#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA Hopper card
and the CUDA toolkit:

    python3 chip_smoke.py

Phases, each printed as it runs:

1. build   — compile ``src/repro_torch/kernels/csrc/*.cu`` (seven
             sources: the five kernels, flash attention having a
             CUDA-core and a tensor-core source, and an empty kernel
             that times the launch floor; one nvcc each, all started
             together) for sm_90a; print the build time,
             ptxas' registers and shared memory per kernel, the count of
             HGMMA (wgmma) instructions in the tensor-core flash
             kernel's SASS (``cuobjdump -sass``; 0 fails), the SASS
             instructions per pair-sample in the inner loop of each
             encounter-screen kernel (its design floor's count), and the
             card's name and power limit.
2. kernels — hold each CUDA kernel against its plain PyTorch version on
             the card at the process phase's shapes (B = 1024 rows,
             N = 128 knots, M in {128, 256, 512, 1024}; track_interp and
             dynamic_rates bitwise, headings included, with the split
             ``plan`` chose, the earlier design's time and the launch
             floor: an empty kernel on the same grid; dynamic_rates also
             at a dt that is not a power of two; the AGL gather
             on the 30-arc-second GLOBE-resolution DEM, 3121 x 7081 f32)
             and the encounter screen at (C, K, T) cell batches up to
             K = 240 rows and T = 4608 samples and at the screen
             workflow's own one-cell K = 8 launches (bitwise, with the
             regime and strips ``plan`` chose, the design floor and the
             earlier design's time), and time kernel, plain version
             and, where one exists, the single PyTorch call computing
             the same function.
3. workflow— the port's TrackWorkflow end to end on the card (threads,
             8 workers, 4 tasks per message, 8 raw files at scale 500),
             with every kernel's launch counter zeroed just before and
             read just after, and track_interp's and dynamic_rates'
             launches by shape and track_interp's by route.
4. globe   — one process_batch over every archive the workflow wrote,
             on the GLOBE-resolution DEM, on the card and on the CPU
             (plain versions), compared within 1e-4 (both sides run the
             same f32 operations), with the host parse timed apart from
             the pipeline.
5. screen  — the port's TrackWorkflow(input="store", screen=True) on the
             card (threads, 8 workers, 4 tasks per message, 8192 points
             per shard, the same 8 raw files), with all four launch
             counters zeroed just before and read just after; the
             candidates held against the brute-force screen over the
             same store-derived rows and against the screen tasks re-run
             on the CPU, and the store path's process phase held
             against the zip path's, bitwise; the screen launches by
             padded (K, T) shape, track_interp's and dynamic_rates' by
             shape; 200 screen tasks profiled (host split, device busy
             time, the screen kernels' own device time); then
             track_interp and dynamic_rates at the most frequent launch
             shape of phase 3 and of phase 5, bitwise, timed beside
             their plain versions, bounds and launch floors.
6. flash   — the flash-attention kernels against their plain version at
             the six shapes of tests/test_flash_attention.py in f32
             (rtol/atol 2e-5), its bf16 case, stablelm-12b's heads (B =
             1, H = 32, KV = 8, hd = 160, T = S in {512, 2048, 4096}) in
             bf16 and f32, and phase 7's own shape (B = 2, T = S = 2048,
             bf16); a bf16 output within one bf16 rounding of the plain
             f32 one (rtol 2^-8, atol 1e-5).  Every bf16 shape must go
             through the tensor-core kernel (route "sm90") and every f32
             one through the CUDA-core kernel (route counters); each is
             timed beside the plain version and, at T = S,
             F.scaled_dot_product_attention (the yardstick only), and a
             bf16 shape also beside the CUDA-core kernel's bf16 entry,
             called directly on the same inputs.
7. lm      — stablelm-12b at full width and depth (40 layers, 12.1 B
             parameters in bf16, random from a seed) on the card: forward
             on 2 x 2048 tokens with attention_impl "flash" (the flash
             counters zeroed just before, 40 launches, all on the sm90
             route, read just after; the kernel's share of the profiled
             forward's device time) and
             "xla", logits compared; prefill + decode_step against
             forward; BatchedServer (4 slots, prompt 64, cache 256): one
             warm-up request, then 3 rounds of 8 seeded requests of 16
             new tokens each, every round gated and timed on its own.

The line before the last is the card's name and power limit; before it
one JSON object lists every kernel with its timings.  The last line is
``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero before that line is printed.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")
WORK = os.path.join(HERE, "experiments", "chip_smoke")

HBM_BYTES_PER_S = 3.35e12        # H100 SXM memory rate
F32_OPS_PER_S = 67e12            # H100 SXM f32 rate outside tensor cores
B_ROWS, N_KNOTS = 1024, 128
WIDTHS = (128, 256, 512, 1024)
TIMED_RUNS = 30
# Tolerances of the parity tests (tests/test_kernels.py and
# tests/test_segment_pipeline.py); headings compare as wrapped angles.
TOL = {"track_interp": (1e-5, 1e-4), "agl_lookup": (1e-4, 1e-2),
       "dynamic_rates": (1e-4, 1e-3), "encounter_screen": (1e-5, 1e-2)}
# The earlier track_interp and dynamic_rates kernels' times (one block per
# row and 256-query tile, one query a thread) at B = 1024, N = 128 and
# each width, on an H100 80GB HBM3 at 700 W, as PERF.md records them,
# printed beside this run's.
INTERP_EARLIER_MS = {128: 0.0080, 256: 0.0095, 512: 0.0128, 1024: 0.0193}
RATES_EARLIER_MS = {128: 0.0082, 256: 0.0097, 512: 0.0133, 1024: 0.0201}
# A grid spacing that is not a power of two: dynamic_rates then takes its
# IEEE divisions (a power of two divides by exact reciprocals).
RATES_IEEE_DT = 0.3
# Encounter-screen cell batches (C cells, K rows, T samples): many small
# cells, mid-size, the densest cell the aerodrome_dense manifest gives
# (237 rows, 240 padded), and that at an hour-long union grid; then the
# screen workflow's own launches, one cell of at most 4 rows (K = 8) at
# three union-grid widths.
SCREEN_SHAPES = ((256, 8, 1024), (32, 64, 1024), (8, 240, 1024),
                 (4, 240, 4608), (1, 8, 128), (1, 8, 1024), (1, 8, 4608))
# The shape of the kernels line's screen row (the kernel table's).
SCREEN_TOP_SHAPE = (4, 240, 4608)
# The earlier screen kernel's times (one block per cell and pair tile,
# each walking the whole time axis) on an H100 80GB HBM3 at 700 W, as
# PERF.md records them, printed beside this run's.
SCREEN_EARLIER_MS = {(256, 8, 1024): 0.4015, (32, 64, 1024): 0.7221,
                  (8, 240, 1024): 1.1674, (4, 240, 4608): 3.6918}
# SIMT lanes an SM issues per clock (4 schedulers x 32), for the screen
# kernels' design floor.
LANES_PER_SM_CLOCK = 128
SCREEN_H_M, SCREEN_V_M = 926.0, 152.4
# f32 operations per jointly valid pair-sample (i < j), from
# csrc/encounter_screen.cu: val product and its test (2), dn (2), mean
# latitude and radians (3), cosf (1), de (3), dn^2 + de^2 (3), sqrtf (1),
# dv (2), both thresholds (2), the strict-< minimum test (1), the dv
# minimum (1).  cosf and sqrtf count as one operation each, and a pair-
# sample that is not jointly valid needs none of them, so the bound
# counts this run's jointly valid pair-samples only: a floor.
SCREEN_OPS_PER_PAIR_SAMPLE = 22
# Phase 5: the thresholds tests/test_workflow_screen.py calibrated so
# the synthetic traffic co-bins, and the distance tolerance of its
# brute-force comparison.
SCREEN_WF = dict(screen_h_m=50_000.0, screen_v_m=1000.0,
                 screen_cell_deg=1.0)
CAND_ATOL_M = 1e-2
# Phase 6: the flash kernel's shapes (B, H, KV, T, S, hd, causal).  The
# six of tests/test_flash_attention.py in f32, its bf16 case, and
# stablelm-12b's heads at three sequence lengths in both dtypes.
FLASH_TEST_SHAPES = ((1, 4, 2, 256, 256, 64, True), (2, 8, 2, 128, 384, 64, True),
                     (1, 2, 2, 256, 256, 128, False),
                     (1, 12, 4, 384, 384, 192, True),
                     (2, 4, 1, 256, 512, 64, True), (1, 4, 4, 200, 300, 64, True))
FLASH_BF16_SHAPE = (1, 4, 2, 128, 128, 64, True)
FLASH_LM_T = (512, 2048, 4096)
FLASH_F32_TOL = 2e-5             # rtol and atol, tests/test_flash_attention.py
# A bf16 output against the plain version's f32 output: one bf16 rounding
# (unit roundoff 2^-8) of an f32 result.  At the JAX test's bf16 case,
# whose outputs stay below 4, this is tighter than its max error 0.05.
FLASH_BF16_RTOL, FLASH_BF16_ATOL = 2.0 ** -8, 1e-5
BF16_OPS_PER_S = 989e12          # H100 SXM dense bf16 tensor-core rate
# Phase 7: stablelm-12b at full width and depth.
LM_ARCH = "stablelm-12b"
LM_B, LM_T = 2, 2048
# Phase 6 also holds the kernel at the shape phase 7's forward gives it.
FLASH_MAIN_PATH_SHAPE = (LM_B, 32, 8, LM_T, LM_T, 160, True)
LM_REL_GATE = 0.03               # flash vs xla logits, tests/test_flash_attention.py
LM_DECODE_T, LM_DECODE_GATE = 64, 0.05   # tests/test_models.py's gate
SERVE = dict(slots=4, prompt_len=64, cache_len=256)
SERVE_REQUESTS, SERVE_NEW, SERVE_ROUNDS = 8, 16, 3
# Screen tasks timed one after another, profiled, after the workflow.
SCREEN_PROFILE_TASKS = 200
# Card against CPU on the GLOBE batch: both run the same f32 operations
# without FMA, so only cosf/atan2f ulps differ.  |card - CPU| must stay
# within CARD_ATOL + CARD_RTOL * |CPU| on every plane (headings wrapped).
CARD_ATOL, CARD_RTOL = 1e-4, 1e-6


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def device_ms(fn, runs: int = TIMED_RUNS, warmup: int = 3) -> float:
    """Median device time of one call, from CUDA events around each of
    ``runs`` back-to-back calls.  A spin kernel first holds the stream
    while the host queues every call, so host overhead between calls
    does not show as device time."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(runs + 1)]
    torch.cuda._sleep(200_000_000)
    ev[0].record()
    for i in range(runs):
        fn()
        ev[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(ev[i].elapsed_time(ev[i + 1])
                             for i in range(runs))


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def wrapped(a, b):
    """|a - b| as angles, in (-pi, pi]."""
    d = (a.double() - b.double() + math.pi) % (2 * math.pi) - math.pi
    return d.abs()


def bucket_inputs(rng, W: int, B: int = B_ROWS, N: int = N_KNOTS):
    """One (B, W) bucket shaped like the process phase's: 10-120
    irregular knots about 10 s apart (dataset #1's update period; N >=
    128 slots), covering half to all of the bucket's 1 Hz grid, over
    CONUS."""
    import numpy as np
    t_in = np.zeros((B, N), np.float32)
    v_in = np.zeros((B, 3, N), np.float32)
    count_in = np.zeros(B, np.int32)
    t_out = np.zeros((B, W), np.float32)
    count_out = np.zeros(B, np.int32)
    for b in range(B):
        m = int(rng.integers(W // 2 + 1, W + 1))
        n = int(min(max(m // 10, 10), 120))
        t = np.sort(rng.uniform(0, m - 1, n))
        t[0], t[-1] = 0.0, m - 1
        t_in[b, :n] = t
        t_in[b, n:] = t[-1] + np.arange(1, N - n + 1)
        hdg = rng.uniform(0, 2 * np.pi) + np.cumsum(rng.normal(0, 0.05, n))
        step = rng.uniform(30, 220) * np.diff(t, prepend=0.0) / 111_111.0
        lat0 = rng.uniform(26, 48)
        v_in[b, 0, :n] = lat0 + np.cumsum(step * np.cos(hdg))
        v_in[b, 1, :n] = rng.uniform(-122, -69) + np.cumsum(
            step * np.sin(hdg) / np.cos(np.deg2rad(lat0)))
        v_in[b, 2, :n] = np.maximum(
            rng.uniform(300, 3000) + np.cumsum(rng.normal(0, 20, n)), 10)
        v_in[b, :, n:] = v_in[b, :, n - 1:n]
        count_in[b] = n
        t_out[b, :m] = np.arange(m)
        t_out[b, m:] = m - 1
        count_out[b] = m
    return t_in, v_in, count_in, t_out, count_out


def phase_build() -> tuple[str, dict]:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.lib()
    say("build", f"libkernels built in {_build.build_seconds:.2f}s "
                 f"(load {time.perf_counter() - t0:.2f}s) for sm_90a")
    source, kernel, found = "?", "", []
    log = _build.build_log()
    for line in log.splitlines():
        if line.startswith("== "):
            source, kernel = line[3:], ""
        elif "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif ("registers" in line or "spill" in line.lower()
              or "Performance Loss" in line):
            text, name = line.split("ptxas", 1)[-1], kernel
            if "Performance Loss" in line:     # printed before its kernel
                text, _, rest = text.partition("for the function")
                name = rest.split("'")[1] if "'" in rest else name
            found.append((source, name, text))
    names = demangle({name for _, name, _ in found if name})
    for source, name, text in found:
        say("build", f"{source} {names.get(name, name)}: ptxas{text}")
    n = len(_build._sources())
    if n != 7 or "flash_attention_sm90.cu" not in log:
        raise AssertionError(f"expected seven kernel sources, built {n}")
    hgmma = hgmma_count(_build.library_path())
    say("build", f"flash_attention_sm90.cu: {hgmma} HGMMA instructions in "
                 f"its kernels' SASS (cuobjdump -sass)")
    if hgmma == 0:
        raise AssertionError("the sm90 flash kernel has no HGMMA: it does "
                             "not run on the tensor cores")
    floor = screen_sass_per_pair_sample(_build.library_path())
    for regime, f in sorted(floor.items()):
        say("build", f"encounter_screen.cu {regime}-K kernel: "
                     f"{f['instructions']} SASS instructions in its inner "
                     f"loop for {f['pair_samples']} pair-samples = "
                     f"{f['per_pair_sample']:.2f} per pair-sample "
                     f"(cuobjdump -sass)")
    card = card_line()
    say("build", f"card: {card}")
    return card, floor


def demangle(mangled) -> dict:
    """Each mangled kernel name's function name and template arguments,
    from the CUDA toolkit's cu++filt."""
    mangled = sorted(mangled)
    if not mangled:
        return {}
    cufilt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    out = subprocess.run([cufilt, "-p", *mangled], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return dict(zip(mangled, out.splitlines()))


def hgmma_count(library) -> int:
    """HGMMA instructions in the SASS of the sm90 flash kernels."""
    cuobjdump = (shutil.which("cuobjdump")
                 or "/usr/local/cuda/bin/cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(library)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    return sum(fn.count("HGMMA") for fn in sass.split("Function : ")
               if fn.startswith("_") and "flash_attention_sm90" in
               fn.split("\n", 1)[0])


def screen_sass_per_pair_sample(library) -> dict:
    """SASS instructions per pair-sample of each encounter-screen kernel's
    inner loop, from ``cuobjdump -sass``: the smallest loop (a backward
    branch and its target) that holds a MUFU.RSQ, one of which each
    pair-sample's sqrtf issues, counted without NOPs and divided by its
    MUFU.RSQs.  The slow paths of cosf and sqrtf lie outside it (a
    call), so this is the fast path's count: a floor per pair-sample."""
    cuobjdump = (shutil.which("cuobjdump")
                 or "/usr/local/cuda/bin/cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(library)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    out = {}
    for fn in sass.split("Function : ")[1:]:
        name = fn.split("\n", 1)[0]
        regime = ("small" if "screen_small_kernel" in name else
                  "large" if "screen_tile_kernel" in name else None)
        if regime is None:
            continue
        ins = [(int(a, 16), text.strip()) for a, text in
               re.findall(r"/\*([0-9a-f]+)\*/\s+([^;]*);", fn)]
        best = None
        for addr, text in ins:
            m = re.search(r"\bBRA\b.*?\b0x([0-9a-f]+)", text)
            if not m or int(m.group(1), 16) > addr:
                continue
            body = [t for a, t in ins
                    if int(m.group(1), 16) <= a <= addr and t != "NOP"]
            rsq = sum("MUFU.RSQ" in t for t in body)
            if rsq and (best is None or len(body) < best[0]):
                best = (len(body), rsq)
        if best is None:
            raise AssertionError(f"no inner loop with a MUFU.RSQ in {name}")
        out[regime] = {"instructions": best[0], "pair_samples": best[1],
                       "per_pair_sample": best[0] / best[1]}
    if set(out) != {"small", "large"}:
        raise AssertionError(f"screen kernels' SASS not found: {out}")
    return out


def sm_clock_hz() -> float:
    """The card's highest SM clock, from nvidia-smi, in Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return float(out.splitlines()[0]) * 1e6


def phase_kernels(globe_dem) -> dict:
    """Each kernel against its plain version, timed, at every width."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.agl_lookup import agl_lookup

    dev = torch.device("cuda")
    dem = torch.from_numpy(
        globe_dem.elevation_m.astype(np.float32)).to(dev)
    H, W_dem = dem.shape
    grid = (globe_dem.lat_min, globe_dem.lat_max, globe_dem.lon_min,
            globe_dem.lon_max, float(globe_dem.cells_per_deg))
    say("kernels", f"DEM {H} x {W_dem} f32, "
                   f"{dem.numel() * 4 / 1e6:.1f} MB on the card")
    rng = np.random.default_rng(11)
    results = {name: {"per_width": {}, "max_abs_err": 0.0}
               for name in ("track_interp", "agl_lookup", "dynamic_rates")}
    for W in WIDTHS:
        t_in, v_in, count_in, t_out, count_out = (
            torch.from_numpy(x).to(dev) for x in bucket_inputs(rng, W))
        B = v_in.shape[0]

        # track_interp
        got, interp_row = interp_check(t_in, v_in, count_in, t_out)

        # agl_lookup on the interpolated grid, indices as the pipeline
        # computes them
        v_grid = got.permute(0, 2, 1).contiguous()
        lat, lon, alt = v_grid[:, 0], v_grid[:, 1], v_grid[:, 2]
        fi = torch.clamp((torch.clamp(lat, grid[0], grid[1]) - grid[0])
                         * grid[4], 0.0, H - 1.001).contiguous()
        fj = torch.clamp((torch.clamp(lon, grid[2], grid[3]) - grid[2])
                         * grid[4], 0.0, W_dem - 1.001).contiguous()
        alt = alt.contiguous()
        got_a = agl_lookup(dem, fi, fj, alt)
        want_a = ref.agl_lookup_ref(dem, fi, fj, alt)
        err_a = (got_a - want_a).abs().max().item()
        ok_a = torch.allclose(got_a, want_a, rtol=TOL["agl_lookup"][0],
                              atol=TOL["agl_lookup"][1])
        # grid_sample's bilinear, align_corners=True, is the same gather.
        gs_grid = torch.stack([fj / (W_dem - 1) * 2 - 1,
                               fi / (H - 1) * 2 - 1], dim=-1)[None]
        dem4 = dem[None, None]
        lib_a = F.grid_sample(dem4, gs_grid, mode="bilinear",
                              align_corners=True)[0, 0]
        lib_err = (alt - lib_a - want_a).abs().max().item()
        i0 = torch.floor(fi).long()
        j0 = torch.floor(fj).long()
        cells = torch.cat([((i0 + di).clamp(max=H - 1) * W_dem
                            + (j0 + dj).clamp(max=W_dem - 1)).flatten()
                           for di in (0, 1) for dj in (0, 1)])
        n_cells = torch.unique(cells).numel()
        b_ms, b_by = bound(fi.numel() * 16 + n_cells * 4, fi.numel() * 20)
        agl_row = {
            "ms": device_ms(lambda: agl_lookup(dem, fi, fj, alt)),
            "plain_ms": device_ms(lambda: ref.agl_lookup_ref(
                dem, fi, fj, alt)),
            "library_ms": device_ms(lambda: F.grid_sample(
                dem4, gs_grid, mode="bilinear", align_corners=True)),
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err_a,
            "dem_cells_touched": n_cells, "library_max_abs_err": lib_err}

        # dynamic_rates on the same grid
        rates_row = rates_check(v_grid, count_out, 1.0)

        for name, row, earlier in (
                ("track_interp", interp_row, INTERP_EARLIER_MS[W]),
                ("agl_lookup", agl_row, None),
                ("dynamic_rates", rates_row, RATES_EARLIER_MS[W])):
            say_kernel(name, f"B={B} M={W:4d}", row, earlier)
            if name == "agl_lookup" and not ok_a:
                raise AssertionError(
                    f"{name} at M={W} disagrees with its plain version: "
                    f"max |diff| {row['max_abs_err']}")
            results[name]["per_width"][W] = row
            results[name]["max_abs_err"] = max(
                results[name]["max_abs_err"], row["max_abs_err"])
        if W == WIDTHS[-1]:
            # A dt that is not a power of two takes the IEEE divisions.
            row = rates_check(v_grid, count_out, RATES_IEEE_DT)
            say_kernel("dynamic_rates", f"B={B} M={W:4d} dt={RATES_IEEE_DT} "
                                        f"(IEEE divisions)", row)
            results["dynamic_rates"]["ieee_dt"] = row
    return results


def launch_floor_ms(blocks: int, threads: int, smem: int, like) -> float:
    """device_ms of a kernel that does nothing, on the given grid: the
    part of a launch's time that no kernel design can remove."""
    from repro_torch.kernels import _build
    lib, stream = _build.lib(), _build.stream_of(like)

    def run():
        _build.check(lib.launch_floor(blocks, threads, smem, stream),
                     "launch_floor")
    return device_ms(run)


def interp_check(t_in, v_in, count_in, t_out) -> tuple:
    """track_interp against its plain version, bitwise and within TOL,
    timed beside it, its bound and the launch floor of its grid; returns
    the output and the row."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import track_interp as ti
    got = ti.track_interp(t_in, v_in, count_in, t_out)
    want = ref.track_interp_ref(t_in, v_in, count_in, t_out)
    torch.cuda.synchronize()
    split = ti.last_plan
    rtol, atol = TOL["track_interp"]
    err = (got - want).abs().max().item()
    ok = torch.allclose(got, want, rtol=rtol, atol=atol)
    bitwise = torch.equal(got, want)
    # The kernel reads only each row's first `count` knots (times and C
    # value planes), every query time and count, and writes (B,M,C).
    B, C, _ = v_in.shape
    M = t_out.shape[1]
    knots = int(count_in.sum().item())
    nbytes = (knots * (1 + C) + B + B * M + B * M * C) * 4
    b_ms, b_by = bound(nbytes, B * M * (6 + 3 * C))
    row = {"ms": device_ms(lambda: ti.track_interp(t_in, v_in, count_in,
                                                   t_out)),
           "plain_ms": device_ms(lambda: ref.track_interp_ref(
               t_in, v_in, count_in, t_out)),
           "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
           "max_abs_err": err, "bitwise": bitwise,
           "floor_ms": launch_floor_ms(split.blocks,
                                       split.rows * split.per_row,
                                       split.smem, t_in),
           "plan": split._asdict()}
    if not ok or not bitwise:
        raise AssertionError(f"track_interp at B={B} M={M} disagrees with "
                             f"its plain version: max |diff| {err}, "
                             f"bitwise {bitwise}")
    return got, row


def rates_check(v, count, dt: float) -> dict:
    """dynamic_rates against its plain version, bitwise (headings
    included) and within TOL (headings as wrapped angles), timed beside
    it, its bound and the launch floor of its grid."""
    import torch
    from repro_torch.kernels import dynamic_rates as dr
    from repro_torch.kernels import ref
    got = dr.dynamic_rates(v, count, dt)
    want = ref.dynamic_rates_ref(v, count, dt)
    torch.cuda.synchronize()
    split = dr.last_plan
    diff = (got - want).abs()
    diff[:, 2] = wrapped(got[:, 2], want[:, 2]).float()
    err = diff.max().item()
    rtol, atol = TOL["dynamic_rates"]
    ok = bool((diff <= atol + rtol * want.abs()).all())
    bitwise = torch.equal(got, want)
    # Positions at and past count read nothing and write zeros.
    B, _, M = v.shape
    valid = int(count.clamp(max=M).sum().item())
    b_ms, b_by = bound((valid * 3 + B + B * 4 * M) * 4, valid * 60)
    row = {"ms": device_ms(lambda: dr.dynamic_rates(v, count, dt)),
           "plain_ms": device_ms(lambda: ref.dynamic_rates_ref(
               v, count, dt)),
           "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
           "max_abs_err": err, "bitwise": bitwise,
           "floor_ms": launch_floor_ms(split.blocks,
                                       split.rows * split.per_row, 0, v),
           "plan": split._asdict()}
    if not ok or not bitwise:
        raise AssertionError(f"dynamic_rates at B={B} M={M} dt={dt} "
                             f"disagrees with its plain version: max "
                             f"|diff| {err}, bitwise {bitwise}")
    return row


def say_kernel(name: str, shape: str, row: dict,
               earlier_ms: float | None = None) -> None:
    """One [kernels] line: agreement, kernel, plain, library and bound
    times, and for the redesigned kernels the launch floor and the split
    ``plan`` chose, and ``earlier_ms`` (the earlier design's time as
    PERF.md records it, printed here only) where given."""
    rtol, atol = TOL[name]
    lib = "-" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
    extra = ""
    if "floor_ms" in row:
        p = row["plan"]
        extra = (f"; launch floor {row['floor_ms']:.4f} ms; "
                 + (f"route {p['route']}, " if "route" in p else "")
                 + f"{p['rows']} rows x {p['per_row']} threads a block, "
                   f"{p['blocks']} blocks, "
                 + (f"{p['smem']} B shared, " if "smem" in p else "")
                 + ("16-byte" if p["vec"] else "scalar") + " path")
    if earlier_ms:
        extra += (f"; earlier design {earlier_ms:.4f} ms "
                  f"(now x{row['ms'] / earlier_ms:.3f})")
    say("kernels", f"{name:13s} {shape}: max|diff| "
                   f"{row['max_abs_err']:.3g} (rtol {rtol}, atol {atol})"
                   + (f", bitwise {row['bitwise']}" if "bitwise" in row
                      else "")
                   + f"; kernel {row['ms']:.4f} ms, plain "
                   f"{row['plain_ms']:.4f} ms, library {lib} ms, bound "
                   f"{row['bound_ms']:.4g} ms ({row['bound_by']})" + extra)


def top_shape(by_shape: dict):
    """The most frequent launch shape (the larger shape on a tie)."""
    return max(by_shape.items(), key=lambda kv: (kv[1], kv[0]))[0]


def phase_workflow_shapes(shapes: dict) -> dict:
    """track_interp and dynamic_rates at each workflow's most frequent
    launch shape (``shapes``: workflow -> kernel -> launches_by_shape),
    bitwise against their plain versions and timed beside them, their
    bounds and the launch floor of their grids."""
    import numpy as np
    import torch
    dev = torch.device("cuda")
    rng = np.random.default_rng(13)
    out = {}
    for label, by_kernel in shapes.items():
        B, N, M = top_shape(by_kernel["track_interp"])
        t_in, v_in, count_in, t_out, _ = (
            torch.from_numpy(x).to(dev)
            for x in bucket_inputs(rng, M, B=B, N=N))
        _, i_row = interp_check(t_in, v_in, count_in, t_out)
        Br, Mr = top_shape(by_kernel["dynamic_rates"])
        Nr = max((n for b, n, m in by_kernel["track_interp"]
                  if (b, m) == (Br, Mr)), default=N_KNOTS)
        t_in, v_in, count_in, t_out, count_out = (
            torch.from_numpy(x).to(dev)
            for x in bucket_inputs(rng, Mr, B=Br, N=Nr))
        grid, _ = interp_check(t_in, v_in, count_in, t_out)
        v_grid = grid.permute(0, 2, 1).contiguous()
        r_row = rates_check(v_grid, count_out, 1.0)
        say_kernel("track_interp", f"{label}'s top shape B={B} N={N} M={M} "
                   f"({by_kernel['track_interp'][(B, N, M)]} launches)",
                   i_row)
        say_kernel("dynamic_rates", f"{label}'s top shape B={Br} M={Mr} "
                   f"({by_kernel['dynamic_rates'][(Br, Mr)]} launches)",
                   r_row)
        out[label] = {"track_interp": dict(i_row, shape=[B, N, M]),
                      "dynamic_rates": dict(r_row, shape=[Br, Mr])}
    return out


def screen_cells(rng, C: int, K: int, T: int):
    """C cells of K rows of 1 Hz trails clustered around one point per
    cell (as tests/test_encounter_screen.py builds them, so a real share
    of pairs hit), each row valid over a random span; as (C, K, T) f32
    planes lat, lon, alt, val."""
    import numpy as np
    lat = (40.0 + rng.normal(0, 0.005, (C, K, 1))
           + np.cumsum(rng.normal(0, 1e-4, (C, K, T)), axis=2))
    lon = (-100.0 + rng.normal(0, 0.005, (C, K, 1))
           + np.cumsum(rng.normal(0, 1e-4, (C, K, T)), axis=2))
    alt = rng.uniform(400, 900, (C, K, 1)) + rng.normal(0, 5, (C, K, T))
    start = rng.integers(0, T // 2, (C, K, 1))
    end = rng.integers(T // 2, T + 1, (C, K, 1))
    t = np.arange(T)[None, None, :]
    val = (t >= start) & (t < end)
    return [x.astype(np.float32) for x in (lat, lon, alt, val)]


def phase_screen_kernels(floor: dict) -> dict:
    """The encounter-screen kernel against its plain version, bitwise,
    timed, at every cell-batch shape, with the split the timed launches
    took (``encounter_screen.last_plan``) and the design floor: ``floor``'s SASS instructions per pair-sample over
    this run's jointly valid pair-samples, at 128 lanes a clock on every
    SM at the card's highest SM clock."""
    import numpy as np
    import torch
    from repro_torch.kernels import encounter_screen as screen

    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_hz = sm_clock_hz()
    say("kernels", f"encounter_screen design floor at {n_sm} SMs x "
                   f"{LANES_PER_SM_CLOCK} lanes x {clock_hz / 1e6:.0f} MHz "
                   f"(nvidia-smi clocks.max.sm)")
    rng = np.random.default_rng(12)
    rtol, atol = TOL["encounter_screen"]
    res = {"per_shape": {}, "max_abs_err": 0.0}
    for C, K, T in SCREEN_SHAPES:
        args = [torch.from_numpy(x).to(dev)
                for x in screen_cells(rng, C, K, T)]

        def kernel():
            return screen.encounter_screen(*args, h_m=SCREEN_H_M,
                                           v_m=SCREEN_V_M)

        def plain():
            return screen._screen_batch_plain(*args, h_m=SCREEN_H_M,
                                              v_m=SCREEN_V_M)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        hit = want[0] > 0.5
        ok = (torch.equal(got[0], want[0])
              and torch.equal(got[3][hit], want[3][hit]))
        err = 0.0
        for g, w in zip(got[1:3], want[1:3]):
            d = (g[hit] - w[hit]).abs()
            err = max(err, d.max().item() if d.numel() else 0.0)
            ok = ok and bool((d <= atol + rtol * w[hit].abs()).all())
        # No-hit entries (lower triangle and diagonal too) hold the
        # reference's constants.
        for g, fill in zip(got, (0.0, 1e30, 1e30, 0.0)):
            ok = ok and bool((g[~hit] == torch.tensor(
                fill, dtype=torch.float32, device=dev)).all())
        bitwise = all(torch.equal(g, w) for g, w in zip(got, want))
        # Jointly valid pair-samples with i < j: n_t valid rows at an
        # instant make n_t (n_t - 1) / 2 of them.
        n_t = args[3].sum(dim=1).double()
        valid_ps = float(((n_t * n_t - n_t) / 2).sum().item())
        nbytes = 4 * C * K * T * 4 + 4 * C * K * K * 4
        b_ms, b_by = bound(nbytes, valid_ps * SCREEN_OPS_PER_PAIR_SAMPLE)
        earlier = SCREEN_EARLIER_MS.get((C, K, T))
        runs = 10
        screen.last_plan = None
        k_ms = device_ms(kernel, runs=runs)
        split = screen.last_plan
        floor_ms = (floor[split.regime]["per_pair_sample"] * valid_ps
                    / (n_sm * LANES_PER_SM_CLOCK * clock_hz) * 1e3)
        row = {"ms": k_ms,
               "plain_ms": device_ms(plain, runs=runs),
               "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
               "max_abs_err": err, "bitwise": bitwise,
               "regime": split.regime, "strips": split.strips,
               "hits": int(hit.sum().item()),
               "pairs": C * K * (K - 1) // 2,
               "valid_pair_samples": valid_ps}
        say("kernels", f"encounter_screen C={C} K={K} T={T}: "
                       f"{row['hits']} of {row['pairs']} pairs hit, "
                       f"{valid_ps:.0f} jointly valid pair-samples; "
                       f"{split.regime}-K regime, {split.strips} strips "
                       f"({split.block_strips} across blocks, "
                       f"{split.blocks} blocks); "
                       f"max|diff| {err:.3g} (rtol {rtol}, atol {atol}), "
                       f"bitwise {bitwise}; kernel {row['ms']:.4f} ms "
                       f"(earlier design: " + (f"{earlier:.4f} ms" if earlier
                                              else "not timed") + f"), "
                       f"plain {row['plain_ms']:.4f} ms, library - ms, "
                       f"bound {b_ms:.4g} ms ({b_by}), design floor "
                       f"{floor_ms:.4g} ms")
        if not ok or not bitwise:
            raise AssertionError(
                f"encounter_screen at C={C} K={K} T={T} disagrees with "
                f"its plain version bitwise: max |diff| {err}")
        res["per_shape"][f"{C}x{K}x{T}"] = row
        res["max_abs_err"] = max(res["max_abs_err"], err)
    return res


# Kernels whose wrappers count launches by shape.
SHAPED = {"track_interp": "(B, N, M)", "dynamic_rates": "(B, M)"}
SHAPES_PRINTED = 12


def snapshot_shapes(mods: dict) -> dict:
    """The SHAPED kernels' launches by shape, most frequent first, and
    track_interp's launches by route, read just after a run."""
    shapes = {name: dict(sorted(mods[name].launches_by_shape.items(),
                                key=lambda kv: (-kv[1], kv[0])))
              for name in SHAPED}
    shapes["routes"] = dict(mods["track_interp"].launches_by_route)
    return shapes


def say_shapes(tag: str, shapes: dict, launches: dict) -> None:
    """Print a snapshot_shapes; each kernel's shapes must sum to its
    launches."""
    for name, key in SHAPED.items():
        by = shapes[name]
        more = len(by) - SHAPES_PRINTED
        say(tag, f"{name} launches by shape {key}: " + ", ".join(
            f"{k}: {n}" for k, n in list(by.items())[:SHAPES_PRINTED])
            + (f", and {more} more shapes" if more > 0 else ""))
        if sum(by.values()) != launches[name]:
            raise AssertionError(f"{name} launches_by_shape sums to "
                                 f"{sum(by.values())}, not "
                                 f"{launches[name]}")
    say(tag, f"track_interp launches by route {shapes['routes']}")


def zero_counters(mods: dict) -> None:
    for mod in mods.values():
        mod.launches = 0
    for name in SHAPED:
        mods[name].launches_by_shape.clear()
    for route in mods["track_interp"].launches_by_route:
        mods["track_interp"].launches_by_route[route] = 0


def phase_workflow() -> tuple[dict, str, dict]:
    import torch
    from repro_torch.kernels import agl_lookup, dynamic_rates, ops
    from repro_torch.kernels import track_interp
    from repro_torch.tracks.workflow import TrackWorkflow

    shutil.rmtree(WORK, ignore_errors=True)
    wf = TrackWorkflow(WORK, n_workers=8, tasks_per_message=4,
                       poll_interval=0.005, device="cuda")
    t0 = time.perf_counter()
    n_files = wf.generate_raw(n_files=8, scale=500)
    say("workflow", f"generated {n_files} raw files in "
                    f"{time.perf_counter() - t0:.2f}s")
    mods = {"track_interp": track_interp, "agl_lookup": agl_lookup,
            "dynamic_rates": dynamic_rates}
    zero_counters(mods)
    ops.reset_pipeline_stats()
    t0 = time.perf_counter()
    reports = wf.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: mod.launches for name, mod in mods.items()}
    shapes = snapshot_shapes(mods)
    stats = ops.get_pipeline_stats()
    for r in reports:
        say("workflow", f"{r.phase:9s}: {r.tasks:4d} tasks on {r.workers} "
                        f"threads workers in {r.job_seconds:.3f}s "
                        f"({r.messages} messages)")
    say("workflow", f"end to end {wall:.3f}s; launches {launches}; "
                    f"pipeline stats {stats}")
    say_shapes("workflow", shapes, launches)
    if min(launches.values()) < 1:
        raise AssertionError(f"the workflow bypassed a kernel: {launches}")
    if stats["intermediate_transfers"] != 0:
        raise AssertionError(f"fused path crossed the host: {stats}")
    if [r.phase for r in reports] != ["organize", "archive", "process"]:
        raise AssertionError(f"phases ran: {[r.phase for r in reports]}")
    return launches, wf.archive_dir, shapes


def phase_globe(archive_dir: str, globe_dem) -> None:
    import numpy as np
    import torch
    from repro_torch.geometry.aerodromes import synthetic_aerodromes
    from repro_torch.tracks.segments import (
        SegmentProcessor, segment_tasks_from_archive_tree, split_segments)

    tasks = segment_tasks_from_archive_tree(archive_dir)
    aero = synthetic_aerodromes(n=64)
    gpu = SegmentProcessor(dem=globe_dem, aerodromes=aero, device="cuda")
    cpu = SegmentProcessor(dem=globe_dem, aerodromes=aero, device="cpu")
    gpu.process_batch(tasks)                    # DEM upload, warm-up
    # Where process_batch's time goes: the host parse of the zip/CSV
    # archives, then the bucketed pipeline (packing, kernels, fetch).
    t0 = time.perf_counter()
    items = [(obs, split_segments(obs["time"]))
             for obs in (gpu.read_observations(t.payload) for t in tasks)]
    items = [it for it in items if it[1]]
    parse_s = time.perf_counter() - t0
    pipe_s = {}
    for name, proc in (("card", gpu), ("CPU", cpu)):
        t0 = time.perf_counter()
        proc._process_many(items)
        torch.cuda.synchronize()
        pipe_s[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = gpu.process_batch(tasks)
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = cpu.process_batch(tasks)
    cpu_s = time.perf_counter() - t0
    n_seg = gpu.last_stats["n_segments"]
    if gpu.last_stats != cpu.last_stats:
        raise AssertionError(f"bucket plans differ: {gpu.last_stats} vs "
                             f"{cpu.last_stats}")
    worst = {}
    for tid, w in want.items():
        g = got[tid]
        if g.icao24 != w.icao24 or g.airspace != w.airspace or \
                not np.array_equal(g.count, w.count):
            raise AssertionError(f"{tid}: names/airspace/counts differ")
        for attr in ("times", "lat", "lon", "alt_msl_m", "alt_agl_m",
                     "vrate_ms", "gspeed_ms", "heading_rad", "turn_rad_s"):
            a, b = getattr(g, attr), getattr(w, attr)
            if not a.size:
                continue
            if attr == "heading_rad":
                d = np.abs(np.angle(np.exp(1j * (a.astype(np.float64) - b))))
            else:
                d = np.abs(a.astype(np.float64) - b)
            bad = d > CARD_ATOL + CARD_RTOL * np.abs(b)
            worst[attr] = max(worst.get(attr, 0.0), float(d.max()))
            if bad.any():
                raise AssertionError(f"{tid} {attr}: card and CPU differ "
                                     f"by {d.max()}")
    say("globe", f"{len(tasks)} archives, {n_seg} segments, "
                 f"{gpu.last_stats['pipeline_calls']} pipeline calls on a "
                 f"{globe_dem.elevation_m.shape[0]} x "
                 f"{globe_dem.elevation_m.shape[1]} DEM: card "
                 f"{gpu_s:.3f}s ({n_seg / gpu_s:.1f} segments/s, host "
                 f"parse included), CPU plain {cpu_s:.3f}s "
                 f"({n_seg / cpu_s:.1f} segments/s)")
    say("globe", f"split: host parse {parse_s:.3f}s; pipeline alone "
                 f"card {pipe_s['card']:.3f}s "
                 f"({n_seg / pipe_s['card']:.1f} segments/s), CPU plain "
                 f"{pipe_s['CPU']:.3f}s "
                 f"({n_seg / pipe_s['CPU']:.1f} segments/s)")
    say("globe", f"max |card - CPU| per plane (limit {CARD_ATOL} + "
                 f"{CARD_RTOL} |CPU|): " + ", ".join(
                     f"{k} {v:.3g}" for k, v in worst.items()))

    # Device busy share of the card's pipeline, from a profiler trace of
    # one more pass (the timed passes above ran without the profiler).
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gpu._process_many(items)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    busy = _device_busy(prof)
    busy_ms = sum(busy.values())
    if busy_ms > 0:
        top = sorted(busy.items(), key=lambda kv: -kv[1])[:6]
        say("globe", f"profiled pipeline pass {prof_s * 1e3:.1f} ms wall, "
                     f"device busy {busy_ms:.3f} ms (idle share "
                     f"{1 - busy_ms / (prof_s * 1e3):.4f}); top: " + "; ".join(
                         f"{k[:40]} {v:.3f} ms" for k, v in top))
    else:
        say("globe", "profiler saw no device time: idle share not measured")


def brute_force_overlapping(rows, config) -> list:
    """``brute_force_screen`` over every pair of rows that share an
    instant, deduplicated: the all-pairs result, without the O(N^2 T)
    global grid (782 rows over 8 hours would take minutes in numpy).
    Rows that never share an instant are never jointly valid, and with
    integer start times on the 1 s grid each pair's samples align
    exactly as on the global grid, so the records are the same."""
    from repro_torch.kernels.encounter_screen import (
        brute_force_screen, dedup_candidates)
    if config.dt_s != 1.0 or any(r.t0 != int(r.t0) for r in rows):
        raise AssertionError("pairwise brute force needs integer start "
                             "times on a 1 s grid")
    rows = sorted(rows, key=lambda r: r.t0)
    out = []
    for a, ra in enumerate(rows):
        end = ra.t0 + len(ra)
        for rb in rows[a + 1:]:
            if rb.t0 >= end:
                break
            out.extend(brute_force_screen([ra, rb], config=config))
    return dedup_candidates(out)


def same_candidates(got, want, what: str) -> float:
    """Raise unless the pair sets and t_s are equal and h_m/v_m agree
    within CAND_ATOL_M; return the largest distance difference."""
    if [(c["a"], c["b"]) for c in got] != [(c["a"], c["b"]) for c in want]:
        raise AssertionError(f"candidate pairs differ from {what}: "
                             f"{len(got)} vs {len(want)}")
    worst = 0.0
    for g, w in zip(got, want):
        if g["t_s"] != w["t_s"]:
            raise AssertionError(f"{g['a']}/{g['b']}: t_s {g['t_s']} vs "
                                 f"{w['t_s']} ({what})")
        d = max(abs(g["h_m"] - w["h_m"]), abs(g["v_m"] - w["v_m"]))
        worst = max(worst, d)
        if d > CAND_ATOL_M:
            raise AssertionError(f"{g['a']}/{g['b']}: distances differ by "
                                 f"{d} m from {what}")
    return worst


def phase_screen_workflow() -> dict:
    """organize -> archive -> store-build -> process -> screen on the
    card, with every kernel's launch counter zeroed just before."""
    import numpy as np
    import torch
    from repro_torch.kernels import agl_lookup, dynamic_rates, ops
    from repro_torch.kernels import encounter_screen, track_interp
    from repro_torch.runtime import run_job
    from repro_torch.tracks.datasets import SCREEN_ROW_BYTES
    from repro_torch.tracks.segments import (
        SegmentProcessor, segment_tasks_from_archive_tree,
        segment_tasks_from_store)
    from repro_torch.tracks.workflow import (
        ScreenWorker, TrackWorkflow, _screen_rows_for_uri)

    root = WORK + "_screen"
    shutil.rmtree(root, ignore_errors=True)
    wf = TrackWorkflow(root, n_workers=8, tasks_per_message=4,
                       poll_interval=0.005, device="cuda", input="store",
                       store_target_points=8192, screen=True, **SCREEN_WF)
    wf.generate_raw(n_files=8, scale=500)
    mods = {"track_interp": track_interp, "agl_lookup": agl_lookup,
            "dynamic_rates": dynamic_rates,
            "encounter_screen": encounter_screen}
    zero_counters(mods)
    encounter_screen.launches_by_shape.clear()
    ops.reset_pipeline_stats()
    encounter_screen.reset_screen_stats()
    t0 = time.perf_counter()
    reports = wf.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: mod.launches for name, mod in mods.items()}
    shapes = snapshot_shapes(mods)
    by_shape = dict(sorted(encounter_screen.launches_by_shape.items()))
    stats = ops.get_pipeline_stats()
    sstats = encounter_screen.get_screen_stats()
    for r in reports:
        say("screen", f"{r.phase:11s}: {r.tasks:5d} tasks on {r.workers} "
                      f"threads workers in {r.job_seconds:.3f}s "
                      f"({r.messages} messages)")
    with open(wf.candidates_path) as f:
        got = json.load(f)["candidates"]
    tasks = wf._screen_tasks_full()
    occupancy = [t.size_bytes // SCREEN_ROW_BYTES for t in tasks]
    say("screen", f"end to end {wall:.3f}s; {sstats['cells_screened']} "
                  f"cells screened ({sstats['pairs_screened']} pairs, "
                  f"{sstats['kernel_calls']} screen calls), largest "
                  f"occupancy {max(occupancy)}, {len(got)} candidates; "
                  f"launches {launches}; pipeline stats {stats}")
    phases = [r.phase for r in reports]
    if phases != ["organize", "archive", "store-build", "process",
                  "screen"]:
        raise AssertionError(f"phases ran: {phases}")
    say_shapes("screen", shapes, launches)
    say("screen", "encounter_screen launches by padded shape (Kp, Tp): "
                  + ", ".join(f"({k}, {t}): {n}"
                              for (k, t), n in by_shape.items()))
    if sum(by_shape.values()) != launches["encounter_screen"]:
        raise AssertionError(f"launches_by_shape {by_shape} does not sum "
                             f"to {launches['encounter_screen']}")
    if min(launches.values()) < 1:
        raise AssertionError(f"the workflow bypassed a kernel: {launches}")
    if stats["intermediate_transfers"] != 0:
        raise AssertionError(f"fused path crossed the host: {stats}")
    if not got:
        raise AssertionError("the screen found no candidates")

    # The rows the screen saw, from the store, on the card and on the
    # CPU: the resampled planes agree bitwise, so only the screen's
    # cosf can tell the two sides apart.
    gpu = SegmentProcessor(device="cuda")
    cpu = SegmentProcessor(device="cpu")
    shards = segment_tasks_from_store(wf.store_dir, granularity="shard")
    rows = [r for t in shards for r in _screen_rows_for_uri(gpu, t.payload)]
    rows_cpu = [r for t in shards
                for r in _screen_rows_for_uri(cpu, t.payload)]
    for a, b in zip(rows, rows_cpu):
        if a.row_id != b.row_id or not all(
                np.array_equal(getattr(a, k), getattr(b, k))
                for k in ("lat", "lon", "alt")):
            raise AssertionError(f"{a.row_id}: card and CPU planes differ")
    if len(rows) != len(rows_cpu):
        raise AssertionError("card and CPU rows differ in number")
    t0 = time.perf_counter()
    want = brute_force_overlapping(rows, wf.screen_config)
    bf_s = time.perf_counter() - t0
    d_bf = same_candidates(got, want, "brute force")

    # The screen tasks re-run on the CPU (plain versions), 8 processes.
    cpu_worker = ScreenWorker(wf.store_dir, h_thresh_m=wf.screen_config.h_thresh_m,
                              v_thresh_m=wf.screen_config.v_thresh_m,
                              device="cpu")
    t0 = time.perf_counter()
    res = run_job(tasks, cpu_worker, backend="processes", n_workers=8,
                  tasks_per_message=4, poll_interval=0.005)
    cpu_s = time.perf_counter() - t0
    cpu_cands = encounter_screen.dedup_candidates(
        c for t in tasks for c in res.results[t.task_id]["candidates"])
    d_cpu = same_candidates(got, cpu_cands, "the CPU re-run")
    say("screen", f"{len(rows)} rows; candidates = brute force over "
                  f"overlapping pairs ({bf_s:.2f}s, max |d| {d_bf:.3g} m) "
                  f"= CPU re-run of {len(tasks)} screen tasks on 8 "
                  f"processes ({cpu_s:.2f}s, max |d| {d_cpu:.3g} m); "
                  f"row planes card = CPU bitwise")

    # The store path's process phase against the zip path's, on the card.
    by_track = gpu.process_batch(
        segment_tasks_from_store(wf.store_dir, granularity="track"))
    by_zip = gpu.process_batch(
        segment_tasks_from_archive_tree(wf.archive_dir))
    if sorted(by_track) != sorted(by_zip):
        raise AssertionError("store and zip task ids differ")
    for tid, z in by_zip.items():
        g = by_track[tid]
        if g.icao24 != z.icao24 or g.airspace != z.airspace or not all(
                np.array_equal(getattr(g, k), getattr(z, k))
                for k in ("count", "times", "lat", "lon", "alt_msl_m",
                          "alt_agl_m", "vrate_ms", "gspeed_ms",
                          "heading_rad", "turn_rad_s")):
            raise AssertionError(f"{tid}: store and zip paths differ")
    say("screen", f"store path = zip path bitwise over {len(by_zip)} "
                  f"tracks on the card")
    profile_screen_tasks(wf, tasks[:SCREEN_PROFILE_TASKS])
    return launches, shapes


def profile_screen_tasks(wf, tasks) -> None:
    """Where a screen task's time goes: ``tasks`` run one after another
    on the card under cProfile (the host split between the store reads,
    the per-track segment pipeline and the cell screen) and
    torch.profiler (device busy time, hence the idle share)."""
    import cProfile
    import pstats
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.tracks.workflow import ScreenWorker

    worker = ScreenWorker(wf.store_dir,
                          h_thresh_m=wf.screen_config.h_thresh_m,
                          v_thresh_m=wf.screen_config.v_thresh_m,
                          device="cuda")
    worker(tasks[0])                            # processor, DEM upload
    host = cProfile.Profile()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        host.enable()
        for t in tasks:
            worker(t)
        torch.cuda.synchronize()
        host.disable()
        wall = time.perf_counter() - t0
    cum = {}
    for (path, _line, name), row in pstats.Stats(host).stats.items():
        key = (os.path.basename(path), name)
        cum[key] = cum.get(key, 0.0) + row[3]
    split = {"store reads": cum.get(("segments.py", "read_observations"), 0),
             "segment pipeline": cum.get(("segments.py", "process_arrays"), 0),
             "cell screen": cum.get(("encounter_screen.py", "screen_cells"), 0)}
    by_kernel = _device_busy(prof)
    busy = sum(by_kernel.values()) / 1e3
    screen_ms = sum(v for k, v in by_kernel.items() if "screen_" in k)
    say("screen", f"{len(tasks)} screen tasks one after another on the "
                  f"card, profiled: {wall:.3f}s wall "
                  f"({wall / len(tasks) * 1e3:.2f} ms a task); host split "
                  + ", ".join(f"{k} {v:.3f}s ({v / wall:.2f})"
                              for k, v in split.items())
                  + (f"; device busy {busy:.4f}s (idle share "
                     f"{1 - busy / wall:.4f}), of it the encounter_screen "
                     f"kernels {screen_ms / 1e3:.4f}s "
                     f"({screen_ms / len(tasks):.4f} ms a task)"
                     if busy > 0 else
                     "; profiler saw no device time: idle share not "
                     "measured"))


def flash_bound(B, H, KV, T, S, hd, causal, itemsize, ops_per_s,
                ops_per_pair=None):
    """(ms, "bytes" | "operations"): q, k, v read once and o written once
    against ``ops_per_pair`` operations (default 4 * hd: 2 hd for the
    score, 2 hd for the weighted sum) for each (query, key) pair the mask
    keeps."""
    # Query t keeps keys 0 .. t + S - T, clipped to [0, S].
    pairs = (sum(min(max(t + S - T + 1, 0), S) for t in range(T))
             if causal else T * S)
    nbytes = itemsize * (2 * B * H * T * hd + 2 * B * KV * S * hd)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (ops_per_pair or 4 * hd) * pairs * B * H / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_flash() -> dict:
    """The flash kernels against their plain version at every shape, each
    through the route its dtype and head_dim select, timed beside the
    plain version, at T == S SDPA, and for bf16 the CUDA-core kernel's
    bf16 entry on the same inputs."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    cases = [(shape, torch.float32) for shape in FLASH_TEST_SHAPES]
    cases.append((FLASH_BF16_SHAPE, torch.bfloat16))
    cases += [((1, 32, 8, T, T, 160, True), dt) for T in FLASH_LM_T
              for dt in (torch.bfloat16, torch.float32)]
    cases.append((FLASH_MAIN_PATH_SHAPE, torch.bfloat16))
    res = {"per_shape": {}, "max_abs_err": 0.0}
    for (B, H, KV, T, S, hd, causal), dt in cases:
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dt)
                   for shape in ((B, H, T, hd), (B, KV, S, hd),
                                 (B, KV, S, hd)))
        bf16 = dt == torch.bfloat16
        route = "sm90" if bf16 else "cuda_core"
        before = dict(flash_mod.launches_by_route)
        got = flash_mod.flash_attention(q, k, v, causal=causal)
        want = ref.flash_attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        name = f"B={B} H={H} KV={KV} T={T} S={S} hd={hd} " \
               f"{'causal' if causal else 'full'} {str(dt)[6:]}"
        routed = {r: flash_mod.launches_by_route[r] - before[r]
                  for r in before}
        if routed != {r: int(r == route) for r in before}:
            raise AssertionError(f"flash_attention at {name} went through "
                                 f"{routed}, expected route {route}")
        rtol, atol = ((FLASH_BF16_RTOL, FLASH_BF16_ATOL) if bf16
                      else (FLASH_F32_TOL, FLASH_F32_TOL))

        def gate(out):
            """(max |out - plain|, whether every element meets the gate,
            share of elements outside it)."""
            d = (out.float() - want).abs()
            outside = d > atol + rtol * want.abs()
            return (d.max().item(), not bool(outside.any()),
                    outside.float().mean().item())

        err, ok, _ = gate(got)
        tol = f"rtol {rtol:.3g}, atol {atol:.3g}"
        if not ok:
            raise AssertionError(f"flash_attention at {name} disagrees with "
                                 f"its plain version: max |diff| {err}")
        runs = 10 if T * S >= 2048 * 2048 else TIMED_RUNS
        row = {"route": route, "max_abs_err": err,
               "ms": device_ms(lambda: flash_mod.flash_attention(
                   q, k, v, causal=causal), runs=runs),
               "plain_ms": device_ms(lambda: ref.flash_attention_ref(
                   q, k, v, causal=causal), runs=runs),
               "library_ms": None, "cuda_core_ms": None}
        if bf16:
            # The CUDA-core kernel's bf16 entry (the route of every bf16
            # input before the tensor-core kernel), called directly on
            # the same inputs.
            old = flash_mod._launch("cuda_core", q, k, v, causal=causal)
            torch.cuda.synchronize()
            row["cuda_core_max_abs_err"], old_ok, _ = gate(old)
            if not old_ok:
                raise AssertionError(f"the CUDA-core bf16 entry at {name} "
                                     f"disagrees with the plain version")
            del old
            row["cuda_core_ms"] = device_ms(lambda: flash_mod._launch(
                "cuda_core", q, k, v, causal=causal), runs=runs)
        if T == S:
            lib = F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                 enable_gqa=True)
            (row["library_max_abs_err"], _,
             row["library_outside_gate"]) = gate(lib)
            del lib
            row["library_ms"] = device_ms(
                lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, enable_gqa=True), runs=runs)
        rate = BF16_OPS_PER_S if bf16 else F32_OPS_PER_S
        row["bound_ms"], row["bound_by"] = flash_bound(
            B, H, KV, T, S, hd, causal, q.element_size(), rate)
        if bf16:
            # The sm90 kernel's own floor: 2 hd for the score and 4 hd for
            # P.V issued twice (hi and lo) per kept pair.
            floor_ms, _ = flash_bound(
                B, H, KV, T, S, hd, causal, q.element_size(), rate,
                ops_per_pair=6 * hd)
        lib = ("-" if row["library_ms"] is None
               else f"{row['library_ms']:.4f}")
        extra = ("" if not bf16 else
                 f", CUDA-core bf16 entry {row['cuda_core_ms']:.4f} ms "
                 f"({row['cuda_core_ms'] / row['ms']:.1f}x), design floor "
                 f"{floor_ms:.4f} ms")
        if "library_outside_gate" in row:
            extra += (f"; SDPA outside the gate: "
                      f"{row['library_outside_gate']:.4f} of the outputs")
        say("flash", f"{name} [{route}]: max|diff| {err:.3g} ({tol}); "
                     f"kernel {row['ms']:.4f} ms, plain "
                     f"{row['plain_ms']:.4f} ms, library {lib} ms, bound "
                     f"{row['bound_ms']:.4f} ms ({row['bound_by']}), "
                     f"{row['ms'] / row['bound_ms']:.1f}x the bound" + extra)
        res["per_shape"][name] = row
        res["max_abs_err"] = max(res["max_abs_err"], err)
        del q, k, v, got, want
    torch.cuda.empty_cache()
    return res


def rel_diff(a, b) -> float:
    return ((a.float() - b.float()).abs().max()
            / (b.float().abs().max() + 1e-6)).item()


def phase_lm() -> dict:
    """stablelm-12b at full width and depth on the card, through the
    port's forward, prefill/decode_step and BatchedServer."""
    import dataclasses
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.models import model as M
    from repro_torch.serving import BatchedServer, Request

    dev = torch.device("cuda")
    cfg = get_arch(LM_ARCH)
    cfg_flash = dataclasses.replace(cfg, attention_impl="flash")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    say("lm", f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
              f"{cfg.n_heads} heads (kv {cfg.n_kv_heads}, hd "
              f"{cfg.head_dim_}), d_ff {cfg.d_ff}, vocab {cfg.vocab_size}: "
              f"{n_params} parameters, {n_bytes / 1e9:.2f} GB on the card, "
              f"drawn in {time.perf_counter() - t0:.2f}s")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (LM_B, LM_T))
                            .astype(np.int32)).to(dev)
    n_tok = LM_B * LM_T

    def timed_forward(c):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = M.forward(c, params, {"tokens": toks})
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    _, warm_s = timed_forward(cfg)              # cuBLAS and allocator warm-up
    del _
    torch.cuda.reset_peak_memory_stats()
    flash_mod.launches = 0
    for r in flash_mod.launches_by_route:
        flash_mod.launches_by_route[r] = 0
    lf, flash_s = timed_forward(cfg_flash)
    launches = flash_mod.launches
    by_route = dict(flash_mod.launches_by_route)
    peak_flash = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    lx, xla_s = timed_forward(cfg)
    peak_xla = torch.cuda.max_memory_allocated()
    rel = rel_diff(lf, lx)
    finite = bool(torch.isfinite(lf).all() and torch.isfinite(lx).all())
    say("lm", f"forward B={LM_B} T={LM_T}: flash {flash_s:.3f}s "
              f"({n_tok / flash_s:.1f} tokens/s, peak "
              f"{peak_flash / 1e9:.2f} GB), xla {xla_s:.3f}s "
              f"({n_tok / xla_s:.1f} tokens/s, peak {peak_xla / 1e9:.2f} "
              f"GB), first (xla, warm-up) {warm_s:.3f}s; flash launches "
              f"{launches} by route {by_route}; max|flash - xla| / max|xla| "
              f"{rel:.3g} (gate {LM_REL_GATE}); finite {finite}")
    if launches != cfg.n_layers or by_route != {"sm90": cfg.n_layers,
                                                "cuda_core": 0}:
        raise AssertionError(f"flash forward launched the kernel {launches} "
                             f"times ({by_route}), expected "
                             f"{cfg.n_layers}, all on the sm90 route")
    if not finite or tuple(lf.shape) != (LM_B, LM_T, cfg.vocab_size):
        raise AssertionError(f"forward logits: shape {tuple(lf.shape)}, "
                             f"finite {finite}")
    if rel >= LM_REL_GATE:
        raise AssertionError(f"flash and xla logits differ: rel {rel}")
    del lf, lx

    # Where a flash forward's device time goes, by kernel.
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        M.forward(cfg_flash, params, {"tokens": toks})
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    busy = _device_busy(prof)
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:8]
    busy_ms = sum(busy.values())
    flash_ms = sum(v for k, v in busy.items() if "flash_attention" in k)
    flash_share = flash_ms / busy_ms
    say("lm", f"profiled flash forward {prof_s * 1e3:.1f} ms wall, device "
              f"busy {busy_ms:.1f} ms (idle share "
              f"{1 - busy_ms / (prof_s * 1e3):.4f}); flash kernel "
              f"{flash_ms:.1f} ms ({flash_share:.4f} of device "
              f"time); top: " + "; ".join(
                  f"{k[:48]} {v:.1f} ms" for k, v in top))

    # prefill(T) + decode_step against forward(T + 1).
    ptoks = toks[:, :LM_DECODE_T + 1]
    _, cache = M.prefill(cfg, params, {"tokens": ptoks[:, :LM_DECODE_T]},
                         cache_len=LM_DECODE_T + 4)
    dec, _ = M.decode_step(cfg, params, cache,
                           {"tokens": ptoks[:, LM_DECODE_T:]})
    full = M.forward(cfg, params, {"tokens": ptoks})
    rel_dec = rel_diff(dec[:, 0], full[:, LM_DECODE_T])
    say("lm", f"prefill({LM_DECODE_T}) + decode_step vs forward("
              f"{LM_DECODE_T + 1}): rel {rel_dec:.3g} (gate {LM_DECODE_GATE})")
    if not rel_dec < LM_DECODE_GATE:
        raise AssertionError(f"decode disagrees with forward: rel {rel_dec}")
    del cache, dec, full

    class TimedServer(BatchedServer):
        """Times each admit (prefill) and engine step; both end in a host
        read of the argmax, so the host clock sees the device finish."""
        def admit(self, req):
            t0 = time.perf_counter()
            ok = super().admit(req)
            if ok:
                self.admit_s.append(time.perf_counter() - t0)
            return ok

        def step(self):
            t0 = time.perf_counter()
            super().step()
            self.step_s.append(time.perf_counter() - t0)

    server = TimedServer(cfg, params, device=dev, **SERVE)
    ids = iter(range(1 + SERVE_REQUESTS * SERVE_ROUNDS))

    def requests(n):
        out = []
        for _ in range(n):
            P = int(rng.integers(16, SERVE["prompt_len"] + 1))
            out.append(Request(next(ids), rng.integers(0, cfg.vocab_size, P),
                               max_new_tokens=SERVE_NEW))
        return out

    # One request outside the timed rounds: the first prefill and decode
    # at these shapes choose their cuBLAS algorithms and grow the cache
    # allocator.
    server.admit_s, server.step_s = [], []
    server.serve(requests(1))
    rounds = []
    for _ in range(SERVE_ROUNDS):
        server.admit_s, server.step_s = [], []
        steps0 = server.steps
        reqs = requests(SERVE_REQUESTS)
        t0 = time.perf_counter()
        server.serve(reqs)
        serve_s = time.perf_counter() - t0
        if not all(r.done and len(r.tokens_out) == SERVE_NEW for r in reqs):
            raise AssertionError(f"requests unfinished: "
                                 f"{[len(r.tokens_out) for r in reqs]}")
        if not all(0 <= t < cfg.vocab_size
                   for r in reqs for t in r.tokens_out):
            raise AssertionError("a token outside the vocabulary")
        n_out = sum(len(r.tokens_out) for r in reqs)
        rounds.append({"tokens_per_s": n_out / serve_s,
                       "step_ms": statistics.median(server.step_s) * 1e3,
                       "admit_ms": statistics.median(server.admit_s) * 1e3})
        say("lm", f"BatchedServer {SERVE}, round {len(rounds)}: "
                  f"{len(reqs)} requests, {n_out} tokens in {serve_s:.3f}s "
                  f"({rounds[-1]['tokens_per_s']:.1f} tokens/s), "
                  f"{server.steps - steps0} engine steps, decode step "
                  f"{rounds[-1]['step_ms']:.1f} ms (median; first "
                  f"{server.step_s[0] * 1e3:.1f} ms), admit (prefill of "
                  f"one prompt + splice) {rounds[-1]['admit_ms']:.1f} ms "
                  f"(median)")
    step_ms = [r["step_ms"] for r in rounds]
    say("lm", f"decode step over {SERVE_ROUNDS} rounds: median "
              f"{statistics.median(step_ms):.1f} ms, spread (max - min) / "
              f"min {(max(step_ms) - min(step_ms)) / min(step_ms):.3f}")

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.step()
        step_prof_s = time.perf_counter() - t0
    busy = _device_busy(prof)
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:6]
    busy_ms = sum(busy.values())
    say("lm", f"profiled decode step {step_prof_s * 1e3:.1f} ms wall, "
              f"device busy {busy_ms:.1f} ms (idle share "
              f"{1 - busy_ms / (step_prof_s * 1e3):.4f}); top: " + "; ".join(
                  f"{k[:48]} {v:.1f} ms" for k, v in top))
    del server, params
    torch.cuda.empty_cache()
    return {"launches": launches, "launches_by_route": by_route,
            "forward_tokens_per_s": n_tok / flash_s,
            "forward_flash_share": flash_share}


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _device_busy(prof) -> dict:
    """Device time (ms) by kernel name from a torch.profiler run."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    return {e.key: getattr(e, "self_device_time_total", 0.0) / 1e3
            for e in prof.key_averages()
            if getattr(e, "device_type", None) == cuda}


def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke.py: src/repro_torch is missing; run it from "
              "the repository root", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    say("setup", f"python {sys.version.split()[0]}, torch "
                 f"{torch.__version__}, CUDA {torch.version.cuda}, "
                 f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card, screen_floor = phase_build()

    from repro_torch.geometry.dem import SyntheticGlobeDEM
    t0 = time.perf_counter()
    globe = SyntheticGlobeDEM(cells_per_deg=120)
    say("setup", f"GLOBE-resolution DEM generated in "
                 f"{time.perf_counter() - t0:.2f}s")
    results = phase_kernels(globe)
    screen = phase_screen_kernels(screen_floor)
    launches, archive_dir, zip_shapes = phase_workflow()
    phase_globe(archive_dir, globe)
    screen_launches, screen_shapes = phase_screen_workflow()
    top_shapes = phase_workflow_shapes({"zip workflow": zip_shapes,
                                        "store+screen workflow":
                                            screen_shapes})
    flash = phase_flash()
    lm = phase_lm()

    from repro_torch.kernels import _build
    sources = {"track_interp": "track_interp.cu",
               "agl_lookup": "agl_lookup.cu",
               "dynamic_rates": "dynamic_rates.cu",
               "encounter_screen": "encounter_screen.cu"}
    replaces = {"track_interp": "src/repro/kernels/track_interp.py:89",
                "agl_lookup": "src/repro/kernels/agl_lookup.py:94",
                "dynamic_rates": "src/repro/kernels/dynamic_rates.py:77",
                "encounter_screen":
                    "src/repro/kernels/encounter_screen.py:169"}
    rows = []
    for name, res in results.items():
        top = res["per_width"][WIDTHS[-1]]
        rows.append({
            "name": name, "route": "cuda",
            "source": os.path.relpath(_build.SRC_DIR / sources[name],
                                      HERE),
            "replaces": replaces[name],
            "launches": launches[name],
            "max_abs_err": res["max_abs_err"],
            "rtol": TOL[name][0], "atol": TOL[name][1],
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"],
            "shape": f"B={B_ROWS} N={N_KNOTS} M={WIDTHS[-1]}",
            "per_width": {str(w): {k: v for k, v in r.items() if k != "plan"}
                          for w, r in res["per_width"].items()},
            "launches_screen_workflow": screen_launches[name],
        })
        if name in SHAPED:
            rows[-1]["plan"] = top["plan"]
            rows[-1]["floor_ms"] = top["floor_ms"]
            rows[-1]["workflow_top_shapes"] = {
                label: {k: v for k, v in by[name].items() if k != "plan"}
                for label, by in top_shapes.items()}
        if "ieee_dt" in res:
            rows[-1]["ieee_dt"] = {k: v for k, v in res["ieee_dt"].items()
                                   if k != "plan"}
    C, K, T = SCREEN_TOP_SHAPE
    top = screen["per_shape"][f"{C}x{K}x{T}"]
    rows.append({
        "name": "encounter_screen", "route": "cuda",
        "source": os.path.relpath(_build.SRC_DIR / sources[
            "encounter_screen"], HERE),
        "replaces": replaces["encounter_screen"],
        "launches": screen_launches["encounter_screen"],
        "max_abs_err": screen["max_abs_err"],
        "rtol": TOL["encounter_screen"][0],
        "atol": TOL["encounter_screen"][1],
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": None, "shape": f"C={C} K={K} T={T}",
        "per_shape": screen["per_shape"],
    })
    top_name = f"B=1 H=32 KV=8 T={FLASH_LM_T[-1]} S={FLASH_LM_T[-1]} " \
               f"hd=160 causal bfloat16"
    top = flash["per_shape"][top_name]
    rows.append({
        "name": "flash_attention", "route": "cuda",
        "source": os.path.relpath(_build.SRC_DIR / "flash_attention_sm90.cu",
                                  HERE),
        "cuda_core_source": os.path.relpath(
            _build.SRC_DIR / "flash_attention.cu", HERE),
        "cuda_core_ms": top["cuda_core_ms"],
        "launches_by_route": lm["launches_by_route"],
        "replaces": "src/repro/kernels/flash_attention.py:124",
        "launches": lm["launches"],
        "max_abs_err": flash["max_abs_err"],
        "rtol": FLASH_F32_TOL, "atol": FLASH_F32_TOL,
        "bf16_rtol": FLASH_BF16_RTOL, "bf16_atol": FLASH_BF16_ATOL,
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": top["library_ms"], "shape": top_name,
        "per_shape": flash["per_shape"],
        "lm_forward_tokens_per_s": lm["forward_tokens_per_s"],
        "lm_forward_flash_share": lm["forward_flash_share"],
    })
    say("done", f"all phases passed in {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
