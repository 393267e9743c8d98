"""Time ``csrc/track_interp.cu`` and ``csrc/dynamic_rates.cu`` against an
earlier design of the same two kernels, at the track workflows' own
few-row launch shapes and at the process phase's full bucket, beside
the launch floor (an empty kernel on each design's grid), and time the
current kernels with fewer threads on a row (so more steps of 4
queries or positions in each thread's chain), which shows what one step
of a thread's chain costs when a launch has a few rows.

Run from the repository root on a machine with a card and ``nvcc``::

    PYTHONPATH=src python -m repro_torch.kernels.interp_rates_ab \\
        --earlier DIR

``DIR`` holds the earlier design's ``track_interp.cu`` and
``dynamic_rates.cu`` (one block per row and 256-query tile, one query
or position a thread), e.g. ``src/repro_torch/kernels/csrc`` of commit
2b9d137 unpacked with ``git archive``.  They are built with this
package's flags into a library of their own.  Every result is held
bitwise to the plain version before it is timed with CUDA events, as
chip_smoke.py times its kernels.  Prints one line per case, the card's
name and power limit, then one JSON line of median ms.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
from pathlib import Path

from repro_torch.kernels import _build
from repro_torch.kernels import dynamic_rates as dr
from repro_torch.kernels import ref
from repro_torch.kernels import track_interp as ti

N_KNOTS = 128
# (B, M): the store + screen workflow's top shape and its B = 1 range,
# the zip workflow's top shape, and the process phase's bucket.
SHAPES = ((1, 128), (1, 256), (1, 1024), (4, 1024), (1024, 1024))
# Threads on a row for the chain sweep at B = 1, M = 1024: 1, 2, 4 and
# 8 steps of 4 a thread.
PER_ROW = (256, 128, 64, 32)
RUNS = 30
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
EARLIER_SIGNATURES = {
    "track_interp_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "dynamic_rates_f32": (_P, _P, _P, _I, _I, _F, _P),
}


def _earlier_lib(src_dir: Path) -> ctypes.CDLL:
    sources = [src_dir / "track_interp.cu", src_dir / "dynamic_rates.cu"]
    target = _build.BUILD_DIR / f"libearlier-{_build._digest(sources)}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    if not target.exists():
        _build._compile(sources, target)
    lib = ctypes.CDLL(str(target))
    for name, argtypes in EARLIER_SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


def _inputs(rng, B: int, M: int):
    """Rows as chip_smoke.py's bucket_inputs builds them: 10-120
    irregular knots about 10 s apart covering half to all of the row's
    1 Hz grid, over CONUS."""
    import numpy as np
    N = N_KNOTS
    t_in = np.zeros((B, N), np.float32)
    v_in = np.zeros((B, 3, N), np.float32)
    count_in = np.zeros(B, np.int32)
    t_out = np.zeros((B, M), np.float32)
    count_out = np.zeros(B, np.int32)
    for b in range(B):
        m = int(rng.integers(M // 2 + 1, M + 1))
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


def _ms(fn) -> float:
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(RUNS + 1)]
    torch.cuda._sleep(200_000_000)
    ev[0].record()
    for i in range(RUNS):
        fn()
        ev[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(ev[i].elapsed_time(ev[i + 1])
                             for i in range(RUNS))


def _median3(fn) -> float:
    return statistics.median(_ms(fn) for _ in range(3))


def _held(name: str, got, want) -> None:
    import torch
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: not bitwise the plain version")


def _interp_split(t_in, v_in, count, t_out, out, split):
    """The current kernel on a given split (plan()'s, or with fewer
    threads a row); returns out."""
    B, N = t_in.shape
    C, M = v_in.shape[1], t_out.shape[1]
    _build.check(_build.lib().track_interp_f32(
        t_in.data_ptr(), v_in.data_ptr(), count.data_ptr(),
        t_out.data_ptr(), out.data_ptr(), B, N, C, M, split.rows,
        split.per_row, split.blocks, split.smem,
        int(split.route == "gather"), int(split.vec),
        _build.stream_of(t_in)), "track_interp")
    return out


def _rates_split(v, count, out, split):
    B, _, M = v.shape
    _build.check(_build.lib().dynamic_rates_f32(
        v.data_ptr(), count.data_ptr(), out.data_ptr(), B, M, 1.0,
        split.rows, split.per_row, split.blocks, int(split.vec),
        _build.stream_of(v)), "dynamic_rates")
    return out


def main() -> None:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--earlier", type=Path, required=True,
                    help="directory of the earlier design's sources")
    args = ap.parse_args()
    old = _earlier_lib(args.earlier)
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    rows = []
    for B, M in SHAPES:
        t_in, v_in, count_in, t_out, count_out = (
            torch.from_numpy(x).to(dev) for x in _inputs(rng, B, M))
        # The earlier kernels write into contiguous (B,M,C) and (B,4,M)
        # buffers (the plain interp output is a transposed view).
        want_i = ref.track_interp_ref(t_in, v_in, count_in, t_out)
        out_i = torch.empty(want_i.shape, device=dev)
        v = want_i.permute(0, 2, 1).contiguous()
        want_r = ref.dynamic_rates_ref(v, count_out, 1.0)
        out_r = torch.empty(want_r.shape, device=dev)
        stream = _build.stream_of(v)

        def old_interp():
            _build.check(old.track_interp_f32(
                t_in.data_ptr(), v_in.data_ptr(), count_in.data_ptr(),
                t_out.data_ptr(), out_i.data_ptr(), B, N_KNOTS, 3, M,
                stream), "earlier track_interp")
            return out_i

        def old_rates():
            _build.check(old.dynamic_rates_f32(
                v.data_ptr(), count_out.data_ptr(), out_r.data_ptr(), B, M,
                1.0, stream), "earlier dynamic_rates")
            return out_r

        def new_interp():
            return ti.track_interp(t_in, v_in, count_in, t_out)

        def new_rates():
            return dr.dynamic_rates(v, count_out, 1.0)

        row = {"shape": f"B={B} N={N_KNOTS} M={M}"}
        # The launch floor: an empty kernel on each design's interp grid.
        split = ti.plan(B, N_KNOTS, 3, M)
        for name, grid in (
                ("floor", (split.blocks, split.rows * split.per_row,
                           split.smem)),
                ("floor_earlier", (B * -(-M // 256), 256, N_KNOTS * 4))):
            row[f"{name}_ms"] = _median3(lambda: _build.check(
                _build.lib().launch_floor(*grid, stream), "launch_floor"))
        for name, fn, want in (("interp", new_interp, want_i),
                               ("interp_earlier", old_interp, want_i),
                               ("rates", new_rates, want_r),
                               ("rates_earlier", old_rates, want_r)):
            _held(name, fn(), want)
            torch.cuda.synchronize()
            row[f"{name}_ms"] = _median3(fn)
        if B == 1 and M == 1024:
            # The chain sweep: the same launch with fewer threads a row.
            ip = ti.plan(B, N_KNOTS, 3, M)
            rp = dr.plan(B, M)
            for k in PER_ROW:
                isp = ip._replace(per_row=k, smem=ip.smem
                                  - 48 * ip.rows * (ip.per_row - k))
                rsp = rp._replace(per_row=k)
                _held(f"interp per_row {k}",
                      _interp_split(t_in, v_in, count_in, t_out, out_i, isp),
                      want_i)
                _held(f"rates per_row {k}",
                      _rates_split(v, count_out, out_r, rsp), want_r)
                row[f"interp_per_row{k}_ms"] = _median3(
                    lambda: _interp_split(t_in, v_in, count_in, t_out,
                                          out_i, isp))
                row[f"rates_per_row{k}_ms"] = _median3(
                    lambda: _rates_split(v, count_out, out_r, rsp))
        rows.append(row)
        print(row, flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    print(json.dumps({"interp_rates_ab": rows}))


if __name__ == "__main__":
    main()
