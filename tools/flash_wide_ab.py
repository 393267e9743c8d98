"""Time the wide flash kernels (``csrc/flash_attention_wide.cu`` and
``csrc/flash_attention_wide_f32.cu``) compiled for each widest output
chunk (128, 192 and 256 columns) at chip_smoke.py phase 6's causal
T = S = 1024 wide shapes, in f16, bf16 and f32.

Run from the repository root on a machine with a card and ``nvcc``::

    PYTHONPATH=src python tools/flash_wide_ab.py

The kernels take their chunk width from the caller and are compiled for
the widths from ``kMaxCW / 2 + 32`` to ``kMaxCW``.  For each cap this
script copies the two sources under ``build/kernels/wide_ab_cw<cap>/``
with ``kMaxCW`` set to the cap, compiles them into a library of their
own (as ``kernels/_build.py`` compiles the sources), and calls its C
entries with the plan of ``flash_attention.wide_plan`` at that cap (at
256, that function's own plan).  Every result is held to the plain
version at its dtype's gate before it is timed with CUDA events.  Prints
ptxas' registers and spills per instantiation, one line per case (the
chunk plan, the kernel's time, its design floor), the card's name and
power limit, then one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import re
import statistics
import subprocess

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import ref

CAPS = (128, 192, 256)
SOURCES = ("flash_attention_wide.cu", "flash_attention_wide_f32.cu")
CAP_LINE = "constexpr int kMaxCW = 256;"
# (B, H, KV, T, S, hd): chip_smoke.py's FLASH_WIDE_HD_SHAPES at T = S;
# every hd is a multiple of 8, so no zero-padding is needed.
SHAPES = ((1, 16, 4, 1024, 1024, 320), (1, 16, 2, 1024, 1024, 384),
          (1, 8, 1, 1024, 1024, 512), (1, 8, 2, 1024, 1024, 1024))
DTYPES = ("float16", "bfloat16", "float32")
# (rtol, atol): one rounding of each output dtype.
GATES = {"float16": (2.0 ** -11, 1e-5), "bfloat16": (2.0 ** -8, 1e-5),
         "float32": (2e-5, 2e-5)}
TC16_OPS_PER_S, TF32_OPS_PER_S = 989e12, 495e12
RUNS = 20


def plan(hd: int, cap: int) -> tuple[int, int]:
    """wide_plan's rule with the widest chunk ``cap``."""
    n = -(-hd // cap)
    width = -(-hd // (32 * n)) * 32
    return -(-hd // width), width


def build(cap: int) -> tuple[ctypes.CDLL, list[str]]:
    """The two wide sources compiled with kMaxCW = ``cap``, and ptxas'
    registers and spills per instantiation."""
    work = _build.BUILD_DIR / f"wide_ab_cw{cap}"
    work.mkdir(parents=True, exist_ok=True)
    sources = []
    for name in SOURCES:
        text = (_build.SRC_DIR / name).read_text()
        if text.count(CAP_LINE) != 1:
            raise AssertionError(f"{name}: no single '{CAP_LINE}'")
        text = text.replace(CAP_LINE, f"constexpr int kMaxCW = {cap};")
        src = work / name
        if not src.exists() or src.read_text() != text:
            src.write_text(text)
        sources.append(src)
    target = work / f"libwide-{_build._digest(sources)}.so"
    if not target.exists():
        _build._compile(sources, target)
    lib = ctypes.CDLL(str(target))
    for dt in (torch.bfloat16, torch.float16, torch.float32):
        fn = getattr(lib, flash_mod._KERNELS[dt][2])
        fn.argtypes = _build.SIGNATURES[flash_mod._KERNELS[dt][2]]
        fn.restype = ctypes.c_int
    regs, kernel = [], ""
    for line in target.with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            found = re.search(r"flash_attention_wide_\w*?kernelI\w*?E", name)
            kernel = found.group(0) if found else name
        elif kernel and ("registers" in line or "spill" in line):
            regs.append(f"{kernel}: {line.split(':', 1)[-1].strip()}")
    return lib, regs


def median_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(RUNS + 1)]
    torch.cuda._sleep(100_000_000)
    ev[0].record()
    for i in range(RUNS):
        fn()
        ev[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(ev[i].elapsed_time(ev[i + 1])
                             for i in range(RUNS))


def floor_ms(B, H, T, S, hd, dtype, n_chunks) -> float:
    """The recompute-per-chunk design floor: per kept (causal) pair,
    2 hd n_chunks + 4 hd in 16 bits at 989 TFLOP/s, 3 (2 hd n_chunks +
    2 hd) in f32 at 495 TF32."""
    pairs = sum(min(S, t + 1 + S - T) for t in range(T))
    if dtype == "float32":
        ops, rate = 3 * (2 * hd * n_chunks + 2 * hd), TF32_OPS_PER_S
    else:
        ops, rate = 2 * hd * n_chunks + 4 * hd, TC16_OPS_PER_S
    return ops * pairs * B * H / rate * 1e3


def main() -> None:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    libs = {}
    for cap in CAPS:
        libs[cap], regs = build(cap)
        for line in regs:
            print(f"cap {cap}: {line}", flush=True)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows = []
    for B, H, KV, T, S, hd in SHAPES:
        assert plan(hd, flash_mod.WIDE_MAX_CHUNK) == flash_mod.wide_plan(hd)
        for name in DTYPES:
            dt = getattr(torch, name)
            q, k, v = (torch.randn(s, generator=gen, device=dev).to(dt)
                       for s in ((B, H, T, hd), (B, KV, S, hd),
                                 (B, KV, S, hd)))
            want = ref.flash_attention_ref(q, k, v, causal=True)
            out = torch.empty_like(q)
            rtol, atol = GATES[name]
            row = {"shape": f"B={B} H={H} KV={KV} T={T} S={S} hd={hd}",
                   "dtype": name}
            for cap in CAPS:
                n_chunks, cw = plan(hd, cap)
                entry = getattr(libs[cap], flash_mod._KERNELS[dt][2])

                def call():
                    _build.check(entry(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), B, H, KV, T, S, hd, hd, cw, 1,
                        hd ** -0.5, stream), "flash_wide_ab")
                out.zero_()
                call()
                torch.cuda.synchronize()
                got = out.float()
                bad = ((got - want).abs()
                       > atol + rtol * want.abs()).sum().item()
                if bad:
                    raise AssertionError(
                        f"cap {cap} at {row['shape']} {name}: {bad} "
                        f"outputs outside the gate")
                ms = statistics.median(median_ms(call) for _ in range(3))
                row[f"cw{cap}"] = {
                    "n_chunks": n_chunks, "cw": cw, "ms": ms,
                    "floor_ms": floor_ms(B, H, T, S, hd, name, n_chunks)}
                print(f"{row['shape']} {name} cap {cap}: {n_chunks} x {cw} "
                      f"columns, {ms:.4f} ms, design floor "
                      f"{row[f'cw{cap}']['floor_ms']:.4f} ms", flush=True)
            rows.append(row)
            del q, k, v, want, out
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    print(json.dumps({"flash_wide_ab": rows}))


if __name__ == "__main__":
    main()
