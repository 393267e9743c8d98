"""Time ``csrc/flash_attention.cu``, the CUDA-core flash kernel, built
with ``-fmad=true`` and with ``-fmad=false``: the measurement behind its
entry in ``_build.FMA_SOURCES``.  That source serves f32 inputs and bf16
inputs whose head_dim is not a multiple of 8; both of its entries are
called directly here (bf16 at hd 160 is otherwise routed to
``csrc/flash_attention_sm90.cu``).

Run from the repository root on a machine with a card and ``nvcc``::

    PYTHONPATH=src python -m repro_torch.kernels.fmad_ab

Both builds go to ``build/kernels/fmad_ab/`` (compiled together).  Each
is held against the plain version (rtol/atol 2e-5 in f32, rtol 2^-8 and
atol 1e-5 in bf16) and timed with CUDA events at stablelm-12b's
attention (B = 1, H = 32, KV = 8, hd = 160, causal), in the order true,
false, false, true.  Prints one JSON line of median ms per build.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess

from repro_torch.kernels import _build

SHAPES = ((1, 32, 8, 2048, 2048, 160), (1, 32, 8, 4096, 4096, 160))
RUNS = 10


def _build_variants() -> dict[str, ctypes.CDLL]:
    out_dir = _build.BUILD_DIR / "fmad_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = _build.SRC_DIR / "flash_attention.cu"
    procs = {}
    for fmad in ("true", "false"):
        so = out_dir / f"flash_attention_fmad_{fmad}.so"
        procs[fmad] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-fmad={fmad}", "-shared",
             str(src), "-o", str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for fmad, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc -fmad={fmad} failed:\n{log}")
        lib = ctypes.CDLL(str(so))
        for name in ("flash_attention_f32", "flash_attention_bf16"):
            fn = getattr(lib, name)
            fn.argtypes = _build.SIGNATURES[name]
            fn.restype = ctypes.c_int
        libs[fmad] = lib
    return libs


def _ms(fn) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(RUNS + 1)]
    ev[0].record()
    for i in range(RUNS):
        fn()
        ev[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(ev[i].elapsed_time(ev[i + 1])
                             for i in range(RUNS))


def main() -> None:
    import torch
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ref

    torch.backends.cuda.matmul.allow_tf32 = False
    libs = _build_variants()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for B, H, KV, T, S, hd in SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = (torch.randn(s, generator=gen, device="cuda").to(dt)
                       for s in ((B, H, T, hd), (B, KV, S, hd),
                                 (B, KV, S, hd)))
            want = ref.flash_attention_ref(q, k, v)
            tol = (2e-5, 2e-5) if dt == torch.float32 else (2 ** -8, 1e-5)
            times = {"true": [], "false": []}
            for fmad in ("true", "false", "false", "true"):
                # The wrapper launches whatever library _build holds.
                _build._lib = libs[fmad]
                got = flash_mod.flash_attention(q, k, v)
                torch.testing.assert_close(got.float(), want, rtol=tol[0],
                                           atol=tol[1])
                times[fmad].append(
                    _ms(lambda: flash_mod.flash_attention(q, k, v)))
            rows.append({"shape": f"B={B} H={H} KV={KV} T={T} S={S} "
                                  f"hd={hd} causal {str(dt)[6:]}",
                         **{f"fmad_{f}_ms": statistics.median(t)
                            for f, t in times.items()}})
            print(rows[-1], flush=True)
    _build._lib = None
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    print(json.dumps({"fmad_ab": rows}))


if __name__ == "__main__":
    main()
