"""Build the CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

The sources under ``csrc/`` compile into one ``libkernels-<hash>.so``
under ``build/kernels/`` at the repository root, at first use: each
``.cu`` file goes to its own ``nvcc -c`` (all started together), then
one link.  The hash covers the sources and the flags, so an edit
rebuilds and an unchanged tree loads the library it already has.  The C
entry points take plain pointers and the caller's stream, launch, and
return ``cudaGetLastError()``; :func:`check` raises on anything but 0.

Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

# No --use_fast_math: it would swap atan2f/cosf/sqrtf and IEEE division
# for approximations.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# -fmad=false keeps products out of fused adds, as the plain versions
# compute them, for the kernels held bitwise to them.  The flash sources
# are held to a tolerance instead and may fuse (the flag decides little
# there: their products run on the tensor cores, and every exponent
# argument is an explicit fmaf).
FMA_SOURCES = ("flash_attention_sm90.cu", "flash_attention_f32_sm90.cu",
               "flash_attention_wide.cu", "flash_attention_wide_f32.cu")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong

# The flash entries: q, k, v, o, B, H, KV, T, S, hd, hd_out, causal,
# scale, stream.
_FLASH = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P)
# The wide flash entries take the plan's chunk width cw after hd_out.
_FLASH_WIDE = _FLASH[:11] + (_I,) + _FLASH[11:]

#: C entry point -> argtypes (every pointer and the stream as c_void_p).
SIGNATURES = {
    "track_interp_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                         _I, _I, _I, _P),
    "agl_lookup_f32": (_P, _P, _P, _P, _P, _LL, _I, _I, _F, _F, _P),
    "dynamic_rates_f32": (_P, _P, _P, _I, _I, _F, _I, _I, _I, _I, _P),
    "encounter_screen_f32": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _I, _I, _F, _F, _P),
    "flash_attention_bf16_sm90": _FLASH,
    "flash_attention_f16_sm90": _FLASH,
    "flash_attention_f32_sm90": _FLASH,
    "flash_attention_wide_bf16": _FLASH_WIDE,
    "flash_attention_wide_f16": _FLASH_WIDE,
    "flash_attention_wide_f32": _FLASH_WIDE,
    "launch_floor": (_I, _I, _I, _P),
}

_lock = threading.Lock()
_lib = None
#: Seconds the last :func:`lib` call spent compiling (0 when cached).
build_seconds = 0.0


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def _flags(src: Path) -> tuple[str, ...]:
    fmad = "true" if src.name in FMA_SOURCES else "false"
    return NVCC_FLAGS + (f"-fmad={fmad}",)


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256()
    for src in sources:
        h.update(" ".join(_flags(src)).encode())
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return nvcc


def _compile(sources: list[Path], target: Path) -> None:
    """Compile every source in parallel, link, and install atomically."""
    nvcc = _nvcc()
    work = target.with_suffix(f".tmp{os.getpid()}")
    work.mkdir(parents=True, exist_ok=True)
    objs, procs = [], []
    for src in sources:
        obj = work / (src.stem + ".o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *_flags(src), "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    log = []
    failed = []
    for src, proc in zip(sources, procs):
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode:
            failed.append(src.name)
    if not failed:
        so = work / target.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", *map(str, objs),
             "-o", str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link\n{link.stdout}")
        if link.returncode:
            failed.append("link")
    target.with_suffix(".log").write_text("".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n"
                           + "".join(log))
    os.replace(work / target.name, target)
    shutil.rmtree(work, ignore_errors=True)


def lib() -> ctypes.CDLL:
    """The kernel library, built on first use (thread- and process-safe)."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        sources = _sources()
        target = library_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / "build.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not target.exists():
                t0 = time.perf_counter()
                _compile(sources, target)
                build_seconds = time.perf_counter() - t0
        handle = ctypes.CDLL(str(target))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
        return _lib


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    return BUILD_DIR / f"libkernels-{_digest(_sources())}.so"


def build_log() -> str:
    """What nvcc and ptxas said for the current library (registers,
    shared memory, spills per kernel)."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def stream_of(tensor) -> int:
    """The raw handle of torch's current stream on ``tensor``'s device."""
    import torch
    return torch.cuda.current_stream(tensor.device).cuda_stream


def row_split(M: int, max_rows: int = 8) -> tuple[int, int]:
    """(rows, per_row) for the kernels that give each row's M / 4 groups
    of 4 a warp-multiple of threads (per_row, at most 256, which loop
    past 4 * per_row) and a block of 256 threads up to ``max_rows``
    whole rows."""
    threads = 256
    groups = -(-M // 4)
    warps = -(-groups // 32)
    per_row = 32 * min(threads // 32, warps)
    return max(1, min(threads // per_row, max_rows)), per_row


def check_inputs(name: str, tensors: dict, shapes: dict) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor of the
    expected dtype and shape, all on one device.  ``tensors`` maps an
    argument name to (tensor, dtype); ``shapes`` maps it to a shape."""
    device = None
    for arg, (t, dtype) in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} is on {t.device}, not cuda")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, "
                             f"others on {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} is {t.dtype}, needs {dtype}")
        if tuple(t.shape) != tuple(shapes[arg]):
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"needs {tuple(shapes[arg])}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")
