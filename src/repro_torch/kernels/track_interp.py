"""track_interp: piecewise-linear resample of track knots (CUDA).

Port of the TPU kernel ``repro/kernels/track_interp.py``; the kernel is
``csrc/track_interp.cu``.  :func:`track_interp` launches it on CUDA
tensors and runs the plain version on CPU tensors.
"""

from __future__ import annotations

import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import track_interp_ref

__all__ = ["track_interp", "track_interp_ref", "launches"]

#: Kernel launches since the last reset (set to 0 to reset).
launches = 0
_count_lock = threading.Lock()

# Dynamic shared memory holds one row's knot times.
_MAX_KNOTS = 48 * 1024 // 4


def track_interp(t_in: torch.Tensor, v_in: torch.Tensor, count: torch.Tensor,
                 t_out: torch.Tensor) -> torch.Tensor:
    """t_in (B,N) f32, v_in (B,C,N) f32, count (B,) i32 (each in [2, N]),
    t_out (B,M) f32 -> (B,M,C) f32.  See ref.track_interp_ref."""
    global launches
    if t_in.device.type == "cpu":
        return track_interp_ref(t_in, v_in, count, t_out)
    B, N = t_in.shape
    C, M = v_in.shape[1], t_out.shape[1]
    _build.check_inputs(
        "track_interp",
        {"t_in": (t_in, torch.float32), "v_in": (v_in, torch.float32),
         "count": (count, torch.int32), "t_out": (t_out, torch.float32)},
        {"t_in": (B, N), "v_in": (B, C, N), "count": (B,), "t_out": (B, M)})
    if not 2 <= N <= _MAX_KNOTS:
        raise ValueError(f"track_interp: N={N} outside [2, {_MAX_KNOTS}]")
    out = torch.empty((B, M, C), dtype=torch.float32, device=t_in.device)
    with torch.cuda.device(t_in.device):
        rc = _build.lib().track_interp_f32(
            t_in.data_ptr(), v_in.data_ptr(), count.data_ptr(),
            t_out.data_ptr(), out.data_ptr(), B, N, C, M,
            _build.stream_of(t_in))
    _build.check(rc, "track_interp")
    with _count_lock:
        launches += 1
    return out
