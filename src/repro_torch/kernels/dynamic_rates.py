"""dynamic_rates: vertical rate, ground speed, heading, turn (CUDA).

Port of the TPU kernel ``repro/kernels/dynamic_rates.py``; the kernel
is ``csrc/dynamic_rates.cu``.  :func:`dynamic_rates` launches it on CUDA
tensors and runs the plain version on CPU tensors.
"""

from __future__ import annotations

import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import dynamic_rates_ref

__all__ = ["dynamic_rates", "dynamic_rates_ref", "launches"]

#: Kernel launches since the last reset (set to 0 to reset).
launches = 0
_count_lock = threading.Lock()


def dynamic_rates(v: torch.Tensor, count: torch.Tensor,
                  dt: float) -> torch.Tensor:
    """v (B,3,M) f32, count (B,) i32 -> (B,4,M) f32.
    See ref.dynamic_rates_ref."""
    global launches
    if v.device.type == "cpu":
        return dynamic_rates_ref(v, count, dt)
    B, C, M = v.shape
    if C != 3:
        raise ValueError(f"dynamic_rates: v has {C} channels, needs 3")
    _build.check_inputs(
        "dynamic_rates",
        {"v": (v, torch.float32), "count": (count, torch.int32)},
        {"v": (B, 3, M), "count": (B,)})
    out = torch.empty((B, 4, M), dtype=torch.float32, device=v.device)
    with torch.cuda.device(v.device):
        rc = _build.lib().dynamic_rates_f32(
            v.data_ptr(), count.data_ptr(), out.data_ptr(), B, M, float(dt),
            _build.stream_of(v))
    _build.check(rc, "dynamic_rates")
    with _count_lock:
        launches += 1
    return out
