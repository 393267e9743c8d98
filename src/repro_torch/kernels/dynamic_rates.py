"""dynamic_rates: vertical rate, ground speed, heading, turn (CUDA).

Port of the TPU kernel ``repro/kernels/dynamic_rates.py``; the kernel
is ``csrc/dynamic_rates.cu``.  :func:`dynamic_rates` launches it on CUDA
tensors and runs the plain version on CPU tensors.  :func:`plan` splits
a launch by a fixed rule.
"""

from __future__ import annotations

import threading
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import dynamic_rates_ref

__all__ = ["dynamic_rates", "dynamic_rates_ref", "plan", "RatesPlan",
           "launches", "launches_by_shape", "last_plan"]

#: Kernel launches since the last reset (set to 0 to reset).
launches = 0
#: Kernel launches by (B, M) shape (clear to reset).
launches_by_shape: Dict[Tuple[int, int], int] = {}
_count_lock = threading.Lock()


class RatesPlan(NamedTuple):
    """How one launch splits its work (``csrc/dynamic_rates.cu``):
    ``rows`` per block, ``per_row`` threads on each row (a multiple of
    32; 4 positions a thread, looping past 4 * per_row), ``blocks`` (the
    grid the kernel is launched on), and ``vec``: 16-byte loads and
    stores, else scalar ones."""

    rows: int
    per_row: int
    blocks: int
    vec: bool


def plan(B: int, M: int, aligned: bool = True) -> RatesPlan:
    """The fixed rule: a row gets a warp-multiple of threads for its
    M / 4 position groups (at most 256) and a block as many whole rows
    as fit 256 threads (``_build.row_split``); the 16-byte path where
    M % 4 == 0 and the input and output bases are ``aligned`` to 16
    bytes."""
    rows, per_row = _build.row_split(M)
    return RatesPlan(rows, per_row, -(-B // rows), M % 4 == 0 and aligned)


#: The split of the most recent kernel launch (None before the first).
last_plan: Optional[RatesPlan] = None


def dynamic_rates(v: torch.Tensor, count: torch.Tensor,
                  dt: float) -> torch.Tensor:
    """v (B,3,M) f32, count (B,) i32 -> (B,4,M) f32.  See
    ref.dynamic_rates_ref; the kernel reads a count above M as M."""
    global launches, last_plan
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
    split = plan(B, M, aligned=(v.data_ptr() | out.data_ptr()) % 16 == 0)
    with torch.cuda.device(v.device):
        rc = _build.lib().dynamic_rates_f32(
            v.data_ptr(), count.data_ptr(), out.data_ptr(), B, M, float(dt),
            split.rows, split.per_row, split.blocks, int(split.vec),
            _build.stream_of(v))
    _build.check(rc, "dynamic_rates")
    with _count_lock:
        launches += 1
        launches_by_shape[(B, M)] = launches_by_shape.get((B, M), 0) + 1
        last_plan = split
    return out
