"""track_interp: piecewise-linear resample of track knots (CUDA).

Port of the TPU kernel ``repro/kernels/track_interp.py``; the kernel is
``csrc/track_interp.cu``.  :func:`track_interp` launches it on CUDA
tensors and runs the plain version on CPU tensors.  :func:`plan` splits
a launch by a fixed rule: the "shared" route stages each row's knot
times and value planes in shared memory, the "gather" route only the
times, for rows too long for a block's shared memory.
"""

from __future__ import annotations

import threading
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import track_interp_ref

__all__ = ["track_interp", "track_interp_ref", "plan", "InterpPlan",
           "launches", "launches_by_route", "launches_by_shape",
           "last_plan", "MAX_KNOTS"]

#: Kernel launches since the last reset (set to 0 to reset).
launches = 0
#: The same launches by route (set the values to 0 to reset).
launches_by_route = {"shared": 0, "gather": 0}
#: Kernel launches by (B, N, M) shape (clear to reset).
launches_by_shape: Dict[Tuple[int, int, int], int] = {}
_count_lock = threading.Lock()

#: Largest knot count a row may have (the knot times of one row always
#: fit a block's shared memory).
MAX_KNOTS = 12 * 1024
SMEM_MAX = 232_448          # bytes of shared memory a block can use (H100)
_THREADS = 256              # most threads a block takes
_ROWS_SMEM = 48 * 1024      # shared bytes of rows a block may take
_STAGE_BYTES = 48           # output restaging a thread (4 queries x 3)


class InterpPlan(NamedTuple):
    """How one launch splits its work (``csrc/track_interp.cu``):
    ``route`` "shared" or "gather", ``rows`` per block, ``per_row``
    threads on each row (4 queries a thread, looping past 4 * per_row),
    ``blocks`` (the grid the kernel is launched on), ``smem`` bytes of
    dynamic shared memory a block, and ``vec``: 16-byte query loads
    (and, at C = 3, 16-byte output stores), else scalar ones."""

    route: str
    rows: int
    per_row: int
    blocks: int
    smem: int
    vec: bool


def plan(B: int, N: int, C: int, M: int,
         aligned: bool = True) -> InterpPlan:
    """The fixed rule: the "shared" route where a row's (1 + C) * N
    floats and the output's restaging fit a block's shared memory, else
    "gather"; a row gets a warp-multiple of threads for its M / 4 query
    groups (at most 256) and a block as many whole rows as fit 256
    threads and 48 KB of rows (one at least, whatever its bytes)
    (``_build.row_split``); the 16-byte path where M % 4 == 0 and the
    query and output bases are ``aligned`` to 16 bytes, and with it, at
    C = 3, 48 bytes a thread to restage the output."""
    shared = (1 + C) * N * 4 + _STAGE_BYTES * _THREADS <= SMEM_MAX
    row_bytes = (1 + C) * N * 4 if shared else N * 4
    rows, per_row = _build.row_split(M, max_rows=_ROWS_SMEM // row_bytes)
    vec = M % 4 == 0 and aligned
    smem = -(-rows * row_bytes // 16) * 16
    if vec and C == 3:
        smem += _STAGE_BYTES * rows * per_row
    return InterpPlan("shared" if shared else "gather", rows, per_row,
                      -(-B // rows), smem, vec)


#: The split of the most recent kernel launch (None before the first).
last_plan: Optional[InterpPlan] = None


def track_interp(t_in: torch.Tensor, v_in: torch.Tensor, count: torch.Tensor,
                 t_out: torch.Tensor) -> torch.Tensor:
    """t_in (B,N) f32, v_in (B,C,N) f32, count (B,) i32 (each in [2, N]),
    t_out (B,M) f32 -> (B,M,C) f32.  See ref.track_interp_ref."""
    global launches, last_plan
    if t_in.device.type == "cpu":
        return track_interp_ref(t_in, v_in, count, t_out)
    B, N = t_in.shape
    C, M = v_in.shape[1], t_out.shape[1]
    _build.check_inputs(
        "track_interp",
        {"t_in": (t_in, torch.float32), "v_in": (v_in, torch.float32),
         "count": (count, torch.int32), "t_out": (t_out, torch.float32)},
        {"t_in": (B, N), "v_in": (B, C, N), "count": (B,), "t_out": (B, M)})
    if not 2 <= N <= MAX_KNOTS:
        raise ValueError(f"track_interp: N={N} outside [2, {MAX_KNOTS}]")
    out = torch.empty((B, M, C), dtype=torch.float32, device=t_in.device)
    split = plan(B, N, C, M, aligned=(t_out.data_ptr() | out.data_ptr())
                 % 16 == 0)
    with torch.cuda.device(t_in.device):
        rc = _build.lib().track_interp_f32(
            t_in.data_ptr(), v_in.data_ptr(), count.data_ptr(),
            t_out.data_ptr(), out.data_ptr(), B, N, C, M, split.rows,
            split.per_row, split.blocks, split.smem,
            int(split.route == "gather"), int(split.vec),
            _build.stream_of(t_in))
    _build.check(rc, "track_interp")
    with _count_lock:
        launches += 1
        launches_by_route[split.route] += 1
        launches_by_shape[(B, N, M)] = launches_by_shape.get((B, N, M), 0) + 1
        last_plan = split
    return out
