"""agl_lookup: AGL = MSL - bilinear DEM elevation (CUDA).

Port of the TPU kernel ``repro/kernels/agl_lookup.py``; the kernel is
``csrc/agl_lookup.cu``, a direct four-point gather from the whole DEM,
so it serves tracks of any extent (the TPU kernel's one-tile limit and
its oracle fallback have no counterpart).  :func:`agl_lookup` launches
it on CUDA tensors and runs the plain version on CPU tensors.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import agl_lookup_ref

__all__ = ["agl_lookup", "agl_lookup_ref", "launches"]

#: Kernel launches since the last reset (set to 0 to reset).
launches = 0
_count_lock = threading.Lock()


def agl_lookup(dem: torch.Tensor, fi: torch.Tensor, fj: torch.Tensor,
               alt_msl: torch.Tensor) -> torch.Tensor:
    """dem (H,W) f32, fi/fj/alt_msl (B,M) f32 -> (B,M) f32 AGL (m).
    See ref.agl_lookup_ref."""
    global launches
    if dem.device.type == "cpu":
        return agl_lookup_ref(dem, fi, fj, alt_msl)
    H, W = dem.shape
    shape = tuple(fi.shape)
    _build.check_inputs(
        "agl_lookup",
        {"dem": (dem, torch.float32), "fi": (fi, torch.float32),
         "fj": (fj, torch.float32), "alt_msl": (alt_msl, torch.float32)},
        {"dem": (H, W), "fi": shape, "fj": shape, "alt_msl": shape})
    if H < 1 or W < 1:
        raise ValueError(f"agl_lookup: empty DEM {tuple(dem.shape)}")
    out = torch.empty(shape, dtype=torch.float32, device=dem.device)
    # The clip bounds rounded to f32, as the plain version rounds them.
    fi_max = float(np.float32(H - 1.000001))
    fj_max = float(np.float32(W - 1.000001))
    with torch.cuda.device(dem.device):
        rc = _build.lib().agl_lookup_f32(
            dem.data_ptr(), fi.data_ptr(), fj.data_ptr(), alt_msl.data_ptr(),
            out.data_ptr(), fi.numel(), H, W, fi_max, fj_max,
            _build.stream_of(dem))
    _build.check(rc, "agl_lookup")
    with _count_lock:
        launches += 1
    return out
