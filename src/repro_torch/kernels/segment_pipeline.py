"""Device-resident segment pipeline: interp -> AGL -> rates -> masks.

Port of ``repro/kernels/segment_pipeline.py``.  One call per (B, K)
bucket of segments: the inputs go up to the device once, the three
CUDA kernels and the tensor code between them (DEM fractional indices,
padding masks) run there, and the nine output planes come back as one
stacked (9, B, K) tensor, so the caller fetches them with one ``.cpu()``.
PyTorch runs eagerly, so each kernel's output is materialised at its
stage boundary and no optimization barrier is needed to pin rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.agl_lookup import agl_lookup
from repro_torch.kernels.dynamic_rates import dynamic_rates
from repro_torch.kernels.track_interp import track_interp

#: Output planes of the pipeline, in order (the first axis of its result).
FIELDS = ("times", "lat", "lon", "alt_msl", "alt_agl",
          "vrate", "gspeed", "heading", "turn")

_LANE = 128     # track axes pad to this multiple, as in the reference


def _next_mult(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pad_tracks(t_in, v_in, t_out):
    """Pad the track axes to a multiple of 128, as the reference does.

    Knot padding is FINITE and increasing (last time + 1, 2, ...) and
    holds the last knot's values; query padding holds the last query
    (constant extrapolation, masked out afterwards).
    """
    N = t_in.shape[1]
    K = t_out.shape[1]
    Np, Kp = _next_mult(N, _LANE), _next_mult(K, _LANE)
    if Np != N:
        step = torch.arange(1, Np - N + 1, dtype=torch.float32,
                            device=t_in.device)
        t_in = torch.cat([t_in, t_in[:, -1:] + step[None, :]], dim=1)
        v_in = torch.cat(
            [v_in, v_in[:, :, -1:].expand(*v_in.shape[:2], Np - N)], dim=2)
    if Kp != K:
        t_out = torch.cat(
            [t_out, t_out[:, -1:].expand(t_out.shape[0], Kp - K)], dim=1)
    return t_in.contiguous(), v_in.contiguous(), t_out.contiguous(), K


def _pipeline(dem, t_in, v_in, count_in, t_out, count_out, *,
              grid: tuple, dt: float, use_kernels: bool) -> torch.Tensor:
    """interp -> fi/fj -> AGL -> rates -> masks, on the inputs' device."""
    lat_min, lat_max, lon_min, lon_max, cells_per_deg = grid
    B, K = t_out.shape
    H, W = dem.shape
    interp_fn = track_interp if use_kernels else ref.track_interp_ref
    agl_fn = agl_lookup if use_kernels else ref.agl_lookup_ref
    rates_fn = dynamic_rates if use_kernels else ref.dynamic_rates_ref

    # 1. Resample onto the uniform grid.
    interp = interp_fn(t_in, v_in, count_in, t_out)           # (B, K, 3)
    v_grid = interp.permute(0, 2, 1).contiguous()             # (B, 3, K)
    lat, lon, alt = v_grid[:, 0], v_grid[:, 1], v_grid[:, 2]

    # 2. DEM fractional indices from the affine grid (plain tensor code,
    #    as the reference computes them outside any Pallas kernel).
    fi = (torch.clamp(lat, lat_min, lat_max) - lat_min) * cells_per_deg
    fj = (torch.clamp(lon, lon_min, lon_max) - lon_min) * cells_per_deg
    fi = torch.clamp(fi, 0.0, H - 1.001)
    fj = torch.clamp(fj, 0.0, W - 1.001)

    # 3. AGL = MSL - bilinear DEM elevation.  One gather kernel serves
    #    every row, so the reference's tile/oracle split has no branch.
    agl = agl_fn(dem, fi, fj, alt.contiguous())

    # 4. Dynamic rates over the resampled grid.
    rates = rates_fn(v_grid, count_out, dt)

    # 5. Padding masks, still on device; one stacked result.
    mask = (torch.arange(K, device=t_out.device)[None, :]
            < count_out[:, None]).to(torch.float32)
    planes = torch.stack([t_out, lat, lon, alt, agl, rates[:, 0],
                          rates[:, 1], rates[:, 2], rates[:, 3]])
    return planes * mask


def process_segments(dem, t_in, v_in, count_in, t_out, count_out, *,
                     grid, dt: float = 1.0, use_kernels: bool = True,
                     agl_oracle: bool = False, interpret: bool = True,
                     donate: bool = False, use_pallas=None) -> torch.Tensor:
    """Run the pipeline on one (B, K) bucket of segments.

    Args:
      dem: (H, W) f32 elevation tensor; its device is where the pipeline
        runs.
      t_in, v_in, count_in: (B, N), (B, 3, N) lat/lon/alt knots, (B,) —
        numpy arrays or tensors; moved to ``dem``'s device.
      t_out, count_out: (B, K) query grid + (B,) valid lengths.
      grid: (lat_min, lat_max, lon_min, lon_max, cells_per_deg) — the
        DEM affine transform.
      dt: uniform grid spacing.
      use_kernels: False composes the plain versions directly (the
        reference for tests); True calls the kernel wrappers, which run
        the CUDA kernels on a CUDA ``dem`` and the plain versions on CPU.
      agl_oracle, interpret, donate: the reference's keywords, with its
        defaults; each must be a bool and changes no output.  The one
        gather kernel serves both AGL variants (``agl_oracle``), and
        PyTorch has no interpret mode and no buffer donation.
      use_pallas: refused with ``TypeError``: the port has no Pallas, as
        ``backend="pallas"`` is refused.  Pass ``use_kernels``.

    Returns:
      (9, B, K) f32 tensor on ``dem``'s device, planes in :data:`FIELDS`
      order, all masked to ``count_out``.
    """
    if use_pallas is not None:
        raise TypeError("process_segments() takes use_kernels, not "
                        "use_pallas: the port runs CUDA kernels, not "
                        "Pallas (use_kernels=False composes the plain "
                        "versions)")
    for name, flag in (("agl_oracle", agl_oracle), ("interpret", interpret),
                       ("donate", donate)):
        if not isinstance(flag, (bool, np.bool_)):
            raise ValueError(f"{name} must be a bool, got {flag!r}")
    device = dem.device

    def up(x, dtype):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x)
                               else x, dtype=dtype, device=device)

    t_in, v_in, t_out = (up(x, torch.float32) for x in (t_in, v_in, t_out))
    count_in = up(count_in, torch.int32)
    count_out = up(count_out, torch.int32)
    t_in, v_in, t_out, K = _pad_tracks(t_in, v_in, t_out)
    planes = _pipeline(dem, t_in, v_in, count_in, t_out, count_out,
                       grid=tuple(float(g) for g in grid), dt=float(dt),
                       use_kernels=use_kernels)
    return planes[:, :, :K].contiguous() if planes.shape[2] != K else planes
