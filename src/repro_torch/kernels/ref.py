"""Plain PyTorch versions of the kernels (the correctness reference).

Straightforward, unfused tensor code with the signatures and layouts of
the JAX package's oracles.  On a CPU tensor each kernel wrapper runs its
plain version from here; on the card ``chip_smoke.py`` holds every CUDA
kernel against it.
"""

from __future__ import annotations

import math

import torch

M_PER_DEG = 111_111.0
DEG2RAD = math.pi / 180.0


def track_interp_ref(t_in: torch.Tensor, v_in: torch.Tensor,
                     count: torch.Tensor, t_out: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear resample of tracks onto a new time grid.

    Args:
      t_in:  (B, N) sorted observation times (padding after ``count``).
      v_in:  (B, C, N) channel values at t_in.
      count: (B,) int32 — number of valid observations per track (>= 2).
      t_out: (B, M) query times.
    Returns:
      (B, M, C) linearly interpolated values; t_out clamped to the valid
      time range of each track (constant extrapolation at the ends).
    """
    B, C, _ = v_in.shape
    M = t_out.shape[1]
    last = (count.long() - 1)[:, None]                       # (B, 1)
    t0 = t_in[:, :1]
    tl = t_in.gather(1, last)
    q = torch.minimum(torch.maximum(t_out, t0), tl)
    # Right bracketing index in [1, last].
    idx = torch.searchsorted(t_in.contiguous(), q.contiguous(), right=True)
    idx = torch.minimum(torch.clamp(idx, min=1), last)
    tj = t_in.gather(1, idx - 1)
    tj1 = t_in.gather(1, idx)
    gap = tj1 > tj
    w = torch.where(gap, (q - tj) / torch.where(gap, tj1 - tj, 1.0), 0.0)
    vl = v_in.gather(2, (idx - 1)[:, None, :].expand(B, C, M))
    vr = v_in.gather(2, idx[:, None, :].expand(B, C, M))
    return ((1.0 - w)[:, None, :] * vl + w[:, None, :] * vr).transpose(1, 2)


def dynamic_rates_ref(v: torch.Tensor, count: torch.Tensor,
                      dt: float) -> torch.Tensor:
    """Dynamic rates from a uniformly resampled track (paper §III.A).

    Args:
      v: (B, 3, M) — lat (deg), lon (deg), altitude (m) on a uniform grid.
      count: (B,) int32 valid lengths.
      dt: grid spacing in seconds.
    Returns:
      (B, 4, M): vertical rate (m/s), ground speed (m/s), heading (rad,
      from north, clockwise), turn rate (rad/s). Positions >= count are 0.
    """
    B, _, M = v.shape
    lat, lon, alt = v[:, 0], v[:, 1], v[:, 2]
    idx = torch.arange(M, device=v.device)[None, :]
    last = (count.long() - 1)[:, None]
    li = torch.clamp(idx - 1, min=0).expand(B, M)
    ri = torch.minimum(idx + 1, torch.clamp(last, min=0))
    denom = torch.clamp(ri - li, min=1).to(torch.float32) * dt

    def central(x):
        # difference between clamped neighbors: central inside the valid
        # range, one-sided at both track ends.
        return (x.gather(1, ri) - x.gather(1, li)) / denom

    vrate = central(alt)
    dn = central(lat) * M_PER_DEG                       # north velocity m/s
    de = central(lon) * M_PER_DEG * torch.cos(lat * DEG2RAD)
    gspeed = torch.sqrt(dn * dn + de * de)
    heading = torch.atan2(de, dn)
    dh = central(heading) * dt                          # un-normalized diff
    # torch.remainder is a floor-mod, like jnp's %: wrap to [-pi, pi).
    dh = torch.remainder(dh + math.pi, 2.0 * math.pi) - math.pi
    turn = dh / dt
    out = torch.stack([vrate, gspeed, heading, turn], dim=1)
    valid = idx[:, None, :] < count[:, None, None]
    return torch.where(valid, out, 0.0)


def agl_lookup_ref(dem: torch.Tensor, fi: torch.Tensor, fj: torch.Tensor,
                   alt_msl: torch.Tensor) -> torch.Tensor:
    """AGL altitude: MSL altitude minus bilinear DEM elevation.

    Args:
      dem: (H, W) elevation grid (m).
      fi, fj: (B, M) fractional row/col indices into dem.
      alt_msl: (B, M) MSL altitudes (m).
    Returns:
      (B, M) AGL altitudes (m).  The far neighbour's index is clamped
      into the grid, as the JAX oracle's gather clamps it.
    """
    H, W = dem.shape
    fi = torch.clamp(fi, 0.0, H - 1.000001)
    fj = torch.clamp(fj, 0.0, W - 1.000001)
    i0 = torch.floor(fi).long()
    j0 = torch.floor(fj).long()
    i1 = torch.clamp(i0 + 1, max=H - 1)
    j1 = torch.clamp(j0 + 1, max=W - 1)
    di = fi - i0
    dj = fj - j0
    z00 = dem[i0, j0]
    z01 = dem[i0, j1]
    z10 = dem[i1, j0]
    z11 = dem[i1, j1]
    elev = ((1 - di) * (1 - dj) * z00 + (1 - di) * dj * z01
            + di * (1 - dj) * z10 + di * dj * z11)
    return alt_msl - elev


SCREEN_BIG = 1e30


def f32(x: float) -> float:
    """``x`` rounded to float32, as the JAX package rounds thresholds."""
    return float(torch.tensor(x, dtype=torch.float32))


def encounter_screen_ref(lat: torch.Tensor, lon: torch.Tensor,
                         alt: torch.Tensor, valid: torch.Tensor, *,
                         h_thresh_m: float, v_thresh_m: float):
    """Pairwise miss-distance screen over time-aligned rows (one cell).

    The full-broadcast oracle: every (i, j, t) at once.

    Args:
      lat, lon, alt: (K, T) f32, samples on a common 1-sample grid.
      valid: (K, T) f32 0/1 sample presence mask.
      h_thresh_m / v_thresh_m: candidate thresholds (m), rounded to f32.
    Returns:
      ``(hit, min_dh, min_dv, t_idx)``, each (K, K) f32, populated on the
      strict upper triangle (i < j) only.  ``hit[i, j]`` is 1.0 when rows
      i and j are within *both* thresholds at some jointly valid instant;
      ``min_dh``/``min_dv`` are the minima of the horizontal/vertical
      separation over those instants (1e30 where no hit); ``t_idx`` is
      the first time index attaining ``min_dh`` (0 where no hit).
      Local-tangent metric: 1 deg = 111_111 m, east metres scaled by the
      cosine of the pair's mean latitude, in the JAX package's order of
      f32 operations.
    """
    K, _ = lat.shape
    li, lj = lat[:, None, :], lat[None, :, :]
    dn = (li - lj) * M_PER_DEG
    de = ((lon[:, None, :] - lon[None, :, :]) * M_PER_DEG
          * torch.cos(torch.deg2rad(0.5 * (li + lj))))
    dh = torch.sqrt(dn * dn + de * de)
    dv = torch.abs(alt[:, None, :] - alt[None, :, :])
    both = (valid[:, None, :] * valid[None, :, :]) > 0.5
    k = torch.arange(K, device=lat.device)
    tri = (k[:, None] < k[None, :])[:, :, None]
    hit_t = both & tri & (dh <= f32(h_thresh_m)) & (dv <= f32(v_thresh_m))
    dh_m = torch.where(hit_t, dh, SCREEN_BIG)
    dv_m = torch.where(hit_t, dv, SCREEN_BIG)
    return (hit_t.any(dim=-1).to(torch.float32),
            dh_m.amin(dim=-1),
            dv_m.amin(dim=-1),
            torch.argmin(dh_m, dim=-1).to(torch.float32))


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True) -> torch.Tensor:
    """Plain-softmax GQA attention, the flash kernel's plain version.

    q (B, H, T, hd); k, v (B, KV, S, hd) -> (B, H, T, hd) f32, computed
    in f32 whatever the input dtype.  Causal alignment: query t attends
    keys <= t + (S - T).  A query row with no key to attend (t < T - S)
    comes out 0, as in the CUDA kernel; the JAX oracle gives such a row
    the mean of v instead, and the JAX kernel 0 or a block's share of v
    depending on its block size.
    """
    B, H, T, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    g = H // KV
    kk = k.repeat_interleave(g, dim=1).float()
    vv = v.repeat_interleave(g, dim=1).float()
    s = torch.einsum("bhtd,bhsd->bhts", q.float(), kk) * hd ** -0.5
    mask = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        mask = torch.tril(mask, diagonal=S - T)
    # Masked scores underflow to exactly 0 in a row that has a valid key;
    # in a row that has none the softmax is uniform, and the mask zeroes it.
    p = torch.softmax(torch.where(mask, s, -1e30), dim=-1) * mask
    return torch.einsum("bhts,bhsd->bhtd", p, vv)
