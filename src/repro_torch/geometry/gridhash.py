"""Spatial-hash grid binning for encounter screening (lat/lon/alt/time).

The all-pairs proximity screen over N tracks is O(N^2) and intractable
at fleet scale; binning track rows into a 4-D grid (latitude band x
longitude band x altitude layer x time window) prunes it to within-cell
pairs.  Correctness hinges on one invariant:

  **halo padding** — a row's membership is its *home* cells plus every
  cell within the screening thresholds of any of its samples.  Two
  rows that ever come within ``h_thresh_m`` horizontally *and*
  ``v_thresh_m`` vertically at a common instant are then guaranteed to
  share at least one cell (the home cell of either sample is inside the
  other's padded membership), so within-cell screening misses nothing.

Longitude indices live on a ring of ``n_lon = round(360 / cell_deg)``
cells: the antimeridian is just another cell boundary and padded ranges
wrap modulo ``n_lon``.  Latitude/altitude indices are plain floors, so
equator/hemisphere boundaries need no special casing — padding spills
into the adjacent (possibly negative) index.

Cell *cost* is quadratic in occupancy — a cell with k rows screens
k*(k-1)/2 pairs — which is exactly the skew ``PhaseCostModel.
task_seconds`` exposes to the scheduling policies via ``cpu_cost_hint``
(see :func:`cell_cost`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

__all__ = [
    "GridSpec", "CellKey", "cell_id", "wrap_lon",
    "cells_for_samples", "bin_samples", "occupancy_stats", "cell_cost",
    "SCREEN_COST_PER_PAIR_S",
]

#: Modeled CPU seconds per screened pair (one pairwise miss-distance
#: trace over a bucketed time window).  Calibrated so a 256-row cell
#: (~32k pairs) costs ~8 s — the same order as the heaviest tasks in
#: the archive-phase manifests, keeping sim makespans comparable.
SCREEN_COST_PER_PAIR_S = 2.5e-4

#: (time index, altitude index, latitude index, longitude index)
CellKey = Tuple[int, int, int, int]

_M_PER_DEG = 111_111.0          # matches kernels/ref.py distance model
_MIN_COS_LAT = 0.2              # clamp: lon padding stays finite at poles


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Cell dimensions of the 4-D screening grid.

    ``cell_deg`` must divide 360 to an integer number of longitude
    cells so the ring wraps cleanly at the antimeridian.
    """

    cell_deg: float = 0.25      # lat/lon cell edge (degrees)
    cell_alt_m: float = 300.0   # altitude layer thickness (meters)
    cell_t_s: float = 3600.0    # time window (seconds)

    def __post_init__(self) -> None:
        if self.cell_deg <= 0 or self.cell_alt_m <= 0 or self.cell_t_s <= 0:
            raise ValueError("GridSpec dimensions must be positive")
        n_lon = 360.0 / self.cell_deg
        if abs(n_lon - round(n_lon)) > 1e-9:
            raise ValueError(
                f"cell_deg={self.cell_deg} does not divide 360 evenly; "
                f"the longitude ring would not close at the antimeridian")

    @property
    def n_lon(self) -> int:
        return int(round(360.0 / self.cell_deg))


def wrap_lon(lon):
    """Wrap longitudes into [-180, 180)."""
    return (np.asarray(lon, dtype=np.float64) + 180.0) % 360.0 - 180.0


def cell_id(key: CellKey) -> str:
    """Stable, sortable-enough string id for a cell key."""
    ti, ai, yi, xi = key
    return f"t{ti}_a{ai}_y{yi}_x{xi}"


def _parse_cell_id(cid: str) -> CellKey:
    ti, ai, yi, xi = (int(p[1:]) for p in cid.split("_"))
    return (ti, ai, yi, xi)


def cells_for_samples(times, lat, lon, alt, *, spec: GridSpec,
                      h_pad_m: float = 0.0,
                      v_pad_m: float = 0.0) -> List[CellKey]:
    """All cells a sampled trajectory touches, halo-padded.

    Args:
      times, lat, lon, alt: 1-D sample arrays (seconds, deg, deg, m).
      spec: grid dimensions.
      h_pad_m / v_pad_m: halo radii — normally the screening
        thresholds, so any trajectory within threshold of a sample
        shares a cell with it.  Longitude padding scales by
        1/cos(lat) (clamped near the poles) so the halo is a true
        metric radius at every latitude.

    Returns a sorted list of unique :data:`CellKey` tuples.  Time is
    never padded: two rows can only conflict at a *common* instant, and
    that instant lands in the same time window for both.
    """
    t = np.asarray(times, dtype=np.float64)
    la = np.asarray(lat, dtype=np.float64)
    lo = wrap_lon(lon)
    al = np.asarray(alt, dtype=np.float64)
    if t.size == 0:
        return []

    ti = np.floor(t / spec.cell_t_s).astype(np.int64)

    pad_lat = h_pad_m / _M_PER_DEG
    cos_lat = np.maximum(np.cos(np.deg2rad(la)), _MIN_COS_LAT)
    pad_lon = h_pad_m / (_M_PER_DEG * cos_lat)

    def _rng(vals, pad, width):
        lo_i = np.floor((vals - pad) / width).astype(np.int64)
        hi_i = np.floor((vals + pad) / width).astype(np.int64)
        return lo_i, hi_i

    la_lo, la_hi = _rng(la, pad_lat, spec.cell_deg)
    lo_lo, lo_hi = _rng(lo, pad_lon, spec.cell_deg)
    al_lo, al_hi = _rng(al, v_pad_m, spec.cell_alt_m)

    n_lon = spec.n_lon
    keys = set()
    ti_l = ti.tolist()
    # Halo spans are tiny (<= 2 cells/dim when pad <= cell size), so
    # iterating offset combinations costs O(samples * ~8).  The set
    # dedups tuples directly: rows are short, so python-level inserts
    # beat an np.unique(axis=0) round trip per combination by ~10x.
    for da in range(int((la_hi - la_lo).max()) + 1):
        ai_l = np.minimum(la_lo + da, la_hi).tolist()
        for do in range(int((lo_hi - lo_lo).max()) + 1):
            oi_l = (np.minimum(lo_lo + do, lo_hi) % n_lon).tolist()
            for dz in range(int((al_hi - al_lo).max()) + 1):
                zi_l = np.minimum(al_lo + dz, al_hi).tolist()
                keys.update(zip(ti_l, zi_l, ai_l, oi_l))
    return sorted(keys)


def bin_samples(rows: Sequence[Tuple[str, np.ndarray, np.ndarray,
                                     np.ndarray, np.ndarray]],
                *, spec: GridSpec, h_pad_m: float = 0.0,
                v_pad_m: float = 0.0) -> Dict[CellKey, List[str]]:
    """Bin ``(row_id, times, lat, lon, alt)`` rows -> cell -> row ids.

    Row ids keep their first-seen order within each cell; callers that
    need canonical cell contents sort the lists themselves.
    """
    bins: Dict[CellKey, List[str]] = {}
    for row_id, times, lat, lon, alt in rows:
        for key in cells_for_samples(times, lat, lon, alt, spec=spec,
                                     h_pad_m=h_pad_m, v_pad_m=v_pad_m):
            bins.setdefault(key, []).append(row_id)
    return bins


def occupancy_stats(bins: Dict[CellKey, Iterable[str]]) -> dict:
    """Occupancy summary of a binning: totals, max, pair counts."""
    occ = [len(list(v)) for v in bins.values()]
    pairs = sum(k * (k - 1) // 2 for k in occ)
    return {
        "cells": len(occ),
        "max_occupancy": max(occ) if occ else 0,
        "mean_occupancy": (sum(occ) / len(occ)) if occ else 0.0,
        "multi_cells": sum(1 for k in occ if k >= 2),
        "pairs": pairs,
    }


def cell_cost(n_all: int, n_new: int | None = None, *,
              per_pair_s: float = SCREEN_COST_PER_PAIR_S) -> float:
    """Modeled CPU seconds to screen one cell — quadratic in occupancy.

    A full-cell screen walks all n*(n-1)/2 pairs; an incremental screen
    (streaming DAG generations) walks only pairs touching the ``n_new``
    newly admitted rows: n_new * (n_all - n_new) + n_new*(n_new-1)/2.
    """
    n_all = int(n_all)
    if n_new is None:
        pairs = n_all * (n_all - 1) // 2
    else:
        n_new = int(n_new)
        n_old = n_all - n_new
        pairs = n_new * n_old + n_new * (n_new - 1) // 2
    return float(pairs) * per_pair_s
