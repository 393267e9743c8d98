"""Fused pairwise encounter screen: per-cell miss distances on the card.

Port of ``repro/kernels/encounter_screen.py``; the kernel is
``csrc/encounter_screen.cu``.  The screening workload takes the
spatial-hash cells of :mod:`repro_torch.geometry.gridhash` and, within
each cell, computes the pairwise horizontal/vertical separation of every
row pair over their time-aligned sample grids, emitting *candidate
encounters*: pairs that are inside both thresholds at some jointly valid
instant.

:func:`screen_aligned` dispatches a padded (C, K, T) batch:

  * ``backend="kernel"`` (the default): :func:`encounter_screen`, which
    launches the CUDA kernel on CUDA tensors and runs the plain version
    (:func:`_screen_batch_plain`, the chunked trace) on CPU tensors.
    :func:`plan` decides how a launch splits its pairs and its time axis
    from the shape and the card's SM count; each chunk of cells comes
    back in one device-to-host copy;
  * ``backend="ref"``: the plain version on the given device, only ever
    the caller's explicit choice.

:func:`repro_torch.kernels.ref.encounter_screen_ref` is the
full-broadcast oracle the tests hold both against.

Cells are batched with the segment pipeline's bucket machinery, exactly
as the reference batches them: rows round to multiples of 8
(:func:`repro_torch.tracks.segments._round_rows`), time to 128-sample
widths, the cell axis to ``_round_rows`` in chunks capped by
``_C_CHUNK_BYTES``, so :func:`get_screen_stats` counts what the
reference counts.  Empty and singleton cells never reach the kernel.

Candidate records are plain dicts, canonically ordered so every path
(grid vs. brute force) yields byte-identical serializations:
``{"a", "b", "t_s", "h_m", "v_m"}`` with ``a < b`` (row ids),
deduplicated across the several cells a pair may share.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import (Dict, Iterable, List, NamedTuple, Optional, Sequence,
                    Set, Tuple)

import numpy as np
import torch

from repro_torch.geometry.gridhash import CellKey, GridSpec, bin_samples
from repro_torch.kernels import _build, ops
from repro_torch.kernels.ref import M_PER_DEG, SCREEN_BIG, f32
from repro_torch.tracks.segments import BUCKET_SIZES, _round_rows, bucket_width

__all__ = [
    "ScreenConfig", "ScreenRow", "rows_from_track", "bin_screen_rows",
    "encounter_screen", "screen_aligned", "screen_cells",
    "screen_rows_grid", "brute_force_screen", "dedup_candidates",
    "get_screen_stats", "reset_screen_stats", "launches",
    "launches_by_shape", "last_plan", "plan", "ScreenPlan",
]

_BIG = np.float32(SCREEN_BIG)
_T_CHUNK = 128                  # time padding and plain-version chunk
_ROW_BLOCK = 8                  # rows pad to a multiple of 8
_C_CHUNK_BYTES = 64 << 20       # cap plain-version (C, K, K, Tc) temporaries
SCREEN_BACKENDS = ("kernel", "ref")

#: Kernel launches since the last reset (set to 0 to reset).
launches = 0
#: Kernel launches by padded (K, T) shape (clear to reset).
launches_by_shape: Dict[Tuple[int, int], int] = {}
_count_lock = threading.Lock()


# ---------------------------------------------------------------------------
# plain version: the reference's chunked trace in PyTorch
# ---------------------------------------------------------------------------

def _chunk_minima(lat_i, lon_i, alt_i, val_i, lat_j, lon_j, alt_j, val_j,
                  tri, h_m: float, v_m: float):
    """Pair minima over one time chunk.

    ``*_i`` are (..., R, 1, Tc), ``*_j`` (..., 1, K, Tc), ``tri``
    (..., R, K, 1) bool.  Returns (hit, min_dh, argmin_dh, min_dv), each
    (..., R, K); minima are 1e30 where the chunk has no hit.
    """
    dn = (lat_i - lat_j) * M_PER_DEG
    de = ((lon_i - lon_j) * M_PER_DEG
          * torch.cos(torch.deg2rad(0.5 * (lat_i + lat_j))))
    dh = torch.sqrt(dn * dn + de * de)
    dv = torch.abs(alt_i - alt_j)
    hit_t = ((val_i * val_j) > 0.5) & tri & (dh <= f32(h_m)) \
        & (dv <= f32(v_m))
    dh_m = torch.where(hit_t, dh, SCREEN_BIG)
    dv_m = torch.where(hit_t, dv, SCREEN_BIG)
    return (hit_t.any(dim=-1).to(torch.float32), dh_m.amin(dim=-1),
            torch.argmin(dh_m, dim=-1), dv_m.amin(dim=-1))


def _screen_batch_plain(lat, lon, alt, val, *, h_m: float, v_m: float):
    """(C, K, T) f32 planes -> (hit, min_dh, min_dv, t_idx), each
    (C, K, K) f32, walking T in 128-sample chunks.  A strict ``<`` on the
    running minimum keeps the *first* time index of the global minimum,
    as the oracle's single argmin over the whole time axis does."""
    C, K, T = lat.shape
    tc = min(_T_CHUNK, T)
    k = torch.arange(K, device=lat.device)
    tri = (k[:, None] < k[None, :])[None, :, :, None]
    hit = torch.zeros((C, K, K), dtype=torch.float32, device=lat.device)
    mdh = torch.full((C, K, K), SCREEN_BIG, dtype=torch.float32,
                     device=lat.device)
    mdv = mdh.clone()
    tix = torch.zeros_like(hit)
    for t0 in range(0, T, tc):
        la, lo, al, va = (x[:, :, t0:t0 + tc] for x in (lat, lon, alt, val))
        c_hit, c_dh, c_arg, c_dv = _chunk_minima(
            la[:, :, None], lo[:, :, None], al[:, :, None], va[:, :, None],
            la[:, None], lo[:, None], al[:, None], va[:, None],
            tri, h_m, v_m)
        better = c_dh < mdh
        hit = torch.maximum(hit, c_hit)
        mdh = torch.where(better, c_dh, mdh)
        mdv = torch.minimum(mdv, c_dv)
        tix = torch.where(better, (c_arg + t0).to(torch.float32), tix)
    return hit, mdh, mdv, tix


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

class ScreenPlan(NamedTuple):
    """How one launch splits its work (``csrc/encounter_screen.cu``).

    ``regime`` is "small" (a cell's pairs packed 32 to a warp) or
    "large" (one block per live 32 x 32 pair tile); ``strips`` is the
    number of time strips each pair's walk is cut into, ``block_strips``
    how many of those lie in different blocks (above 1 the blocks write
    partials to a device workspace that a second kernel merges), and
    ``warps_per_unit`` how many warps of one block share a unit (small
    regime; 1 in the large one)."""

    regime: str
    strips: int
    block_strips: int
    warps_per_unit: int
    blocks: int


_CHUNK = 32                     # samples per strip chunk (the kernel's)
_WARPS = 8                      # warps per block (the kernel's)
_SMALL_MAX_K = 24               # largest K of the small regime
_TILE = 32


def plan(C: int, K: int, T: int, n_sm: int) -> ScreenPlan:
    """The fixed rule by which :func:`encounter_screen` splits a (C, K,
    T) launch over ``n_sm`` SMs: the small regime up to K = 24 rows, the
    large one above (``kernels/screen_ab.py`` times both at K = 16, 24
    and 32 on the card: the small one is faster at 16, the large one at
    32; at 24 each wins at one of two cell counts).  Many cells need no time cut (strips = 1, no workspace)."""
    return (_plan_small if K <= _SMALL_MAX_K else _plan_large)(C, K, T, n_sm)


def _plan_small(C: int, K: int, T: int, n_sm: int) -> ScreenPlan:
    """Pack each cell's K(K-1)/2 pairs 32 to a warp and cut time until
    there are about 16 warps per SM, each walking at least one 32-sample
    chunk: up to 8 strips in one block, the rest across blocks."""
    units = C * -(-(K * (K - 1) // 2) // 32)
    want = min(max(1, -(-16 * n_sm // units)), max(1, T // _CHUNK))
    wpu = 1 << min(3, want.bit_length() - 1)
    bs = want // wpu
    blocks = -(-units // (_WARPS // wpu)) * bs
    return ScreenPlan("small", wpu * bs, bs, wpu, blocks)


def _plan_large(C: int, K: int, T: int, n_sm: int) -> ScreenPlan:
    """Live 32 x 32 tiles only, time cut until there are about 8 blocks
    per SM, each walking at least one 32-sample chunk."""
    nt = -(-K // _TILE)
    tiles = C * nt * (nt + 1) // 2
    strips = min(max(1, -(-8 * n_sm // tiles)), max(1, T // _CHUNK))
    return ScreenPlan("large", strips, strips, 1, tiles * strips)


#: The split of the most recent kernel launch (None before the first).
last_plan: Optional[ScreenPlan] = None

_N_SM: Dict[int, int] = {}


def _n_sm(device: torch.device) -> int:
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _N_SM:
        _N_SM[idx] = torch.cuda.get_device_properties(idx) \
            .multi_processor_count
    return _N_SM[idx]


def _launch(lat, lon, alt, val, *, h_m: float, v_m: float,
            split: Optional[ScreenPlan] = None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors -> one (4, C, K, K) buffer,
    split as :func:`plan` says unless ``split`` is given (the timing
    script ``kernels/screen_ab.py`` forces a regime so).  The split it
    launched with is left in :data:`last_plan`."""
    global launches, last_plan
    C, K, T = lat.shape
    _build.check_inputs(
        "encounter_screen",
        {"lat": (lat, torch.float32), "lon": (lon, torch.float32),
         "alt": (alt, torch.float32), "val": (val, torch.float32)},
        {"lat": (C, K, T), "lon": (C, K, T), "alt": (C, K, T),
         "val": (C, K, T)})
    if K % _ROW_BLOCK or T % _T_CHUNK:
        raise ValueError(f"encounter_screen: K={K} must be a multiple of "
                         f"{_ROW_BLOCK} and T={T} of {_T_CHUNK}")
    p = split or plan(C, K, T, _n_sm(lat.device))
    dev = lat.device
    out = torch.empty((4, C, K, K), dtype=torch.float32, device=dev)
    spans = torch.empty((2, C * K), dtype=torch.int32, device=dev)
    part = (torch.empty((p.block_strips, 4, C, K, K), dtype=torch.float32,
                        device=dev) if p.block_strips > 1 else None)
    with torch.cuda.device(dev):
        rc = _build.lib().encounter_screen_f32(
            lat.data_ptr(), lon.data_ptr(), alt.data_ptr(), val.data_ptr(),
            out.data_ptr(), spans.data_ptr(),
            None if part is None else part.data_ptr(), C, K, T,
            0 if p.regime == "small" else 1, p.block_strips,
            p.warps_per_unit, f32(h_m), f32(v_m), _build.stream_of(lat))
    _build.check(rc, "encounter_screen")
    with _count_lock:
        launches += 1
        launches_by_shape[(K, T)] = launches_by_shape.get((K, T), 0) + 1
        last_plan = p
    return out


def _screen_stacked(lat, lon, alt, val, *, h_m: float, v_m: float,
                    backend: str = "kernel") -> torch.Tensor:
    """(C, K, T) planes -> one (4, C, K, K) tensor: the kernel on CUDA
    tensors, the plain version on CPU tensors or for ``backend="ref"``."""
    if backend == "kernel" and lat.device.type != "cpu":
        return _launch(lat, lon, alt, val, h_m=h_m, v_m=v_m)
    return torch.stack(_screen_batch_plain(lat, lon, alt, val, h_m=h_m,
                                           v_m=v_m))


def encounter_screen(lat: torch.Tensor, lon: torch.Tensor,
                     alt: torch.Tensor, val: torch.Tensor, *,
                     h_m: float, v_m: float):
    """lat/lon/alt/val (C,K,T) f32, K a multiple of 8 and T of 128 ->
    (hit, min_dh, min_dv, t_idx), each (C,K,K) f32 (strict upper
    triangle; no-hit entries hold 0, 1e30, 1e30, 0).  Launches the CUDA
    kernel on CUDA tensors (the four are views of its one output
    buffer); on CPU tensors runs the plain version."""
    return tuple(_screen_stacked(lat, lon, alt, val, h_m=h_m, v_m=v_m))


# ---------------------------------------------------------------------------
# stats
# ---------------------------------------------------------------------------

_STATS_LOCK = threading.Lock()
_STATS: Dict[str, float] = {}


def reset_screen_stats() -> None:
    with _STATS_LOCK:
        _STATS.clear()
        _STATS.update(kernel_calls=0, cells_screened=0, cells_skipped=0,
                      pairs_screened=0, padded_cells=0)


def get_screen_stats() -> dict:
    with _STATS_LOCK:
        return dict(_STATS)


def _count(**kw) -> None:
    with _STATS_LOCK:
        for k, v in kw.items():
            _STATS[k] += v


reset_screen_stats()


# ---------------------------------------------------------------------------
# batched screening over padded (C, K, T) arrays
# ---------------------------------------------------------------------------

def screen_aligned(lat, lon, alt, valid, *, h_thresh_m: float,
                   v_thresh_m: float, backend: str = "kernel",
                   interpret: Optional[bool] = None, device=None) -> dict:
    """Screen a (C, K, T) batch of time-aligned cells on ``device``.

    Pads rows to a multiple of 8, time to 128-sample chunks, and the
    cell axis to ``_round_rows`` in chunks capped by ``_C_CHUNK_BYTES``
    (the reference's padding), then runs ``backend``.  Returns
    ``{"hit", "min_dh", "min_dv", "t_idx"}`` as (C, K, K) float32 numpy
    arrays (strict upper triangle).

    ``interpret`` (``None`` or a bool) is the reference's Pallas
    interpret switch and changes no output: the port has no interpret
    mode, and the CPU runs the plain version because the caller chose
    ``device="cpu"``.
    """
    if interpret is not None and not isinstance(interpret, bool):
        raise ValueError(f"interpret must be None or a bool, got "
                         f"{interpret!r}")
    if backend not in SCREEN_BACKENDS:
        raise ValueError(f"unknown screen backend {backend!r}; choose "
                         f"from {SCREEN_BACKENDS}")
    dev = ops.resolve_device(device)
    lat = np.asarray(lat, np.float32)
    C, K, T = lat.shape
    Kp = max(_ROW_BLOCK, _round_rows(K))
    Tp = -(-T // _T_CHUNK) * _T_CHUNK

    def pad(x):
        out = np.zeros((C, Kp, Tp), np.float32)
        out[:, :K, :T] = np.asarray(x, np.float32)
        return out

    planes = [pad(x) for x in (lat, lon, alt, valid)]
    c_max = max(1, _C_CHUNK_BYTES // (Kp * Kp * min(_T_CHUNK, Tp) * 4))
    out = np.empty((4, C, Kp, Kp), np.float32)
    done = 0
    while done < C:
        n = min(c_max, C - done)
        Cp = min(max(1, _round_rows(n)), c_max)
        args = []
        for x in planes:
            chunk = np.zeros((Cp, Kp, Tp), np.float32)
            chunk[:n] = x[done:done + n]
            args.append(torch.from_numpy(chunk).to(dev))
        res = _screen_stacked(*args, h_m=h_thresh_m, v_m=v_thresh_m,
                              backend=backend)
        out[:, done:done + n] = res[:, :n].cpu().numpy()
        _count(kernel_calls=1, padded_cells=Cp - n)
        done += n
    hit, mdh, mdv, tix = out[:, :, :K, :K]
    return {"hit": hit, "min_dh": mdh, "min_dv": mdv, "t_idx": tix}


# ---------------------------------------------------------------------------
# rows, binning, cell screening
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ScreenConfig:
    """Encounter-screen thresholds and execution knobs.

    ``device=None`` means the card and raises without one; the resolved
    device is kept as a string, so the config pickles into worker
    processes without touching CUDA."""

    h_thresh_m: float = 926.0   # 0.5 NM horizontal
    v_thresh_m: float = 152.4   # 500 ft vertical
    dt_s: float = 1.0           # sample grid spacing (RESAMPLE_DT_S)
    backend: str = "kernel"     # kernel | ref
    device: Optional[str] = None

    def __post_init__(self) -> None:
        if self.h_thresh_m <= 0 or self.v_thresh_m <= 0 or self.dt_s <= 0:
            raise ValueError("ScreenConfig values must be positive")
        if self.backend not in SCREEN_BACKENDS:
            raise ValueError(f"unknown screen backend {self.backend!r}")
        object.__setattr__(self, "device",
                           str(ops.resolve_device(self.device)))


@dataclasses.dataclass
class ScreenRow:
    """One resampled segment, anchored at an absolute start time.

    Samples sit on a uniform ``dt_s`` grid starting at ``t0``; rows from
    the same aircraft share a ``group`` and are never paired.
    """
    row_id: str
    group: str
    t0: float
    lat: np.ndarray
    lon: np.ndarray
    alt: np.ndarray
    dt_s: float = 1.0

    def __len__(self) -> int:
        return len(self.lat)

    @property
    def times(self) -> np.ndarray:
        return self.t0 + np.arange(len(self.lat)) * self.dt_s


def rows_from_track(track_id: str, obs: dict, segs: Sequence[slice],
                    processed) -> List[ScreenRow]:
    """ProcessedSegments planes + raw observation times -> ScreenRows.

    ``processed.times`` grids are segment-relative (they start at 0);
    the absolute anchor is the raw first-observation time of each
    segment, which places rows on the shared screening grid.
    """
    rows = []
    for k, s in enumerate(segs):
        if k >= len(processed):
            break
        m = int(processed.count[k])
        rows.append(ScreenRow(
            row_id=f"{track_id}#s{k:03d}", group=track_id,
            t0=float(obs["time"][s.start]),
            lat=np.asarray(processed.lat[k, :m], np.float32),
            lon=np.asarray(processed.lon[k, :m], np.float32),
            alt=np.asarray(processed.alt_msl_m[k, :m], np.float32)))
    return rows


def bin_screen_rows(rows: Sequence[ScreenRow], *, grid: GridSpec,
                    config: ScreenConfig) -> Dict[CellKey, List[str]]:
    """Halo-padded cell membership (cell -> row ids) for screen rows."""
    return bin_samples(
        [(r.row_id, r.times, r.lat, r.lon, r.alt) for r in rows],
        spec=grid, h_pad_m=config.h_thresh_m, v_pad_m=config.v_thresh_m)


def _pack_cell(rows: Sequence[ScreenRow], dt: float):
    """-> (t0_cell, T, lat, lon, alt, valid) on the cell's union grid."""
    t0c = min(r.t0 for r in rows)
    starts = [int(round((r.t0 - t0c) / dt)) for r in rows]
    T = max(s + len(r) for s, r in zip(starts, rows))
    K = len(rows)
    lat = np.zeros((K, T), np.float32)
    lon = np.zeros((K, T), np.float32)
    alt = np.zeros((K, T), np.float32)
    val = np.zeros((K, T), np.float32)
    for k, (s, r) in enumerate(zip(starts, rows)):
        m = len(r)
        lat[k, s:s + m] = r.lat
        lon[k, s:s + m] = r.lon
        alt[k, s:s + m] = r.alt
        val[k, s:s + m] = 1.0
    return t0c, T, lat, lon, alt, val


def dedup_candidates(cands: Iterable[dict]) -> List[dict]:
    """Canonical candidate list: unique pairs, sorted by (a, b).

    A pair screened in several cells produces identical records (the
    pair trace depends only on the two rows' absolute-time samples), so
    keeping the first is exact."""
    seen: Set[Tuple[str, str]] = set()
    out = []
    for c in sorted(cands, key=lambda c: (c["a"], c["b"])):
        key = (c["a"], c["b"])
        if key not in seen:
            seen.add(key)
            out.append(c)
    return out


def screen_cells(cells: Dict[CellKey, Sequence[ScreenRow]], *,
                 config: ScreenConfig,
                 new_ids: Optional[Dict[CellKey, Set[str]]] = None,
                 dedup: bool = True):
    """Screen binned cells -> (candidates, stats).

    Cells are length-bucketed by (padded rows, padded time span) and
    batched so one kernel launch covers many same-shape cells.  Empty
    and singleton cells are skipped before any batching.  With
    ``new_ids`` only pairs touching a new row are emitted.
    """
    dt = config.dt_s
    skipped = screened = pairs = 0
    buckets: Dict[Tuple[int, int], list] = {}
    occ_max = 0
    for key in sorted(cells):
        rows = sorted(cells[key], key=lambda r: r.row_id)
        occ_max = max(occ_max, len(rows))
        if len(rows) < 2:
            skipped += 1
            continue
        screened += 1
        pairs += len(rows) * (len(rows) - 1) // 2
        t0c, T, *planes = _pack_cell(rows, dt)
        Kp = max(_ROW_BLOCK, _round_rows(len(rows)))
        Tp = (bucket_width(T) if T <= BUCKET_SIZES[-1]
              else -(-T // _T_CHUNK) * _T_CHUNK)
        buckets.setdefault((Kp, Tp), []).append((key, rows, t0c, T, planes))

    _count(cells_screened=screened, cells_skipped=skipped,
           pairs_screened=pairs)

    cands: List[dict] = []
    for (Kp, Tp), items in sorted(buckets.items()):
        C = len(items)
        lat = np.zeros((C, Kp, Tp), np.float32)
        lon = np.zeros((C, Kp, Tp), np.float32)
        alt = np.zeros((C, Kp, Tp), np.float32)
        val = np.zeros((C, Kp, Tp), np.float32)
        for c, (_, rows, _, T, planes) in enumerate(items):
            K = len(rows)
            lat[c, :K, :T], lon[c, :K, :T] = planes[0], planes[1]
            alt[c, :K, :T], val[c, :K, :T] = planes[2], planes[3]
        res = screen_aligned(lat, lon, alt, val,
                             h_thresh_m=config.h_thresh_m,
                             v_thresh_m=config.v_thresh_m,
                             backend=config.backend, device=config.device)
        for c, (key, rows, t0c, _, _) in enumerate(items):
            fresh = None if new_ids is None else new_ids.get(key, set())
            ii, jj = np.nonzero(res["hit"][c] > 0.5)
            for i, j in zip(ii.tolist(), jj.tolist()):
                if i >= len(rows) or j >= len(rows):
                    continue
                a, b = rows[i], rows[j]
                if a.group == b.group:
                    continue
                if fresh is not None and a.row_id not in fresh \
                        and b.row_id not in fresh:
                    continue
                cands.append({
                    "a": a.row_id, "b": b.row_id,
                    "t_s": float(t0c + float(res["t_idx"][c, i, j]) * dt),
                    "h_m": float(res["min_dh"][c, i, j]),
                    "v_m": float(res["min_dv"][c, i, j]),
                })
    stats = {
        "cells": screened + skipped,
        "cells_screened": screened,
        "cells_skipped": skipped,
        "pairs_screened": pairs,
        "max_occupancy": occ_max,
        "candidates_raw": len(cands),
    }
    if dedup:
        cands = dedup_candidates(cands)
    stats["candidates"] = len(cands)
    return cands, stats


def screen_rows_grid(rows: Sequence[ScreenRow], *, grid: GridSpec,
                     config: ScreenConfig):
    """Bin rows into the spatial hash and screen every multi-row cell."""
    by_id = {r.row_id: r for r in rows}
    bins = bin_screen_rows(rows, grid=grid, config=config)
    cells = {key: [by_id[i] for i in ids] for key, ids in bins.items()}
    return screen_cells(cells, config=config)


# ---------------------------------------------------------------------------
# numpy brute-force reference
# ---------------------------------------------------------------------------

def brute_force_screen(rows: Sequence[ScreenRow], *,
                       config: ScreenConfig) -> List[dict]:
    """All-pairs numpy screen on one global time grid, O(N^2 * T).

    No spatial pruning, no device: the exactness reference the grid +
    kernel path must match candidate for candidate.
    """
    rows = sorted(rows, key=lambda r: r.row_id)
    if len(rows) < 2:
        return []
    dt = config.dt_s
    t0g = min(r.t0 for r in rows)
    starts = [int(round((r.t0 - t0g) / dt)) for r in rows]
    T = max(s + len(r) for s, r in zip(starts, rows))
    N = len(rows)
    lat = np.zeros((N, T), np.float32)
    lon = np.zeros((N, T), np.float32)
    alt = np.zeros((N, T), np.float32)
    val = np.zeros((N, T), bool)
    for k, (s, r) in enumerate(zip(starts, rows)):
        m = len(r)
        lat[k, s:s + m] = r.lat
        lon[k, s:s + m] = r.lon
        alt[k, s:s + m] = r.alt
        val[k, s:s + m] = True
    groups = np.array([r.group for r in rows])
    m_per_deg = np.float32(M_PER_DEG)
    h_t = np.float32(config.h_thresh_m)
    v_t = np.float32(config.v_thresh_m)
    out = []
    for i in range(N - 1):
        lj = lat[i + 1:]
        dn = (lat[i][None, :] - lj) * m_per_deg
        de = ((lon[i][None, :] - lon[i + 1:]) * m_per_deg
              * np.cos(np.deg2rad(np.float32(0.5) * (lat[i][None, :] + lj))))
        dh = np.sqrt(dn * dn + de * de)
        dv = np.abs(alt[i][None, :] - alt[i + 1:])
        hit_t = (val[i][None, :] & val[i + 1:]
                 & (dh <= h_t) & (dv <= v_t)
                 & (groups[i + 1:] != groups[i])[:, None])
        js = np.nonzero(hit_t.any(axis=1))[0]
        for j in js.tolist():
            dh_m = np.where(hit_t[j], dh[j], _BIG)
            dv_m = np.where(hit_t[j], dv[j], _BIG)
            ti = int(np.argmin(dh_m))
            out.append({
                "a": rows[i].row_id, "b": rows[i + 1 + j].row_id,
                "t_s": float(t0g + ti * dt),
                "h_m": float(dh_m[ti]),
                "v_m": float(np.min(dv_m)),
            })
    return dedup_candidates(out)
