"""Bounding-box query generation (paper §III.B, Fig 2; software [16]).

Pipeline (mirrors em-download-opensky):
  1. circles of TERMINAL_RADIUS_NM around every aerodrome;
  2. union -> discrete non-overlapping rectilinear polygons (raster);
  3. decompose into simple non-overlapping rectangles; split large ones;
  4. drop boxes not within the desired airspace classes / distance;
  5. DEM min/max elevation per box -> MSL range for the desired AGL range
     (default 0..5,100 ft AGL, hard ceiling 12,500 ft MSL);
  6. meridian-based timezone per box;
  7. one query per (box, local day), assigned to a load-balancing group.

The Impala shell supports only axis-aligned range predicates (no geometric
types), which is why everything must become rectangles.

The port's copy of the reference's ``geometry/queries.py`` (numpy only).
:data:`RADIUS_DEG` is also the terminal-cylinder radius the process
phase's airspace lookup uses.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.geometry.aerodromes import (
    Aerodrome, NM_TO_M, TERMINAL_RADIUS_NM, synthetic_aerodromes)
from repro_torch.geometry.dem import FT_PER_M, SyntheticGlobeDEM
from repro_torch.geometry.rectilinear import (
    connected_components, decompose_mask_into_rectangles, rasterize_circles,
    split_large_rectangles)

DEFAULT_AGL_CEILING_FT = 5100.0
HARD_MSL_CEILING_FT = 12500.0
# 8 nm in latitude degrees: 8 * 1852 m / 111,111 m/deg.
RADIUS_DEG = TERMINAL_RADIUS_NM * NM_TO_M / 111_111.0


@dataclasses.dataclass(frozen=True)
class BoundingBox:
    box_id: int
    lat_min: float
    lat_max: float
    lon_min: float
    lon_max: float
    elev_min_ft: float
    elev_max_ft: float
    msl_min_ft: float
    msl_max_ft: float
    timezone_offset_h: int
    airspace_classes: tuple[str, ...]

    @property
    def area_deg2(self) -> float:
        return (self.lat_max - self.lat_min) * (self.lon_max - self.lon_min)


@dataclasses.dataclass(frozen=True)
class Query:
    query_id: int
    box_id: int
    day_index: int
    group: int
    sql: str


def make_bounding_boxes(
        aerodromes: Optional[Sequence[Aerodrome]] = None,
        *,
        cells_per_deg: int = 8,
        max_cells: int = 12,
        agl_ceiling_ft: float = DEFAULT_AGL_CEILING_FT,
        classes: tuple[str, ...] = ("B", "C", "D"),
        dem: Optional[SyntheticGlobeDEM] = None) -> list[BoundingBox]:
    """Steps 1-6: aerodrome circles -> filtered, annotated boxes."""
    if aerodromes is None:
        aerodromes = synthetic_aerodromes()
    if dem is None:
        dem = SyntheticGlobeDEM(cells_per_deg=cells_per_deg)
    aero = [a for a in aerodromes if a.airspace_class in classes]
    lats = np.array([a.lat for a in aero])
    lons = np.array([a.lon for a in aero])

    grid_lat, grid_lon = dem.lats, dem.lons
    # Conservative rasterization: a grid point marks the CELL extent
    # [point, point+1/cpd)^2, so inflate the radius by the half-cell
    # diagonal — every point of the union is then inside some marked cell
    # (bounding boxes are supersets, exactly like the paper's).
    half_diag = 0.5 * (2 ** 0.5) / cells_per_deg
    mask = rasterize_circles(lats, lons, RADIUS_DEG + half_diag,
                             grid_lat, grid_lon)

    rects: list[tuple[int, int, int, int]] = []
    for comp in connected_components(mask):
        rects.extend(decompose_mask_into_rectangles(comp))
    rects = split_large_rectangles(rects, max_cells=max_cells)

    boxes: list[BoundingBox] = []
    cell_lat = (grid_lat[-1] - grid_lat[0]) / (len(grid_lat) - 1)
    cell_lon = (grid_lon[-1] - grid_lon[0]) / (len(grid_lon) - 1)
    for bid, (r0, c0, r1, c1) in enumerate(sorted(rects)):
        lat0 = grid_lat[0] + r0 * cell_lat
        lat1 = grid_lat[0] + r1 * cell_lat
        lon0 = grid_lon[0] + c0 * cell_lon
        lon1 = grid_lon[0] + c1 * cell_lon
        # Step 4: keep boxes within 1.5 radii of some in-class aerodrome
        # (nearest-point distance, so a box containing an aerodrome at its
        # corner is never dropped).
        clat, clon = 0.5 * (lat0 + lat1), 0.5 * (lon0 + lon1)
        nlat = np.clip(lats, lat0, lat1)
        nlon = np.clip(lons, lon0, lon1)
        d2 = (lats - nlat) ** 2 + ((lons - nlon)
                                   * np.cos(np.deg2rad(clat))) ** 2
        near = d2 <= (1.5 * RADIUS_DEG) ** 2
        if not near.any():
            continue
        near_classes = tuple(sorted({aero[i].airspace_class
                                     for i in np.flatnonzero(near)}))
        # Step 5: DEM -> MSL range.
        emin_m, emax_m = dem.minmax_in_box(lat0, lat1, lon0, lon1)
        emin_ft, emax_ft = emin_m * FT_PER_M, emax_m * FT_PER_M
        msl_min = emin_ft                       # AGL 0 at the lowest point
        msl_max = min(emax_ft + agl_ceiling_ft, HARD_MSL_CEILING_FT)
        # Step 6: meridian-based timezone.
        tz = int(np.round(clon / 15.0))
        boxes.append(BoundingBox(
            box_id=len(boxes),
            lat_min=float(lat0), lat_max=float(lat1),
            lon_min=float(lon0), lon_max=float(lon1),
            elev_min_ft=float(emin_ft), elev_max_ft=float(emax_ft),
            msl_min_ft=float(msl_min), msl_max_ft=float(msl_max),
            timezone_offset_h=tz,
            airspace_classes=near_classes))
    return boxes


def generate_queries(boxes: Sequence[BoundingBox],
                     n_days: int = 196,
                     n_groups: int = 64) -> list[Query]:
    """Step 7: one query per (box, local day); groups balance total area.

    The paper generated 136,884 queries for 196 days across 695 boxes.
    Groups facilitate load balancing and storage optimization: we assign
    boxes to groups greedily by descending area (largest-first into the
    least-loaded group — the same insight as task organization by size).
    """
    order = sorted(boxes, key=lambda b: -b.area_deg2)
    load = [0.0] * n_groups
    group_of: dict[int, int] = {}
    for b in order:
        g = min(range(n_groups), key=load.__getitem__)
        group_of[b.box_id] = g
        load[g] += b.area_deg2

    queries: list[Query] = []
    qid = 0
    for b in boxes:
        for d in range(n_days):
            # Local midnight-to-midnight day window, expressed in UTC via
            # the meridian timezone (the Impala table is hour-partitioned).
            utc_start = d * 24 - b.timezone_offset_h
            sql = (
                "SELECT * FROM state_vectors_data4 WHERE "
                f"lat BETWEEN {b.lat_min:.4f} AND {b.lat_max:.4f} AND "
                f"lon BETWEEN {b.lon_min:.4f} AND {b.lon_max:.4f} AND "
                f"baroaltitude BETWEEN {b.msl_min_ft / FT_PER_M:.1f} "
                f"AND {b.msl_max_ft / FT_PER_M:.1f} AND "
                f"hour >= {utc_start * 3600} AND "
                f"hour < {(utc_start + 24) * 3600}"
            )
            queries.append(Query(
                query_id=qid, box_id=b.box_id, day_index=d,
                group=group_of[b.box_id], sql=sql))
            qid += 1
    return queries
