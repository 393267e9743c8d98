"""Rectilinear polygon machinery (paper §III.B, Fig 1).

The paper's pipeline: circles around aerodromes -> union into (possibly
non-convex, overlapping) polygons -> a set of DISCRETE, NON-OVERLAPPING,
RECTILINEAR polygons -> iteratively joined / divided into simple
non-overlapping rectangular bounding boxes.

We implement this on a raster: circles are rasterized onto a lat/lon grid
(the union is then exact on the grid), connected components give the
discrete rectilinear polygons, and a row-run sweep decomposes each
component into maximal non-overlapping rectangles (merging vertically
adjacent runs with identical column extents — the 'iteratively joined'
step). Oversized rectangles are recursively split (the 'iteratively
divided' step).

Everything returns cell-index rectangles [r0, r1) x [c0, c1); queries.py
maps them back to lat/lon.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

Rect = tuple[int, int, int, int]   # (r0, c0, r1, c1), half-open


def rasterize_circles(lats: np.ndarray, lons: np.ndarray, radius_deg: float,
                      grid_lat: np.ndarray, grid_lon: np.ndarray,
                      lon_scale: bool = True) -> np.ndarray:
    """Boolean mask of the union of circles on the grid.

    ``radius_deg`` is the radius in latitude degrees; the longitude extent
    is stretched by 1/cos(lat) when ``lon_scale`` (8 nm is ~0.133 deg lat).
    """
    mask = np.zeros((len(grid_lat), len(grid_lon)), dtype=bool)
    glat = grid_lat[:, None]
    glon = grid_lon[None, :]
    for lat0, lon0 in zip(lats, lons):
        coslat = max(np.cos(np.deg2rad(lat0)), 0.2) if lon_scale else 1.0
        d2 = ((glat - lat0) ** 2
              + ((glon - lon0) * coslat) ** 2)
        mask |= d2 <= radius_deg ** 2
    return mask


def connected_components(mask: np.ndarray) -> list[np.ndarray]:
    """4-connected components of a boolean mask, as boolean masks.

    Iterative flood fill (stack-based) — no scipy dependency.
    """
    visited = np.zeros_like(mask, dtype=bool)
    comps: list[np.ndarray] = []
    rows, cols = mask.shape
    for r0 in range(rows):
        for c0 in range(cols):
            if mask[r0, c0] and not visited[r0, c0]:
                comp = np.zeros_like(mask, dtype=bool)
                stack = [(r0, c0)]
                visited[r0, c0] = True
                while stack:
                    r, c = stack.pop()
                    comp[r, c] = True
                    for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                        rr, cc = r + dr, c + dc
                        if (0 <= rr < rows and 0 <= cc < cols
                                and mask[rr, cc] and not visited[rr, cc]):
                            visited[rr, cc] = True
                            stack.append((rr, cc))
                comps.append(comp)
    return comps


def decompose_mask_into_rectangles(mask: np.ndarray) -> list[Rect]:
    """Exact cover of a boolean mask by non-overlapping rectangles.

    Row-run sweep: each row decomposes into maximal horizontal runs; runs
    with identical column extent merge with the row above ('iteratively
    joined'). Produces a small rectangle count for rectilinear unions of
    circles while guaranteeing exact, overlap-free coverage.
    """
    rows, cols = mask.shape
    open_runs: dict[tuple[int, int], int] = {}   # (c0, c1) -> r_start
    rects: list[Rect] = []
    for r in range(rows + 1):
        runs: set[tuple[int, int]] = set()
        if r < rows:
            row = mask[r]
            c = 0
            while c < cols:
                if row[c]:
                    c0 = c
                    while c < cols and row[c]:
                        c += 1
                    runs.add((c0, c))
                else:
                    c += 1
        # Close runs that don't continue with the same extent.
        for extent in list(open_runs):
            if extent not in runs:
                r_start = open_runs.pop(extent)
                rects.append((r_start, extent[0], r, extent[1]))
        # Open new runs.
        for extent in runs:
            if extent not in open_runs:
                open_runs[extent] = r
    return rects


def split_large_rectangles(rects: Sequence[Rect],
                           max_cells: int) -> list[Rect]:
    """Recursively halve rectangles larger than ``max_cells`` cells
    (paper: 'For large rectangles, they are iteratively divided into
    smaller boxes')."""
    out: list[Rect] = []
    stack = list(rects)
    while stack:
        r0, c0, r1, c1 = stack.pop()
        h, w = r1 - r0, c1 - c0
        if h * w <= max_cells or (h <= 1 and w <= 1):
            out.append((r0, c0, r1, c1))
        elif h >= w:
            mid = r0 + h // 2
            stack.append((r0, c0, mid, c1))
            stack.append((mid, c0, r1, c1))
        else:
            mid = c0 + w // 2
            stack.append((r0, c0, r1, mid))
            stack.append((r0, mid, r1, c1))
    return out


def rectangles_cover_mask(rects: Sequence[Rect], mask: np.ndarray) -> bool:
    """Validation helper: rectangles exactly tile the mask, no overlap."""
    acc = np.zeros_like(mask, dtype=np.int32)
    for r0, c0, r1, c1 in rects:
        acc[r0:r1, c0:c1] += 1
    return bool(np.all((acc == 1) == mask) and np.all(acc <= 1))
