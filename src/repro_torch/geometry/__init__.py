"""Aerodrome query-generation geometry (paper §III.B, Figs 1-2), and the
DEM and spatial hash of the process and screen phases."""

from repro_torch.geometry.aerodromes import (
    Aerodrome, synthetic_aerodromes)
from repro_torch.geometry.dem import SyntheticGlobeDEM
from repro_torch.geometry.gridhash import (
    GridSpec, bin_samples, cell_cost, cell_id, cells_for_samples,
    occupancy_stats, wrap_lon)
from repro_torch.geometry.queries import (
    BoundingBox, Query, generate_queries, make_bounding_boxes)
from repro_torch.geometry.rectilinear import (
    decompose_mask_into_rectangles, rasterize_circles, split_large_rectangles)

__all__ = [
    "Aerodrome", "synthetic_aerodromes",
    "SyntheticGlobeDEM",
    "GridSpec", "bin_samples", "cell_cost", "cell_id",
    "cells_for_samples", "occupancy_stats", "wrap_lon",
    "BoundingBox", "Query", "generate_queries", "make_bounding_boxes",
    "decompose_mask_into_rectangles", "rasterize_circles",
    "split_large_rectangles",
]
