"""Aerodrome, DEM and spatial-hash geometry of the process and screen
phases (paper §III.B)."""

from repro_torch.geometry.aerodromes import Aerodrome, synthetic_aerodromes
from repro_torch.geometry.dem import SyntheticGlobeDEM
from repro_torch.geometry.gridhash import (
    GridSpec, bin_samples, cell_cost, cell_id, cells_for_samples,
    occupancy_stats, wrap_lon)

__all__ = ["Aerodrome", "synthetic_aerodromes", "SyntheticGlobeDEM",
           "GridSpec", "bin_samples", "cell_cost", "cell_id",
           "cells_for_samples", "occupancy_stats", "wrap_lon"]
