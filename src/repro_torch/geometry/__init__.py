"""Aerodrome and DEM geometry the process phase needs (paper §III.B)."""

from repro_torch.geometry.aerodromes import Aerodrome, synthetic_aerodromes
from repro_torch.geometry.dem import SyntheticGlobeDEM

__all__ = ["Aerodrome", "synthetic_aerodromes", "SyntheticGlobeDEM"]
