"""Synthetic NOAA GLOBE-like digital elevation model.

The paper uses the NOAA GLOBE DEM (30-arc-second, ~1 km) to estimate the
min/max elevation of each bounding box, converting a desired AGL range
into the MSL range Impala can filter on. We synthesize smooth continental
terrain (sum of long-wavelength sinusoids + ridged noise, flat coasts)
deterministic in the seed, sampled on the same grid the rasterizer uses.

Also provides the bilinear lookup used by the AGL-altitude kernel's oracle
(kernels/agl_lookup/ref.py delegates here for the pure-numpy path).
"""

from __future__ import annotations

import numpy as np

FT_PER_M = 3.280839895


class SyntheticGlobeDEM:
    """Deterministic synthetic terrain over the continental US."""

    def __init__(self, lat_min: float = 24.0, lat_max: float = 50.0,
                 lon_min: float = -125.0, lon_max: float = -66.0,
                 cells_per_deg: int = 8, seed: int = 5):
        self.lat_min, self.lat_max = lat_min, lat_max
        self.lon_min, self.lon_max = lon_min, lon_max
        self.cells_per_deg = cells_per_deg
        nlat = int(round((lat_max - lat_min) * cells_per_deg)) + 1
        nlon = int(round((lon_max - lon_min) * cells_per_deg)) + 1
        self.lats = np.linspace(lat_min, lat_max, nlat)
        self.lons = np.linspace(lon_min, lon_max, nlon)
        rng = np.random.default_rng(seed)
        glat, glon = np.meshgrid(self.lats, self.lons, indexing="ij")
        z = np.zeros_like(glat)
        # Long-wavelength continental shape + Rockies/Appalachians ridges.
        for _ in range(12):
            fx, fy = rng.uniform(0.02, 0.45, size=2)
            ph1, ph2 = rng.uniform(0, 2 * np.pi, size=2)
            amp = rng.uniform(80, 420)
            z += amp * np.sin(fx * glon + ph1) * np.sin(fy * glat + ph2)
        # Rockies: strong meridional ridge near -110..-105.
        z += 2200.0 * np.exp(-((glon + 107.5) / 6.0) ** 2)
        # Appalachians: weaker ridge near -80.
        z += 600.0 * np.exp(-((glon + 80.0) / 3.5) ** 2)
        # Coastal taper.
        z *= np.clip((glat - 23.0) / 4.0, 0.2, 1.0)
        self.elevation_m = np.maximum(z, 0.0)

    # -- queries ------------------------------------------------------------

    def minmax_in_box(self, lat0: float, lat1: float,
                      lon0: float, lon1: float) -> tuple[float, float]:
        """Min/max elevation (meters MSL) inside a lat/lon box."""
        i0 = int(np.searchsorted(self.lats, lat0, "left"))
        i1 = max(int(np.searchsorted(self.lats, lat1, "right")), i0 + 1)
        j0 = int(np.searchsorted(self.lons, lon0, "left"))
        j1 = max(int(np.searchsorted(self.lons, lon1, "right")), j0 + 1)
        i1 = min(i1, len(self.lats))
        j1 = min(j1, len(self.lons))
        i0 = min(i0, i1 - 1)
        j0 = min(j0, j1 - 1)
        patch = self.elevation_m[i0:i1, j0:j1]
        return float(patch.min()), float(patch.max())

    def bilinear(self, lat: np.ndarray, lon: np.ndarray) -> np.ndarray:
        """Bilinear elevation interpolation (meters), vectorized."""
        fi = (np.clip(lat, self.lat_min, self.lat_max) - self.lat_min) \
            * self.cells_per_deg
        fj = (np.clip(lon, self.lon_min, self.lon_max) - self.lon_min) \
            * self.cells_per_deg
        i = np.clip(fi.astype(np.int64), 0, len(self.lats) - 2)
        j = np.clip(fj.astype(np.int64), 0, len(self.lons) - 2)
        di = fi - i
        dj = fj - j
        z = self.elevation_m
        return ((1 - di) * (1 - dj) * z[i, j]
                + (1 - di) * dj * z[i, j + 1]
                + di * (1 - dj) * z[i + 1, j]
                + di * dj * z[i + 1, j + 1])
