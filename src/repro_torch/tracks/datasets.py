"""Synthetic stand-in for the paper's dataset #1 ("Mondays", §III.B).

No network access is available, so the workflow writes real, scaled-down
CSV files whose sizes follow the full-scale manifest of dataset #1:
104 Mondays (2018-02-05 .. 2020-11-16), 24 hourly files/day with gaps =>
2425 files, 714 GB total, with a roughly Gaussian (diurnal) size mix
(Fig 3).  The same seed writes byte-identical files in both packages.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from repro_torch.core.messages import Task

GB = 1_000_000_000

# Paper constants.
MONDAY_FILE_COUNT = 2425
MONDAY_TOTAL_BYTES = 714 * GB
MONDAY_COUNT = 104


def monday_manifest(seed: int = 0) -> list[Task]:
    """2425 hourly files with a diurnal (Gaussian-looking, Fig 3) size mix."""
    rng = np.random.default_rng(seed)
    # 104 Mondays x 24 hours = 2496 slots; drop 71 at random (availability
    # is not guaranteed) to hit exactly 2425 files.
    slots = [(d, h) for d in range(MONDAY_COUNT) for h in range(24)]
    drop = rng.choice(len(slots), size=len(slots) - MONDAY_FILE_COUNT,
                      replace=False)
    keep = sorted(set(range(len(slots))) - set(drop.tolist()))
    # Diurnal weight: global ADS-B volume peaks around 14:00 UTC (EU+US
    # daytime overlap). Multiplicative lognormal noise keeps sizes positive.
    days = np.array([slots[i][0] for i in keep])
    hours = np.array([slots[i][1] for i in keep])
    w = 0.35 + 0.65 * 0.5 * (1.0 + np.cos(2.0 * np.pi * (hours - 14) / 24.0))
    w = w * rng.lognormal(mean=0.0, sigma=0.18, size=len(keep))
    sizes = w / w.sum() * MONDAY_TOTAL_BYTES
    ts = days * 86400.0 * 7 + hours * 3600.0
    return [Task(task_id=f"monday/d{d:03d}/h{h:02d}.csv",
                 size_bytes=int(s), timestamp=float(t))
            for d, h, s, t in zip(days, hours, sizes, ts)]


STATE_COLUMNS = ["time", "icao24", "lat", "lon", "velocity", "heading",
                 "vertrate", "baroaltitude", "geoaltitude", "onground"]


@dataclasses.dataclass(frozen=True)
class ScaledDatasetSpec:
    """A scaled-down real dataset written to disk.

    ``scale`` divides file sizes; e.g. scale=1e6 turns 714 GB into ~714 KB
    of actual CSV. Observation counts follow from bytes/row (~80 B)."""
    name: str
    n_files: int
    scale: float
    seed: int = 0
    update_period_s: float = 10.0    # dataset #1: >=10 s between obs


def _synth_track_points(rng: np.random.Generator, n: int, icao24: str,
                        t0: float, period_s: float) -> list[str]:
    """One aircraft's observation rows: a smooth random flight."""
    t = t0 + np.arange(n) * period_s
    lat0 = rng.uniform(25.0, 48.0)
    lon0 = rng.uniform(-124.0, -67.0)
    heading = rng.uniform(0, 360)
    speed = rng.uniform(30.0, 220.0)          # m/s
    turn = rng.normal(0.0, 0.3, size=n).cumsum()
    hdg = np.deg2rad(heading + turn)
    dlat = speed * np.cos(hdg) * period_s / 111_111.0
    dlon = speed * np.sin(hdg) * period_s / (111_111.0 *
                                             np.cos(np.deg2rad(lat0)))
    lat = lat0 + np.concatenate([[0.0], dlat[:-1]]).cumsum()
    lon = lon0 + np.concatenate([[0.0], dlon[:-1]]).cumsum()
    alt0 = rng.uniform(300.0, 3000.0)
    vr = rng.normal(0.0, 2.0, size=n)
    alt = np.maximum(alt0 + (vr * period_s).cumsum(), 10.0)
    rows = []
    for i in range(n):
        rows.append(
            f"{t[i]:.0f},{icao24},{lat[i]:.5f},{lon[i]:.5f},"
            f"{speed:.1f},{np.rad2deg(hdg[i]) % 360:.1f},{vr[i]:.2f},"
            f"{alt[i]:.1f},{alt[i] + rng.normal(0, 8):.1f},0")
    return rows


def write_scaled_dataset(root: str, spec: ScaledDatasetSpec,
                         manifest: Optional[list[Task]] = None) -> list[str]:
    """Write real CSV files whose sizes follow ``manifest`` / ``scale``.

    Returns the list of file paths. Each file holds whole synthetic tracks
    (multiple aircraft), like an OpenSky hourly state file.
    """
    rng = np.random.default_rng(spec.seed)
    if manifest is None:
        manifest = monday_manifest(spec.seed)[: spec.n_files]
    manifest = manifest[: spec.n_files]
    os.makedirs(root, exist_ok=True)
    paths = []
    header = ",".join(STATE_COLUMNS)
    for task in manifest:
        target_bytes = max(int(task.size_bytes / spec.scale), 400)
        path = os.path.join(root, task.task_id.replace("/", "_"))
        if not path.endswith(".csv"):
            path += ".csv"
        rows: list[str] = []
        nbytes = len(header) + 1
        while nbytes < target_bytes:
            # US registry block (matches tracks.registry.synthetic_registry)
            icao24 = f"{rng.integers(0xA00000, 0xB00000):06x}"
            n = int(rng.integers(12, 120))
            chunk = _synth_track_points(
                rng, n, icao24, task.timestamp, spec.update_period_s)
            rows.extend(chunk)
            nbytes += sum(len(r) + 1 for r in chunk)
        with open(path, "w") as f:
            f.write(header + "\n")
            f.write("\n".join(rows) + "\n")
        paths.append(path)
    return paths


#: Modeled store re-read bytes per screen-cell row (one resampled
#: segment's lat/lon/alt planes).  Screen-cell task sizes are
#: ``occupancy * SCREEN_ROW_BYTES``, so occupancy is recoverable from
#: ``size_bytes`` exactly.
SCREEN_ROW_BYTES = 12_000
