"""Synthetic stand-ins for the paper's three datasets.

No network access is available, so we synthesize datasets that match the
paper's *described statistics* (§III.B-C, §V):

  Dataset #1 "Mondays"   : 104 Mondays (2018-02-05 .. 2020-11-16), 24 hourly
                           files/day with gaps => 2425 files, 714 GB total.
                           Fig 3: roughly Gaussian size distribution —
                           diurnal pattern because files are per-UTC-hour.
  Dataset #2 "Aerodromes": 136,884 query-result files over 695 bounding
                           boxes x 196 days, 847 GB. Fig 3: heavy-tailed
                           ("sloping") — activity is not uniform across
                           locations; many small files.
  Radar (§V)             : 13,190,700 deidentified ids across 18 radars,
                           Jan-Sep 2015; tasks are small and uniform;
                           allocated 300 tasks/message => 43,969 messages.

Two products per dataset:
  * a *manifest* of (task_id, size_bytes, timestamp) at FULL scale — drives
    the discrete-event simulator benchmarks; and
  * real, scaled-down CSV files on disk (synthetic ADS-B/radar
    observations) — drive the real workflow end to end.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional

import numpy as np

from repro_torch.core.messages import Task

MB = 1_000_000
GB = 1_000_000_000

# Paper constants.
MONDAY_FILE_COUNT = 2425
MONDAY_TOTAL_BYTES = 714 * GB
MONDAY_COUNT = 104
AERODROME_FILE_COUNT = 136_884
AERODROME_TOTAL_BYTES = 847 * GB
AERODROME_BBOX_COUNT = 695
AERODROME_DAY_COUNT = 196
RADAR_ID_COUNT = 13_190_700
RADAR_TASKS_PER_MESSAGE = 300
RADAR_MESSAGE_COUNT = 43_969   # ceil(13_190_700 / 300)

RADARS = ["ATL", "DEN", "DFW", "FLL", "HPN", "JFK", "LAS", "LAX", "LAXN",
          "MOD", "OAK", "ORDA", "PDX", "PHL", "PHX", "SDF", "SEA", "STL"]


# ---------------------------------------------------------------------------
# Full-scale manifests (for the simulator).
# ---------------------------------------------------------------------------

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


def aerodrome_manifest(seed: int = 1) -> list[Task]:
    """136,884 query files; heavy-tailed sizes ('sloping', Fig 3)."""
    rng = np.random.default_rng(seed)
    n = AERODROME_FILE_COUNT
    # Location 'popularity' is heavy-tailed (Zipf-ish over bounding boxes),
    # compounded with per-day lognormal noise.
    bbox = rng.integers(0, AERODROME_BBOX_COUNT, size=n)
    popularity = rng.pareto(1.2, size=AERODROME_BBOX_COUNT) + 0.05
    w = popularity[bbox] * rng.lognormal(0.0, 0.8, size=n)
    sizes = w / w.sum() * AERODROME_TOTAL_BYTES
    day = rng.integers(0, AERODROME_DAY_COUNT, size=n)
    return [Task(task_id=f"aero/b{b:03d}/d{d:03d}_{i:06d}.csv",
                 size_bytes=int(s), timestamp=float(d) * 86400.0)
            for i, (b, d, s) in enumerate(zip(bbox, day, sizes))]


def radar_message_manifest(seed: int = 2,
                           n_messages: int = RADAR_MESSAGE_COUNT) -> list[Task]:
    """Radar job at MESSAGE granularity (300 ids each, §V).

    Per-message CPU hint: 300 small uniform tasks. Calibrated so the median
    worker busy time lands near the paper's 24.34 h with 1023 workers:
    total ~= 1023 * 87,633 s => ~6.8 s/task average (SQL query + organize +
    interpolate for ONE sensor-contiguous track).
    """
    rng = np.random.default_rng(seed)
    # Each message sums 300 i.i.d. gamma(8) task costs => gamma(2400) per
    # message; per-message relative sd ~2 %, matching the paper's tight
    # 1.12 h span across 24.34 h median worker times.
    per_msg_cpu = rng.gamma(shape=2400.0, scale=6.3 / 8.0,
                            size=n_messages) * (RADAR_TASKS_PER_MESSAGE / 300.0)
    sizes = rng.lognormal(math.log(1.2 * MB), 0.5, size=n_messages) \
        * RADAR_TASKS_PER_MESSAGE
    return [Task(task_id=f"radar/m{i:06d}",
                 size_bytes=int(s), timestamp=float(i),
                 cpu_cost_hint=float(c))
            for i, (s, c) in enumerate(zip(sizes, per_msg_cpu))]


def aircraft_archive_manifest(n_aircraft: int = 30_000,
                              seed: int = 7) -> list[Task]:
    """Leaf-directory archive tasks (§IV.B): one per aircraft.

    Filename-sorted task ids cluster a well-observed aircraft's files
    consecutively; sizes are heavy-tailed AND autocorrelated along the
    sorted order (commercial fleets share registry prefixes), which is the
    precondition for the block-distribution pathology.

    Fleet blocks of ~30 consecutive registrations match one worker's block
    size at 1023 workers, so a hot fleet lands on a single worker under
    block distribution — reproducing the paper's '2 % of processes account
    for >95 % of job time' pathology and the >90 % cyclic win.
    """
    rng = np.random.default_rng(seed)
    fleet_size = 30
    n_blocks = n_aircraft // fleet_size
    block_level = rng.pareto(0.9, size=n_blocks) + 0.01
    blocks = np.repeat(np.arange(n_blocks), fleet_size)[:n_aircraft]
    w = block_level[blocks] * rng.lognormal(0.0, 0.4, size=n_aircraft)
    sizes = w / w.sum() * MONDAY_TOTAL_BYTES
    return [Task(task_id=f"archive/{i:08d}", size_bytes=int(s),
                 timestamp=0.0)
            for i, s in enumerate(sizes)]


def processing_manifest(n_aircraft: int = 40_000, seed: int = 4) -> list[Task]:
    """Track-processing tasks (§IV.C): one per aircraft archive.

    CPU cost scales super-linearly with the aircraft's observation volume
    and with its spatial extent (wide-area tracks load more DEM tiles —
    §V attributes the OpenSky imbalance to exactly this). Calibrated to the
    paper's dataset #2 worker statistics: median 13.1 h, all done in
    29.6 h, 17.3 h fastest-to-slowest span, on 1023 workers.
    """
    rng = np.random.default_rng(seed)
    # The 4-tier hierarchy sorts by year/type/seats/icao24, so a filename
    # sort clusters aircraft of the same TYPE — and types differ hugely in
    # activity (commercial jets vs gliders). That autocorrelation is what
    # block distribution trips over (§IV.B applies to processing too: the
    # paper's predecessor needed >7 days with batch/block).
    n_fleets = 160
    fleet_level = rng.pareto(1.0, size=n_fleets) + 0.02
    fleet = np.sort(rng.integers(0, n_fleets, size=n_aircraft))
    w = fleet_level[fleet] * rng.lognormal(0.0, 0.45, size=n_aircraft)
    sizes = w / w.sum() * AERODROME_TOTAL_BYTES
    extent = rng.lognormal(0.0, 0.4, size=n_aircraft)    # DEM working set
    # CPU grows sublinearly with archive size (dedup/seek amortization) but
    # is inflated by spatial extent. Scale chosen so total work / 1023
    # workers ~= the paper's 13.1 h median; the sublinear exponent tames
    # the Pareto tail so 99.1 % of workers finish within 18 h.
    rel = (sizes / sizes.mean()) ** 0.45 * extent
    # mean 1206 s/task: 40,000 tasks / 1023 workers => ~13.1 h median busy.
    cpu = rel / rel.mean() * 1206.0                      # seconds
    # A handful of continental ferry flights: tracks spanning multiple
    # states load DEM tiles far beyond the norm (§V blames exactly these).
    # They stretch the slowest workers toward the paper's 29.6 h max
    # without moving the 99.1 % quantile.
    k = max(n_aircraft // 2500, 1)
    idx = rng.choice(n_aircraft, size=k, replace=False)
    cpu[idx] += rng.uniform(8.0 * 3600, 15.0 * 3600, size=k)
    return [Task(task_id=f"proc/f{f:03d}/{i:08d}", size_bytes=int(s),
                 timestamp=0.0, cpu_cost_hint=float(c))
            for i, (f, s, c) in enumerate(zip(fleet, sizes, cpu))]


def smoke_manifest(n: int = 200, seed: int = 0) -> list[Task]:
    """Tiny fixed-seed workload for live-backend smoke scenarios.

    Sizes follow the same deterministic pattern the old ad-hoc smoke jobs
    used (``(i * 37) % 23 + 1`` bytes), so a smoke task costs microseconds
    on the threads/processes backends while still exercising batching,
    ordering, and exactly-once accounting.  ``seed`` offsets the pattern so
    distinct smoke scenarios don't share task ids.
    """
    return [Task(task_id=f"smoke{seed}/t{i:04d}",
                 size_bytes=((i + seed) * 37) % 23 + 1, timestamp=float(i))
            for i in range(n)]


def heavy_tail_manifest(n: int = 20_000, seed: int = 5) -> list[Task]:
    """Many small tasks under a heavy Pareto tail (beyond-paper).

    The scheduling-policy bench's acceptance dataset: the §V radar
    regime (so many sub-second-to-seconds tasks that per-message
    overhead and the manager's serial send matter at
    ``tasks_per_message=1``) crossed with the aerodrome datasets'
    heavy-tailed size mix (Fig 3 "sloping": a few tasks hundreds of
    times the median).  Pareto(1.6) compute hints put the largest task
    near ``total/P`` for the bench's worker counts, which is the regime
    where dispatch ORDER (sized_lpt) and cost-budgeted chunking
    (adaptive_chunk) each separate from naive FIFO dispatch — exactly
    the gap the companion 2020 HPC paper measured behind stragglers.
    Task order is shuffled (timestamps are a random permutation), so
    chronological organization models an arrival stream with no
    helpful accidental ordering.
    """
    rng = np.random.default_rng(seed)
    cpu = 0.35 + rng.pareto(1.6, size=n) * 1.9           # seconds
    sizes = (cpu / cpu.mean()) * 260_000                  # bytes ~ cpu
    order = rng.permutation(n)
    return [Task(task_id=f"ht/t{i:06d}", size_bytes=max(int(s), 1_000),
                 timestamp=float(order[i]), cpu_cost_hint=float(c))
            for i, (s, c) in enumerate(zip(sizes, cpu))]


def tiny_task_manifest(n: int = 131_400, seed: int = 0) -> list[Task]:
    """Radar-like tiny-uniform tasks at reduced count (beyond-paper).

    The §V regime — so many sub-second tasks that the manager's serial
    send loop is the constraint — scaled to 131,400 tasks so sweeps over
    tasks-per-message stay simulable in seconds.
    """
    rng = np.random.default_rng(seed)
    return [Task(task_id=f"tiny/t{i:06d}", size_bytes=400_000,
                 timestamp=float(i),
                 cpu_cost_hint=float(rng.gamma(8.0, 0.25 / 8)))
            for i in range(n)]


# ---------------------------------------------------------------------------
# Encounter-screening density manifests (beyond-paper).
# ---------------------------------------------------------------------------

#: Modeled store re-read bytes per cell row (one resampled segment's
#: lat/lon/alt planes).  Screen-cell task sizes are
#: ``occupancy * SCREEN_ROW_BYTES``, so goldens and cost models can
#: recover occupancy from ``size_bytes`` exactly.
SCREEN_ROW_BYTES = 12_000

_SCREEN_REGION = (24.0, 48.0, -125.0, -67.0)       # lat/lon box (CONUS)

# Eight busy terminal areas; the paper's dataset #2 is aerodrome-anchored
# bounding-box queries, so density concentrates at a handful of hotspots.
_SCREEN_HOTSPOTS = [
    (33.64, -84.43), (32.90, -97.04), (39.86, -104.67), (41.98, -87.90),
    (33.94, -118.41), (40.64, -73.78), (37.62, -122.38), (47.45, -122.31),
]


#: Screen-trail sample spacing (seconds).  Trail start times snap to
#: this grid so pair placement on a shared time grid is independent of
#: the grid anchor (cell minimum vs global minimum) — the property the
#: grid-vs-brute-force exactness gate in the JAX package's
#: ``bench.encounters`` relies on.
SCREEN_TRAIL_DT_S = 15.0


def screen_density_trails(kind: str, n_aircraft: int, seed: int, *,
                          cell_t_s: float = 3600.0) -> list[tuple]:
    """Synthetic aircraft sample trails for the screening manifests.

    Each aircraft contributes one short straight trail (8 samples at
    ``SCREEN_TRAIL_DT_S``): ``(aircraft_id, times, lat, lon, alt)``.
    ``kind='dense'`` concentrates traffic at eight terminal hotspots
    plus inter-hotspot corridors at low altitude; ``kind='sparse'``
    spreads cruise-altitude overflights across the whole region.
    """
    rng = np.random.default_rng(seed)
    lat_lo, lat_hi, lon_lo, lon_hi = _SCREEN_REGION
    hot = np.array(_SCREEN_HOTSPOTS)
    rows = []
    for i in range(n_aircraft):
        if kind == "dense":
            if rng.random() < 0.7:      # terminal-area traffic
                c = hot[rng.integers(len(hot))]
                lat0 = c[0] + rng.normal(0.0, 0.05)
                lon0 = c[1] + rng.normal(0.0, 0.05)
            else:                        # inter-hotspot corridor
                a, b = hot[rng.choice(len(hot), 2, replace=False)]
                f = rng.random()
                lat0 = a[0] + f * (b[0] - a[0]) + rng.normal(0.0, 0.03)
                lon0 = a[1] + f * (b[1] - a[1]) + rng.normal(0.0, 0.03)
            alt0 = float(rng.lognormal(np.log(450.0), 0.5))
            speed = rng.uniform(60.0, 120.0)
        else:                            # "sparse": en-route overflights
            a = np.array([rng.uniform(lat_lo, lat_hi),
                          rng.uniform(lon_lo, lon_hi)])
            b = np.array([rng.uniform(lat_lo, lat_hi),
                          rng.uniform(lon_lo, lon_hi)])
            f = rng.random()
            lat0, lon0 = a + f * (b - a) + rng.normal(0.0, 0.15, 2)
            alt0 = rng.uniform(7_000.0, 12_000.0)
            speed = rng.uniform(180.0, 260.0)
        hdg = rng.uniform(0.0, 2.0 * np.pi)
        ns, dt = 8, SCREEN_TRAIL_DT_S
        t0 = round(float(rng.uniform(0.0, cell_t_s / 2)) / dt) * dt
        ts = t0 + np.arange(ns) * dt
        step = speed * dt / 111_111.0
        la = lat0 + np.cos(hdg) * step * np.arange(ns)
        lo = lon0 + np.sin(hdg) * step * np.arange(ns) \
            / max(np.cos(np.deg2rad(lat0)), 0.2)
        al = np.full(ns, alt0) + rng.normal(0.0, 5.0, ns).cumsum()
        rows.append((f"a{i:05d}", ts, la, lo, al))
    return rows


def _density_screen_tasks(kind: str, n_aircraft: int, seed: int, *,
                          cell_deg: float = 0.25, cell_alt_m: float = 300.0,
                          cell_t_s: float = 3600.0) -> list[Task]:
    """Screen-cell tasks from a real spatial-hash binning of the
    :func:`screen_density_trails` trails.

    Trails are binned through
    :func:`repro_torch.geometry.gridhash.bin_samples` with the default
    screening-threshold halo, and every multi-occupancy cell becomes
    one task (singleton cells never reach the kernel, so they are not
    workload).  ``cpu_cost_hint = cell_cost(occupancy)`` — quadratic —
    and timestamps are a random permutation, so chronological arrival
    models an unordered cell stream.
    """
    from repro_torch.geometry import gridhash
    rng = np.random.default_rng(seed + 101)
    spec = gridhash.GridSpec(cell_deg=cell_deg, cell_alt_m=cell_alt_m,
                             cell_t_s=cell_t_s)
    rows = screen_density_trails(kind, n_aircraft, seed,
                                 cell_t_s=cell_t_s)
    bins = gridhash.bin_samples(rows, spec=spec, h_pad_m=926.0,
                                v_pad_m=152.4)
    cells = sorted((key, len(ids)) for key, ids in bins.items()
                   if len(ids) >= 2)
    order = rng.permutation(len(cells))
    return [Task(task_id=f"screen/{kind}/{gridhash.cell_id(key)}",
                 size_bytes=occ * SCREEN_ROW_BYTES,
                 timestamp=float(order[k]),
                 cpu_cost_hint=gridhash.cell_cost(occ))
            for k, (key, occ) in enumerate(cells)]


def aerodrome_dense_manifest(n_aircraft: int = 3000,
                             seed: int = 11) -> list[Task]:
    """Aerodrome-dense screening cells (paper dataset #2 regime).

    Traffic concentrates at eight terminal hotspots plus the corridors
    between them, so a few cells hold hundreds of rows while the bulk
    hold a handful — with quadratic per-cell cost, the resulting skew
    is far beyond any size-linear manifest and is the acceptance
    workload for ``sized_lpt``/``adaptive_chunk`` in
    the JAX package's ``bench.encounters``.
    """
    return _density_screen_tasks("dense", n_aircraft, seed)


def enroute_sparse_manifest(n_aircraft: int = 900,
                            seed: int = 12) -> list[Task]:
    """En-route-sparse screening cells (paper dataset #1 regime).

    Overflights spread across the whole region at cruise altitudes:
    almost every occupied cell holds one or two rows, so max-cell
    occupancy stays an order of magnitude below the aerodrome-dense
    manifest (asserted by the dataset goldens) and screening cost is
    dominated by per-task overhead, not pair count.
    """
    return _density_screen_tasks("sparse", n_aircraft, seed)


# ---------------------------------------------------------------------------
# Manifest registry — the declarative handle the bench subsystem uses.
# ---------------------------------------------------------------------------

MANIFESTS = {
    "monday": monday_manifest,
    "aerodrome": aerodrome_manifest,
    "radar_messages": radar_message_manifest,
    "archive": aircraft_archive_manifest,
    "processing": processing_manifest,
    "smoke": smoke_manifest,
    "heavy_tail": heavy_tail_manifest,
    "tiny": tiny_task_manifest,
    "aerodrome_dense": aerodrome_dense_manifest,
    "enroute_sparse": enroute_sparse_manifest,
}

_manifest_cache: dict[tuple, list[Task]] = {}


def get_manifest(name: str, *, limit: Optional[int] = None,
                 **kwargs) -> list[Task]:
    """Build (and memoize) a named manifest.

    ``limit`` truncates AFTER generation so a scaled scenario sees a prefix
    of the exact full-scale task population.  Returns a fresh list each
    call; the cached copy is never handed out for mutation.
    """
    if name not in MANIFESTS:
        raise KeyError(f"unknown manifest {name!r}; "
                       f"choose from {sorted(MANIFESTS)}")
    key = (name, tuple(sorted(kwargs.items())))
    if key not in _manifest_cache:
        _manifest_cache[key] = MANIFESTS[name](**kwargs)
    tasks = _manifest_cache[key]
    return list(tasks if limit is None else tasks[:limit])


def manifest_stats(tasks: list[Task]) -> dict:
    """Distribution summary used by golden tests and BENCH artifacts."""
    sizes = np.array([t.size_bytes for t in tasks], dtype=float)
    total = float(sizes.sum())
    srt = np.sort(sizes)
    top1 = max(len(tasks) // 100, 1)
    return {
        "count": len(tasks),
        "total_bytes": int(total),
        "mean_bytes": float(sizes.mean()) if len(tasks) else 0.0,
        "median_over_mean": (float(np.median(sizes) / sizes.mean())
                             if total else 0.0),
        "cv": float(sizes.std() / sizes.mean()) if total else 0.0,
        "top1pct_share": float(srt[-top1:].sum() / total) if total else 0.0,
    }


# ---------------------------------------------------------------------------
# Real scaled-down observation files (for the actual workflow).
# ---------------------------------------------------------------------------

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
