"""Storage-layer benchmark scenarios: CSV-zip vs the columnar store.

The campaign benchmarks the scheduler, the kernels matrix benchmarks the
device hot path — this module benchmarks the layer that FEEDS that hot
path: how fast ``(obs, segs)`` batches reach
``SegmentProcessor._process_many`` from disk.  It compares the paper's
§III.A stopgap (zip archives whose CSV text is re-parsed every run)
against :mod:`repro_torch.store` (decoded columns, checksummed zlib shards,
index-driven planning, async prefetch) across a cold/warm x
sync/prefetch x feed-only/pipeline-consume matrix, and emits a
schema-validated ``BENCH_storage.json`` (``repro.bench.storage/v1``).

Metric split (same contract as the other artifacts):

  * deterministic ``metrics`` — track/point/segment counts, bytes on
    disk, ``bytes_per_point``, ``rebuild_identical`` (two same-seed
    store builds compared byte-for-byte) and ``feed_bitwise_equal``
    (store-fed observation arrays vs zip-fed, exact);
  * nondeterministic ``measured`` — feed wall time, points/s,
    ``feed_speedup_x`` vs the scenario's baseline, and the prefetch
    wait fraction (how much of the feed the consumer actually blocked).

The quick tier is the acceptance cell: store+prefetch batch
feed >= 2x the CSV-zip path on the heavy-tail workload, bitwise-equal
payloads, byte-identical rebuilds.

``device`` (a campaign-level argument) is where the ``consume='pipeline'``
cells run the fused segment pipeline: on the card it launches the
track_interp, agl_lookup and dynamic_rates kernels per bucket, and every
batch's planes come back to the host before the next one, so a timed
pass never ends with card work queued.  The feed-only cells do no device
work.

CLI::

    PYTHONPATH=src python -m repro_torch.bench.storage --quick --device cpu
"""

from __future__ import annotations

import atexit
import dataclasses
import glob
import json
import os
import sys
import tempfile
import time
import zipfile
from typing import Optional, Sequence

import numpy as np

from repro_torch.bench.engine import environment
from repro_torch.bench.scenarios import Check
from repro_torch.bench.schema import (
    SCHEMA_VERSION, STORAGE_SCHEMA, validate_storage)
from repro_torch.kernels.ops import resolve_device

__all__ = ["StorageSpec", "StorageScenario", "storage_scenarios",
           "run_storage_scenario", "run_storage_campaign",
           "storage_summary_lines", "main"]


@dataclasses.dataclass(frozen=True)
class StorageSpec:
    """One storage-path configuration — JSON-able, hashable."""

    source: str = "store"               # zip | store
    phase: str = "warm"                 # cold | warm
    prefetch: int = 0                   # store only; decode-ahead depth
    consume: str = "feed"               # feed | pipeline
    workload: str = "heavy_tail"        # repro_torch.bench.kernels.WORKLOADS
    # Sized so the fixture spans several shards and a feed pass costs
    # tens of milliseconds — thread wakeups and timer noise must not
    # dominate the measured ratios the quick tier gates on.
    n_archives: int = 64
    segments_per_archive: int = 16
    compression: str = "zlib"           # store shard codec
    target_points: int = 4_096          # store shard sizing
    repeats: int = 3
    seed: int = 0

    def __post_init__(self) -> None:
        from repro_torch.bench.kernels import WORKLOADS
        if self.source not in ("zip", "store"):
            raise ValueError(f"unknown source {self.source!r}")
        if self.phase not in ("cold", "warm"):
            raise ValueError(f"unknown phase {self.phase!r}")
        if self.consume not in ("feed", "pipeline"):
            raise ValueError(f"unknown consume {self.consume!r}")
        if self.workload not in WORKLOADS:
            raise ValueError(f"unknown workload {self.workload!r}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def fixture_key(self) -> tuple:
        return (self.workload, self.n_archives, self.segments_per_archive,
                self.compression, self.target_points, self.seed)


@dataclasses.dataclass(frozen=True)
class StorageScenario:
    """One named storage-bench cell."""

    name: str
    group: str
    run: StorageSpec
    baseline: Optional[StorageSpec] = None
    checks: tuple[Check, ...] = ()
    tier: str = "full"
    notes: str = ""

    def matches(self, patterns: Sequence[str]) -> bool:
        if not patterns:
            return True
        return any(p in self.name or p in self.group for p in patterns)


# ---------------------------------------------------------------------------
# Fixtures: synthetic archives as a zip tree + a store built from it.
# ---------------------------------------------------------------------------

_FIXTURES: dict[tuple, dict] = {}


@atexit.register
def _cleanup_fixtures() -> None:
    """Fixture trees live under the temporary directory for the process
    (cache); not beyond."""
    import shutil
    for fx in _FIXTURES.values():
        shutil.rmtree(fx["root"], ignore_errors=True)
    _FIXTURES.clear()


def _write_fixture(spec: StorageSpec) -> dict:
    """Synth archives -> CSVs -> zip tree -> store (built twice)."""
    from repro_torch.bench.kernels import KernelSpec, synth_items
    from repro_torch.store import build_store

    items = synth_items(KernelSpec(
        workload=spec.workload, n_archives=spec.n_archives,
        segments_per_archive=spec.segments_per_archive, seed=spec.seed))
    root = tempfile.mkdtemp(prefix="repro-storage-bench-")
    zip_root = os.path.join(root, "archived")
    os.makedirs(zip_root, exist_ok=True)
    n_segments = 0
    for a, (obs, segs) in enumerate(items):
        n_segments += len(segs)
        name = f"bench{a:02d}"
        lines = ["time,icao24,lat,lon,geoaltitude"]
        for i in range(len(obs["time"])):
            # repr of a Python float round-trips bitwise through the
            # CSV parse — the store-vs-zip equality gate needs that.
            lines.append(f"{float(obs['time'][i])!r},{obs['icao24'][i]},"
                         f"{float(obs['lat'][i])!r},"
                         f"{float(obs['lon'][i])!r},"
                         f"{float(obs['alt'][i])!r}")
        csv_path = os.path.join(root, f"{name}.csv")
        with open(csv_path, "w") as f:
            f.write("\n".join(lines) + "\n")
        with zipfile.ZipFile(os.path.join(zip_root, f"{name}.zip"), "w",
                             zipfile.ZIP_STORED) as zf:
            zf.write(csv_path, arcname=f"{name}.csv")
        os.remove(csv_path)

    store_root = os.path.join(root, "store")
    manifest = build_store(zip_root, store_root,
                           compression=spec.compression,
                           target_points=spec.target_points)
    rebuild_root = os.path.join(root, "store-rebuild")
    manifest2 = build_store(zip_root, rebuild_root,
                            compression=spec.compression,
                            target_points=spec.target_points)
    identical = manifest.canonical_bytes() == manifest2.canonical_bytes()
    for s in manifest.shards:
        with open(os.path.join(store_root, s.filename), "rb") as f1, \
                open(os.path.join(rebuild_root, s.filename), "rb") as f2:
            identical = identical and f1.read() == f2.read()

    zip_paths = sorted(glob.glob(os.path.join(zip_root, "*.zip")))
    return {
        "root": root,
        "zip_root": zip_root,
        "zip_paths": zip_paths,
        "store_root": store_root,
        "n_tracks": len(manifest.tracks),
        "n_points": manifest.n_points,
        "n_segments": n_segments,
        "n_shards": len(manifest.shards),
        "zip_bytes": sum(os.path.getsize(p) for p in zip_paths),
        "store_bytes": (manifest.size_bytes
                        + os.path.getsize(os.path.join(
                            store_root, "store_manifest.json"))),
        "rebuild_identical": 1.0 if identical else 0.0,
    }


def _fixture(spec: StorageSpec) -> dict:
    key = spec.fixture_key()
    if key not in _FIXTURES:
        _FIXTURES[key] = _write_fixture(spec)
    return _FIXTURES[key]


# ---------------------------------------------------------------------------
# Execution.
# ---------------------------------------------------------------------------

def _feed_zip(fx: dict, cold: bool) -> list[tuple[str, dict, list]]:
    """The §III.A path: unzip + re-parse CSV text, per archive."""
    from repro_torch.tracks.segments import read_observations, split_segments

    paths = (sorted(glob.glob(os.path.join(fx["zip_root"], "*.zip")))
             if cold else fx["zip_paths"])
    out = []
    for p in paths:
        obs = read_observations(p)
        segs = split_segments(obs["time"]) if obs else []
        out.append((os.path.basename(p), obs, segs))
    return out


def _consumer(spec: StorageSpec, device):
    """feed: no per-batch work.  pipeline: run the fused device path on
    each fed batch (what hides behind the prefetcher in production), on
    ``device``."""
    if spec.consume == "feed":
        return None
    from repro_torch.geometry.aerodromes import synthetic_aerodromes
    from repro_torch.tracks.segments import SegmentProcessor
    return SegmentProcessor(aerodromes=synthetic_aerodromes(n=16),
                            device=device)


def _one_pass(spec: StorageSpec, fx: dict, store, proc) -> dict:
    """One full feed (optionally + pipeline) pass; returns fed items."""
    from repro_torch.store.reader import TrackStore

    if spec.source == "zip":
        fed = _feed_zip(fx, cold=spec.phase == "cold")
        if proc is not None:
            for _tid, obs, segs in fed:
                if segs:
                    proc._process_many([(obs, segs)])
        return {"fed": fed}
    st = (TrackStore(fx["store_root"]) if spec.phase == "cold" else store)
    fed = []
    wait0 = st.stats["wait_s"]
    for batch in st.iter_batches(prefetch=spec.prefetch):
        for tid, (obs, segs) in zip(batch.track_ids, batch.items):
            fed.append((tid, obs, segs))
        if proc is not None:
            work = [it for it in batch.items if it[1]]
            if work:
                proc._process_many(work)
    return {"fed": fed, "wait_s": st.stats["wait_s"] - wait0}


def _execute(spec: StorageSpec, device) -> dict:
    from repro_torch.store.reader import TrackStore

    fx = _fixture(spec)
    store = (TrackStore(fx["store_root"]) if spec.source == "store"
             else None)
    proc = _consumer(spec, device)
    # Warm-up pass: page cache, the kernel library and every bucket shape
    # (pipeline consume on the card), lazy
    # imports — cold scenarios deliberately measure a fresh TrackStore
    # per pass but still after this process-level warm-up, so "cold"
    # isolates index-open + first-decode cost, not import cost.
    result = _one_pass(spec, fx, store, proc)
    t0 = time.perf_counter()
    waits = 0.0
    for _ in range(spec.repeats):
        result = _one_pass(spec, fx, store, proc)
        waits += result.get("wait_s", 0.0)
    wall = (time.perf_counter() - t0) / spec.repeats
    fed = result["fed"]

    bytes_on_disk = (fx["store_bytes"] if spec.source == "store"
                     else fx["zip_bytes"])
    metrics = {
        "n_tracks": fx["n_tracks"],
        "n_points": fx["n_points"],
        "n_segments": fx["n_segments"],
        "n_shards": fx["n_shards"] if spec.source == "store" else 0,
        "bytes_on_disk": bytes_on_disk,
        "bytes_per_point": (bytes_on_disk / fx["n_points"]
                            if fx["n_points"] else 0.0),
    }
    if spec.source == "store":
        metrics["rebuild_identical"] = fx["rebuild_identical"]
    measured = {
        "feed_s_per_pass": wall,
        "points_per_s": fx["n_points"] / wall if wall else 0.0,
        "tracks_per_s": fx["n_tracks"] / wall if wall else 0.0,
    }
    if spec.source == "store":
        measured["prefetch_wait_frac"] = (
            (waits / spec.repeats) / wall if wall else 0.0)
    return {"fed": fed, "metrics": metrics, "measured": measured}


def _feed_equal(run_fed, base_fed) -> float:
    """Exact equality of fed observation arrays across the two paths.

    Track ids differ in spelling (``bench00.zip`` vs the store's
    root-relative id), so alignment is by sorted basename stem."""
    def by_stem(fed):
        out = {}
        for tid, obs, segs in fed:
            stem = os.path.basename(str(tid)).split(".")[0]
            out[stem] = (obs, segs)
        return out

    a, b = by_stem(run_fed), by_stem(base_fed)
    if set(a) != set(b):
        return 0.0
    for stem in a:
        (obs_a, segs_a), (obs_b, segs_b) = a[stem], b[stem]
        if segs_a != segs_b:
            return 0.0
        for col in ("time", "lat", "lon", "alt"):
            if not np.array_equal(np.asarray(obs_a[col]),
                                  np.asarray(obs_b[col])):
                return 0.0
        if [str(x) for x in obs_a["icao24"]] != \
                [str(x) for x in obs_b["icao24"]]:
            return 0.0
    return 1.0


def run_storage_scenario(sc: StorageScenario, *, device=None) -> dict:
    """Execute one scenario (plus baseline) into a BENCH record, its
    pipeline cells on ``device`` (``None``: the card)."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    spec_doc = {"run": sc.run.to_dict(),
                "baseline": sc.baseline.to_dict() if sc.baseline else None}
    try:
        run = _execute(sc.run, device)
        base = _execute(sc.baseline, device) if sc.baseline else None
    except Exception as e:                 # keep the campaign going
        return {"name": sc.name, "group": sc.group, "tier": sc.tier,
                "status": "error", "spec": spec_doc,
                "metrics": {}, "measured": {}, "checks": [],
                "timing": {"wall_s": time.perf_counter() - t0},
                "error": f"{type(e).__name__}: {e}"}

    metrics = dict(run["metrics"])
    measured = dict(run["measured"])
    if base is not None:
        metrics["baseline_bytes_on_disk"] = \
            base["metrics"]["bytes_on_disk"]
        metrics["bytes_vs_baseline"] = (
            metrics["bytes_on_disk"]
            / max(base["metrics"]["bytes_on_disk"], 1))
        metrics["feed_bitwise_equal"] = _feed_equal(run["fed"],
                                                    base["fed"])
        bw = base["measured"]["feed_s_per_pass"]
        rw = measured["feed_s_per_pass"]
        measured["baseline_feed_s_per_pass"] = bw
        measured["feed_speedup_x"] = bw / rw if rw else float("inf")

    merged = {**measured, **metrics}
    checks = [c.evaluate(merged) for c in sc.checks]
    status = ("ran" if not checks
              else "pass" if all(c["passed"] for c in checks) else "fail")
    return {"name": sc.name, "group": sc.group, "tier": sc.tier,
            "status": status, "spec": spec_doc,
            "metrics": metrics, "measured": measured, "checks": checks,
            "timing": {"wall_s": time.perf_counter() - t0}, "error": None}


# ---------------------------------------------------------------------------
# The declared matrix.
# ---------------------------------------------------------------------------

def storage_scenarios() -> list[StorageScenario]:
    """cold/warm x sync/prefetch x zip/store, heavy-tail workload.

    The quick tier is the acceptance cell: warm store feed with
    prefetch vs the warm CSV-zip path — >= 2x throughput, bitwise-equal
    observation payloads, byte-identical same-seed store rebuilds."""
    acceptance = (
        Check("feed_speedup_x", "min", 2.0,
              source="store+prefetch batch feed vs CSV-zip"),
        Check("feed_bitwise_equal", "min", 1.0,
              source="store feed == zip feed, bitwise"),
        Check("rebuild_identical", "min", 1.0,
              source="same-seed builds byte-identical"),
    )
    equivalence = (
        Check("feed_bitwise_equal", "min", 1.0,
              source="store feed == zip feed, bitwise"),
    )
    store_warm = StorageSpec(source="store", phase="warm", prefetch=1)
    zip_warm = StorageSpec(source="zip", phase="warm")
    out = [
        StorageScenario(
            name="storage_feed_heavy_tail_store_prefetch",
            group="storage_feed", run=store_warm, baseline=zip_warm,
            checks=acceptance, tier="quick",
            notes="acceptance cell"),
        StorageScenario(
            name="storage_feed_store_sync",
            group="storage_feed",
            run=dataclasses.replace(store_warm, prefetch=0),
            baseline=zip_warm, checks=equivalence),
        StorageScenario(
            name="storage_feed_cold_store_vs_zip",
            group="storage_cold",
            run=dataclasses.replace(store_warm, phase="cold"),
            baseline=dataclasses.replace(zip_warm, phase="cold"),
            checks=equivalence),
        # Prefetch overlap: decode of shard N+1 hides behind the fused
        # pipeline on shard N.  Report-only (wall-clock ratio of two
        # live runs is too machine-dependent to gate); smaller fixture
        # because each pass runs real device compute.
        StorageScenario(
            name="storage_pipeline_prefetch_overlap",
            group="storage_overlap",
            run=dataclasses.replace(store_warm, consume="pipeline",
                                    prefetch=2, n_archives=16,
                                    segments_per_archive=6,
                                    target_points=2_048, repeats=2),
            baseline=dataclasses.replace(store_warm, consume="pipeline",
                                         prefetch=0, n_archives=16,
                                         segments_per_archive=6,
                                         target_points=2_048, repeats=2)),
        StorageScenario(
            name="storage_store_uncompressed",
            group="storage_format",
            run=dataclasses.replace(store_warm, compression="none"),
            baseline=zip_warm, checks=equivalence),
    ]
    return out


def run_storage_campaign(*, quick: bool = False,
                         filters: Sequence[str] = (),
                         seed: Optional[int] = None,
                         progress=None, device=None) -> dict:
    """Run the storage matrix into a schema-valid BENCH_storage doc, its
    pipeline cells on ``device`` (``None``: the card)."""
    device = resolve_device(device)
    selected = [sc for sc in storage_scenarios()
                if (not quick or sc.tier == "quick")
                and sc.matches(filters)]
    if not selected:
        raise ValueError("no storage scenarios match the quick/filter "
                         "selection")
    if seed is not None:
        selected = [dataclasses.replace(
            sc, run=dataclasses.replace(sc.run, seed=seed),
            baseline=(dataclasses.replace(sc.baseline, seed=seed)
                      if sc.baseline else None))
            for sc in selected]
    t0 = time.perf_counter()
    records = []
    for sc in selected:
        rec = run_storage_scenario(sc, device=device)
        records.append(rec)
        if progress is not None:
            progress(rec)
    counts = {s: 0 for s in ("pass", "fail", "ran", "error")}
    for rec in records:
        counts[rec["status"]] += 1
    doc = {
        "schema": STORAGE_SCHEMA,
        "schema_version": SCHEMA_VERSION,
        "created_at": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        "config": {"quick": quick, "filters": list(filters),
                   "seed": seed, "n_selected": len(selected)},
        "environment": environment(device),
        "scenarios": records,
        "summary": {"total": len(records), **counts,
                    "checked": sum(1 for r in records if r["checks"])},
        "timing": {"wall_s": time.perf_counter() - t0},
    }
    problems = validate_storage(doc)
    if problems:      # a bug in this module, not in the scenarios
        raise RuntimeError("storage bench produced a schema-invalid "
                           "artifact: " + "; ".join(problems[:5]))
    return doc


def storage_summary_lines(doc: dict) -> list[str]:
    """Human-readable summary for the CLI."""
    s = doc["summary"]
    lines = [f"{s['total']} storage scenarios: {s['pass']} pass, "
             f"{s['fail']} fail, {s['ran']} ran, {s['error']} error "
             f"[{doc['timing']['wall_s']:.1f}s]"]
    for rec in doc["scenarios"]:
        if rec["status"] == "error":
            lines.append(f"  ERROR {rec['name']}: {rec['error']}")
            continue
        m = {**rec["measured"], **rec["metrics"]}
        bits = [f"points/s={m['points_per_s']:.0f}"]
        if "feed_speedup_x" in m:
            bits.append(f"speedup={m['feed_speedup_x']:.2f}x")
        bits.append(f"bytes/pt={m['bytes_per_point']:.1f}")
        if "prefetch_wait_frac" in m:
            bits.append(f"wait={m['prefetch_wait_frac']:.0%}")
        if "feed_bitwise_equal" in m:
            bits.append(f"bitwise={'OK' if m['feed_bitwise_equal'] else 'DIFF'}")
        lines.append(f"  {rec['status']:5s} {rec['name']}: "
                     + " ".join(bits))
        for c in rec["checks"]:
            if not c["passed"]:
                lines.append(f"        FAIL {c['metric']}="
                             f"{c['actual']} vs {c['kind']} {c['expect']}")
    return lines


def main(argv=None) -> int:
    """CLI: ``python -m repro_torch.bench.storage [--quick] [--out PATH]``."""
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.bench.storage",
        description="Benchmark the columnar track store against the "
                    "CSV-zip path; write BENCH_storage.json.")
    ap.add_argument("--quick", action="store_true",
                    help="run only the quick tier (the CI acceptance "
                         "cell)")
    ap.add_argument("--filter", action="append", default=[],
                    metavar="SUBSTR")
    ap.add_argument("--out", default="BENCH_storage.json",
                    help="artifact path ('-' for stdout only)")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--device", default=None,
                    help="where the pipeline cells run (default: the "
                         "card; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    if args.list:
        for sc in storage_scenarios():
            if sc.matches(args.filter) and (not args.quick
                                            or sc.tier == "quick"):
                print(f"{sc.tier:5s} {sc.group:20s} {sc.name} "
                      f"[{len(sc.checks)} checks]")
        return 0

    if not any(sc.matches(args.filter) and (not args.quick
                                            or sc.tier == "quick")
               for sc in storage_scenarios()):
        print("no storage scenarios match", file=sys.stderr)
        return 1

    def progress(rec):
        print(f"  {rec['status']:5s} {rec['name']} "
              f"({rec['timing']['wall_s']:.2f}s)", flush=True)

    doc = run_storage_campaign(quick=args.quick, filters=args.filter,
                               seed=args.seed, progress=progress,
                               device=args.device)
    if args.out != "-":
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"wrote {args.out}")
    for line in storage_summary_lines(doc):
        print(line)
    return 1 if (doc["summary"]["fail"] or doc["summary"]["error"]) else 0


if __name__ == "__main__":
    sys.exit(main())
