"""The BENCH artifact schema: validation + canonical serialization.

Three artifact kinds share the scenario-record shape:

  * ``BENCH_campaign.json`` (``repro.bench.campaign/v1``) — one record per
    scenario plus a campaign summary;
  * ``BENCH_smoke.json`` (``repro.bench.smoke/v1``) — a single record
    emitted by ``benchmarks/run.py --backend ...``;
  * ``BENCH_kernels.json`` (``repro.bench.kernels/v1``) — kernel-level
    records from ``benchmarks/kernel_bench.py``: fused vs unfused
    segment-pipeline throughput, padded-element fraction, intermediate
    host<->device transfer counts, and per-bucket compile cache hits.
    Kernel records use a different ``spec.run`` shape (workload x
    pipeline x backend instead of dataset x triple x backend) and their
    own required metrics.
  * ``BENCH_storage.json`` (``repro.bench.storage/v1``) — storage-layer
    records from ``benchmarks/storage_bench.py``: columnar-store vs
    CSV-zip batch-feed throughput, bytes per point, prefetch wait
    fraction, bitwise feed equality and rebuild determinism.  Storage
    records use a source x phase x prefetch x consume ``spec.run``
    shape.
  * ``BENCH_scheduling.json`` (``repro.bench.scheduling/v1``) —
    scheduling-policy records from ``benchmarks/scheduling_bench.py``:
    makespan + worker-busy quantiles per policy x dataset x
    fault-profile x backend, and prefetch-wait attribution for the
    store-backed shard-affinity cells.  Scheduling records use a
    policy x dataset x fault-profile x backend ``spec.run`` shape.
  * ``BENCH_serving.json`` (``repro.bench.serving/v1``) — continuous-
    ingest serving records from ``benchmarks/serving_bench.py``:
    snapshot byte-identity of the live-appended store vs a batch
    build, tiny-query p50/p99 latency idle vs under concurrent
    ingest, and maximum accepted-but-uncommitted ingest backlog.
    Serving records use a mode x feed-shape x shard-target
    ``spec.run`` shape.
  * ``BENCH_encounters.json`` (``repro.bench.encounters/v1``) —
    encounter-screening records from ``benchmarks/encounters_bench.py``:
    spatial-hash + fused-kernel candidate exactness vs the brute-force
    all-pairs reference, kernel speedup at aerodrome density, and
    scheduling-policy makespan on the genuinely quadratic per-cell
    cost skew.  Encounter records use a kind x dataset x backend x
    policy ``spec.run`` shape; the deterministic gating metric is
    ``screen_seconds_per_candidate`` (modeled screen cost per emitted
    candidate).

Scenario record layout::

    {
      "name": str, "group": str, "tier": str, "status": str,
      "spec":     {"run": {...RunSpec...}, "baseline": {...}|null},
      "metrics":  {...},   # deterministic for a fixed spec + seed
      "measured": {...},   # wall-clock measurements (live backends)
      "checks":   [{metric, kind, expect, tol, source, actual, passed}],
      "timing":   {"wall_s": float},
      "error":    str|null
    }

Determinism contract: for a fixed seed, ``canonical_bytes`` of two runs of
the same campaign are byte-identical.  Everything nondeterministic lives
under the ``NONDETERMINISTIC_KEYS`` (per record: ``measured``/``timing``;
per campaign: ``created_at``/``environment``/``timing``), which canonical
serialization drops.  The validator is hand-rolled (no jsonschema
dependency in the container).

The port keeps the schema names of the JAX reference package
(``repro.*/v1``): they name artifact formats, which the two packages
share, so an artifact of either validates and diffs the same way
(``python -m repro_torch.bench.compare``).  The ``benchmarks/*.py``
producers named above belong to the reference; the port writes the
campaign, kernels, storage, scheduling and encounters artifacts from
``python -m repro_torch.bench.{campaign,kernels,storage,scheduling,
encounters,serving}`` and the obs artifacts (:mod:`repro_torch.bench.obs`,
:func:`repro_torch.obs.write_trace_files`).  A port artifact's
``environment`` also names the device it ran on (and a card's name and
power limit), except the serving artifact's: host work, it records the
host (python, platform) as the reference does.
"""

from __future__ import annotations

import json
from typing import Any

__all__ = ["CAMPAIGN_SCHEMA", "SMOKE_SCHEMA", "KERNELS_SCHEMA",
           "STORAGE_SCHEMA", "SCHEDULING_SCHEMA", "SERVING_SCHEMA",
           "ENCOUNTERS_SCHEMA", "OBS_SUMMARY_SCHEMA", "OBS_BENCH_SCHEMA",
           "SCHEMA_VERSION",
           "NONDETERMINISTIC_RECORD_KEYS", "NONDETERMINISTIC_DOC_KEYS",
           "validate_record", "validate_campaign", "validate_smoke",
           "validate_kernels", "validate_storage", "validate_scheduling",
           "validate_serving", "validate_encounters", "validate_obs",
           "validate_obs_summary", "canonical_bytes"]

SCHEMA_VERSION = 1
CAMPAIGN_SCHEMA = "repro.bench.campaign/v1"
SMOKE_SCHEMA = "repro.bench.smoke/v1"
KERNELS_SCHEMA = "repro.bench.kernels/v1"
STORAGE_SCHEMA = "repro.bench.storage/v1"
SCHEDULING_SCHEMA = "repro.bench.scheduling/v1"
SERVING_SCHEMA = "repro.bench.serving/v1"
ENCOUNTERS_SCHEMA = "repro.bench.encounters/v1"
#: Canonical trace summary (``TRACE_summary.json``) emitted by
#: :mod:`repro_torch.obs.summary` — a single-scenario document shaped for
#: ``compare.py``'s smoke-doc path.
OBS_SUMMARY_SCHEMA = "repro.obs/v1"
#: Observability bench matrix (``BENCH_obs.json``) from
#: :mod:`repro_torch.bench.obs`: tracing overhead / determinism /
#: straggler-attribution cells.
OBS_BENCH_SCHEMA = "repro.bench.obs/v1"

NONDETERMINISTIC_RECORD_KEYS = ("measured", "timing")
NONDETERMINISTIC_DOC_KEYS = ("created_at", "environment", "timing")

_STATUSES = ("pass", "fail", "ran", "error")
_CHECK_KEYS = ("metric", "kind", "expect", "tol", "source", "actual",
               "passed")
_RECORD_KEYS = ("name", "group", "tier", "status", "spec", "metrics",
                "measured", "checks", "timing", "error")
_SPEC_REQUIRED = ("dataset", "phase", "backend", "mode", "n_workers",
                  "organization", "tasks_per_message", "fault_profile",
                  "seed")
_METRICS_REQUIRED = ("tasks_completed", "messages_sent")
# Kernel-bench records describe a synthetic workload, not a run_job spec.
_KERNEL_SPEC_REQUIRED = ("workload", "pipeline", "backend", "n_archives",
                         "seed")
_KERNEL_METRICS_REQUIRED = ("n_segments", "padded_fraction",
                            "intermediate_transfers")
# Storage-bench records describe a feed path, not a run_job spec.
_STORAGE_SPEC_REQUIRED = ("source", "phase", "prefetch", "consume",
                          "workload", "n_archives", "seed")
_STORAGE_METRICS_REQUIRED = ("n_tracks", "n_points", "bytes_on_disk")
# Scheduling-bench records describe a policy cell: policy x dataset x
# fault profile x backend.  makespan_seconds lives under ``metrics`` on
# the sim backend (deterministic) and ``measured`` on live backends;
# the validator merges both, so one requirement covers both kinds.
_SCHEDULING_SPEC_REQUIRED = ("policy", "dataset", "backend", "n_workers",
                             "organization", "tasks_per_message",
                             "fault_profile", "seed")
_SCHEDULING_METRICS_REQUIRED = ("tasks_completed", "messages_sent",
                                "makespan_seconds")
# Serving-bench records describe a continuous-ingest cell: mode x feed
# shape x shard target.  Latency quantiles live under ``measured``
# (wall-clock); the required metrics are the deterministic counters plus
# the byte-identity flag the acceptance gate reads.
_SERVING_SPEC_REQUIRED = ("mode", "n_files", "obs_per_file",
                          "feed_batch", "target_points", "tiny_queries",
                          "seed")
_SERVING_METRICS_REQUIRED = ("shards_committed", "points_ingested",
                             "snapshot_identical")
# Encounter-bench records describe either a live screen cell (spatial
# hash + fused kernel vs brute force) or a scheduling-policy sim cell
# over screen tasks.  The shared requirement is the deterministic cell
# count; the gating ``screen_seconds_per_candidate`` metric only exists
# on screen-kind records (compare.py skips records without it).
_ENCOUNTERS_SPEC_REQUIRED = ("kind", "dataset", "backend", "policy",
                             "n_workers", "fault_profile", "seed")
_ENCOUNTERS_METRICS_REQUIRED = ("cells",)
# Obs-bench records describe a tracing cell: kind (overhead /
# determinism / straggler attribution) x dataset x backend x fleet x
# fault profile.  Every cell reports the virtual makespan of its traced
# run (the deterministic gating metric).
_OBS_SPEC_REQUIRED = ("kind", "dataset", "backend", "n_workers",
                      "fault_profile", "seed")
_OBS_METRICS_REQUIRED = ("makespan_seconds", "n_events")
# Required headline metrics of a repro.obs/v1 trace summary (the
# ``scenario.metrics`` block compare.py diffs).
_OBS_SUMMARY_METRICS_REQUIRED = ("critical_path_s", "makespan_s",
                                 "straggler_count", "exec_p99_over_p50",
                                 "n_exec_spans")


def _num(x: Any) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool)


def validate_record(rec: Any, where: str = "record",
                    spec_required: tuple = _SPEC_REQUIRED,
                    required_metrics: tuple = _METRICS_REQUIRED
                    ) -> list[str]:
    """Structural validation of one scenario record; returns problems."""
    errs: list[str] = []
    if not isinstance(rec, dict):
        return [f"{where}: not an object"]
    for key in _RECORD_KEYS:
        if key not in rec:
            errs.append(f"{where}: missing key {key!r}")
    for key in ("name", "group", "tier"):
        if key in rec and not isinstance(rec[key], str):
            errs.append(f"{where}.{key}: not a string")
    if rec.get("status") not in _STATUSES:
        errs.append(f"{where}.status: {rec.get('status')!r} not in "
                    f"{_STATUSES}")
    spec = rec.get("spec")
    if not isinstance(spec, dict) or "run" not in spec:
        errs.append(f"{where}.spec: missing 'run' object")
    else:
        run = spec["run"]
        if not isinstance(run, dict):
            errs.append(f"{where}.spec.run: not an object")
        else:
            for key in spec_required:
                if key not in run:
                    errs.append(f"{where}.spec.run: missing key {key!r}")
        base = spec.get("baseline")
        if base is not None and not isinstance(base, dict):
            errs.append(f"{where}.spec.baseline: not an object or null")
    for key in ("metrics", "measured"):
        if key in rec and not isinstance(rec[key], dict):
            errs.append(f"{where}.{key}: not an object")
    if rec.get("status") in ("pass", "fail", "ran"):
        merged = {}
        for key in ("metrics", "measured"):
            if isinstance(rec.get(key), dict):
                merged.update(rec[key])
        for key in required_metrics:
            if not _num(merged.get(key)):
                errs.append(f"{where}: metric {key!r} missing/non-numeric")
    checks = rec.get("checks")
    if not isinstance(checks, list):
        errs.append(f"{where}.checks: not a list")
    else:
        for i, c in enumerate(checks):
            if not isinstance(c, dict):
                errs.append(f"{where}.checks[{i}]: not an object")
                continue
            for key in _CHECK_KEYS:
                if key not in c:
                    errs.append(f"{where}.checks[{i}]: missing {key!r}")
            if not isinstance(c.get("passed"), bool):
                errs.append(f"{where}.checks[{i}].passed: not a bool")
    timing = rec.get("timing")
    if not isinstance(timing, dict) or not _num(timing.get("wall_s")):
        errs.append(f"{where}.timing.wall_s: missing/non-numeric")
    if rec.get("status") == "error" and not isinstance(rec.get("error"), str):
        errs.append(f"{where}.error: status=error needs an error string")
    return errs


def validate_campaign(doc: Any) -> list[str]:
    """Structural validation of a whole campaign artifact."""
    errs: list[str] = []
    if not isinstance(doc, dict):
        return ["campaign: not an object"]
    if doc.get("schema") != CAMPAIGN_SCHEMA:
        errs.append(f"campaign.schema: {doc.get('schema')!r} != "
                    f"{CAMPAIGN_SCHEMA!r}")
    if doc.get("schema_version") != SCHEMA_VERSION:
        errs.append("campaign.schema_version: missing/mismatched")
    if not isinstance(doc.get("config"), dict):
        errs.append("campaign.config: not an object")
    scenarios = doc.get("scenarios")
    if not isinstance(scenarios, list) or not scenarios:
        errs.append("campaign.scenarios: missing/empty list")
        scenarios = []
    names = set()
    for i, rec in enumerate(scenarios):
        where = (f"scenarios[{i}]({rec.get('name', '?')})"
                 if isinstance(rec, dict) else f"scenarios[{i}]")
        errs.extend(validate_record(rec, where))
        if isinstance(rec, dict):
            if rec.get("name") in names:
                errs.append(f"{where}: duplicate scenario name")
            names.add(rec.get("name"))
    summary = doc.get("summary")
    if not isinstance(summary, dict):
        errs.append("campaign.summary: not an object")
    else:
        for key in ("total", "pass", "fail", "ran", "error"):
            if not isinstance(summary.get(key), int):
                errs.append(f"campaign.summary.{key}: missing/non-int")
        if isinstance(doc.get("scenarios"), list) and \
                summary.get("total") != len(doc["scenarios"]):
            errs.append("campaign.summary.total != len(scenarios)")
    return errs


def _validate_matrix_doc(doc: Any, *, label: str, schema: str,
                         spec_required: tuple,
                         required_metrics: tuple) -> list[str]:
    """Shared shape check for the scenario-matrix artifacts (kernels,
    storage): schema/version stamp, config, uniquely-named records with
    the matrix's own spec/metric requirements, and a summary."""
    errs: list[str] = []
    if not isinstance(doc, dict):
        return [f"{label}: not an object"]
    if doc.get("schema") != schema:
        errs.append(f"{label}.schema: {doc.get('schema')!r} != "
                    f"{schema!r}")
    if doc.get("schema_version") != SCHEMA_VERSION:
        errs.append(f"{label}.schema_version: missing/mismatched")
    if not isinstance(doc.get("config"), dict):
        errs.append(f"{label}.config: not an object")
    scenarios = doc.get("scenarios")
    if not isinstance(scenarios, list) or not scenarios:
        errs.append(f"{label}.scenarios: missing/empty list")
        scenarios = []
    names = set()
    for i, rec in enumerate(scenarios):
        where = (f"scenarios[{i}]({rec.get('name', '?')})"
                 if isinstance(rec, dict) else f"scenarios[{i}]")
        errs.extend(validate_record(
            rec, where, spec_required=spec_required,
            required_metrics=required_metrics))
        if isinstance(rec, dict):
            if rec.get("name") in names:
                errs.append(f"{where}: duplicate scenario name")
            names.add(rec.get("name"))
    summary = doc.get("summary")
    if not isinstance(summary, dict):
        errs.append(f"{label}.summary: not an object")
    else:
        for key in ("total", "pass", "fail", "ran", "error"):
            if not isinstance(summary.get(key), int):
                errs.append(f"{label}.summary.{key}: missing/non-int")
    return errs


def validate_kernels(doc: Any) -> list[str]:
    """Structural validation of a BENCH_kernels.json artifact."""
    return _validate_matrix_doc(
        doc, label="kernels", schema=KERNELS_SCHEMA,
        spec_required=_KERNEL_SPEC_REQUIRED,
        required_metrics=_KERNEL_METRICS_REQUIRED)


def validate_storage(doc: Any) -> list[str]:
    """Structural validation of a BENCH_storage.json artifact."""
    return _validate_matrix_doc(
        doc, label="storage", schema=STORAGE_SCHEMA,
        spec_required=_STORAGE_SPEC_REQUIRED,
        required_metrics=_STORAGE_METRICS_REQUIRED)


def validate_scheduling(doc: Any) -> list[str]:
    """Structural validation of a BENCH_scheduling.json artifact."""
    return _validate_matrix_doc(
        doc, label="scheduling", schema=SCHEDULING_SCHEMA,
        spec_required=_SCHEDULING_SPEC_REQUIRED,
        required_metrics=_SCHEDULING_METRICS_REQUIRED)


def validate_serving(doc: Any) -> list[str]:
    """Structural validation of a BENCH_serving.json artifact."""
    return _validate_matrix_doc(
        doc, label="serving", schema=SERVING_SCHEMA,
        spec_required=_SERVING_SPEC_REQUIRED,
        required_metrics=_SERVING_METRICS_REQUIRED)


def validate_encounters(doc: Any) -> list[str]:
    """Structural validation of a BENCH_encounters.json artifact."""
    return _validate_matrix_doc(
        doc, label="encounters", schema=ENCOUNTERS_SCHEMA,
        spec_required=_ENCOUNTERS_SPEC_REQUIRED,
        required_metrics=_ENCOUNTERS_METRICS_REQUIRED)


def validate_obs(doc: Any) -> list[str]:
    """Structural validation of a BENCH_obs.json artifact."""
    return _validate_matrix_doc(
        doc, label="obs", schema=OBS_BENCH_SCHEMA,
        spec_required=_OBS_SPEC_REQUIRED,
        required_metrics=_OBS_METRICS_REQUIRED)


def validate_obs_summary(doc: Any) -> list[str]:
    """Structural validation of a TRACE_summary.json (repro.obs/v1).

    A trace summary is not a bench record — it carries no spec/checks/
    timing — so it gets its own shape check: schema stamp, a
    single-``scenario`` metrics block (the compare.py contract), and
    the derived phase/worker/straggler/shard tables.
    """
    errs: list[str] = []
    if not isinstance(doc, dict):
        return ["obs_summary: not an object"]
    if doc.get("schema") != OBS_SUMMARY_SCHEMA:
        errs.append(f"obs_summary.schema: {doc.get('schema')!r} != "
                    f"{OBS_SUMMARY_SCHEMA!r}")
    if doc.get("schema_version") != SCHEMA_VERSION:
        errs.append("obs_summary.schema_version: missing/mismatched")
    if not isinstance(doc.get("config"), dict):
        errs.append("obs_summary.config: not an object")
    sc = doc.get("scenario")
    if not isinstance(sc, dict):
        errs.append("obs_summary.scenario: not an object")
    else:
        if not isinstance(sc.get("name"), str):
            errs.append("obs_summary.scenario.name: not a string")
        metrics = sc.get("metrics")
        if not isinstance(metrics, dict):
            errs.append("obs_summary.scenario.metrics: not an object")
        else:
            for key in _OBS_SUMMARY_METRICS_REQUIRED:
                if not _num(metrics.get(key)):
                    errs.append(f"obs_summary.scenario.metrics: "
                                f"{key!r} missing/non-numeric")
    for key in ("phases", "workers", "shards"):
        if not isinstance(doc.get(key), dict):
            errs.append(f"obs_summary.{key}: not an object")
    if not isinstance(doc.get("stragglers"), list):
        errs.append("obs_summary.stragglers: not a list")
    return errs


def validate_smoke(doc: Any) -> list[str]:
    """Structural validation of a BENCH_smoke.json artifact."""
    errs: list[str] = []
    if not isinstance(doc, dict):
        return ["smoke: not an object"]
    if doc.get("schema") != SMOKE_SCHEMA:
        errs.append(f"smoke.schema: {doc.get('schema')!r} != "
                    f"{SMOKE_SCHEMA!r}")
    if doc.get("schema_version") != SCHEMA_VERSION:
        errs.append("smoke.schema_version: missing/mismatched")
    errs.extend(validate_record(doc.get("scenario"), "smoke.scenario"))
    return errs


def canonical_bytes(doc: dict) -> bytes:
    """Deterministic serialization: drop nondeterministic keys, sort keys.

    Two campaigns over the same scenarios with the same seed must agree
    byte-for-byte here (the acceptance gate for reproducible BENCH
    artifacts); wall-clock fields are excluded by construction.
    """
    def strip_record(rec: dict) -> dict:
        return {k: v for k, v in rec.items()
                if k not in NONDETERMINISTIC_RECORD_KEYS}

    out: dict[str, Any] = {k: v for k, v in doc.items()
                           if k not in NONDETERMINISTIC_DOC_KEYS}
    if isinstance(out.get("scenarios"), list):
        out["scenarios"] = [strip_record(r) if isinstance(r, dict) else r
                            for r in out["scenarios"]]
    return json.dumps(out, sort_keys=True,
                      separators=(",", ":")).encode() + b"\n"
