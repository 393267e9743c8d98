"""Observability benchmark matrix: tracing cost, determinism, attribution.

The tracing layer (:mod:`repro_torch.obs`) only earns its keep if it is (a)
cheap enough to leave on, (b) byte-reproducible where the runtime is,
and (c) actually able to find the slow worker.  This module gates all
three as BENCH cells (``BENCH_obs.json``, schema ``repro.bench.obs/v1``):

  * ``overhead`` cells — the heavy-tail sim at fleet scale run traced
    and untraced, interleaved, min-of-N wall-clocks.  The quick tier
    gates ``overhead_ratio <= 1.05`` (the ≤5 % tracing budget) *and*
    ``makespan_identical == 1``: the traced run's virtual makespan and
    dispatch digest must equal the untraced run's, i.e. tracing
    observes the schedule without perturbing a single decision.
  * ``determinism`` cells — the same traced sim run twice;
    ``canonical_bytes`` of the two ``repro.obs/v1`` summaries must be
    byte-identical (``summary_identical == 1``).  This cell is also
    the workload of :func:`reference_run` and of the CLI's
    ``--summary-out`` / ``--trace-out`` flags (the reference package
    commits its summary as ``benchmarks/refs/TRACE_heavy_tail_quick.json``;
    the port commits none and is held against a fresh reference run).
  * ``straggler`` cells — heavy tail under ``stragglers_10pct``
    (10 % of workers at 0.25× speed): the summary's per-worker
    ``speed_est`` ranking must place a genuinely-slowed worker at the
    bottom (``straggler_rank_correct == 1``) — the attribution the
    ROADMAP's speculation work will consume.

Every cell reports the traced run's deterministic virtual makespan
(``makespan_seconds``, the bench compare's gating metric) and
``n_events``.
Wall-clock ratios live under ``measured`` (they measure the machine),
but the overhead gate is intentionally a measured check: both sides run
interleaved in the same process on the same machine, so the *ratio* is
meaningful where the absolute times are not.

CLI::

    PYTHONPATH=src python -m repro_torch.bench.obs --quick
    PYTHONPATH=src python -m repro_torch.bench.obs \\
        --quick --trace-out trace.json --summary-out TRACE_summary.json
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from typing import Optional, Sequence

from repro_torch.bench.scenarios import FAULT_PROFILES, Check
from repro_torch.bench.schema import (
    OBS_BENCH_SCHEMA, SCHEMA_VERSION, canonical_bytes, validate_obs)
from repro_torch.obs import Tracer, summary_from_tracer, to_chrome_trace
from repro_torch.runtime.policies import POLICY_NAMES

__all__ = ["ObsSpec", "ObsScenario", "REF_LABEL", "obs_scenarios",
           "run_obs_scenario", "run_obs_campaign", "reference_run",
           "obs_summary_lines", "main"]

#: Label of the reference trace summary (fixed so the committed ref and
#: a fresh ``--summary-out`` run produce the same scenario name for
#: a bench compare to match rows on).
REF_LABEL = "heavy_tail_quick"


@dataclasses.dataclass(frozen=True)
class ObsSpec:
    """One observability-bench configuration — JSON-able, hashable."""

    kind: str = "overhead"          # overhead | determinism | straggler
    dataset: str = "heavy_tail"
    phase: str = "process"          # cost-model name
    backend: str = "sim"
    n_workers: int = 64
    organization: str = "chronological"
    tasks_per_message: int = 1
    policy: str = "fifo_selfsched"
    fault_profile: str = "deaths_20pct"
    dataset_limit: Optional[int] = 12_000
    repeats: int = 3                # wall-clock repeats (overhead cells)
    seed: int = 0

    def __post_init__(self) -> None:
        if self.kind not in ("overhead", "determinism", "straggler"):
            raise ValueError(f"unknown cell kind {self.kind!r}")
        if self.backend != "sim":
            raise ValueError("obs cells gate on the deterministic sim "
                             "backend")
        if self.policy not in POLICY_NAMES:
            raise ValueError(f"unknown policy {self.policy!r}")
        if self.fault_profile not in FAULT_PROFILES:
            raise ValueError(
                f"unknown fault profile {self.fault_profile!r}")
        if self.repeats < 1:
            raise ValueError("repeats must be >= 1")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class ObsScenario:
    """One named observability-bench cell."""

    name: str
    group: str
    run: ObsSpec
    checks: tuple = ()
    tier: str = "full"
    notes: str = ""

    def matches(self, filters: Sequence[str]) -> bool:
        return (not filters
                or any(f in self.name or f in self.group for f in filters))


# ---------------------------------------------------------------------------
# Cell executors.
# ---------------------------------------------------------------------------

def _run_once(spec: ObsSpec, tracer: Optional[Tracer]):
    """One sim run of the spec's workload, optionally traced."""
    from repro_torch.core.cost_model import PHASES
    from repro_torch.runtime import run_job
    from repro_torch.tracks.datasets import get_manifest

    tasks = get_manifest(spec.dataset, limit=spec.dataset_limit)
    model = PHASES[spec.phase]
    worker_death, worker_speed, _, _ = FAULT_PROFILES[
        spec.fault_profile].materialize(spec.n_workers, spec.seed)
    return run_job(
        tasks, None, backend="sim", n_workers=spec.n_workers,
        organization=spec.organization,
        tasks_per_message=spec.tasks_per_message, policy=spec.policy,
        cost_model=model, worker_death=worker_death,
        worker_speed=worker_speed, organize_seed=spec.seed,
        raise_on_failure=False, tracer=tracer)


def _execute_overhead(spec: ObsSpec) -> dict:
    """Traced vs untraced, interleaved, min-of-``repeats`` wall-clocks.

    Interleaving (plain, traced, plain, traced, ...) puts both sides
    under the same thermal/frequency regime; min-of-N is the standard
    noise floor for a deterministic workload.  The virtual results
    must be IDENTICAL — tracing is an observer, not a participant.
    """
    plain_walls: list[float] = []
    traced_walls: list[float] = []
    plain = traced = tracer = None
    for _ in range(spec.repeats):
        t0 = time.perf_counter()
        plain = _run_once(spec, None)
        plain_walls.append(time.perf_counter() - t0)
        tracer = Tracer()
        t0 = time.perf_counter()
        traced = _run_once(spec, tracer)
        traced_walls.append(time.perf_counter() - t0)
    identical = int(traced.job_seconds == plain.job_seconds
                    and traced.dispatch_digest == plain.dispatch_digest)
    metrics = {
        "makespan_seconds": traced.job_seconds,
        "n_events": len(tracer.events),
        "events_dropped": tracer.dropped,
        "makespan_identical": identical,
        "tasks_completed": len(traced.completed_ids),
        "messages_sent": traced.messages_sent,
        "dispatch_digest": traced.dispatch_digest,
    }
    measured = {
        "overhead_ratio": min(traced_walls) / min(plain_walls),
        "traced_wall_s": min(traced_walls),
        "untraced_wall_s": min(plain_walls),
    }
    return {"metrics": metrics, "measured": measured}


def _execute_determinism(spec: ObsSpec) -> dict:
    """Two fresh traced runs -> canonical summary bytes must agree."""
    tr1, tr2 = Tracer(), Tracer()
    res = _run_once(spec, tr1)
    _run_once(spec, tr2)
    b1 = canonical_bytes(summary_from_tracer(tr1, label=REF_LABEL))
    b2 = canonical_bytes(summary_from_tracer(tr2, label=REF_LABEL))
    metrics = {
        "makespan_seconds": res.job_seconds,
        "n_events": len(tr1.events),
        "events_dropped": tr1.dropped,
        "summary_identical": int(b1 == b2),
        "n_events_identical": int(len(tr1.events) == len(tr2.events)),
        "summary_bytes": len(b1),
        "tasks_completed": len(res.completed_ids),
    }
    return {"metrics": metrics, "measured": {}}


def _execute_straggler(spec: ObsSpec) -> dict:
    """Does the trace summary's speed ranking find the slowed workers?"""
    _, worker_speed, _, _ = FAULT_PROFILES[spec.fault_profile].materialize(
        spec.n_workers, spec.seed)
    if not worker_speed:
        raise ValueError("straggler cells need a fault profile with "
                         "straggler_frac > 0")
    slow = {str(i) for i, s in enumerate(worker_speed) if s < 1.0}
    tracer = Tracer()
    res = _run_once(spec, tracer)
    summary = summary_from_tracer(tracer, label=spec.dataset,
                                  max_workers=spec.n_workers)
    workers = {w: d for w, d in summary["workers"].items()
               if isinstance(d, dict)}
    # speed_est ascending: the slowest-estimated workers first.
    ranked = sorted(workers, key=lambda w: (workers[w]["speed_est"], w))
    bottom = ranked[:len(slow)]
    metrics = {
        "makespan_seconds": res.job_seconds,
        "n_events": len(tracer.events),
        "events_dropped": tracer.dropped,
        "n_slow_workers": len(slow),
        "straggler_rank_correct": int(bool(ranked) and ranked[0] in slow),
        "bottom_k_hits": sum(1 for w in bottom if w in slow),
        "slowest_speed_est": (workers[ranked[0]]["speed_est"]
                              if ranked else 0.0),
        "straggler_count": summary["scenario"]["metrics"]
                                  ["straggler_count"],
        "tasks_completed": len(res.completed_ids),
    }
    return {"metrics": metrics, "measured": {}}


_EXECUTORS = {"overhead": _execute_overhead,
              "determinism": _execute_determinism,
              "straggler": _execute_straggler}


# ---------------------------------------------------------------------------
# Scenario matrix.
# ---------------------------------------------------------------------------

_BASE = ObsSpec()
#: The determinism cell's spec doubles as the reference-artifact spec
#: (``reference_run`` / ``--summary-out``): 64 workers keeps the whole
#: fleet inside the summary's default per-worker table.
_DETERMINISM_BASE = dataclasses.replace(_BASE, kind="determinism")


def obs_scenarios() -> list[ObsScenario]:
    """The full matrix (the quick tier is the acceptance set)."""
    return [
        ObsScenario(
            name="obs_overhead_heavy_tail_w1024",
            group="obs_overhead",
            run=dataclasses.replace(_BASE, kind="overhead",
                                    n_workers=1024),
            checks=(Check("overhead_ratio", "max", 1.05,
                          source="tracing enabled costs <= 5% "
                                 "makespan on the heavy_tail sim at "
                                 "1024 workers"),
                    Check("makespan_identical", "min", 1,
                          source="tracing observes the schedule without "
                                 "changing any dispatch decision"),),
            tier="quick", notes="overhead acceptance cell"),
        ObsScenario(
            name="obs_determinism_heavy_tail",
            group="obs_determinism",
            run=_DETERMINISM_BASE,
            checks=(Check("summary_identical", "min", 1,
                          source="sim trace summaries are "
                                 "byte-identical across same-seed "
                                 "reruns"),
                    Check("n_events_identical", "min", 1,
                          source="same-seed reruns emit the same event "
                                 "stream"),),
            tier="quick", notes="source of TRACE_heavy_tail_quick.json"),
        ObsScenario(
            name="obs_straggler_ranking",
            group="obs_straggler",
            run=dataclasses.replace(_BASE, kind="straggler",
                                    fault_profile="stragglers_10pct"),
            checks=(Check("straggler_rank_correct", "min", 1,
                          source="the 0.25x-speed workers rank "
                                 "slowest by measured speed_est"),
                    Check("straggler_count", "min", 1,
                          source="slowed workers produce straggler "
                                 "tasks (actual > 2x estimate)"),),
            tier="quick", notes="attribution acceptance cell"),
        # Full tier: the overhead curve at the base fleet size (no
        # gate — documents the small-fleet cost alongside the w1024
        # acceptance point).
        ObsScenario(
            name="obs_overhead_heavy_tail_w64",
            group="obs_overhead",
            run=dataclasses.replace(_BASE, kind="overhead"),
            tier="full", notes="small-fleet overhead curve point"),
    ]


def run_obs_scenario(sc: ObsScenario) -> dict:
    """Execute one scenario into a BENCH record."""
    t0 = time.perf_counter()
    spec_doc = {"run": sc.run.to_dict(), "baseline": None}
    try:
        out = _EXECUTORS[sc.run.kind](sc.run)
    except Exception as e:                 # keep the campaign going
        return {"name": sc.name, "group": sc.group, "tier": sc.tier,
                "status": "error", "spec": spec_doc,
                "metrics": {}, "measured": {}, "checks": [],
                "timing": {"wall_s": time.perf_counter() - t0},
                "error": f"{type(e).__name__}: {e}"}
    metrics, measured = out["metrics"], out["measured"]
    merged = {**measured, **metrics}
    checks = [c.evaluate(merged) for c in sc.checks]
    status = ("ran" if not checks
              else "pass" if all(c["passed"] for c in checks) else "fail")
    return {"name": sc.name, "group": sc.group, "tier": sc.tier,
            "status": status, "spec": spec_doc,
            "metrics": metrics, "measured": measured, "checks": checks,
            "timing": {"wall_s": time.perf_counter() - t0}, "error": None}


def run_obs_campaign(*, quick: bool = False, filters: Sequence[str] = (),
                     seed: Optional[int] = None, progress=None) -> dict:
    """Run the obs matrix into a schema-valid BENCH_obs doc."""
    selected = [sc for sc in obs_scenarios()
                if (not quick or sc.tier == "quick")
                and sc.matches(filters)]
    if not selected:
        raise ValueError("no obs scenarios match the quick/filter "
                         "selection")
    if seed is not None:
        selected = [dataclasses.replace(
            sc, run=dataclasses.replace(sc.run, seed=seed))
            for sc in selected]
    t0 = time.perf_counter()
    records = []
    for sc in selected:
        rec = run_obs_scenario(sc)
        records.append(rec)
        if progress is not None:
            progress(rec)
    counts = {s: 0 for s in ("pass", "fail", "ran", "error")}
    for rec in records:
        counts[rec["status"]] += 1
    doc = {
        "schema": OBS_BENCH_SCHEMA,
        "schema_version": SCHEMA_VERSION,
        "created_at": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        "config": {"quick": quick, "filters": list(filters),
                   "seed": seed, "n_selected": len(selected)},
        "environment": {"python": sys.version.split()[0],
                        "platform": sys.platform},
        "scenarios": records,
        "summary": {"total": len(records), **counts,
                    "checked": sum(1 for r in records if r["checks"])},
        "timing": {"wall_s": time.perf_counter() - t0},
    }
    problems = validate_obs(doc)
    if problems:      # a bug in this module, not in the scenarios
        raise RuntimeError("obs bench produced a schema-invalid "
                           "artifact: " + "; ".join(problems[:5]))
    return doc


def reference_run(seed: Optional[int] = None):
    """-> (tracer, summary doc) of the reference heavy-tail quick run.

    Exactly the determinism cell's workload and label, so
    ``canonical_bytes`` of the returned summary equals the reference
    package's ``reference_run`` at the same seed.
    """
    spec = (_DETERMINISM_BASE if seed is None
            else dataclasses.replace(_DETERMINISM_BASE, seed=seed))
    tracer = Tracer()
    _run_once(spec, tracer)
    return tracer, summary_from_tracer(tracer, label=REF_LABEL)


def obs_summary_lines(doc: dict) -> list[str]:
    """Human-readable summary for the CLI."""
    s = doc["summary"]
    lines = [f"{s['total']} obs scenarios: {s['pass']} pass, "
             f"{s['fail']} fail, {s['ran']} ran, {s['error']} error "
             f"[{doc['timing']['wall_s']:.1f}s]"]
    for rec in doc["scenarios"]:
        if rec["status"] == "error":
            lines.append(f"  ERROR {rec['name']}: {rec['error']}")
            continue
        m = {**rec["measured"], **rec["metrics"]}
        bits = [f"makespan={m['makespan_seconds']:.3g}s",
                f"events={m['n_events']:.0f}"]
        if "overhead_ratio" in m:
            bits.append(f"overhead={(m['overhead_ratio'] - 1) * 100:+.1f}%")
        if "summary_identical" in m:
            bits.append(f"identical={m['summary_identical']:.0f}")
        if "straggler_rank_correct" in m:
            bits.append(f"rank_ok={m['straggler_rank_correct']:.0f} "
                        f"bottom_k={m['bottom_k_hits']:.0f}"
                        f"/{m['n_slow_workers']:.0f}")
        lines.append(f"  {rec['status']:5s} {rec['name']}: "
                     + " ".join(bits))
        for c in rec["checks"]:
            if not c["passed"]:
                lines.append(f"        FAIL {c['metric']}="
                             f"{c['actual']} vs {c['kind']} {c['expect']}")
    return lines


def main(argv=None) -> int:
    """CLI: ``python -m repro_torch.bench.obs [--quick] [--out PATH]``."""
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.bench.obs",
        description="Benchmark the tracing layer (overhead, summary "
                    "determinism, straggler attribution); write "
                    "BENCH_obs.json.")
    ap.add_argument("--quick", action="store_true",
                    help="run only the quick tier (the CI acceptance "
                         "cells)")
    ap.add_argument("--filter", action="append", default=[],
                    metavar="SUBSTR")
    ap.add_argument("--out", default="BENCH_obs.json",
                    help="artifact path ('-' for stdout only)")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="also write the reference run's Perfetto "
                         "trace.json here")
    ap.add_argument("--summary-out", default=None, metavar="PATH",
                    help="also write the reference run's canonical "
                         "repro.obs/v1 summary here")
    args = ap.parse_args(argv)

    if args.list:
        for sc in obs_scenarios():
            if sc.matches(args.filter) and (not args.quick
                                            or sc.tier == "quick"):
                print(f"{sc.tier:5s} {sc.group:18s} {sc.name} "
                      f"[{len(sc.checks)} checks]")
        return 0

    def progress(rec):
        print(f"  {rec['status']:5s} {rec['name']} "
              f"({rec['timing']['wall_s']:.2f}s)", flush=True)

    try:
        doc = run_obs_campaign(quick=args.quick, filters=args.filter,
                               seed=args.seed, progress=progress)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if args.out != "-":
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"wrote {args.out}")
    if args.trace_out or args.summary_out:
        tracer, summary = reference_run(seed=args.seed)
        if args.trace_out:
            with open(args.trace_out, "w") as f:
                json.dump(to_chrome_trace(tracer.events, label=REF_LABEL),
                          f)
            print(f"wrote {args.trace_out}")
        if args.summary_out:
            with open(args.summary_out, "wb") as f:
                f.write(canonical_bytes(summary))
            print(f"wrote {args.summary_out}")
    for line in obs_summary_lines(doc):
        print(line)
    return 1 if (doc["summary"]["fail"] or doc["summary"]["error"]) else 0


if __name__ == "__main__":
    sys.exit(main())
