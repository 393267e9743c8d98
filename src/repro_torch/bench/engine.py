"""Campaign engine: expand scenarios into runs, collect BENCH records.

Every scenario funnels through the unified runtime entry point
(:func:`repro_torch.runtime.run_job`) — full-scale sweeps on the ``sim``
backend, scaled smoke workloads on ``threads``/``processes`` — except
``mode='static'`` baselines, which use the discrete-event
``simulate_static`` (there is no live static distribution to run).

Record shape and the deterministic/measured split are documented in
:mod:`repro_torch.bench.schema`.  The split rule:

  * sim backend — the engine is a deterministic discrete-event machine,
    so *every* metric (including fault-injected runs) goes in ``metrics``;
  * live backend, fault-free — counts and the dispatch digest are decided
    by the shared SchedulerCore and stay deterministic; wall-clock times
    and busy-time quantiles go in ``measured``;
  * live backend with faults — re-queue accounting depends on real
    timing, so only the completion count stays in ``metrics``.

The campaign's scenarios run on the host (the sim, threads and
processes backends); ``device`` is the campaign-level argument every
bench entry point shares.  It is resolved like every port entry point's
(``None`` is the card and raises without one) and recorded in the
artifact's ``environment`` by :func:`environment`, which the kernel,
storage, encounter and scheduling benches use too.
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
import time
from typing import Optional, Sequence

from repro_torch.bench.scenarios import FAULT_PROFILES, RunSpec, Scenario
from repro_torch.bench.schema import (
    CAMPAIGN_SCHEMA, SCHEMA_VERSION, validate_campaign)
from repro_torch.core.cost_model import PHASES
from repro_torch.kernels.ops import resolve_device
from repro_torch.runtime import run_job
from repro_torch.runtime.api import default_topology
from repro_torch.runtime.result import RunResult
from repro_torch.tracks.datasets import get_manifest

__all__ = ["execute_spec", "run_scenario", "run_campaign", "csv_rows",
           "summary_lines", "environment"]

# Live smoke scenarios poll fast; the paper's 0.3 s default would dominate
# a 200-task smoke job.
LIVE_POLL_DEFAULT = 0.002

# Deterministic keys of RunResult.to_record() on a fault-free live run
# (all decided by the shared SchedulerCore, not by wall clocks).
_LIVE_DET_KEYS = ("backend", "tasks_completed", "n_results",
                  "messages_sent", "n_batches", "dispatch_digest",
                  "reassigned_tasks", "failed_workers", "n_task_failures",
                  "n_workers")
_LIVE_FAULT_DET_KEYS = ("backend", "tasks_completed", "n_task_failures")


def environment(device) -> dict:
    """An artifact's ``environment``: Python, platform and the device the
    campaign ran on; for a card also its name and power limit (as
    ``nvidia-smi`` reports it, ``None`` where it cannot be read).  The
    CPU case touches no CUDA state."""
    device = resolve_device(device)
    env = {"python": sys.version.split()[0], "platform": sys.platform,
           "device": str(device)}
    if device.type == "cuda":
        import torch
        index = device.index if device.index is not None else 0
        env["device_name"] = torch.cuda.get_device_name(index)
        try:
            env["power_limit"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=power.limit",
                 "--format=csv,noheader", f"--id={index}"],
                capture_output=True, text=True, timeout=30,
                check=True).stdout.strip()
        except (OSError, subprocess.SubprocessError):
            env["power_limit"] = None
    return env


def _smoke_fn(task):
    """Per-task worker fn for live smoke scenarios (picklable)."""
    return task.size_bytes


def execute_spec(spec: RunSpec, *,
                 tracer=None) -> tuple[RunResult, int]:
    """Run one RunSpec; returns (result, n_tasks).

    ``tracer`` attaches a :class:`repro_torch.obs.Tracer` to the run (ignored
    by ``mode='static'`` baselines — there is no per-task dispatch to
    trace in a static distribution)."""
    tasks = get_manifest(spec.dataset, limit=spec.dataset_limit)
    model = PHASES[spec.phase]
    if spec.cpu_rate_scale != 1.0:
        model = dataclasses.replace(
            model, cpu_rate=model.cpu_rate * spec.cpu_rate_scale)
    profile = FAULT_PROFILES[spec.fault_profile]
    (worker_death, worker_speed, worker_fail_after,
     worker_slow_factor) = profile.materialize(spec.n_workers, spec.seed)

    if spec.mode == "static":
        from repro_torch.runtime.sim import simulate_static
        default_nodes, default_nppn = default_topology(spec.n_workers)
        result = simulate_static(
            tasks, n_workers=spec.n_workers,
            nodes=spec.nodes if spec.nodes is not None else default_nodes,
            nppn=spec.nppn if spec.nppn is not None else default_nppn,
            model=model, policy=spec.policy,
            organization=spec.organization,
            **({"poll_interval": spec.poll_interval}
               if spec.poll_interval is not None else {}),
            worker_death=worker_death,
            **({"failure_timeout": spec.failure_timeout}
               if spec.failure_timeout is not None else {}),
            legacy_launch_penalty=spec.legacy_launch_penalty,
            worker_speed=worker_speed)
        return result, len(tasks)

    kwargs: dict = {}
    if spec.backend == "sim":
        kwargs.update(cost_model=model, worker_death=worker_death,
                      worker_speed=worker_speed,
                      legacy_launch_penalty=spec.legacy_launch_penalty)
        fn = None
        poll = (spec.poll_interval if spec.poll_interval is not None
                else None)
    else:
        kwargs.update(worker_fail_after=worker_fail_after,
                      worker_slow_factor=worker_slow_factor)
        fn = _smoke_fn
        poll = (spec.poll_interval if spec.poll_interval is not None
                else LIVE_POLL_DEFAULT)
    # Speculation / speed feedback / elastic fleets are policy concerns
    # shared by every backend (run_job validates elastic's backend
    # restrictions at declaration level via RunSpec.__post_init__).
    kwargs.update(speculative=spec.speculative,
                  speculation_max_copies=spec.speculation_max_copies,
                  speed_feedback=spec.speed_feedback,
                  elastic=spec.elastic)
    if poll is not None:
        kwargs["poll_interval"] = poll
    if spec.failure_timeout is not None:
        kwargs["failure_timeout"] = spec.failure_timeout
    result = run_job(
        tasks, fn, backend=spec.backend, n_workers=spec.n_workers,
        nodes=spec.nodes, nppn=spec.nppn,
        organization=spec.organization,
        tasks_per_message=spec.tasks_per_message,
        policy=spec.sched_policy,
        organize_seed=spec.seed, raise_on_failure=False,
        tracer=tracer, **kwargs)
    return result, len(tasks)


def _sim_derived(rec: dict) -> dict:
    """Headline figures the paper reports in hours."""
    return {
        "median_busy_hours": rec["median_worker_busy_s"] / 3600.0,
        "max_busy_hours":
            rec["worker_busy_quantiles_s"]["p100"] / 3600.0,
        "span_hours": rec["worker_time_span_s"] / 3600.0,
    }


def _baseline_derived(rec: dict, base: dict) -> dict:
    out = {"baseline_job_seconds": base["job_seconds"]}
    if base["job_seconds"] > 0:
        out["job_seconds_reduction_pct"] = \
            (1.0 - rec["job_seconds"] / base["job_seconds"]) * 100.0
        out["speedup_x"] = base["job_seconds"] / rec["job_seconds"] \
            if rec["job_seconds"] > 0 else float("inf")
    if base["median_worker_busy_s"] > 0:
        out["median_busy_delta_pct"] = \
            (rec["median_worker_busy_s"] / base["median_worker_busy_s"]
             - 1.0) * 100.0
    return out


def run_scenario(sc: Scenario, *, trace: bool = False,
                 device=None) -> dict:
    """Execute one scenario (plus baseline) into a BENCH record.

    ``trace=True`` runs the scenario (not its baseline) with a
    :class:`repro_torch.obs.Tracer` attached and adds an ``obs`` key to the
    record — the trace-summary headline metrics (critical path,
    straggler count, exec-time tails).  Default runs carry no ``obs``
    key, so existing artifacts stay byte-identical.  ``device`` is only
    resolved: the campaign's runs are host work."""
    resolve_device(device)
    t0 = time.perf_counter()
    spec_doc = {"run": sc.run.to_dict(),
                "baseline": sc.baseline.to_dict() if sc.baseline else None}
    base_rec: Optional[dict] = None
    tracer = None
    if trace:
        from repro_torch.obs import Tracer
        tracer = Tracer()
    try:
        result, n_tasks = execute_spec(sc.run, tracer=tracer)
        if sc.baseline is not None:
            base_result, _ = execute_spec(sc.baseline)
            base_rec = base_result.to_record()
    except Exception as e:                 # keep the campaign going
        return {"name": sc.name, "group": sc.group, "tier": sc.tier,
                "status": "error", "spec": spec_doc,
                "metrics": {}, "measured": {}, "checks": [],
                "timing": {"wall_s": time.perf_counter() - t0},
                "error": f"{type(e).__name__}: {e}"}
    wall_s = time.perf_counter() - t0

    rec = result.to_record()
    rec["n_tasks"] = n_tasks
    if sc.run.backend == "sim":
        rec.update(_sim_derived(rec))
        if base_rec is not None:
            rec.update(_baseline_derived(rec, base_rec))
        metrics, measured = rec, {}
    else:
        det_keys = (_LIVE_DET_KEYS if FAULT_PROFILES[
            sc.run.fault_profile].is_none else _LIVE_FAULT_DET_KEYS)
        metrics = {k: rec[k] for k in det_keys}
        metrics["n_tasks"] = n_tasks
        measured = {k: v for k, v in rec.items()
                    if k not in metrics}
        if base_rec is not None:
            measured.update(_baseline_derived(rec, base_rec))

    merged = {**measured, **metrics}
    checks = [c.evaluate(merged) for c in sc.checks]
    if not checks:
        status = "ran"
    else:
        status = "pass" if all(c["passed"] for c in checks) else "fail"
    out = {"name": sc.name, "group": sc.group, "tier": sc.tier,
           "status": status, "spec": spec_doc,
           "metrics": metrics, "measured": measured, "checks": checks,
           "timing": {"wall_s": wall_s}, "error": None}
    if tracer is not None:
        from repro_torch.obs import summary_from_tracer
        obs = summary_from_tracer(tracer, label=sc.name)
        out["obs"] = {"metrics": obs["scenario"]["metrics"],
                      "dropped": tracer.dropped}
    return out


def run_campaign(scenarios: Sequence[Scenario], *, quick: bool = False,
                 filters: Sequence[str] = (), seed: Optional[int] = None,
                 progress=None, device=None) -> dict:
    """Run a scenario set into a schema-valid campaign artifact (dict).

    ``quick`` keeps only tier='quick' scenarios; ``filters`` are OR'd
    substring matches on scenario name/group; ``seed`` overrides every
    spec's organize/fault seed (the campaign-level reproducibility knob);
    ``device`` is recorded in ``environment``.
    """
    device = resolve_device(device)
    selected = [sc for sc in scenarios
                if (not quick or sc.tier == "quick") and sc.matches(filters)]
    if seed is not None:
        selected = [dataclasses.replace(
            sc, run=dataclasses.replace(sc.run, seed=seed),
            baseline=(dataclasses.replace(sc.baseline, seed=seed)
                      if sc.baseline else None))
            for sc in selected]
    t0 = time.perf_counter()
    records = []
    for sc in selected:
        rec = run_scenario(sc, device=device)
        records.append(rec)
        if progress is not None:
            progress(rec)
    counts = {s: 0 for s in ("pass", "fail", "ran", "error")}
    for rec in records:
        counts[rec["status"]] += 1
    doc = {
        "schema": CAMPAIGN_SCHEMA,
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
    problems = validate_campaign(doc)
    if problems:      # a bug in the engine, not in the scenarios
        raise RuntimeError("engine produced a schema-invalid campaign: "
                           + "; ".join(problems[:5]))
    return doc


# ---------------------------------------------------------------------------
# Back-compat adapters for the benchmarks/ CSV harness.
# ---------------------------------------------------------------------------

def _fmt(x) -> str:
    if isinstance(x, float):
        return f"{x:.4g}"
    return str(x)


def csv_rows(records: Sequence[dict]) -> list[str]:
    """Render records as the historical ``name,us_per_call,derived`` rows."""
    rows = []
    for rec in records:
        us = rec["timing"]["wall_s"] * 1e6
        if rec["status"] == "error":
            derived = "ERROR_" + rec["error"].split(":")[0]
        elif rec["checks"]:
            parts = []
            for c in rec["checks"]:
                tag = "ok" if c["passed"] else "FAIL"
                parts.append(f"{c['metric']}={_fmt(c['actual'])}"
                             f"_ref{_fmt(c['expect'])}_{tag}")
            derived = "_".join(parts)
        else:
            merged = {**rec["measured"], **rec["metrics"]}
            derived = f"job_seconds={_fmt(merged.get('job_seconds'))}"
            if "job_seconds_reduction_pct" in merged:
                derived += (f"_reduction={merged['job_seconds_reduction_pct']:.1f}pct")
        rows.append(f"{rec['name']},{us:.0f},{derived}")
    return rows


def summary_lines(doc: dict) -> list[str]:
    """Human-readable campaign summary for the CLI."""
    s = doc["summary"]
    lines = [f"{doc['summary']['total']} scenarios: "
             f"{s['pass']} pass, {s['fail']} fail, {s['ran']} ran "
             f"(unchecked), {s['error']} error "
             f"[{doc['timing']['wall_s']:.1f}s]"]
    for rec in doc["scenarios"]:
        if rec["status"] in ("fail", "error"):
            detail = rec["error"] or "; ".join(
                f"{c['metric']}={_fmt(c['actual'])} vs {c['kind']} "
                f"{_fmt(c['expect'])} (tol {c['tol']}) [{c['source']}]"
                for c in rec["checks"] if not c["passed"])
            lines.append(f"  {rec['status'].upper()} {rec['name']}: {detail}")
    return lines
