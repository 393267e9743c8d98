"""Canonical trace summaries: raw event tuples -> ``TRACE_summary.json``.

:func:`build_summary` reduces a :class:`repro_torch.obs.tracer.Tracer`
event stream to the byte-stable ``repro.obs/v1`` artifact the bench
compare tooling diffs:

  * headline ``scenario.metrics`` — critical-path seconds, straggler
    count, exec p99/p50 ratio, makespan — shaped so the reference's
    ``repro.bench.compare`` reads them through its single-``scenario``
    path (the smoke-doc shape);
  * per-phase critical paths and fitted cost models;
  * per-worker busy time and *speed estimates* (estimated cost over
    actual cost — the ``worker_speed`` input the ROADMAP's speculation
    tentpole needs, now measured instead of assumed);
  * top-k straggler tasks with cost-estimate vs actual residuals;
  * per-manager-shard dispatch-rate timelines (binned ``assigned``
    counts) that render the paper's §V message wall as a curve.

Determinism: timestamps are normalized to the earliest event, every
reduction iterates in event order or over sorted keys, and no wall-clock
or environment field enters the document — so a sim trace summarizes to
byte-identical JSON across same-seed reruns
(``repro_torch.bench.schema.canonical_bytes`` is the serializer).

Cost model: per phase, a least-squares linear fit of exec duration vs
task ``size_bytes`` when every span carries a size (the sim path), else
the phase mean.  The same fit prices every worker's tasks, so a uniform
fit bias cancels out of the speed-estimate *ranking* — a 4×-slowed
worker lands at the bottom regardless of fit quality.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

from repro_torch.bench.schema import OBS_SUMMARY_SCHEMA, SCHEMA_VERSION

__all__ = ["build_summary", "summary_from_tracer", "phase_of",
           "STRAGGLER_RATIO"]

#: A task is a straggler when actual exec time exceeds this multiple of
#: its cost estimate.
STRAGGLER_RATIO = 2.0

#: Floor for cost estimates (keeps actual/estimate ratios finite).
_EST_FLOOR = 1e-12


def phase_of(task_id: Optional[str]) -> str:
    """Phase bucket of a task id: the DAG node prefix when namespaced
    (``radar:t0042`` -> ``radar``), else the catch-all ``all``."""
    if isinstance(task_id, str) and ":" in task_id:
        return task_id.split(":", 1)[0]
    return "all"


def _num(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool)


def _quantile(sorted_xs: Sequence[float], q: float) -> float:
    """Nearest-rank quantile (same rule as ``RunResult._quantiles``)."""
    i = min(int(q * (len(sorted_xs) - 1) + 0.5), len(sorted_xs) - 1)
    return sorted_xs[i]


def _fit_cost_model(spans: Sequence[tuple]) -> dict:
    """Fit one phase's exec spans -> cost-model doc.

    ``spans`` are event tuples whose ``extra`` slot may carry the task
    size in bytes.  Linear least squares on (size, dur) when every span
    has a numeric size and the fit slope is positive; otherwise the
    phase-mean model.
    """
    durs = [e[1] for e in spans]
    mean = sum(durs) / len(durs)
    sizes = [e[6] for e in spans]
    if len(spans) >= 2 and all(_num(s) for s in sizes):
        n = float(len(spans))
        sx = sum(float(s) for s in sizes)
        sy = sum(durs)
        sxx = sum(float(s) * float(s) for s in sizes)
        sxy = sum(float(s) * d for s, d in zip(sizes, durs))
        denom = n * sxx - sx * sx
        if denom > 0.0:
            b = (n * sxy - sx * sy) / denom
            a = (sy - b * sx) / n
            if b > 0.0:
                return {"kind": "linear", "a_s": a, "b_s_per_byte": b,
                        "mean_s": mean}
    return {"kind": "mean", "mean_s": mean}


def _estimate(model: dict, extra) -> float:
    if model["kind"] == "linear" and _num(extra):
        return max(model["a_s"] + model["b_s_per_byte"] * float(extra),
                   _EST_FLOOR)
    return max(model["mean_s"], _EST_FLOOR)


def build_summary(events: Iterable[tuple], *, label: str = "run",
                  dropped: int = 0, top_k: int = 10,
                  max_workers: int = 64, n_bins: int = 20) -> dict:
    """Reduce raw event tuples to a ``repro.obs/v1`` summary document.

    ``dropped`` records ring-buffer evictions (from
    ``Tracer.dropped``); ``top_k`` bounds the straggler table;
    ``max_workers`` caps the per-worker table (busiest kept, the rest
    counted under ``_dropped_workers``); ``n_bins`` sets the dispatch
    timeline resolution.
    """
    evs = [tuple(e) for e in events]
    t0 = min((e[0] for e in evs), default=0.0)
    t1 = t0
    for e in evs:
        end = e[0] + (e[1] if e[1] >= 0.0 else 0.0)
        if end > t1:
            t1 = end
    makespan = t1 - t0

    name_counts: dict[str, int] = {}
    for e in evs:
        name_counts[e[2]] = name_counts.get(e[2], 0) + 1

    exec_spans = [e for e in evs if e[2] == "exec" and e[1] >= 0.0]

    # -- per-phase cost models + critical paths ---------------------------
    by_phase: dict[str, list[tuple]] = {}
    for e in exec_spans:
        by_phase.setdefault(phase_of(e[5]), []).append(e)
    phases: dict[str, dict] = {}
    models: dict[str, dict] = {}
    critical_path_total = 0.0
    for ph in sorted(by_phase):
        spans = by_phase[ph]
        model = _fit_cost_model(spans)
        models[ph] = model
        worker_busy: dict[str, float] = {}
        busy = 0.0
        for e in spans:
            w = str(e[4])
            worker_busy[w] = worker_busy.get(w, 0.0) + e[1]
            busy += e[1]
        crit = max((worker_busy[w] for w in sorted(worker_busy)),
                   default=0.0)
        critical_path_total += crit
        phases[ph] = {"n_tasks": len(spans), "busy_s": busy,
                      "critical_path_s": crit, "cost_model": model}

    # -- per-task residuals -> stragglers ---------------------------------
    scored = []
    for e in exec_spans:
        ph = phase_of(e[5])
        est = _estimate(models[ph], e[6])
        scored.append((e, ph, est, e[1] - est, e[1] / est))
    straggler_count = sum(1 for s in scored if s[4] > STRAGGLER_RATIO)
    scored.sort(key=lambda s: (-s[3], str(s[0][5]), str(s[0][4])))
    stragglers = [
        {"task_id": s[0][5], "worker": str(s[0][4]), "phase": s[1],
         "actual_s": s[0][1], "est_s": s[2], "residual_s": s[3],
         "ratio": s[4]}
        for s in scored[:top_k]]

    # -- per-worker speed estimates ---------------------------------------
    wk: dict[str, dict] = {}
    for e, _ph, est, _res, _ratio in scored:
        w = wk.setdefault(str(e[4]),
                          {"n_tasks": 0, "busy_s": 0.0, "est_s": 0.0})
        w["n_tasks"] += 1
        w["busy_s"] += e[1]
        w["est_s"] += est
    for w in wk.values():
        w["speed_est"] = (w["est_s"] / w["busy_s"]
                          if w["busy_s"] > 0.0 else 1.0)
    kept = sorted(wk, key=lambda k: (-wk[k]["busy_s"], k))[:max_workers]
    workers: dict[str, dict] = {k: wk[k] for k in kept}
    if len(wk) > len(kept):
        workers["_dropped_workers"] = len(wk) - len(kept)

    # -- per-shard dispatch timelines -------------------------------------
    width = (makespan / n_bins) if makespan > 0.0 else 1.0
    shard_bins: dict[str, list[int]] = {}
    shard_counts: dict[str, int] = {}
    for e in evs:
        if e[2] != "assigned":
            continue
        shard = str(e[6] if e[6] is not None else 0)
        bins = shard_bins.setdefault(shard, [0] * n_bins)
        bins[min(int((e[0] - t0) / width), n_bins - 1)] += 1
        shard_counts[shard] = shard_counts.get(shard, 0) + 1
    shards = {s: {"assigned": shard_counts[s], "bin_s": width,
                  "bins": shard_bins[s]}
              for s in sorted(shard_bins)}

    durs = sorted(e[1] for e in exec_spans)
    p50 = _quantile(durs, 0.50) if durs else 0.0
    p99 = _quantile(durs, 0.99) if durs else 0.0
    metrics = {
        "critical_path_s": critical_path_total,
        "makespan_s": makespan,
        "straggler_count": straggler_count,
        "exec_p50_s": p50,
        "exec_p99_s": p99,
        "exec_p99_over_p50": (p99 / p50) if p50 > 0.0 else 0.0,
        "n_exec_spans": len(exec_spans),
        "n_workers_seen": len(wk),
        "n_queued": name_counts.get("queued", 0),
        "n_assigned": name_counts.get("assigned", 0),
        "n_done": name_counts.get("done", 0),
        "n_failed": name_counts.get("failed", 0),
        "n_requeued": name_counts.get("requeued", 0),
    }
    return {
        "schema": OBS_SUMMARY_SCHEMA,
        "schema_version": SCHEMA_VERSION,
        "config": {"label": label, "n_events": len(evs),
                   "dropped": dropped, "top_k": top_k,
                   "max_workers": max_workers, "n_bins": n_bins},
        "scenario": {"name": label, "status": "ran", "metrics": metrics},
        "phases": phases,
        "workers": workers,
        "stragglers": stragglers,
        "shards": shards,
    }


def summary_from_tracer(tracer, *, label: str = "run", **kw) -> dict:
    """Summarize a live :class:`~repro_torch.obs.tracer.Tracer` in place."""
    return build_summary(tracer.events, label=label,
                         dropped=tracer.dropped, **kw)
