"""Critical-path / straggler report: ``python -m repro_torch.obs.report``.

Reads either artifact the tracer exports — a Chrome/Perfetto
``trace.json`` (reduced on the fly) or a canonical
``TRACE_summary.json`` — and prints the derived performance story:

  * per-phase critical-path lengths and the fitted cost models;
  * top-k straggler tasks with cost-estimate vs actual residuals;
  * per-worker speed estimates, slowest first (the measured
    ``worker_speed`` input the speculation work consumes);
  * per-manager-shard dispatch-rate timelines (the §V message wall as a
    curve).

``--summary-out`` additionally writes the canonical summary JSON, so a
raw ``trace.json`` can be reduced to the diffable artifact after the
fact.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.bench.schema import OBS_SUMMARY_SCHEMA, canonical_bytes
from repro_torch.obs.perfetto import from_chrome_trace
from repro_torch.obs.summary import build_summary

__all__ = ["load_summary", "render_report", "main"]

_SPARK = " .:-=+*#%@"


def _spark(bins) -> str:
    peak = max(bins) if bins else 0
    if peak <= 0:
        return " " * len(bins)
    return "".join(
        _SPARK[min(int(b * (len(_SPARK) - 1) / peak + 0.5),
                   len(_SPARK) - 1)] for b in bins)


def load_summary(path: str, *, top_k: int = 10) -> dict:
    """Load a summary from either a trace.json or a TRACE_summary.json."""
    with open(path) as f:
        doc = json.load(f)
    if doc.get("schema") == OBS_SUMMARY_SCHEMA:
        return doc
    if "traceEvents" in doc:
        label = doc.get("metadata", {}).get("label", "trace")
        return build_summary(from_chrome_trace(doc), label=label,
                             top_k=top_k)
    raise ValueError(
        f"{path}: neither a {OBS_SUMMARY_SCHEMA!r} summary nor a "
        f"Chrome trace (no 'traceEvents')")


def render_report(doc: dict, *, top: int = 10) -> list[str]:
    """Human-readable report lines for one summary document."""
    m = doc["scenario"]["metrics"]
    cfg = doc.get("config", {})
    lines = [
        f"trace: {doc['scenario']['name']}  "
        f"events={cfg.get('n_events', '?')} "
        f"dropped={cfg.get('dropped', 0)}",
        f"makespan {m['makespan_s']:.6g}s  critical path "
        f"{m['critical_path_s']:.6g}s  exec p50/p99 "
        f"{m['exec_p50_s']:.4g}/{m['exec_p99_s']:.4g}s "
        f"(ratio {m['exec_p99_over_p50']:.3g})",
        f"lifecycle: queued={m['n_queued']} assigned={m['n_assigned']} "
        f"done={m['n_done']} failed={m['n_failed']} "
        f"requeued={m['n_requeued']}  exec spans={m['n_exec_spans']} "
        f"workers={m['n_workers_seen']}",
    ]
    phases = doc.get("phases", {})
    if phases:
        lines.append("per-phase critical path:")
        for ph in sorted(phases):
            p = phases[ph]
            cm = p["cost_model"]
            model = (f"linear(a={cm['a_s']:.3g}s, "
                     f"b={cm['b_s_per_byte']:.3g}s/B)"
                     if cm["kind"] == "linear"
                     else f"mean({cm['mean_s']:.3g}s)")
            lines.append(f"  {ph:16s} crit={p['critical_path_s']:10.6g}s"
                         f"  tasks={p['n_tasks']:6d}"
                         f"  busy={p['busy_s']:10.6g}s  cost={model}")
    stragglers = doc.get("stragglers", [])
    if stragglers:
        lines.append(f"top {min(top, len(stragglers))} stragglers "
                     f"(of {m['straggler_count']} beyond the "
                     f"2x-estimate threshold):")
        lines.append(f"  {'task':24s} {'worker':>8s} {'actual':>10s} "
                     f"{'est':>10s} {'residual':>10s} {'ratio':>7s}")
        for s in stragglers[:top]:
            lines.append(f"  {str(s['task_id']):24s} {s['worker']:>8s} "
                         f"{s['actual_s']:10.4g} {s['est_s']:10.4g} "
                         f"{s['residual_s']:10.4g} {s['ratio']:7.2f}")
    workers = {k: v for k, v in doc.get("workers", {}).items()
               if not k.startswith("_")}
    if workers:
        ranked = sorted(workers, key=lambda k: (workers[k]["speed_est"], k))
        lines.append(f"slowest workers (speed = estimated/actual cost; "
                     f"{len(ranked)} listed"
                     + (f", {doc['workers']['_dropped_workers']} dropped)"
                        if "_dropped_workers" in doc.get("workers", {})
                        else ")") + ":")
        for k in ranked[:top]:
            w = workers[k]
            lines.append(f"  {k:>8s}  speed={w['speed_est']:.3f}  "
                         f"tasks={w['n_tasks']:5d}  "
                         f"busy={w['busy_s']:.6g}s")
    shards = doc.get("shards", {})
    if shards:
        lines.append("per-shard dispatch timeline (assigned per bin, "
                     f"bin={next(iter(shards.values()))['bin_s']:.4g}s):")
        for s in sorted(shards):
            d = shards[s]
            lines.append(f"  shard {s:>4s} [{_spark(d['bins'])}] "
                         f"total={d['assigned']}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Derive the critical-path/straggler report from a "
                    "trace.json or TRACE_summary.json.")
    ap.add_argument("path", help="trace.json or TRACE_summary.json")
    ap.add_argument("--top", type=int, default=10,
                    help="rows per table (default 10)")
    ap.add_argument("--summary-out", default=None,
                    help="also write the canonical summary JSON here")
    args = ap.parse_args(argv)
    try:
        doc = load_summary(args.path, top_k=args.top)
    except (OSError, ValueError, KeyError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    for line in render_report(doc, top=args.top):
        print(line)
    if args.summary_out:
        with open(args.summary_out, "wb") as f:
            f.write(canonical_bytes(doc))
        print(f"wrote {args.summary_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
