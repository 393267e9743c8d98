"""Diff two BENCH artifacts: ``python -m repro_torch.bench.compare``.

Dispatches on the artifacts' ``schema`` field, so one CLI diffs every
BENCH kind the repo emits:

  * ``repro.bench.campaign/v1`` / ``repro.bench.smoke/v1`` — headline
    deterministic metric ``job_seconds`` (simulated job time);
  * ``repro.bench.kernels/v1`` — ``padded_fraction`` (padding-to-payload
    ratio of the fused pipeline; multiplies wasted kernel compute);
  * ``repro.bench.storage/v1`` — ``bytes_per_point`` (columnar-store
    encoding efficiency);
  * ``repro.bench.scheduling/v1`` — ``makespan_seconds`` (simulated
    policy makespan), with non-gating delta rows for the busy
    quantiles (``busy_p50_s``/``busy_p90_s``) and the per-manager
    dispatch throughput (``dispatch_rate_msgs_per_s``) printed
    alongside, so a policy that holds its makespan by burning
    worker-time imbalance — or a change that quietly serializes the
    manager — is still visible in the diff; speculation accounting
    (``speculated``/``extra_messages``/``wasted_duplicate_s``) rides
    along the same way, so a policy change that wins makespan by
    burning duplicate executions cannot hide it;
  * ``repro.bench.serving/v1`` — ``ingest_lag_max_points`` (worst
    accepted-but-uncommitted backlog during continuous ingest; only
    the deterministic inline-mode cells publish it under ``metrics``),
    with non-gating rows for ``shards_committed``/``points_ingested``
    so a cut-rule change that silently re-shards the same feed is
    visible.
  * ``repro.bench.obs/v1`` — ``makespan_seconds`` (the traced run's
    simulated makespan; the overhead/determinism/straggler gates live
    in the artifact's own checks), with a non-gating ``n_events`` row;
  * ``repro.obs/v1`` — a single trace summary
    (``TRACE_summary.json``): headline ``critical_path_s``, with
    non-gating rows for ``straggler_count`` and ``exec_p99_over_p50``
    so a scheduling change that trades critical path for tail blowup
    is visible;
  * ``repro.bench.encounters/v1`` — ``screen_seconds_per_candidate``
    (modeled screen wall-clock per emitted candidate encounter; only
    the screen-kind cells publish it — policy sim cells gate through
    their own checks), with non-gating rows for ``cells``,
    ``candidates``, and ``max_cell_occupancy`` so a binning change
    that silently reshapes the spatial hash (more cells, fewer
    candidates, flattened occupancy skew) is visible in the diff.

All default metrics are lower-is-better and deterministic for a fixed
seed; live wall-clock numbers live under ``measured`` and are
deliberately NOT regression-gated — they measure the CI machine, not
the code.  A scenario *regresses* when its metric grows by more than
``--threshold`` (relative).  Exit codes: 0 — no regressions; 1 —
regressions found (or the two artifacts' schemas do not match).

The port writes the reference's schema names (``repro.bench.*/v1``), and
keeps its scenario names, so a JAX-package artifact and a port artifact
of one kind diff against each other, row by row::

    python -m repro.bench.kernels --quick --out ref.json
    python -m repro_torch.bench.kernels --quick --device cpu --out port.json
    python -m repro_torch.bench.compare ref.json port.json

Typical PR workflow::

    git stash && python -m repro_torch.bench.campaign --quick --out old.json
    git stash pop && python -m repro_torch.bench.campaign --quick --out new.json
    python -m repro_torch.bench.compare old.json new.json --threshold 0.10
"""

from __future__ import annotations

import argparse
import json
import sys

__all__ = ["DEFAULT_METRICS", "INFO_METRICS", "default_metric",
           "compare_docs", "render_rows", "main"]

METRIC = "job_seconds"          # historical default (campaign artifacts)

#: schema -> the deterministic, lower-is-better headline metric.
DEFAULT_METRICS = {
    "repro.bench.campaign/v1": "job_seconds",
    "repro.bench.smoke/v1": "job_seconds",
    "repro.bench.kernels/v1": "padded_fraction",
    "repro.bench.storage/v1": "bytes_per_point",
    "repro.bench.scheduling/v1": "makespan_seconds",
    "repro.bench.serving/v1": "ingest_lag_max_points",
    "repro.bench.encounters/v1": "screen_seconds_per_candidate",
    "repro.bench.obs/v1": "makespan_seconds",
    "repro.obs/v1": "critical_path_s",
}

#: schema -> informational secondary metrics: their deltas are printed
#: but never gate (only the schema's DEFAULT metric regresses a run).
INFO_METRICS = {
    "repro.bench.scheduling/v1": ("busy_p50_s", "busy_p90_s",
                                  "dispatch_rate_msgs_per_s",
                                  "speculated", "extra_messages",
                                  "wasted_duplicate_s"),
    "repro.bench.serving/v1": ("shards_committed", "points_ingested"),
    "repro.bench.encounters/v1": ("cells", "candidates",
                                  "max_cell_occupancy"),
    "repro.bench.obs/v1": ("n_events",),
    "repro.obs/v1": ("straggler_count", "exec_p99_over_p50"),
}


def default_metric(doc: dict) -> str:
    """The regression metric for a BENCH document's schema."""
    schema = doc.get("schema")
    try:
        return DEFAULT_METRICS[schema]
    except KeyError:
        raise ValueError(
            f"unknown BENCH schema {schema!r}; known: "
            f"{sorted(DEFAULT_METRICS)}") from None


def _records(doc: dict) -> list[dict]:
    """Scenario records regardless of kind (smoke docs hold just one)."""
    if isinstance(doc.get("scenarios"), list):
        return [r for r in doc["scenarios"] if isinstance(r, dict)]
    if isinstance(doc.get("scenario"), dict):
        return [doc["scenario"]]
    return []


def compare_docs(old: dict, new: dict, *, threshold: float = 0.10,
                 metric: str | None = None):
    """-> (rows, regressions): per-scenario metric deltas old -> new.

    ``metric=None`` resolves the metric from the artifacts' ``schema``
    field (the two must agree).  Only scenarios present in both
    artifacts with a positive numeric deterministic metric are compared.
    """
    if old.get("schema") != new.get("schema"):
        raise ValueError(
            f"cannot compare artifacts of different schemas: "
            f"{old.get('schema')!r} vs {new.get('schema')!r}")
    if metric is None:
        metric = default_metric(old)

    def metric_map(doc):
        out = {}
        for rec in _records(doc):
            v = rec.get("metrics", {}).get(metric)
            if isinstance(v, (int, float)) and v > 0:
                out[rec["name"]] = v
        return out

    o, n = metric_map(old), metric_map(new)
    rows, regressions = [], []
    for name in sorted(o.keys() & n.keys()):
        delta = n[name] / o[name] - 1.0
        row = {"name": name, "metric": metric, "old": o[name],
               "new": n[name], "delta_pct": delta * 100.0,
               "regressed": delta > threshold}
        rows.append(row)
        if row["regressed"]:
            regressions.append(row)
    for name in sorted(o.keys() - n.keys()):
        rows.append({"name": name, "metric": metric, "old": o[name],
                     "new": None, "delta_pct": None, "regressed": False})
    for name in sorted(n.keys() - o.keys()):
        rows.append({"name": name, "metric": metric, "old": None,
                     "new": n[name], "delta_pct": None, "regressed": False})
    return rows, regressions


def render_rows(rows) -> list[str]:
    lines = [f"{'scenario':44s} {'old':>12s} {'new':>12s} {'delta':>8s}"]
    for r in rows:
        old = f"{r['old']:.4g}" if r["old"] is not None else "-"
        new = f"{r['new']:.4g}" if r["new"] is not None else "-"
        delta = (f"{r['delta_pct']:+.1f}%" if r["delta_pct"] is not None
                 else "n/a")
        flag = "  << REGRESSED" if r["regressed"] else ""
        lines.append(f"{r['name']:44s} {old:>12s} {new:>12s} "
                     f"{delta:>8s}{flag}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.bench.compare",
        description="Compare two BENCH artifacts (campaign, smoke, "
                    "kernels, or storage — dispatched on their schema "
                    "field) and fail on metric regressions.")
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--threshold", type=float, default=0.10,
                    help="max allowed relative regression (default 0.10)")
    defaults = ", ".join(
        "{}: {}".format(k.split("/")[0].rsplit(".", 1)[-1], v)
        for k, v in sorted(DEFAULT_METRICS.items()))
    ap.add_argument("--metric", default=None,
                    help=f"override the schema's default metric "
                         f"(defaults: {defaults})")
    args = ap.parse_args(argv)
    with open(args.old) as f:
        old = json.load(f)
    with open(args.new) as f:
        new = json.load(f)
    try:
        rows, regressions = compare_docs(old, new,
                                         threshold=args.threshold,
                                         metric=args.metric)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(f"metric: {args.metric or default_metric(old)} "
          f"[{old.get('schema')}]")
    for line in render_rows(rows):
        print(line)
    if args.metric is None:
        for extra in INFO_METRICS.get(old.get("schema"), ()):
            xrows, _ = compare_docs(old, new, threshold=float("inf"),
                                    metric=extra)
            if xrows:
                print(f"info metric: {extra} (not gated)")
                for line in render_rows(xrows):
                    print(line)
    if regressions:
        print(f"{len(regressions)} scenario(s) regressed beyond "
              f"{args.threshold:.0%}")
        return 1
    print("no regressions")
    return 0


if __name__ == "__main__":
    sys.exit(main())
