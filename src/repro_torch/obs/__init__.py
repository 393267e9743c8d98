"""End-to-end tracing & metrics for the track-processing machine.

The layer the paper's §IV–§V performance story needs: structured,
low-overhead span events for every task lifecycle transition, store
decode and DAG admission — emitted identically by
the discrete-event sim (virtual clock) and the live backends (monotonic
clock), exported as Chrome/Perfetto timelines and canonical byte-stable
``TRACE_summary.json`` artifacts, and reduced to critical-path /
straggler / worker-speed reports by ``python -m repro_torch.obs.report``.

Entry points:

  * :class:`Tracer` — the event ring (pass as ``tracer=`` to
    ``run_job``/``run_dag``/``run_service``/``TrackStore``/
    ``TrackWorkflow``, or use ``--trace DIR`` on the track workflow
    CLI; the serving layer's emitters wait for the serving slice);
  * :func:`build_summary` / :func:`summary_from_tracer` — canonical
    ``repro.obs/v1`` summaries;
  * :func:`to_chrome_trace` / :func:`from_chrome_trace` — Perfetto
    export and its inverse;
  * :func:`write_trace_files` — the one-call exporter the workflow and
    bench CLIs use.
"""

from __future__ import annotations

import json
import os

from repro_torch.obs.perfetto import from_chrome_trace, to_chrome_trace
from repro_torch.obs.summary import (
    build_summary, phase_of, summary_from_tracer)
from repro_torch.obs.tracer import (
    CATEGORIES, DEFAULT_CAPACITY, EVENT_FIELDS, INSTANT, Tracer)

__all__ = ["Tracer", "INSTANT", "EVENT_FIELDS", "CATEGORIES",
           "DEFAULT_CAPACITY", "build_summary", "summary_from_tracer",
           "phase_of", "to_chrome_trace", "from_chrome_trace",
           "write_trace_files"]


def write_trace_files(tracer: Tracer, out_dir: str, *,
                      label: str = "run") -> dict[str, str]:
    """Export one tracer to ``<out_dir>/trace.json`` (Perfetto) and
    ``<out_dir>/TRACE_summary.json`` (canonical ``repro.obs/v1``
    bytes); returns the paths keyed by artifact kind."""
    from repro_torch.bench.schema import canonical_bytes

    os.makedirs(out_dir, exist_ok=True)
    events = tracer.events
    trace_path = os.path.join(out_dir, "trace.json")
    with open(trace_path, "w") as f:
        json.dump(to_chrome_trace(events, label=label), f)
    summary = build_summary(events, label=label, dropped=tracer.dropped)
    summary_path = os.path.join(out_dir, "TRACE_summary.json")
    with open(summary_path, "wb") as f:
        f.write(canonical_bytes(summary))
    return {"trace": trace_path, "summary": summary_path}
