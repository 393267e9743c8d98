"""Chrome/Perfetto trace export: event tuples <-> ``trace.json``.

:func:`to_chrome_trace` renders a tracer's event ring as the Trace Event
Format JSON that ``chrome://tracing`` and https://ui.perfetto.dev load
directly: each ``(cat, track)`` pair becomes a named thread row, spans
become complete (``"X"``) events, instants become ``"i"`` events, and
timestamps are normalized to the earliest event and scaled to
microseconds.  Virtual-clock sim traces and wall-clock live traces
render identically — the paper's heavy-tail §IV timelines become
something you can scrub.

:func:`from_chrome_trace` is the inverse used by
``repro_torch.obs.report`` so the CLI accepts either a ``trace.json``
or a ``TRACE_summary.json``.
The round trip preserves event structure exactly; timestamps come back
in (relative) seconds via the µs scaling, so derived *reports* agree
while canonical summary bytes are only guaranteed when built directly
from the tracer.
"""

from __future__ import annotations

from typing import Iterable

from repro_torch.obs.tracer import INSTANT

__all__ = ["to_chrome_trace", "from_chrome_trace"]

_PID = 1
_US = 1e6


def _track_order(events: list[tuple]) -> dict[tuple[str, str], int]:
    """Stable tid assignment: sorted unique (cat, track-name) -> 1..N."""
    keys = sorted({(e[3], str(e[4])) for e in events})
    return {k: i + 1 for i, k in enumerate(keys)}


def to_chrome_trace(events: Iterable[tuple], *, label: str = "run") -> dict:
    """Event tuples -> a Trace Event Format document (JSON-ready dict)."""
    evs = [tuple(e) for e in events]
    t0 = min((e[0] for e in evs), default=0.0)
    tids = _track_order(evs)
    out: list[dict] = []
    for (cat, track), tid in sorted(tids.items(), key=lambda kv: kv[1]):
        out.append({"ph": "M", "pid": _PID, "tid": tid,
                    "name": "thread_name",
                    "args": {"name": f"{cat}:{track}"}})
    for ts, dur, name, cat, track, task_id, extra in evs:
        ev: dict = {"pid": _PID, "tid": tids[(cat, str(track))],
                    "ts": (ts - t0) * _US, "name": name, "cat": cat}
        if dur >= 0.0:
            ev["ph"] = "X"
            ev["dur"] = dur * _US
        else:
            ev["ph"] = "i"
            ev["s"] = "t"
        args = {}
        if task_id is not None:
            args["task_id"] = task_id
        if extra is not None:
            args["extra"] = extra
        if args:
            ev["args"] = args
        out.append(ev)
    return {"traceEvents": out, "displayTimeUnit": "ms",
            "metadata": {"label": label, "t0_s": t0,
                         "format": "repro.obs trace"}}


def from_chrome_trace(doc: dict) -> list[tuple]:
    """Trace Event Format document -> event tuples (relative seconds).

    Track identity comes back as the string after ``cat:`` in the thread
    name, so worker tracks that were ints round-trip as strings — every
    downstream reduction keys tracks by ``str(track)`` already.
    """
    raw = doc.get("traceEvents", [])
    names: dict[int, str] = {}
    for ev in raw:
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            names[ev["tid"]] = ev.get("args", {}).get("name", "")
    events: list[tuple] = []
    for ev in raw:
        ph = ev.get("ph")
        if ph not in ("X", "i"):
            continue
        cat = ev.get("cat", "")
        thread = names.get(ev.get("tid"), "")
        track = (thread.split(":", 1)[1]
                 if thread.startswith(cat + ":") else thread)
        args = ev.get("args", {})
        events.append((ev["ts"] / _US,
                       (ev["dur"] / _US) if ph == "X" else INSTANT,
                       ev.get("name", ""), cat, track,
                       args.get("task_id"), args.get("extra")))
    return events
