"""`Tracer`: the low-overhead structured event ring every layer emits into.

One tracer instance is threaded through a whole run — scheduler core,
execution backend, store reader, serving loop — and collects *events*:
fixed-shape tuples appended to a bounded ring buffer.  Two event kinds
share one shape:

  * **spans** carry a start timestamp and a duration (``dur >= 0``) —
    task executions, shard decodes, query lifetimes;
  * **instants** mark a point in time (``dur == INSTANT``) — task
    lifecycle transitions (``queued``/``assigned``/``done``/``failed``/
    ``requeued``), DAG admissions, ingest commits.

Event tuple layout (:data:`EVENT_FIELDS`)::

    (ts, dur, name, cat, track, task_id, extra)

``ts``/``dur`` are seconds in the tracer's *clock domain*; ``cat`` is one
of :data:`CATEGORIES`; ``track`` names the timeline row the event
belongs to (a worker id, a manager shard, a service stream); ``task_id``
/``extra`` are optional correlation payload (``extra`` stays a scalar on
hot paths).

Design constraints, in order:

  1. **Cheap when attached.**  ``emit`` is one counter bump plus one
     ``deque.append`` of a tuple — no dict construction, no string
     formatting, no locking (``deque.append`` is atomic under the GIL,
     so the store prefetch thread and the driver loop share one tracer
     safely).  Ring overflow is handled by the deque's own ``maxlen``
     eviction; :attr:`Tracer.dropped` is *derived*
     (``emitted - len(ring)``) so the hot path never compares against
     capacity.  Per-task loops go one step further through the
     sanctioned raw fast path — append pre-built tuples via
     :attr:`Tracer.raw`, then settle the count once per batch with
     ``tracer.emitted += n`` — which skips the ``emit`` call frame
     entirely (~10x cheaper per event).  The ≤5 % makespan gate on the
     heavy_tail sim (``python -m repro_torch.bench.obs``) holds the
     line.
  2. **Free when absent.**  Every instrumentation site guards with
     ``if tracer is not None`` — an untraced run pays one attribute
     load per site.
  3. **Clock-agnostic.**  The default clock is ``time.monotonic``; the
     discrete-event sim rebinds it to its virtual clock
     (:meth:`Tracer.set_clock`), so simulated and live runs emit through
     the same API and render identically.

The ring is bounded (``capacity`` events); overflow evicts the oldest
event and counts it in :attr:`Tracer.dropped` — a saturated trace is
explicitly marked, never silently wrong.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Optional

__all__ = ["INSTANT", "EVENT_FIELDS", "CATEGORIES", "DEFAULT_CAPACITY",
           "Tracer"]

#: Sentinel duration marking an instant event (a point, not a range).
INSTANT = -1.0

#: Positional meaning of each slot in an event tuple.
EVENT_FIELDS = ("ts", "dur", "name", "cat", "track", "task_id", "extra")

#: Known event categories (one per instrumented layer).
CATEGORIES = ("task", "sched", "store", "dag", "serving")

#: Default ring size: a 12k-task sim emits ~5 events per task, so the
#: default holds two orders of magnitude more than the standard bench
#: workload before eviction starts.
DEFAULT_CAPACITY = 1_000_000


class Tracer:
    """Bounded event ring with a swappable clock (see module docstring)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 clock: Optional[Callable[[], float]] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._events: collections.deque = collections.deque(maxlen=capacity)
        #: Sanctioned hot-loop fast path: the ring's bound
        #: ``deque.append``.  Append fully-built 7-slot event tuples
        #: directly, then settle accounting once per batch with
        #: ``tracer.emitted += n`` (eviction is the deque's own
        #: ``maxlen``; :attr:`dropped` is derived from ``emitted``).
        self.raw: Callable[[tuple], None] = self._events.append
        #: Total events ever appended (raw appends included — their
        #: callers bump this).
        self.emitted = 0
        #: Current time source — call directly (``tracer.clock()``) on
        #: hot paths; :meth:`now` is the same thing one frame slower.
        self.clock: Callable[[], float] = (clock if clock is not None
                                           else time.monotonic)

    def set_clock(self, clock: Callable[[], float]) -> None:
        """Rebind the time source (the sim binds its virtual clock)."""
        self.clock = clock

    def now(self) -> float:
        """Current time in the tracer's clock domain."""
        return self.clock()

    @property
    def dropped(self) -> int:
        """Events evicted by ring overflow (oldest-first)."""
        return self.emitted - len(self._events)

    # -- hot path ----------------------------------------------------------

    def emit(self, ts: float, dur: float, name: str, cat: str, track,
             task_id=None, extra=None) -> None:
        """Append one raw event tuple; ``dur=INSTANT`` marks an instant."""
        self.emitted += 1
        self.raw((ts, dur, name, cat, track, task_id, extra))

    def instant(self, name: str, cat: str, track, *, ts: Optional[float]
                = None, task_id=None, extra=None) -> None:
        """Point event at ``ts`` (default: now)."""
        self.emit(self.clock() if ts is None else ts, INSTANT,
                  name, cat, track, task_id, extra)

    def span(self, name: str, cat: str, track, start: float, end: float,
             *, task_id=None, extra=None) -> None:
        """Range event covering ``[start, end]``."""
        self.emit(start, end - start, name, cat, track, task_id, extra)

    # -- read side ---------------------------------------------------------

    def __len__(self) -> int:
        return len(self._events)

    @property
    def events(self) -> list[tuple]:
        """Snapshot of the ring contents (oldest first)."""
        return list(self._events)

    def clear(self) -> None:
        self._events.clear()
        self.emitted = 0
