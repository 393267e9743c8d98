"""Threshold-driven elastic worker-fleet controller.

The paper pins the worker count at launch (a triple is chosen before the
job starts) — so 20% worker deaths permanently shrink the fleet, and a
drained queue leaves the survivors idle while the last stragglers run.
This module adds the missing control loop, modeled on the memcached
core-reallocation controller (SNIPPETS.md Snippet 2): a measured load
signal crossing fixed thresholds changes the allocation, with hysteresis
so the fleet does not thrash.

The :class:`FleetController` is pure decision state — no clocks, no
threads.  Each backend samples its own load signal on a control interval
and calls :meth:`decide`:

  * the sim backend schedules ``_CONTROL`` events on the virtual clock
    and grows/retires simulated workers (decisions are therefore
    deterministic per seed);
  * the threads backend samples wall-clock intervals inside the
    :func:`~repro_torch.runtime.protocol.drive` loop and spawns/retires real
    worker threads (``ThreadTransport.add_worker`` / ``retire_worker``).

Scale-up triggers on queue pressure (pending tasks per live worker above
``queue_high_per_worker``), scale-down on a drained queue with a mostly
idle fleet; a dead fleet always recovers to ``min_workers`` regardless
of cooldown, so worker deaths shrink a static fleet permanently but only
dent an elastic one for a control interval.  Decisions are recorded (and
traced as ``fleet_scale`` obs instants by the backends) and the
controller's counters serialize into
:class:`~repro_torch.runtime.protocol.ManagerCheckpoint`, so a kill/resume
continues the scaling history instead of resetting it.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["FleetController"]


class FleetController:
    """Grow/shrink a worker fleet from observed queue depth and idleness.

    ``interval_s`` is the control period (virtual seconds on the sim
    backend, wall seconds on threads).  ``step_frac`` sizes each scaling
    move as a fraction of the current fleet (at least one worker), and
    ``cooldown_s`` enforces hysteresis between consecutive moves — the
    memcached exemplar's guard against oscillating around a threshold.
    """

    def __init__(self, *, min_workers: int = 1, max_workers: int = 256,
                 interval_s: float = 5.0,
                 queue_high_per_worker: float = 2.0,
                 idle_frac_high: float = 0.5,
                 step_frac: float = 0.25,
                 cooldown_s: float = 10.0):
        if min_workers < 1:
            raise ValueError("min_workers must be >= 1")
        if max_workers < min_workers:
            raise ValueError("max_workers must be >= min_workers")
        if interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        self.min_workers = int(min_workers)
        self.max_workers = int(max_workers)
        self.interval_s = float(interval_s)
        self.queue_high_per_worker = float(queue_high_per_worker)
        self.idle_frac_high = float(idle_frac_high)
        self.step_frac = float(step_frac)
        self.cooldown_s = float(cooldown_s)
        #: Full decision log: one dict per control tick (observability;
        #: not checkpointed — the counters below are).
        self.decisions: list[dict] = []
        self.workers_added = 0
        self.workers_retired = 0
        self._last_change_t: Optional[float] = None
        # Decisions made before a checkpoint restore (the log itself is
        # not serialized; the running total is).
        self._decisions_base = 0

    def _step(self, n_workers: int) -> int:
        return max(1, int(n_workers * self.step_frac))

    def decide(self, now: float, *, n_workers: int, queue_depth: int,
               busy_frac: float) -> int:
        """One control tick -> intended worker delta (+grow, -shrink, 0).

        ``n_workers`` counts live (non-dead, non-retired) workers;
        ``busy_frac`` is the fraction of them with work in flight.  The
        backend applies as much of the delta as it can (it may find
        fewer idle workers to retire than asked) and reports the actual
        move back through :meth:`applied`.
        """
        delta = 0
        recovery = n_workers < self.min_workers
        if recovery:
            # A (partially) dead fleet recovers immediately: cooldown
            # guards threshold oscillation, not disaster recovery.
            delta = self.min_workers - n_workers
        elif (queue_depth > self.queue_high_per_worker * n_workers
                and n_workers < self.max_workers):
            delta = min(self._step(n_workers),
                        self.max_workers - n_workers)
        elif (queue_depth == 0
                and busy_frac <= 1.0 - self.idle_frac_high
                and n_workers > self.min_workers):
            delta = -min(self._step(n_workers),
                         n_workers - self.min_workers)
        if delta != 0 and not recovery \
                and self._last_change_t is not None \
                and now - self._last_change_t < self.cooldown_s:
            delta = 0
        self.decisions.append({
            "t": float(now), "n_workers": int(n_workers),
            "queue_depth": int(queue_depth),
            "busy_frac": float(busy_frac), "delta": int(delta)})
        if delta != 0:
            self._last_change_t = float(now)
        return delta

    def applied(self, delta: int) -> None:
        """The backend reports how many workers it actually added (>0)
        or retired (<0) for the last decision."""
        if delta > 0:
            self.workers_added += delta
        elif delta < 0:
            self.workers_retired += -delta

    # -- checkpoint --------------------------------------------------------

    def state(self) -> Optional[dict]:
        """JSON-able controller state (None while it never acted)."""
        if self.workers_added == 0 and self.workers_retired == 0 \
                and self._last_change_t is None and not self.decisions \
                and self._decisions_base == 0:
            return None
        return {"workers_added": self.workers_added,
                "workers_retired": self.workers_retired,
                "last_change_t": self._last_change_t,
                "n_decisions": self._decisions_base + len(self.decisions)}

    def restore(self, state: dict) -> None:
        self.workers_added = int(state.get("workers_added", 0))
        self.workers_retired = int(state.get("workers_retired", 0))
        t = state.get("last_change_t")
        self._last_change_t = float(t) if t is not None else None
        self._decisions_base = int(state.get("n_decisions", 0))
