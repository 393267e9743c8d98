"""Unified result type for every execution backend.

Before this package existed the repo had two divergent result types:
``selfsched.JobResult`` (real runs, wall-clock seconds) and
``simulator.SimResult`` (simulated seconds).  ``RunResult`` subsumes both:
the live backends fill ``results``/``worker_stats``; the sim backend
additionally fills ``task_records``.  The old names remain as aliases so
existing callers keep working.

:meth:`RunResult.to_record` is the serialization boundary for the BENCH
artifacts (the JAX package's ``bench.schema``): a flat JSON-able dict of the
run's measurable outcomes, split so that callers can separate fields that
are deterministic for a fixed job spec (counts, the dispatch digest, sim
times) from wall-clock measurements.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Optional

__all__ = ["WorkerStats", "SimTaskRecord", "RunResult"]

BUSY_QUANTILES = (0.0, 0.25, 0.50, 0.75, 0.90, 0.99, 1.0)


@dataclasses.dataclass
class WorkerStats:
    worker_id: Any
    tasks_completed: int = 0
    busy_seconds: float = 0.0
    idle_seconds: float = 0.0
    # Portion of busy_seconds spent waiting on the task *feed* rather
    # than computing: live backends fill it from DONE messages (worker
    # fns exposing take_wait_s(), e.g. the store reader's decode wait);
    # the sim backend fills it with the task's I/O-phase seconds.
    wait_seconds: float = 0.0
    first_task_at: Optional[float] = None
    last_done_at: Optional[float] = None

    @property
    def span_seconds(self) -> float:
        if self.first_task_at is None or self.last_done_at is None:
            return 0.0
        return self.last_done_at - self.first_task_at


@dataclasses.dataclass
class SimTaskRecord:
    task_id: str
    worker: int
    start_s: float
    end_s: float
    size_bytes: int


@dataclasses.dataclass
class RunResult:
    """What the manager measures: 'total job time ... as measured by the
    manager' (paper §IV.A) — plus per-worker stats, exactly-once results,
    and the dispatch log shared by all backends."""

    job_seconds: float
    results: dict[str, Any] = dataclasses.field(default_factory=dict)
    worker_stats: dict[Any, WorkerStats] = dataclasses.field(
        default_factory=dict)
    failed_workers: list = dataclasses.field(default_factory=list)
    reassigned_tasks: int = 0
    messages_sent: int = 0
    backend: str = "threads"
    # Per-task failure ledger (task_id -> error string); empty unless the
    # job ran with raise_on_failure=False and tasks actually failed.
    failures: dict[str, str] = dataclasses.field(default_factory=dict)
    # Sim-only extras (empty on live backends).
    task_records: list[SimTaskRecord] = dataclasses.field(
        default_factory=list)
    # The manager's dispatch log: one tuple of task ids per ASSIGN message,
    # in send order.  Identical across backends for the same job spec.
    batches: list[tuple[str, ...]] = dataclasses.field(default_factory=list)
    completed_ids: frozenset = frozenset()
    # Per-manager-shard ASSIGN counts (sharded-coordinator runs only;
    # empty for the single-manager baseline).  Feeds the per-shard
    # dispatch rates in to_record() that make the §V message-wall
    # flatline — and its removal under sharding — observable in
    # BENCH_scheduling.json.
    shard_messages: list[int] = dataclasses.field(default_factory=list)
    # Speculation accounting: backup copies issued, the extra ASSIGN
    # messages they cost (counted in messages_sent but NOT in batches —
    # the dispatch digest covers the primary schedule only), and the
    # seconds burned executing duplicates that lost the race.
    speculated: int = 0
    extra_messages: int = 0
    wasted_seconds: float = 0.0
    # Elastic-fleet accounting (zero for static fleets).
    workers_added: int = 0
    workers_retired: int = 0

    # -- JobResult compatibility -------------------------------------------

    @property
    def worker_times(self) -> list[float]:
        return sorted(s.busy_seconds for s in self.worker_stats.values())

    # -- SimResult compatibility -------------------------------------------

    @property
    def worker_busy(self) -> list[float]:
        """Per-worker busy seconds, in worker order."""
        return [s.busy_seconds for s in self.worker_stats.values()]

    @property
    def worker_span(self) -> list[float]:
        """First-start..last-end per worker, in worker order."""
        return [s.span_seconds for s in self.worker_stats.values()]

    @property
    def worker_wait(self) -> list[float]:
        """Per-worker feed-wait seconds, in worker order."""
        return [s.wait_seconds for s in self.worker_stats.values()]

    @property
    def dead_workers(self) -> list:
        return self.failed_workers

    @property
    def median_worker_busy(self) -> float:
        xs = sorted(b for b in self.worker_busy if b > 0)
        if not xs:
            return 0.0
        n = len(xs)
        return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])

    @property
    def worker_time_span(self) -> float:
        xs = [b for b in self.worker_busy if b > 0]
        return (max(xs) - min(xs)) if xs else 0.0

    # -- serialization -----------------------------------------------------

    @property
    def dispatch_digest(self) -> str:
        """SHA-256 over the ordered ASSIGN batch contents.

        The batch *sequence* is decided by the shared SchedulerCore, so
        for a fixed fault-free job spec this digest is identical across
        backends and across repeat runs — it is the cheap equality proof
        the BENCH artifacts store instead of the full dispatch log.
        """
        h = hashlib.sha256()
        for batch in self.batches:
            h.update("|".join(batch).encode())
            h.update(b"\n")
        return h.hexdigest()

    @staticmethod
    def _quantiles(xs: list, qs) -> dict[str, float]:
        xs = sorted(xs)
        if not xs:
            return {f"p{int(q * 100)}": 0.0 for q in qs}
        out = {}
        for q in qs:
            # Nearest-rank on the sorted values: index-arithmetic only,
            # so the values are bit-reproducible across platforms.
            i = min(int(q * (len(xs) - 1) + 0.5), len(xs) - 1)
            out[f"p{int(q * 100)}"] = xs[i]
        return out

    def busy_quantiles(self, qs=BUSY_QUANTILES) -> dict[str, float]:
        """Quantiles of per-worker busy seconds (workers that ran >0 s)."""
        return self._quantiles([b for b in self.worker_busy if b > 0], qs)

    def wait_quantiles(self, qs=BUSY_QUANTILES) -> dict[str, float]:
        """Quantiles of per-worker feed-wait seconds (workers that ran)."""
        return self._quantiles(
            [s.wait_seconds for s in self.worker_stats.values()
             if s.busy_seconds > 0], qs)

    def worker_breakdown(self, max_workers: Optional[int] = 64
                         ) -> dict[str, dict[str, float]]:
        """Per-worker busy/idle/wait attribution, keyed by worker id.

        ``busy_s`` includes ``wait_s`` (a worker stalled on its feed is
        occupied, not idle); ``idle_s`` is time between DONEs not
        covered by reported busy time — i.e. scheduling/poll latency.

        ``max_workers`` bounds the table so a 2047-worker sim sweep
        cannot bloat a BENCH record: the busiest ``max_workers`` rows
        (ties broken by worker id) are kept and the rest are *counted*
        under a ``"_dropped_workers"`` entry rather than silently
        truncated.  ``None`` disables the cap.  The ``"_"`` prefix
        cannot collide with a real worker key (ids stringify to
        ``"w0"``/``"3"``-style names).
        """
        stats = list(self.worker_stats.values())
        dropped = 0
        if max_workers is not None and len(stats) > max_workers:
            stats.sort(key=lambda s: (-s.busy_seconds, str(s.worker_id)))
            dropped = len(stats) - max_workers
            stats = stats[:max_workers]
        out: dict[str, dict[str, float]] = {
            str(s.worker_id): {
                "tasks": s.tasks_completed,
                "busy_s": s.busy_seconds,
                "idle_s": s.idle_seconds,
                "wait_s": s.wait_seconds,
            }
            for s in stats}
        if dropped:
            out["_dropped_workers"] = dropped
        return out

    @property
    def dispatch_rate_msgs_per_s(self) -> float:
        """Manager ASSIGN throughput over the whole job (the §V message
        wall caps this at ``1 / msg_overhead_s`` per coordinator)."""
        if self.job_seconds <= 0:
            return 0.0
        return self.messages_sent / self.job_seconds

    @property
    def shard_dispatch_rates_msgs_per_s(self) -> list[float]:
        """Per-manager-shard ASSIGN throughput (empty unless the job ran
        with a sharded coordinator)."""
        if self.job_seconds <= 0:
            return [0.0 for _ in self.shard_messages]
        return [m / self.job_seconds for m in self.shard_messages]

    def to_record(self) -> dict[str, Any]:
        """Flat JSON-able summary of the run for BENCH artifacts.

        Everything here is deterministic for a fixed job spec on the sim
        backend.  On the live backends the counts and ``dispatch_digest``
        stay deterministic (fault-free), while ``job_seconds``, the busy
        quantiles, the dispatch rates, and the per-worker aggregates are
        wall-clock measurements — the bench engine splits them
        accordingly.
        """
        return {
            "backend": self.backend,
            "job_seconds": self.job_seconds,
            "tasks_completed": len(self.completed_ids),
            "n_results": len(self.results),
            "messages_sent": self.messages_sent,
            "n_batches": len(self.batches),
            "dispatch_digest": self.dispatch_digest,
            "reassigned_tasks": self.reassigned_tasks,
            "speculated": self.speculated,
            "extra_messages": self.extra_messages,
            "wasted_duplicate_s": self.wasted_seconds,
            **({"workers_added": self.workers_added,
                "workers_retired": self.workers_retired}
               if self.workers_added or self.workers_retired else {}),
            "failed_workers": [str(w) for w in self.failed_workers],
            "n_task_failures": len(self.failures),
            "n_workers": len(self.worker_stats),
            "workers_used": sum(1 for s in self.worker_stats.values()
                                if s.tasks_completed > 0),
            "busy_total_s": sum(self.worker_busy),
            "median_worker_busy_s": self.median_worker_busy,
            "worker_time_span_s": self.worker_time_span,
            "worker_busy_quantiles_s": self.busy_quantiles(),
            "wait_total_s": sum(self.worker_wait),
            "worker_wait_quantiles_s": self.wait_quantiles(),
            "dispatch_rate_msgs_per_s": self.dispatch_rate_msgs_per_s,
            **({"n_manager_shards": len(self.shard_messages),
                "shard_messages": list(self.shard_messages),
                "shard_dispatch_rates_msgs_per_s":
                    self.shard_dispatch_rates_msgs_per_s}
               if self.shard_messages else {}),
            # Per-worker attribution capped at the busiest 64 rows —
            # beyond that the table carries a "_dropped_workers" count
            # and the quantiles above summarize the fleet.
            **({"worker_breakdown": self.worker_breakdown()}
               if self.worker_stats else {}),
        }
