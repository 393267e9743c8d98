"""Back-compat wrapper: the live manager/worker runtime moved to
``repro_torch.runtime`` (one protocol core, pluggable thread/process/sim
backends).  This module keeps the original API surface:

  * :class:`Manager` / :func:`run_self_scheduled` — the threaded runtime,
    now a thin shell over ``repro_torch.runtime.run_job(backend="threads")``.
  * :class:`ManagerCheckpoint`, :class:`WorkerStats`, :class:`JobResult`
    (an alias of the unified :class:`~repro_torch.runtime.result.RunResult`).
  * :func:`worker_loop` — the shared worker loop (the old ``Worker``
    thread class is gone; transports manage their own workers).

New code should call :func:`repro_torch.runtime.run_job` instead.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Optional, Sequence

from repro_torch.core.messages import Task
from repro_torch.runtime.protocol import (
    DEFAULT_POLL_INTERVAL_S, ManagerCheckpoint, SchedulerCore, drive)
from repro_torch.runtime.result import RunResult, WorkerStats
from repro_torch.runtime.transports import ThreadTransport, worker_loop

JobResult = RunResult

__all__ = ["DEFAULT_POLL_INTERVAL_S", "JobResult", "Manager",
           "ManagerCheckpoint", "WorkerStats", "run_self_scheduled",
           "worker_loop"]


class Manager:
    """The managing process of §II.D over the threads backend.

    Thin wrapper: all protocol state lives in a shared
    :class:`~repro_torch.runtime.protocol.SchedulerCore`; ``completed`` and
    ``pending`` delegate to it for checkpoint-surgery compatibility.
    """

    def __init__(self, tasks: Sequence[Task],
                 n_workers: int,
                 fn: Callable[[Task], Any],
                 organization: str = "largest_first",
                 tasks_per_message: int = 1,
                 poll_interval: float = DEFAULT_POLL_INTERVAL_S,
                 failure_timeout: Optional[float] = None,
                 checkpoint: Optional[ManagerCheckpoint] = None,
                 worker_fail_after: Optional[dict[str, int]] = None,
                 organize_seed: int = 0):
        if n_workers < 1:
            raise ValueError("need at least one worker")
        self.core = SchedulerCore(
            tasks, organization=organization,
            tasks_per_message=tasks_per_message,
            checkpoint=checkpoint, organize_seed=organize_seed)
        self.n_workers = n_workers
        self.fn = fn
        self.tasks_per_message = tasks_per_message
        self.poll_interval = poll_interval
        self.failure_timeout = failure_timeout
        self.worker_fail_after = worker_fail_after or {}

    # -- state passthrough (checkpoint surgery, tests) ---------------------

    @property
    def completed(self) -> set[str]:
        return self.core.completed

    @completed.setter
    def completed(self, value: set[str]) -> None:
        self.core.completed = set(value)

    @property
    def pending(self) -> deque[Task]:
        return self.core.pending

    @pending.setter
    def pending(self, value: Sequence[Task]) -> None:
        self.core.pending = deque(value)

    @property
    def messages_sent(self) -> int:
        return self.core.messages_sent

    @property
    def reassigned(self) -> int:
        return self.core.reassigned

    def checkpoint(self) -> ManagerCheckpoint:
        return self.core.checkpoint()

    # -- main loop ----------------------------------------------------------

    def run(self) -> JobResult:
        heartbeat = (self.failure_timeout / 3
                     if self.failure_timeout is not None else None)
        transport = ThreadTransport(
            self.n_workers, self.fn,
            batch_fn=getattr(self.fn, "process_batch", None),
            poll_interval=self.poll_interval,
            heartbeat_interval=heartbeat,
            worker_fail_after=self.worker_fail_after)
        return drive(self.core, transport,
                     poll_interval=self.poll_interval,
                     failure_timeout=self.failure_timeout,
                     backend="threads")


def run_self_scheduled(tasks: Sequence[Task], n_workers: int,
                       fn: Callable[[Task], Any], **kwargs: Any) -> JobResult:
    """Convenience wrapper: build a Manager and run the job."""
    return Manager(tasks, n_workers, fn, **kwargs).run()
