"""Pluggable scheduling policies: who gets which tasks, and how many.

The paper's headline result is that *how* tasks are distributed (triples
shape x self-scheduling x tasks-per-message) dominates end-to-end time —
and the companion HPC paper (Weinert et al. 2020) shows these workloads
are heavy-tailed enough that static chunking leaves workers idle behind
stragglers.  This module factors every dispatch *decision* out of
:class:`~repro_torch.runtime.protocol.SchedulerCore` into a
:class:`SchedulingPolicy` object the core delegates to, so dispatch
order and batch size are selectable per job on every backend
(``run_job(..., policy=...)``):

  ``static``
      The paper baseline and the repo's historical behavior: dispatch in
      organizer order, a fixed ``tasks_per_message`` per ASSIGN.
  ``fifo_selfsched``
      Classic self-scheduling at the finest granularity: organizer
      order, ONE task per ASSIGN regardless of ``tasks_per_message``
      (maximum adaptivity, maximum messaging overhead).
  ``sized_lpt``
      Longest-processing-time-first: the queue is re-sorted by a
      per-task cost estimate (``cpu_cost_hint`` when recorded, else a
      :meth:`~repro_torch.core.cost_model.PhaseCostModel.task_seconds`
      estimate, else ``size_bytes`` — for ``store://`` tasks those
      bytes come from the manifest index), fixed-size batches.  The
      classic 4/3-OPT makespan heuristic for heavy-tailed task mixes.
  ``adaptive_chunk``
      Cost-aware guided-self-scheduling/factoring: the queue is cost
      sorted like ``sized_lpt``, and each ASSIGN packs tasks up to a
      per-round cost budget ``remaining_cost / (alpha * P)`` — heavy
      tasks travel alone (LPT-like), the cheap tail packs
      many-per-message, and the budget shrinks geometrically so
      stragglers get small tail chunks.  Its round state is
      checkpointed so a mid-phase resume continues the chunk schedule
      instead of resetting it.
  ``shard_affinity``
      Locality dispatch for store-backed feeds: tasks are grouped into
      *runs* by :func:`locality_key` (the ``store://...#shard=`` id for
      shard/row-range payloads, the task-id directory prefix
      otherwise), each worker is bound to one run and keeps receiving
      consecutive ranges of the same shard until it drains — so the
      PR-4 double-buffered prefetcher stays warm instead of re-decoding
      a different shard on every ASSIGN.

Determinism contract
--------------------
A policy may consult only the core's protocol state (pending queue,
completed set, the asking worker) — never clocks or randomness — so for
a fixed job spec the dispatch log is reproducible.  For the four
order-based policies the *contents* of the i-th ASSIGN are independent
of which worker asks, so the dispatch log is bit-identical across the
threads, processes, and sim backends (the PR-1 invariant).
``shard_affinity`` is the documented exception: batch contents depend
on the asking worker's binding, so the *global interleaving* on the
live backends follows real completion timing — but every batch is
always single-run, the per-seed sim log is still bit-identical, and
exactly-once/checkpoint invariants hold everywhere (see
tests/test_scheduler_properties.py).
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Optional, Sequence, Union

from repro_torch.core.messages import Task

__all__ = ["POLICIES", "POLICY_NAMES", "SchedulingPolicy", "StaticPolicy",
           "FifoSelfSchedPolicy", "SizedLptPolicy", "AdaptiveChunkPolicy",
           "ShardAffinityPolicy", "default_task_cost", "model_task_cost",
           "locality_key", "get_policy"]

#: Fallback worker count for policies that scale with P when the core is
#: built without one (run_job always passes its resolved n_workers; this
#: matches run_job's own default).
DEFAULT_N_WORKERS = 4

CostFn = Callable[[Task], float]


def default_task_cost(task: Task) -> float:
    """Size-signal cost estimate: the explicit per-task compute hint when
    the manifest recorded one, else the task's byte size (for ``store://``
    tasks that is already an index-derived figure — see
    :func:`repro_torch.tracks.segments.segment_tasks_from_store`)."""
    if task.cpu_cost_hint is not None:
        return float(task.cpu_cost_hint)
    return float(task.size_bytes)


def model_task_cost(model, *, nppn: int = 1, nodes: int = 1) -> CostFn:
    """Cost estimator from a :class:`~repro_torch.core.cost_model.PhaseCostModel`:
    isolated-task seconds (I/O at the uncontended per-process rate + CPU
    phase), the same physics the sim backend charges."""
    def cost(task: Task) -> float:
        return model.task_seconds(task.size_bytes, nppn=nppn,
                                  cpu_cost_hint=task.cpu_cost_hint,
                                  nodes=nodes)
    return cost


def locality_key(task: Task) -> str:
    """The shard-locality grouping key for :class:`ShardAffinityPolicy`.

    ``store://<root>#shard=<id>[&rows=a:b]`` payloads group by
    ``<root>#shard=<id>`` (row ranges of one shard share a decode);
    other string payloads and plain task ids fall back to the task-id
    directory prefix, so zip-archive trees group by leaf directory.
    """
    p = task.payload
    if isinstance(p, str) and p.startswith("store://"):
        from repro_torch.store.uri import parse_store_uri
        try:
            root, sel = parse_store_uri(p)
        except ValueError:
            return p
        if "shard" in sel:
            return f"{root}#shard={sel['shard']}"
        return root
    tid = task.task_id
    return tid.rsplit("/", 1)[0] if "/" in tid else tid


class SchedulingPolicy:
    """Owns the pending queue and decides each ASSIGN batch.

    The :class:`~repro_torch.runtime.protocol.SchedulerCore` keeps the
    protocol *ledger* (in-flight, completed, failures, the dispatch
    log); the policy keeps the *queue* and answers
    :meth:`select`.  Stateless policies return ``None`` from
    :meth:`state`; ``adaptive_chunk``/``shard_affinity`` serialize their
    schedule/bindings into the manager checkpoint.
    """

    name = "?"

    def __init__(self, *, tasks_per_message: Optional[int] = None,
                 n_workers: Optional[int] = None,
                 cost_fn: Optional[CostFn] = None):
        self.tasks_per_message = tasks_per_message
        self.n_workers = n_workers
        self.cost_fn = cost_fn
        #: Optional :class:`repro_torch.runtime.speed.WorkerSpeedModel` — set
        #: by the core when speed feedback is enabled; the cost-aware
        #: policies scale their chunk sizes by the asking worker's
        #: measured relative speed.
        self.speed_model = None

    # -- wiring -----------------------------------------------------------

    def configure(self, *, tasks_per_message: int, n_workers: Optional[int],
                  cost_fn: Optional[CostFn]) -> None:
        """Fill unset knobs from the core's job spec (explicit constructor
        arguments win, so a hand-built policy instance keeps its tuning)."""
        if self.tasks_per_message is None:
            self.tasks_per_message = tasks_per_message
        if self.n_workers is None:
            self.n_workers = n_workers
        if self.cost_fn is None:
            self.cost_fn = cost_fn or default_task_cost

    @property
    def _k(self) -> int:
        return max(int(self.tasks_per_message or 1), 1)

    @property
    def _p(self) -> int:
        return max(int(self.n_workers or DEFAULT_N_WORKERS), 1)

    def _rel_speed(self, worker) -> float:
        """The asking worker's measured speed relative to the fleet
        median (1.0 without a speed model or observations)."""
        model = self.speed_model
        return model.relative_speed(worker) if model is not None else 1.0

    # -- queue ------------------------------------------------------------

    def initialize(self, tasks: Sequence[Task]) -> None:
        """(Re)build the queue from ``tasks`` (organizer order)."""
        self._q: deque[Task] = deque(self.order(list(tasks)))

    def order(self, tasks: list[Task]) -> list[Task]:
        """Initial queue order; default keeps the organizer's order."""
        return tasks

    def pending_count(self) -> int:
        return len(self._q)

    def pending_tasks(self) -> list[Task]:
        """Ordered snapshot of the queue (checkpoint observability)."""
        return list(self._q)

    def requeue(self, tasks: Sequence[Task]) -> None:
        """Put re-queued tasks (a dead worker's in-flight work, already
        sorted largest-first by the core) ahead of the rest."""
        self._q.extendleft(reversed(list(tasks)))

    def admit(self, tasks: Sequence[Task]) -> None:
        """Append tasks that arrive mid-run (streaming DAG emission,
        work stolen from a sibling manager shard) at the queue tail, in
        this policy's own order."""
        self._q.extend(self.order(list(tasks)))

    def steal(self, core, k: int) -> list[Task]:
        """Pop up to ``k`` tasks off the queue TAIL for a sibling manager
        shard (work-stealing never touches the head the owner is about
        to dispatch).  Returns them in queue order; stale entries a late
        DONE already completed are dropped, exactly as in :meth:`_pop`."""
        out: list[Task] = []
        while self._q and len(out) < k:
            t = self._q.pop()
            if t.task_id in core.completed:
                continue
            out.append(t)
        out.reverse()
        return out

    def _pop(self, core, k: int) -> list[Task]:
        """Pop up to ``k`` queue-head tasks, skipping stale entries that a
        late DONE already completed."""
        batch: list[Task] = []
        while self._q and len(batch) < k:
            t = self._q.popleft()
            if t.task_id in core.completed:
                continue
            batch.append(t)
        return batch

    # -- decisions --------------------------------------------------------

    def select(self, core, worker) -> list[Task]:
        """The next ASSIGN batch for ``worker`` (empty = nothing to send)."""
        raise NotImplementedError

    def release(self, worker) -> None:
        """``worker`` was declared dead; drop any affinity to it."""

    # -- checkpoint -------------------------------------------------------

    def state(self) -> Optional[dict]:
        """JSON-able mid-run policy state (None = stateless)."""
        return None

    def restore(self, state: dict) -> None:
        """Restore :meth:`state` output after a checkpoint reload."""


class StaticPolicy(SchedulingPolicy):
    """Paper baseline: organizer order, fixed ``tasks_per_message``."""

    name = "static"

    def select(self, core, worker) -> list[Task]:
        return self._pop(core, self._k)


class FifoSelfSchedPolicy(SchedulingPolicy):
    """Classic self-scheduling: organizer order, one task per ASSIGN."""

    name = "fifo_selfsched"

    def select(self, core, worker) -> list[Task]:
        return self._pop(core, 1)


class _CostSortedPolicy(SchedulingPolicy):
    """Shared cost-descending ordering (ties broken by task id so the
    sort — and therefore the dispatch log — is deterministic)."""

    def order(self, tasks: list[Task]) -> list[Task]:
        cost = self.cost_fn or default_task_cost
        return sorted(tasks, key=lambda t: (-cost(t), t.task_id))


class SizedLptPolicy(_CostSortedPolicy):
    """Longest-processing-time-first with fixed-size batches.

    With a speed model attached the batch size scales with the asking
    worker's measured relative speed (always at least one task), so a
    0.25x worker receives a quarter-sized share instead of an equal one.
    """

    name = "sized_lpt"

    def select(self, core, worker) -> list[Task]:
        k = self._k
        rel = self._rel_speed(worker)
        if rel != 1.0:
            k = max(1, int(k * rel + 0.5))
        return self._pop(core, k)


class AdaptiveChunkPolicy(_CostSortedPolicy):
    """Cost-aware guided self-scheduling / factoring.

    Batches are issued in rounds of ``P`` ASSIGNs sharing one *cost
    budget* ``remaining_cost / (alpha * P)`` computed when the round
    opens: each ASSIGN pops queue-head tasks until their summed cost
    estimate reaches the budget (always at least one task).  With the
    queue cost-sorted descending this degenerates to LPT for the heavy
    hitters — a task costing more than the budget travels alone — while
    the long tail of cheap tasks packs many-per-message, amortizing the
    manager's serial send and the poll latency that a
    ``tasks_per_message=1`` baseline pays per task.  As the queue
    drains the budget shrinks geometrically, so stragglers only ever
    receive small tail chunks (Hummel et al.'s *factoring*, keyed on
    cost instead of count because the workloads are heavy-tailed).

    The open round (budget + ASSIGNs left) is part of :meth:`state`,
    so a manager restart resumes the *schedule*, not just the task
    ledger — a restored job keeps issuing the checkpointed budget
    instead of re-opening a round from the shrunken queue.
    """

    name = "adaptive_chunk"

    def __init__(self, *, alpha: float = 2.0, **kw):
        super().__init__(**kw)
        if alpha <= 0:
            raise ValueError("alpha must be > 0")
        self.alpha = alpha
        self._budget: Optional[float] = None
        self._round_left = 0

    def initialize(self, tasks: Sequence[Task]) -> None:
        super().initialize(tasks)
        cost = self.cost_fn or default_task_cost
        self._rem_cost = float(sum(cost(t) for t in self._q))

    def requeue(self, tasks: Sequence[Task]) -> None:
        super().requeue(tasks)
        cost = self.cost_fn or default_task_cost
        self._rem_cost += float(sum(cost(t) for t in tasks))
        if tasks:
            # Policy-aware re-queue placement: a dead worker's chunk
            # re-enters the *factoring schedule*, not just the queue —
            # closing the round re-computes the budget from the grown
            # remaining cost on the next ASSIGN, so the lost work is
            # re-spread across the fleet instead of riding out the old
            # (now undersized) budget.
            self._budget = None
            self._round_left = 0

    def admit(self, tasks: Sequence[Task]) -> None:
        super().admit(tasks)
        cost = self.cost_fn or default_task_cost
        self._rem_cost += float(sum(cost(t) for t in tasks))

    def steal(self, core, k: int) -> list[Task]:
        out = super().steal(core, k)
        cost = self.cost_fn or default_task_cost
        self._rem_cost = max(
            self._rem_cost - float(sum(cost(t) for t in out)), 0.0)
        return out

    def select(self, core, worker) -> list[Task]:
        cost = self.cost_fn or default_task_cost
        if self._round_left <= 0 or self._budget is None:
            self._budget = self._rem_cost / (self.alpha * self._p)
            self._round_left = self._p
        # Speed-fed sizing: a slow worker's ASSIGN gets a proportionally
        # smaller cost budget (it still always receives one task).
        budget = self._budget * self._rel_speed(worker)
        batch: list[Task] = []
        batch_cost = 0.0
        while self._q and (not batch or batch_cost < budget):
            t = self._q.popleft()
            self._rem_cost -= float(cost(t))
            if t.task_id in core.completed:   # stale re-queue of late DONE
                continue
            batch.append(t)
            batch_cost += float(cost(t))
        self._rem_cost = max(self._rem_cost, 0.0)
        self._round_left -= 1
        return batch

    def state(self) -> Optional[dict]:
        if self._budget is None:
            return None
        return {"budget": float(self._budget),
                "round_left": int(self._round_left)}

    def restore(self, state: dict) -> None:
        self._budget = float(state["budget"])
        self._round_left = int(state["round_left"])


class ShardAffinityPolicy(SchedulingPolicy):
    """Keep each worker on consecutive ranges of one shard.

    The queue is a sequence of *runs* — one deque per
    :func:`locality_key`, in organizer first-appearance order.  A
    worker serves its bound run until the run drains, then binds the
    first nonempty run no live worker owns.  When every nonempty run is
    owned by someone else (more workers than shards, or a tail
    imbalance), the worker *steals* a batch from the first nonempty run
    without rebinding — progress is never blocked on affinity.  Every
    ASSIGN batch therefore stays within a single run, which is the
    invariant the store reader's decode cache (and the prefetcher
    behind it) monetizes.
    """

    name = "shard_affinity"

    def initialize(self, tasks: Sequence[Task]) -> None:
        self._runs: dict[str, deque[Task]] = {}
        self._order: list[str] = []
        self._count = 0
        if not hasattr(self, "_bound"):
            self._bound: dict[str, str] = {}   # str(worker) -> run key
        if not hasattr(self, "_orphans"):
            # Runs released by a dead worker, oldest first: the next
            # worker asking for a binding adopts the orphaned run (its
            # requeued head tasks carry the locality the dead worker's
            # prefetcher had warmed) before opening a fresh run.
            self._orphans: list[str] = []
        for t in tasks:
            key = locality_key(t)
            if key not in self._runs:
                self._runs[key] = deque()
                self._order.append(key)
            self._runs[key].append(t)
            self._count += 1

    def pending_count(self) -> int:
        return self._count

    def pending_tasks(self) -> list[Task]:
        out: list[Task] = []
        for key in self._order:
            out.extend(self._runs[key])
        return out

    def requeue(self, tasks: Sequence[Task]) -> None:
        for t in reversed(list(tasks)):
            key = locality_key(t)
            if key not in self._runs:
                self._runs[key] = deque()
                self._order.append(key)
            self._runs[key].appendleft(t)
            self._count += 1

    def admit(self, tasks: Sequence[Task]) -> None:
        for t in tasks:
            key = locality_key(t)
            if key not in self._runs:
                self._runs[key] = deque()
                self._order.append(key)
            self._runs[key].append(t)
            self._count += 1

    def steal(self, core, k: int) -> list[Task]:
        # Steal the tail of the LAST nonempty run so the victim keeps
        # its warm head runs; whole-run transfer preserves the
        # single-run-per-ASSIGN invariant on the thief's side too.
        out: list[Task] = []
        for key in reversed(self._order):
            run = self._runs[key]
            while run and len(out) < k:
                t = run.pop()
                self._count -= 1
                if t.task_id in core.completed:
                    continue
                out.append(t)
            if out:
                break
        out.reverse()
        return out

    def _pop_run(self, core, key: str) -> list[Task]:
        run = self._runs[key]
        batch: list[Task] = []
        while run and len(batch) < self._k:
            t = run.popleft()
            self._count -= 1
            if t.task_id in core.completed:
                continue
            batch.append(t)
        return batch

    def select(self, core, worker) -> list[Task]:
        w = str(worker)
        key = self._bound.get(w)
        if key is None or not self._runs.get(key):
            taken = {k for ww, k in self._bound.items()
                     if ww != w and self._runs.get(k)}
            # Orphaned runs first: re-bind a dead worker's locality run
            # to the next asking (neighbor-warm) worker instead of
            # leaving its requeued head behind fresh runs.
            key = None
            while self._orphans:
                cand = self._orphans.pop(0)
                if self._runs.get(cand) and cand not in taken:
                    key = cand
                    break
            if key is None:
                key = next((k for k in self._order
                            if self._runs[k] and k not in taken), None)
            if key is not None:
                self._bound[w] = key
            else:
                # Everything nonempty is owned: steal, don't starve.
                key = next((k for k in self._order if self._runs[k]), None)
                if key is None:
                    return []
        return self._pop_run(core, key)

    def release(self, worker) -> None:
        # Recorded even if the run looks empty right now: the core
        # requeues the dead worker's in-flight tasks immediately after
        # this call, refilling the run; select() discards an orphan
        # entry that is still empty when it comes up.
        key = self._bound.pop(str(worker), None)
        if key is not None and key not in self._orphans:
            self._orphans.append(key)

    def state(self) -> Optional[dict]:
        if not self._bound and not self._orphans:
            return None
        return {"bindings": dict(self._bound),
                "orphans": list(self._orphans)}

    def restore(self, state: dict) -> None:
        self._bound = {str(w): str(k)
                       for w, k in state.get("bindings", {}).items()}
        self._orphans = [str(k) for k in state.get("orphans", [])]


POLICIES: dict[str, type[SchedulingPolicy]] = {
    cls.name: cls for cls in (
        StaticPolicy, FifoSelfSchedPolicy, SizedLptPolicy,
        AdaptiveChunkPolicy, ShardAffinityPolicy)}

#: Stable public ordering (docs, CLIs, test parametrization).
POLICY_NAMES = ("static", "fifo_selfsched", "sized_lpt", "adaptive_chunk",
                "shard_affinity")


def get_policy(policy: Union[str, SchedulingPolicy, None], *,
               tasks_per_message: int = 1,
               n_workers: Optional[int] = None,
               cost_fn: Optional[CostFn] = None) -> SchedulingPolicy:
    """Resolve a policy name (or pass through a configured instance) and
    fill its unset knobs from the job spec."""
    if policy is None:
        policy = "static"
    if isinstance(policy, str):
        try:
            cls = POLICIES[policy]
        except KeyError:
            raise ValueError(f"unknown scheduling policy {policy!r}; "
                             f"choose from {list(POLICY_NAMES)}") from None
        policy = cls()
    elif not isinstance(policy, SchedulingPolicy):
        raise TypeError(f"policy must be a name or SchedulingPolicy, "
                        f"got {type(policy).__name__}")
    policy.configure(tasks_per_message=tasks_per_message,
                     n_workers=n_workers, cost_fn=cost_fn)
    return policy
