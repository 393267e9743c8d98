"""Transport-agnostic manager/worker self-scheduling protocol core.

The paper's protocol (§II.D) used to be implemented three separate times
(threaded runtime, discrete-event simulator, workflow driver).  This module
is the single source of truth for every *decision* the managing process
makes; the backends supply only the physics of message delivery:

  * :class:`SchedulerCore` — exactly-once accounting by task id, failure
    detection + re-queue, and checkpoint serialization.  Dispatch order
    and batch size are delegated to a pluggable
    :class:`~repro_torch.runtime.policies.SchedulingPolicy` (default
    ``static`` = the paper baseline: organizer order, fixed
    tasks-per-message — Fig 7).  Driven by the threads and processes
    transports (transports.py) and by the discrete-event engine
    (sim.py), so all three backends make bit-identical batching
    decisions for any order-based policy.
  * :func:`drive` — the real-time manager loop of §II.D (eager initial
    allocation, drain-then-poll, 0.3 s default poll) run against any
    :class:`~repro_torch.runtime.transports.Transport`.

Perf note: the policy queues are :class:`collections.deque` s and
per-worker in-flight sets are ``set``s — the previous list-based manager
paid O(n²) ``list.pop(0)`` across a job (see benchmarks/dispatch_bench.py).
"""

from __future__ import annotations

import json
import time
from typing import Any, Callable, Optional, Sequence, Union

from repro_torch.core.messages import Message, MessageKind, Task, get_organizer
from repro_torch.runtime.policies import SchedulingPolicy, get_policy
from repro_torch.runtime.result import RunResult, WorkerStats

DEFAULT_POLL_INTERVAL_S = 0.3

__all__ = ["DEFAULT_POLL_INTERVAL_S", "ManagerCheckpoint", "SchedulerCore",
           "ShardedCore", "drive", "manager_shard",
           "partition_tasks_by_locality"]


class ManagerCheckpoint:
    """JSON-serializable manager state for restart (beyond-paper).

    Restart consumes ``completed`` (the restored scheduler rebuilds its
    queue from the full task list minus the completed ids, so in-flight
    tasks at checkpoint time are re-run) and ``policy_state`` (the
    scheduling policy's mid-run state — e.g. ``adaptive_chunk``'s open
    round — so a resume continues the chunk schedule instead of
    resetting it).  ``pending_ids`` is written for observability (how
    much was left) — edits to it are not read back.  ``frontier`` is
    the streaming-DAG per-node frontier (the DAG slice of the port):
    which original tasks each node has completed, which admitted tasks
    are still outstanding (serialized in full, because streamed tasks
    cannot be rebuilt from a static task list), and each streaming
    edge's emitter state — enough to resume a DAG run mid-stream.
    Checkpoints written before the policy/DAG layers existed load fine
    (both fields default to None).
    """

    def __init__(self, completed: set, pending_ids: list,
                 policy_state: Optional[dict] = None,
                 frontier: Optional[dict] = None,
                 runtime_state: Optional[dict] = None):
        self.completed = set(completed)
        self.pending_ids = list(pending_ids)
        self.policy_state = (dict(policy_state)
                             if policy_state is not None else None)
        self.frontier = dict(frontier) if frontier is not None else None
        #: Feedback-loop state beyond the task ledger: the worker speed
        #: model (``"speed"``) and the elastic fleet controller
        #: (``"fleet"``) — restored on resume so a restarted manager
        #: keeps its learned fleet profile and scaling history.
        self.runtime_state = (dict(runtime_state)
                              if runtime_state is not None else None)

    def dumps(self) -> str:
        doc: dict = {"completed": sorted(self.completed),
                     "pending": self.pending_ids}
        if self.policy_state is not None:
            doc["policy"] = self.policy_state
        if self.frontier is not None:
            doc["frontier"] = self.frontier
        if self.runtime_state is not None:
            doc["runtime"] = self.runtime_state
        return json.dumps(doc)

    @classmethod
    def loads(cls, s: str) -> "ManagerCheckpoint":
        d = json.loads(s)
        return cls(set(d["completed"]), list(d["pending"]),
                   policy_state=d.get("policy"),
                   frontier=d.get("frontier"),
                   runtime_state=d.get("runtime"))


def manager_shard(worker: Any, n_workers: int, n_shards: int) -> int:
    """Contiguous-block worker -> manager-shard map.

    Shared by the live :class:`ShardedCore` facade and the sim's
    per-shard message clocks so both backends agree which coordinator
    a worker reports to.  Accepts the transports' ``"w<i>"`` string ids
    and the sim's integer worker indices.
    """
    if n_shards <= 1:
        return 0
    if isinstance(worker, int):
        i = worker
    else:
        digits = "".join(ch for ch in str(worker) if ch.isdigit())
        i = int(digits) if digits else 0
    n = max(int(n_workers), 1)
    i = min(max(i, 0), n - 1)
    return min(i * n_shards // n, n_shards - 1)


def partition_tasks_by_locality(tasks: Sequence[Task],
                                n_shards: int) -> list[list[Task]]:
    """Split tasks into ``n_shards`` disjoint partitions by locality run.

    Tasks are grouped into runs by
    :func:`repro_torch.runtime.policies.locality_key` in first-appearance
    order, and whole runs are dealt round-robin across shards — a
    locality run never splits across managers, so ``shard_affinity``'s
    single-run-per-ASSIGN invariant survives manager sharding.  Order
    within each partition preserves the input order.
    """
    if n_shards <= 1:
        return [list(tasks)]
    from repro_torch.runtime.policies import locality_key
    runs: dict[str, list[Task]] = {}
    order: list[str] = []
    for t in tasks:
        key = locality_key(t)
        if key not in runs:
            runs[key] = []
            order.append(key)
        runs[key].append(t)
    parts: list[list[Task]] = [[] for _ in range(n_shards)]
    for i, key in enumerate(order):
        parts[i % n_shards].extend(runs[key])
    return parts


class _PendingView:
    """Deque-ish read view over the policy's queue (the policy owns the
    storage; callers keep using ``core.pending`` for truthiness, length,
    and iteration exactly as when it was a plain deque)."""

    __slots__ = ("_policy",)

    def __init__(self, policy: SchedulingPolicy):
        self._policy = policy

    def __len__(self) -> int:
        return self._policy.pending_count()

    def __bool__(self) -> bool:
        return self._policy.pending_count() > 0

    def __iter__(self):
        return iter(self._policy.pending_tasks())

    def __repr__(self) -> str:
        return f"<pending {len(self)} tasks>"


class SchedulerCore:
    """Pure protocol state machine — no clocks, no transports, no threads.

    Every backend funnels its manager-side events through the same five
    calls: :meth:`next_batch`, :meth:`on_done`, :meth:`on_failed`,
    :meth:`mark_dead`, :meth:`checkpoint`.
    """

    def __init__(self, tasks: Sequence[Task], *,
                 organization: str = "largest_first",
                 tasks_per_message: int = 1,
                 checkpoint: Optional[ManagerCheckpoint] = None,
                 organize_seed: int = 0,
                 policy: Union[str, SchedulingPolicy, None] = None,
                 n_workers: Optional[int] = None,
                 speculative: bool = False,
                 speculation_max_copies: int = 2,
                 speed_model: Optional[Any] = None,
                 fleet: Optional[Any] = None):
        if tasks_per_message < 1:
            raise ValueError("tasks_per_message must be >= 1")
        if speculation_max_copies < 1:
            raise ValueError("speculation_max_copies must be >= 1")
        organizer = get_organizer(organization)
        if organization == "random":
            ordered = organizer(tasks, seed=organize_seed)  # type: ignore[call-arg]
        else:
            ordered = organizer(tasks)
        self._by_id = {t.task_id: t for t in ordered}
        if len(self._by_id) != len(ordered):
            raise ValueError("task ids must be unique")
        self.tasks_per_message = tasks_per_message
        self.completed: set[str] = set()
        if checkpoint is not None:
            self.completed |= checkpoint.completed & set(self._by_id)
            ordered = [t for t in ordered if t.task_id not in self.completed]
        self.policy = get_policy(policy, tasks_per_message=tasks_per_message,
                                 n_workers=n_workers)
        self.policy.initialize(ordered)
        if checkpoint is not None and checkpoint.policy_state is not None \
                and "shards" not in checkpoint.policy_state:
            # A {"shards": [...]} state belongs to a ShardedCore; a plain
            # core restoring such a checkpoint keeps its fresh schedule.
            self.policy.restore(checkpoint.policy_state)
        self.in_flight: dict[Any, set[str]] = {}
        self.dead: set = set()
        self.failures: dict[str, str] = {}
        self.messages_sent = 0
        self.reassigned = 0
        self.batches: list[tuple[str, ...]] = []
        # Speculation (MapReduce-style backup copies) as a protocol
        # concern: any backend whose queue drained may ask speculate()
        # for a duplicate of the longest-in-flight task.  Speculative
        # sends are accounted in extra_messages, never in
        # messages_sent/batches — the dispatch digest stays the primary
        # schedule's, identical across backends.
        self.speculative = bool(speculative)
        self.speculation_max_copies = int(speculation_max_copies)
        self.speculated = 0
        self.extra_messages = 0
        self.wasted_seconds = 0.0
        self._copies: dict[str, int] = {}
        self._assign_seq: dict[str, int] = {}
        self._next_seq = 0
        # Feedback loop: per-worker speed model consulted by the
        # cost-aware policies, and the elastic fleet controller the
        # backend drives (both optional; both checkpointed).
        self.speed_model = speed_model
        if speed_model is not None:
            self.policy.speed_model = speed_model
        self.fleet = fleet
        if checkpoint is not None and checkpoint.runtime_state is not None:
            rs = checkpoint.runtime_state
            if speed_model is not None and rs.get("speed"):
                speed_model.restore(rs["speed"])
            if fleet is not None and rs.get("fleet"):
                fleet.restore(rs["fleet"])
        #: Optional :class:`repro_torch.obs.Tracer`; every lifecycle
        #: decision below emits an instant when attached (``attach_tracer``).
        self.tracer = None
        self._trace_shard = 0

    def attach_tracer(self, tracer, shard: int = 0) -> None:
        """Attach an observability tracer; emits a ``queued`` instant for
        every task already pending, so the trace's lifecycle ledger is
        complete from t0.  The backend binds the tracer's clock BEFORE
        attaching (the sim rebinds to its virtual clock)."""
        self.tracer = tracer
        self._trace_shard = shard
        if tracer is not None:
            ts = tracer.clock()
            raw, n = tracer.raw, 0
            for t in self.pending:
                raw((ts, -1.0, "queued", "task", shard, t.task_id, None))
                n += 1
            tracer.emitted += n

    # -- queries -----------------------------------------------------------

    @property
    def pending(self) -> _PendingView:
        """The policy-owned queue, as a deque-ish view (len/bool/iter)."""
        return _PendingView(self.policy)

    @pending.setter
    def pending(self, value: Sequence[Task]) -> None:
        """Replace the queue wholesale (checkpoint surgery in tests/tools);
        the policy re-applies its own ordering to the new contents."""
        self.policy.initialize(list(value))

    @property
    def total(self) -> int:
        return len(self._by_id)

    @property
    def done(self) -> bool:
        return len(self.completed) + len(self.failures) >= self.total

    def idle(self, worker: Any) -> bool:
        return not self.in_flight.get(worker)

    def task(self, task_id: str) -> Task:
        return self._by_id[task_id]

    # -- protocol events ---------------------------------------------------

    def next_batch(self, worker: Any) -> tuple[Task, ...]:
        """The scheduling policy's next ASSIGN batch for ``worker``."""
        if worker in self.dead:
            return ()
        batch = self.policy.select(self, worker)
        if not batch:
            return ()
        ids = tuple(t.task_id for t in batch)
        self.in_flight.setdefault(worker, set()).update(ids)
        self.messages_sent += 1
        self.batches.append(ids)
        for tid in ids:
            # One primary copy per assignment (a re-queued task starts a
            # fresh copy budget — the dead owner's copy is gone), stamped
            # with the send sequence so speculation can find the batch
            # that has been in flight longest without consulting a clock.
            self._copies[tid] = 1
            self._assign_seq[tid] = self._next_seq
            self._next_seq += 1
        tr = self.tracer
        if tr is not None:
            ts = tr.clock()
            shard = self._trace_shard
            raw = tr.raw
            for tid in ids:
                raw((ts, -1.0, "assigned", "task", worker, tid, shard))
            tr.emitted += len(ids)
        return tuple(batch)

    def speculate(self, worker: Any) -> tuple[Task, ...]:
        """A backup copy of the longest-in-flight incomplete task for an
        idle worker at the tail (MapReduce-style speculation, lifted
        here from the sim so every backend shares the decision rule).

        Only fires when speculation is enabled AND the queue is empty —
        a pending task always beats a duplicate.  The victim is the
        eligible in-flight task with the oldest assignment sequence
        (ties broken by task id, so the choice is deterministic), held
        by another live worker, with fewer than
        ``speculation_max_copies`` copies outstanding.  First DONE wins
        via the ``completed`` set exactly as for primary copies; the
        send is accounted in ``extra_messages``, never in
        ``messages_sent``/``batches``.
        """
        if not self.speculative or worker in self.dead or self.pending:
            return ()
        mine = self.in_flight.get(worker) or set()
        best: Optional[str] = None
        best_seq = 0
        for w, ids in self.in_flight.items():
            if w == worker or w in self.dead:
                continue
            for tid in ids:
                if tid in self.completed or tid in self.failures \
                        or tid in mine:
                    continue
                if self._copies.get(tid, 1) >= self.speculation_max_copies:
                    continue
                seq = self._assign_seq.get(tid, -1)
                if best is None or (seq, tid) < (best_seq, best):
                    best, best_seq = tid, seq
        if best is None:
            return ()
        self._copies[best] = self._copies.get(best, 1) + 1
        self.in_flight.setdefault(worker, set()).add(best)
        self.speculated += 1
        self.extra_messages += 1
        tr = self.tracer
        if tr is not None:
            tr.raw((tr.clock(), -1.0, "speculated", "sched", worker, best,
                    self._trace_shard))
            tr.emitted += 1
        return (self._by_id[best],)

    def observe_speed(self, worker: Any, task_ids: Sequence[str],
                      busy_seconds: float) -> None:
        """Feed the speed model one finished batch: the policy's own
        cost estimate for its tasks over the worker's reported busy
        seconds.  No-op without a model (the default), so dispatch
        stays measurement-free unless feedback was opted into."""
        model = self.speed_model
        if model is None or busy_seconds <= 0.0:
            return
        from repro_torch.runtime.policies import default_task_cost
        cost = self.policy.cost_fn or default_task_cost
        est = 0.0
        for tid in task_ids:
            t = self._by_id.get(tid)
            if t is not None:
                est += float(cost(t))
        if est > 0.0:
            model.observe(worker, est, busy_seconds)

    def record_waste(self, worker: Any, seconds: float) -> None:
        """Account duplicate-execution seconds (a DONE for an already
        completed task — a speculated or falsely-redispatched copy that
        lost the race).  Pure accounting; surfaces in BENCH records."""
        if seconds > 0.0:
            self.wasted_seconds += float(seconds)

    def on_done(self, worker: Any, task_ids: Sequence[str],
                results: Optional[Sequence[Any]] = None) -> list[str]:
        """Record a DONE message; returns the ids completed for the first
        time (exactly-once: a late DONE from a 'dead' worker is a no-op).
        ``results`` (aligned with ``task_ids``) is ignored here — the
        streaming-DAG coordinator overrides this hook and feeds them to
        its edge emitters; the sim backend passes None."""
        fresh: list[str] = []
        fl = self.in_flight.get(worker)
        for tid in task_ids:
            if fl is not None:
                fl.discard(tid)
            if tid in self.completed:
                continue
            # A surviving copy's success supersedes a lost copy's failure
            # (only reachable with speculation: one copy crashed, the
            # other finished the work).
            self.failures.pop(tid, None)
            self.completed.add(tid)
            fresh.append(tid)
        tr = self.tracer
        if tr is not None and fresh:
            ts = tr.clock()
            raw = tr.raw
            for tid in fresh:
                raw((ts, -1.0, "done", "task", worker, tid, None))
            tr.emitted += len(fresh)
        return fresh

    def admit(self, tasks: Sequence[Task]) -> list[Task]:
        """Register tasks that arrive after construction (streaming DAG
        emission, work stolen from a sibling manager shard).  Ids already
        known — pending, in flight, or completed — are dropped, so a
        re-emitted duplicate is a no-op and exactly-once extends across
        dynamic admission.  Returns the tasks actually admitted."""
        fresh: list[Task] = []
        for t in tasks:
            if t.task_id in self._by_id or t.task_id in self.completed:
                continue
            self._by_id[t.task_id] = t
            fresh.append(t)
        if fresh:
            self.policy.admit(fresh)
            tr = self.tracer
            if tr is not None:
                ts = tr.clock()
                shard = self._trace_shard
                raw = tr.raw
                for t in fresh:
                    raw((ts, -1.0, "queued", "task", shard, t.task_id,
                         None))
                tr.emitted += len(fresh)
        return fresh

    def surrender(self, k: int) -> list[Task]:
        """Give up to ``k`` pending queue-tail tasks to a sibling manager
        shard (work-stealing).  Surrendered tasks leave this core's
        ledger entirely — ``total`` shrinks — so per-shard exactly-once
        accounting stays exact; the thief re-registers them via
        :meth:`admit`."""
        stolen = self.policy.steal(self, k)
        for t in stolen:
            del self._by_id[t.task_id]
        return stolen

    def on_failed(self, worker: Any, task_ids: Sequence[str],
                  error: Optional[str] = None) -> None:
        fl = self.in_flight.get(worker)
        recorded: list[str] = []
        for tid in task_ids:
            if fl is not None:
                fl.discard(tid)
            if tid in self.completed:
                # A speculative copy crashing AFTER another copy's DONE
                # is a no-op — the task is done; a non-idempotent fn's
                # losing duplicate (its input already consumed) must not
                # poison the ledger.  Mirrors duplicate-DONE suppression.
                continue
            if any(tid in ids for w, ids in self.in_flight.items()
                   if w != worker and w not in self.dead):
                # Another live copy is still running this task — it may
                # yet succeed (and with speculation the crashed copy is
                # often the duplicate racing a non-idempotent fn).  Only
                # the LAST outstanding copy's failure is recorded.
                continue
            self.failures[tid] = error or "unknown"
            recorded.append(tid)
        task_ids = recorded
        tr = self.tracer
        if tr is not None and task_ids:
            ts = tr.clock()
            raw = tr.raw
            for tid in task_ids:
                raw((ts, -1.0, "failed", "task", worker, tid, error))
            tr.emitted += len(task_ids)

    def mark_dead(self, worker: Any) -> list[Task]:
        """Declare a worker dead and re-queue its in-flight tasks,
        largest-first, ahead of the rest of the queue (the policy may
        refine placement — e.g. shard_affinity re-inserts each task at
        the front of its locality run).  Idempotent."""
        self.dead.add(worker)
        self.policy.release(worker)
        ids = self.in_flight.pop(worker, set())
        requeue = [self._by_id[tid] for tid in ids
                   if tid not in self.completed and tid not in self.failures]
        requeue.sort(key=lambda t: (-t.size_bytes, t.task_id))
        self.policy.requeue(requeue)
        self.reassigned += len(requeue)
        tr = self.tracer
        if tr is not None and requeue:
            ts = tr.clock()
            shard = self._trace_shard
            raw = tr.raw
            for t in requeue:
                raw((ts, -1.0, "requeued", "task", worker, t.task_id,
                     shard))
            tr.emitted += len(requeue)
        return requeue

    # -- checkpoint --------------------------------------------------------

    def checkpoint(self) -> ManagerCheckpoint:
        return ManagerCheckpoint(
            set(self.completed), [t.task_id for t in self.pending],
            policy_state=self.policy.state(),
            runtime_state=self._runtime_state())

    def _runtime_state(self) -> Optional[dict]:
        runtime: dict = {}
        if self.speed_model is not None:
            st = self.speed_model.state()
            if st:
                runtime["speed"] = st
        if self.fleet is not None:
            st = self.fleet.state()
            if st:
                runtime["fleet"] = st
        return runtime or None


class _GroupPendingView:
    """Union read view over several cores' pending queues."""

    __slots__ = ("_cores",)

    def __init__(self, cores: Sequence[SchedulerCore]):
        self._cores = cores

    def __len__(self) -> int:
        return sum(len(c.pending) for c in self._cores)

    def __bool__(self) -> bool:
        return any(c.pending for c in self._cores)

    def __iter__(self):
        for c in self._cores:
            yield from c.pending

    def __repr__(self) -> str:
        return f"<pending {len(self)} tasks over {len(self._cores)} shards>"


class ShardedCore:
    """N :class:`SchedulerCore` shards over disjoint task partitions,
    behind the single-core facade every backend already drives.

    The paper's §V scaling wall is ONE coordinator serializing every
    ASSIGN — adding workers stops helping once the manager's message
    rate saturates.  Sharding the manager splits the pending queue by
    locality run (:func:`partition_tasks_by_locality`) into ``n_shards``
    independent decision cores; workers map to shards in contiguous
    blocks (:func:`manager_shard`), so each shard serves a fixed slice
    of the fleet.

    On the live backends all shards run inside the one :func:`drive`
    loop: CPython threads would serialize the decision work on the GIL
    anyway, so what sharding buys is *disjoint decision state* (no
    shared queue, per-shard policy schedules) — the structure an
    N-process manager deployment needs.  The sim backend models the
    physics: each shard owns its own ``msg_overhead_s`` clock, so the
    simulated dispatch rate genuinely scales past one coordinator
    (``bench/scheduling.py``'s scaling-curve cells).

    Work-stealing at the tail: a shard whose partition drains steals
    the tail half of the heaviest sibling's queue
    (:meth:`SchedulerCore.surrender` -> :meth:`SchedulerCore.admit`),
    so a skewed partition never idles a block of workers.
    """

    def __init__(self, tasks: Sequence[Task], *,
                 n_shards: int,
                 n_workers: int,
                 organization: str = "largest_first",
                 tasks_per_message: int = 1,
                 checkpoint: Optional[ManagerCheckpoint] = None,
                 organize_seed: int = 0,
                 policy: Union[str, None] = None,
                 cost_fn: Optional[Callable[[Task], float]] = None,
                 speculative: bool = False,
                 speculation_max_copies: int = 2,
                 speed_model: Optional[Any] = None):
        from repro_torch.runtime.policies import SchedulingPolicy, get_policy
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        if isinstance(policy, SchedulingPolicy):
            raise ValueError("pass a policy NAME with manager sharding; "
                             "each shard needs its own policy instance")
        self.n_shards = n_shards
        self.n_workers = n_workers
        self.tasks_per_message = tasks_per_message
        shard_states: list = [None] * n_shards
        if checkpoint is not None and checkpoint.policy_state is not None:
            st = checkpoint.policy_state.get("shards")
            if isinstance(st, list) and len(st) == n_shards:
                shard_states = st
        self.cores: list[SchedulerCore] = []
        for part, pstate in zip(
                partition_tasks_by_locality(list(tasks), n_shards),
                shard_states):
            ck = None
            if checkpoint is not None:
                # The global completed set intersects down to each
                # shard's own tasks inside SchedulerCore.__init__.  The
                # runtime (speed-model) state rides on the first shard
                # only: the model instance is shared, restore once.
                ck = ManagerCheckpoint(
                    checkpoint.completed, [], policy_state=pstate,
                    runtime_state=(checkpoint.runtime_state
                                   if not self.cores else None))
            self.cores.append(SchedulerCore(
                part, organization=organization,
                tasks_per_message=tasks_per_message, checkpoint=ck,
                organize_seed=organize_seed,
                policy=get_policy(policy,
                                  tasks_per_message=tasks_per_message,
                                  n_workers=n_workers, cost_fn=cost_fn),
                n_workers=n_workers,
                speculative=speculative,
                speculation_max_copies=speculation_max_copies,
                speed_model=speed_model))
        self.speculative = bool(speculative)
        # Elastic scaling needs one coordinator (run_job enforces it);
        # backends discover the controller via this attribute.
        self.fleet = None
        #: Global interleaved dispatch log (per-shard logs live on the
        #: member cores).
        self.batches: list[tuple[str, ...]] = []
        # Streaming-admission routing: locality key -> owning shard,
        # assigned round-robin on first appearance (sticky after).
        self._key_shard: dict[str, int] = {}
        self._next_key_shard = 0
        self.tracer = None

    def attach_tracer(self, tracer) -> None:
        """Attach a tracer to every member core, tagged with its shard
        index (the ``assigned`` instants' shard field is what the
        per-shard dispatch-rate timelines bin)."""
        self.tracer = tracer
        for i, c in enumerate(self.cores):
            c.attach_tracer(tracer, shard=i)

    # -- routing -----------------------------------------------------------

    def shard_of(self, worker: Any) -> int:
        return manager_shard(worker, self.n_workers, self.n_shards)

    def admit(self, tasks: Sequence[Task]) -> list[Task]:
        """Register tasks that arrive mid-run (streaming DAG emission),
        routed to shards by locality key — keys are dealt round-robin on
        first appearance and sticky afterwards, so one locality run
        never splits across managers (the same invariant as the initial
        :func:`partition_tasks_by_locality` cut).  Returns the tasks
        actually admitted (per-shard dedup applies)."""
        from repro_torch.runtime.policies import locality_key
        fresh: list[Task] = []
        for t in tasks:
            key = locality_key(t)
            shard = self._key_shard.get(key)
            if shard is None:
                shard = self._next_key_shard
                self._key_shard[key] = shard
                self._next_key_shard = (shard + 1) % self.n_shards
            fresh.extend(self.cores[shard].admit([t]))
        return fresh

    # -- aggregate queries -------------------------------------------------

    @property
    def pending(self) -> _GroupPendingView:
        return _GroupPendingView(self.cores)

    @property
    def total(self) -> int:
        return sum(c.total for c in self.cores)

    @property
    def completed(self) -> set:
        out: set = set()
        for c in self.cores:
            out |= c.completed
        return out

    @property
    def failures(self) -> dict:
        out: dict = {}
        for c in self.cores:
            out.update(c.failures)
        return out

    @property
    def dead(self) -> set:
        out: set = set()
        for c in self.cores:
            out |= c.dead
        return out

    @property
    def messages_sent(self) -> int:
        return sum(c.messages_sent for c in self.cores)

    @property
    def shard_messages(self) -> list[int]:
        """Per-manager-shard ASSIGN counts (RunResult dispatch rates)."""
        return [c.messages_sent for c in self.cores]

    @property
    def reassigned(self) -> int:
        return sum(c.reassigned for c in self.cores)

    @property
    def speculated(self) -> int:
        return sum(c.speculated for c in self.cores)

    @property
    def extra_messages(self) -> int:
        return sum(c.extra_messages for c in self.cores)

    @property
    def wasted_seconds(self) -> float:
        return sum(c.wasted_seconds for c in self.cores)

    @property
    def done(self) -> bool:
        return all(c.done for c in self.cores)

    def idle(self, worker: Any) -> bool:
        return self.cores[self.shard_of(worker)].idle(worker)

    def task(self, task_id: str) -> Task:
        for c in self.cores:
            try:
                return c.task(task_id)
            except KeyError:
                continue
        raise KeyError(task_id)

    # -- protocol events ---------------------------------------------------

    def next_batch(self, worker: Any) -> tuple[Task, ...]:
        core = self.cores[self.shard_of(worker)]
        batch = core.next_batch(worker)
        if not batch and worker not in core.dead:
            victim = max((c for c in self.cores if c is not core),
                         key=lambda c: len(c.pending), default=None)
            if victim is not None and victim.pending:
                n_avail = len(victim.pending)
                k = min(max(self.tasks_per_message, (n_avail + 1) // 2),
                        n_avail)
                core.admit(victim.surrender(k))
                batch = core.next_batch(worker)
        if batch:
            self.batches.append(tuple(t.task_id for t in batch))
        return batch

    def on_done(self, worker: Any, task_ids: Sequence[str],
                results: Optional[Sequence[Any]] = None) -> list[str]:
        return self.cores[self.shard_of(worker)].on_done(
            worker, task_ids, results)

    def on_failed(self, worker: Any, task_ids: Sequence[str],
                  error: Optional[str] = None) -> None:
        self.cores[self.shard_of(worker)].on_failed(worker, task_ids, error)

    def mark_dead(self, worker: Any) -> list[Task]:
        return self.cores[self.shard_of(worker)].mark_dead(worker)

    def speculate(self, worker: Any) -> tuple[Task, ...]:
        """Backup copy from the worker's own shard (speculation never
        crosses coordinators — the shard already steals siblings' tails
        before its queue drains, so its in-flight set is the tail)."""
        return self.cores[self.shard_of(worker)].speculate(worker)

    def observe_speed(self, worker: Any, task_ids: Sequence[str],
                      busy_seconds: float) -> None:
        self.cores[self.shard_of(worker)].observe_speed(
            worker, task_ids, busy_seconds)

    def record_waste(self, worker: Any, seconds: float) -> None:
        self.cores[self.shard_of(worker)].record_waste(worker, seconds)

    # -- checkpoint --------------------------------------------------------

    def checkpoint(self) -> ManagerCheckpoint:
        pending: list[str] = []
        for c in self.cores:
            pending.extend(t.task_id for t in c.pending)
        return ManagerCheckpoint(
            self.completed, pending,
            policy_state={"shards": [c.policy.state()
                                     for c in self.cores]},
            runtime_state=self.cores[0]._runtime_state())


def drive(core: SchedulerCore, transport, *,
          poll_interval: float = DEFAULT_POLL_INTERVAL_S,
          failure_timeout: Optional[float] = None,
          on_checkpoint: Optional[Callable[[ManagerCheckpoint], None]] = None,
          checkpoint_interval_s: float = 1.0,
          raise_on_failure: bool = True,
          backend: str = "threads") -> RunResult:
    """The managing process of §II.D against a live transport.

    Eagerly allocates initial batches to every worker, then drains every
    waiting message before sleeping ``poll_interval`` ("the manager waits
    0.3 seconds prior to checking for more idle workers").  With
    ``failure_timeout`` set, workers that go silent have their in-flight
    tasks re-queued.  ``on_checkpoint`` is invoked roughly every
    ``checkpoint_interval_s`` with the serializable manager state, so a
    killed job resumes mid-phase instead of restarting it.
    """
    worker_ids = list(transport.worker_ids)
    stats = {wid: WorkerStats(wid) for wid in worker_ids}
    results: dict[str, Any] = {}
    tracer = getattr(core, "tracer", None)
    # Per-worker end of the last emitted exec span: live exec spans are
    # reconstructed from DONE-reported busy windows and clamped to never
    # overlap within a worker's timeline.
    exec_end: dict[Any, float] = {}
    # Elastic fleet: the controller rides on the core (run_job attaches
    # it) and only engages on transports that can actually scale.
    fleet = getattr(core, "fleet", None)
    can_scale = fleet is not None and hasattr(transport, "add_worker")
    retired: set = set()
    transport.start()
    try:
        t_start = time.monotonic()
        last_seen = {wid: t_start for wid in worker_ids}
        heard: set = set()      # workers that have sent at least one message
        last_ckpt = t_start
        last_control = t_start

        def send(wid) -> None:
            if wid in retired or wid in core.dead:
                return
            batch = core.next_batch(wid)
            if not batch:
                # Queue drained: offer the idle worker a backup copy of
                # the longest-in-flight task (no-op unless the core was
                # built speculative).
                speculate = getattr(core, "speculate", None)
                if speculate is not None:
                    batch = speculate(wid)
            if batch:
                transport.send(wid, Message(
                    MessageKind.ASSIGN, sender="manager", tasks=batch))

        def control_tick(now: float) -> None:
            alive = [w for w in worker_ids
                     if w not in core.dead and w not in retired]
            busy = sum(1 for w in alive if not core.idle(w))
            busy_frac = busy / len(alive) if alive else 0.0
            delta = fleet.decide(now - t_start, n_workers=len(alive),
                                 queue_depth=len(core.pending),
                                 busy_frac=busy_frac)
            applied = 0
            if delta > 0:
                for _ in range(delta):
                    wid = transport.add_worker()
                    worker_ids.append(wid)
                    stats[wid] = WorkerStats(wid)
                    last_seen[wid] = now
                    applied += 1
                    send(wid)
            elif delta < 0:
                # Retire only both-views-idle workers — never interrupt
                # in-flight work (exactly-once stays trivially safe: a
                # retired worker has nothing to lose).
                for w in alive:
                    if applied <= delta:
                        break
                    if core.idle(w):
                        transport.retire_worker(w)
                        retired.add(w)
                        applied -= 1
            if applied:
                fleet.applied(applied)
                pol = getattr(core, "policy", None)
                if pol is not None:
                    pol.n_workers = len(worker_ids) - len(retired)
            if tracer is not None and delta:
                tracer.emit(tracer.clock(), -1.0, "fleet_scale", "sched",
                            len(worker_ids) - len(retired), None, applied)

        # "the manager sequentially allocates initial tasks to all workers
        # as fast as possible ... does not pause when sending"
        for wid in worker_ids:
            send(wid)

        while not core.done:
            drained = False
            while True:
                msg = transport.recv_nowait()
                if msg is None:
                    break
                drained = True
                now = time.monotonic()
                last_seen[msg.sender] = now
                heard.add(msg.sender)
                if msg.kind is MessageKind.DONE:
                    fresh_ids = core.on_done(msg.sender, msg.task_ids,
                                             msg.results)
                    fresh = set(fresh_ids)
                    for tid, res in zip(msg.task_ids, msg.results):
                        if tid in fresh:
                            results[tid] = res
                    observe = getattr(core, "observe_speed", None)
                    if observe is not None:
                        observe(msg.sender, msg.task_ids, msg.busy_seconds)
                    n_stale = len(msg.task_ids) - len(fresh)
                    if n_stale > 0 and msg.task_ids:
                        # Duplicate executions (a speculated or falsely
                        # re-dispatched copy lost the race): charge the
                        # stale share of this batch's busy window.
                        waste = getattr(core, "record_waste", None)
                        if waste is not None:
                            waste(msg.sender, msg.busy_seconds
                                  * n_stale / len(msg.task_ids))
                    s = stats[msg.sender]
                    s.tasks_completed += len(fresh)
                    s.busy_seconds += msg.busy_seconds
                    s.wait_seconds += msg.wait_seconds
                    prev = (s.last_done_at if s.last_done_at is not None
                            else t_start)
                    s.idle_seconds += max(0.0, (now - prev)
                                          - msg.busy_seconds)
                    if s.first_task_at is None:
                        s.first_task_at = now - msg.busy_seconds
                    s.last_done_at = now
                    if tracer is not None and fresh_ids:
                        # The batch's reported busy window, split evenly
                        # across its tasks (the worker does not report
                        # per-task boundaries), clamped so spans never
                        # overlap within this worker's row.
                        start = max(now - msg.busy_seconds,
                                    exec_end.get(msg.sender, t_start))
                        start = min(start, now)
                        step = (now - start) / len(fresh_ids)
                        raw = tracer.raw
                        for i, tid in enumerate(fresh_ids):
                            raw((start + i * step, step, "exec", "task",
                                 msg.sender, tid, None))
                        tracer.emitted += len(fresh_ids)
                        exec_end[msg.sender] = now
                    if msg.sender not in core.dead:
                        send(msg.sender)
                elif msg.kind is MessageKind.FAILED:
                    core.on_failed(msg.sender, msg.task_ids, msg.error)
                    if msg.sender not in core.dead:
                        send(msg.sender)
                # HEARTBEAT just refreshes last_seen.

            if drained and core.pending:
                # Streaming admissions (DAG edge emission during the
                # DONEs above) may have refilled a queue that was empty
                # when other workers went idle — kick them now instead
                # of after a poll sleep.  For static task sets this
                # never fires: a worker only idles once its shard's
                # queue is empty for good.
                for wid in worker_ids:
                    if wid not in core.dead and wid not in retired \
                            and core.idle(wid):
                        send(wid)

            # Failure detection.  Two tiers:
            #  * hard death (always on): a worker whose thread/process is
            #    gone can never report again — re-queue immediately;
            #  * silent worker (needs failure_timeout): alive but not
            #    heartbeating/reporting within the timeout.
            now = time.monotonic()
            newly_dead = False
            for wid in worker_ids:
                if wid in core.dead or wid in retired or core.idle(wid):
                    continue
                if not transport.worker_alive(wid):
                    core.mark_dead(wid)
                    newly_dead = True
                    continue
                if failure_timeout is None:
                    continue
                # A worker we have never heard from may still be booting
                # (spawn-based processes take seconds); only condemn it
                # once its process/thread is actually gone (above).
                if wid not in heard:
                    continue
                if now - last_seen[wid] > failure_timeout:
                    core.mark_dead(wid)
                    newly_dead = True
            if newly_dead:
                # Kick idle live workers so re-queued work starts
                # without waiting for another DONE.
                for w2 in worker_ids:
                    if w2 not in core.dead and w2 not in retired \
                            and core.idle(w2):
                        send(w2)
            n_alive = sum(1 for w in worker_ids
                          if w not in core.dead and w not in retired)
            if n_alive == 0 and not core.done and not can_scale:
                raise RuntimeError(
                    f"all {len(worker_ids)} workers died with "
                    f"{core.total - len(core.completed)} tasks left")
            # With an elastic fleet a fully dead fleet is recoverable:
            # the controller's min_workers floor re-grows it below.

            if can_scale:
                now = time.monotonic()
                if now - last_control >= fleet.interval_s:
                    last_control = now
                    control_tick(now)

            if on_checkpoint is not None:
                now = time.monotonic()
                if now - last_ckpt >= checkpoint_interval_s:
                    on_checkpoint(core.checkpoint())
                    last_ckpt = now

            if not drained:
                time.sleep(poll_interval)
                # Re-poll idle workers (they may have raced the initial send).
                for wid in worker_ids:
                    if wid not in core.dead and wid not in retired \
                            and core.idle(wid) and core.pending:
                        send(wid)
    finally:
        transport.stop()

    job_seconds = time.monotonic() - t_start
    if core.failures and raise_on_failure:
        raise RuntimeError(
            f"{len(core.failures)} tasks failed: "
            f"{dict(list(core.failures.items())[:3])}")
    extra_messages = int(getattr(core, "extra_messages", 0) or 0)
    return RunResult(
        job_seconds=job_seconds,
        results=results,
        worker_stats=stats,
        failed_workers=sorted(core.dead),
        reassigned_tasks=core.reassigned,
        messages_sent=core.messages_sent + extra_messages,
        backend=backend,
        failures=dict(core.failures),
        batches=list(core.batches),
        completed_ids=frozenset(core.completed),
        shard_messages=list(getattr(core, "shard_messages", []) or []),
        speculated=int(getattr(core, "speculated", 0) or 0),
        extra_messages=extra_messages,
        wasted_seconds=float(getattr(core, "wasted_seconds", 0.0) or 0.0),
        workers_added=(fleet.workers_added if fleet is not None else 0),
        workers_retired=(fleet.workers_retired if fleet is not None else 0))
