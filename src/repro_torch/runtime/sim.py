"""Discrete-event simulator backend for triples-mode + self-scheduling jobs.

A live run holds a handful of workers; the paper benchmarks 256-2048
worker processes.  This engine reproduces the paper's experiments at
full scale against the calibrated cost models of core/cost_model.py,
and every manager-side *decision* (batching, dispatch order,
exactly-once accounting, failure re-queue) is delegated to the same
:class:`~repro_torch.runtime.protocol.SchedulerCore` that drives the
live threads/processes backends, so all three backends make
bit-identical scheduling decisions.  Times are virtual seconds of the
cost model, not the card's.

Engine notes
------------
I/O is processor-shared: every task in its I/O phase receives the same
instantaneous rate rho(n_active) (three-level min — see PhaseCostModel).
Equal sharing admits the classic *virtual-time* trick: let V(t) advance at
rate rho(n(t)); a task entering I/O at virtual time V0 with demand d bytes
completes when V reaches V0 + d.  Completions pop off a heap keyed on
V0 + d, so each event costs O(log n) instead of O(n) rescans.  CPU phases
are dedicated (one task per core) and sit in an ordinary event heap.

Fault injection: ``worker_death`` kills workers at given sim times; the
manager re-queues their in-flight tasks after ``failure_timeout`` — the
same recovery loop as the live runtime.
"""

from __future__ import annotations

import heapq
import itertools
from typing import Optional, Sequence

from repro_torch.core.cost_model import PhaseCostModel
from repro_torch.core.distribution import (
    DistributionPolicy, block_distribution, cyclic_distribution)
from repro_torch.core.messages import Task
from repro_torch.runtime.protocol import (
    DEFAULT_POLL_INTERVAL_S, SchedulerCore, manager_shard)
from repro_torch.runtime.result import RunResult, SimTaskRecord, WorkerStats

DEFAULT_POLL_S = DEFAULT_POLL_INTERVAL_S

__all__ = ["DEFAULT_POLL_S", "simulate_self_scheduling", "simulate_static",
           "merge_tasks_per_message"]

# Event kinds (heap entries are (time, seq, kind, data)).
_CPU_DONE = 0       # data = worker index
_RECV = 1           # data = (worker, tuple[int task indices])
_MGR_DONE = 2       # data = (worker, tuple[str task ids])
_DEATH = 3          # data = worker index
_REDISPATCH = 4     # data = worker index (dynamic) | tuple[int] (static)
_CONTROL = 5        # data = None (elastic fleet controller tick)


class _Sim:
    def __init__(self, tasks: Sequence[Task], n_workers: int, nodes: int,
                 nppn: int, model: PhaseCostModel,
                 poll_interval: float,
                 worker_death: Optional[dict[int, float]],
                 failure_timeout: float,
                 core: Optional[SchedulerCore] = None,
                 legacy_launch_penalty: float = 1.0,
                 worker_speed: Optional[Sequence[float]] = None,
                 speculative: bool = False,
                 n_manager_shards: int = 1,
                 model_fn=None,
                 tracer=None):
        self.tasks = list(tasks)
        self.n_workers = n_workers
        self.nodes = max(nodes, 1)
        self.nppn = max(nppn, 1)
        self.model = model
        self.core = core                      # None for static jobs
        self._index = {t.task_id: i for i, t in enumerate(self.tasks)}
        self.latency = poll_interval / 2.0   # expected poll delay, each hop
        self.worker_death = dict(worker_death or {})
        self.failure_timeout = failure_timeout
        # >1.0 models the pre-triples launcher: no EPPAC placement/affinity
        # => cache/NUMA thrash on the 64-core mesh slows every task.
        self.legacy = legacy_launch_penalty
        # Per-worker speed multipliers on task cost (beyond-paper:
        # heterogeneous fleets / persistent stragglers). 1.0 = nominal;
        # 0.25 = a worker running 4x slow.
        self.speed = (list(worker_speed) if worker_speed is not None
                      else [1.0] * n_workers)
        # Beyond-paper: MapReduce-style backup tasks. The *decision* now
        # lives in SchedulerCore.speculate() (shared with the live
        # backends); the sim only routes an idle worker's empty ASSIGN
        # through it. First completion wins (exactly-once via
        # completed_set worker-side, core.completed manager-side).
        self.speculative = (bool(speculative)
                            or bool(getattr(core, "speculative", False)))
        self.completed_set: set[int] = set()
        # Elastic fleet: the controller rides on the core (run_job
        # attaches it); the sim drives it with _CONTROL events on the
        # virtual clock, so scaling decisions are deterministic per seed.
        self.fleet = getattr(core, "fleet", None) if core is not None \
            else None
        self.retired: list[bool] = [False] * n_workers

        self.now = 0.0
        self.seq = itertools.count()
        self.events: list[tuple[float, int, int, object]] = []

        # Virtual-time I/O processor sharing.
        self.V = 0.0                      # attained per-task service (bytes)
        self.io_heap: list[tuple[float, int, int]] = []  # (V_target, seq, worker)
        self.n_io = 0

        # Manager message clocks: ONE per coordinator shard.  Each send
        # charges msg_overhead_s against its shard's clock — the single
        # clock (n_manager_shards=1) is exactly the paper's §V message
        # wall; N clocks model N coordinator entities each paying its
        # own serial overhead, so dispatch throughput scales with N.
        self.mgr_free_at = [0.0] * max(int(n_manager_shards), 1)
        # Per-TASK cost-model override (streaming DAG: each phase node
        # keeps its own PhaseCostModel); None = the job-wide model.
        self.model_fn = model_fn
        self.static_reassigned = 0

        # Workers.
        self.inflight: list[list[int]] = [[] for _ in range(n_workers)]
        self.batch_pos: list[int] = [0] * n_workers
        self.io_wait: list[float] = [0.0] * n_workers
        self.cur_task: list[Optional[int]] = [None] * n_workers
        self.in_io: list[bool] = [False] * n_workers
        self.dead: list[bool] = [False] * n_workers
        self.busy: list[float] = [0.0] * n_workers
        self.first_start: list[Optional[float]] = [None] * n_workers
        self.last_end: list[float] = [0.0] * n_workers
        self.task_start: list[float] = [0.0] * n_workers
        self.records: list[SimTaskRecord] = []
        self.completed = 0
        self.failed_tasks: set[int] = set()
        self._static = False

        # Observability: bind the tracer to the VIRTUAL clock before
        # attaching it to the core, so the core's queued-at-attach
        # instants land at sim t=0 and every later lifecycle instant
        # carries simulated time — the same API the live backends emit
        # wall-clock events through.
        self.tracer = tracer
        if tracer is not None:
            tracer.set_clock(lambda: self.now)
            if core is not None and hasattr(core, "attach_tracer"):
                core.attach_tracer(tracer)

    # -- helpers -------------------------------------------------------------

    def _push(self, t: float, kind: int, data: object) -> None:
        heapq.heappush(self.events, (t, next(self.seq), kind, data))

    def _rho(self) -> float:
        return self.model.io_rate(self.n_io, self.nodes, self.nppn)

    def _advance_virtual(self, t: float) -> None:
        if t > self.now and self.n_io > 0:
            self.V += self._rho() * (t - self.now)
        self.now = t

    def _next_io_time(self) -> float:
        if not self.io_heap:
            return float("inf")
        v_target = self.io_heap[0][0]
        rho = self._rho()
        if rho <= 0:
            return float("inf")
        return self.now + max(v_target - self.V, 0.0) / rho

    # -- manager -------------------------------------------------------------

    def _task_model(self, idx: int):
        """The cost model charged for one task (per-node in DAG runs)."""
        if self.model_fn is None:
            return self.model
        return self.model_fn(self.tasks[idx]) or self.model

    def _send_indices(self, worker: int, batch: Sequence[int]) -> None:
        """Serial manager send: one message, msg_overhead_s charged to
        the sending coordinator shard's clock."""
        shard = manager_shard(worker, self.n_workers, len(self.mgr_free_at))
        send_start = max(self.now, self.mgr_free_at[shard])
        self.mgr_free_at[shard] = send_start + self.model.msg_overhead_s
        self._push(self.mgr_free_at[shard] + self.latency, _RECV,
                   (worker, tuple(batch)))

    def _register(self, task: Task) -> int:
        """Index a task the core admitted mid-run (streaming DAG edges
        emit tasks the sim never saw at construction)."""
        i = self._index.get(task.task_id)
        if i is None:
            i = len(self.tasks)
            self.tasks.append(task)
            self._index[task.task_id] = i
        return i

    def _mgr_send(self, worker: int) -> None:
        """Ask the shared protocol core for the next batch (same decision
        the live backends make) and put it on the simulated wire."""
        if self.dead[worker] or self.retired[worker]:
            return
        assert self.core is not None
        batch_tasks = self.core.next_batch(worker)
        if not batch_tasks and self.speculative:
            # Queue drained: the core may hand this idle worker a backup
            # copy of the longest-in-flight task (first DONE wins).
            speculate = getattr(self.core, "speculate", None)
            if speculate is not None:
                batch_tasks = speculate(worker)
        if not batch_tasks:
            return
        self._send_indices(
            worker, [self._register(t) for t in batch_tasks])

    # -- worker task lifecycle -------------------------------------------------

    def _start_task(self, worker: int) -> None:
        batch = self.inflight[worker]
        pos = self.batch_pos[worker]
        if pos >= len(batch):
            return
        idx = batch[pos]
        self.cur_task[worker] = idx
        self.task_start[worker] = self.now
        if self.first_start[worker] is None:
            self.first_start[worker] = self.now
        demand = self._task_model(idx).io_bytes(self.tasks[idx].size_bytes) \
            * self.legacy / self.speed[worker]
        self.n_io += 1
        self.in_io[worker] = True
        heapq.heappush(self.io_heap, (self.V + demand, next(self.seq), worker))

    def _io_done(self, worker: int) -> None:
        self.n_io -= 1
        self.in_io[worker] = False
        # The I/O phase is the worker waiting on its feed: attribute it
        # to wait_seconds so BENCH records split busy into compute vs I/O.
        self.io_wait[worker] += self.now - self.task_start[worker]
        idx = self.cur_task[worker]
        assert idx is not None
        t = self.tasks[idx]
        cpu = self._task_model(idx).cpu_seconds(
            t.size_bytes, self.nppn, t.cpu_cost_hint)
        self._push(self.now + cpu * self.legacy / self.speed[worker],
                   _CPU_DONE, worker)

    def _cpu_done(self, worker: int) -> None:
        idx = self.cur_task[worker]
        assert idx is not None
        t = self.tasks[idx]
        elapsed = self.now - self.task_start[worker]
        self.busy[worker] += elapsed
        self.last_end[worker] = self.now
        if self.core is not None:
            # Online speed feedback: est cost over simulated elapsed
            # seconds (virtual time, so the model stays deterministic).
            observe = getattr(self.core, "observe_speed", None)
            if observe is not None:
                observe(worker, (t.task_id,), elapsed)
        if idx not in self.completed_set:   # first copy wins (speculation)
            self.completed_set.add(idx)
            self.records.append(SimTaskRecord(
                t.task_id, worker, self.task_start[worker], self.now,
                t.size_bytes))
            self.completed += 1
            tr = self.tracer
            if tr is not None:
                # First completion only, so traces keep exactly one exec
                # span per task even under speculative backup copies.
                tr.raw((self.task_start[worker],
                        self.now - self.task_start[worker],
                        "exec", "task", worker, t.task_id, t.size_bytes))
                tr.emitted += 1
        elif self.core is not None:
            # A losing duplicate: charge the wasted execution seconds.
            waste = getattr(self.core, "record_waste", None)
            if waste is not None:
                waste(worker, elapsed)
        self.cur_task[worker] = None
        self.batch_pos[worker] += 1
        if self.batch_pos[worker] < len(self.inflight[worker]):
            self._start_task(worker)          # next task of the same message
        else:
            finished = tuple(self.tasks[i].task_id
                             for i in self.inflight[worker])
            self.inflight[worker] = []
            self.batch_pos[worker] = 0
            # DONE message reaches the manager after one poll hop.
            self._push(self.now + self.latency, _MGR_DONE,
                       (worker, finished))

    # -- elastic fleet ---------------------------------------------------------

    def _grow(self, k: int) -> list[int]:
        """Add k simulated workers (every per-worker parallel list grows;
        new workers run at nominal speed) and hand each its first batch."""
        new_ids = []
        for _ in range(k):
            w = self.n_workers
            self.n_workers += 1
            self.inflight.append([])
            self.batch_pos.append(0)
            self.io_wait.append(0.0)
            self.cur_task.append(None)
            self.in_io.append(False)
            self.dead.append(False)
            self.busy.append(0.0)
            self.first_start.append(None)
            self.last_end.append(0.0)
            self.task_start.append(0.0)
            self.speed.append(1.0)
            self.retired.append(False)
            new_ids.append(w)
        pol = getattr(self.core, "policy", None)
        if pol is not None:
            # Keep the factoring policies' P in step with the fleet.
            pol.n_workers = self.n_workers
        for w in new_ids:
            self._mgr_send(w)
        return new_ids

    def _retire(self, k: int) -> int:
        """Retire up to k both-views-idle workers (never interrupts
        in-flight work, so exactly-once needs no re-queue)."""
        n = 0
        for w in range(self.n_workers):
            if n >= k:
                break
            if self.dead[w] or self.retired[w] or self.inflight[w]:
                continue
            if self.core is not None and not self.core.idle(w):
                continue
            self.retired[w] = True
            n += 1
        return n

    def _fleet_control(self) -> None:
        alive = [w for w in range(self.n_workers)
                 if not self.dead[w] and not self.retired[w]]
        busy = sum(1 for w in alive
                   if self.inflight[w] or not self.core.idle(w))
        busy_frac = busy / len(alive) if alive else 0.0
        delta = self.fleet.decide(self.now, n_workers=len(alive),
                                  queue_depth=len(self.core.pending),
                                  busy_frac=busy_frac)
        applied = 0
        if delta > 0:
            applied = len(self._grow(delta))
        elif delta < 0:
            applied = -self._retire(-delta)
        if applied:
            self.fleet.applied(applied)
        if self.tracer is not None and delta:
            n_alive = sum(1 for w in range(self.n_workers)
                          if not self.dead[w] and not self.retired[w])
            self.tracer.emit(self.now, -1.0, "fleet_scale", "sched",
                             n_alive, None, applied)

    def _kill(self, worker: int) -> None:
        if self.dead[worker]:
            return
        self.dead[worker] = True
        if self.tracer is not None:
            self.tracer.emit(self.now, -1.0, "worker_dead", "sched",
                             worker, None, None)
        # Release the processor-sharing I/O slot if the worker died mid-I/O
        # (the stale heap entry is skipped when popped); without this the
        # shared rate rho(n_io) stays depressed by a phantom task.
        if self.cur_task[worker] is not None and self.in_io[worker]:
            self.n_io -= 1
            self.in_io[worker] = False
        self.cur_task[worker] = None
        if self._static:
            lost = list(self.inflight[worker][self.batch_pos[worker]:])
            if lost:
                self._push(self.now + self.failure_timeout, _REDISPATCH,
                           tuple(lost))
        else:
            # The shared core tracks everything in flight to this worker
            # (including ASSIGNs still on the wire); after failure_timeout
            # the manager declares it dead and re-queues.
            self._push(self.now + self.failure_timeout, _REDISPATCH, worker)
        self.inflight[worker] = []
        self.batch_pos[worker] = 0

    # -- main loop -------------------------------------------------------------

    def run_self_scheduled(self) -> RunResult:
        assert self.core is not None
        for w, t in self.worker_death.items():
            if 0 <= w < self.n_workers:
                self._push(t, _DEATH, w)
        if self.fleet is not None:
            self._push(self.fleet.interval_s, _CONTROL, None)
        # Eager initial allocation to every worker, serially, no pauses.
        for w in range(self.n_workers):
            if not self.core.pending:
                break
            self._mgr_send(w)
        return self._loop()

    def run_static(self, assignment: Sequence[Sequence[int]]) -> RunResult:
        """Block/cyclic: all tasks pre-assigned; workers start at t=0."""
        self._static = True
        for w, t in self.worker_death.items():
            if 0 <= w < self.n_workers:
                self._push(t, _DEATH, w)
        for w, batch in enumerate(assignment):
            self.inflight[w] = list(batch)
            self.batch_pos[w] = 0
            if batch:
                self._start_task(w)
        return self._loop()

    def _loop(self) -> RunResult:
        static = self._static
        n_total = len(self.tasks)
        dead_workers: list[int] = []

        def running() -> bool:
            # Dynamic jobs end when the MANAGER's ledger is complete, not
            # when the last worker-side copy finishes: a worker that dies
            # mid-batch after completing a task but before its per-batch
            # DONE leaves the manager unaware, and the job truly lasts
            # until the re-dispatched copy reports (the live drive loop
            # behaves exactly this way).  Static jobs have no manager.
            if static:
                return self.completed + len(self.failed_tasks) < n_total
            return not self.core.done

        while running():
            t_io = self._next_io_time()
            t_ev = self.events[0][0] if self.events else float("inf")
            if t_io == float("inf") and t_ev == float("inf"):
                break  # no progress possible (all workers dead)
            if t_io <= t_ev:
                self._advance_virtual(t_io)
                _, _, worker = heapq.heappop(self.io_heap)
                if self.dead[worker] or self.cur_task[worker] is None:
                    continue  # stale entry from a killed worker
                self._io_done(worker)
                continue
            t, _, kind, data = heapq.heappop(self.events)
            self._advance_virtual(t)
            if kind == _CPU_DONE:
                w = data  # type: ignore[assignment]
                if not self.dead[w]:
                    self._cpu_done(w)
            elif kind == _RECV:
                w, batch = data  # type: ignore[misc]
                if self.dead[w]:
                    # The core still holds these in in_flight[w]; schedule a
                    # re-queue (mark_dead is idempotent, so a double event
                    # is harmless).
                    self._push(self.now + self.failure_timeout,
                               _REDISPATCH,
                               tuple(batch) if static else w)
                else:
                    self.inflight[w] = list(batch)
                    self.batch_pos[w] = 0
                    self._start_task(w)
            elif kind == _MGR_DONE:
                w, done_ids = data  # type: ignore[misc]
                if not static:
                    self.core.on_done(w, done_ids)
                    self._mgr_send(w)
                    # Streaming DAG: this DONE may have admitted fresh
                    # downstream tasks while other workers sit idle
                    # (they drained the queue before the admission).
                    # Kick every both-views-idle worker, exactly like
                    # the live drive loop's post-drain kick.
                    if getattr(self.core, "streaming", False) \
                            and self.core.pending:
                        for w2 in range(self.n_workers):
                            if not self.core.pending:
                                break
                            if (not self.dead[w2] and not self.retired[w2]
                                    and not self.inflight[w2]
                                    and self.core.idle(w2)):
                                self._mgr_send(w2)
            elif kind == _CONTROL:
                if self.fleet is not None and not self.core.done:
                    self._fleet_control()
                    self._push(self.now + self.fleet.interval_s,
                               _CONTROL, None)
            elif kind == _DEATH:
                w = data  # type: ignore[assignment]
                dead_workers.append(w)
                self._kill(w)
            elif kind == _REDISPATCH:
                if static:
                    lost = list(data)  # type: ignore[arg-type]
                    # Static jobs have no manager: reassign round-robin to
                    # the survivors' tails (models a restart-from-list).
                    alive = [w for w in range(self.n_workers)
                             if not self.dead[w]]
                    if not alive:
                        continue   # no survivors: the job ends incomplete
                    self.static_reassigned += len(lost)
                    for i, idx in enumerate(lost):
                        w = alive[i % len(alive)]
                        self.inflight[w].append(idx)
                        if self.cur_task[w] is None and \
                                self.batch_pos[w] < len(self.inflight[w]):
                            self._start_task(w)
                else:
                    w = data  # type: ignore[assignment]
                    self.core.mark_dead(w)
                    for w2 in range(self.n_workers):
                        # A worker is only safe to re-kick when BOTH views
                        # agree it is idle: sim-side inflight empty AND no
                        # core in-flight ids (a DONE still on the wire
                        # leaves core.idle False — sending then would
                        # double-assign, exactly like the live drive loop's
                        # core.idle guard prevents).
                        if (not self.dead[w2] and not self.retired[w2]
                                and not self.inflight[w2]
                                and self.core.idle(w2)
                                and self.core.pending):
                            self._mgr_send(w2)

        if not static:
            # The loop exits the instant the last CPU phase finishes; flush
            # DONE messages still on the wire so the core's exactly-once
            # ledger covers every executed task.
            while self.events:
                _, _, kind, data = heapq.heappop(self.events)
                if kind == _MGR_DONE:
                    w, done_ids = data  # type: ignore[misc]
                    self.core.on_done(w, done_ids)

        job_end = max(self.last_end) + self.latency if self.records else 0.0
        stats = {}
        per_worker = [0] * self.n_workers
        for rec in self.records:
            per_worker[rec.worker] += 1
        for w in range(self.n_workers):
            span = ((self.last_end[w] - self.first_start[w])
                    if self.first_start[w] is not None else 0.0)
            stats[w] = WorkerStats(
                worker_id=w,
                tasks_completed=per_worker[w],
                busy_seconds=self.busy[w],
                idle_seconds=max(0.0, span - self.busy[w]),
                wait_seconds=self.io_wait[w],
                first_task_at=self.first_start[w],
                last_done_at=(self.last_end[w]
                              if self.first_start[w] is not None else None))
        if static:
            messages = 0
            reassigned = self.static_reassigned
            completed_ids = frozenset(r.task_id for r in self.records)
            batches = []
            failures: dict[str, str] = {}
        else:
            extra = int(getattr(self.core, "extra_messages", 0) or 0)
            messages = self.core.messages_sent + extra
            reassigned = self.core.reassigned
            completed_ids = frozenset(self.core.completed)
            batches = list(self.core.batches)
            failures = dict(self.core.failures)
        return RunResult(
            job_seconds=job_end,
            worker_stats=stats,
            failed_workers=sorted(dead_workers),
            reassigned_tasks=reassigned,
            messages_sent=messages,
            backend="sim",
            failures=failures,
            task_records=self.records,
            batches=batches,
            completed_ids=completed_ids,
            shard_messages=([] if static else list(
                getattr(self.core, "shard_messages", []) or [])),
            speculated=(0 if static else
                        int(getattr(self.core, "speculated", 0) or 0)),
            extra_messages=(0 if static else
                            int(getattr(self.core, "extra_messages", 0)
                                or 0)),
            wasted_seconds=(0.0 if static else
                            float(getattr(self.core, "wasted_seconds", 0.0)
                                  or 0.0)),
            workers_added=(self.fleet.workers_added if self.fleet else 0),
            workers_retired=(self.fleet.workers_retired
                             if self.fleet else 0))


# ---------------------------------------------------------------------------
# Public entry points.
# ---------------------------------------------------------------------------

def simulate_self_scheduling(
        tasks: Sequence[Task], *,
        n_workers: int,
        nodes: int,
        nppn: int,
        model: PhaseCostModel,
        organization: str = "largest_first",
        tasks_per_message: int = 1,
        poll_interval: float = DEFAULT_POLL_S,
        worker_death: Optional[dict[int, float]] = None,
        failure_timeout: float = 30.0,
        legacy_launch_penalty: float = 1.0,
        worker_speed: Optional[Sequence[float]] = None,
        speculative: bool = False,
        speculation_max_copies: int = 2,
        organize_seed: int = 0,
        policy: object = None,
        core: Optional[SchedulerCore] = None,
        n_manager_shards: int = 1,
        model_fn=None,
        tracer=None) -> RunResult:
    """Simulate a triples-mode self-scheduled job (the paper's §II.D).

    ``policy`` selects the scheduling policy (name or instance, see
    :mod:`repro_torch.runtime.policies`); cost-aware policies estimate task
    seconds from ``model`` at this topology.  Ignored when an
    already-built ``core`` is supplied (run_job resolves it there).

    ``n_manager_shards`` > 1 gives the sim that many coordinator clocks
    (each paying its own ``msg_overhead_s``) — pair it with a
    :class:`~repro_torch.runtime.protocol.ShardedCore` supplied via ``core``
    so decisions and clocks shard identically.  ``model_fn`` maps a task
    to its phase's cost model (streaming DAG runs); None = ``model``.

    ``tracer`` threads a :class:`repro_torch.obs.Tracer` through the run:
    its clock is rebound to the sim's virtual time, so simulated traces are
    bit-reproducible and read like live ones.
    """
    if core is None:
        from repro_torch.runtime.policies import get_policy, model_task_cost
        pol = get_policy(policy, tasks_per_message=tasks_per_message,
                         n_workers=n_workers,
                         cost_fn=model_task_cost(model, nppn=nppn,
                                                 nodes=nodes))
        core = SchedulerCore(tasks, organization=organization,
                             tasks_per_message=tasks_per_message,
                             organize_seed=organize_seed,
                             policy=pol, n_workers=n_workers,
                             speculative=speculative,
                             speculation_max_copies=speculation_max_copies)
    elif speculative and not getattr(core, "speculative", False):
        # Legacy call sites pass speculative= alongside a pre-built core;
        # the flag now lives on the core, so lift it there.
        core.speculative = True
    sim = _Sim(tasks, n_workers, nodes, nppn, model,
               poll_interval, worker_death, failure_timeout, core=core,
               legacy_launch_penalty=legacy_launch_penalty,
               worker_speed=worker_speed, speculative=speculative,
               n_manager_shards=n_manager_shards, model_fn=model_fn,
               tracer=tracer)
    return sim.run_self_scheduled()


def simulate_static(
        tasks: Sequence[Task], *,
        n_workers: int,
        nodes: int,
        nppn: int,
        model: PhaseCostModel,
        policy: DistributionPolicy | str = DistributionPolicy.BLOCK,
        organization: str = "filename",
        poll_interval: float = DEFAULT_POLL_S,
        worker_death: Optional[dict[int, float]] = None,
        failure_timeout: float = 30.0,
        legacy_launch_penalty: float = 1.0,
        worker_speed: Optional[Sequence[float]] = None) -> RunResult:
    """Simulate a static block/cyclic job (LLMapReduce-style, §IV.B).

    ``organization`` defaults to 'filename' because LLMapReduce sorts tasks
    by filename before splitting (§IV.B) — that interaction with the 4-tier
    hierarchy is exactly what made block distribution pathological.
    """
    if isinstance(policy, str):
        policy = DistributionPolicy(policy)
    from repro_torch.core.messages import get_organizer
    organizer = get_organizer(organization)
    ordered = organizer(tasks)
    index = {id(t): i for i, t in enumerate(tasks)}
    order = [index[id(t)] for t in ordered]
    if policy is DistributionPolicy.BLOCK:
        assignment = block_distribution(order, n_workers)
    elif policy is DistributionPolicy.CYCLIC:
        assignment = cyclic_distribution(order, n_workers)
    else:
        raise ValueError("use simulate_self_scheduling for dynamic policy")
    sim = _Sim(tasks, n_workers, nodes, nppn, model,
               poll_interval, worker_death, failure_timeout, core=None,
               legacy_launch_penalty=legacy_launch_penalty,
               worker_speed=worker_speed)
    return sim.run_static(assignment)


def merge_tasks_per_message(tasks: Sequence[Task], k: int) -> list[Task]:
    """Pre-merge k real tasks into one sim unit (radar: k=300, 13.2 M ids
    -> 43,969 message units) so huge jobs stay simulable."""
    out = []
    for i in range(0, len(tasks), k):
        chunk = tasks[i:i + k]
        out.append(Task(
            task_id=f"m{i // k:07d}",
            size_bytes=sum(t.size_bytes for t in chunk),
            timestamp=min(t.timestamp for t in chunk),
            cpu_cost_hint=(
                sum(t.cpu_cost_hint for t in chunk)
                if all(t.cpu_cost_hint is not None for t in chunk) else None),
        ))
    return out
