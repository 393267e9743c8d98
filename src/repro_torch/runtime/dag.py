"""Streaming phase DAG: tasks flow between phases as dependencies resolve.

The track workflow historically ran organize -> archive -> store-build ->
process as four *global barriers*: every phase waited for the slowest
task of the previous one, so a single straggler archive idled the whole
fleet before the first shard could even be planned.  This module replaces
the barrier sequence with a streaming DAG:

  * :class:`PhaseNode` — one phase: a worker fn (live backends), an
    optional initial task list (source nodes), and an optional per-phase
    cost model (sim backend).
  * :class:`StreamingDAG` — nodes plus typed edges.  A *streaming* edge
    carries an :class:`EdgeEmitter` (or a per-task ``expand`` fn): every
    completed source task is fed to the emitter, which may immediately
    emit downstream tasks — e.g. each completed archive feeds the
    shard planner, which cuts a store-build task the moment enough
    consecutive archives exist.  A *barrier* edge carries an
    ``on_complete`` thunk that fires once when the source node
    completes (for phases that genuinely need the whole upstream
    output, e.g. scanning the organized tree).
  * :func:`run_dag` — executes the DAG on any runtime backend (threads /
    processes / sim) through the same :func:`~repro_torch.runtime.protocol.drive`
    loop and :mod:`~repro_torch.runtime.sim` engine as ``run_job``, including
    manager sharding (``n_manager_shards`` > 1 routes tasks across a
    :class:`~repro_torch.runtime.protocol.ShardedCore`; the sim charges each
    shard its own ``msg_overhead_s`` clock).

Exactly-once extends across dynamic admission: the coordinator keys
every node's ledger by *original* task id, so a re-emitted duplicate is
dropped before it reaches the scheduler, and the per-node frontier
(completed / failed / outstanding-task docs / emitter states) is
serialized into :class:`~repro_torch.runtime.protocol.ManagerCheckpoint`
``frontier`` — a killed DAG run resumes mid-stream, re-running only the
tasks that had not completed at the last checkpoint.

Task ids are namespaced ``<node>:<original_id>`` on the wire so two
phases may process the same logical item (e.g. store-build and process
both operate on shard ``s00001``).  Node names therefore must not
contain ``:``.  Streamed task payloads must obey the streaming-payload
contract documented on :func:`repro_torch.runtime.api.run_job`: plain-string
payloads, everything the worker needs in the five Task fields.

A :class:`StreamingDAG` holding stateful emitters is single-use: build a
fresh DAG per run (resume included — the checkpoint restores emitter
state into the fresh instances).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

from repro_torch.core.messages import Task
from repro_torch.runtime.policies import get_policy, model_task_cost
from repro_torch.runtime.protocol import (
    DEFAULT_POLL_INTERVAL_S, ManagerCheckpoint, SchedulerCore, ShardedCore,
    drive)
from repro_torch.runtime.result import RunResult
from repro_torch.runtime.transports import TRANSPORTS
from repro_torch.runtime import sim as _sim

__all__ = ["PhaseNode", "StreamingDAG", "EdgeEmitter", "DagCoordinator",
           "DagResult", "run_dag", "run_service"]

#: Separator between node name and original task id on the wire.
_SEP = ":"


@dataclasses.dataclass
class PhaseNode:
    """One phase of the workflow.

    ``fn`` runs each task on the live backends (ignored by sim); it may
    expose ``process_batch(list[Task]) -> dict`` for one-call batches.
    ``tasks`` seeds a *source* node (known up front); non-source nodes
    receive their tasks from in-edges.  ``cost_model`` gives the sim a
    per-phase :class:`~repro_torch.core.cost_model.PhaseCostModel`.
    """

    name: str
    fn: Optional[Callable[[Task], Any]] = None
    tasks: Optional[Sequence[Task]] = None
    batch_fn: Optional[Callable[[list[Task]], dict]] = None
    cost_model: Optional[Any] = None
    #: An *open* node never seals on its own: external callers keep
    #: admitting tasks mid-run (:meth:`DagCoordinator.admit_node`) until
    #: :meth:`DagCoordinator.close_node` declares the stream finished.
    #: This is what turns a batch DAG into a service (see
    #: :func:`run_service`).
    open: bool = False

    def __post_init__(self) -> None:
        if not self.name or _SEP in self.name:
            raise ValueError(
                f"node name {self.name!r} must be non-empty and must not "
                f"contain {_SEP!r} (task ids are namespaced <node>:<id>)")


class EdgeEmitter:
    """Streaming-edge protocol: turn source-task completions into
    downstream tasks, incrementally.

    Lifecycle: :meth:`prime` fires once when the source node is *sealed*
    (its admitted task set is final); :meth:`feed` fires for every
    source task completion (``result`` is the worker's return value on
    live backends, ``None`` on sim — emitters must produce the same
    tasks either way to keep the backends equivalent); :meth:`finish`
    fires once when the source node completes, flushing anything
    buffered.  :meth:`state` / :meth:`restore` serialize mid-stream
    emitter state into the manager checkpoint.
    """

    def prime(self, src_task_ids: Sequence[str]) -> None:
        """The source node's admitted task ids are now final."""

    def feed(self, task: Task, result: Any) -> list[Task]:
        """One source task completed; return tasks to admit downstream."""
        return []

    def finish(self) -> list[Task]:
        """Source node complete; return any remaining downstream tasks."""
        return []

    def state(self) -> Optional[dict]:
        """JSON-able mid-stream state (None = stateless)."""
        return None

    def restore(self, state: dict) -> None:
        """Restore :meth:`state` output after a checkpoint reload."""


class _ExpandEmitter(EdgeEmitter):
    """Stateless 1:N streaming edge from a plain ``expand`` callable."""

    def __init__(self, expand: Callable[[Task, Any], Sequence[Task]]):
        self._expand = expand

    def feed(self, task: Task, result: Any) -> list[Task]:
        return list(self._expand(task, result) or [])


@dataclasses.dataclass
class _Edge:
    src: str
    dst: str
    emitter: Optional[EdgeEmitter] = None
    on_complete: Optional[Callable[[], Sequence[Task]]] = None


class StreamingDAG:
    """Phase nodes plus streaming/barrier edges (see module docstring)."""

    def __init__(self) -> None:
        self.nodes: dict[str, PhaseNode] = {}
        self.order: list[str] = []
        self.edges: list[_Edge] = []

    def add_node(self, node: Any = None, /, **kwargs) -> PhaseNode:
        """Add a :class:`PhaseNode` (or a name + PhaseNode kwargs)."""
        if node is None:
            node = PhaseNode(**kwargs)
        elif not isinstance(node, PhaseNode):
            node = PhaseNode(name=node, **kwargs)
        if node.name in self.nodes:
            raise ValueError(f"duplicate node {node.name!r}")
        self.nodes[node.name] = node
        self.order.append(node.name)
        return node

    def add_edge(self, src: str, dst: str, *,
                 emitter: Optional[EdgeEmitter] = None,
                 expand: Optional[Callable[[Task, Any],
                                           Sequence[Task]]] = None,
                 on_complete: Optional[Callable[[],
                                                Sequence[Task]]] = None
                 ) -> None:
        """Connect ``src`` -> ``dst`` with exactly one of:

        * ``emitter`` — a stateful :class:`EdgeEmitter` (streaming);
        * ``expand(task, result) -> list[Task]`` — stateless per-task
          streaming expansion;
        * ``on_complete() -> list[Task]`` — barrier: fires once when
          ``src`` completes.
        """
        for name in (src, dst):
            if name not in self.nodes:
                raise ValueError(f"unknown node {name!r}")
        given = sum(x is not None for x in (emitter, expand, on_complete))
        if given != 1:
            raise ValueError(
                "pass exactly one of emitter=, expand=, on_complete=")
        if expand is not None:
            emitter = _ExpandEmitter(expand)
        self.edges.append(_Edge(src, dst, emitter=emitter,
                                on_complete=on_complete))

    def toposort(self) -> list[str]:
        """Node names in dependency order; raises on a cycle."""
        indeg = {n: 0 for n in self.order}
        for e in self.edges:
            indeg[e.dst] += 1
        ready = [n for n in self.order if indeg[n] == 0]
        out: list[str] = []
        while ready:
            n = ready.pop(0)
            out.append(n)
            for e in self.edges:
                if e.src == n:
                    indeg[e.dst] -= 1
                    if indeg[e.dst] == 0:
                        ready.append(e.dst)
        if len(out) != len(self.order):
            raise ValueError("DAG has a cycle")
        return out


class DagCoordinator:
    """The streaming-DAG manager: a SchedulerCore-compatible facade that
    admits downstream tasks the instant their dependencies resolve.

    Wraps an inner :class:`SchedulerCore` (or :class:`ShardedCore` when
    ``n_manager_shards`` > 1) for dispatch/exactly-once mechanics, and
    keeps the per-node frontier on top: which *original* ids each node
    has admitted / completed / failed, which nodes are sealed (admitted
    set final) and complete, and each streaming edge's emitter state.
    Every backend drives it through the same five protocol calls as a
    plain core; ``streaming = True`` tells the drive loop and the sim to
    re-kick idle workers after DONEs, because a DONE may have admitted
    fresh work to a queue those workers had already drained.
    """

    streaming = True
    #: Attached :class:`repro_torch.obs.Tracer` (None = untraced).  The
    #: drive loop and the sim discover it via
    #: ``getattr(core, "tracer", None)``.
    tracer = None

    def __init__(self, dag: StreamingDAG, *,
                 n_workers: int,
                 n_manager_shards: int = 1,
                 organization: str = "largest_first",
                 tasks_per_message: int = 1,
                 policy: Any = None,
                 organize_seed: int = 0,
                 cost_fn: Optional[Callable[[Task], float]] = None,
                 checkpoint: Optional[ManagerCheckpoint] = None,
                 speculative: bool = False,
                 speculation_max_copies: int = 2,
                 speed_model: Optional[Any] = None,
                 fleet: Optional[Any] = None):
        self.dag = dag
        self.topo = dag.toposort()
        self.out_edges: dict[str, list[_Edge]] = {n: [] for n in self.topo}
        self.in_edges: dict[str, list[_Edge]] = {n: [] for n in self.topo}
        for e in dag.edges:
            self.out_edges[e.src].append(e)
            self.in_edges[e.dst].append(e)
        # Per-node ledgers, keyed by ORIGINAL task id.
        self.node_admitted: dict[str, dict[str, Task]] = {
            n: {} for n in self.topo}
        self.node_completed: dict[str, set[str]] = {n: set()
                                                    for n in self.topo}
        self.node_failed: dict[str, set[str]] = {n: set() for n in self.topo}
        self.sealed: set[str] = set()
        self.complete: set[str] = set()
        #: Open nodes (live admission) and the subset already closed.
        self.open_nodes: set[str] = {n for n in self.topo
                                     if dag.nodes[n].open}
        self._closed: set[str] = set()
        # Edge runtime flags live here (not on the shared _Edge objects).
        self._edge_primed = [False] * len(dag.edges)
        self._edge_finished = [False] * len(dag.edges)

        outstanding: list[Task] = []
        pstate = (checkpoint.policy_state if checkpoint is not None
                  else None)
        rstate = (checkpoint.runtime_state if checkpoint is not None
                  else None)
        if checkpoint is not None and checkpoint.frontier:
            fr = checkpoint.frontier
            self._closed = set(fr.get("closed", [])) & self.open_nodes
            for name, doc in fr.get("nodes", {}).items():
                if name not in self.node_admitted:
                    continue
                self.node_completed[name] |= set(doc.get("completed", []))
                self.node_failed[name] |= set(doc.get("failed", []))
                for td in doc.get("outstanding", []):
                    t = Task(task_id=td["id"],
                             size_bytes=int(td.get("size", 0)),
                             timestamp=float(td.get("ts", 0.0)),
                             payload=td.get("payload"),
                             cpu_cost_hint=td.get("hint"))
                    self.node_admitted[name][t.task_id] = t
                    outstanding.append(self._namespaced(name, t))
            for i, ed in enumerate(fr.get("edges", [])):
                if i >= len(dag.edges):
                    break
                self._edge_primed[i] = bool(ed.get("primed", False))
                self._edge_finished[i] = bool(ed.get("finished", False))
                em = dag.edges[i].emitter
                if em is not None and ed.get("state") is not None:
                    em.restore(ed["state"])
        else:
            for name in self.topo:
                for t in (dag.nodes[name].tasks or []):
                    if t.task_id in self.node_admitted[name]:
                        raise ValueError(
                            f"duplicate task {t.task_id!r} in node {name!r}")
                    self.node_admitted[name][t.task_id] = t
                    outstanding.append(self._namespaced(name, t))

        inner_ck = (ManagerCheckpoint(set(), [], policy_state=pstate,
                                      runtime_state=rstate)
                    if (pstate or rstate) else None)
        if n_manager_shards > 1:
            self.inner: Any = ShardedCore(
                outstanding, n_shards=n_manager_shards, n_workers=n_workers,
                organization=organization,
                tasks_per_message=tasks_per_message,
                checkpoint=inner_ck,
                organize_seed=organize_seed, policy=policy, cost_fn=cost_fn,
                speculative=speculative,
                speculation_max_copies=speculation_max_copies,
                speed_model=speed_model)
        else:
            pol = get_policy(policy, tasks_per_message=tasks_per_message,
                             n_workers=n_workers, cost_fn=cost_fn)
            self.inner = SchedulerCore(
                outstanding, organization=organization,
                tasks_per_message=tasks_per_message,
                checkpoint=inner_ck,
                organize_seed=organize_seed, policy=pol,
                n_workers=n_workers,
                speculative=speculative,
                speculation_max_copies=speculation_max_copies,
                speed_model=speed_model, fleet=fleet)
        self._cascade()

    # -- tracing -----------------------------------------------------------

    def attach_tracer(self, tracer, shard: int = 0) -> None:
        """Attach a :class:`repro_torch.obs.Tracer`: DAG admissions and
        node seal/complete transitions become ``dag``-category instants, and
        the inner core emits the task-lifecycle events.  Attach before
        the drive loop starts (the sim attaches after binding its
        virtual clock, so instants land on simulated time)."""
        self.tracer = tracer
        if tracer is not None and hasattr(self.inner, "attach_tracer"):
            self.inner.attach_tracer(tracer)

    # -- namespacing -------------------------------------------------------

    @staticmethod
    def _namespaced(node: str, t: Task) -> Task:
        return Task(task_id=f"{node}{_SEP}{t.task_id}",
                    size_bytes=t.size_bytes, timestamp=t.timestamp,
                    payload=t.payload, cpu_cost_hint=t.cpu_cost_hint)

    @staticmethod
    def split_id(task_id: str) -> tuple[str, str]:
        node, _, oid = task_id.partition(_SEP)
        return node, oid

    # -- frontier mechanics ------------------------------------------------

    def _admit(self, node: str, tasks: Sequence[Task]) -> list[Task]:
        """Admit downstream tasks, deduped against the node's full
        history (admitted + completed + failed — exactly-once across
        re-emission AND across restarts)."""
        fresh: list[Task] = []
        for t in tasks or []:
            if (t.task_id in self.node_admitted[node]
                    or t.task_id in self.node_completed[node]
                    or t.task_id in self.node_failed[node]):
                continue
            self.node_admitted[node][t.task_id] = t
            fresh.append(self._namespaced(node, t))
        if fresh:
            self.inner.admit(fresh)
            if self.tracer is not None:
                self.tracer.emit(self.tracer.now(), -1.0, "admit", "dag",
                                 node, extra=len(fresh))
        return fresh

    def _is_sealed(self, name: str) -> bool:
        if name in self.open_nodes and name not in self._closed:
            return False
        return all(e.src in self.complete for e in self.in_edges[name])

    # -- live admission (open nodes) ---------------------------------------

    def admit_node(self, name: str, tasks: Sequence[Task]) -> int:
        """Externally admit tasks to an open node mid-run (a service's
        ingest loop calling in from :func:`run_service`'s ``tick``).
        Deduped exactly-once like every other admission; returns the
        number actually admitted.  Raises once the node is sealed —
        admission after :meth:`close_node` is a caller bug."""
        if name not in self.node_admitted:
            raise KeyError(f"unknown node {name!r}")
        if name in self.sealed:
            raise RuntimeError(
                f"node {name!r} is sealed; no further admission")
        return len(self._admit(name, tasks))

    def close_node(self, name: str) -> None:
        """Declare an open node's external stream finished: the node can
        now seal (priming out-edge emitters) and complete once its
        admitted tasks resolve.  Idempotent."""
        if name not in self.open_nodes:
            raise KeyError(f"node {name!r} is not open")
        self._closed.add(name)
        self._cascade()

    def _is_complete(self, name: str) -> bool:
        comp, fail = self.node_completed[name], self.node_failed[name]
        return all(oid in comp or oid in fail
                   for oid in self.node_admitted[name])

    def _cascade(self) -> None:
        """Propagate seal/complete transitions to a fixpoint: sealing a
        node primes its out-edge emitters; completing a node fires
        barrier edges and flushes streaming emitters, which may admit
        tasks that complete further nodes (empty phases collapse
        instantly)."""
        changed = True
        while changed:
            changed = False
            for name in self.topo:
                if name not in self.sealed and self._is_sealed(name):
                    self.sealed.add(name)
                    if self.tracer is not None:
                        self.tracer.emit(self.tracer.now(), -1.0,
                                         "node_sealed", "dag", name)
                    for e in self.out_edges[name]:
                        i = self.dag.edges.index(e)
                        if e.emitter is not None and not self._edge_primed[i]:
                            e.emitter.prime(sorted(self.node_admitted[name]))
                            self._edge_primed[i] = True
                    changed = True
                if name in self.sealed and name not in self.complete \
                        and self._is_complete(name):
                    self.complete.add(name)
                    if self.tracer is not None:
                        self.tracer.emit(self.tracer.now(), -1.0,
                                         "node_complete", "dag", name)
                    for e in self.out_edges[name]:
                        i = self.dag.edges.index(e)
                        if self._edge_finished[i]:
                            continue
                        self._edge_finished[i] = True
                        if e.on_complete is not None:
                            self._admit(e.dst, list(e.on_complete() or []))
                        elif e.emitter is not None:
                            self._admit(e.dst, list(e.emitter.finish() or []))
                    changed = True

    # -- SchedulerCore facade ----------------------------------------------

    @property
    def pending(self):
        return self.inner.pending

    @property
    def total(self) -> int:
        return self.inner.total

    @property
    def completed(self) -> set:
        return self.inner.completed

    @property
    def failures(self) -> dict:
        return self.inner.failures

    @property
    def dead(self) -> set:
        return self.inner.dead

    @property
    def messages_sent(self) -> int:
        return self.inner.messages_sent

    @property
    def shard_messages(self) -> list[int]:
        return list(getattr(self.inner, "shard_messages", []) or [])

    @property
    def reassigned(self) -> int:
        return self.inner.reassigned

    @property
    def batches(self) -> list[tuple[str, ...]]:
        return self.inner.batches

    @property
    def done(self) -> bool:
        return len(self.complete) == len(self.topo)

    @property
    def speculative(self) -> bool:
        return bool(getattr(self.inner, "speculative", False))

    @property
    def speculated(self) -> int:
        return int(getattr(self.inner, "speculated", 0) or 0)

    @property
    def extra_messages(self) -> int:
        return int(getattr(self.inner, "extra_messages", 0) or 0)

    @property
    def wasted_seconds(self) -> float:
        return float(getattr(self.inner, "wasted_seconds", 0.0) or 0.0)

    @property
    def fleet(self):
        return getattr(self.inner, "fleet", None)

    def idle(self, worker: Any) -> bool:
        return self.inner.idle(worker)

    def task(self, task_id: str) -> Task:
        return self.inner.task(task_id)

    def next_batch(self, worker: Any) -> tuple[Task, ...]:
        return self.inner.next_batch(worker)

    def speculate(self, worker: Any) -> tuple[Task, ...]:
        spec = getattr(self.inner, "speculate", None)
        return spec(worker) if spec is not None else ()

    def observe_speed(self, worker: Any, task_ids: Sequence[str],
                      busy_seconds: float) -> None:
        obs = getattr(self.inner, "observe_speed", None)
        if obs is not None:
            obs(worker, task_ids, busy_seconds)

    def record_waste(self, worker: Any, seconds: float) -> None:
        waste = getattr(self.inner, "record_waste", None)
        if waste is not None:
            waste(worker, seconds)

    def on_done(self, worker: Any, task_ids: Sequence[str],
                results: Optional[Sequence[Any]] = None) -> list[str]:
        """Record DONEs, then feed each fresh completion to its node's
        out-edge emitters — downstream tasks are admitted *inside* this
        call, so the caller's next dispatch already sees them.
        ``results`` align with ``task_ids`` (None on sim)."""
        fresh = self.inner.on_done(worker, task_ids, results)
        res = dict(zip(task_ids, results)) if results else {}
        for tid in fresh:
            name, oid = self.split_id(tid)
            self.node_completed[name].add(oid)
            task = self.node_admitted[name].get(oid)
            if task is None:
                continue
            for e in self.out_edges[name]:
                i = self.dag.edges.index(e)
                if e.emitter is not None and not self._edge_finished[i]:
                    self._admit(e.dst,
                                list(e.emitter.feed(task, res.get(tid))
                                     or []))
        self._cascade()
        return fresh

    def on_failed(self, worker: Any, task_ids: Sequence[str],
                  error: Optional[str] = None) -> None:
        self.inner.on_failed(worker, task_ids, error)
        for tid in task_ids:
            name, oid = self.split_id(tid)
            if oid not in self.node_completed[name]:
                self.node_failed[name].add(oid)
        self._cascade()

    def mark_dead(self, worker: Any) -> list[Task]:
        return self.inner.mark_dead(worker)

    # -- checkpoint --------------------------------------------------------

    def checkpoint(self) -> ManagerCheckpoint:
        """Serialize the DAG frontier: per-node completed/failed ids plus
        full task docs for outstanding (admitted, unresolved) tasks —
        streamed tasks cannot be rebuilt from a static list — and each
        edge's primed/finished flags + emitter state."""
        inner_ck = self.inner.checkpoint()
        completed: set[str] = set()
        nodes: dict[str, dict] = {}
        for name in self.topo:
            comp, fail = self.node_completed[name], self.node_failed[name]
            outstanding = [
                {"id": t.task_id, "size": t.size_bytes, "ts": t.timestamp,
                 "payload": t.payload, "hint": t.cpu_cost_hint}
                for oid, t in self.node_admitted[name].items()
                if oid not in comp and oid not in fail]
            nodes[name] = {"completed": sorted(comp),
                           "failed": sorted(fail),
                           "outstanding": outstanding}
            completed |= {f"{name}{_SEP}{oid}" for oid in comp}
        edges = [{"primed": self._edge_primed[i],
                  "finished": self._edge_finished[i],
                  "state": (e.emitter.state() if e.emitter is not None
                            else None)}
                 for i, e in enumerate(self.dag.edges)]
        return ManagerCheckpoint(
            completed, inner_ck.pending_ids,
            policy_state=inner_ck.policy_state,
            frontier={"nodes": nodes, "edges": edges,
                      "closed": sorted(self._closed)},
            runtime_state=inner_ck.runtime_state)


class _DagRouter:
    """Worker-side dispatcher for live backends: strips the node prefix,
    rebuilds the original Task, and calls that node's worker fn.
    Picklable as long as every node fn is (module-level callables /
    instances — the same constraint run_job already imposes)."""

    def __init__(self, fns: dict[str, Any]):
        self._fns = fns

    @staticmethod
    def _orig(task: Task) -> tuple[str, Task]:
        name, _, oid = task.task_id.partition(_SEP)
        return name, Task(task_id=oid, size_bytes=task.size_bytes,
                          timestamp=task.timestamp, payload=task.payload,
                          cpu_cost_hint=task.cpu_cost_hint)

    def _fn(self, name: str):
        fn = self._fns.get(name)
        if fn is None:
            raise RuntimeError(f"phase node {name!r} has no worker fn")
        return fn

    def __call__(self, task: Task) -> Any:
        name, orig = self._orig(task)
        return self._fn(name)(orig)

    def process_batch(self, tasks: list[Task]) -> dict:
        """One-call batch execution: group by node, use the node's own
        process_batch when it has one, and re-namespace the result keys."""
        out: dict[str, Any] = {}
        by_node: dict[str, list[Task]] = {}
        for t in tasks:
            by_node.setdefault(t.task_id.partition(_SEP)[0], []).append(t)
        for name, group in by_node.items():
            fn = self._fn(name)
            origs = [self._orig(t)[1] for t in group]
            batch = getattr(fn, "process_batch", None)
            if batch is not None and len(origs) > 1:
                res = batch(origs)
                for t, o in zip(group, origs):
                    out[t.task_id] = (res.get(o.task_id)
                                      if isinstance(res, dict) else res)
            else:
                for t, o in zip(group, origs):
                    out[t.task_id] = fn(o)
        return out

    def take_wait_s(self) -> float:
        total = 0.0
        for fn in self._fns.values():
            tw = getattr(fn, "take_wait_s", None)
            if tw is not None:
                total += float(tw())
        return total


@dataclasses.dataclass
class DagResult:
    """A DAG run: per-node results keyed by original task id, the raw
    :class:`RunResult`, and each node's completed original-id set."""

    job_seconds: float
    run: RunResult
    node_results: dict[str, dict[str, Any]]
    node_completed: dict[str, frozenset]


def run_dag(dag: StreamingDAG, *,
            backend: str = "threads",
            n_workers: Optional[int] = None,
            triple: Optional[Any] = None,
            n_manager_shards: int = 1,
            organization: str = "largest_first",
            tasks_per_message: int = 1,
            policy: Optional[Any] = None,
            poll_interval: float = DEFAULT_POLL_INTERVAL_S,
            failure_timeout: Optional[float] = None,
            checkpoint: Optional[ManagerCheckpoint] = None,
            on_checkpoint: Optional[Callable[[ManagerCheckpoint],
                                             None]] = None,
            checkpoint_interval_s: float = 1.0,
            organize_seed: int = 0,
            raise_on_failure: bool = True,
            worker_fail_after: Optional[dict[str, int]] = None,
            cost_model: Optional[Any] = None,
            nodes: Optional[int] = None,
            nppn: Optional[int] = None,
            worker_death: Optional[dict[int, float]] = None,
            worker_speed: Optional[Sequence[float]] = None,
            speculative: bool = False,
            speculation_max_copies: int = 2,
            speed_feedback: bool = False,
            speed_model: Optional[Any] = None,
            elastic: bool = False,
            fleet: Optional[Any] = None,
            worker_slow_factor: Optional[dict[str, float]] = None,
            mp_context: Optional[str] = None,
            tracer: Optional[Any] = None) -> DagResult:
    """Execute a :class:`StreamingDAG` on one runtime backend.

    The knobs mirror :func:`repro_torch.runtime.api.run_job` (same backends,
    policies, checkpointing, fault injection, triples topology,
    speculation / speed feedback / elastic fleets), plus
    ``n_manager_shards`` for the sharded coordinator.  Passing a
    ``checkpoint`` whose ``frontier`` was produced by a previous DAG run
    resumes mid-stream: completed tasks are skipped, outstanding ones
    re-admitted, emitter state restored.  ``tracer`` attaches a
    :class:`repro_torch.obs.Tracer`: task lifecycle plus ``dag``-category
    admission and node seal/complete instants on every backend.
    """
    from repro_torch.runtime.api import BACKENDS, default_topology
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; "
                         f"choose from {BACKENDS}")
    if speed_feedback and speed_model is None:
        from repro_torch.runtime.speed import WorkerSpeedModel
        speed_model = WorkerSpeedModel()
    if elastic and fleet is None:
        from repro_torch.runtime.fleet import FleetController
        fleet = FleetController(
            min_workers=1,
            max_workers=max(2 * (n_workers or 4), (n_workers or 4) + 1))
    if fleet is not None:
        if n_manager_shards > 1:
            raise ValueError("elastic fleets require n_manager_shards=1")
        if backend == "processes":
            raise ValueError("elastic fleets support the sim and threads "
                             "backends only")
    if triple is not None:
        if n_workers is None:
            n_workers = max(triple.worker_processes, 1)
        if nodes is None:
            nodes = triple.nodes
        if nppn is None:
            nppn = triple.nppn
    if n_workers is None:
        n_workers = 4
    if n_workers < 1:
        raise ValueError("need at least one worker")
    default_nodes, default_nppn = default_topology(n_workers)
    if cost_model is None:
        from repro_torch.core.cost_model import PROCESS_PHASE
        cost_model = PROCESS_PHASE
    cost_fn = model_task_cost(
        cost_model,
        nppn=nppn if nppn is not None else default_nppn,
        nodes=nodes if nodes is not None else default_nodes)

    coord = DagCoordinator(
        dag, n_workers=n_workers, n_manager_shards=n_manager_shards,
        organization=organization, tasks_per_message=tasks_per_message,
        policy=policy, organize_seed=organize_seed, cost_fn=cost_fn,
        checkpoint=checkpoint, speculative=speculative,
        speculation_max_copies=speculation_max_copies,
        speed_model=speed_model,
        fleet=fleet if n_manager_shards == 1 else None)

    if backend == "sim":
        model_fn = None
        if any(dag.nodes[n].cost_model is not None for n in coord.topo):
            node_models = {n: dag.nodes[n].cost_model for n in coord.topo}

            def model_fn(task: Task):
                return node_models.get(task.task_id.partition(_SEP)[0])

        run = _sim.simulate_self_scheduling(
            list(coord.pending),
            n_workers=n_workers,
            nodes=nodes if nodes is not None else default_nodes,
            nppn=nppn if nppn is not None else default_nppn,
            model=cost_model,
            poll_interval=poll_interval,
            worker_death=worker_death,
            failure_timeout=(failure_timeout if failure_timeout is not None
                             else 30.0),
            worker_speed=worker_speed,
            core=coord,
            n_manager_shards=n_manager_shards,
            model_fn=model_fn,
            tracer=tracer)
        if raise_on_failure and not coord.done:
            unresolved = [n for n in coord.topo if n not in coord.complete]
            raise RuntimeError(
                f"sim DAG run ended with incomplete nodes {unresolved} "
                f"(all workers dead?)")
    else:
        if tracer is not None:
            coord.attach_tracer(tracer)
        fns = {n: dag.nodes[n].fn for n in coord.topo}
        router = _DagRouter(fns)
        heartbeat = (failure_timeout / 3 if failure_timeout is not None
                     else None)
        transport_cls = TRANSPORTS[backend]
        kwargs: dict[str, Any] = {}
        if backend == "processes" and mp_context is not None:
            kwargs["mp_context"] = mp_context
        transport = transport_cls(
            n_workers, router, batch_fn=router.process_batch,
            poll_interval=poll_interval, heartbeat_interval=heartbeat,
            worker_fail_after=worker_fail_after,
            worker_slow_factor=worker_slow_factor, **kwargs)
        run = drive(coord, transport,
                    poll_interval=poll_interval,
                    failure_timeout=failure_timeout,
                    on_checkpoint=on_checkpoint,
                    checkpoint_interval_s=checkpoint_interval_s,
                    raise_on_failure=raise_on_failure,
                    backend=backend)

    node_results: dict[str, dict[str, Any]] = {n: {} for n in coord.topo}
    for tid, res in run.results.items():
        name, oid = coord.split_id(tid)
        node_results.setdefault(name, {})[oid] = res
    return DagResult(
        job_seconds=run.job_seconds,
        run=run,
        node_results=node_results,
        node_completed={n: frozenset(coord.node_completed[n])
                        for n in coord.topo})


class _TickingCore:
    """Facade that interleaves a service ``tick`` with the existing
    :func:`~repro_torch.runtime.protocol.drive` loop.

    ``drive`` polls ``core.done`` once per iteration; this wrapper runs
    the tick there — so admission, failure detection, checkpointing and
    worker accounting all stay in the one battle-tested loop instead of
    a second hand-rolled one.  When ``tick`` returns ``False`` the
    service enters shutdown: every still-open node is closed, and
    ``drive`` drains the frontier to completion as for a batch DAG.
    """

    streaming = True

    def __init__(self, coord: DagCoordinator,
                 tick: Callable[[DagCoordinator], Any]):
        self._coord = coord
        self._tick = tick
        self._closing = False

    def __getattr__(self, name):
        return getattr(self._coord, name)

    @property
    def done(self) -> bool:
        if not self._closing:
            if self._tick(self._coord) is False:
                self._closing = True
                for n in sorted(self._coord.open_nodes
                                - self._coord._closed):
                    self._coord.close_node(n)
        return self._coord.done


def run_service(dag: StreamingDAG, *,
                tick: Callable[[DagCoordinator], Any],
                backend: str = "threads",
                n_workers: int = 2,
                n_manager_shards: int = 1,
                organization: str = "largest_first",
                tasks_per_message: int = 1,
                policy: Optional[Any] = None,
                poll_interval: float = DEFAULT_POLL_INTERVAL_S,
                failure_timeout: Optional[float] = None,
                checkpoint: Optional[ManagerCheckpoint] = None,
                on_checkpoint: Optional[Callable[[ManagerCheckpoint],
                                                 None]] = None,
                checkpoint_interval_s: float = 1.0,
                organize_seed: int = 0,
                raise_on_failure: bool = True,
                worker_fail_after: Optional[dict[str, int]] = None,
                mp_context: Optional[str] = None,
                tracer: Optional[Any] = None) -> DagResult:
    """Run a :class:`StreamingDAG` with *open* nodes as a live service.

    Unlike :func:`run_dag`, the task set is not known up front: the DAG
    must contain at least one :class:`PhaseNode` with ``open=True``, and
    ``tick(coord)`` — called once per manager loop iteration, on the
    manager thread — feeds it via :meth:`DagCoordinator.admit_node`
    (e.g. an ingest scan cutting new store shards).  Return ``False``
    from ``tick`` to begin shutdown: open nodes are closed and the loop
    drains outstanding work exactly like a batch DAG run.

    Live backends only (a *service* has no simulated clock to live on);
    everything else — exactly-once, checkpoint/resume, two-tier failure
    detection, streaming re-kicks — is inherited from ``drive``.
    """
    if backend not in TRANSPORTS:
        raise ValueError(
            f"run_service needs a live backend {sorted(TRANSPORTS)}, "
            f"got {backend!r}")
    if not any(dag.nodes[n].open for n in dag.order):
        raise ValueError("run_service needs at least one open node "
                         "(otherwise use run_dag)")
    coord = DagCoordinator(
        dag, n_workers=n_workers, n_manager_shards=n_manager_shards,
        organization=organization, tasks_per_message=tasks_per_message,
        policy=policy, organize_seed=organize_seed,
        checkpoint=checkpoint)
    if tracer is not None:
        coord.attach_tracer(tracer)
    router = _DagRouter({n: dag.nodes[n].fn for n in coord.topo})
    heartbeat = (failure_timeout / 3 if failure_timeout is not None
                 else None)
    kwargs: dict[str, Any] = {}
    if backend == "processes" and mp_context is not None:
        kwargs["mp_context"] = mp_context
    transport = TRANSPORTS[backend](
        n_workers, router, batch_fn=router.process_batch,
        poll_interval=poll_interval, heartbeat_interval=heartbeat,
        worker_fail_after=worker_fail_after, **kwargs)
    run = drive(_TickingCore(coord, tick), transport,
                poll_interval=poll_interval,
                failure_timeout=failure_timeout,
                on_checkpoint=on_checkpoint,
                checkpoint_interval_s=checkpoint_interval_s,
                raise_on_failure=raise_on_failure,
                backend=backend)
    node_results: dict[str, dict[str, Any]] = {n: {} for n in coord.topo}
    for tid, res in run.results.items():
        name, oid = coord.split_id(tid)
        node_results.setdefault(name, {})[oid] = res
    return DagResult(
        job_seconds=run.job_seconds,
        run=run,
        node_results=node_results,
        node_completed={n: frozenset(coord.node_completed[n])
                        for n in coord.topo})
