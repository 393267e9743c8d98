"""``run_job`` — one entry point, three execution backends.

    from repro_torch.runtime import run_job
    r = run_job(tasks, fn, backend="processes",
                triple=TriplesConfig(nodes=2, nppn=8))

Backends:
  * ``threads``   — in-process worker threads (fast start, shared memory).
  * ``processes`` — one OS process per worker via multiprocessing: the
    real process isolation of triples-mode NPPN placement.
  * ``sim``       — the calibrated discrete-event engine at full LLSC
    scale (``fn`` is not executed; timing comes from ``cost_model``).

All three run the identical §II.D protocol through one
:class:`~repro_torch.runtime.protocol.SchedulerCore`, so for a fixed job spec
they produce the same completed-task set and the same dispatch log
(``RunResult.batches``).

A :class:`~repro_torch.core.triples.TriplesConfig` triple selects worker count
and placement uniformly: ``worker_processes`` (total processes minus the
manager) becomes the worker count on every backend, and nodes/NPPN feed
the sim's I/O-contention model.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

from repro_torch.core.messages import Task
from repro_torch.runtime.policies import get_policy, model_task_cost
from repro_torch.runtime.protocol import (
    DEFAULT_POLL_INTERVAL_S, ManagerCheckpoint, SchedulerCore, ShardedCore,
    drive)
from repro_torch.runtime.result import RunResult
from repro_torch.runtime.transports import TRANSPORTS
from repro_torch.runtime import sim as _sim

BACKENDS = ("threads", "processes", "sim")

__all__ = ["BACKENDS", "default_topology", "run_job"]


def default_topology(n_workers: int) -> tuple[int, int]:
    """Default (nodes, nppn) when no triple is given: NPPN 8 (the paper's
    best-performing setting), as many nodes as that implies.  Shared by
    run_job's sim branch and the cost-aware policies' task estimates, so
    both simulate the same I/O-contention topology.
    """
    return max(n_workers // 8, 1), min(n_workers, 8)


def run_job(tasks: Sequence[Task],
            fn: Optional[Callable[[Task], Any]] = None, *,
            backend: str = "threads",
            n_workers: Optional[int] = None,
            triple: Optional[Any] = None,
            organization: str = "largest_first",
            tasks_per_message: int = 1,
            policy: Optional[Any] = None,
            n_manager_shards: int = 1,
            poll_interval: float = DEFAULT_POLL_INTERVAL_S,
            failure_timeout: Optional[float] = None,
            checkpoint: Optional[ManagerCheckpoint] = None,
            on_checkpoint: Optional[Callable[[ManagerCheckpoint], None]] = None,
            checkpoint_interval_s: float = 1.0,
            organize_seed: int = 0,
            batch_fn: Optional[Callable[[list[Task]], dict]] = None,
            raise_on_failure: bool = True,
            worker_fail_after: Optional[dict[str, int]] = None,
            # cost model: sim timing AND the cost-aware policies' task
            # estimates (all backends); remaining knobs are sim-only
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
            legacy_launch_penalty: float = 1.0,
            mp_context: Optional[str] = None,
            tracer: Optional[Any] = None) -> RunResult:
    """Run a self-scheduled job on the chosen execution backend.

    ``fn`` is the per-task worker function (required for live backends,
    ignored by ``sim``).  If ``fn`` exposes a ``process_batch`` method —
    or ``batch_fn`` is passed — a multi-task ASSIGN executes as ONE call
    (e.g. one bucketed pass of the segment kernels) instead of per-task
    Python dispatch.  Task payloads should be plain strings so they
    survive every backend's message path (pickled process messages,
    JSON checkpoints) — e.g. the track workflow's store-backed tasks
    name shard ranges as ``store://<root>#shard=<id>&rows=<a>:<b>``
    URIs (:mod:`repro_torch.store.uri`) and its store-build tasks carry
    ``ShardPlan.dumps()`` JSON.  ``worker_fail_after`` / ``worker_death`` are
    fault-injection hooks (live / sim respectively).  ``on_checkpoint``
    fires on wall-clock intervals and therefore applies to the live
    backends only; the sim backend ignores it (simulated jobs rebuild
    from their task list, not from mid-run state).

    ``policy`` selects the scheduling policy (a name from
    :data:`repro_torch.runtime.policies.POLICY_NAMES` or a configured
    :class:`~repro_torch.runtime.policies.SchedulingPolicy` instance) with
    identical semantics on all three backends; the default ``static``
    keeps the historical organizer-order fixed-batch dispatch bitwise.
    Cost-aware policies (``sized_lpt``, ``adaptive_chunk``) estimate
    per-task seconds from ``cost_model`` (default: the §IV.C process
    phase) at the job's topology — on EVERY backend, so a fixed job
    spec orders and chunks identically whether it runs live or
    simulated.

    ``n_manager_shards`` > 1 partitions the pending queue by locality
    run into N coordinator shards (:class:`ShardedCore`): each shard
    owns a disjoint task partition and a contiguous block of workers,
    with work-stealing from sibling tails once a shard drains.  On the
    live backends the shards are N independent decision loops over one
    transport; on the sim backend each shard gets its own message
    clock, so ASSIGN throughput scales past the single-coordinator §V
    wall.  Requires a policy *name* (each shard instantiates its own).

    Streaming-task payload contract: tasks admitted mid-run (via
    ``core.admit`` — the streaming DAG's edge emissions,
    :mod:`repro_torch.runtime.dag`) must carry everything the worker needs in
    ``task_id`` / ``size_bytes`` / ``timestamp`` / ``payload`` /
    ``cpu_cost_hint``, with ``payload`` a plain string: those five
    fields are exactly what survives the checkpoint frontier
    (``ManagerCheckpoint.frontier``) and every transport's message
    path, so a resumed manager can re-admit the task bit-identically
    without re-running its producer.

    ``tracer`` attaches a :class:`repro_torch.obs.Tracer`: task lifecycle
    instants and exec spans are emitted on every backend (the sim binds
    its virtual clock, so traced sim runs stay bit-reproducible and
    tracing never changes a dispatch decision).

    ``speculative`` re-issues the longest-in-flight task to idle
    workers once the queue drains (at most ``speculation_max_copies``
    copies of a task; first DONE wins) — on every backend.  Speculative
    ASSIGNs are counted in ``RunResult.extra_messages``, never in
    ``batches``, so the dispatch digest still covers the primary
    schedule only.

    ``speed_feedback`` turns on online per-worker speed estimation
    (:class:`~repro_torch.runtime.speed.WorkerSpeedModel`, or pass a seeded
    ``speed_model``): cost-aware policies then size each worker's next
    chunk by its observed relative speed.  Because chunk sizes depend
    on measured timings, this is an explicit exception to the
    cross-backend bit-identical dispatch contract (sim runs stay
    deterministic per seed — virtual-clock observations).

    ``elastic`` attaches a threshold-driven
    :class:`~repro_torch.runtime.fleet.FleetController` (or pass a configured
    ``fleet``) that grows/shrinks the worker pool from observed queue
    depth and idleness — sim and threads backends, single manager
    shard only.  ``worker_slow_factor`` maps live worker ids (``"w3"``)
    to slowdown multipliers (the threads mirror of the sim's
    ``worker_speed`` straggler injection).
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; "
                         f"choose from {BACKENDS}")
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
    # One cost estimator for all backends: dispatch decisions must not
    # depend on where the job runs (the cross-backend bit-identical
    # dispatch contract covers the cost-aware policies too).
    cost_fn = model_task_cost(
        cost_model,
        nppn=nppn if nppn is not None else default_nppn,
        nodes=nodes if nodes is not None else default_nodes)
    if speed_feedback and speed_model is None:
        from repro_torch.runtime.speed import WorkerSpeedModel
        speed_model = WorkerSpeedModel()
    if elastic and fleet is None:
        from repro_torch.runtime.fleet import FleetController
        fleet = FleetController(
            min_workers=1, max_workers=max(2 * n_workers, n_workers + 1))
    if fleet is not None:
        if n_manager_shards > 1:
            raise ValueError(
                "elastic fleets require n_manager_shards=1 (the controller "
                "drives one worker pool; shards own worker blocks)")
        if backend == "processes":
            raise ValueError(
                "elastic fleets support the sim and threads backends only "
                "(ProcessTransport cannot spawn workers mid-run)")
    if n_manager_shards > 1:
        core: Any = ShardedCore(
            tasks, n_shards=n_manager_shards, n_workers=n_workers,
            organization=organization, tasks_per_message=tasks_per_message,
            checkpoint=checkpoint, organize_seed=organize_seed,
            policy=policy, cost_fn=cost_fn,
            speculative=speculative,
            speculation_max_copies=speculation_max_copies,
            speed_model=speed_model)
    else:
        policy_obj = get_policy(policy, tasks_per_message=tasks_per_message,
                                n_workers=n_workers, cost_fn=cost_fn)
        core = SchedulerCore(tasks, organization=organization,
                             tasks_per_message=tasks_per_message,
                             checkpoint=checkpoint,
                             organize_seed=organize_seed,
                             policy=policy_obj, n_workers=n_workers,
                             speculative=speculative,
                             speculation_max_copies=speculation_max_copies,
                             speed_model=speed_model, fleet=fleet)

    if backend == "sim":
        result = _sim.simulate_self_scheduling(
            list(tasks),
            n_workers=n_workers,
            nodes=nodes if nodes is not None else default_nodes,
            nppn=nppn if nppn is not None else default_nppn,
            model=cost_model,
            poll_interval=poll_interval,
            worker_death=worker_death,
            failure_timeout=(failure_timeout if failure_timeout is not None
                             else 30.0),
            legacy_launch_penalty=legacy_launch_penalty,
            worker_speed=worker_speed,
            speculative=speculative,
            core=core,
            n_manager_shards=n_manager_shards,
            tracer=tracer)
        # Same contract as the live backends: an incomplete job (e.g.
        # every simulated worker died) raises instead of returning a
        # silently partial result.
        missing = core.total - len(result.completed_ids)
        if raise_on_failure and missing > 0:
            raise RuntimeError(
                f"sim job ended with {missing} of {core.total} tasks "
                f"incomplete (all workers dead?)")
        return result

    if fn is None:
        raise ValueError(f"backend {backend!r} needs a worker fn")
    if tracer is not None:
        # Live backends: wall-clock domain, attached before the drive
        # loop so the queued-at-attach instants precede the first ASSIGN.
        core.attach_tracer(tracer)
    if batch_fn is None:
        batch_fn = getattr(fn, "process_batch", None)
    heartbeat = (failure_timeout / 3 if failure_timeout is not None else None)
    transport_cls = TRANSPORTS[backend]
    kwargs: dict[str, Any] = {}
    if backend == "processes" and mp_context is not None:
        kwargs["mp_context"] = mp_context
    transport = transport_cls(
        n_workers, fn, batch_fn=batch_fn, poll_interval=poll_interval,
        heartbeat_interval=heartbeat, worker_fail_after=worker_fail_after,
        worker_slow_factor=worker_slow_factor,
        **kwargs)
    return drive(core, transport,
                 poll_interval=poll_interval,
                 failure_timeout=failure_timeout,
                 on_checkpoint=on_checkpoint,
                 checkpoint_interval_s=checkpoint_interval_s,
                 raise_on_failure=raise_on_failure,
                 backend=backend)
