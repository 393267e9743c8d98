"""Scheduling-policy benchmark matrix: policy x dataset x fault x backend.

The campaign benchmarks the protocol against the paper's tables, the
kernels matrix benchmarks the device hot path, the storage matrix the
feed — this module benchmarks the *dispatch decisions* themselves: how
much makespan, worker balance, and prefetch warmth each
:mod:`repro_torch.runtime.policies` policy buys on the workloads where the
companion HPC paper says static chunking falls over (heavy-tailed task
mixes + worker deaths).  Two cell kinds share one artifact
(``BENCH_scheduling.json``, schema ``repro.bench.scheduling/v1``):

  * ``sim`` cells — the discrete-event backend at bench scale: run a
    policy against the heavy-tailed aerodrome manifest under a fault
    profile and record makespan + worker-busy quantiles + simulated
    I/O wait.  Fully deterministic per seed, so everything lands in
    ``metrics`` and regression-gates byte-stably.
  * ``store_feed`` cells — a LIVE threads-backend job over row-range
    ``store://`` tasks of a real (synthetic-content) columnar store,
    with a worker that models the store prefetch consumer: serving a
    range from its cached shard decode is free, switching shards pays
    a full decode into ``wait_s``.  Wall-clock figures land in
    ``measured``; the quick tier gates the shard_affinity-vs-fifo wait
    *ratio* (both sides measured on the same machine in the same
    process).

  * ``dag_sim`` cells — the streaming phase DAG: a
    three-phase 1:1 chain over the dataset on
    :func:`repro_torch.runtime.run_dag` vs the same phases as sequential
    barrier ``run_job`` calls; plus manager-sharding scaling cells that
    gate ``dispatch_rate_gain_x`` where the single coordinator's
    message clock flatlines (paper §V).

The quick tier is the acceptance cell set: on the heavy-tail dataset
with the 20 %-death fault profile in the sim backend, ``adaptive_chunk``
and ``sized_lpt`` each make >= 1.3x lower makespan than ``static`` with
``tasks_per_message=1``; ``shard_affinity`` reduces measured prefetch
``wait_s`` vs ``fifo_selfsched`` on the store-backed feed; the
streaming DAG makes >= 1.5x lower makespan than the barrier sequence;
and 4 manager shards dispatch >= 1.3x faster than one at 1024 workers.

Every cell is host work (the sim and the threads backend); ``device``
is resolved as every bench entry point's is and recorded in the
artifact's ``environment``.

CLI::

    PYTHONPATH=src python -m repro_torch.bench.scheduling --quick --device cpu
"""

from __future__ import annotations

import dataclasses
import json
import sys
import threading
import time
from typing import Optional, Sequence

from repro_torch.bench.engine import environment
from repro_torch.bench.scenarios import FAULT_PROFILES, Check
from repro_torch.bench.schema import (
    SCHEDULING_SCHEMA, SCHEMA_VERSION, validate_scheduling)
from repro_torch.kernels.ops import resolve_device
from repro_torch.runtime.policies import POLICY_NAMES

__all__ = ["SchedulingSpec", "SchedulingScenario", "StoreFeedWorker",
           "scheduling_scenarios", "run_scheduling_scenario",
           "run_scheduling_campaign", "scheduling_summary_lines", "main"]


@dataclasses.dataclass(frozen=True)
class SchedulingSpec:
    """One policy-bench configuration — JSON-able, hashable."""

    policy: str = "static"
    kind: str = "sim"        # sim | store_feed | dag_sim | elastic_panel
    #                        # | elastic_live
    dataset: str = "aerodrome"          # manifest name / feed fixture tag
    phase: str = "process"              # cost-model name (sim cells)
    backend: str = "sim"                # sim | threads
    n_workers: int = 64
    organization: str = "chronological"
    tasks_per_message: int = 1
    fault_profile: str = "none"
    dataset_limit: Optional[int] = 3000
    poll_interval: Optional[float] = None
    failure_timeout: Optional[float] = None
    n_manager_shards: int = 1
    speculative: bool = False
    speculation_max_copies: int = 2
    speed_feedback: bool = False
    elastic: bool = False
    seed: int = 0
    # store_feed fixture knobs (which store, how it is sliced into tasks).
    n_archives: int = 48
    segments_per_archive: int = 8
    target_points: int = 3072
    rows_per_task: int = 2

    def __post_init__(self) -> None:
        if self.policy not in POLICY_NAMES:
            raise ValueError(f"unknown policy {self.policy!r}; choose "
                             f"from {list(POLICY_NAMES)}")
        if self.kind not in ("sim", "store_feed", "dag_sim",
                             "elastic_panel", "elastic_live"):
            raise ValueError(f"unknown cell kind {self.kind!r}")
        if self.fault_profile not in FAULT_PROFILES:
            raise ValueError(
                f"unknown fault profile {self.fault_profile!r}")
        if self.kind in ("sim", "dag_sim", "elastic_panel") \
                and self.backend != "sim":
            raise ValueError(f"{self.kind} cells run on the sim backend")
        if self.n_manager_shards < 1:
            raise ValueError("n_manager_shards must be >= 1")
        if self.kind == "store_feed" and self.backend != "threads":
            raise ValueError("store_feed cells measure a live feed; "
                             "backend must be 'threads'")
        if self.kind == "elastic_live" and self.backend != "threads":
            raise ValueError("elastic_live cells spawn worker threads; "
                             "backend must be 'threads'")
        if self.elastic and self.n_manager_shards > 1:
            raise ValueError("elastic fleets need n_manager_shards=1")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def fixture_key(self) -> tuple:
        return (self.n_archives, self.segments_per_archive,
                self.target_points, self.seed)


@dataclasses.dataclass(frozen=True)
class SchedulingScenario:
    """One named scheduling-bench cell."""

    name: str
    group: str
    run: SchedulingSpec
    baseline: Optional[SchedulingSpec] = None
    checks: tuple[Check, ...] = ()
    tier: str = "full"
    notes: str = ""

    def matches(self, patterns: Sequence[str]) -> bool:
        if not patterns:
            return True
        return any(p in self.name or p in self.group for p in patterns)


# ---------------------------------------------------------------------------
# sim cells.
# ---------------------------------------------------------------------------

def _execute_sim(spec: SchedulingSpec) -> dict:
    from repro_torch.core.cost_model import PHASES
    from repro_torch.runtime import run_job
    from repro_torch.tracks.datasets import get_manifest

    tasks = get_manifest(spec.dataset, limit=spec.dataset_limit)
    model = PHASES[spec.phase]
    worker_death, worker_speed, _, _ = FAULT_PROFILES[
        spec.fault_profile].materialize(spec.n_workers, spec.seed)
    kwargs: dict = {}
    if spec.poll_interval is not None:
        kwargs["poll_interval"] = spec.poll_interval
    if spec.failure_timeout is not None:
        kwargs["failure_timeout"] = spec.failure_timeout
    result = run_job(
        tasks, None, backend="sim", n_workers=spec.n_workers,
        organization=spec.organization,
        tasks_per_message=spec.tasks_per_message,
        policy=spec.policy, cost_model=model,
        n_manager_shards=spec.n_manager_shards,
        worker_death=worker_death, worker_speed=worker_speed,
        speculative=spec.speculative,
        speculation_max_copies=spec.speculation_max_copies,
        speed_feedback=spec.speed_feedback, elastic=spec.elastic,
        organize_seed=spec.seed, raise_on_failure=False, **kwargs)
    bq = result.busy_quantiles()
    # Everything the sim reports is deterministic for a fixed spec+seed.
    metrics = {
        "n_tasks": len(tasks),
        "tasks_completed": len(result.completed_ids),
        "messages_sent": result.messages_sent,
        "n_batches": len(result.batches),
        "reassigned_tasks": result.reassigned_tasks,
        "makespan_seconds": result.job_seconds,
        "busy_p50_s": bq["p50"],
        "busy_p90_s": bq["p90"],
        "busy_p99_s": bq["p99"],
        "busy_total_s": sum(result.worker_busy),
        "wait_total_s": sum(result.worker_wait),
        "dispatch_digest": result.dispatch_digest,
        "dispatch_rate_msgs_per_s": result.dispatch_rate_msgs_per_s,
        "speculated": result.speculated,
        "extra_messages": result.extra_messages,
        "wasted_duplicate_s": result.wasted_seconds,
    }
    if result.workers_added or result.workers_retired:
        metrics["workers_added"] = result.workers_added
        metrics["workers_retired"] = result.workers_retired
    if result.shard_messages:
        metrics["n_manager_shards"] = len(result.shard_messages)
        metrics["shard_messages"] = list(result.shard_messages)
        metrics["shard_dispatch_rates_msgs_per_s"] = (
            result.shard_dispatch_rates_msgs_per_s)
    return {"metrics": metrics, "measured": {}}


def _execute_dag_sim(spec: SchedulingSpec) -> dict:
    """Streaming-DAG cell: a three-phase 1:1 chain over the dataset on
    :func:`repro_torch.runtime.run_dag`, against the barrier baseline (the
    same three phases as sequential ``run_job`` calls, each waiting for
    the previous one's slowest task).  Both sides share the cost model,
    fault profile, policy, and manager-shard count, so the speedup
    isolates the barrier removal itself.

    The workload mirrors the paper's pipeline shape: the source phase
    streams the dataset's bytes through the phase model's SHARED
    bandwidth hierarchy (at fleet scale the global Lustre term binds,
    so the fleet idles waiting on I/O), while the two downstream
    phases carry the dataset's heavy-tailed CPU costs on otherwise
    idle cores.  A barrier sequence pays T_io + T_cpu + T_cpu; the
    streaming DAG hides the CPU phases inside the I/O phase's
    bandwidth shadow — a speedup no intra-phase policy can reach."""
    from repro_torch.core.cost_model import PHASES
    from repro_torch.core.messages import Task
    from repro_torch.runtime import run_job
    from repro_torch.runtime.dag import StreamingDAG, run_dag
    from repro_torch.tracks.datasets import get_manifest

    tasks = get_manifest(spec.dataset, limit=spec.dataset_limit)
    model = PHASES[spec.phase]
    worker_death, worker_speed, _, _ = FAULT_PROFILES[
        spec.fault_profile].materialize(spec.n_workers, spec.seed)
    common = dict(
        n_workers=spec.n_workers, organization=spec.organization,
        tasks_per_message=spec.tasks_per_message, policy=spec.policy,
        cost_model=model, n_manager_shards=spec.n_manager_shards,
        worker_death=worker_death, worker_speed=worker_speed,
        organize_seed=spec.seed, raise_on_failure=False)

    # p0 carries the manifest's BYTES (I/O-bound under the phase
    # model's shared bandwidth hierarchy at this fleet size); p1/p2
    # carry the manifest's heavy-tailed CPU-cost hints on negligible
    # bytes, with the per-item rank reshuffled per phase (the big raw
    # file is not the slow track to process), so no single item chains
    # all three giants through the DAG's critical path.
    import random
    phase_hints: list[dict[str, float]] = []
    for phase in (1, 2):
        hints = [t.cpu_cost_hint or 0.0 for t in tasks]
        random.Random(spec.seed * 7919 + phase).shuffle(hints)
        phase_hints.append({t.task_id: h for t, h in zip(tasks, hints)})

    def cpu_tasks(phase: int) -> list[Task]:
        return [Task(task_id=t.task_id, size_bytes=1, timestamp=t.timestamp,
                     cpu_cost_hint=phase_hints[phase - 1][t.task_id])
                for t in tasks]

    def relabel(phase: int):
        def expand(task: Task, _result) -> list[Task]:
            # 1:1 expansion at the next phase's cost for this item;
            # namespacing keeps the ids distinct on the wire.
            return [Task(task_id=task.task_id, size_bytes=1,
                         timestamp=task.timestamp,
                         cpu_cost_hint=phase_hints[phase - 1][task.task_id])]
        return expand

    dag = StreamingDAG()
    dag.add_node("p0", tasks=list(tasks))
    dag.add_node("p1")
    dag.add_node("p2")
    dag.add_edge("p0", "p1", expand=relabel(1))
    dag.add_edge("p1", "p2", expand=relabel(2))
    dres = run_dag(dag, backend="sim", **common)
    pipelined = dres.run

    barrier_makespan = 0.0
    barrier_messages = 0
    barrier_completed = 0
    for phase_tasks in (list(tasks), cpu_tasks(1), cpu_tasks(2)):
        r = run_job(phase_tasks, None, backend="sim", **common)
        barrier_makespan += r.job_seconds
        barrier_messages += r.messages_sent
        barrier_completed += len(r.completed_ids)

    completed = sum(len(c) for c in dres.node_completed.values())
    metrics = {
        "n_tasks": 3 * len(tasks),
        "tasks_completed": completed,
        "messages_sent": pipelined.messages_sent,
        "makespan_seconds": pipelined.job_seconds,
        "barrier_makespan_seconds": barrier_makespan,
        "barrier_messages_sent": barrier_messages,
        "barrier_tasks_completed": barrier_completed,
        "makespan_speedup_x": (barrier_makespan / pipelined.job_seconds
                               if pipelined.job_seconds else 0.0),
        "dispatch_rate_msgs_per_s": pipelined.dispatch_rate_msgs_per_s,
        "dispatch_digest": pipelined.dispatch_digest,
    }
    if pipelined.shard_messages:
        metrics["n_manager_shards"] = len(pipelined.shard_messages)
        metrics["shard_messages"] = list(pipelined.shard_messages)
    return {"metrics": metrics, "measured": {}}


# ---------------------------------------------------------------------------
# elastic cells.
# ---------------------------------------------------------------------------

#: Every static-fleet policy the elastic stack must beat — the panel
#: runs ALL of them under the identical fault regime, so the acceptance
#: gate compares against the best static cell, not a cherry-picked one.
_STATIC_PANEL_POLICIES = ("static", "fifo_selfsched", "sized_lpt",
                          "adaptive_chunk")


def _execute_elastic_panel(spec: SchedulingSpec) -> dict:
    """Acceptance cell: the full elastic stack (speculation +
    speed-fed sizing + threshold autoscaler) against every static-fleet
    policy under the same deaths+stragglers storm.  The headline metric
    ``makespan_speedup_vs_best_static_x`` divides the BEST static
    makespan by the elastic one; the gate is >= 1.2x.  Deaths shrink a
    static fleet permanently while the controller re-grows capacity,
    and speculation cuts the 4x-slow straggler tail — all decisions on
    the virtual clock, so the whole panel is deterministic per seed."""
    elastic_spec = dataclasses.replace(
        spec, kind="sim", speculative=True, speed_feedback=True,
        elastic=True)
    elastic = _execute_sim(elastic_spec)
    em = elastic["metrics"]
    static_makespans: dict[str, float] = {}
    static_completed: dict[str, int] = {}
    for policy in _STATIC_PANEL_POLICIES:
        srun = _execute_sim(dataclasses.replace(
            spec, kind="sim", policy=policy, speculative=False,
            speed_feedback=False, elastic=False))
        static_makespans[policy] = srun["metrics"]["makespan_seconds"]
        static_completed[policy] = srun["metrics"]["tasks_completed"]
    best_policy = min(static_makespans, key=static_makespans.get)
    best = static_makespans[best_policy]
    metrics = dict(em)
    metrics.update({
        "static_makespans": static_makespans,
        "best_static_policy": best_policy,
        "best_static_makespan_seconds": best,
        "makespan_speedup_vs_best_static_x": (
            best / em["makespan_seconds"] if em["makespan_seconds"]
            else 0.0),
        "static_tasks_completed_min": min(static_completed.values()),
    })
    return {"metrics": metrics, "measured": {}}


class _SleepTaskWorker:
    """Fixed-cost live worker for the elastic threads cell: every task
    sleeps ``base_s``, so straggling comes only from the injected
    ``worker_slow_factor`` — the thing the cell measures."""

    def __init__(self, base_s: float = 0.02):
        self.base_s = base_s

    def __call__(self, task) -> str:
        time.sleep(self.base_s)
        return task.task_id


def _execute_elastic_live(spec: SchedulingSpec) -> dict:
    """Live threads cell: a real 4x-slow worker (``live_slow4`` ->
    ``worker_slow_factor``), real speculation, and a real autoscaler
    spawning/retiring worker threads mid-run.  Wall-clock numbers land
    in ``measured``; the exactly-once counters stay in ``metrics``."""
    from repro_torch.runtime import FleetController, run_job
    from repro_torch.tracks.datasets import get_manifest

    tasks = get_manifest(spec.dataset, limit=spec.dataset_limit)
    _, _, worker_fail_after, worker_slow_factor = FAULT_PROFILES[
        spec.fault_profile].materialize(spec.n_workers, spec.seed)
    # A live control loop needs sub-second ticks on a seconds-long job
    # (run_job's default controller paces for simulated hours).
    fleet = None
    if spec.elastic:
        fleet = FleetController(
            min_workers=1, max_workers=2 * spec.n_workers,
            interval_s=0.1, cooldown_s=0.2, queue_high_per_worker=2.0)
    result = run_job(
        tasks, _SleepTaskWorker(), backend="threads",
        n_workers=spec.n_workers,
        organization=spec.organization,
        tasks_per_message=spec.tasks_per_message,
        policy=spec.policy,
        speculative=spec.speculative,
        speculation_max_copies=spec.speculation_max_copies,
        speed_feedback=spec.speed_feedback,
        fleet=fleet,
        worker_fail_after=worker_fail_after,
        worker_slow_factor=worker_slow_factor,
        organize_seed=spec.seed,
        poll_interval=(spec.poll_interval if spec.poll_interval is not None
                       else 0.002))
    metrics = {
        "n_tasks": len(tasks),
        "tasks_completed": len(result.completed_ids),
        "n_results": len(result.results),
        "messages_sent": result.messages_sent,
        "n_batches": len(result.batches),
    }
    measured = {
        "makespan_seconds": result.job_seconds,
        "speculated": float(result.speculated),
        "extra_messages": float(result.extra_messages),
        "wasted_duplicate_s": result.wasted_seconds,
        "workers_added": float(result.workers_added),
        "workers_retired": float(result.workers_retired),
    }
    return {"metrics": metrics, "measured": measured}


# ---------------------------------------------------------------------------
# store_feed cells.
# ---------------------------------------------------------------------------

class StoreFeedWorker:
    """run_job worker fn modelling the store-backed prefetch consumer.

    Each task is a ``store://...#shard=<id>&rows=a:b`` payload.  The
    worker keeps ONE decoded shard per thread/process (exactly what the
    double-buffered prefetcher keeps warm): a task on the cached shard
    serves from memory; a task on a different shard pays the full
    read+decode, accumulated as feed wait.  ``take_wait_s()`` hands the
    wait to the runtime after every DONE batch, so it surfaces in
    ``RunResult`` per worker — the number the shard_affinity acceptance
    cell gates on.
    """

    def __init__(self, store_root: str):
        self.store_root = store_root
        self._local = threading.local()

    # One-shard-cache state is per thread (threads backend) and rebuilt
    # per process after pickling (processes backend).
    def __getstate__(self) -> dict:
        return {"store_root": self.store_root}

    def __setstate__(self, state: dict) -> None:
        self.__init__(state["store_root"])

    def _state(self):
        loc = self._local
        if not hasattr(loc, "store"):
            from repro_torch.store.reader import TrackStore
            loc.store = TrackStore(self.store_root, prefetch=0)
            loc.shard_id = None
            loc.batch = None
            loc.wait_s = 0.0
            loc.decodes = 0
        return loc

    def __call__(self, task) -> dict:
        from repro_torch.store.reader import parse_store_uri

        loc = self._state()
        _root, sel = parse_store_uri(task.payload)
        shard_id = sel["shard"]
        decoded = 0
        if loc.shard_id != shard_id:
            t0 = time.perf_counter()
            loc.batch = loc.store.read_shard_batch(shard_id)
            loc.wait_s += time.perf_counter() - t0
            loc.decodes += 1
            loc.shard_id = shard_id
            decoded = 1
        a, _, b = sel.get("rows", "").partition(":")
        lo = int(a) if a else 0
        hi = int(b) if b else len(loc.batch.items)
        items = loc.batch.items[lo:hi]
        return {"n_rows": len(items),
                "n_points": sum(len(obs["time"]) for obs, _ in items),
                "decoded": decoded}

    def take_wait_s(self) -> float:
        """Return-and-reset this thread's accumulated decode wait (the
        runtime calls it after each DONE batch — see worker_loop)."""
        loc = self._state()
        w, loc.wait_s = loc.wait_s, 0.0
        return w


def _feed_fixture(spec: SchedulingSpec) -> dict:
    """A real columnar store on disk (cached via the storage bench's
    fixture machinery, which also cleans it up at exit)."""
    from repro_torch.bench.storage import StorageSpec, _fixture

    return _fixture(StorageSpec(
        source="store", phase="warm", workload="heavy_tail",
        n_archives=spec.n_archives,
        segments_per_archive=spec.segments_per_archive,
        target_points=spec.target_points, seed=spec.seed))


def _feed_tasks(store_root: str, spec: SchedulingSpec) -> list:
    """Row-range tasks over every shard, timestamped so chronological
    order interleaves shards round-robin — the worst case for a
    locality-blind policy (consecutive FIFO tasks almost always switch
    shards) and precisely what shard_affinity is meant to undo."""
    from repro_torch.store.reader import parse_store_uri
    from repro_torch.tracks.segments import segment_tasks_from_store

    tasks = segment_tasks_from_store(store_root, granularity="rows",
                                     rows_per_task=spec.rows_per_task)
    by_shard: dict[str, list] = {}
    for t in tasks:
        _root, sel = parse_store_uri(t.payload)
        by_shard.setdefault(sel["shard"], []).append(t)
    n_shards = len(by_shard)
    for si, sid in enumerate(sorted(by_shard)):
        for ri, t in enumerate(sorted(by_shard[sid],
                                      key=lambda t: t.task_id)):
            t.timestamp = float(ri * n_shards + si)
    return tasks


def _batch_locality(batches: list, tasks: list) -> float:
    """Fraction of MULTI-task ASSIGNs whose ids share one shard (1.0 =
    every such batch is single-shard, the shard_affinity invariant).
    Single-task batches are trivially single-shard and are excluded so
    the metric cannot go vacuously true; 0.0 when the job produced no
    multi-task batch at all (the acceptance cell runs at
    tasks_per_message=2 precisely so this measures something)."""
    from repro_torch.store.reader import parse_store_uri

    shard_of = {}
    for t in tasks:
        _root, sel = parse_store_uri(t.payload)
        shard_of[t.task_id] = sel["shard"]
    multi = [b for b in batches if len(b) > 1]
    if not multi:
        return 0.0
    ok = sum(1 for b in multi
             if len({shard_of[tid] for tid in b}) == 1)
    return ok / len(multi)


def _execute_store_feed(spec: SchedulingSpec) -> dict:
    from repro_torch.runtime import run_job

    from repro_torch.store.reader import parse_store_uri

    fx = _feed_fixture(spec)
    tasks = _feed_tasks(fx["store_root"], spec)
    fn = StoreFeedWorker(fx["store_root"])
    # Warm-up decode of every shard once (page cache + lazy imports) so
    # the measured cells compare decode *scheduling*, not first-touch
    # costs that only the first cell of the process would pay.
    warm = StoreFeedWorker(fx["store_root"])._state().store
    for sid in sorted({parse_store_uri(t.payload)[1]["shard"]
                       for t in tasks}):
        warm.read_shard_batch(sid)
    result = run_job(
        tasks, fn, backend="threads", n_workers=spec.n_workers,
        organization=spec.organization,
        tasks_per_message=spec.tasks_per_message,
        policy=spec.policy,
        poll_interval=(spec.poll_interval if spec.poll_interval is not None
                       else 0.002))
    metrics = {
        "n_tasks": len(tasks),
        "n_shards": fx["n_shards"],
        "tasks_completed": len(result.completed_ids),
        "messages_sent": result.messages_sent,
        "n_batches": len(result.batches),
        "batch_locality": _batch_locality(result.batches, tasks),
    }
    measured = {
        "makespan_seconds": result.job_seconds,
        "prefetch_wait_s": sum(result.worker_wait),
        "shard_decodes": float(sum(
            r.get("decoded", 0) for r in result.results.values())),
        "worker_breakdown": result.worker_breakdown(),
    }
    return {"metrics": metrics, "measured": measured}


# ---------------------------------------------------------------------------
# Record assembly.
# ---------------------------------------------------------------------------

def _execute(spec: SchedulingSpec,
             cache: Optional[dict] = None) -> dict:
    """Run one spec; ``cache`` (keyed on the frozen spec) lets a
    campaign reuse shared baselines — the quick tier alone would
    otherwise simulate the identical static cell once per scenario."""
    if cache is not None and spec in cache:
        return cache[spec]
    out = (_execute_sim(spec) if spec.kind == "sim"
           else _execute_dag_sim(spec) if spec.kind == "dag_sim"
           else _execute_elastic_panel(spec) if spec.kind == "elastic_panel"
           else _execute_elastic_live(spec) if spec.kind == "elastic_live"
           else _execute_store_feed(spec))
    if cache is not None:
        cache[spec] = out
    return out


def run_scheduling_scenario(sc: SchedulingScenario,
                            cache: Optional[dict] = None, *,
                            device=None) -> dict:
    """Execute one scenario (plus baseline) into a BENCH record.
    ``device`` is only resolved: the cells are host work."""
    resolve_device(device)
    t0 = time.perf_counter()
    spec_doc = {"run": sc.run.to_dict(),
                "baseline": sc.baseline.to_dict() if sc.baseline else None}
    try:
        run = _execute(sc.run, cache)
        base = _execute(sc.baseline, cache) if sc.baseline else None
    except Exception as e:                 # keep the campaign going
        return {"name": sc.name, "group": sc.group, "tier": sc.tier,
                "status": "error", "spec": spec_doc,
                "metrics": {}, "measured": {}, "checks": [],
                "timing": {"wall_s": time.perf_counter() - t0},
                "error": f"{type(e).__name__}: {e}"}

    metrics = dict(run["metrics"])
    measured = dict(run["measured"])
    if base is not None:
        bm, bw = base["metrics"], base["measured"]
        if "makespan_seconds" in bm:          # sim vs sim: deterministic
            metrics["baseline_makespan_seconds"] = bm["makespan_seconds"]
            if metrics.get("makespan_seconds"):
                metrics["makespan_speedup_x"] = (
                    bm["makespan_seconds"] / metrics["makespan_seconds"])
            if bm.get("busy_p90_s"):
                metrics["busy_p90_delta_pct"] = (
                    metrics["busy_p90_s"] / bm["busy_p90_s"] - 1.0) * 100.0
        if (bm.get("dispatch_rate_msgs_per_s")
                and metrics.get("dispatch_rate_msgs_per_s")):
            # Manager-sharding cells: how much dispatch throughput the
            # extra coordinator clocks buy over the single manager.
            metrics["dispatch_rate_gain_x"] = (
                metrics["dispatch_rate_msgs_per_s"]
                / bm["dispatch_rate_msgs_per_s"])
        if "makespan_seconds" in bw:          # live vs live: wall clock
            measured["baseline_makespan_seconds"] = bw["makespan_seconds"]
            if bw.get("prefetch_wait_s") is not None:
                measured["baseline_prefetch_wait_s"] = bw["prefetch_wait_s"]
                w = measured.get("prefetch_wait_s") or 0.0
                measured["prefetch_wait_reduction_x"] = (
                    bw["prefetch_wait_s"] / w if w > 0 else float("inf"))
            if bw.get("shard_decodes"):
                measured["baseline_shard_decodes"] = bw["shard_decodes"]

    merged = {**measured, **metrics}
    checks = [c.evaluate(merged) for c in sc.checks]
    status = ("ran" if not checks
              else "pass" if all(c["passed"] for c in checks) else "fail")
    return {"name": sc.name, "group": sc.group, "tier": sc.tier,
            "status": status, "spec": spec_doc,
            "metrics": metrics, "measured": measured, "checks": checks,
            "timing": {"wall_s": time.perf_counter() - t0}, "error": None}


# ---------------------------------------------------------------------------
# The declared matrix.
# ---------------------------------------------------------------------------

#: The sim acceptance cell base: the heavy-tail dataset (many
#: small tasks under a Pareto tail with the largest near total/P — see
#: repro_torch.tracks.datasets.heavy_tail_manifest), naive arrival order, one
#: task per message, 20 % of the fleet dying mid-job — the regime where
#: the 2020 HPC companion paper shows static chunking collapsing behind
#: stragglers, and where the paper's own §V needed tasks-per-message to
#: stop the manager serializing.
_SIM_BASE = SchedulingSpec(kind="sim", dataset="heavy_tail",
                           phase="radar", backend="sim", n_workers=64,
                           organization="chronological",
                           tasks_per_message=1,
                           fault_profile="deaths_20pct",
                           dataset_limit=12_000)

_FEED_BASE = SchedulingSpec(kind="store_feed", dataset="store_heavy_tail",
                            backend="threads", n_workers=3,
                            organization="chronological",
                            tasks_per_message=1, dataset_limit=None)


def scheduling_scenarios() -> list[SchedulingScenario]:
    """policy x dataset x fault-profile x backend.

    Quick tier = the acceptance cells; full tier sweeps every
    policy over fault profiles and adds the radar-like tiny-task regime
    (where adaptive chunking pays through message-overhead amortization
    rather than tail behavior).
    """
    static_base = dataclasses.replace(_SIM_BASE, policy="static")
    fifo_feed = dataclasses.replace(_FEED_BASE, policy="fifo_selfsched")
    out = [
        SchedulingScenario(
            name="sched_heavy_tail_deaths20_adaptive_chunk",
            group="sched_makespan",
            run=dataclasses.replace(_SIM_BASE, policy="adaptive_chunk"),
            baseline=static_base,
            checks=(Check("makespan_speedup_x", "min", 1.3,
                          source="adaptive_chunk >= 1.3x vs "
                                 "static @ k=1, heavy tail, 20% deaths"),
                    Check("tasks_completed", "min", 12_000,
                          source="exactly-once under deaths")),
            tier="quick", notes="acceptance cell"),
        SchedulingScenario(
            name="sched_heavy_tail_deaths20_sized_lpt",
            group="sched_makespan",
            run=dataclasses.replace(_SIM_BASE, policy="sized_lpt"),
            baseline=static_base,
            checks=(Check("makespan_speedup_x", "min", 1.3,
                          source="sized_lpt >= 1.3x vs static "
                                 "@ k=1, heavy tail, 20% deaths"),
                    Check("tasks_completed", "min", 12_000,
                          source="exactly-once under deaths")),
            tier="quick", notes="acceptance cell"),
        SchedulingScenario(
            name="sched_store_affinity_prefetch_wait",
            group="sched_locality",
            # k=2 so the run emits real multi-task ASSIGNs — that is
            # what makes the batch_locality gate falsifiable (a k=1 run
            # is single-shard per batch by construction).
            run=dataclasses.replace(_FEED_BASE, policy="shard_affinity",
                                    tasks_per_message=2),
            baseline=fifo_feed,
            checks=(Check("prefetch_wait_reduction_x", "min", 1.2,
                          source="shard_affinity cuts measured "
                                 "prefetch wait_s vs fifo_selfsched"),
                    Check("batch_locality", "min", 1.0,
                          source="every multi-task affinity ASSIGN is "
                                 "single-shard"),),
            tier="quick", notes="acceptance cell (live feed)"),
        # The pipelined acceptance cell: the streaming DAG vs the
        # barrier sequence, same heavy-tail tasks / deaths / policy.
        SchedulingScenario(
            name="sched_dag_stream_vs_barrier_heavy_tail",
            group="sched_dag",
            # phase="organize" at 1024 workers puts p0 behind the
            # shared Lustre bandwidth cap (the paper's I/O wall), so
            # the barrier fleet idles there while the DAG overlaps the
            # CPU phases into that shadow.  fault_profile="none": the
            # deaths_20pct profile kills a FIXED worker set at absolute
            # sim times, which the barrier baseline dodges by
            # restarting the fleet at every phase boundary while the
            # single long DAG run pays permanently — that asymmetry
            # measures fleet attrition, not barrier removal.  Fault
            # handling is gated by the exactly-once cells/tests.
            run=dataclasses.replace(_SIM_BASE, kind="dag_sim",
                                    policy="fifo_selfsched",
                                    phase="organize", n_workers=1024,
                                    fault_profile="none"),
            checks=(Check("makespan_speedup_x", "min", 1.5,
                          source="streaming DAG >= 1.5x vs "
                                 "barrier phases on heavy tail"),
                    Check("tasks_completed", "min", 36_000,
                          source="exactly-once across streamed phases "
                                 "under 20% deaths")),
            tier="quick", notes="acceptance cell (3-phase chain)"),
    ]
    # The acceptance cell: the full elastic stack (speculation +
    # speed-fed sizing + autoscaler) vs EVERY static-fleet policy under
    # the combined deaths+stragglers storm — the gate compares against
    # whichever static policy does best.
    out.append(SchedulingScenario(
        name="sched_elastic_vs_static_panel",
        group="sched_elastic",
        run=dataclasses.replace(
            _SIM_BASE, kind="elastic_panel", policy="adaptive_chunk",
            fault_profile="deaths20_stragglers10"),
        checks=(Check("makespan_speedup_vs_best_static_x", "min", 1.2,
                      source="elastic+speculative+speed-fed "
                             ">= 1.2x vs the best static cell under 20% "
                             "deaths + 4x stragglers"),
                Check("tasks_completed", "min", 12_000,
                      source="exactly-once under deaths, stragglers, "
                             "speculation, and scaling"),
                Check("workers_added", "min", 1,
                      source="the controller actually grew the fleet")),
        tier="quick", notes="acceptance cell (elastic panel)"))
    # The live cell: real worker threads, a real 4x-slow straggler
    # (worker_slow_factor), real speculation and thread spawn/retire.
    # Wall-clock lands in measured; the gated metric is exactly-once.
    out.append(SchedulingScenario(
        name="sched_elastic_live_slow4_speculative",
        group="sched_elastic",
        run=dataclasses.replace(
            _SIM_BASE, kind="elastic_live", backend="threads",
            dataset="tiny", dataset_limit=80, n_workers=4,
            policy="fifo_selfsched", fault_profile="live_slow4",
            speculative=True, speed_feedback=True, elastic=True),
        checks=(Check("tasks_completed", "min", 80,
                      source="exactly-once on live threads "
                             "under a 4x straggler with speculation + "
                             "elastic scaling"),
                Check("n_results", "min", 80,
                      source="every result delivered exactly once")),
        tier="quick", notes="live cell (threads autoscaler)"))
    # The manager-sharding scaling curve: tiny radar-like tasks at
    # one task per message drive the §V message wall; the single manager
    # flatlines at 1/msg_overhead dispatches per second while four shard
    # clocks keep scaling.  stragglers_10pct wires worker_speed
    # heterogeneity through the same cells.
    msgwall = dataclasses.replace(_SIM_BASE, dataset="tiny",
                                  dataset_limit=20_000, phase="radar",
                                  policy="fifo_selfsched",
                                  fault_profile="stragglers_10pct")
    for n_workers, tier, checks in (
            (256, "quick", ()),
            (1024, "quick",
             (Check("dispatch_rate_gain_x", "min", 1.3,
                    source="4 manager shards >= 1.3x dispatch "
                           "throughput where one manager flatlines"),)),):
        out.append(SchedulingScenario(
            name=f"sched_msgwall_shards4_w{n_workers}",
            group="sched_msgwall",
            run=dataclasses.replace(msgwall, n_workers=n_workers,
                                    n_manager_shards=4),
            baseline=dataclasses.replace(msgwall, n_workers=n_workers),
            checks=checks, tier=tier,
            notes="sharded-manager dispatch-throughput scaling"))
    # Full tier: the whole policy sweep on the acceptance regime plus a
    # fault-free control (policies must not cost anything when nothing
    # goes wrong) and the tiny-task message-overhead regime.
    for policy in POLICY_NAMES:
        out.append(SchedulingScenario(
            name=f"sched_sweep_deaths20_{policy}",
            group="sched_sweep",
            run=dataclasses.replace(_SIM_BASE, policy=policy),
            baseline=(static_base if policy != "static" else None)))
        out.append(SchedulingScenario(
            name=f"sched_sweep_faultfree_{policy}",
            group="sched_sweep",
            run=dataclasses.replace(_SIM_BASE, policy=policy,
                                    fault_profile="none"),
            baseline=(dataclasses.replace(static_base,
                                          fault_profile="none")
                      if policy != "static" else None)))
    tiny = dataclasses.replace(_SIM_BASE, dataset="tiny", phase="radar",
                               dataset_limit=20_000,
                               fault_profile="none")
    out.append(SchedulingScenario(
        name="sched_tiny_msg_overhead_adaptive_chunk",
        group="sched_tiny",
        run=dataclasses.replace(tiny, policy="adaptive_chunk"),
        baseline=dataclasses.replace(tiny, policy="static"),
        notes="radar regime: chunking amortizes the serial manager"))
    out.append(SchedulingScenario(
        name="sched_store_static_vs_fifo",
        group="sched_locality",
        run=dataclasses.replace(_FEED_BASE, policy="static",
                                tasks_per_message=2),
        baseline=fifo_feed))
    return out


def run_scheduling_campaign(*, quick: bool = False,
                            filters: Sequence[str] = (),
                            seed: Optional[int] = None,
                            progress=None, device=None) -> dict:
    """Run the policy matrix into a schema-valid BENCH_scheduling doc;
    ``device`` is recorded in ``environment``."""
    device = resolve_device(device)
    selected = [sc for sc in scheduling_scenarios()
                if (not quick or sc.tier == "quick")
                and sc.matches(filters)]
    if not selected:
        raise ValueError("no scheduling scenarios match the quick/filter "
                         "selection")
    if seed is not None:
        selected = [dataclasses.replace(
            sc, run=dataclasses.replace(sc.run, seed=seed),
            baseline=(dataclasses.replace(sc.baseline, seed=seed)
                      if sc.baseline else None))
            for sc in selected]
    t0 = time.perf_counter()
    records = []
    cache: dict = {}     # one execution per distinct spec per campaign
    for sc in selected:
        rec = run_scheduling_scenario(sc, cache, device=device)
        records.append(rec)
        if progress is not None:
            progress(rec)
    counts = {s: 0 for s in ("pass", "fail", "ran", "error")}
    for rec in records:
        counts[rec["status"]] += 1
    doc = {
        "schema": SCHEDULING_SCHEMA,
        "schema_version": SCHEMA_VERSION,
        "created_at": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        "config": {"quick": quick, "filters": list(filters),
                   "seed": seed, "n_selected": len(selected)},
        "environment": environment(device),
        "scenarios": records,
        "summary": {"total": len(records), **counts,
                    "checked": sum(1 for r in records if r["checks"])},
        "timing": {"wall_s": time.perf_counter() - t0},
    }
    problems = validate_scheduling(doc)
    if problems:      # a bug in this module, not in the scenarios
        raise RuntimeError("scheduling bench produced a schema-invalid "
                           "artifact: " + "; ".join(problems[:5]))
    return doc


def scheduling_summary_lines(doc: dict) -> list[str]:
    """Human-readable summary for the CLI."""
    s = doc["summary"]
    lines = [f"{s['total']} scheduling scenarios: {s['pass']} pass, "
             f"{s['fail']} fail, {s['ran']} ran, {s['error']} error "
             f"[{doc['timing']['wall_s']:.1f}s]"]
    for rec in doc["scenarios"]:
        if rec["status"] == "error":
            lines.append(f"  ERROR {rec['name']}: {rec['error']}")
            continue
        m = {**rec["measured"], **rec["metrics"]}
        bits = [f"makespan={m['makespan_seconds']:.3g}s"]
        if "makespan_speedup_x" in m:
            bits.append(f"speedup={m['makespan_speedup_x']:.2f}x")
        if "busy_p90_s" in m:
            bits.append(f"busy_p90={m['busy_p90_s']:.3g}s")
        if "dispatch_rate_gain_x" in m:
            bits.append(f"dispatch_gain={m['dispatch_rate_gain_x']:.2f}x")
        if "prefetch_wait_s" in m:
            bits.append(f"wait={m['prefetch_wait_s'] * 1e3:.1f}ms")
        if "prefetch_wait_reduction_x" in m:
            bits.append(f"wait_cut={m['prefetch_wait_reduction_x']:.2f}x")
        if "shard_decodes" in m:
            bits.append(f"decodes={m['shard_decodes']:.0f}")
        lines.append(f"  {rec['status']:5s} {rec['name']}: "
                     + " ".join(bits))
        for c in rec["checks"]:
            if not c["passed"]:
                lines.append(f"        FAIL {c['metric']}="
                             f"{c['actual']} vs {c['kind']} {c['expect']}")
    return lines


def main(argv=None) -> int:
    """CLI: ``python -m repro_torch.bench.scheduling [--quick] [--out PATH]``."""
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.bench.scheduling",
        description="Benchmark the scheduling-policy matrix (makespan, "
                    "busy quantiles, prefetch wait); write "
                    "BENCH_scheduling.json.")
    ap.add_argument("--quick", action="store_true",
                    help="run only the quick tier (the CI acceptance "
                         "cells)")
    ap.add_argument("--filter", action="append", default=[],
                    metavar="SUBSTR")
    ap.add_argument("--out", default="BENCH_scheduling.json",
                    help="artifact path ('-' for stdout only)")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--device", default=None,
                    help="the device recorded for the run (default: the "
                         "card; the cells are host work)")
    args = ap.parse_args(argv)

    if args.list:
        for sc in scheduling_scenarios():
            if sc.matches(args.filter) and (not args.quick
                                            or sc.tier == "quick"):
                print(f"{sc.tier:5s} {sc.group:18s} {sc.name} "
                      f"[{len(sc.checks)} checks]")
        return 0

    if not any(sc.matches(args.filter) and (not args.quick
                                            or sc.tier == "quick")
               for sc in scheduling_scenarios()):
        print("no scheduling scenarios match", file=sys.stderr)
        return 1

    def progress(rec):
        print(f"  {rec['status']:5s} {rec['name']} "
              f"({rec['timing']['wall_s']:.2f}s)", flush=True)

    doc = run_scheduling_campaign(quick=args.quick, filters=args.filter,
                                  seed=args.seed, progress=progress,
                                  device=args.device)
    if args.out != "-":
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"wrote {args.out}")
    for line in scheduling_summary_lines(doc):
        print(line)
    return 1 if (doc["summary"]["fail"] or doc["summary"]["error"]) else 0


if __name__ == "__main__":
    sys.exit(main())
