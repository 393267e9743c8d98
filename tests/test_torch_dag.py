"""Port streaming-DAG runtime: its own invariants, and parity with the
JAX package's.

The invariants are those of tests/test_dag_runtime.py, held by
``repro_torch.runtime.dag``: every (node, original-id) pair completes
exactly once on all three backends and across manager sharding, under
live and simulated worker deaths, the sim's dispatch log is bitwise
repeatable (sharded too), and a coordinator killed mid-stream resumes
from its checkpoint text into a fresh DAG with nothing lost or re-run.

Parity: the same DAG spec (a source node streaming 1:2 into a second
node, plus a barrier edge into a third) through
``repro.runtime.dag.run_dag`` and ``repro_torch.runtime.dag.run_dag`` on
the sim gives equal dispatch logs, digests, makespans, message counts
and per-node completed sets, held with exact equality (the sim is the
same float arithmetic on the same heap of events).  One ``run_service``
case (an open node fed by ``tick``) gives the reference's completed
sets.
"""

from __future__ import annotations

import random
import time

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core.cost_model as jax_cost
import repro.core.messages as jax_messages
import repro.runtime.dag as jax_dag
import repro_torch.core.cost_model as port_cost
import repro_torch.core.messages as port_messages
import repro_torch.runtime.dag as port_dag
from repro_torch.core.cost_model import PhaseCostModel
from repro_torch.core.messages import Task
from repro_torch.runtime.dag import DagCoordinator, StreamingDAG, run_dag
from repro_torch.runtime.protocol import ManagerCheckpoint

FAST = dict(poll_interval=0.002)
BACKENDS = ("threads", "processes", "sim")
SIM_MODEL_KW = dict(
    name="t", r_process=1e6, b_node=8e6, b_global=64e6,
    cpu_rate=50e6, contention_alpha=0.001, task_overhead_s=0.01,
    msg_overhead_s=0.001)
SIM_MODEL = PhaseCostModel(**SIM_MODEL_KW)

PACKAGES = {
    "jax": (jax_messages.Task, jax_dag, jax_cost.PhaseCostModel),
    "port": (port_messages.Task, port_dag, port_cost.PhaseCostModel),
}


def _tasks(n, size_fn=lambda i: (i * 37) % 23 + 1, task_cls=Task):
    return [task_cls(task_id=f"t{i:04d}", size_bytes=size_fn(i),
                     timestamp=i)
            for i in range(n)]


def _double(task):            # module-level: picklable for processes
    return task.size_bytes * 2


def _size(task):
    return task.size_bytes


def _slow_double(task):
    time.sleep(0.005)
    return task.size_bytes * 2


def _slow_size(task):
    time.sleep(0.005)
    return task.size_bytes


def _fanout(task, _result):
    """Stateless 1:2 streaming expansion (downstream sizes preserved)."""
    return [type(task)(task_id=f"{task.task_id}/{suffix}",
                       size_bytes=task.size_bytes, timestamp=task.timestamp)
            for suffix in ("x", "y")]


def _make_dag(n, *, a_fn=_double, b_fn=_size, size_fn=None):
    """Source node ``a`` (n seeded tasks) streaming 1:2 into node ``b``;
    a fresh instance per run (StreamingDAG is single-use)."""
    tasks = _tasks(n) if size_fn is None else _tasks(n, size_fn=size_fn)
    dag = StreamingDAG()
    dag.add_node("a", fn=a_fn, tasks=tasks)
    dag.add_node("b", fn=b_fn)
    dag.add_edge("a", "b", expand=_fanout)
    return dag


def _expected_ids(n):
    a_ids = {f"t{i:04d}" for i in range(n)}
    b_ids = {f"{t}/{s}" for t in a_ids for s in ("x", "y")}
    return a_ids, b_ids


# -- exactly-once across backends and manager shards --------------------


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("shards", (1, 2))
def test_dag_exactly_once_across_backends(backend, shards):
    n = 18
    dres = run_dag(_make_dag(n), backend=backend, n_workers=4,
                   n_manager_shards=shards, tasks_per_message=2,
                   cost_model=SIM_MODEL, **FAST)
    a_ids, b_ids = _expected_ids(n)
    assert dres.node_completed["a"] == a_ids
    assert dres.node_completed["b"] == b_ids
    assert dres.run.completed_ids == (
        {f"a:{t}" for t in a_ids} | {f"b:{t}" for t in b_ids})
    flat = [tid for batch in dres.run.batches for tid in batch]
    assert len(flat) == len(set(flat)) == 3 * n
    if backend != "sim":
        for i in range(n):
            oid = f"t{i:04d}"
            assert dres.node_results["a"][oid] == 2 * ((i * 37) % 23 + 1)


# -- exactly-once under worker deaths -----------------------------------


@pytest.mark.parametrize("backend", ["threads", "processes"])
def test_dag_exactly_once_under_live_worker_death(backend):
    n = 20
    dres = run_dag(_make_dag(n, a_fn=_slow_double, b_fn=_slow_size),
                   backend=backend, n_workers=5, tasks_per_message=2,
                   worker_fail_after={"w0": 3}, failure_timeout=0.5,
                   **FAST)
    a_ids, b_ids = _expected_ids(n)
    assert dres.run.failed_workers == ["w0"]
    assert dres.run.reassigned_tasks >= 1
    assert dres.node_completed["a"] == a_ids
    assert dres.node_completed["b"] == b_ids
    assert dres.run.completed_ids == (
        {f"a:{t}" for t in a_ids} | {f"b:{t}" for t in b_ids})


@pytest.mark.parametrize("shards", (1, 2))
def test_dag_exactly_once_under_sim_worker_deaths(shards):
    n = 40
    dres = run_dag(_make_dag(n, size_fn=lambda i: 10_000_000),
                   backend="sim", n_workers=10, n_manager_shards=shards,
                   worker_death={0: 5.0, 1: 9.0}, failure_timeout=2.0,
                   cost_model=SIM_MODEL, **FAST)
    a_ids, b_ids = _expected_ids(n)
    assert set(dres.run.failed_workers) == {0, 1}
    assert dres.run.reassigned_tasks >= 1
    assert dres.node_completed["a"] == a_ids
    assert dres.node_completed["b"] == b_ids


# -- dispatch determinism ------------------------------------------------


def test_dag_sim_dispatch_is_deterministic():
    n = 30
    runs = [run_dag(_make_dag(n), backend="sim", n_workers=6,
                    tasks_per_message=3, cost_model=SIM_MODEL, **FAST)
            for _ in range(2)]
    assert runs[0].run.batches == runs[1].run.batches
    assert runs[0].run.job_seconds == runs[1].run.job_seconds
    assert runs[0].run.dispatch_digest == runs[1].run.dispatch_digest


@pytest.mark.parametrize("shards", (2, 3))
def test_dag_sharded_sim_deterministic_and_equivalent(shards):
    n = 30
    base = run_dag(_make_dag(n), backend="sim", n_workers=6,
                   cost_model=SIM_MODEL, **FAST)
    first, second = [
        run_dag(_make_dag(n), backend="sim", n_workers=6,
                n_manager_shards=shards, cost_model=SIM_MODEL, **FAST)
        for _ in range(2)]
    assert first.run.batches == second.run.batches
    assert first.run.job_seconds == second.run.job_seconds
    assert len(first.run.shard_messages) == shards
    assert all(m > 0 for m in first.run.shard_messages)
    assert first.run.completed_ids == base.run.completed_ids


def test_dag_refuses_elastic_with_manager_shards():
    with pytest.raises(ValueError, match="n_manager_shards=1"):
        run_dag(_make_dag(4), backend="sim", n_workers=2,
                n_manager_shards=2, elastic=True, cost_model=SIM_MODEL)


# -- mid-stream kill / resume -------------------------------------------


@given(st.integers(0, 2 ** 31 - 1), st.integers(1, 3),
       st.integers(0, 80))
@settings(max_examples=25, deadline=None)
def test_dag_mid_stream_kill_resume_exactly_once(opseed, per_msg, steps):
    """Drive a DagCoordinator by hand for a random number of dispatch /
    partial-DONE operations, serialize its frontier checkpoint to text
    (in-flight work is lost) and resume into a coordinator over a fresh
    DAG: fresh completions before and after cover every (node, id) pair
    exactly once, streamed ``b`` tasks included."""
    n = 10
    workers = ["w0", "w1", "w2"]
    coord = DagCoordinator(_make_dag(n), n_workers=len(workers),
                           tasks_per_message=per_msg)
    rng = random.Random(opseed)
    inflight = {w: [] for w in workers}
    fresh: list[str] = []
    for _ in range(steps):
        if coord.done:
            break
        w = rng.choice(workers)
        if rng.random() < 0.6:
            inflight[w].extend(t.task_id for t in coord.next_batch(w))
        elif inflight[w]:
            take = rng.randint(1, len(inflight[w]))
            done_ids, inflight[w] = inflight[w][:take], inflight[w][take:]
            fresh.extend(coord.on_done(w, done_ids))

    ck = ManagerCheckpoint.loads(coord.checkpoint().dumps())
    coord2 = DagCoordinator(_make_dag(n), n_workers=len(workers),
                            tasks_per_message=per_msg, checkpoint=ck)
    guard = 0
    while not coord2.done:
        guard += 1
        assert guard < 10_000, "resumed DAG coordinator made no progress"
        for w in workers:
            batch = coord2.next_batch(w)
            if batch:
                fresh.extend(
                    coord2.on_done(w, [t.task_id for t in batch]))

    a_ids, b_ids = _expected_ids(n)
    assert sorted(fresh) == sorted({f"a:{t}" for t in a_ids}
                                   | {f"b:{t}" for t in b_ids})
    assert coord2.node_completed["a"] == a_ids
    assert coord2.node_completed["b"] == b_ids


# -- parity with the JAX package ----------------------------------------


def _spec_dag(pkg: str, n: int = 24):
    """``a`` (n seeded tasks, varied sizes and hints) streams 1:2 into
    ``b``; a barrier edge admits ``c``'s tasks once ``a`` completes.  Per
    node cost models exercise the sim's ``model_fn`` path."""
    task_cls, dag_mod, model_cls = PACKAGES[pkg]
    tasks = [task_cls(task_id=f"d{i % 3}/t{i:04d}",
                      size_bytes=((i * 7919) % 97 + 1) * 100_000,
                      timestamp=float((i * 13) % n),
                      cpu_cost_hint=(0.05 * ((i * 11) % 7)
                                     if i % 4 else None))
             for i in range(n)]
    dag = dag_mod.StreamingDAG()
    dag.add_node("a", tasks=tasks,
                 cost_model=model_cls(**SIM_MODEL_KW))
    dag.add_node("b")
    dag.add_node("c", cost_model=model_cls(
        **dict(SIM_MODEL_KW, name="c", cpu_rate=5e6)))
    dag.add_edge("a", "b", expand=_fanout)
    dag.add_edge("a", "c", on_complete=lambda: [
        task_cls(task_id=f"c{k:03d}", size_bytes=(k + 1) * 250_000,
                 timestamp=float(k)) for k in range(n // 3)])
    return dag


def _sim_fields(dres) -> dict:
    run = dres.run
    return {"batches": run.batches, "digest": run.dispatch_digest,
            "makespan": run.job_seconds, "messages": run.messages_sent,
            "shard_messages": list(run.shard_messages),
            "worker_times": run.worker_times,
            "completed": {k: set(v) for k, v in dres.node_completed.items()}}


@pytest.mark.parametrize("shards", (1, 2))
@pytest.mark.parametrize("policy,tpm", [("static", 2), ("sized_lpt", 1),
                                        ("adaptive_chunk", 3)])
def test_sim_dag_matches_reference(shards, policy, tpm):
    kw = dict(backend="sim", n_workers=5, n_manager_shards=shards,
              tasks_per_message=tpm, policy=policy,
              cost_model=None, **FAST)
    want = jax_dag.run_dag(_spec_dag("jax"), **kw)
    got = port_dag.run_dag(_spec_dag("port"), **kw)
    assert _sim_fields(got) == _sim_fields(want)
    assert len(got.node_completed["c"]) == 8
    assert len(got.node_completed["b"]) == 48


def test_sim_dag_worker_deaths_match_reference():
    kw = dict(backend="sim", n_workers=6, n_manager_shards=2,
              tasks_per_message=2, worker_death={0: 0.5, 3: 1.5},
              failure_timeout=1.0, **FAST)
    want = jax_dag.run_dag(_spec_dag("jax"), **kw)
    got = port_dag.run_dag(_spec_dag("port"), **kw)
    assert _sim_fields(got) == _sim_fields(want)
    assert got.run.failed_workers == want.run.failed_workers
    assert got.run.reassigned_tasks == want.run.reassigned_tasks


def _ingest(task):            # module-level: picklable for processes
    return task.size_bytes + 1


def _service_dag(pkg: str):
    task_cls, dag_mod, _model = PACKAGES[pkg]
    dag = dag_mod.StreamingDAG()
    dag.add_node("ingest", fn=_ingest, open=True)
    dag.add_node("b", fn=_size)
    dag.add_edge("ingest", "b", expand=_fanout)
    return dag, task_cls


def _run_service(pkg: str):
    dag, task_cls = _service_dag(pkg)
    dag_mod = PACKAGES[pkg][1]
    admitted: list[int] = []

    def tick(coord):
        if len(admitted) == 3:
            return False
        k = len(admitted)
        batch = [task_cls(task_id=f"g{k}/t{i}", size_bytes=10 * k + i,
                          timestamp=float(i)) for i in range(4)]
        # Each batch once more: a re-admitted duplicate is dropped.
        admitted.append(coord.admit_node("ingest", batch + batch[:2]))
        return True

    dres = dag_mod.run_service(dag, tick=tick, backend="threads",
                               n_workers=2, tasks_per_message=2, **FAST)
    return dres, admitted


def test_run_service_matches_reference():
    want, want_admitted = _run_service("jax")
    got, got_admitted = _run_service("port")
    assert got_admitted == want_admitted == [4, 4, 4]
    assert {k: set(v) for k, v in got.node_completed.items()} == \
        {k: set(v) for k, v in want.node_completed.items()}
    assert len(got.node_completed["ingest"]) == 12
    assert len(got.node_completed["b"]) == 24
    assert got.node_results["ingest"]["g2/t3"] == 24
    with pytest.raises(ValueError, match="live backend"):
        port_dag.run_service(_service_dag("port")[0], tick=lambda c: False,
                             backend="sim")
