"""Port discrete-event sim and manifests vs the JAX package's.

The sim is pure Python float arithmetic on a heap of events, so the same
job spec must give the same bits in both packages: every field compared
here (dispatch log, digest, makespan, message counts, per-worker times,
per-task records) is held with exact equality.  The manifests are numpy
draws from a fixed seed and must give the same tasks (ids, sizes,
timestamps, cost hints).
"""

from __future__ import annotations

import pytest

import repro.core as jax_core
import repro.core.cost_model as jax_cost
import repro.runtime as jax_runtime
import repro.runtime.sim as jax_sim
import repro.tracks.datasets as jax_datasets
import repro_torch.core as port_core
import repro_torch.core.cost_model as port_cost
import repro_torch.runtime as port_runtime
import repro_torch.runtime.sim as port_sim
import repro_torch.tracks.datasets as port_datasets
from repro_torch.runtime.policies import POLICY_NAMES

# Each manifest cut to a few hundred tasks (a prefix of the full-scale
# population, as get_manifest's ``limit`` does).
SIM_MANIFESTS = {"smoke": 200, "heavy_tail": 300, "aerodrome_dense": 300,
                 "enroute_sparse": 300, "monday": 300}

# Small arguments where a manifest takes a count; the rest at their
# defaults (aerodrome is fixed at its 136,884 files).
MANIFEST_KW = {
    "monday": {}, "aerodrome": {}, "radar_messages": {"n_messages": 500},
    "archive": {"n_aircraft": 600}, "processing": {"n_aircraft": 800},
    "smoke": {"n": 50, "seed": 3}, "heavy_tail": {"n": 500},
    "tiny": {"n": 500}, "aerodrome_dense": {"n_aircraft": 400},
    "enroute_sparse": {"n_aircraft": 300},
}


def _rows(tasks) -> list[tuple]:
    return [(t.task_id, t.size_bytes, t.timestamp, t.payload,
             t.cpu_cost_hint) for t in tasks]


def _port_tasks(tasks):
    return [port_core.Task(*row) for row in _rows(tasks)]


def _fields(r) -> dict:
    return {"batches": r.batches, "digest": r.dispatch_digest,
            "makespan": r.job_seconds, "messages": r.messages_sent,
            "shard_messages": list(r.shard_messages),
            "completed": r.completed_ids,
            "worker_times": r.worker_times,
            "records": [(x.task_id, x.worker, x.start_s, x.end_s,
                         x.size_bytes) for x in r.task_records],
            "reassigned": r.reassigned_tasks,
            "failed": list(r.failed_workers)}


def test_manifest_registry_matches_reference():
    assert list(port_datasets.MANIFESTS) == list(jax_datasets.MANIFESTS)
    assert port_datasets.SCREEN_ROW_BYTES == jax_datasets.SCREEN_ROW_BYTES
    with pytest.raises(KeyError, match="unknown manifest"):
        port_datasets.get_manifest("nope")


@pytest.mark.parametrize("name", sorted(MANIFEST_KW))
def test_manifest_tasks_match_reference(name):
    kw = MANIFEST_KW[name]
    want = jax_datasets.get_manifest(name, **kw)
    got = port_datasets.get_manifest(name, **kw)
    assert len(got) > 0
    assert _rows(got) == _rows(want)
    assert port_datasets.manifest_stats(got) == \
        jax_datasets.manifest_stats(want)
    assert _rows(port_datasets.get_manifest(name, limit=7, **kw)) == \
        _rows(got[:7])


def test_screen_density_trails_match_reference():
    for kind in ("dense", "sparse"):
        want = jax_datasets.screen_density_trails(kind, 20, 4)
        got = port_datasets.screen_density_trails(kind, 20, 4)
        assert [r[0] for r in got] == [r[0] for r in want]
        for g, w in zip(got, want):
            for a, b in zip(g[1:], w[1:]):
                assert a.tobytes() == b.tobytes()


def test_backends_include_the_sim():
    assert port_runtime.BACKENDS == jax_runtime.BACKENDS
    assert "sim" in port_runtime.BACKENDS


@pytest.mark.parametrize("name", sorted(SIM_MANIFESTS))
@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_run_job_sim_matches_reference(name, policy):
    tasks = jax_datasets.get_manifest(name, limit=SIM_MANIFESTS[name])
    kw = dict(backend="sim", n_workers=16, tasks_per_message=3,
              policy=policy)
    want = jax_runtime.run_job(tasks, None, **kw)
    got = port_runtime.run_job(_port_tasks(tasks), None, **kw)
    assert got.backend == "sim"
    assert len(got.completed_ids) == len(tasks)
    assert _fields(got) == _fields(want)


@pytest.mark.parametrize("shards", (1, 2))
def test_run_job_sim_knobs_match_reference(shards):
    """worker_death, worker_speed, legacy_launch_penalty and manager
    shards through the sim arm of run_job."""
    tasks = jax_datasets.get_manifest("heavy_tail", limit=240)
    kw = dict(backend="sim", n_workers=12, tasks_per_message=2,
              policy="fifo_selfsched", n_manager_shards=shards,
              worker_death={1: 3.0, 5: 7.5}, failure_timeout=2.0,
              worker_speed=[1.0 + 0.25 * (i % 3) for i in range(12)],
              legacy_launch_penalty=1.18,
              cost_model=jax_core.PROCESS_PHASE)
    want = jax_runtime.run_job(tasks, None, **kw)
    got = port_runtime.run_job(_port_tasks(tasks), None, **dict(
        kw, cost_model=port_core.PROCESS_PHASE))
    assert set(got.failed_workers) == {1, 5}
    assert _fields(got) == _fields(want)


def test_run_job_sim_raises_when_every_worker_dies():
    tasks = _port_tasks(jax_datasets.get_manifest("smoke", limit=40))
    with pytest.raises(RuntimeError, match="incomplete"):
        port_runtime.run_job(tasks, None, backend="sim", n_workers=2,
                             worker_death={0: 0.0, 1: 0.0})


@pytest.mark.parametrize("policy", ["block", "cyclic"])
def test_simulate_static_matches_reference(policy):
    tasks = jax_datasets.get_manifest("archive", n_aircraft=600)
    kw = dict(n_workers=31, nodes=4, nppn=8, policy=policy,
              legacy_launch_penalty=1.18)
    want = jax_sim.simulate_static(tasks, model=jax_core.ARCHIVE_PHASE,
                                   **kw)
    got = port_sim.simulate_static(_port_tasks(tasks),
                                   model=port_core.ARCHIVE_PHASE, **kw)
    assert _fields(got) == _fields(want)
    assert port_core.assignment_imbalance(
        port_core.distribute(_port_tasks(tasks), 31, policy)) == \
        jax_core.assignment_imbalance(jax_core.distribute(tasks, 31, policy))


def test_simulate_self_scheduling_phases_match_reference():
    tasks = jax_datasets.get_manifest("monday", limit=200)
    for name in jax_core.PHASES:
        want = jax_sim.simulate_self_scheduling(
            tasks, n_workers=24, nodes=3, nppn=8,
            model=jax_core.PHASES[name], tasks_per_message=2)
        got = port_sim.simulate_self_scheduling(
            _port_tasks(tasks), n_workers=24, nodes=3, nppn=8,
            model=port_core.PHASES[name], tasks_per_message=2)
        assert _fields(got) == _fields(want), name
    assert port_cost.LEGACY_LAUNCH_PENALTY == jax_cost.LEGACY_LAUNCH_PENALTY


def test_merge_tasks_per_message_matches_reference():
    tasks = jax_datasets.get_manifest("tiny", n=1000)
    for k in (1, 7, 300):
        want = jax_sim.merge_tasks_per_message(tasks, k)
        got = port_sim.merge_tasks_per_message(_port_tasks(tasks), k)
        assert _rows(got) == _rows(want)
    assert port_core.merge_tasks_per_message is \
        port_sim.merge_tasks_per_message


def _square(task):
    return task.size_bytes ** 2


def test_run_self_scheduled_matches_reference():
    tasks = jax_datasets.get_manifest("smoke", n=40, seed=1)
    kw = dict(tasks_per_message=3, poll_interval=0.001)
    want = jax_core.run_self_scheduled(tasks, 4, _square, **kw)
    got = port_core.run_self_scheduled(_port_tasks(tasks), 4, _square, **kw)
    assert got.completed_ids == want.completed_ids
    assert got.batches == want.batches
    assert got.results == want.results
    assert isinstance(got, port_core.RunResult)
