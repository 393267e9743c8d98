"""Port scheduling bench (``repro_torch.bench.scheduling``) vs the JAX
package's.

Both run each package's quick tier on the same specs and seeds, with one
cut for time: the streaming-DAG cell (a 3 x 12000-task chain on 1024 sim
workers, about 30 s a side on a CPU) runs at ``dataset_limit=2000`` on
both sides, so its 36000-task completion gate fails on both and is held
equal, not passed.  Every other cell runs at its declared size.

The ``sim``, ``dag_sim`` and ``elastic_panel`` cells are the sim's
virtual arithmetic, so their records equal the reference's field for
field (wall clocks aside; the check sources differ only by the
reference's leading tracker tag).  The live threads cells
(``store_feed``, ``elastic_live``) are held on their deterministic
metrics: task, shard and result counts and the shard-affinity batch
locality.  Their message and batch counts and every wall-clock figure
depend on worker timing and are not compared.
"""

from __future__ import annotations

import dataclasses
import json
import re

import pytest

from repro.bench import scheduling as jax_sched
from repro_torch.bench import scheduling as sched
from repro_torch.bench.compare import compare_docs
from repro_torch.bench.schema import (
    NONDETERMINISTIC_RECORD_KEYS, SCHEDULING_SCHEMA, validate_scheduling)

_TAG = re.compile(r"^[A-Z]+ \d+: ")
DAG_CELL = "sched_dag_stream_vs_barrier_heavy_tail"
#: Cut for time: the DAG cell's dataset_limit (declared 12000).
DAG_LIMIT = 2000
SIM_CELLS = ["sched_heavy_tail_deaths20_adaptive_chunk",
             "sched_heavy_tail_deaths20_sized_lpt", DAG_CELL,
             "sched_elastic_vs_static_panel", "sched_msgwall_shards4_w256",
             "sched_msgwall_shards4_w1024"]
LIVE_CELLS = {
    "sched_store_affinity_prefetch_wait":
        ("n_tasks", "n_shards", "tasks_completed", "batch_locality"),
    "sched_elastic_live_slow4_speculative":
        ("n_tasks", "tasks_completed", "n_results"),
}


def _quick(mod) -> list:
    out = []
    for sc in mod.scheduling_scenarios():
        if sc.tier != "quick":
            continue
        if sc.name == DAG_CELL:
            sc = dataclasses.replace(sc, run=dataclasses.replace(
                sc.run, dataset_limit=DAG_LIMIT))
        out.append(sc)
    return out


@pytest.fixture(scope="module")
def records():
    got, want = {}, {}
    cache, jax_cache = {}, {}
    for sc in _quick(sched):
        got[sc.name] = sched.run_scheduling_scenario(sc, cache,
                                                     device="cpu")
    for sc in _quick(jax_sched):
        want[sc.name] = jax_sched.run_scheduling_scenario(sc, jax_cache)
    return got, want


def _strip(rec: dict, *, reference: bool) -> dict:
    rec = json.loads(json.dumps(rec))
    for key in NONDETERMINISTIC_RECORD_KEYS:
        rec.pop(key)
    if reference:
        for c in rec["checks"]:
            c["source"] = _TAG.sub("", c["source"])
    return rec


def test_quick_tier_names_equal_reference(records):
    got, want = records
    assert list(got) == list(want)
    assert set(got) == set(SIM_CELLS) | set(LIVE_CELLS)


@pytest.mark.parametrize("name", SIM_CELLS)
def test_sim_cell_equals_reference_field_for_field(records, name):
    got, want = (r[name] for r in records)
    assert got["error"] is None, got["error"]
    assert _strip(got, reference=False) == _strip(want, reference=True)
    assert got["measured"] == want["measured"] == {}


@pytest.mark.parametrize("name", sorted(LIVE_CELLS))
def test_live_cell_deterministic_metrics_equal_reference(records, name):
    got, want = (r[name] for r in records)
    assert got["error"] is None, got["error"]
    keys = LIVE_CELLS[name]
    assert {k: got["metrics"][k] for k in keys} == \
        {k: want["metrics"][k] for k in keys}
    assert got["metrics"]["tasks_completed"] == got["metrics"]["n_tasks"]
    assert set(got["metrics"]) == set(want["metrics"])
    assert set(got["measured"]) == set(want["measured"])
    assert got["spec"] == want["spec"]


def test_store_feed_cell_attributes_its_wait(records):
    got, _ = records
    aff = got["sched_store_affinity_prefetch_wait"]
    assert aff["metrics"]["batch_locality"] == 1.0
    assert aff["measured"]["prefetch_wait_reduction_x"] > 0
    assert sum(w["wait_s"] for w in
               aff["measured"]["worker_breakdown"].values()) == \
        pytest.approx(aff["measured"]["prefetch_wait_s"])


def test_compare_reference_against_port_has_no_regression(records):
    def doc(recs):
        return {"schema": SCHEDULING_SCHEMA,
                "scenarios": [r for n, r in recs.items() if n in SIM_CELLS]}
    got, want = (doc(r) for r in records)
    rows, regressions = compare_docs(want, got)
    assert regressions == []
    assert len(rows) == len(SIM_CELLS)
    assert all(r["delta_pct"] == 0.0 for r in rows)


def test_campaign_doc_validates_and_records_the_device():
    doc = sched.run_scheduling_campaign(
        quick=True, filters=["sched_heavy_tail"], device="cpu")
    assert validate_scheduling(doc) == []
    assert doc["environment"]["device"] == "cpu"
    assert doc["summary"]["pass"] == 2


def test_declared_matrix_is_the_references():
    def decl(mod, untag):
        out = []
        for sc in mod.scheduling_scenarios():
            checks = [dataclasses.asdict(c) for c in sc.checks]
            if untag:
                for c in checks:
                    c["source"] = _TAG.sub("", c["source"])
            out.append((sc.name, sc.group, sc.tier, sc.run.to_dict(),
                        sc.baseline.to_dict() if sc.baseline else None,
                        checks))
        return out
    assert decl(sched, False) == decl(jax_sched, True)


@pytest.mark.parametrize("kw", [dict(policy="nope"), dict(kind="nope"),
                                dict(fault_profile="nope"),
                                dict(kind="sim", backend="threads"),
                                dict(kind="store_feed", backend="sim"),
                                dict(kind="elastic_live", backend="sim"),
                                dict(n_manager_shards=0),
                                dict(elastic=True, n_manager_shards=2)])
def test_spec_validation(kw):
    with pytest.raises(ValueError):
        sched.SchedulingSpec(**kw)
    with pytest.raises(ValueError):
        jax_sched.SchedulingSpec(**kw)


def test_store_feed_worker_pickles_without_its_cache():
    import pickle
    fn = sched.StoreFeedWorker("/nonexistent")
    fn._local.store = object()
    clone = pickle.loads(pickle.dumps(fn))
    assert clone.store_root == "/nonexistent"
    assert not hasattr(clone._local, "store")


def test_cli_lists_the_references_matrix(capsys):
    assert sched.main(["--list"]) == 0
    listed = capsys.readouterr().out
    assert jax_sched.main(["--list"]) == 0
    assert listed == capsys.readouterr().out
