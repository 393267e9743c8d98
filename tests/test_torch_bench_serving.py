"""Port serving bench (``repro_torch.bench.serving``) vs the JAX
package's ``repro.bench.serving``.

The serving path is host work in both packages (numpy, the same codec),
so a campaign's deterministic ``metrics`` equal a fresh reference run's
exactly; ``checks`` and ``status`` are stripped before the comparison
because the latency checks record measured actuals
(tests/test_bench_serving.py:34).  The artifact uses the reference's
schema, so ``compare_docs`` diffs a reference artifact against a port
artifact.
"""

from __future__ import annotations

import copy
import json

import pytest

from repro.bench import serving as jax_serving
from repro_torch.bench import serving
from repro_torch.bench.compare import compare_docs
from repro_torch.bench.schema import (
    SERVING_SCHEMA, canonical_bytes, validate_serving)


def _strip(doc: dict) -> str:
    doc = json.loads(canonical_bytes(doc))
    for rec in doc["scenarios"]:
        rec.pop("checks", None)
        rec.pop("status", None)
    return json.dumps(doc, sort_keys=True)


@pytest.fixture(scope="module")
def docs():
    return {"jax": jax_serving.run_serving_campaign(quick=True),
            "port": serving.run_serving_campaign(quick=True)}


@pytest.fixture(scope="module")
def dag_docs():
    return {"jax": jax_serving.run_serving_campaign(
                filters=["serving_dag_fleet"]),
            "port": serving.run_serving_campaign(
                filters=["serving_dag_fleet"])}


def test_quick_campaign_is_schema_valid_and_passes(docs):
    doc = docs["port"]
    assert doc["schema"] == SERVING_SCHEMA == "repro.bench.serving/v1"
    assert validate_serving(doc) == []
    assert doc["summary"]["error"] == 0
    rec = doc["scenarios"][0]
    m = rec["metrics"]
    # Every check of a deterministic metric passes; the tiny-query p99
    # ratio is a host timing, recorded but not asserted here.
    assert [c["passed"] for c in rec["checks"] if c["metric"] in m] \
        == [True, True]
    assert m["snapshot_identical"] == 1.0
    assert m["ingest_lag_max_points"] <= rec["spec"]["run"]["target_points"]
    assert "tiny_p99_ratio" in rec["measured"]
    assert m["shards_committed"] >= 2
    assert m["generation"] == m["shards_committed"]
    # The host, as the reference records it: no device is resolved.
    assert set(doc["environment"]) == {"python", "platform"}


def test_quick_metrics_equal_reference(docs):
    assert _strip(docs["port"]) == _strip(docs["jax"])
    assert [r["metrics"] for r in docs["port"]["scenarios"]] \
        == [r["metrics"] for r in docs["jax"]["scenarios"]]
    assert [r["spec"] for r in docs["port"]["scenarios"]] \
        == [r["spec"] for r in docs["jax"]["scenarios"]]


def test_compare_reference_against_port(docs):
    rows, regressions = compare_docs(docs["jax"], docs["port"])
    assert not regressions
    lag = [r for r in rows if r["metric"] == "ingest_lag_max_points"]
    assert len(lag) == 1 and lag[0]["delta_pct"] == 0.0
    worse = copy.deepcopy(docs["port"])
    worse["scenarios"][0]["metrics"]["ingest_lag_max_points"] *= 2
    _rows, regressions = compare_docs(docs["jax"], worse, threshold=0.10)
    assert len(regressions) == 1


def test_dag_cell_matches_batch_and_reference(dag_docs):
    rec = dag_docs["port"]["scenarios"][0]
    assert rec["status"] == "pass"
    assert rec["metrics"]["snapshot_identical"] == 1.0
    # DAG-mode lag depends on worker timing: measured, not metrics.
    assert "ingest_lag_max_points" not in rec["metrics"]
    assert "ingest_lag_max_points" in rec["measured"]
    assert rec["metrics"] == dag_docs["jax"]["scenarios"][0]["metrics"]


@pytest.mark.parametrize("bad", [dict(mode="batch"), dict(n_files=0),
                                 dict(tiny_queries=0)])
def test_spec_validation_equals_reference(bad):
    for mod in (serving, jax_serving):
        with pytest.raises(ValueError):
            mod.ServingSpec(**bad)


def test_declared_matrix_equals_reference():
    port = serving.serving_scenarios()
    ref = jax_serving.serving_scenarios()
    assert [(s.name, s.group, s.tier, s.run.to_dict()) for s in port] \
        == [(s.name, s.group, s.tier, s.run.to_dict()) for s in ref]
    assert [[(c.metric, c.kind, c.expect) for c in s.checks] for s in port] \
        == [[(c.metric, c.kind, c.expect) for c in s.checks] for s in ref]
    with pytest.raises(ValueError, match="no serving scenarios"):
        serving.run_serving_campaign(filters=["no_such_cell"])


def test_summary_lines_equal_reference(docs):
    doc = docs["port"]
    assert serving.serving_summary_lines(doc) \
        == jax_serving.serving_summary_lines(doc)
    broken = copy.deepcopy(doc)
    broken["scenarios"][0].update(status="error", error="boom")
    broken["summary"]["error"] = 1
    assert serving.serving_summary_lines(broken) \
        == jax_serving.serving_summary_lines(broken)


def test_cli_writes_a_valid_artifact(tmp_path, capsys):
    out = str(tmp_path / "BENCH_serving.json")
    serving.main(["--quick", "--out", out])
    with open(out) as f:
        doc = json.load(f)
    assert validate_serving(doc) == []
    text = capsys.readouterr().out
    assert f"wrote {out}" in text and "serving_live_ingest_quick" in text
    assert serving.main(["--list"]) == 0
    listed = capsys.readouterr().out.splitlines()
    assert [ln.split()[2] for ln in listed] \
        == [s.name for s in serving.serving_scenarios()]
