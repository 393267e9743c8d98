"""Port storage bench (``repro_torch.bench.storage``) vs the JAX package's.

Both build their fixtures from the same specs and seeds (the synthetic
archives come from each package's ``kernels.synth_items``) and write
them through each package's store writer; the port runs its pipeline
cell on ``device="cpu"``.  On the quick acceptance cell, the cold and
uncompressed cells and the pipeline-consume cell, every deterministic
metric equals the reference's: track, point, segment and shard counts,
``bytes_on_disk``, ``bytes_per_point``, ``rebuild_identical`` and
``feed_bitwise_equal`` (which must be 1).  Feed wall times
(``measured``) are not compared.
"""

from __future__ import annotations

import dataclasses
import json
import re

import pytest

from repro.bench import storage as jax_storage
from repro_torch.bench import storage
from repro_torch.bench.compare import compare_docs
from repro_torch.bench.schema import STORAGE_SCHEMA, validate_storage

#: The quick acceptance cell, the cold cell, the pipeline-consume cell
#: and the uncompressed cell, selected by name (in the matrix's order).
CELLS = ["storage_feed_heavy_tail_store_prefetch",
         "storage_feed_cold_store_vs_zip",
         "storage_pipeline_prefetch_overlap", "storage_store_uncompressed"]
_TAG = re.compile(r"^[A-Z]+ \d+: ")


@pytest.fixture(scope="module")
def docs():
    return (storage.run_storage_campaign(filters=CELLS, device="cpu"),
            jax_storage.run_storage_campaign(filters=CELLS))


def test_docs_are_schema_valid(docs):
    got, want = docs
    assert validate_storage(got) == []
    assert got["schema"] == want["schema"] == STORAGE_SCHEMA
    assert [r["name"] for r in got["scenarios"]] == \
        [r["name"] for r in want["scenarios"]] == CELLS
    assert got["environment"]["device"] == "cpu"


@pytest.mark.parametrize("name", CELLS)
def test_cell_metrics_equal_reference(docs, name):
    got, want = (next(r for r in d["scenarios"] if r["name"] == name)
                 for d in docs)
    assert got["status"] != "error", got["error"]
    assert got["metrics"] == want["metrics"]
    assert got["spec"] == want["spec"]
    assert got["metrics"]["feed_bitwise_equal"] == 1.0
    assert got["metrics"]["rebuild_identical"] == 1.0
    assert got["metrics"]["bytes_on_disk"] > 0
    assert set(got["measured"]) == set(want["measured"])


def test_compare_reference_against_port_has_no_regression(docs):
    got, want = docs
    rows, regressions = compare_docs(want, got)
    assert regressions == []
    assert len(rows) == len(CELLS)
    assert all(r["delta_pct"] == 0.0 for r in rows)


def test_declared_matrix_is_the_references():
    def decl(mod, untag):
        out = []
        for sc in mod.storage_scenarios():
            checks = [dataclasses.asdict(c) for c in sc.checks]
            if untag:
                for c in checks:
                    c["source"] = _TAG.sub("", c["source"])
            out.append((sc.name, sc.group, sc.tier, sc.run.to_dict(),
                        sc.baseline.to_dict() if sc.baseline else None,
                        checks))
        return out
    assert decl(storage, False) == decl(jax_storage, True)


@pytest.mark.parametrize("kw", [dict(source="nope"), dict(phase="hot"),
                                dict(consume="nope"),
                                dict(workload="nope")])
def test_spec_validation(kw):
    with pytest.raises(ValueError):
        storage.StorageSpec(**kw)
    with pytest.raises(ValueError):
        jax_storage.StorageSpec(**kw)


def test_pipeline_cell_needs_a_device(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        storage.run_storage_campaign(quick=True)


def test_cli_runs_quick_tier_on_cpu(tmp_path, capsys):
    out = tmp_path / "s.json"
    code = storage.main(["--quick", "--device", "cpu", "--out", str(out)])
    doc = json.loads(out.read_text())
    assert validate_storage(doc) == []
    assert code == (1 if doc["summary"]["fail"] else 0)
    assert doc["scenarios"][0]["metrics"]["feed_bitwise_equal"] == 1.0
    assert "storage scenarios" in capsys.readouterr().out
