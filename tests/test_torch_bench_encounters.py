"""Port encounter bench (``repro_torch.bench.encounters``) vs the JAX
package's.

Both run the quick tier (the acceptance cells, the 3000-aircraft speedup
cell included) on the same specs and seeds; the port on
``device="cpu"``, where its screen cells run the kernel's plain version.
Each screen cell's metrics equal the reference's — cells, pairs,
candidates, exactness, ``kernel_calls`` (one per cell-batch chunk, the
reference's chunking) and ``modeled_screen_seconds`` — and each policy
cell equals it field for field, ``dispatch_digest`` included.  The
reference's ``jit`` and ``pallas`` screen cells are ``kernel`` cells in
the port and keep their names, so ``compare`` pairs the two artifacts
scenario by scenario.  Wall-clock numbers (``measured``, including the
``kernel_speedup_x`` gate) are not compared; the check sources differ
only by the reference's leading tracker tag.
"""

from __future__ import annotations

import dataclasses
import json
import re

import pytest

from repro.bench import encounters as jax_enc
from repro_torch.bench import encounters as enc
from repro_torch.bench.compare import compare_docs
from repro_torch.bench.schema import ENCOUNTERS_SCHEMA, validate_encounters

#: The reference's backend names and the port's.
BACKEND = {"jit": "kernel", "pallas": "kernel", "ref": "ref", "sim": "sim"}
_TAG = re.compile(r"^[A-Z]+ \d+: ")
SCREEN_CELLS = ["enc_exact_tiny_dense_jit", "enc_exact_tiny_dense_pallas",
                "enc_dense_kernel_speedup", "enc_sparse_density"]
POLICY_CELLS = ["enc_policy_quadratic_sized_lpt",
                "enc_policy_quadratic_adaptive_chunk"]


def _untagged(checks: list) -> list:
    return [dict(c, source=_TAG.sub("", c["source"])) for c in checks]


def _port_spec(spec: dict) -> dict:
    return dict(spec, backend=BACKEND[spec["backend"]])


@pytest.fixture(scope="module")
def quick_docs():
    return (enc.run_encounter_campaign(quick=True, device="cpu"),
            jax_enc.run_encounter_campaign(quick=True))


def _record(doc, name):
    return next(r for r in doc["scenarios"] if r["name"] == name)


def test_quick_tier_names_equal_reference(quick_docs):
    got, want = quick_docs
    assert validate_encounters(got) == []
    assert got["schema"] == want["schema"] == ENCOUNTERS_SCHEMA
    assert [r["name"] for r in got["scenarios"]] == \
        [r["name"] for r in want["scenarios"]] == SCREEN_CELLS + POLICY_CELLS
    assert got["environment"]["device"] == "cpu"


@pytest.mark.parametrize("name", SCREEN_CELLS)
def test_screen_cell_metrics_equal_reference(quick_docs, name):
    got, want = (_record(d, name) for d in quick_docs)
    assert got["status"] != "error", got["error"]
    assert got["metrics"] == want["metrics"]
    assert got["metrics"]["candidate_set_equal"] == 1
    assert got["metrics"]["candidate_values_equal"] == 1
    assert got["metrics"]["kernel_calls"] >= 1
    assert got["spec"]["run"] == _port_spec(want["spec"]["run"])
    assert set(got["measured"]) == set(want["measured"])
    # every exactness gate passes (kernel_speedup_x reads a clock)
    for c in got["checks"]:
        if c["metric"] != "kernel_speedup_x":
            assert c["passed"], c


@pytest.mark.parametrize("name", POLICY_CELLS)
def test_policy_cell_equals_reference_field_for_field(quick_docs, name):
    got, want = (_record(d, name) for d in quick_docs)
    assert got["metrics"]["dispatch_digest"] == \
        want["metrics"]["dispatch_digest"]
    strip = ("timing", "checks")
    assert {k: v for k, v in got.items() if k not in strip} == \
        {k: v for k, v in want.items() if k not in strip}
    assert got["checks"] == _untagged(want["checks"])
    assert got["status"] == "pass"


def test_compare_reference_against_port_has_no_regression(quick_docs):
    got, want = quick_docs
    rows, regressions = compare_docs(want, got)
    assert regressions == []
    assert rows and all(r["delta_pct"] == 0.0 for r in rows)
    for extra in ("cells", "candidates", "max_cell_occupancy"):
        xrows, _ = compare_docs(want, got, metric=extra)
        assert all(r["delta_pct"] == 0.0 for r in xrows)


def test_declared_matrix_is_the_references():
    got = [(sc.name, sc.group, sc.tier, sc.run.to_dict(),
            sc.baseline.to_dict() if sc.baseline else None,
            [dataclasses.asdict(c) for c in sc.checks])
           for sc in enc.encounter_scenarios()]
    want = [(sc.name, sc.group, sc.tier, _port_spec(sc.run.to_dict()),
             _port_spec(sc.baseline.to_dict()) if sc.baseline else None,
             _untagged([dataclasses.asdict(c) for c in sc.checks]))
            for sc in jax_enc.encounter_scenarios()]
    assert got == want


@pytest.mark.parametrize("kw", [dict(kind="nope"), dict(backend="jit"),
                                dict(backend="pallas"),
                                dict(dataset="nope"),
                                dict(kind="policy_sim", backend="kernel"),
                                dict(kind="policy_sim", backend="sim",
                                     policy="nope"),
                                dict(fault_profile="nope")])
def test_spec_validation(kw):
    with pytest.raises(ValueError):
        enc.EncounterSpec(**kw)


def test_screen_cells_need_a_device(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        enc.run_encounter_campaign(quick=True,
                                   filters=["enc_exact_tiny_dense_pallas"])


def test_cli_runs_a_filtered_cell_on_cpu(tmp_path, capsys):
    out = tmp_path / "e.json"
    assert enc.main(["--quick", "--filter", "enc_exact_tiny_dense_pallas",
                     "--device", "cpu", "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert validate_encounters(doc) == []
    assert [r["name"] for r in doc["scenarios"]] == \
        ["enc_exact_tiny_dense_pallas"]
    assert doc["scenarios"][0]["spec"]["run"]["backend"] == "kernel"
    assert "encounter scenarios" in capsys.readouterr().out
