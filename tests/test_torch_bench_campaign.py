"""Port campaign engine and CLI (``repro_torch.bench.engine``, ``paper``,
``beyond``, ``campaign``, ``compare``) vs the JAX package's.

The quick tier — the sim's Table I/II cells and headline claims, and the
threads smoke — runs on both packages; the port's ``canonical_bytes``
equal the reference's byte for byte (the sim's virtual arithmetic, the
smoke's deterministic counts and dispatch digest).  ``csv_rows`` and
``summary_lines`` equal the reference's once their wall-clock fields are
cut, and ``--list`` prints the same lines.  Each port bench CLI, run in
a fresh interpreter, leaves ``jax`` and every ``repro`` module out of
``sys.modules``.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import pytest

from repro.bench import campaign as jax_campaign
from repro.bench import engine as jax_engine
from repro.bench.schema import canonical_bytes as jax_canonical_bytes
from repro_torch.bench import all_scenarios, engine
from repro_torch.bench import campaign
from repro_torch.bench.compare import compare_docs, render_rows
from repro_torch.bench.schema import (
    CAMPAIGN_SCHEMA, canonical_bytes, validate_campaign)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(scope="module")
def quick_docs():
    return (engine.run_campaign(all_scenarios(), quick=True, device="cpu"),
            jax_engine.run_campaign(jax_campaign.all_scenarios(),
                                    quick=True))


def test_quick_tier_canonical_bytes_equal_reference(quick_docs):
    got, want = quick_docs
    assert validate_campaign(got) == []
    assert got["schema"] == CAMPAIGN_SCHEMA
    assert got["summary"]["total"] == want["summary"]["total"] > 20
    assert canonical_bytes(got) == jax_canonical_bytes(want)
    assert got["environment"]["device"] == "cpu"


def test_csv_rows_equal_reference_apart_from_wall_clock(quick_docs):
    def cut(rows):
        return [re.sub(r"^([^,]*),\d+,", r"\1,-,", row) for row in rows]
    got, want = quick_docs
    rows = engine.csv_rows(got["scenarios"])
    assert len(rows) == got["summary"]["total"]
    assert cut(rows) == cut(jax_engine.csv_rows(want["scenarios"]))


def test_summary_lines_equal_reference_apart_from_wall_clock(quick_docs):
    def cut(lines):
        return [re.sub(r"\[[0-9.]+s\]", "[-]", line) for line in lines]
    got, want = quick_docs
    assert cut(engine.summary_lines(got)) == \
        cut(jax_engine.summary_lines(want))


def test_compare_reference_against_port_has_no_regression(quick_docs):
    got, want = quick_docs
    rows, regressions = compare_docs(want, got)
    assert regressions == []
    assert len(rows) == sum(1 for r in got["scenarios"]
                            if r["metrics"].get("job_seconds", 0) > 0)
    assert all(r["delta_pct"] == 0.0 for r in rows)
    assert not any("REGRESSED" in line for line in render_rows(rows))


def test_traced_scenario_equals_reference():
    sc = next(s for s in all_scenarios() if s.name == "fig9_radar")
    jsc = next(s for s in jax_campaign.all_scenarios()
               if s.name == "fig9_radar")
    got = engine.run_scenario(sc, trace=True, device="cpu")
    want = jax_engine.run_scenario(jsc, trace=True)
    assert got["obs"] == want["obs"]
    assert got["obs"]["dropped"] == 0
    assert got["metrics"] == want["metrics"]


def test_declared_matrix_equals_reference():
    def decl(scs):
        return [(sc.name, sc.group, sc.tier, sc.run.to_dict(),
                 sc.baseline.to_dict() if sc.baseline else None,
                 [c.__dict__ for c in sc.checks]) for sc in scs]
    assert decl(all_scenarios()) == decl(jax_campaign.all_scenarios())


@pytest.mark.parametrize("argv", [["--list"], ["--quick", "--list"],
                                  ["--filter", "fig", "--list"]],
                         ids=["full", "quick", "filter"])
def test_list_output_equals_reference(argv, capsys):
    assert campaign.main(argv) == 0
    got = capsys.readouterr().out
    assert jax_campaign.main(argv) == 0
    assert got == capsys.readouterr().out


def test_cli_writes_artifact_and_gates_baseline(tmp_path, capsys):
    out = tmp_path / "c.json"
    assert campaign.main(["--quick", "--filter", "table1_c512", "--device",
                          "cpu", "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert validate_campaign(doc) == []
    assert doc["summary"]["total"] == doc["summary"]["pass"] == 3
    # the same cells against themselves: no regression
    assert campaign.main(["--quick", "--filter", "table1_c512", "--device",
                          "cpu", "--out", "-", "--baseline",
                          str(out)]) == 0
    # a baseline whose job_seconds were 20 % lower regresses
    for rec in doc["scenarios"]:
        rec["metrics"]["job_seconds"] *= 0.8
    out.write_text(json.dumps(doc))
    assert campaign.main(["--quick", "--filter", "table1_c512", "--device",
                          "cpu", "--out", "-", "--baseline",
                          str(out)]) == 1
    assert "regressed" in capsys.readouterr().out


def test_device_none_means_the_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.run_campaign(all_scenarios(), quick=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.run_scenario(all_scenarios()[0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.environment(None)
    assert engine.environment("cpu")["device"] == "cpu"


_DRIVER = r"""
import json, runpy, sys
module, argv = sys.argv[1], sys.argv[2:]
sys.argv = [module] + argv
try:
    runpy.run_module(module, run_name="__main__")
    code = 0
except SystemExit as e:
    code = e.code
print(json.dumps({
    "code": code,
    "foreign": sorted(m for m in sys.modules
                      if m == "jax" or m.startswith(("jax.", "repro.")))
               + (["repro"] if "repro" in sys.modules else []),
}))
"""


def _cli_args(tmp_path) -> dict:
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    doc = {"schema": CAMPAIGN_SCHEMA,
           "scenarios": [{"name": "x", "metrics": {"job_seconds": 1.0}}]}
    a.write_text(json.dumps(doc))
    b.write_text(json.dumps(doc))
    cpu = ["--device", "cpu", "--out", str(tmp_path / "out.json")]
    return {
        "campaign": ["--quick", "--filter", "smoke_threads"] + cpu,
        "kernels": ["--quick"] + cpu,
        "storage": ["--quick"] + cpu,
        "encounters": ["--quick", "--filter",
                       "enc_exact_tiny_dense_pallas"] + cpu,
        "scheduling": ["--quick", "--filter",
                       "sched_store_affinity"] + cpu,
        "compare": [str(a), str(b)],
    }


# The CLIs whose artifacts hold a wall-clock speed gate, by its metric.
# Under the suite's parallel load the storage feed's speedup over the
# CSV-zip path fell from 5.38 to 2.11 in a run here, and below its 2.0
# gate in one full run.
CLOCK_GATED = {"kernels": "speedup_x", "storage": "feed_speedup_x"}


@pytest.mark.parametrize("cli", ["campaign", "kernels", "storage",
                                 "encounters", "scheduling", "compare"])
def test_bench_cli_runs_without_jax(tmp_path, cli):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    proc = subprocess.run(
        [sys.executable, "-c", _DRIVER, f"repro_torch.bench.{cli}"]
        + _cli_args(tmp_path)[cli],
        capture_output=True, text=True, env=env, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    # kernels and storage: on a loaded CPU only their clock gates may
    # fail; every other gate (storage's bitwise feed and identical
    # rebuilds) must pass
    assert doc["code"] in ((0, 1) if cli in CLOCK_GATED else (0,)), \
        proc.stdout[-4000:]
    assert doc["foreign"] == []
    if cli in CLOCK_GATED:
        art = json.loads((tmp_path / "out.json").read_text())
        checks = [c for sc in art["scenarios"] for c in sc["checks"]]
        assert checks and all(c["passed"] for c in checks
                              if c["metric"] != CLOCK_GATED[cli]), checks
        if cli == "storage":
            assert any(c["metric"] == "feed_bitwise_equal" for c in checks)
