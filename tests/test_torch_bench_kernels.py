"""Port kernel bench (``repro_torch.bench.kernels``) vs the JAX package's.

Both run the same specs and seeds; the port on ``device="cpu"``, where
the segment pipeline runs the kernels' plain versions.  The synthetic
archives are bitwise equal, and every deterministic metric of a record
(padding, bucket rows, pipeline calls, transfers, compile hits and
misses) equals the reference's; ``max_abs_diff_vs_baseline`` (fused vs
unfused outputs) must stay within the acceptance gate's 1e-5 on both
sides.  Specs are the reference tests' ``TINY`` (tests/test_kernel_bench.py)
and the quick acceptance cell at its own size.  Wall-clock numbers
(``measured``, ``speedup_x``) are not compared: on the CPU the port's
plain versions run eagerly where the reference's fused path is one XLA
program.
"""

from __future__ import annotations

import dataclasses
import json
import re

import numpy as np
import pytest

from repro.bench import kernels as jax_kernels
from repro_torch.bench import kernels
from repro_torch.bench.compare import compare_docs
from repro_torch.bench.schema import KERNELS_SCHEMA, validate_kernels

TINY = kernels.KernelSpec(workload="heavy_tail", n_archives=2,
                          segments_per_archive=3, repeats=1, seed=5)
JAX_TINY = jax_kernels.KernelSpec(workload="heavy_tail", n_archives=2,
                                  segments_per_archive=3, repeats=1, seed=5)

#: The reference's backend names and the port's.
BACKEND = {"pallas": "kernel", "ref": "ref"}
DIFF = "max_abs_diff_vs_baseline"
_TAG = re.compile(r"^[A-Z]+ \d+: ")


def _tiny(mod, spec):
    return mod.KernelScenario(
        name="tiny", group="tiny", run=spec,
        baseline=dataclasses.replace(spec, pipeline="unfused"))


def _same_metrics(got: dict, want: dict) -> None:
    """Deterministic metrics equal; the fused-vs-unfused difference
    within the gate on both sides."""
    assert got[DIFF] <= 1e-5 and want[DIFF] <= 1e-5
    assert {k: v for k, v in got.items() if k != DIFF} == \
        {k: v for k, v in want.items() if k != DIFF}


@pytest.fixture(scope="module")
def quick_docs():
    return (kernels.run_kernel_campaign(quick=True, device="cpu"),
            jax_kernels.run_kernel_campaign(quick=True))


@pytest.mark.parametrize("spec", [
    dataclasses.asdict(TINY),
    dataclasses.asdict(kernels.KernelSpec()),
    dataclasses.asdict(kernels.KernelSpec(workload="uniform_mix")),
    dataclasses.asdict(kernels.KernelSpec(workload="long_cruise", seed=3)),
], ids=["tiny", "heavy_tail", "uniform_mix", "long_cruise"])
def test_synth_items_bitwise_equal(spec):
    jax_spec = dict(spec, backend="pallas")
    got = kernels.synth_items(kernels.KernelSpec(**spec))
    want = jax_kernels.synth_items(jax_kernels.KernelSpec(**jax_spec))
    assert len(got) == len(want)
    for (obs, segs), (jobs, jsegs) in zip(got, want):
        assert segs == jsegs
        assert sorted(obs) == sorted(jobs)
        for col in obs:
            assert obs[col].dtype == jobs[col].dtype
            np.testing.assert_array_equal(obs[col], jobs[col])


def test_tiny_scenario_metrics_equal_reference():
    got = kernels.run_kernel_scenario(_tiny(kernels, TINY), device="cpu")
    want = jax_kernels.run_kernel_scenario(_tiny(jax_kernels, JAX_TINY))
    assert got["status"] != "error" and want["status"] != "error"
    _same_metrics(got["metrics"], want["metrics"])
    assert got["metrics"]["intermediate_transfers"] == 0
    assert got["metrics"]["baseline_intermediate_transfers"] == 4
    assert set(got["measured"]) == set(want["measured"])


def test_quick_cell_metrics_equal_reference(quick_docs):
    got, want = quick_docs
    assert validate_kernels(got) == []
    assert got["schema"] == want["schema"] == KERNELS_SCHEMA
    assert [r["name"] for r in got["scenarios"]] == \
        [r["name"] for r in want["scenarios"]] == \
        ["segment_pipeline_heavy_tail"]
    for g, w in zip(got["scenarios"], want["scenarios"]):
        _same_metrics(g["metrics"], w["metrics"])
        m = g["metrics"]
        assert m["compile_misses_steady"] == 0 and m["compile_hits_steady"] > 0
        # every deterministic gate passes on both sides; only speedup_x
        # reads a clock
        for gc, wc in zip(g["checks"], w["checks"]):
            assert gc["metric"] == wc["metric"]
            if gc["metric"] != "speedup_x":
                assert gc["passed"] and wc["passed"], (gc, wc)
    assert got["environment"]["device"] == "cpu"


def test_compare_reference_against_port_has_no_regression(quick_docs,
                                                          tmp_path,
                                                          capsys):
    got, want = quick_docs
    rows, regressions = compare_docs(want, got)
    assert regressions == []
    assert rows and all(r["delta_pct"] == 0.0 for r in rows)
    old, new = tmp_path / "ref.json", tmp_path / "port.json"
    old.write_text(json.dumps(want))
    new.write_text(json.dumps(got))
    from repro_torch.bench.compare import main
    assert main([str(old), str(new)]) == 0
    assert "no regressions" in capsys.readouterr().out


def test_declared_matrix_is_the_references():
    got = [(sc.name, sc.group, sc.tier, sc.run.to_dict(),
            sc.baseline.to_dict() if sc.baseline else None,
            [dataclasses.asdict(c) for c in sc.checks])
           for sc in kernels.kernel_scenarios()]
    want = []
    for sc in jax_kernels.kernel_scenarios():
        run = dict(sc.run.to_dict(), backend=BACKEND[sc.run.backend])
        base = (dict(sc.baseline.to_dict(),
                     backend=BACKEND[sc.baseline.backend])
                if sc.baseline else None)
        checks = [dataclasses.asdict(c) for c in sc.checks]
        for c in checks:
            c["source"] = _TAG.sub("", c["source"])
        want.append((sc.name, sc.group, sc.tier, run, base, checks))
    assert got == want


@pytest.mark.parametrize("kw", [dict(workload="nope"),
                                dict(pipeline="nope"),
                                dict(backend="pallas"),
                                dict(backend="jit")])
def test_bad_spec_rejected(kw):
    with pytest.raises(ValueError):
        kernels.KernelSpec(**kw)


def test_device_none_means_the_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernels.run_kernel_campaign(quick=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernels.run_kernel_scenario(_tiny(kernels, TINY))


def test_cli_lists_and_runs_on_cpu(tmp_path, capsys):
    assert kernels.main(["--list"]) == 0
    listed = capsys.readouterr().out
    assert jax_kernels.main(["--list"]) == 0
    assert listed == capsys.readouterr().out
    out = tmp_path / "k.json"
    code = kernels.main(["--quick", "--filter", "heavy_tail", "--device",
                         "cpu", "--out", str(out)])
    doc = json.loads(out.read_text())
    assert validate_kernels(doc) == []
    # exit 1 exactly when a check failed (on the CPU only the clock
    # gate, speedup_x, can)
    assert code == (1 if doc["summary"]["fail"] else 0)
    assert "kernel scenarios" in capsys.readouterr().out
