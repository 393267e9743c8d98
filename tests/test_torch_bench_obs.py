"""Port observability bench (``repro_torch.bench.obs``) and benchmark
scenarios (``repro_torch.bench.scenarios``) vs the JAX package's.

The executors run at tests/test_bench_obs.py's shrunk ``_TINY`` spec,
the quick ``determinism`` and ``straggler`` cells at their own size
(the 12k-task heavy-tail sim).  Every metric is the sim's virtual
arithmetic, so the port's records equal the reference's once the
nondeterministic keys (``NONDETERMINISTIC_RECORD_KEYS`` /
``NONDETERMINISTIC_DOC_KEYS``: wall clocks, dates, environment) are
stripped.  The only other difference is wording: the port's check
sources drop the reference's leading tracker tag (an upper-case word, a
number and a colon), which the comparison removes from the reference
side.  Nothing is compared against the
reference's committed ``TRACE_heavy_tail_quick.json``; the port's
reference run is held against a fresh reference run instead.
"""

from __future__ import annotations

import dataclasses
import json
import re

import pytest

from repro.bench import obs as jax_obsbench
from repro.bench import scenarios as jax_scenarios
from repro.bench.schema import canonical_bytes as jax_canonical_bytes
from repro_torch.bench import obs as obsbench
from repro_torch.bench import scenarios
from repro_torch.bench.schema import (
    NONDETERMINISTIC_DOC_KEYS, NONDETERMINISTIC_RECORD_KEYS,
    OBS_BENCH_SCHEMA, canonical_bytes, validate_obs, validate_obs_summary)

#: Shrunk spec for executor-level tests, tests/test_bench_obs.py's.
_TINY = dataclasses.replace(obsbench._BASE, dataset_limit=1500,
                            n_workers=32, repeats=1)
_JAX_TINY = dataclasses.replace(jax_obsbench._BASE, dataset_limit=1500,
                                n_workers=32, repeats=1)

_TAG = re.compile(r"^[A-Z]+ \d+: ")


def _untagged(checks: list) -> list:
    """Check dicts with the tracker tag cut from their sources."""
    for check in checks:
        check["source"] = _TAG.sub("", check["source"])
    return checks


def _strip(doc: dict, *, reference: bool) -> dict:
    """``doc`` through JSON, without its nondeterministic keys; on the
    reference side the check sources lose their tracker tag."""
    doc = json.loads(json.dumps(doc))
    for key in NONDETERMINISTIC_DOC_KEYS:
        doc.pop(key, None)
    for rec in doc["scenarios"]:
        for key in NONDETERMINISTIC_RECORD_KEYS:
            rec.pop(key, None)
        if reference:
            _untagged(rec["checks"])
    return doc


def test_quick_tier_is_the_acceptance_cells():
    names = {sc.name for sc in obsbench.obs_scenarios()
             if sc.tier == "quick"}
    assert names == {"obs_overhead_heavy_tail_w1024",
                     "obs_determinism_heavy_tail",
                     "obs_straggler_ranking"}
    got = [(sc.name, sc.group, sc.tier, sc.run.to_dict(),
            [dataclasses.asdict(c) for c in sc.checks])
           for sc in obsbench.obs_scenarios()]
    want = [(sc.name, sc.group, sc.tier, sc.run.to_dict(),
             _untagged([dataclasses.asdict(c) for c in sc.checks]))
            for sc in jax_obsbench.obs_scenarios()]
    assert got == want


@pytest.mark.parametrize("kw", [dict(kind="nope"), dict(backend="threads"),
                                dict(fault_profile="nope"),
                                dict(repeats=0), dict(policy="nope")])
def test_spec_validation(kw):
    with pytest.raises(ValueError):
        obsbench.ObsSpec(**kw)
    with pytest.raises(ValueError):
        jax_obsbench.ObsSpec(**kw)


def test_overhead_executor_schedule_invariant():
    out = obsbench._execute_overhead(
        dataclasses.replace(_TINY, kind="overhead"))
    m = out["metrics"]
    # Tracing must not change a single virtual decision, at any scale.
    assert m["makespan_identical"] == 1
    assert m["tasks_completed"] == 1500
    assert m["n_events"] > 4 * 1500 * 0.9
    assert m["events_dropped"] == 0
    assert out["measured"]["overhead_ratio"] > 0.0
    want = jax_obsbench._execute_overhead(
        dataclasses.replace(_JAX_TINY, kind="overhead"))
    assert m == want["metrics"]
    assert set(out["measured"]) == set(want["measured"])


@pytest.mark.parametrize("kind", ["determinism", "straggler"])
def test_executors_equal_reference_at_tiny_size(kind):
    profile = "stragglers_10pct" if kind == "straggler" else "deaths_20pct"
    got = obsbench._EXECUTORS[kind](dataclasses.replace(
        _TINY, kind=kind, fault_profile=profile))
    want = jax_obsbench._EXECUTORS[kind](dataclasses.replace(
        _JAX_TINY, kind=kind, fault_profile=profile))
    assert got == want


def test_straggler_executor_requires_straggler_profile():
    rec = obsbench.run_obs_scenario(obsbench.ObsScenario(
        name="bad", group="obs_straggler",
        run=dataclasses.replace(_TINY, kind="straggler",
                                fault_profile="none")))
    assert rec["status"] == "error"
    assert "straggler" in rec["error"]
    want = jax_obsbench.run_obs_scenario(jax_obsbench.ObsScenario(
        name="bad", group="obs_straggler",
        run=dataclasses.replace(_JAX_TINY, kind="straggler",
                                fault_profile="none")))
    assert rec["error"] == want["error"]


@pytest.fixture(scope="module")
def quick_docs():
    kw = dict(quick=True, filters=["determinism", "straggler"])
    return obsbench.run_obs_campaign(**kw), jax_obsbench.run_obs_campaign(
        **kw)


def test_determinism_and_straggler_cells_pass_at_quick_size(quick_docs):
    doc, _ = quick_docs
    assert doc["schema"] == OBS_BENCH_SCHEMA
    assert validate_obs(doc) == []
    assert doc["summary"]["fail"] == 0 and doc["summary"]["error"] == 0
    by_name = {r["name"]: r for r in doc["scenarios"]}
    det = by_name["obs_determinism_heavy_tail"]
    assert det["metrics"]["summary_identical"] == 1
    assert det["metrics"]["n_events_identical"] == 1
    strag = by_name["obs_straggler_ranking"]
    assert strag["metrics"]["straggler_rank_correct"] == 1
    assert strag["metrics"]["bottom_k_hits"] \
        == strag["metrics"]["n_slow_workers"] > 0
    assert strag["metrics"]["straggler_count"] >= 1


def test_quick_cells_equal_reference(quick_docs):
    doc, ref = quick_docs
    assert _strip(doc, reference=False) == _strip(ref, reference=True)


def test_campaign_doc_is_deterministic_modulo_wall_clock(quick_docs):
    doc, _ = quick_docs
    again = obsbench.run_obs_campaign(quick=True, filters=["determinism"])
    first = dict(doc, scenarios=[r for r in doc["scenarios"]
                                 if "determinism" in r["name"]])
    a, b = _strip(first, reference=False), _strip(again, reference=False)
    a.pop("config"), b.pop("config"), a.pop("summary"), b.pop("summary")
    assert a == b
    assert canonical_bytes(again) == canonical_bytes(
        obsbench.run_obs_campaign(quick=True, filters=["determinism"]))


def test_reference_run_summary_equals_a_fresh_reference_run():
    tracer, summary = obsbench.reference_run()
    assert tracer.dropped == 0
    assert validate_obs_summary(summary) == []
    jtracer, jsummary = jax_obsbench.reference_run()
    assert tracer.events == jtracer.events
    assert canonical_bytes(summary) == jax_canonical_bytes(jsummary)


def test_cli_writes_doc_trace_and_summary(tmp_path, capsys):
    out, trace, summ = (str(tmp_path / f) for f in (
        "BENCH_obs.json", "trace.json", "TRACE_summary.json"))
    rc = obsbench.main(["--quick", "--filter", "determinism", "--out", out,
                        "--trace-out", trace, "--summary-out", summ])
    printed = capsys.readouterr().out
    assert rc == 0
    assert "obs_determinism_heavy_tail" in printed
    with open(out) as f:
        assert validate_obs(json.load(f)) == []
    _jt, jsummary = jax_obsbench.reference_run()
    with open(summ, "rb") as f:
        assert f.read() == jax_canonical_bytes(jsummary)
    with open(trace) as f:
        assert len(json.load(f)["traceEvents"]) > 0
    assert obsbench.main(["--list", "--quick"]) == 0
    assert len(capsys.readouterr().out.splitlines()) == 3
    assert obsbench.main(["--filter", "no-such-cell", "--out", "-"]) == 1


# ---------------------------------------------------------------------------
# Scenarios.
# ---------------------------------------------------------------------------

def test_fault_profiles_equal_reference():
    assert list(scenarios.FAULT_PROFILES) == list(
        jax_scenarios.FAULT_PROFILES)
    for name, prof in scenarios.FAULT_PROFILES.items():
        want = jax_scenarios.FAULT_PROFILES[name]
        assert dataclasses.asdict(prof) == dataclasses.asdict(want)
        for n, seed in ((64, 0), (1024, 3), (7, 1)):
            assert prof.materialize(n, seed) == want.materialize(n, seed)


@pytest.mark.parametrize("actual", [0.5, 1.0, 1.05, 1.2, 3, None])
def test_check_evaluate_equals_reference(actual):
    for kind, expect, tol in (("max", 1.05, 0.0), ("min", 1, 0.0),
                              ("within_rel", 1.0, 0.1),
                              ("within_abs", 1.0, 0.05)):
        got = scenarios.Check("m", kind, expect, tol=tol, source="s")
        want = jax_scenarios.Check("m", kind, expect, tol=tol, source="s")
        metrics = {} if actual is None else {"m": actual}
        assert got.evaluate(metrics) == want.evaluate(metrics)


def test_expand_equals_reference():
    kw = dict(dataset="monday", n_workers=[64, 511], nodes=64, nppn=8,
              poll_interval=[0.05, 2.0], tier="quick")
    got = scenarios.expand("beyond_poll", **kw)
    want = jax_scenarios.expand("beyond_poll", **kw)
    assert [(s.name, s.group, s.tier, dataclasses.asdict(s.run))
            for s in got] == [(s.name, s.group, s.tier,
                               dataclasses.asdict(s.run)) for s in want]
    assert len(got) == 4 and got[0].matches(["beyond"])
    with pytest.raises(ValueError):
        scenarios.RunSpec(dataset="monday", mode="nope")
    with pytest.raises(ValueError):
        scenarios.Check("m", "approx", 1.0)
