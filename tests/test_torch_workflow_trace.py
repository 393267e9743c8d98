"""Traced live runs of the port: ``run_job`` and ``TrackWorkflow``, on
the CPU.

A live trace is the run's history: the span-ledger invariants of
tests/test_obs.py (one ``exec`` span and one ``done`` instant per
completed task, a requeued task re-assigned before it finished, a
worker's ``exec`` spans never overlapping) hold for traced ``run_job``
calls on threads and processes workers and for a traced workflow,
barrier phases and streaming DAG, against the ids the runs completed.
Tracing changes no output: the traced DAG's ``store/`` tree and
``candidates.json`` are byte-identical to an untraced run's.  For a
``static``-policy barrier workflow on the same raw files the per-phase
multiset of ``(name, cat, task_id)`` of task events, and the summary's
lifecycle counts, equal the JAX package's traced workflow.  The CLI's
``--trace DIR`` writes both artifacts and its report reads them.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import shutil

import pytest
import torch

import repro_torch.tracks.workflow as port_workflow
from repro_torch.bench.schema import validate_obs_summary
from repro_torch.core.messages import Task
from repro_torch.obs import Tracer, phase_of, summary_from_tracer
from repro_torch.obs.report import main as report_main
from repro_torch.runtime import run_job
from repro_torch.tracks.workflow import TrackWorkflow

# tests/test_workflow_screen.py:22-26.
SCREEN_KW = dict(
    input="store", store_target_points=2048, screen=True,
    screen_h_m=50_000.0, screen_v_m=1000.0, screen_cell_deg=1.0,
    n_workers=4, poll_interval=0.003)


def _ledger_invariants(events, completed_ids):
    """tests/test_obs.py's invariants every traced run must satisfy."""
    completed = sorted(completed_ids)
    execs = [e for e in events if e[2] == "exec"]
    assert sorted(e[5] for e in execs) == completed
    assert sorted(e[5] for e in events if e[2] == "done") == completed
    last_ass, last_req = {}, {}
    for i, e in enumerate(events):
        if e[2] == "assigned":
            last_ass[e[5]] = i
        elif e[2] == "requeued":
            last_req[e[5]] = i
    for tid, i in last_req.items():
        if tid in set(completed):
            assert last_ass.get(tid, -1) > i, \
                f"{tid} completed but never re-assigned after requeue"
    by_worker = collections.defaultdict(list)
    for e in execs:
        by_worker[str(e[4])].append(e)
    for spans in by_worker.values():
        spans.sort(key=lambda e: e[0])
        for prev, nxt in zip(spans, spans[1:]):
            assert nxt[0] >= prev[0] + prev[1] - 1e-9


def _tasks(n):
    return [Task(task_id=f"t{i:04d}", size_bytes=(i % 5 + 1) * 400_000,
                 timestamp=i) for i in range(n)]


def _sizeof(task):               # module-level: picklable
    return task.size_bytes


@pytest.mark.parametrize("backend,tpm", [("threads", 2), ("threads", 1),
                                         ("processes", 3)])
def test_live_run_job_ledger_invariants(backend, tpm):
    tr = Tracer()
    res = run_job(_tasks(12), _sizeof, backend=backend, n_workers=3,
                  tasks_per_message=tpm, poll_interval=0.002, tracer=tr)
    assert len(res.completed_ids) == 12
    _ledger_invariants(tr.events, res.completed_ids)
    # Live exec spans are drive-side reconstructions on the wall clock.
    assert all(e[1] >= 0.0 for e in tr.events if e[2] == "exec")
    assert tr.dropped == 0


def test_live_run_job_worker_failure_is_traced():
    tr = Tracer()
    res = run_job(_tasks(16), _sizeof, backend="threads", n_workers=3,
                  failure_timeout=0.25, worker_fail_after={"w0": 3},
                  poll_interval=0.002, tracer=tr)
    assert len(res.completed_ids) == 16
    _ledger_invariants(tr.events, res.completed_ids)
    assert res.failed_workers == ["w0"]


def _tree(root: str) -> dict[str, bytes]:
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def _on_host(x) -> bool:
    """No torch tensor anywhere in ``x`` (dataclasses, dicts, lists)."""
    if isinstance(x, torch.Tensor):
        return False
    if dataclasses.is_dataclass(x):
        return _on_host(vars(x))
    if isinstance(x, dict):
        return all(_on_host(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return all(_on_host(v) for v in x)
    return True


def _capture(monkeypatch, module, name: str) -> list:
    """Wrap ``module.<name>`` to keep every result it returns."""
    kept = []
    real = getattr(module, name)

    def wrapped(*args, **kwargs):
        kept.append(real(*args, **kwargs))
        return kept[-1]

    monkeypatch.setattr(module, name, wrapped)
    return kept


def test_traced_dag_workflow_ledger_and_same_bytes(tmp_path, monkeypatch):
    root = tmp_path / "run"
    kept = _capture(monkeypatch, port_workflow, "run_dag")
    trees, tracer = {}, Tracer()
    for name, tr in (("untraced", None), ("traced", tracer)):
        wf = TrackWorkflow(str(root), device="cpu", mode="dag", tracer=tr,
                           **SCREEN_KW)
        wf.generate_raw(n_files=1, scale=1e3)
        assert [r.phase for r in wf.run()] == ["dag"]
        trees[name] = _tree(str(root))
        shutil.rmtree(root)
    # What the screen workflow's runs compare (zip archives carry their
    # write times): the store tree and the candidates.
    trees = {k: {p: b for p, b in v.items()
                 if p.startswith("store") or p == "candidates.json"}
             for k, v in trees.items()}
    assert len(trees["traced"]) >= 3
    assert trees["traced"] == trees["untraced"]
    assert json.loads(trees["traced"]["candidates.json"])["candidates"]
    assert len(kept) == 2
    events = tracer.events
    assert tracer.dropped == 0
    _ledger_invariants(events, kept[1].run.completed_ids)
    nodes = {phase_of(e[5]) for e in events if e[2] == "exec"}
    assert nodes == {"organize", "archive", "store-build", "process",
                     "screen"}
    assert {e[2] for e in events if e[3] == "dag"} \
        >= {"admit", "node_sealed", "node_complete"}
    doc = summary_from_tracer(tracer, label="dag")
    assert validate_obs_summary(doc) == []
    assert set(doc["phases"]) == nodes
    assert sum(p["n_tasks"] for p in doc["phases"].values()) \
        == len(kept[1].run.completed_ids)
    # Task results reach the manager as host data (numpy, not tensors),
    # so a drive-side exec span ends after the task's device work.
    for node in ("process", "screen"):
        results = kept[1].node_results[node]
        assert results and _on_host(list(results.values()))


def test_traced_barrier_workflow_on_processes(tmp_path, monkeypatch):
    kept = _capture(monkeypatch, port_workflow, "run_job")
    tr = Tracer()
    wf = TrackWorkflow(str(tmp_path / "wf"), n_workers=2, device="cpu",
                       exec_backend="processes", poll_interval=0.003,
                       tracer=tr)
    wf.generate_raw(n_files=1, scale=1e3)
    assert [r.phase for r in wf.run()] == ["organize", "archive",
                                           "process"]
    assert len(kept) == 3
    _ledger_invariants(tr.events, [t for res in kept
                                   for t in res.completed_ids])
    assert tr.dropped == 0


def test_cli_trace_writes_both_artifacts(tmp_path, capsys):
    root, out = str(tmp_path / "cli"), str(tmp_path / "cli_trace")
    port_workflow.main(["--root", root, "--device", "cpu", "--files", "1",
                        "--scale", "1000", "--workers", "2", "--trace",
                        out])
    printed = capsys.readouterr().out
    trace = os.path.join(out, "trace.json")
    summary = os.path.join(out, "TRACE_summary.json")
    lines = [ln for ln in printed.splitlines() if ln.startswith("trace: ")]
    assert lines == [f"trace: {lines[0].split()[1]} events -> {trace}, "
                     f"summary -> {summary}"]
    assert int(lines[0].split()[1]) > 0
    with open(summary) as f:
        doc = json.load(f)
    assert validate_obs_summary(doc) == []
    assert doc["config"]["label"] == "barrier"
    assert doc["config"]["n_events"] == int(lines[0].split()[1])
    for path in (trace, summary):
        assert report_main([path]) == 0
        assert "critical path" in capsys.readouterr().out


def _task_events_by_phase(monkeypatch, module, tracer) -> dict:
    """Wrap ``module.run_job`` to cut the tracer's events at each
    phase's run; returns the list the cuts land in."""
    cuts = []
    real = module.run_job

    def wrapped(*args, **kwargs):
        start = len(tracer)
        res = real(*args, **kwargs)
        cuts.append((start, len(tracer)))
        return res

    monkeypatch.setattr(module, "run_job", wrapped)
    return cuts


def _phase_multisets(events, cuts, phases) -> dict:
    return {phase: collections.Counter(
        (e[2], e[3], e[5]) for e in events[a:b] if e[3] == "task")
        for phase, (a, b) in zip(phases, cuts)}


_LIFECYCLE = ("n_queued", "n_assigned", "n_done", "n_exec_spans")


# Last in the file: it starts JAX's runtime in this process, and the
# processes-backend runs above fork.
def test_static_workflow_task_events_equal_reference(tmp_path, monkeypatch):
    import repro.obs as jax_obs
    import repro.tracks.workflow as jax_workflow

    kw = dict(n_workers=3, policy="static", tasks_per_message=2,
              poll_interval=0.003)
    out = {}
    for pkg, module, tracer, summarize, extra in (
            ("port", port_workflow, Tracer(), summary_from_tracer,
             {"device": "cpu"}),
            ("jax", jax_workflow, jax_obs.Tracer(),
             jax_obs.summary_from_tracer, {})):
        cuts = _task_events_by_phase(monkeypatch, module, tracer)
        wf = module.TrackWorkflow(str(tmp_path / pkg), tracer=tracer,
                                  **kw, **extra)
        wf.generate_raw(n_files=1, scale=1e3)
        phases = [r.phase for r in wf.run()]
        assert tracer.dropped == 0
        out[pkg] = {
            "phases": phases,
            "events": _phase_multisets(tracer.events, cuts, phases),
            "lifecycle": {k: summarize(tracer, label="s")["scenario"]
                          ["metrics"][k] for k in _LIFECYCLE},
        }
    assert out["port"]["phases"] == ["organize", "archive", "process"]
    assert out["port"] == out["jax"]
    assert all(out["port"]["events"][p] for p in out["port"]["phases"])
