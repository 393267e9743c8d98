"""Port runtime and workflow vs the JAX package's, and the port alone.

The copied runtime must dispatch exactly as the reference's; the copied
dataset writer must write the same bytes; and full workflow runs of
the port (zip input, and store input with the screen phase), in a fresh
interpreter that imports only ``repro_torch``, must leave JAX and every
``repro`` module unimported; a ``--serve`` run must also leave CUDA
uninitialised.
"""

import json
import os
import subprocess
import sys

import pytest

from repro.core.messages import Task as JaxTask
from repro.runtime import BACKENDS as JAX_BACKENDS
from repro.runtime import run_job as jax_run_job
from repro.tracks.datasets import ScaledDatasetSpec as JaxSpec
from repro.tracks.datasets import write_scaled_dataset as jax_write
from repro_torch.core.messages import Task
from repro_torch.runtime import BACKENDS, run_job
from repro_torch.tracks.datasets import (
    ScaledDatasetSpec, write_scaled_dataset)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _square(task):
    return task.size_bytes ** 2


def _tasks(cls, n=40):
    return [cls(task_id=f"dir{i % 5}/t{i:03d}", size_bytes=(i * 37) % 23 + 1,
                timestamp=float(i), cpu_cost_hint=0.01 * ((i * 7) % 5))
            for i in range(n)]


def test_backends_match_reference():
    assert BACKENDS == JAX_BACKENDS == ("threads", "processes", "sim")
    with pytest.raises(ValueError, match="unknown backend"):
        run_job(_tasks(Task), _square, backend="mpi")


@pytest.mark.parametrize("policy,organization,tpm", [
    ("static", "largest_first", 3),
    ("static", "random", 2),
    ("fifo_selfsched", "chronological", 4),
    ("sized_lpt", "largest_first", 1),
    ("adaptive_chunk", "largest_first", 4),
    ("static", "filename", 2),
])
def test_run_job_dispatch_matches_reference(policy, organization, tpm):
    kw = dict(backend="threads", n_workers=3, organization=organization,
              tasks_per_message=tpm, policy=policy, poll_interval=0.001)
    want = jax_run_job(_tasks(JaxTask), _square, **kw)
    got = run_job(_tasks(Task), _square, **kw)
    assert got.completed_ids == want.completed_ids
    assert got.batches == want.batches
    assert got.results == want.results


def test_write_scaled_dataset_same_bytes(tmp_path):
    for spec_seed in (0, 3):
        jax_paths = jax_write(str(tmp_path / f"jax{spec_seed}"), JaxSpec(
            name="m", n_files=3, scale=5e4, seed=spec_seed))
        paths = write_scaled_dataset(
            str(tmp_path / f"port{spec_seed}"), ScaledDatasetSpec(
                name="m", n_files=3, scale=5e4, seed=spec_seed))
        assert [os.path.basename(p) for p in paths] == \
            [os.path.basename(p) for p in jax_paths]
        for a, b in zip(paths, jax_paths):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read()


_DRIVER = r"""
import json, sys
import torch
torch.set_num_threads(1)
from repro_torch.tracks.workflow import TrackWorkflow
from repro_torch.tracks.segments import segment_tasks_from_archive_tree
root, backend = sys.argv[1], sys.argv[2]
kw = dict(n_workers=2, exec_backend=backend, tasks_per_message=2,
          poll_interval=0.003, device="cpu")
wf = TrackWorkflow(root + "/zip", **kw)
wf.generate_raw(n_files=3, scale=4e4)
reports = wf.run()
# The store + screen path, on the reference test's screen thresholds.
sw = TrackWorkflow(root + "/screen", input="store", store_target_points=2048,
                   screen=True, screen_h_m=50_000.0, screen_v_m=1000.0,
                   screen_cell_deg=1.0, **kw)
sw.generate_raw(n_files=1, scale=1e3)
screen_reports = sw.run()
with open(sw.candidates_path) as f:
    n_candidates = len(json.load(f)["candidates"])
# The same as one streaming DAG, and a sim job on a manifest.
dw = TrackWorkflow(root + "/dag", input="store", store_target_points=2048,
                   screen=True, screen_h_m=50_000.0, screen_v_m=1000.0,
                   screen_cell_deg=1.0, mode="dag", **kw)
dw.generate_raw(n_files=1, scale=1e3)
dag_reports = dw.run()
with open(dw.candidates_path, "rb") as f, open(sw.candidates_path, "rb") as g:
    dag_same = f.read() == g.read()
from repro_torch.runtime import run_job
from repro_torch.tracks.datasets import get_manifest
sim = run_job(get_manifest("heavy_tail", limit=200), None, backend="sim",
              n_workers=8, policy="sized_lpt")
print(json.dumps({
    "phases": [r.phase for r in reports],
    "process_tasks": reports[-1].tasks,
    "archives": len(segment_tasks_from_archive_tree(wf.archive_dir)),
    "screen_phases": [r.phase for r in screen_reports],
    "screen_tasks": screen_reports[-1].tasks,
    "candidates": n_candidates,
    "dag_phases": [r.phase for r in dag_reports],
    "dag_same": dag_same,
    "sim_tasks": len(sim.completed_ids),
    "foreign": sorted(m for m in sys.modules
                      if m == "jax" or m.startswith(("jax.", "repro.")))
                      + (["repro"] if "repro" in sys.modules else []),
}))
"""


@pytest.mark.parametrize("backend", ["threads", "processes"])
def test_port_workflow_runs_without_jax(tmp_path, backend):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    proc = subprocess.run(
        [sys.executable, "-c", _DRIVER, str(tmp_path / "wf"), backend],
        capture_output=True, text=True, env=env, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    assert doc["phases"] == ["organize", "archive", "process"]
    assert doc["process_tasks"] == doc["archives"] > 0
    assert doc["screen_phases"] == ["organize", "archive", "store-build",
                                    "process", "screen"]
    assert doc["screen_tasks"] > 0 and doc["candidates"] > 0
    assert doc["dag_phases"] == ["dag"] and doc["dag_same"]
    assert doc["sim_tasks"] == 200
    assert doc["foreign"] == []


_SERVE_DRIVER = r"""
import contextlib, io, json, sys
import torch
torch.set_num_threads(1)
from repro_torch.tracks import workflow
root, backend = sys.argv[1], sys.argv[2]
summary = workflow.run_serve(root + "/api", n_files=12, n_workers=2,
                             backend=backend)
out = io.StringIO()
with contextlib.redirect_stdout(out):
    workflow.main(["--root", root + "/cli", "--serve", "--files", "12",
                   "--workers", "2", "--backend", backend])
summary.pop("job_seconds")
print(json.dumps({
    "summary": summary,
    "cli_lines": [ln for ln in out.getvalue().splitlines()
                  if ln.startswith("serve: ")],
    "cuda_initialized": torch.cuda.is_initialized(),
    "foreign": sorted(m for m in sys.modules
                      if m == "jax" or m.startswith(("jax.", "repro.")))
                      + (["repro"] if "repro" in sys.modules else []),
}))
"""


@pytest.mark.parametrize("backend", ["threads", "processes"])
def test_port_serve_runs_without_jax_or_cuda(tmp_path, backend):
    """``--serve`` is host work: no JAX, no ``repro`` module, and CUDA
    never initialised, on threads and on processes workers."""
    from repro.tracks.workflow import run_serve as jax_run_serve
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    proc = subprocess.run(
        [sys.executable, "-c", _SERVE_DRIVER, str(tmp_path / "wf"),
         backend], capture_output=True, text=True, env=env, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    want = jax_run_serve(str(tmp_path / "jax"), n_files=12, n_workers=2)
    want.pop("job_seconds")
    assert doc["summary"] == want
    assert len(doc["cli_lines"]) == 2
    assert doc["cuda_initialized"] is False
    assert doc["foreign"] == []


_TRACE_DRIVER = r"""
import contextlib, io, json, os, runpy, sys
import torch
torch.set_num_threads(1)
from repro_torch.obs import Tracer
from repro_torch.tracks import workflow
root, backend = sys.argv[1], sys.argv[2]
# A traced store + screen DAG, through the API.
tracer = Tracer()
wf = workflow.TrackWorkflow(root + "/dag", input="store",
                            store_target_points=2048, screen=True,
                            screen_h_m=50_000.0, screen_v_m=1000.0,
                            screen_cell_deg=1.0, mode="dag", n_workers=2,
                            exec_backend=backend, tasks_per_message=2,
                            poll_interval=0.003, device="cpu",
                            tracer=tracer)
wf.generate_raw(n_files=1, scale=1e3)
wf.run()
# --trace through the CLI's main, then the report as a module run.
out = io.StringIO()
with contextlib.redirect_stdout(out):
    workflow.main(["--root", root + "/cli", "--device", "cpu", "--files",
                   "1", "--scale", "1000", "--workers", "2", "--backend",
                   backend, "--trace", root + "/trace"])
report = io.StringIO()
sys.argv = ["report", root + "/trace/TRACE_summary.json"]
with contextlib.redirect_stdout(report):
    try:
        runpy.run_module("repro_torch.obs.report", run_name="__main__")
        code = 0
    except SystemExit as e:
        code = e.code
print(json.dumps({
    "dag_events": len(tracer),
    "dropped": tracer.dropped,
    "cli_trace_lines": [ln for ln in out.getvalue().splitlines()
                        if ln.startswith("trace: ")],
    "files": sorted(os.listdir(root + "/trace")),
    "report_code": code,
    "report_has_critical_path": "critical path" in report.getvalue(),
    "foreign": sorted(m for m in sys.modules
                      if m == "jax" or m.startswith(("jax.", "repro.")))
                      + (["repro"] if "repro" in sys.modules else []),
}))
"""


@pytest.mark.parametrize("backend", ["threads", "processes"])
def test_port_trace_runs_without_jax(tmp_path, backend):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    proc = subprocess.run(
        [sys.executable, "-c", _TRACE_DRIVER, str(tmp_path / "wf"), backend],
        capture_output=True, text=True, env=env, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    assert doc["dag_events"] > 0 and doc["dropped"] == 0
    assert len(doc["cli_trace_lines"]) == 1
    assert doc["files"] == ["TRACE_summary.json", "trace.json"]
    assert doc["report_code"] == 0 and doc["report_has_critical_path"]
    assert doc["foreign"] == []
