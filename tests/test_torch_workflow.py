"""Port runtime and workflow vs the JAX package's, and the port alone.

The copied runtime must dispatch exactly as the reference's; the copied
dataset writer must write the same bytes; and full workflow runs of
the port (zip input, and store input with the screen phase), in a fresh
interpreter that imports only ``repro_torch``, must leave JAX and every
``repro`` module unimported.
"""

import json
import os
import subprocess
import sys

import pytest

from repro.core.messages import Task as JaxTask
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


def test_backends_are_the_live_ones():
    assert BACKENDS == ("threads", "processes")
    with pytest.raises(ValueError, match="unknown backend"):
        run_job(_tasks(Task), _square, backend="sim")


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
print(json.dumps({
    "phases": [r.phase for r in reports],
    "process_tasks": reports[-1].tasks,
    "archives": len(segment_tasks_from_archive_tree(wf.archive_dir)),
    "screen_phases": [r.phase for r in screen_reports],
    "screen_tasks": screen_reports[-1].tasks,
    "candidates": n_candidates,
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
    assert doc["foreign"] == []
