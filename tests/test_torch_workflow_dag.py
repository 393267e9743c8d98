"""The port's workflow as one streaming DAG (``mode="dag"``) on the CPU.

Same raw data, same settings as tests/test_workflow_screen.py: the DAG
run's ``store/`` tree and ``candidates.json`` must be byte-identical to
the port's barrier run, with one manager shard or two, and the
candidates byte-identical to the JAX package's own ``mode="dag"`` run.
The store manifest records the absolute archive root, so every run
whose store is compared runs at the same path and is moved aside after.
A run killed mid-stream (its checkpoint hook raising once screen cells
have completed) resumes and ends with the same bytes.
"""

from __future__ import annotations

import json
import os
import re
import shutil

import numpy as np
import pytest

import repro_torch.tracks.workflow as port_workflow
from repro_torch.core.messages import Task
from repro_torch.runtime import ManagerCheckpoint
from repro_torch.store.format import StoreManifest
from repro_torch.store.writer import (
    ShardBuilder, build_store, commit_shard, discover_sources, plan_shards)
from repro_torch.tracks.workflow import TrackWorkflow

# tests/test_workflow_screen.py:22-26.
SCREEN_KW = dict(
    input="store", store_target_points=2048, screen=True,
    screen_h_m=50_000.0, screen_v_m=1000.0, screen_cell_deg=1.0,
    n_workers=4, poll_interval=0.003)


def _tree(root: str) -> dict[str, bytes]:
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _run_at(base, name: str, cls=TrackWorkflow, **kw) -> dict:
    """Run a fresh workflow at ``base/run`` (one path for every run whose
    store is compared), then move it to ``base/name``; return its store
    tree and candidate bytes."""
    root = str(base / "run")
    shutil.rmtree(root, ignore_errors=True)
    wf = cls(root, device="cpu", **kw)
    wf.generate_raw(n_files=1, scale=1e3)
    reports = wf.run()
    out = {"store": _tree(wf.store_dir), "phases": [r.phase for r in reports]}
    if kw.get("screen"):
        out["candidates"] = _read(wf.candidates_path)
    os.rename(root, str(base / name))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("wf_dag")
    return base, {
        "barrier": _run_at(base, "barrier", **SCREEN_KW),
        "dag": _run_at(base, "dag", mode="dag", **SCREEN_KW),
        "dag2": _run_at(base, "dag2", mode="dag", n_manager_shards=2,
                        **SCREEN_KW),
    }


def test_dag_store_and_candidates_byte_identical_to_barrier(runs):
    _base, r = runs
    assert r["barrier"]["phases"] == ["organize", "archive", "store-build",
                                      "process", "screen"]
    assert r["dag"]["phases"] == ["dag"]
    assert len(r["barrier"]["store"]) >= 3        # manifest + 2 shards
    assert r["dag"]["store"] == r["barrier"]["store"]
    assert r["dag"]["candidates"] == r["barrier"]["candidates"]
    assert json.loads(r["dag"]["candidates"])["candidates"]


@pytest.mark.parametrize("shards", [2])
def test_manager_shards_give_the_same_bytes(runs, shards):
    _base, r = runs
    assert r[f"dag{shards}"]["store"] == r["barrier"]["store"]
    assert r[f"dag{shards}"]["candidates"] == r["barrier"]["candidates"]


def _capture(monkeypatch, name: str) -> list:
    """Record every DagResult / RunResult the workflow module gets."""
    seen: list = []
    real = getattr(port_workflow, name)

    def wrapped(*args, **kwargs):
        res = real(*args, **kwargs)
        seen.append(res)
        return res

    monkeypatch.setattr(port_workflow, name, wrapped)
    return seen


_PLANES = ("count", "times", "lat", "lon", "alt_msl_m", "alt_agl_m",
           "vrate_ms", "gspeed_ms", "heading_rad", "turn_rad_s")


def test_zip_input_dag_process_results_equal_barrier(tmp_path, monkeypatch):
    kw = dict(n_workers=3, tasks_per_message=2, poll_interval=0.003,
              device="cpu")
    jobs = _capture(monkeypatch, "run_job")
    wfb = TrackWorkflow(str(tmp_path / "b"), **kw)
    wfb.generate_raw(n_files=2, scale=3e4)
    wfb.run()
    barrier = jobs[-1].results                      # the process phase
    dags = _capture(monkeypatch, "run_dag")
    wfd = TrackWorkflow(str(tmp_path / "d"), mode="dag", **kw)
    wfd.generate_raw(n_files=2, scale=3e4)
    assert [r.phase for r in wfd.run()] == ["dag"]
    streamed = dags[-1].node_results["process"]
    assert sorted(streamed) == sorted(barrier) and barrier
    for tid, want in barrier.items():
        got = streamed[tid]
        assert (got.icao24, got.airspace) == (want.icao24, want.airspace)
        for k in _PLANES:
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k))


def test_dag_store_build_recommits_unckpted_shard(tmp_path):
    """A shard file + partial manifest row exist on disk but the (lost)
    checkpoint never recorded the task, so the streaming DAG re-runs it
    end to end; the sealed store equals a clean single-shot build."""
    wfz = TrackWorkflow(str(tmp_path), n_workers=2, poll_interval=0.003,
                        device="cpu")
    wfz.generate_raw(n_files=3, scale=2e4)
    wfz.run()                      # organize + archive + (zip) process
    plans = plan_shards(discover_sources(wfz.archive_dir), target_points=1)
    assert len(plans) >= 2
    store_dir = str(tmp_path / "store")
    commit_shard(store_dir, ShardBuilder(store_dir)(
        Task(task_id=f"store/{plans[0].shard_id}",
             payload=plans[0].dumps())), target_points=1)

    wfd = TrackWorkflow(str(tmp_path), n_workers=2, poll_interval=0.003,
                        input="store", store_target_points=1, mode="dag",
                        device="cpu")
    assert [r.phase for r in wfd.run()] == ["dag"]
    manifest = StoreManifest.load(store_dir)
    assert manifest.meta.get("partial") is None      # sealed
    clean = build_store(wfz.archive_dir, str(tmp_path / "store_clean"),
                        target_points=1)
    assert [s.to_doc() for s in manifest.shards] == \
        [s.to_doc() for s in clean.shards]
    assert [t.to_doc() for t in manifest.tracks] == \
        [t.to_doc() for t in clean.tracks]


class _Killed(RuntimeError):
    pass


class _KilledMidScreen(TrackWorkflow):
    """Saves its mid-stream checkpoint, then dies, at the first
    checkpoint whose frontier holds both completed and outstanding
    screen cells: the resumed run must rebuild the completed cells'
    lost results and finish the rest."""

    def _save_ckpt(self, state: dict) -> None:
        super()._save_ckpt(state)
        if state.get("manager_phase") != "dag" or not state.get("manager"):
            return
        screen = ManagerCheckpoint.loads(
            state["manager"]).frontier["nodes"].get("screen", {})
        if screen.get("completed") and screen.get("outstanding"):
            raise _Killed(f"{len(screen['completed'])} screen cells done")


@pytest.mark.parametrize("backend", ["threads", "processes"])
def test_mid_stream_kill_resumes_with_same_bytes(runs, backend):
    base, r = runs
    root = str(base / "run")
    shutil.rmtree(root, ignore_errors=True)
    kw = dict(SCREEN_KW, mode="dag", exec_backend=backend,
              checkpoint_interval_s=0.01, device="cpu")
    wf = _KilledMidScreen(root, **kw)
    wf.generate_raw(n_files=1, scale=1e3)
    with pytest.raises(_Killed):
        wf.run()
    state = wf._load_ckpt()
    assert state["manager_phase"] == "dag"
    frontier = ManagerCheckpoint.loads(state["manager"]).frontier
    assert frontier["nodes"]["screen"]["completed"]
    again = TrackWorkflow(root, **kw)
    assert [rep.phase for rep in again.run()] == ["dag"]
    assert _tree(again.store_dir) == r["barrier"]["store"]
    assert _read(again.candidates_path) == r["barrier"]["candidates"]
    # A finished run is not redone.
    assert TrackWorkflow(root, **kw).run() == []
    shutil.rmtree(root)


def test_cli_pipeline_dag(tmp_path, capsys):
    root = str(tmp_path / "cli")
    port_workflow.main([
        "--root", root, "--device", "cpu", "--input", "store", "--screen",
        "--files", "1", "--scale", "1000", "--workers", "2",
        "--screen-h-m", "50000", "--screen-v-m", "1000",
        "--screen-cell-deg", "1.0", "--pipeline", "dag",
        "--manager-shards", "2"])
    out = capsys.readouterr().out
    assert "dag       :" in out and "candidate encounters" in out
    assert os.path.exists(os.path.join(root, "candidates.json"))


@pytest.mark.parametrize("argv,message", [
    (["--pipeline", "dag", "--manager-shards", "0"],
     "--manager-shards must be >= 1"),
])
def test_cli_refusals(tmp_path, capsys, argv, message):
    with pytest.raises(SystemExit) as exc:
        port_workflow.main(["--root", str(tmp_path / "x"), "--device",
                            "cpu"] + argv)
    assert exc.value.code == 2
    assert message in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "x")


def _serve_lines(out: str) -> list[str]:
    """The two ``serve:`` lines, the job's seconds masked."""
    return [re.sub(r" in [0-9.]+s;", " in Ts;", ln)
            for ln in out.splitlines() if ln.startswith("serve: ")]


@pytest.mark.parametrize("trace", [False, True], ids=["serve", "trace"])
def test_cli_serve(tmp_path, capsys, trace):
    """``--serve`` on the CPU with no ``--device``: the reference's two
    summary lines, with equal values."""
    from repro.tracks.workflow import run_serve as jax_run_serve
    want = jax_run_serve(str(tmp_path / "jax"), n_files=12, n_workers=2,
                         target_points=2048)
    root, trace_dir = str(tmp_path / "port"), str(tmp_path / "trace")
    port_workflow.main(["--root", root, "--serve", "--files", "12",
                        "--workers", "2"]
                       + (["--trace", trace_dir] if trace else []))
    out = capsys.readouterr().out
    lines = _serve_lines(out)
    assert lines == [
        f"serve: ingested {want['files_ingested']} files into "
        f"{want['shards_committed']} shards ({want['points_ingested']} "
        f"points, generation {want['generation']}) in Ts; "
        f"{want['retained_tracks']} tracks retained",
        f"serve: nearest(39,-98) -> {want['nearest_track']}, snapshot "
        f"digest {want['snapshot']['digest'][:16]}... "
        f"({want['snapshot']['n_tracks']} tracks)"]
    assert os.path.exists(os.path.join(root, "store_live",
                                       "store_manifest.json"))
    traced = [ln for ln in out.splitlines() if ln.startswith("trace: ")]
    if trace:
        assert len(traced) == 1
        assert sorted(os.listdir(trace_dir)) == ["TRACE_summary.json",
                                                 "trace.json"]
        with open(os.path.join(trace_dir, "TRACE_summary.json")) as f:
            doc = json.load(f)
        assert doc["config"]["label"] == "serve"
        assert doc["config"]["n_events"] > 0
    else:
        assert traced == [] and not os.path.exists(trace_dir)


def test_workflow_validates_dag_options(tmp_path):
    with pytest.raises(ValueError, match="unknown pipeline mode"):
        TrackWorkflow(str(tmp_path), mode="stream", device="cpu")
    with pytest.raises(ValueError, match="n_manager_shards must be >= 1"):
        TrackWorkflow(str(tmp_path), mode="dag", n_manager_shards=0,
                      device="cpu")
    with pytest.raises(ValueError, match="n_manager_shards=1"):
        TrackWorkflow(str(tmp_path), mode="dag", n_manager_shards=2,
                      elastic=True, device="cpu")


# Last in the file: it starts JAX's runtime in this process, and the
# processes-backend runs above fork.
def test_dag_candidates_match_jax_dag(runs, tmp_path):
    from repro.tracks.workflow import TrackWorkflow as JaxWorkflow
    _base, r = runs
    wf = JaxWorkflow(str(tmp_path / "jax"), mode="dag", **SCREEN_KW)
    wf.generate_raw(n_files=1, scale=1e3)
    wf.run()
    assert _read(wf.candidates_path) == r["dag"]["candidates"]
