"""Port's store + screen workflow vs brute force and vs the JAX package.

One scaled raw feed (a single hourly file, so the synthetic aircraft
share an hour and co-bin) goes through organize -> archive ->
store-build -> process -> screen on the CPU plain versions.  Its
``candidates.json`` must hold exactly the brute-force all-pairs set over
the port's own store-derived rows, and the same pairs as the JAX
workflow's on the same seed.
"""

import json
import os

import pytest
import torch

from repro.tracks.workflow import TrackWorkflow as JaxTrackWorkflow
from repro_torch.kernels.encounter_screen import brute_force_screen
from repro_torch.tracks.segments import (
    SegmentProcessor, segment_tasks_from_store)
from repro_torch.tracks.workflow import TrackWorkflow, _screen_rows_for_uri

torch.set_num_threads(1)

# The reference test's thresholds, calibrated so the ~60 co-located
# synthetic aircraft yield a small, non-empty candidate set.
SCREEN_KW = dict(
    input="store", store_target_points=2048, screen=True,
    screen_h_m=50_000.0, screen_v_m=1000.0, screen_cell_deg=1.0,
    n_workers=4, poll_interval=0.003)
PHASES = ["organize", "archive", "store-build", "process", "screen"]
# Port against JAX on the CPU: the resampled planes and the screen's
# f32 arithmetic agree to the last bit on this feed (measured max
# |difference| 0 m in t_s, h_m and v_m), so the gate is the screen's
# own distance tolerance.
JAX_ATOL_M = 1e-2


def _run(cls, root, **kw):
    wf = cls(str(root), **SCREEN_KW, **kw)
    wf.generate_raw(n_files=1, scale=1e3)
    wf.run()
    return wf


@pytest.fixture(scope="module")
def port_wf(tmp_path_factory):
    return _run(TrackWorkflow, tmp_path_factory.mktemp("torch_screen"),
                device="cpu")


def _candidates(wf):
    with open(wf.candidates_path) as f:
        return json.load(f)


def test_phases_and_artifact(port_wf):
    assert [r.phase for r in port_wf.reports] == PHASES
    doc = _candidates(port_wf)
    assert doc["schema"] == "repro.encounters/v1"
    assert doc["thresholds"] == {"h_m": 50_000.0, "v_m": 1000.0}
    pairs = [(c["a"], c["b"]) for c in doc["candidates"]]
    assert pairs and all(a < b for a, b in pairs)
    assert pairs == sorted(set(pairs))


def test_candidates_equal_brute_force(port_wf):
    proc = SegmentProcessor(device="cpu")
    rows = []
    for t in segment_tasks_from_store(port_wf.store_dir,
                                      granularity="shard"):
        rows.extend(_screen_rows_for_uri(proc, t.payload))
    want = brute_force_screen(rows, config=port_wf.screen_config)
    got = _candidates(port_wf)["candidates"]
    assert [(c["a"], c["b"], c["t_s"]) for c in got] == \
        [(c["a"], c["b"], c["t_s"]) for c in want]
    for g, w in zip(got, want):
        assert g["h_m"] == pytest.approx(w["h_m"], abs=1e-2)
        assert g["v_m"] == pytest.approx(w["v_m"], abs=1e-2)


def test_candidates_match_jax_workflow(port_wf, tmp_path):
    jax_wf = _run(JaxTrackWorkflow, tmp_path / "jax")
    want = _candidates(jax_wf)
    got = _candidates(port_wf)
    assert {k: v for k, v in got.items() if k != "candidates"} == \
        {k: v for k, v in want.items() if k != "candidates"}
    assert [(c["a"], c["b"]) for c in got["candidates"]] == \
        [(c["a"], c["b"]) for c in want["candidates"]]
    for g, w in zip(got["candidates"], want["candidates"]):
        for key in ("t_s", "h_m", "v_m"):
            assert g[key] == pytest.approx(w[key], abs=JAX_ATOL_M), key


def test_rerun_redoes_only_the_missing_screen(port_wf):
    with open(port_wf.candidates_path, "rb") as f:
        before = f.read()
    os.remove(port_wf.candidates_path)
    again = TrackWorkflow(port_wf.root, **SCREEN_KW, device="cpu")
    assert [r.phase for r in again.run()] == ["screen"]
    with open(again.candidates_path, "rb") as f:
        assert f.read() == before
    assert TrackWorkflow(port_wf.root, **SCREEN_KW,
                         device="cpu").run() == []


def test_screen_needs_store_input(tmp_path):
    with pytest.raises(ValueError, match="--screen needs --input store"):
        TrackWorkflow(str(tmp_path), input="zip", screen=True,
                      device="cpu")
