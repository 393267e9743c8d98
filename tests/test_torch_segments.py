"""Port SegmentProcessor vs the JAX package's, on golden archives.

The golden archives come from the JAX workflow, as in
tests/test_segment_pipeline.py.  The port's processor is built with
``SegmentProcessor.from_state`` from the JAX processor's DEM, grid and
aerodrome table, so both compute on identical state; the port runs on
the CPU, where its kernel wrappers take their plain versions.
Tolerances are those of the reference's pallas-vs-ref comparison
(tests/test_segment_pipeline.py:83-86); headings are compared as a
wrapped angle, because the golden tracks fly every direction and an ulp
of atan2 may put a heading near the +-pi cut on either side of it.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.geometry.aerodromes import synthetic_aerodromes
from repro.tracks.segments import SegmentProcessor as JaxProcessor
from repro_torch.kernels import ops as tops
from repro_torch.tracks.segments import (
    SegmentProcessor, segment_tasks_from_archive_tree, split_segments)

# The tensors here are small: keep torch to one thread so the suite's
# other workers, some of them timing-sensitive, keep their cores.
torch.set_num_threads(1)

ATTRS = ("times", "lat", "lon", "alt_msl_m", "alt_agl_m", "vrate_ms",
         "gspeed_ms", "heading_rad", "turn_rad_s")
ATOL = {"vrate_ms": 0.5, "gspeed_ms": 0.5, "heading_rad": 0.1,
        "turn_rad_s": 0.5}


@pytest.fixture(scope="module")
def golden_archives(tmp_path_factory):
    from repro.tracks.workflow import TrackWorkflow
    root = str(tmp_path_factory.mktemp("golden"))
    wf = TrackWorkflow(root, n_workers=2, poll_interval=0.003)
    wf.generate_raw(n_files=4, scale=2e4)
    wf.run()
    tasks = segment_tasks_from_archive_tree(wf.archive_dir)
    assert tasks
    return tasks


def _state(proc: JaxProcessor) -> dict:
    return {"elevation_m": proc._dem_f32, "grid": proc._dem_grid,
            "aero_lat": proc._aero_lat, "aero_lon": proc._aero_lon,
            "aero_cls": proc._aero_cls}


@pytest.fixture(scope="module")
def processors():
    jax_proc = JaxProcessor(aerodromes=synthetic_aerodromes(n=64))
    state = _state(jax_proc)
    return (jax_proc,
            SegmentProcessor.from_state(state, device="cpu"),
            SegmentProcessor.from_state(state, device="cpu",
                                        pipeline="unfused"))


def _assert_planes_close(got, want, width=None):
    for attr in ATTRS:
        a = getattr(got, attr)
        b = getattr(want, attr)[:, :width or a.shape[1]]
        if attr == "heading_rad":
            diff = np.angle(np.exp(1j * (a.astype(np.float64) - b)))
            np.testing.assert_allclose(diff, 0.0, atol=ATOL[attr],
                                       err_msg=attr)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-3,
                                       atol=ATOL.get(attr, 1e-2),
                                       err_msg=attr)


def test_process_batch_matches_jax(golden_archives, processors):
    jax_proc, fused, _ = processors
    want = jax_proc.process_batch(golden_archives)
    got = fused.process_batch(golden_archives)
    assert set(got) == set(want)
    compared = 0
    for tid in want:
        g, w = got[tid], want[tid]
        assert g.icao24 == w.icao24
        assert g.airspace == w.airspace
        np.testing.assert_array_equal(g.count, w.count)
        assert g.times.shape == w.times.shape
        if len(g):
            _assert_planes_close(g, w)
            compared += 1
    assert compared > 0
    for key in ("padded_fraction", "bucket_rows", "pipeline_calls",
                "n_segments", "valid_points", "allocated_points"):
        assert fused.last_stats[key] == jax_proc.last_stats[key], key
    assert fused.last_stats["pipeline_calls"] > 1


def test_unfused_matches_jax_unfused(golden_archives, processors):
    jax_unfused = JaxProcessor(aerodromes=synthetic_aerodromes(n=64),
                               pipeline="unfused")
    _, _, unfused = processors
    tasks = golden_archives[:3]
    want = jax_unfused.process_batch(tasks)
    got = unfused.process_batch(tasks)
    for tid in want:
        assert got[tid].airspace == want[tid].airspace
        np.testing.assert_array_equal(got[tid].count, want[tid].count)
        if len(want[tid]):
            _assert_planes_close(got[tid], want[tid])
    assert unfused.last_stats == {**jax_unfused.last_stats,
                                  "backend": "kernel"}


def test_fused_matches_unfused_on_golden_archives(golden_archives,
                                                   processors):
    _, fused, unfused = processors
    fb = fused.process_batch(golden_archives)
    ub = unfused.process_batch(golden_archives)
    assert set(fb) == set(ub)
    compared = 0
    for tid in fb:
        f, u = fb[tid], ub[tid]
        assert f.icao24 == u.icao24
        assert f.airspace == u.airspace
        np.testing.assert_array_equal(f.count, u.count)
        w = f.times.shape[1]
        for attr in ATTRS:
            a, b = getattr(f, attr), getattr(u, attr)
            if a.size:
                np.testing.assert_allclose(a, b[:, :w], atol=1e-5,
                                           rtol=1e-5, err_msg=attr)
                assert not b[:, w:].any()
                compared += 1
    assert compared > 0
    assert fused.last_stats["padded_fraction"] < \
        unfused.last_stats["padded_fraction"]


def test_intermediate_transfers(golden_archives, processors):
    _, fused, unfused = processors
    tops.reset_pipeline_stats()
    fused.process_batch(golden_archives)
    assert tops.get_pipeline_stats()["intermediate_transfers"] == 0
    tops.reset_pipeline_stats()
    unfused.process_batch(golden_archives[:2])
    # interp down, fi/fj up, agl down, rates down — per batch
    assert tops.get_pipeline_stats()["intermediate_transfers"] == 4


def test_store_payload_names_its_slice(processors, tmp_path):
    # store:// payloads are ported (tests/test_torch_store.py): one that
    # names a missing store fails on its manifest, naming the store.
    _, fused, _ = processors
    with pytest.raises(FileNotFoundError, match="not a track store"):
        fused.process_file(f"store://{tmp_path}/none#shard=s00000")


def test_processor_pickles_without_device_copy(processors):
    import pickle
    _, fused, _ = processors
    fused.dem_tensor()
    clone = pickle.loads(pickle.dumps(fused))
    assert clone._dem_dev == {} and fused._dem_dev
    np.testing.assert_array_equal(clone.dem_tensor().numpy(),
                                  fused._dem_f32)


def _synth_archive(rng, n_segs):
    """One archive of eastward-drifting segments (10-400 obs each)."""
    ts, lats, lons, alts = [], [], [], []
    t = 0.0
    for _ in range(n_segs):
        n = int(rng.integers(10, 400))
        seg_t = t + np.cumsum(rng.uniform(1.0, 7.0, n))
        ts.append(seg_t)
        lats.append(rng.uniform(30, 45) + np.cumsum(rng.normal(0, 2e-4, n)))
        lons.append(rng.uniform(-115, -80)
                    + np.cumsum(rng.uniform(5e-4, 2e-3, n)))
        alts.append(1000 + np.cumsum(rng.normal(0, 2, n)))
        t = seg_t[-1] + 400.0
    obs = {"time": np.concatenate(ts), "lat": np.concatenate(lats),
           "lon": np.concatenate(lons), "alt": np.concatenate(alts),
           "icao24": np.array(["deadbe"] * sum(len(x) for x in ts))}
    return obs, split_segments(obs["time"])


@settings(max_examples=8, deadline=None)
@given(st.integers(0, 10 ** 6), st.integers(2, 4))
def test_bucketing_reassembly_is_batch_composition_invariant(seed, n_arch):
    """Per-archive outputs must not depend on what else shares the
    batch: processing archives together == processing them alone."""
    rng = np.random.default_rng(seed)
    items = [_synth_archive(rng, int(rng.integers(1, 4)))
             for _ in range(n_arch)]
    proc = SegmentProcessor(aerodromes=synthetic_aerodromes(n=16),
                            device="cpu")
    together = proc._process_many(items)
    for item, batched in zip(items, together):
        alone = proc._process_many([item])[0]
        assert alone.icao24 == batched.icao24
        assert alone.airspace == batched.airspace
        np.testing.assert_array_equal(alone.count, batched.count)
        for attr in ATTRS:
            np.testing.assert_array_equal(
                getattr(alone, attr), getattr(batched, attr), err_msg=attr)
