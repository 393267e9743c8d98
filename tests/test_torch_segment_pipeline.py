"""Port segment pipeline vs the JAX package's fused pipeline.

The same numpy bucket goes through ``repro.kernels.ops.process_segments``
(Pallas in interpret mode) and ``repro_torch.kernels.ops.process_segments``
on the CPU, where the kernel wrappers run their plain versions.  The
tolerances are those of tests/test_segment_pipeline.py's pallas-vs-ref
comparison: ulp-level differences in the interpolation (masked matmul
vs direct lerp) are amplified by the central differences and by the
terrain gradient; tracks drift east so headings stay off the +-pi cut.
"""

import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.segment_pipeline import FIELDS as JAX_FIELDS
from repro_torch.kernels import ops as tops
from repro_torch.kernels.segment_pipeline import FIELDS, _pad_tracks
from repro_torch.tracks.segments import BUCKET_SIZES

# The tensors here are small: keep torch to one thread so the suite's
# other workers, some of them timing-sensitive, keep their cores.
torch.set_num_threads(1)

GRID = (0.0, 26.0, 0.0, 59.0, 8.0)
ATOL = {"vrate": 0.5, "gspeed": 0.5, "heading": 0.1, "turn": 0.5}


def _dem(seed=7, H=209, W=473):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 2500, (H, W)).astype(np.float32)


def _ragged_inputs(B, K, seed=0):
    """One bucket batch: B tracks of <=K knots drifting east."""
    rng = np.random.default_rng(seed)
    t_in = np.zeros((B, K), np.float32)
    v_in = np.zeros((B, 3, K), np.float32)
    count_in = np.zeros((B,), np.int32)
    t_out = np.zeros((B, K), np.float32)
    count_out = np.zeros((B,), np.int32)
    for b in range(B):
        n = int(rng.integers(10, K + 1))
        m = int(rng.integers(2, K + 1))
        t = np.cumsum(rng.uniform(1.0, 6.0, n))
        t -= t[0]
        t_in[b, :n] = t
        t_in[b, n:] = t[-1] + np.arange(1, K - n + 1)
        v_in[b, 0, :n] = rng.uniform(1, 3) \
            + np.cumsum(rng.normal(0, 2e-4, n))
        v_in[b, 1, :n] = rng.uniform(2, 20) \
            + np.cumsum(rng.uniform(5e-4, 2e-3, n))        # eastward
        v_in[b, 2, :n] = 1500 + np.cumsum(rng.normal(0, 2, n))
        v_in[b, :, n:] = v_in[b, :, n - 1:n]
        count_in[b] = n
        t_out[b, :m] = np.arange(m)
        t_out[b, m:] = t_out[b, m - 1]
        count_out[b] = m
    return t_in, v_in, count_in, t_out, count_out


def _port(dem, args, **kw):
    out = tops.process_segments(torch.from_numpy(dem), *args, grid=GRID,
                                **kw)
    assert out.device.type == "cpu" and out.dtype == torch.float32
    return dict(zip(FIELDS, out.numpy()))


def test_fields_match_reference():
    assert FIELDS == JAX_FIELDS


@pytest.mark.parametrize("K", BUCKET_SIZES)
def test_process_segments_matches_jax_across_buckets(K):
    dem = _dem()
    args = _ragged_inputs(3, K, seed=K)
    got = _port(dem, args)
    want = {k: np.asarray(v) for k, v in jops.process_segments(
        dem, *args, grid=GRID, backend="pallas").items()}
    for f in FIELDS:
        assert got[f].shape == (3, K), f
        np.testing.assert_allclose(got[f], want[f], rtol=1e-3,
                                   atol=ATOL.get(f, 1e-2), err_msg=f)
    # The plain composition ("ref") agrees with the wrappers' CPU path.
    ref = _port(dem, args, backend="ref")
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)


def test_process_segments_pads_unaligned_widths():
    """Widths that are not multiples of 128 are padded inside and cut
    back, like the reference."""
    dem = _dem()
    args = _ragged_inputs(2, 100, seed=5)
    got = _port(dem, args)
    want = {k: np.asarray(v) for k, v in jops.process_segments(
        dem, *args, grid=GRID, backend="pallas").items()}
    for f in FIELDS:
        assert got[f].shape == (2, 100)
        np.testing.assert_allclose(got[f], want[f], rtol=1e-3,
                                   atol=ATOL.get(f, 1e-2), err_msg=f)


def test_pad_tracks_is_finite_and_increasing():
    t_in = torch.tensor([[0.0, 1.0, 3.0]])
    v_in = torch.arange(9, dtype=torch.float32).reshape(1, 3, 3)
    t_out = torch.tensor([[0.0, 1.0]])
    t_p, v_p, q_p, K = _pad_tracks(t_in, v_in, t_out)
    assert K == 2 and t_p.shape == (1, 128) and q_p.shape == (1, 128)
    assert torch.isfinite(t_p).all() and (t_p.diff(dim=1) > 0).all()
    assert (v_p[0, :, 3:] == v_in[0, :, 2:3]).all()
    assert (q_p[0, 2:] == 1.0).all()


def test_process_segments_masks_padding():
    dem = _dem()
    args = _ragged_inputs(4, 128, seed=1)
    count_out = args[4]
    out = _port(dem, args)
    idx = np.arange(128)[None, :]
    for f in FIELDS:
        assert (out[f][idx >= count_out[:, None]] == 0).all(), f
        assert np.isfinite(out[f]).all(), f


def test_process_segments_counts_compile_cache():
    """The first sighting of a bucket shape is a miss, a repeat a hit;
    the agl_oracle variant and the backend are part of the key."""
    dem = torch.from_numpy(_dem())
    args = _ragged_inputs(2, 128, seed=3)
    tops.reset_pipeline_stats()
    tops.process_segments(dem, *args, grid=GRID)
    tops.process_segments(dem, *args, grid=GRID)
    assert tops.get_pipeline_stats() == {
        "intermediate_transfers": 0, "compile_hits": 1, "compile_misses": 1}
    tops.process_segments(dem, *args, grid=GRID, agl_oracle=True)
    tops.process_segments(dem, *args, grid=GRID, backend="ref")
    stats = tops.get_pipeline_stats()
    assert stats["compile_misses"] == 3 and stats["compile_hits"] == 1
    tops.reset_pipeline_stats(forget_shapes=False)
    tops.process_segments(dem, *args, grid=GRID)
    assert tops.get_pipeline_stats()["compile_hits"] == 1
    assert tops.get_pipeline_stats()["compile_misses"] == 0
