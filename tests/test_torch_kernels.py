"""Port kernels' plain versions vs the JAX package's ops.

The same numpy inputs go through ``repro.kernels.ops`` (Pallas in
interpret mode, as tests/test_kernels.py runs it) and through
``repro_torch.kernels.ops`` on CPU tensors, where each kernel wrapper
runs its plain PyTorch version.  Shapes and tolerances are those of
tests/test_kernels.py.  The CUDA kernels themselves are held against
these plain versions on the card (tests/test_torch_cuda.py and
chip_smoke.py).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import agl_lookup as agl_mod
from repro_torch.kernels import ops as tops
from repro_torch.kernels import track_interp as interp_mod
from repro_torch.kernels import dynamic_rates as rates_mod

# The tensors here are small: keep torch to one thread so the suite's
# other workers, some of them timing-sensitive, keep their cores.
torch.set_num_threads(1)


def _np(x):
    return np.asarray(x.cpu() if torch.is_tensor(x) else x)


def _tracks(B, N, C, M, seed=0):
    rng = np.random.default_rng(seed)
    t_in = np.sort(rng.uniform(0, 900, (B, N)), axis=1).astype(np.float32)
    count = rng.integers(2, N + 1, size=B).astype(np.int32)
    for b in range(B):
        c = count[b]
        t_in[b, c:] = t_in[b, c - 1] + np.arange(1, N - c + 1)
    v_in = rng.normal(size=(B, C, N)).astype(np.float32)
    t_out = rng.uniform(-100, 1000, (B, M)).astype(np.float32)
    return t_in, v_in, count, t_out


@pytest.mark.parametrize("B,N,C,M", [
    (1, 16, 1, 32), (3, 100, 3, 257), (2, 128, 5, 512),
    (4, 300, 2, 64), (2, 1024, 3, 1024),
])
def test_track_interp_matches_jax(B, N, C, M):
    args = _tracks(B, N, C, M, seed=B * 7 + M)
    got = _np(tops.track_interp(*args))
    want = np.asarray(jops.track_interp(*args))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(_np(tops.track_interp(*args, backend="ref")),
                               np.asarray(jref.track_interp_ref(*args)),
                               rtol=1e-5, atol=1e-4)


def test_track_interp_exact_at_knots():
    """Interpolating at the observation times returns the observations."""
    B, N, C = 2, 64, 3
    t_in, v_in, count, _ = _tracks(B, N, C, 1, seed=9)
    got = _np(tops.track_interp(t_in, v_in, count, t_in))
    want = np.asarray(jops.track_interp(t_in, v_in, count, t_in))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    for b in range(B):
        c = count[b]
        np.testing.assert_allclose(
            got[b, :c], v_in[b, :, :c].T, rtol=1e-4, atol=1e-3)


def test_track_interp_clamps_out_of_range():
    B, N, C, M = 1, 32, 2, 16
    t_in, v_in, count, _ = _tracks(B, N, C, M, seed=3)
    for q in (-1e6, 1e6):
        t_out = np.full((B, M), q, np.float32)
        got = _np(tops.track_interp(t_in, v_in, count, t_out))
        want = np.asarray(jops.track_interp(t_in, v_in, count, t_out))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
        edge = 0 if q < 0 else count[0] - 1
        np.testing.assert_allclose(
            got[0], np.tile(v_in[0, :, edge], (M, 1)), rtol=1e-4, atol=1e-3)


def test_track_interp_zero_length_interval_and_count_two():
    """Repeated knot times give w = 0 (no division by zero), and a
    padding-style row with count = 2 interpolates its two knots."""
    t_in = np.array([[0.0, 5.0, 5.0, 10.0, 11.0, 12.0],
                     [0.0, 1.0, 2.0, 3.0, 4.0, 5.0]], np.float32)
    v_in = np.arange(12, dtype=np.float32).reshape(2, 1, 6)
    count = np.array([4, 2], np.int32)
    t_out = np.array([[0.0, 2.5, 5.0, 7.5, 10.0, 20.0],
                      [-1.0, 0.0, 0.25, 0.5, 1.0, 3.0]], np.float32)
    got = _np(tops.track_interp(t_in, v_in, count, t_out))
    want = np.asarray(jops.track_interp(t_in, v_in, count, t_out))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got[1, :, 0],
                               [6.0, 6.0, 6.25, 6.5, 7.0, 7.0])


def _eastward(B, M, seed):
    """Tracks drifting east: headings stay in (0, pi), off the +-pi cut,
    so an ulp of atan2 between XLA and torch cannot flip a wrap."""
    rng = np.random.default_rng(seed)
    v = np.zeros((B, 3, M), np.float32)
    v[:, 0] = 40 + np.cumsum(rng.normal(0, 1e-4, (B, M)), axis=1)
    v[:, 1] = -100 + np.cumsum(rng.uniform(5e-4, 2e-3, (B, M)), axis=1)
    v[:, 2] = 1000 + np.cumsum(rng.normal(0, 2, (B, M)), axis=1)
    count = rng.integers(2, M + 1, size=B).astype(np.int32)
    return v, count


@pytest.mark.parametrize("B,M", [(1, 16), (3, 240), (2, 1024), (5, 100)])
def test_dynamic_rates_matches_jax(B, M):
    v, count = _eastward(B, M, seed=B * 11 + M)
    got = _np(tops.dynamic_rates(v, count, 1.0))
    want = np.asarray(jops.dynamic_rates(v, count, 1.0))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(
        _np(tops.dynamic_rates(v, count, 1.0, backend="ref")),
        np.asarray(jref.dynamic_rates_ref(v, count, 1.0)),
        rtol=1e-4, atol=1e-3)


def test_dynamic_rates_straight_line_speed():
    """Due-north at constant speed: gspeed == v, turn == 0."""
    M = 128
    v = np.zeros((1, 3, M), np.float32)
    v[0, 0] = 40.0 + np.arange(M) * 100.0 / 111_111.0
    v[0, 1] = -100.0
    v[0, 2] = 1000.0
    out = _np(tops.dynamic_rates(v, np.array([M], np.int32), 1.0))
    np.testing.assert_allclose(out[0, 1], 100.0, rtol=1e-2)
    np.testing.assert_allclose(out[0, 3], 0.0, atol=2e-2)


def test_heading_wrap_is_a_floor_mod():
    """A track flying south zig-zags across the +-pi heading cut.  At
    the one-sided track ends the raw heading difference is near -2 pi,
    so dh + pi < 0: a floor-mod (jnp's and torch's %) wraps it to a
    small turn, where a truncating fmod would leave about -2 pi."""
    M = 64
    v = np.zeros((1, 3, M), np.float32)
    v[0, 0] = 40.0 - np.arange(M) * 1e-3                 # due south
    v[0, 1] = -100.0 + 2e-5 * np.array([0, 1, -1])[np.arange(M) % 3]
    v[0, 2] = 1000.0
    count = np.array([M], np.int32)
    out = _np(tops.dynamic_rates(v, count, 1.0))
    heading, turn = out[0, 2], out[0, 3]
    assert (np.abs(np.abs(heading) - math.pi) < 0.2).all()
    assert (heading > 0).any() and (heading < 0).any()  # crosses the cut
    # The reference's formula in float64 from the port's headings.
    li = np.maximum(np.arange(M) - 1, 0)
    ri = np.minimum(np.arange(M) + 1, M - 1)
    dh = (heading[ri].astype(np.float64) - heading[li]) / (ri - li)
    floor_wrapped = np.mod(dh + math.pi, 2 * math.pi) - math.pi
    trunc_wrapped = np.fmod(dh + math.pi, 2 * math.pi) - math.pi
    neg = dh + math.pi < 0
    assert neg.any()
    np.testing.assert_allclose(turn, floor_wrapped, atol=1e-5)
    assert np.abs(turn[neg]).max() < 0.1
    assert np.abs(trunc_wrapped[neg]).min() > 6.0


@pytest.mark.parametrize("B,M,H,W", [
    (1, 16, 64, 64), (3, 300, 200, 400), (2, 128, 128, 256),
])
def test_agl_lookup_matches_jax(B, M, H, W):
    rng = np.random.default_rng(B + M)
    dem = rng.uniform(0, 3000, (H, W)).astype(np.float32)
    fi = rng.uniform(2, min(H - 2, 100), (B, M)).astype(np.float32)
    fj = rng.uniform(2, min(W - 2, 200), (B, M)).astype(np.float32)
    alt = rng.uniform(0, 4000, (B, M)).astype(np.float32)
    got = _np(tops.agl_lookup(dem, fi, fj, alt))
    want = np.asarray(jops.agl_lookup(dem, fi, fj, alt))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-2)


def test_agl_lookup_wide_track_rows():
    """Rows that span several reference DEM tiles (the JAX op routes
    them to its oracle) and rows inside one tile, in one batch: the
    port's single gather serves both."""
    rng = np.random.default_rng(9)
    dem = rng.uniform(0, 3000, (512, 512)).astype(np.float32)
    B, M = 5, 64
    fi = rng.uniform(10, 100, (B, M)).astype(np.float32)
    fj = rng.uniform(10, 200, (B, M)).astype(np.float32)
    fi[1] = rng.uniform(0, 500, M)
    fj[3] = rng.uniform(0, 500, M)
    alt = rng.uniform(0, 4000, (B, M)).astype(np.float32)
    got = _np(tops.agl_lookup(dem, fi, fj, alt))
    np.testing.assert_allclose(got, np.asarray(jops.agl_lookup(
        dem, fi, fj, alt)), rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(got, np.asarray(jref.agl_lookup_ref(
        jnp.asarray(dem), fi, fj, alt)), rtol=1e-5, atol=1e-3)


def test_agl_on_grid_points_is_exact():
    rng = np.random.default_rng(6)
    dem = rng.uniform(0, 3000, (128, 256)).astype(np.float32)
    ii = rng.integers(0, 100, (1, 32))
    jj = rng.integers(0, 200, (1, 32))
    alt = np.zeros((1, 32), np.float32)
    got = _np(tops.agl_lookup(dem, ii.astype(np.float32),
                              jj.astype(np.float32), alt))
    np.testing.assert_allclose(got[0], -dem[ii[0], jj[0]], rtol=1e-5)


def test_agl_ref_clamps_far_neighbour_like_jax():
    """At the grid's last row/column the plain version clamps the far
    neighbour into the grid, as the JAX gather does."""
    dem = np.arange(12, dtype=np.float32).reshape(3, 4)
    fi = np.array([[2.0, 2.0, 0.5, 5.0]], np.float32)
    fj = np.array([[3.0, 1.5, 3.0, -1.0]], np.float32)
    alt = np.zeros_like(fi)
    got = _np(tops.agl_lookup(dem, fi, fj, alt, backend="ref"))
    want = np.asarray(jref.agl_lookup_ref(jnp.asarray(dem), fi, fj, alt))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_no_card_means_no_silent_cpu_fallback(monkeypatch):
    """Entry points default to the card: without one they raise rather
    than compute on the CPU, and a kernel wrapper given a tensor that is
    not on the CPU never takes the plain path."""
    from repro_torch.tracks.segments import SegmentProcessor
    from repro_torch.tracks.workflow import TrackWorkflow
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tops.resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SegmentProcessor()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrackWorkflow("unused-root")
    assert tops.resolve_device("cpu").type == "cpu"
    meta = dict(device="meta", dtype=torch.float32)
    before = (interp_mod.launches, agl_mod.launches, rates_mod.launches)
    with pytest.raises(ValueError, match="not cuda"):
        interp_mod.track_interp(
            torch.empty(2, 8, **meta), torch.empty(2, 3, 8, **meta),
            torch.empty(2, device="meta", dtype=torch.int32),
            torch.empty(2, 16, **meta))
    with pytest.raises(ValueError, match="not cuda"):
        agl_mod.agl_lookup(torch.empty(4, 4, **meta),
                           *(torch.empty(1, 8, **meta) for _ in range(3)))
    with pytest.raises(ValueError, match="not cuda"):
        rates_mod.dynamic_rates(
            torch.empty(1, 3, 8, **meta),
            torch.empty(1, device="meta", dtype=torch.int32), 1.0)
    assert (interp_mod.launches, agl_mod.launches,
            rates_mod.launches) == before
