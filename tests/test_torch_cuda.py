"""The port's CUDA kernels against their plain versions, and the LM
path between card and CPU, on the card.

Marked ``cuda``: each test skips when no CUDA device is present, so on
a CPU-only machine they count as skipped.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX (the card's machine has none); the plain
versions were checked against JAX in tests/test_torch_kernels.py.
"""

import dataclasses
import json
import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels import agl_lookup as agl_mod
from repro_torch.kernels import dynamic_rates as rates_mod
from repro_torch.kernels import encounter_screen as screen_mod
from repro_torch.kernels import ref
from repro_torch.kernels import track_interp as interp_mod

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _tracks(B, N, C, M, seed):
    rng = np.random.default_rng(seed)
    t_in = np.sort(rng.uniform(0, 900, (B, N)), axis=1).astype(np.float32)
    count = rng.integers(2, N + 1, size=B).astype(np.int32)
    for b in range(B):
        c = count[b]
        t_in[b, c:] = t_in[b, c - 1] + np.arange(1, N - c + 1)
    v_in = rng.normal(size=(B, C, N)).astype(np.float32)
    t_out = rng.uniform(-100, 1000, (B, M)).astype(np.float32)
    return t_in, v_in, count, t_out


def test_kernels_take_more_rows_than_grid_y_allows(dev):
    # 70000 rows is past CUDA's 65535 limit on grid.y; rows ride on grid.x.
    B, N, C, M = 70_000, 8, 3, 16
    args = [torch.from_numpy(x).to(dev) for x in _tracks(B, N, C, M, 5)]
    torch.testing.assert_close(interp_mod.track_interp(*args),
                               ref.track_interp_ref(*args),
                               rtol=1e-5, atol=1e-4)
    rng = np.random.default_rng(6)
    v = np.zeros((B, 3, M), np.float32)
    v[:, 0] = 40 + np.cumsum(rng.normal(0, 1e-4, (B, M)), axis=1)
    v[:, 1] = -100 + np.cumsum(rng.normal(0, 1e-4, (B, M)), axis=1)
    v[:, 2] = 1000 + np.cumsum(rng.normal(0, 2, (B, M)), axis=1)
    count = rng.integers(0, M + 1, size=B).astype(np.int32)
    v, count = torch.from_numpy(v).to(dev), torch.from_numpy(count).to(dev)
    got = rates_mod.dynamic_rates(v, count, 1.0)
    want = ref.dynamic_rates_ref(v, count, 1.0)
    heading = (got[:, 2].double() - want[:, 2].double() + math.pi) \
        % (2 * math.pi) - math.pi
    assert heading.abs().max().item() <= 1e-3
    for c in (0, 1, 3):
        torch.testing.assert_close(got[:, c], want[:, c], rtol=1e-4,
                                   atol=1e-3)


@pytest.mark.parametrize("B,N,C,M", [
    (1, 16, 1, 32), (3, 100, 3, 257), (4, 300, 2, 64), (64, 128, 3, 1024),
])
def test_track_interp_kernel(dev, B, N, C, M):
    args = [torch.from_numpy(x).to(dev) for x in _tracks(B, N, C, M, B + M)]
    before = interp_mod.launches
    got = interp_mod.track_interp(*args)
    torch.cuda.synchronize()
    assert interp_mod.launches == before + 1
    want = ref.track_interp_ref(*args)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    assert torch.equal(got, want)
    knots = interp_mod.track_interp(args[0], args[1], args[2], args[0])
    want_k = ref.track_interp_ref(args[0], args[1], args[2], args[0])
    torch.testing.assert_close(knots, want_k, rtol=1e-5, atol=1e-4)
    assert torch.equal(knots, want_k)


@pytest.mark.parametrize("B,M", [(1, 16), (3, 240), (5, 100), (64, 1024)])
def test_dynamic_rates_kernel(dev, B, M):
    rng = np.random.default_rng(B * 11 + M)
    v = np.zeros((B, 3, M), np.float32)
    v[:, 0] = 40 + np.cumsum(rng.normal(0, 1e-4, (B, M)), axis=1)
    v[:, 1] = -100 + np.cumsum(rng.normal(0, 1e-4, (B, M)), axis=1)
    v[:, 2] = 1000 + np.cumsum(rng.normal(0, 2, (B, M)), axis=1)
    count = rng.integers(0, M + 1, size=B).astype(np.int32)
    v, count = torch.from_numpy(v).to(dev), torch.from_numpy(count).to(dev)
    got = rates_mod.dynamic_rates(v, count, 1.0)
    want = ref.dynamic_rates_ref(v, count, 1.0)
    heading = (got[:, 2].double() - want[:, 2].double() + math.pi) \
        % (2 * math.pi) - math.pi
    assert heading.abs().max().item() <= 1e-3
    for c in (0, 1, 3):
        torch.testing.assert_close(got[:, c], want[:, c], rtol=1e-4,
                                   atol=1e-3)
    assert torch.equal(got, want)


def _misaligned(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` whose storage starts one float past a
    16-byte boundary (a slice at storage offset 1)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    assert out.is_contiguous() and out.data_ptr() % 16 == 4
    return out


def _interp_case(dev, B, N, C, M, seed, queries="random"):
    t_in, v_in, count, t_out = _tracks(B, N, C, M, seed)
    if queries != "random":
        # Spread over each row's own knot span and a margin either side,
        # so a thread's 4 queries cross several knots.
        lo = t_in[:, :1] - 50
        hi = t_in[np.arange(B), count - 1][:, None] + 50
        t_out = (lo + (hi - lo) * np.linspace(0, 1, M)[None, :]).astype(
            np.float32)
        if queries == "decreasing":
            t_out = t_out[:, ::-1].copy()
    return [torch.from_numpy(x).to(dev) for x in (t_in, v_in, count, t_out)]


def _check_split(split, M, expect):
    """The split ``expect`` names was the one taken: "rows" (several
    whole rows a block) or "loop" (a thread takes several groups of 4
    in turn)."""
    if expect == "rows":
        assert split.rows > 1
    elif expect == "loop":
        assert split.per_row * 4 < M


def _interp_equal(args, route, vec, expect=None):
    before = dict(interp_mod.launches_by_route)
    got = interp_mod.track_interp(*args)
    torch.cuda.synchronize()
    split = interp_mod.last_plan
    assert interp_mod.launches_by_route[route] == before[route] + 1
    assert split.route == route and split.vec == vec
    _check_split(split, args[3].shape[1], expect)
    want = ref.track_interp_ref(*args)
    assert torch.equal(got, want), (got - want).abs().max().item()


@pytest.mark.parametrize("B,N,C,M,queries,expect", [
    (1024, 128, 3, 128, "random", "rows"),     # 8 rows a block
    (9, 128, 3, 256, "increasing", "rows"),    # the forward walk
    (9, 128, 3, 256, "decreasing", "rows"),    # a fresh search each query
    (1, 128, 3, 1024, "increasing", None),     # the workflows' top shape
    (4, 128, 3, 1024, "random", None),
    (500, 300, 3, 2048, "increasing", "loop"),
    (5, 40, 1, 64, "random", "rows"),          # C = 1: generic kernel,
    (5, 40, 5, 64, "increasing", "rows"),      # 16-byte query loads
])
def test_track_interp_kernel_paths(dev, B, N, C, M, queries, expect):
    args = _interp_case(dev, B, N, C, M, B * 7 + M, queries)
    _interp_equal(args, "shared", True, expect)


@pytest.mark.parametrize("M", [255, 257, 130])
def test_track_interp_kernel_ragged_width(dev, M):
    # M % 4 != 0: the scalar query path, every ragged tail length.
    args = _interp_case(dev, 6, 100, 3, M, M)
    _interp_equal(args, "shared", False)
    args = _interp_case(dev, 6, 100, 3, M, M, "increasing")
    _interp_equal(args, "shared", False)


def test_track_interp_kernel_misaligned_bases(dev):
    # Inputs whose bases sit 4 bytes past a 16-byte boundary: 4-byte
    # staging copies and the scalar query path.
    t_in, v_in, count, t_out = _interp_case(dev, 7, 128, 3, 256, 3)
    args = [_misaligned(t_in), _misaligned(v_in), count, _misaligned(t_out)]
    _interp_equal(args, "shared", False)
    # Only the knots misaligned: the 16-byte query path still applies.
    args = [_misaligned(t_in), _misaligned(v_in), count, t_out]
    _interp_equal(args, "shared", True)


@pytest.mark.parametrize("C,route", [(3, "shared"), (5, "gather")])
def test_track_interp_kernel_longest_rows(dev, C, route):
    # N = 12288: C = 3 stages 196 KB a row (shared memory past 48 KB);
    # C = 5 does not fit 227 KB and reads its values from device memory.
    B, N, M = 3, interp_mod.MAX_KNOTS, 1024
    args = _interp_case(dev, B, N, C, M, C, "increasing")
    _interp_equal(args, route, True)
    args = _interp_case(dev, B, N, C, M, C + 1)
    _interp_equal(args, route, True)


def _rates_case(dev, B, M, seed, count=None):
    rng = np.random.default_rng(seed)
    v = np.zeros((B, 3, M), np.float32)
    v[:, 0] = 40 + np.cumsum(rng.normal(0, 1e-4, (B, M)), axis=1)
    v[:, 1] = -100 + np.cumsum(rng.normal(0, 1e-4, (B, M)), axis=1)
    v[:, 2] = 1000 + np.cumsum(rng.normal(0, 2, (B, M)), axis=1)
    if count is None:
        count = rng.integers(0, M + 1, size=B)
    count = np.broadcast_to(np.asarray(count), (B,)).astype(np.int32)
    return (torch.from_numpy(v).to(dev),
            torch.from_numpy(count.copy()).to(dev))


def _rates_equal(v, count, vec, expect=None, dt=1.0):
    got = rates_mod.dynamic_rates(v, count, dt)
    torch.cuda.synchronize()
    split = rates_mod.last_plan
    assert split.vec == vec
    M = v.shape[2]
    _check_split(split, M, expect)
    want = ref.dynamic_rates_ref(v, torch.clamp(count, max=M), dt)
    assert torch.equal(got, want), (got - want).abs().max().item()
    return got


@pytest.mark.parametrize("B,M,expect", [
    (1024, 128, "rows"),   # 8 rows a block
    (9, 512, "rows"),
    (1, 1024, None),       # the workflows' top shape
    (3, 4096, "loop"),     # a warp takes 4 x 128 positions in turn
    (70, 16, "rows"),      # a warp wider than its row
])
def test_dynamic_rates_kernel_paths(dev, B, M, expect):
    v, count = _rates_case(dev, B, M, B + M)
    _rates_equal(v, count, True, expect)
    # Every row full length: every warp edge inside a track.
    v, count = _rates_case(dev, B, M, B + M + 1, count=M)
    _rates_equal(v, count, True, expect)


@pytest.mark.parametrize("count", [0, 1, 2, 3, 4, 5, 127, 128, 129])
def test_dynamic_rates_kernel_short_and_edge_counts(dev, count):
    # Counts 0-2, and counts either side of a thread's and a warp's edge.
    v, c = _rates_case(dev, 4, 256, count, count=count)
    got = _rates_equal(v, c, True)
    assert not got[:, :, count:].any()


def test_dynamic_rates_kernel_count_past_width(dev):
    # A count above M reads as M, as before the redesign.
    v, count = _rates_case(dev, 5, 256, 9, count=[300, 257, 256, 1000, 2])
    got = _rates_equal(v, count, True)
    assert torch.equal(got, rates_mod.dynamic_rates(
        v, torch.clamp(count, max=256), 1.0))


@pytest.mark.parametrize("M", [255, 257, 130, 33])
def test_dynamic_rates_kernel_ragged_width(dev, M):
    v, count = _rates_case(dev, 6, M, M)
    _rates_equal(v, count, False)
    v, count = _rates_case(dev, 6, M, M + 1, count=M)
    _rates_equal(v, count, False)


def test_dynamic_rates_kernel_misaligned_base(dev):
    v, count = _rates_case(dev, 6, 256, 21)
    _rates_equal(_misaligned(v), count, False)
    # dt other than 1 s: a power of two (divisions by powers of two), and
    # not one (IEEE divisions).
    _rates_equal(v, count, True, dt=0.5)
    _rates_equal(v, count, True, dt=0.3)
    _rates_equal(_misaligned(v), count, False, dt=0.3)


def test_interp_and_rates_launch_only_the_plans_grid(dev):
    # The C entries launch the plan's block count and refuse any other
    # (cudaErrorInvalidConfiguration), launching nothing.
    from repro_torch.kernels import _build
    t_in, v_in, count, t_out = _interp_case(dev, 9, 128, 3, 256, 4)
    B, N = t_in.shape
    C, M = v_in.shape[1], t_out.shape[1]
    out = torch.zeros((B, M, C), device=dev)
    p = interp_mod.plan(B, N, C, M)
    for blocks in (p.blocks - 1, p.blocks + 1):
        rc = _build.lib().track_interp_f32(
            t_in.data_ptr(), v_in.data_ptr(), count.data_ptr(),
            t_out.data_ptr(), out.data_ptr(), B, N, C, M, p.rows, p.per_row,
            blocks, p.smem, 0, int(p.vec), _build.stream_of(t_in))
        assert rc == 9
    v, rcount = _rates_case(dev, 9, 256, 5)
    r_out = torch.zeros((9, 4, 256), device=dev)
    q = rates_mod.plan(9, 256)
    for blocks in (q.blocks - 1, q.blocks + 1):
        rc = _build.lib().dynamic_rates_f32(
            v.data_ptr(), rcount.data_ptr(), r_out.data_ptr(), 9, 256, 1.0,
            q.rows, q.per_row, blocks, int(q.vec), _build.stream_of(v))
        assert rc == 9
    torch.cuda.synchronize()
    assert not out.any() and not r_out.any()


@pytest.mark.parametrize("B,M,H,W", [
    (1, 16, 64, 64), (3, 300, 200, 400), (8, 1024, 3121, 7081),
])
def test_agl_lookup_kernel(dev, B, M, H, W):
    rng = np.random.default_rng(B + M)
    dem = torch.from_numpy(
        rng.uniform(0, 3000, (H, W)).astype(np.float32)).to(dev)
    fi, fj, alt = (torch.from_numpy(x.astype(np.float32)).to(dev) for x in (
        rng.uniform(-2, H + 1, (B, M)), rng.uniform(-2, W + 1, (B, M)),
        rng.uniform(0, 4000, (B, M))))
    got = agl_mod.agl_lookup(dem, fi, fj, alt)
    want = ref.agl_lookup_ref(dem, fi, fj, alt)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-2)


def test_segment_processor_card_matches_cpu(dev, tmp_path):
    from repro_torch.geometry.aerodromes import synthetic_aerodromes
    from repro_torch.tracks.segments import (
        SegmentProcessor, segment_tasks_from_archive_tree)
    from repro_torch.tracks.workflow import TrackWorkflow
    wf = TrackWorkflow(str(tmp_path), n_workers=2, device="cpu")
    wf.generate_raw(n_files=2, scale=2e4)
    wf.run()
    tasks = segment_tasks_from_archive_tree(wf.archive_dir)
    aero = synthetic_aerodromes(n=64)
    got = SegmentProcessor(aerodromes=aero).process_batch(tasks)
    want = SegmentProcessor(aerodromes=aero,
                            device="cpu").process_batch(tasks)
    # Both sides run the same f32 operations (no FMA); only cosf/atan2f
    # ulps differ between the CUDA and CPU math libraries.
    for tid, w in want.items():
        g = got[tid]
        assert g.icao24 == w.icao24 and g.airspace == w.airspace
        np.testing.assert_array_equal(g.count, w.count)
        for attr in ("times", "lat", "lon", "alt_msl_m", "alt_agl_m",
                     "vrate_ms", "gspeed_ms", "turn_rad_s"):
            np.testing.assert_allclose(getattr(g, attr), getattr(w, attr),
                                       rtol=1e-6, atol=1e-4, err_msg=attr)
        d = np.angle(np.exp(1j * (g.heading_rad.astype(np.float64)
                                  - w.heading_rad)))
        assert np.abs(d).max(initial=0.0) <= 1e-4


def test_workflow_processes_backend_forks_workers_onto_card(dev, tmp_path):
    # A fresh interpreter: the parent checks for the card without starting
    # CUDA, so its workers are forked and each opens the card itself.
    code = (
        "import json, sys, torch\n"
        "from repro_torch.runtime import transports\n"
        "from repro_torch.tracks.workflow import TrackWorkflow\n"
        "wf = TrackWorkflow(sys.argv[1], n_workers=2,\n"
        "                   exec_backend='processes', device='cuda')\n"
        "wf.generate_raw(n_files=2, scale=2e4)\n"
        "assert transports._default_start_method() == 'fork'\n"
        "reports = wf.run()\n"
        "assert not torch.cuda.is_initialized()\n"
        "print(json.dumps([[r.phase, r.tasks] for r in reports]))\n")
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src)
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    phases = json.loads(out.stdout.strip().splitlines()[-1])
    assert [p for p, _ in phases] == ["organize", "archive", "process"]
    assert phases[-1][1] > 0


def _cells(C, K, T, seed, n_valid=None):
    """Clustered 1 Hz trails around one point per cell (a real share of
    pairs hits), each row valid over a random span."""
    rng = np.random.default_rng(seed)
    lat = (40.0 + rng.normal(0, 0.005, (C, K, 1))
           + np.cumsum(rng.normal(0, 1e-4, (C, K, T)), axis=2))
    lon = (-100.0 + rng.normal(0, 0.005, (C, K, 1))
           + np.cumsum(rng.normal(0, 1e-4, (C, K, T)), axis=2))
    alt = rng.uniform(400, 900, (C, K, 1)) + rng.normal(0, 5, (C, K, T))
    s = rng.integers(0, T // 2, (C, K, 1))
    e = rng.integers(T // 2, T + 1, (C, K, 1))
    t = np.arange(T)[None, None, :]
    val = ((t >= s) & (t < e)).astype(np.float32)
    if n_valid is not None:
        val[:, n_valid:] = 0.0
    return [x.astype(np.float32) for x in (lat, lon, alt, val)]


def _check_screen(got, want):
    hit = want[0] > 0.5
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[3][hit], want[3][hit])
    for g, w in zip(got[1:3], want[1:3]):
        torch.testing.assert_close(g[hit], w[hit], rtol=1e-5, atol=1e-2)
    # No-hit entries (lower triangle and diagonal included) hold the
    # reference's constants.
    for g, fill in zip(got, (0.0, 1e30, 1e30, 0.0)):
        assert bool((g[~hit] == torch.tensor(fill, dtype=torch.float32,
                                             device=g.device)).all())


@pytest.mark.parametrize("C,K,T", [
    (1, 8, 128), (3, 24, 256), (5, 40, 384), (8, 240, 1024),
    (2, 240, 4608),
])
def test_encounter_screen_kernel(dev, C, K, T):
    args = [torch.from_numpy(x).to(dev)
            for x in _cells(C, K, T, seed=C * 7 + K + T, n_valid=K - 3)]
    before = screen_mod.launches
    got = screen_mod.encounter_screen(*args, h_m=926.0, v_m=152.4)
    torch.cuda.synchronize()
    assert screen_mod.launches == before + 1
    want = screen_mod._screen_batch_plain(*args, h_m=926.0, v_m=152.4)
    assert want[0].sum().item() > 0
    _check_screen(got, want)
    oracle = ref.encounter_screen_ref(*(a[0] for a in args),
                                      h_thresh_m=926.0, v_thresh_m=152.4)
    _check_screen(tuple(g[0] for g in got), oracle)


def test_encounter_screen_grid_past_65535_blocks(dev):
    # 66000 cells x 1 tile: grid.x past grid.y's 65535 limit.
    args = [torch.from_numpy(x).to(dev) for x in _cells(66_000, 8, 128, 3)]
    got = screen_mod.encounter_screen(*args, h_m=926.0, v_m=152.4)
    want = screen_mod._screen_batch_plain(*args, h_m=926.0, v_m=152.4)
    _check_screen(got, want)


def _screen_bitwise(dev, planes, h_m=926.0, v_m=152.4):
    """Launch on the card; hold the result bitwise to the plain version
    on the same tensors and, cell by cell, to the oracle.  Returns the
    plain result and the plan the launch took."""
    args = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            for x in planes]
    C, K, T = args[0].shape
    before = screen_mod.launches
    shape_before = screen_mod.launches_by_shape.get((K, T), 0)
    got = screen_mod.encounter_screen(*args, h_m=h_m, v_m=v_m)
    torch.cuda.synchronize()
    assert screen_mod.launches == before + 1
    assert screen_mod.launches_by_shape[(K, T)] == shape_before + 1
    want = screen_mod._screen_batch_plain(*args, h_m=h_m, v_m=v_m)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    _check_screen(got, want)
    for c in range(min(C, 4)):
        oracle = ref.encounter_screen_ref(*(a[c] for a in args),
                                          h_thresh_m=h_m, v_thresh_m=v_m)
        _check_screen(tuple(g[c] for g in got), oracle)
    return want, screen_mod.last_plan


@pytest.mark.parametrize("T", [128, 1024, 4608])
def test_encounter_screen_workflow_launch_shape(dev, T):
    # The screen phase's own launch: one cell of at most 4 rows, padded
    # to K = 8.
    want, plan = _screen_bitwise(dev, _cells(1, 8, T, seed=T, n_valid=4))
    assert plan.regime == "small"
    assert want[0].sum().item() > 0


@pytest.mark.parametrize("K", [16, 32, 40, 240])
def test_encounter_screen_regime_boundary(dev, K):
    want, plan = _screen_bitwise(dev, _cells(3, K, 512, seed=K))
    assert plan.regime == ("small" if K <= 24 else "large")
    assert want[0].sum().item() > 0


def test_encounter_screen_workspace_path(dev):
    # Large K with few cells: several strips in several blocks, merged
    # from the device workspace.
    want, plan = _screen_bitwise(dev, _cells(2, 240, 2048, seed=5))
    assert plan.regime == "large" and plan.block_strips > 1
    assert want[0].sum().item() > 0


def _screen_case(case, K):
    rng = np.random.default_rng(K + len(case))
    C, T = 2, 1024
    if case == "ties":
        # Stationary rows: every jointly valid sample ties for the
        # minimum, so t_idx is the first one; rows 0 and 1 coincide
        # (dh = 0 takes sqrtf's slow path).
        pos = [40.0 + rng.normal(0, 0.002, (C, K, 1)),
               -100.0 + rng.normal(0, 0.002, (C, K, 1)),
               rng.uniform(500, 560, (C, K, 1))]
        for x in pos:
            x[:, 1] = x[:, 0]
        lat, lon, alt = (np.broadcast_to(x, (C, K, T)).astype(np.float32)
                         for x in pos)
        s = rng.integers(0, T // 2, (C, K, 1))
        e = rng.integers(T // 2, T, (C, K, 1))
        t = np.arange(T)[None, None, :]
        return lat, lon, alt, ((t >= s) & (t < e)).astype(np.float32)
    lat, lon, alt, val = _cells(C, K, T, seed=K)
    if case == "holes":
        val[rng.random(val.shape) < 0.3] = 0.0
    elif case == "empty":
        val[:] = 0.0
        for k in range(K):          # no two rows ever jointly valid
            span = T // K
            val[:, k, k * span:(k + 1) * span] = 1.0
    elif case == "quadrants":
        # Latitudes over the globe: the cosine's argument crosses pi/4
        # (both polynomials, both signs); wide thresholds hit every pair.
        lat[:] = rng.uniform(-89.0, 89.0, lat.shape).astype(np.float32)
    elif case.startswith("lat"):
        # Latitudes swept over a full turn around a base beyond the
        # globe: the cosine's argument lies in (pi/2, 105615) rad, so the
        # inlined cosf reduces it by several multiples j of pi/2 and
        # takes every quadrant.  A cell's rows share each sample's
        # latitude (dn = 0) and lie 1e-9 to 1 degree off the prime
        # meridian, so dh is |de|.  No latitude lies within 10 degrees of
        # a zero of the cosine, so min_dh falls on any quadrant.
        u = float(case[3:]) + rng.uniform(-180.0, 180.0, (C, 1, T))
        m = np.mod(u - 90.0, 180.0)
        u = np.where((m < 10.0) | (m > 170.0), u + 20.0, u)
        lat = np.broadcast_to(u, (C, K, T)).astype(np.float32)
        off = (10.0 ** rng.uniform(-9.0, 0.0, (C, K, T))
               * rng.choice([-1.0, 1.0], (C, K, T)))
        lon = off.astype(np.float32)
    elif case == "far":
        # A latitude far outside the globe takes cosf's slow reduction
        # (|argument| >= 105615 rad); the thresholds let its pairs hit.
        lat[:, 0] = 3e7
    return lat, lon, alt, val


@pytest.mark.parametrize("K", [8, 240])
@pytest.mark.parametrize("case", ["ties", "holes", "empty", "quadrants",
                                  "far", "lat150", "lat400", "lat5000",
                                  "lat-3000"])
def test_encounter_screen_cases(dev, case, K):
    thresholds = {"quadrants": (1e8, 1e5), "far": (1e14, 1e5)}
    planes = _screen_case(case, K)
    want, _ = _screen_bitwise(
        dev, planes, *thresholds.get(case, (1e14, 1e5) if case
                                     .startswith("lat") else ()))
    hit = want[0] > 0.5
    if case == "empty":
        assert not hit.any()
        return
    assert hit.any()
    if case == "ties":
        val = torch.from_numpy(planes[3])
        t = torch.arange(val.shape[-1])
        first = torch.where(val != 0, t, 10**6).amin(-1)
        joint = torch.maximum(first[:, :, None], first[:, None, :])
        assert torch.equal(want[3][hit].cpu(), joint[hit.cpu()].float())
        assert (want[1][:, 0, 1] == 0).any()     # the coincident rows
    if case.startswith("lat"):
        # The samples that decide min_dh cover all four quadrants q of
        # cosf's reduction (q = j + 1 mod 4), several j among them.
        c, i, _ = np.nonzero(hit.cpu().numpy())
        t = want[3][hit].cpu().numpy().astype(np.int64)
        x = planes[0][c, i, t] * np.float32(np.pi / 180)
        j = np.rint(x * np.float32(2 / np.pi)).astype(np.int64)
        assert set(((j + 1) % 4).tolist()) == {0, 1, 2, 3}
        assert len(set(j.tolist())) >= 4


def test_screen_workflow_processes_spawns_workers_onto_card(dev, tmp_path):
    # The screen plan runs the segment pipeline on the card in the
    # parent, so the screen phase's workers are spawned, and each opens
    # the card itself.
    code = (
        "import json, sys, torch\n"
        "from repro_torch.kernels.encounter_screen import "
        "brute_force_screen\n"
        "from repro_torch.runtime import transports\n"
        "from repro_torch.tracks.segments import (SegmentProcessor,\n"
        "    segment_tasks_from_store)\n"
        "from repro_torch.tracks.workflow import (TrackWorkflow,\n"
        "    _screen_rows_for_uri)\n"
        "wf = TrackWorkflow(sys.argv[1], n_workers=2,\n"
        "    exec_backend='processes', device='cuda', input='store',\n"
        "    store_target_points=2048, screen=True, screen_h_m=50_000.0,\n"
        "    screen_v_m=1000.0, screen_cell_deg=1.0)\n"
        "wf.generate_raw(n_files=1, scale=1e3)\n"
        "reports = wf.run()\n"
        "assert torch.cuda.is_initialized()\n"
        "assert transports._default_start_method() == 'spawn'\n"
        "proc = SegmentProcessor(device='cuda')\n"
        "rows = [r for t in segment_tasks_from_store(wf.store_dir)\n"
        "        for r in _screen_rows_for_uri(proc, t.payload)]\n"
        "want = brute_force_screen(rows, config=wf.screen_config)\n"
        "got = json.load(open(wf.candidates_path))['candidates']\n"
        "print(json.dumps({'phases': [[r.phase, r.tasks] for r in reports],\n"
        "    'got': [(c['a'], c['b'], c['t_s']) for c in got],\n"
        "    'want': [(c['a'], c['b'], c['t_s']) for c in want]}))\n")
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src)
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         capture_output=True, text=True, env=env,
                         timeout=400)
    assert out.returncode == 0, out.stderr[-4000:]
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    assert [p for p, _ in doc["phases"]] == [
        "organize", "archive", "store-build", "process", "screen"]
    assert doc["phases"][-1][1] > 0
    assert doc["got"] == doc["want"] and doc["got"]


# The streaming DAG on the card, in fresh interpreters: ``fresh`` runs
# the store + screen workflow as one DAG at <base>/run and moves it to
# <base>/dag, ``kill`` runs it until a mid-stream checkpoint holds both
# completed and outstanding screen cells and dies there, ``resume``
# finishes that run and moves it to <base>/dag, ``barrier`` runs the
# barrier phases (threads) and moves them to <base>/barrier.  Every run
# whose store is compared runs at the same path (the manifest records
# the archive root).  The script prints, for each transport built, the
# start method it chose and whether the parent had started CUDA by then,
# and the DAG's tasks done by workers.
_DAG_SCRIPT = r"""
import json, os, sys, torch
from repro_torch.runtime import ManagerCheckpoint, transports
import repro_torch.tracks.workflow as wfm
base, action, backend = sys.argv[1], sys.argv[2], sys.argv[3]
root = os.path.join(base, "run")
kw = dict(input="store", store_target_points=2048, screen=True,
          screen_h_m=50_000.0, screen_v_m=1000.0, screen_cell_deg=1.0,
          n_workers=4, poll_interval=0.003, device="cuda")
built = []
init = transports.ProcessTransport.__init__
def spy(self, *a, **k):
    built.append([torch.cuda.is_initialized()])
    init(self, *a, **k)
    built[-1].append(self._ctx.get_start_method())
transports.ProcessTransport.__init__ = spy
done_by_workers = []
real_run_dag = wfm.run_dag
def run_dag(*a, **k):
    res = real_run_dag(*a, **k)
    done_by_workers.append(sum(s.tasks_completed
                               for s in res.run.worker_stats.values()))
    return res
wfm.run_dag = run_dag
class Killed(RuntimeError):
    pass
class KilledMidScreen(wfm.TrackWorkflow):
    def _save_ckpt(self, state):
        super()._save_ckpt(state)
        if state.get("manager_phase") != "dag" or not state.get("manager"):
            return
        screen = ManagerCheckpoint.loads(
            state["manager"]).frontier["nodes"].get("screen", {})
        if screen.get("completed") and screen.get("outstanding"):
            raise Killed()
mode = "barrier" if action == "barrier" else "dag"
ex = "threads" if action == "barrier" else backend
cls = KilledMidScreen if action == "kill" else wfm.TrackWorkflow
wf = cls(root, mode=mode, exec_backend=ex, checkpoint_interval_s=0.01, **kw)
if action in ("fresh", "kill", "barrier"):
    wf.generate_raw(n_files=1, scale=1e3)
killed = False
try:
    phases = [r.phase for r in wf.run()]
except Killed:
    killed, phases = True, []
if not killed:
    os.rename(root, os.path.join(base, "barrier" if mode == "barrier"
                                 else "dag"))
print(json.dumps({"phases": phases, "killed": killed, "built": built,
                  "done_by_workers": done_by_workers}))
"""


def _dag_step(base, action: str, backend: str = "threads") -> dict:
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src)
    out = subprocess.run([sys.executable, "-c", _DAG_SCRIPT, str(base),
                          action, backend], capture_output=True, text=True,
                         env=env, timeout=400)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _tree(root) -> dict:
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


def _same_as_barrier(base) -> None:
    dag, barrier = _tree(base / "dag"), _tree(base / "barrier")
    assert dag["candidates.json"] == barrier["candidates.json"]
    assert json.loads(dag["candidates.json"])["candidates"]
    store = {k: v for k, v in barrier.items() if k.startswith("store")}
    assert len(store) >= 3
    assert {k: v for k, v in dag.items() if k.startswith("store")} == store


@pytest.mark.parametrize("backend", ["threads", "processes"])
def test_dag_screen_workflow_on_card_matches_barrier(dev, tmp_path, backend):
    # The DAG first, in a fresh interpreter: on a fresh run nothing
    # starts CUDA in the parent before the transport has forked its
    # workers (the cell-bin emitter first touches the card mid-run).
    doc = _dag_step(tmp_path, "fresh", backend)
    assert doc["phases"] == ["dag"]
    if backend == "processes":
        assert doc["built"] == [[False, "fork"]]
        assert doc["done_by_workers"][0] > 0
    assert _dag_step(tmp_path, "barrier")["phases"] == [
        "organize", "archive", "store-build", "process", "screen"]
    _same_as_barrier(tmp_path)


def test_dag_processes_resume_on_card_matches_barrier(dev, tmp_path):
    killed = _dag_step(tmp_path, "kill", "processes")
    assert killed["killed"] and killed["built"] == [[False, "fork"]]
    # The resumed run restores the frontier and the emitters' state
    # without the card, forks its workers, which finish the outstanding
    # cells, and rebuilds the lost cells' results on the card.
    resumed = _dag_step(tmp_path, "resume", "processes")
    assert resumed["phases"] == ["dag"] and not resumed["killed"]
    assert resumed["built"] == [[False, "fork"]]
    assert resumed["done_by_workers"][0] > 0
    _dag_step(tmp_path, "barrier")
    _same_as_barrier(tmp_path)


def test_traced_dag_on_card_matches_untraced(dev, tmp_path, monkeypatch):
    # A traced store + screen DAG on the card: the trace is the run's
    # ledger, the outputs equal an untraced run's, and every task result
    # is host data, so each drive-side exec span ends after its device
    # work (nothing in the tracer or the runtime synchronizes the card).
    import repro_torch.tracks.workflow as wfm
    from repro_torch.obs import Tracer, phase_of

    kept = []
    real_run_dag = wfm.run_dag

    def run_dag(*a, **k):
        kept.append(real_run_dag(*a, **k))
        return kept[-1]

    monkeypatch.setattr(wfm, "run_dag", run_dag)
    root = tmp_path / "run"
    kw = dict(input="store", store_target_points=2048, screen=True,
              screen_h_m=50_000.0, screen_v_m=1000.0, screen_cell_deg=1.0,
              n_workers=4, poll_interval=0.003, device="cuda", mode="dag")
    tracer = Tracer()
    trees = {}
    for name, tr in (("untraced", None), ("traced", tracer)):
        wf = wfm.TrackWorkflow(str(root), tracer=tr, **kw)
        wf.generate_raw(n_files=1, scale=1e3)
        assert [r.phase for r in wf.run()] == ["dag"]
        trees[name] = {k: v for k, v in _tree(root).items()
                       if k.startswith("store") or k == "candidates.json"}
        os.rename(root, tmp_path / name)
    assert len(trees["traced"]) >= 3
    assert trees["traced"] == trees["untraced"]
    assert json.loads(trees["traced"]["candidates.json"])["candidates"]
    events = tracer.events
    assert tracer.dropped == 0
    completed = sorted(kept[1].run.completed_ids)
    execs = [e for e in events if e[2] == "exec"]
    assert sorted(e[5] for e in execs) == completed
    assert sorted(e[5] for e in events if e[2] == "done") == completed
    by_worker = {}
    for e in execs:
        by_worker.setdefault(str(e[4]), []).append(e)
    for spans in by_worker.values():
        spans.sort(key=lambda e: e[0])
        for prev, nxt in zip(spans, spans[1:]):
            assert nxt[0] >= prev[0] + prev[1] - 1e-9
    assert {phase_of(e[5]) for e in execs} == {
        "organize", "archive", "store-build", "process", "screen"}

    def on_host(x):
        if isinstance(x, torch.Tensor):
            return False
        if dataclasses.is_dataclass(x):
            return on_host(vars(x))
        if isinstance(x, dict):
            return all(on_host(v) for v in x.values())
        if isinstance(x, (list, tuple)):
            return all(on_host(v) for v in x)
        return True

    for node in ("process", "screen"):
        results = kept[1].node_results.get(node, {})
        assert results and on_host(list(results.values()))


# ---------------------------------------------------------------------------
# Flash attention and the LM path
# ---------------------------------------------------------------------------

def _qkv(dev, B, H, KV, T, S, hd, seed, dtype=torch.float32):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev).to(dtype)
            for shape in ((B, H, T, hd), (B, KV, S, hd), (B, KV, S, hd))]


@pytest.mark.parametrize("B,H,KV,T,S,hd,causal", [
    (1, 4, 2, 256, 256, 64, True),
    (2, 8, 2, 128, 384, 64, True),
    (1, 2, 2, 256, 256, 128, False),
    (1, 12, 4, 384, 384, 192, True),
    (2, 4, 1, 256, 512, 64, True),
    (1, 4, 4, 200, 300, 64, True),
    (1, 32, 8, 333, 333, 160, True),     # stablelm's heads, ragged T
    (1, 4, 2, 256, 130, 160, True),      # T > S: rows with no key
    (2, 6, 3, 65, 1, 40, True),
    (1, 4, 2, 100, 70, 192, False),
])
def test_flash_attention_kernel(dev, B, H, KV, T, S, hd, causal):
    from repro_torch.kernels import flash_attention as flash_mod
    q, k, v = _qkv(dev, B, H, KV, T, S, hd, seed=T + S + hd)
    before = flash_mod.launches
    got = flash_mod.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_mod.launches == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    if causal and T > S:
        assert not got[:, :, :T - S].any()


def test_flash_attention_kernel_bf16(dev):
    """A bf16 output is one bf16 rounding (unit roundoff 2^-8) of the
    plain version's f32 output; the last shape is the one the full-width
    stablelm-12b forward gives the kernel."""
    from repro_torch.kernels import ops
    for shape in ((1, 4, 2, 128, 128, 64), (1, 32, 8, 512, 512, 160),
                  (2, 32, 8, 2048, 2048, 160)):
        q, k, v = _qkv(dev, *shape, seed=7, dtype=torch.bfloat16)
        got = ops.flash_attention(q, k, v)
        assert got.dtype == torch.bfloat16
        want = ref.flash_attention_ref(q, k, v)
        torch.testing.assert_close(got.float(), want, rtol=2 ** -8,
                                   atol=1e-5)


def test_flash_attention_takes_strided_views(dev):
    """The attention layer's transposed (B, T, H, hd) views go through
    ops.flash_attention, which makes them contiguous; the kernel wrapper
    itself refuses a strided view."""
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ops
    q, k, v = (x.transpose(1, 2).contiguous().transpose(1, 2)
               for x in _qkv(dev, 2, 8, 2, 96, 96, 160, seed=3))
    assert not q.is_contiguous()
    got = ops.flash_attention(q, k, v)
    torch.testing.assert_close(got, ref.flash_attention_ref(q, k, v),
                               rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="not contiguous"):
        flash_mod.flash_attention(q, k, v)


def test_flash_attention_grid_past_65535_blocks(dev):
    # B * H * q-tiles = 1100 * 60 * 1 = 66000 blocks on grid.x.
    from repro_torch.kernels import ops
    q, k, v = _qkv(dev, 1100, 60, 4, 64, 64, 16, seed=5)
    torch.testing.assert_close(ops.flash_attention(q, k, v),
                               ref.flash_attention_ref(q, k, v),
                               rtol=2e-5, atol=2e-5)


# The configs' and the JAX tests' head_dims, the widths taken zero-padded
# (12, 100, 156: not multiples of 8), 200 (padded to 224 inside) and 256.
SM90_HEAD_DIMS = (12, 24, 40, 64, 100, 128, 156, 160, 192, 200, 256)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("T,S", [(200, 200), (130, 333), (300, 111)],
                         ids=["T=S", "T<S", "T>S"])
@pytest.mark.parametrize("hd", SM90_HEAD_DIMS)
def test_flash_attention_sm90_route(dev, hd, T, S, causal):
    """bf16 goes through the tensor-core kernel at every head_dim of the
    configs and the JAX tests, at head_dims the wrapper zero-pads and up
    to 256, with T = S, T < S (chunked prefill) and T > S (rows with no
    key exactly 0), S never a multiple of a key tile, causal and full;
    each output within one bf16 rounding of the plain f32 output."""
    from repro_torch.kernels import flash_attention as flash_mod
    q, k, v = _qkv(dev, 2, 8, 2, T, S, hd, seed=hd + T + S,
                   dtype=torch.bfloat16)
    before = dict(flash_mod.launches_by_route)
    got = flash_mod.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_mod.launches_by_route == {
        r: n + (r == "sm90") for r, n in before.items()}
    assert got.dtype == torch.bfloat16
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want, rtol=2 ** -8, atol=1e-5)
    if causal and T > S:
        assert not got[:, :, :T - S].any()


# As SM90_HEAD_DIMS, and 16; in f32 the wrapper pads only head_dims that
# are not multiples of 4 (6, 13), and takes 12, 100 and 156 as they are.
SM90_F32_HEAD_DIMS = (6, 12, 13, 16, 24, 40, 64, 100, 128, 156, 160, 192,
                      200, 256)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("T,S", [(200, 200), (130, 333), (300, 111)],
                         ids=["T=S", "T<S", "T>S"])
@pytest.mark.parametrize("hd", SM90_F32_HEAD_DIMS)
def test_flash_attention_sm90_f32_route(dev, hd, T, S, causal):
    """f32 goes through the split-TF32 tensor-core kernel at every
    head_dim of the configs and the JAX tests, at head_dims the wrapper
    zero-pads and up to 256, with T = S, T < S and T > S (rows with no
    key exactly 0), S never a multiple of a key tile, causal and full;
    each output within the f32 tolerance (rtol/atol 2e-5) of the plain
    version."""
    from repro_torch.kernels import flash_attention as flash_mod
    q, k, v = _qkv(dev, 2, 8, 2, T, S, hd, seed=hd + T + S)
    before = dict(flash_mod.launches_by_route)
    got = flash_mod.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_mod.launches_by_route == {
        r: n + (r == "sm90_f32") for r, n in before.items()}
    assert got.dtype == torch.float32
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    if causal and T > S:
        assert not got[:, :, :T - S].any()


@pytest.mark.parametrize("dtype,hd", [(torch.bfloat16, 100),
                                      (torch.bfloat16, 156),
                                      (torch.float32, 13)])
def test_flash_attention_padded_launch_leaves_inputs_unmodified(dev, dtype,
                                                                hd):
    """A head_dim whose rows are not a multiple of 16 bytes is launched on
    zero-padded copies: q, k and v keep their shapes and values, the
    output has the true head_dim and is contiguous, and one launch is
    counted on the dtype's tensor-core route."""
    from repro_torch.kernels import flash_attention as flash_mod
    q, k, v = _qkv(dev, 1, 8, 2, 200, 300, hd, seed=hd, dtype=dtype)
    kept = [x.clone() for x in (q, k, v)]
    route = flash_mod.route(dtype, hd)
    before = flash_mod.launches_by_route[route]
    got = flash_mod.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_mod.launches_by_route[route] == before + 1
    for x, y in zip((q, k, v), kept):
        assert x.shape[-1] == hd and torch.equal(x, y)
    assert got.shape == (1, 8, 200, hd) and got.is_contiguous()
    rtol, atol = (2e-5, 2e-5) if dtype == torch.float32 else (2 ** -8, 1e-5)
    torch.testing.assert_close(got.float(), ref.flash_attention_ref(q, k, v),
                               rtol=rtol, atol=atol)


# One rounding of each output dtype: (rtol, atol).
FLASH_GATES = {torch.bfloat16: (2 ** -8, 1e-5), torch.float16: (2 ** -11, 1e-5),
               torch.float32: (2e-5, 2e-5)}


def _one_launch_on(flash_mod, route, call):
    """``call()``'s output, with exactly one launch counted, on ``route``."""
    before = dict(flash_mod.launches_by_route)
    out = call()
    torch.cuda.synchronize()
    assert flash_mod.launches_by_route == {
        r: n + (r == route) for r, n in before.items()}
    return out


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("T,S", [(200, 200), (130, 333), (300, 111)],
                         ids=["T=S", "T<S", "T>S"])
@pytest.mark.parametrize("hd", SM90_HEAD_DIMS)
def test_flash_attention_sm90_f16_route(dev, hd, T, S, causal):
    """f16 goes through the sm90 kernel's f16 instantiation at every
    head_dim the bf16 route is held at, T = S, T < S and T > S (rows with
    no key exactly 0), causal and full; each output within one f16
    rounding (rtol 2^-11, atol 1e-5) of the plain f32 output."""
    from repro_torch.kernels import flash_attention as flash_mod
    q, k, v = _qkv(dev, 2, 8, 2, T, S, hd, seed=hd + T + S,
                   dtype=torch.float16)
    got = _one_launch_on(flash_mod, "sm90_f16",
                         lambda: flash_mod.flash_attention(q, k, v,
                                                           causal=causal))
    assert got.dtype == torch.float16
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want, rtol=2 ** -11, atol=1e-5)
    if causal and T > S:
        assert not got[:, :, :T - S].any()


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16,
                                   torch.float32],
                         ids=["f16", "bf16", "f32"])
@pytest.mark.parametrize("T,S,causal", [(200, 200, True), (130, 333, True),
                                        (300, 111, True), (96, 160, False)],
                         ids=["T=S", "T<S", "T>S", "full"])
@pytest.mark.parametrize("hd", [257, 264, 320, 384, 576, 768, 1024])
def test_flash_attention_wide_route(dev, hd, T, S, causal, dtype):
    """Above head_dim 256 every dtype goes through the wide kernels: one
    launch on the "wide" route, the output in the input's dtype within
    one rounding of it (2e-5 in f32) of the plain version, rows with no
    key exactly 0; 257 is not a multiple of 8 (zero-padded to 264 in 16
    bits and 260 in f32), and the chunk plan's edges: 264 and 320 take
    two chunks of 160 columns, 384 two of 192, 576 three of 192, 768
    three of 256 and 1024 four."""
    from repro_torch.kernels import flash_attention as flash_mod
    q, k, v = _qkv(dev, 2, 8, 2, T, S, hd, seed=hd + T + S, dtype=dtype)
    got = _one_launch_on(flash_mod, "wide",
                         lambda: flash_mod.flash_attention(q, k, v,
                                                           causal=causal))
    assert got.dtype == dtype and got.shape == (2, 8, T, hd)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    rtol, atol = FLASH_GATES[dtype]
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=atol)
    if causal and T > S:
        assert not got[:, :, :T - S].any()


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16,
                                   torch.float32],
                         ids=["f16", "bf16", "f32"])
@pytest.mark.parametrize("hd", [2048, 4100])
def test_flash_attention_wide_route_has_no_upper_head_dim(dev, hd, dtype):
    """head_dim 2048 (eight chunks of 256) and 4100 (not a multiple of 8:
    zero-padded in 16 bits; seventeen chunks) at a small T < S, causal,
    GQA 2:1: one launch on the "wide" route within the dtype's gate."""
    from repro_torch.kernels import flash_attention as flash_mod
    q, k, v = _qkv(dev, 1, 4, 2, 70, 90, hd, seed=hd, dtype=dtype)
    got = _one_launch_on(flash_mod, "wide",
                         lambda: flash_mod.flash_attention(q, k, v))
    assert got.dtype == dtype and got.shape == (1, 4, 70, hd)
    rtol, atol = FLASH_GATES[dtype]
    torch.testing.assert_close(got.float(), ref.flash_attention_ref(q, k, v),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16,
                                   torch.float32],
                         ids=["f16", "bf16", "f32"])
def test_flash_attention_wide_takes_views_and_unaligned_bases(dev, dtype):
    """TMA and cp.async read 16-byte rows from 16-byte-aligned bases: on
    the wide route, contiguous views that start one element in (hd 320)
    and unaligned views of hd 257 (zero-padded as well) are copied by the
    wrapper, the attention layer's transposed views go through
    ops.flash_attention; each is one "wide" launch within the dtype's
    gate, and the caller's tensors keep their values and strides."""
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ops
    rtol, atol = FLASH_GATES[dtype]
    g = torch.Generator(device=dev).manual_seed(9)
    for hd in (320, 257):
        shapes = ((1, 4, 70, hd), (1, 2, 90, hd), (1, 2, 90, hd))
        q, k, v = (torch.randn(math.prod(s) + 1, generator=g, device=dev)
                   .to(dtype)[1:].view(s) for s in shapes)
        assert q.data_ptr() % 16 and q.is_contiguous()
        kept = [x.clone() for x in (q, k, v)]
        got = _one_launch_on(flash_mod, "wide",
                             lambda: flash_mod.flash_attention(q, k, v))
        for x, y in zip((q, k, v), kept):
            assert torch.equal(x, y)
        torch.testing.assert_close(got.float(),
                                   ref.flash_attention_ref(q, k, v),
                                   rtol=rtol, atol=atol)
    q, k, v = (x.transpose(1, 2).contiguous().transpose(1, 2)
               for x in _qkv(dev, 2, 8, 2, 96, 96, 320, seed=3, dtype=dtype))
    assert not q.is_contiguous()
    strides = [x.stride() for x in (q, k, v)]
    got = _one_launch_on(flash_mod, "wide",
                         lambda: ops.flash_attention(q, k, v))
    assert [x.stride() for x in (q, k, v)] == strides
    torch.testing.assert_close(got.float(), ref.flash_attention_ref(q, k, v),
                               rtol=rtol, atol=atol)


def test_flash_attention_wide_grid_past_65535_blocks(dev):
    # 64-row q tiles x B * H x 2 output chunks = 1 * 300 * 120 * 2 = 72000
    # CTAs on grid.x.
    from repro_torch.kernels import flash_attention as flash_mod
    q, k, v = _qkv(dev, 300, 120, 4, 32, 32, 257, seed=5,
                   dtype=torch.float16)
    got = _one_launch_on(flash_mod, "wide",
                         lambda: flash_mod.flash_attention(q, k, v))
    torch.testing.assert_close(got.float(), ref.flash_attention_ref(q, k, v),
                               rtol=2 ** -11, atol=1e-5)


def test_flash_attention_wide_f32_grid_past_65535_blocks(dev):
    # The f32 kernel's 128-row q tiles: 2 tiles (T = 130) x B * H x 2
    # output chunks = 2 * 150 * 120 * 2 = 72000 CTAs on grid.x.
    from repro_torch.kernels import flash_attention as flash_mod
    q, k, v = _qkv(dev, 150, 120, 4, 130, 130, 257, seed=6,
                   dtype=torch.float32)
    got = _one_launch_on(flash_mod, "wide",
                         lambda: flash_mod.flash_attention(q, k, v))
    torch.testing.assert_close(got, ref.flash_attention_ref(q, k, v),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16,
                                   torch.float32],
                         ids=["f16", "bf16", "f32"])
def test_flash_attention_wide_entries_take_the_callers_chunk_width(dev,
                                                                   dtype):
    """The chunk plan has one owner, flash_attention.wide_plan: the wide
    C entries launch the chunk width they are given (every compiled one,
    160 to 256, is right at hd 320) and refuse any other, leaving the
    output untouched."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as flash_mod
    B, H, KV, T, S, hd = 1, 4, 2, 70, 90, 320
    q, k, v = _qkv(dev, B, H, KV, T, S, hd, seed=4, dtype=dtype)
    want = ref.flash_attention_ref(q, k, v)
    rtol, atol = FLASH_GATES[dtype]
    entry = getattr(_build.lib(), flash_mod._KERNELS[dtype][2])
    assert flash_mod.wide_plan(hd) == (2, 160)
    for cw in (160, 192, 224, 256, 128, 170, 288):
        out = torch.full_like(q, 7.0)
        rc = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   B, H, KV, T, S, hd, hd, cw, 1, hd ** -0.5,
                   _build.stream_of(q))
        torch.cuda.synchronize()
        if cw in (160, 192, 224, 256):
            assert rc == 0
            torch.testing.assert_close(out.float(), want, rtol=rtol,
                                       atol=atol)
        else:
            assert rc != 0 and bool((out == 7.0).all())


@pytest.mark.parametrize("names,hd,route", [
    (("bfloat16", "float32", "float32"), 160, "sm90_f32"),
    (("float16", "bfloat16", "bfloat16"), 160, "sm90_f32"),
    (("float32", "float16", "bfloat16"), 100, "sm90_f32"),
    (("bfloat16", "float16", "float16"), 320, "wide"),
    (("float64", "float64", "float64"), 128, "sm90_f32"),
    (("float64", "float32", "float32"), 13, "sm90_f32"),
    (("float64", "float64", "float64"), 320, "wide"),
], ids=lambda x: "-".join(x) if isinstance(x, tuple) else str(x))
def test_flash_attention_takes_mixed_dtypes_and_f64(dev, names, hd, route):
    """q, k and v not all one of f16, bf16 and f32 are taken in f32 (each
    widened exactly, f64 narrowed): one launch on the f32 route for the
    head_dim, the output in q's dtype (f32 for f64) within one rounding
    of it of the plain version, and the caller's tensors untouched."""
    from repro_torch.kernels import flash_attention as flash_mod
    dts = [getattr(torch, n) for n in names]
    q, k, v = (x.to(d) for x, d in zip(
        _qkv(dev, 1, 8, 2, 200, 300, hd, seed=hd), dts))
    kept = [x.clone() for x in (q, k, v)]
    got = _one_launch_on(flash_mod, route,
                         lambda: flash_mod.flash_attention(q, k, v))
    out = torch.float32 if dts[0] == torch.float64 else dts[0]
    assert got.dtype == out and got.shape == (1, 8, 200, hd)
    for x, y in zip((q, k, v), kept):
        assert x.dtype == y.dtype and torch.equal(x, y)
    rtol, atol = FLASH_GATES[out]
    torch.testing.assert_close(got.float(), ref.flash_attention_ref(q, k, v),
                               rtol=rtol, atol=atol)


def test_flash_attention_counts_each_route(dev):
    """One call on each of the four routes: each counter moves by one,
    and ``launches`` by four."""
    from repro_torch.kernels import flash_attention as flash_mod
    before, total = dict(flash_mod.launches_by_route), flash_mod.launches
    for dtype, hd in ((torch.bfloat16, 64), (torch.float16, 64),
                      (torch.float32, 64), (torch.float16, 300)):
        flash_mod.flash_attention(*_qkv(dev, 1, 4, 2, 64, 64, hd, seed=2,
                                        dtype=dtype))
    torch.cuda.synchronize()
    assert flash_mod.launches == total + 4
    assert flash_mod.launches_by_route == {r: n + 1
                                           for r, n in before.items()}


def test_flash_attention_sm90_f32_takes_strided_views(dev):
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ops
    q, k, v = (x.transpose(1, 2).contiguous().transpose(1, 2)
               for x in _qkv(dev, 2, 8, 2, 96, 96, 160, seed=3))
    assert not q.is_contiguous()
    before = flash_mod.launches_by_route["sm90_f32"]
    got = ops.flash_attention(q, k, v)
    assert flash_mod.launches_by_route["sm90_f32"] == before + 1
    torch.testing.assert_close(got, ref.flash_attention_ref(q, k, v),
                               rtol=2e-5, atol=2e-5)


def test_flash_attention_sm90_f32_copies_unaligned_bases(dev):
    """cp.async reads 16 bytes from 16-byte-aligned addresses: a
    contiguous view that starts 4 bytes in is copied by the wrapper, and
    stays on the sm90_f32 route."""
    from repro_torch.kernels import flash_attention as flash_mod
    shapes = ((1, 4, 70, 64), (1, 2, 90, 64), (1, 2, 90, 64))
    g = torch.Generator(device=dev).manual_seed(9)
    q, k, v = (torch.randn(math.prod(s) + 1, generator=g, device=dev)[1:]
               .view(s) for s in shapes)
    assert q.data_ptr() % 16 and q.is_contiguous()
    before = flash_mod.launches_by_route["sm90_f32"]
    got = flash_mod.flash_attention(q, k, v)
    assert flash_mod.launches_by_route["sm90_f32"] == before + 1
    torch.testing.assert_close(got, ref.flash_attention_ref(q, k, v),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype,hd,route", [
    (torch.float32, 160, "sm90_f32"), (torch.float32, 100, "sm90_f32"),
    (torch.bfloat16, 160, "sm90"), (torch.bfloat16, 100, "sm90"),
    (torch.float16, 160, "sm90_f16"), (torch.float16, 100, "sm90_f16"),
    (torch.float32, 320, "wide"), (torch.float16, 257, "wide")])
def test_flash_attention_keeps_a_nan_row_nan(dev, dtype, hd, route):
    """A NaN in q makes its row NaN, as in the plain version (each kernel
    once wrote such a row as 0: its l is NaN, and only l = 0 means no
    key); rows that see no key stay 0 and every other row matches."""
    from repro_torch.kernels import flash_attention as flash_mod
    q, k, v = _qkv(dev, 1, 4, 2, 200, 150, hd, seed=hd, dtype=dtype)
    q[0, 1, 120, 3] = float("nan")
    before = flash_mod.launches_by_route[route]
    got = flash_mod.flash_attention(q, k, v).float()
    torch.cuda.synchronize()
    assert flash_mod.launches_by_route[route] == before + 1
    want = ref.flash_attention_ref(q, k, v)
    assert want[0, 1, 120].isnan().all() and got[0, 1, 120].isnan().all()
    assert not got[:, :, :50].any()
    keep = torch.ones(200, dtype=torch.bool, device=dev)
    keep[:50] = False
    got[0, 1, 120] = want[0, 1, 120] = 0.0
    rtol, atol = FLASH_GATES[dtype]
    torch.testing.assert_close(got[:, :, keep], want[:, :, keep], rtol=rtol,
                               atol=atol)


_TF32_SPLIT_CHECK = r"""
#include <cuda_runtime.h>
#include <stdint.h>
%s
extern "C" __global__ void split_both(const float* x, uint32_t* rna,
                                      uint32_t* hi, uint32_t* lo, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t r;
  asm("cvt.rna.tf32.f32 %%0, %%1;\n" : "=r"(r) : "f"(x[i]));
  rna[i] = r;
  split(x[i], hi[i], lo[i]);
}
extern "C" int run(const float* x, uint32_t* rna, uint32_t* hi,
                   uint32_t* lo, int n) {
  split_both<<<(n + 255) / 256, 256>>>(x, rna, hi, lo, n);
  return static_cast<int>(cudaDeviceSynchronize());
}
"""


def test_f32_flash_split_rounds_as_cvt_rna(dev, tmp_path):
    """The f32 flash kernel's split() (csrc/flash_attention_f32_sm90.cu),
    compiled on its own beside cvt.rna.tf32.f32 on 2^24 f32 values (many
    binades, ties, +-inf, +-0, the largest finite values, subnormals):
    its integer hi is cvt.rna's result bit for bit for every value but
    NaN, hi + lo is x exactly wherever x and hi are finite, and a NaN x leaves
    lo NaN, so NaN still reaches the products."""
    import ctypes

    from repro_torch.kernels import _build
    text = (_build.SRC_DIR / "flash_attention_f32_sm90.cu").read_text()
    split = re.search(r"__device__ __forceinline__ void split\(.*?\n\}\n",
                      text, re.S).group(0)
    src, so = tmp_path / "split.cu", tmp_path / "split.so"
    src.write_text(_TF32_SPLIT_CHECK % split)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS[:6], "-shared",
                    str(src), "-o", str(so)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    g = torch.Generator(device=dev).manual_seed(0)
    n = 1 << 24
    x = torch.randn(n, generator=g, device=dev) * torch.exp2(
        torch.randint(-60, 60, (n,), generator=g, device=dev).float())
    # Ties (the 13 dropped bits exactly 0x1000), the edges, and NaNs.
    x[:4096] = (x[:4096].view(torch.int32) & ~0x1FFF | 0x1000).view(
        torch.float32)
    edges = [float("inf"), -float("inf"), 0.0, -0.0, 3.4028235e38,
             -3.4028235e38, 3.3e38, 1e-40, -1e-40, 1.5e-45]
    x[4096:4096 + len(edges)] = torch.tensor(edges, device=dev)
    x[5000:5004] = float("nan")
    x.view(torch.int32)[5004] = 0x7FFFFFFF    # the add carries into the sign
    rna, hi, lo = (torch.empty(n, dtype=torch.int32, device=dev)
                   for _ in range(3))
    assert lib.run(*(ctypes.c_void_p(t.data_ptr())
                     for t in (x, rna, hi, lo)), ctypes.c_int(n)) == 0
    nan = x.isnan()
    assert int(nan.sum()) == 5
    assert torch.equal(hi[~nan], rna[~nan])
    hi_f, lo_f = hi.view(torch.float32), lo.view(torch.float32)
    assert lo_f[nan].isnan().all()
    finite = hi_f.isfinite() & x.isfinite()   # 0x7FFFFFFF's hi is -0
    assert int((~hi_f.isfinite() & x.isfinite()).sum()) == 2   # +-FLT_MAX
    assert torch.equal(hi_f[finite] + lo_f[finite], x[finite])


def test_flash_attention_sm90_takes_strided_views(dev):
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ops
    q, k, v = (x.transpose(1, 2).contiguous().transpose(1, 2)
               for x in _qkv(dev, 2, 8, 2, 96, 96, 160, seed=3,
                             dtype=torch.bfloat16))
    assert not q.is_contiguous()
    before = flash_mod.launches_by_route["sm90"]
    got = ops.flash_attention(q, k, v)
    assert flash_mod.launches_by_route["sm90"] == before + 1
    torch.testing.assert_close(got.float(), ref.flash_attention_ref(q, k, v),
                               rtol=2 ** -8, atol=1e-5)


def test_flash_attention_sm90_copies_unaligned_bases(dev):
    """TMA reads from 16-byte-aligned bases: a contiguous view that starts
    2 bytes in is copied by the wrapper, and stays on the sm90 route."""
    from repro_torch.kernels import flash_attention as flash_mod
    shapes = ((1, 4, 70, 64), (1, 2, 90, 64), (1, 2, 90, 64))
    g = torch.Generator(device=dev).manual_seed(9)
    q, k, v = (torch.randn(math.prod(s) + 1, generator=g, device=dev)
               .to(torch.bfloat16)[1:].view(s) for s in shapes)
    assert q.data_ptr() % 16 and q.is_contiguous()
    before = flash_mod.launches_by_route["sm90"]
    got = flash_mod.flash_attention(q, k, v)
    assert flash_mod.launches_by_route["sm90"] == before + 1
    torch.testing.assert_close(got.float(), ref.flash_attention_ref(q, k, v),
                               rtol=2 ** -8, atol=1e-5)


def test_flash_attention_sm90_grid_past_65535_blocks(dev):
    # B * H * 128-row q tiles = 1100 * 60 * 1 = 66000 CTAs on grid.x.
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ops
    q, k, v = _qkv(dev, 1100, 60, 4, 64, 64, 16, seed=5,
                   dtype=torch.bfloat16)
    before = flash_mod.launches_by_route["sm90"]
    got = ops.flash_attention(q, k, v)
    assert flash_mod.launches_by_route["sm90"] == before + 1
    torch.testing.assert_close(got.float(), ref.flash_attention_ref(q, k, v),
                               rtol=2 ** -8, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("H,KV", [(48, 1), (40, 8)],
                         ids=["granite-48-on-1", "llama4-40-on-8"])
def test_flash_attention_at_wide_groupings(dev, H, KV, dtype):
    """granite-34b's 48 query heads on one KV head and llama4-maverick's
    groups of 5, at hd 128 and T = S = 1024, causal: each route against
    the plain version (one bf16 rounding; 2e-5 in f32)."""
    from repro_torch.kernels import flash_attention as flash_mod
    q, k, v = _qkv(dev, 1, H, KV, 1024, 1024, 128, seed=H + KV, dtype=dtype)
    route = "sm90" if dtype == torch.bfloat16 else "sm90_f32"
    before = dict(flash_mod.launches_by_route)
    got = flash_mod.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_mod.launches_by_route == {
        r: n + (r == route) for r, n in before.items()}
    want = ref.flash_attention_ref(q, k, v, causal=True)
    tol = (2 ** -8, 1e-5) if dtype == torch.bfloat16 else (2e-5, 2e-5)
    torch.testing.assert_close(got.float(), want, rtol=tol[0], atol=tol[1])


@pytest.mark.parametrize("E,D,Fd,K,chunk", [
    (128, 2048, 768, 8, None),     # qwen3-moe-30b-a3b: the rule's 2 chunks
    (16, 5120, 8192, 1, 3),        # 16 of llama4-maverick's experts
])
def test_chunked_moe_on_card_matches_whole(dev, monkeypatch, E, D, Fd, K,
                                           chunk):
    """``layers.moe``'s expert products a chunk of experts at a time
    (``F32_CHUNK_BYTES`` left as it is, or set for ``chunk`` experts)
    against one product over all experts, at full expert widths where
    both fit: bf16 weights, f32 activations (the f32 twin, whose
    products widen the weights), within 1e-5 of max|whole| (the same f32
    products, cuBLAS free to order each sum its own way); and bf16
    activations within one bf16 ulp (2^-7) of max|whole|, where an f32
    sum summed in another order may round to the next bf16 value."""
    from repro_torch.models import layers as L
    g = torch.Generator(device=dev).manual_seed(E + K)
    p = {"router": torch.randn(D, E, generator=g, device=dev) * D ** -0.5,
         "wi": (torch.randn(E, D, 2, Fd, generator=g, device=dev)
                * D ** -0.5).to(torch.bfloat16),
         "wo": (torch.randn(E, Fd, D, generator=g, device=dev)
                * Fd ** -0.5).to(torch.bfloat16)}
    x = torch.randn(1, 2048, D, generator=g, device=dev)
    kw = dict(n_experts=E, top_k=K, activation="silu", capacity_factor=1.25)
    per_expert = L.expert_bytes(D, 2, Fd, int(1.25 * K * 2048 / E))
    if chunk is None:
        assert L.F32_CHUNK_BYTES < E * per_expert
    budget = L.F32_CHUNK_BYTES if chunk is None else chunk * per_expert

    def run(xin, nbytes):
        monkeypatch.setattr(L, "F32_CHUNK_BYTES", nbytes)
        return L.moe(xin, p, **kw).float()

    for xin in (x, x.to(torch.bfloat16)):
        whole = run(xin, E * per_expert)
        got = run(xin, budget)
        err = (got - whole).abs().max() / whole.abs().max()
        assert err.item() <= (1e-5 if xin.dtype == torch.float32
                              else 2 ** -7)


def _reduced_lm(name, **kw):
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_arch(name, reduced=True),
                              param_dtype="float32",
                              activation_dtype="float32", **kw)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return cfg, params


@pytest.mark.parametrize("name", ["stablelm-12b", "granite-34b"])
def test_reduced_forward_card_matches_cpu(dev, name):
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.models import model as M
    cfg, params = _reduced_lm(name, attention_impl="flash")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 200))
    want = M.forward(cfg, params, {"tokens": toks})
    on_card = M.tree_map(lambda t: t.to(dev), params)
    before = flash_mod.launches
    got = M.forward(cfg, on_card, {"tokens": toks})
    torch.cuda.synchronize()
    assert flash_mod.launches - before == cfg.n_layers
    rel = (got.cpu() - want).abs().max() / want.abs().max()
    assert rel.item() < 1e-4


def test_reduced_server_tokens_card_match_cpu(dev):
    from repro_torch.serving import BatchedServer, Request
    cfg, params = _reduced_lm("stablelm-12b")

    def run(device):
        rng = np.random.default_rng(5)
        reqs = [Request(i, rng.integers(0, cfg.vocab_size,
                                        int(rng.integers(3, 14))),
                        max_new_tokens=int(rng.integers(2, 9)))
                for i in range(7)]
        server = BatchedServer(cfg, params, slots=3, prompt_len=16,
                               cache_len=48, device=device)
        server.serve(reqs)
        return [r.tokens_out for r in reqs], server.steps

    assert run("cuda") == run("cpu")


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "rwkv6-3b",
                                  "jamba-v0.1-52b"])
def test_reduced_arms_forward_card_matches_cpu(dev, name):
    """MoE, RWKV-6 and Mamba blocks on the card (f32, flash attention
    where the config has attention layers) against the CPU."""
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.models import model as M
    cfg, params = _reduced_lm(name, attention_impl="flash")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 200))
    want = M.forward(cfg, params, {"tokens": toks})
    on_card = M.tree_map(lambda t: t.to(dev), params)
    before = flash_mod.launches
    got = M.forward(cfg, on_card, {"tokens": toks})
    torch.cuda.synchronize()
    n_attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))
    assert flash_mod.launches - before == n_attn
    rel = (got.cpu() - want).abs().max() / want.abs().max()
    assert rel.item() < 1e-4


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "rwkv6-3b",
                                  "jamba-v0.1-52b"])
def test_reduced_arms_server_tokens_card_match_cpu(dev, name):
    from repro_torch.serving import BatchedServer, Request
    cfg, params = _reduced_lm(name)

    def run(device):
        rng = np.random.default_rng(5)
        reqs = [Request(i, rng.integers(0, cfg.vocab_size,
                                        int(rng.integers(3, 14))),
                        max_new_tokens=int(rng.integers(2, 9)))
                for i in range(7)]
        server = BatchedServer(cfg, params, slots=4, prompt_len=16,
                               cache_len=48, device=device)
        server.serve(reqs)
        return [r.tokens_out for r in reqs], server.steps

    assert run("cuda") == run("cpu")


# ---------------------------------------------------------------------------
# The bench matrices on the card (repro_torch.bench).
# ---------------------------------------------------------------------------

def _bench_tiny():
    from repro_torch.bench import kernels as kbench
    return kbench.KernelSpec(workload="heavy_tail", n_archives=2,
                             segments_per_archive=3, repeats=1, seed=5)


def test_kernel_bench_tiny_on_card_matches_cpu(dev):
    from repro_torch.bench import kernels as kbench
    spec = _bench_tiny()
    sc = kbench.KernelScenario(
        name="tiny", group="tiny", run=spec,
        baseline=dataclasses.replace(spec, pipeline="unfused"))
    before = {m.__name__: m.launches
              for m in (interp_mod, agl_mod, rates_mod)}
    got = kbench.run_kernel_scenario(sc, device=dev)
    want = kbench.run_kernel_scenario(sc, device="cpu")
    assert all(m.launches > before[m.__name__]
               for m in (interp_mod, agl_mod, rates_mod))
    diff = "max_abs_diff_vs_baseline"
    assert got["metrics"][diff] <= 1e-5 and want["metrics"][diff] <= 1e-5
    assert {k: v for k, v in got["metrics"].items() if k != diff} == \
        {k: v for k, v in want["metrics"].items() if k != diff}
    # The fused outputs, card against CPU, within PERF.md's card-vs-CPU
    # tolerance (1e-4 + 1e-6 |CPU|; headings as wrapped angles).
    card = kbench._execute(spec, torch.device("cuda"))["outputs"]
    cpu = kbench._execute(spec, torch.device("cpu"))["outputs"]
    for g, w in zip(card, cpu):
        for attr in ("times", "lat", "lon", "alt_msl_m", "alt_agl_m",
                     "vrate_ms", "gspeed_ms", "turn_rad_s"):
            np.testing.assert_allclose(getattr(g, attr), getattr(w, attr),
                                       rtol=1e-6, atol=1e-4, err_msg=attr)
        d = np.angle(np.exp(1j * (g.heading_rad.astype(np.float64)
                                  - w.heading_rad)))
        assert np.abs(d).max(initial=0.0) <= 1e-4


def test_encounter_bench_exact_cell_on_card(dev):
    from repro_torch.bench import encounters as ebench
    sc = next(s for s in ebench.encounter_scenarios()
              if s.name == "enc_exact_tiny_dense_pallas")
    before = screen_mod.launches
    rec = ebench.run_encounter_scenario(sc, device=dev)
    assert screen_mod.launches > before
    assert rec["status"] == "pass", rec["checks"]
    assert rec["metrics"]["candidate_set_equal"] == 1
    assert rec["metrics"]["candidate_values_equal"] == 1
    cpu = ebench.run_encounter_scenario(sc, device="cpu")
    assert rec["metrics"] == cpu["metrics"]


def test_storage_bench_pipeline_cell_on_card(dev):
    from repro_torch.bench import storage as sbench
    run = sbench.StorageSpec(source="store", phase="warm", prefetch=2,
                             consume="pipeline", n_archives=6,
                             segments_per_archive=4, target_points=1024,
                             repeats=1)
    sc = sbench.StorageScenario(
        name="pipeline_small", group="storage_overlap", run=run,
        baseline=dataclasses.replace(run, prefetch=0),
        checks=(sbench.Check("feed_bitwise_equal", "min", 1.0),
                sbench.Check("rebuild_identical", "min", 1.0)))
    before = interp_mod.launches
    rec = sbench.run_storage_scenario(sc, device=dev)
    assert interp_mod.launches > before
    assert rec["status"] == "pass", (rec["error"], rec["checks"])
    cpu = sbench.run_storage_scenario(sc, device="cpu")
    assert rec["metrics"] == cpu["metrics"]


def test_smoke_processes_cell_after_a_kernel_launch(dev):
    from repro_torch.bench import engine, paper
    from repro_torch.runtime import transports
    args = [torch.from_numpy(x).to(dev) for x in _tracks(4, 16, 3, 32, 1)]
    interp_mod.track_interp(*args)
    torch.cuda.synchronize()
    assert torch.cuda.is_initialized()
    # CUDA is live in this process: its processes workers are spawned.
    assert transports._default_start_method() == "spawn"
    sc = next(s for s in paper.smoke_scenarios()
              if s.name == "smoke_processes")
    rec = engine.run_scenario(sc, device=dev)
    assert rec["status"] == "pass", (rec["error"], rec["checks"])
    assert rec["metrics"]["tasks_completed"] == 200
    assert rec["metrics"]["backend"] == "processes"


def test_live_ingested_store_on_card_matches_batch_store(dev, tmp_path):
    """The serving mode's sealed live store, processed on the card, gives
    bitwise the outputs of a batch build of the same feed (the bytes in
    are identical), through all three process kernels."""
    from repro_torch.geometry.aerodromes import synthetic_aerodromes
    from repro_torch.store.writer import build_store
    from repro_torch.tracks.segments import (
        SegmentProcessor, segment_tasks_from_store)
    from repro_torch.tracks.workflow import run_serve
    root = str(tmp_path / "serve")
    summary = run_serve(root, n_files=48, obs_per_file=128,
                        target_points=1024, feed_batch=8, n_workers=2)
    assert summary["files_ingested"] == summary["retained_tracks"] == 48
    batch = str(tmp_path / "batch")
    build_store(os.path.join(root, "feed"), batch, target_points=1024)
    proc = SegmentProcessor(aerodromes=synthetic_aerodromes(n=64))
    before = {m: m.launches for m in (interp_mod, agl_mod, rates_mod)}
    live_out = proc.process_batch(segment_tasks_from_store(
        os.path.join(root, "store_live")))
    assert all(m.launches > n for m, n in before.items())
    batch_out = proc.process_batch(segment_tasks_from_store(batch))
    assert list(live_out) == list(batch_out) and len(live_out) > 1
    for task_id, by_track in batch_out.items():
        assert list(live_out[task_id]) == list(by_track)
        for tid, w in by_track.items():
            g = live_out[task_id][tid]
            assert g.icao24 == w.icao24 and g.airspace == w.airspace
            for attr in ("count", "times", "lat", "lon", "alt_msl_m",
                         "alt_agl_m", "vrate_ms", "gspeed_ms",
                         "heading_rad", "turn_rad_s"):
                assert getattr(g, attr).tobytes() \
                    == getattr(w, attr).tobytes(), (tid, attr)


# ---------------------------------------------------------------------------
# Training on the card (chip_smoke.py phase 10 runs these at full width).
# ---------------------------------------------------------------------------

def _zipf_batches(vocab, n, B=4, T=64, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = np.minimum(rng.zipf(1.5, size=(B, T + 1)),
                          vocab - 1).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return out


@pytest.mark.parametrize("name", ["minicpm-2b", "qwen3-moe-30b-a3b",
                                  "jamba-v0.1-52b", "rwkv6-3b",
                                  "musicgen-medium"])
def test_reduced_train_steps_card_match_cpu(dev, name):
    """Three AdamW steps of the f32 variant of a reduced config from the
    same weights: losses within 1e-4 relative, ||card - CPU|| / ||CPU||
    over the parameters within 1e-4 (an element whose gradient is near
    0 may take Adam's step the other way).  minicpm-2b (dense) and the
    arms chip_smoke.py's phase 10b trains at full width: MoE routing
    with drops (qwen3-moe), Mamba, attention and MoE (jamba), RWKV-6
    (T = 64: two of its 32-token chunks) and musicgen's embeds, looked
    up in the weights' embedding table from the Zipf tokens as
    ``launch/train.py`` feeds them."""
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as O
    cfg, host = _reduced_lm(name)
    tree = M.tree_map(lambda t: t.numpy(), host)
    opt = O.OptimizerConfig(lr=1e-3)
    batches = _zipf_batches(cfg.vocab_size, 3, seed=1)
    if cfg.frontend is not None:
        batches = [{"embeds": host["embed"][torch.from_numpy(b["tokens"])
                                            .long()].numpy(),
                    "labels": b["labels"]} for b in batches]
    runs = {}
    for where in ("cuda", "cpu"):
        params = M.params_from_numpy(cfg, tree, where)
        state = O.init_opt_state(params, opt)
        step = ST.make_train_step(cfg, opt)
        losses = []
        for b in batches:
            _, _, met = step(params, state, {k: torch.from_numpy(v).to(where)
                                             for k, v in b.items()})
            losses.append(met["loss"].item())
        runs[where] = (losses, O.tree_leaves(params))
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-4)
    num = sum(float(((a.detach().cpu().double() - b.detach().double()) ** 2)
                    .sum()) for a, b in zip(runs["cuda"][1], runs["cpu"][1]))
    den = sum(float((b.detach().double() ** 2).sum()) for b in runs["cpu"][1])
    assert (num / den) ** 0.5 <= 1e-4


def test_trainer_resumes_on_card_and_keeps_no_tensor(dev, tmp_path):
    """bf16 reduced minicpm-2b: a run checkpointed at step 2 and resumed
    by a fresh Trainer gives the uninterrupted run's losses (1e-3
    relative, under one bf16 rounding), and a step leaves the card's
    allocated memory as it found it."""
    from repro_torch.configs import get_arch
    from repro_torch.train import optimizer as O
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = get_arch("minicpm-2b", reduced=True)
    batches = _zipf_batches(cfg.vocab_size, 6, seed=2)
    kw = dict(total_steps=6, ckpt_every=2, log_every=100, peak_lr=1e-2,
              warmup_steps=1)

    def trainer(name):
        return Trainer(cfg, O.OptimizerConfig(),
                       TrainerConfig(workdir=str(tmp_path / name), **kw))
    whole = trainer("whole")
    assert whole.device.type == "cuda"
    allocated = []
    for b in batches:
        whole.run(iter([b]), 1)
        allocated.append(torch.cuda.memory_allocated())
    whole.close()
    assert len(set(allocated)) == 1, allocated
    want = [r["loss"] for r in whole.metrics_log]
    first = trainer("resumed")
    first.run(iter(batches[:3]), 3)
    first.close()
    second = trainer("resumed")
    assert second.step == 3
    got = [r["loss"] for r in second.run(iter(batches[3:]), 3)]
    second.close()
    np.testing.assert_allclose(got, want[3:], rtol=1e-3)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_refuses_gradients_on_card(dev, dtype):
    """Both routes raise under grad, as on the CPU, instead of returning
    an output with no grad_fn."""
    from repro_torch.kernels import ops
    q = torch.randn(1, 4, 128, 64, device=dev, dtype=dtype,
                    requires_grad=True)
    k = torch.randn(1, 4, 128, 64, device=dev, dtype=dtype)
    with pytest.raises(NotImplementedError, match="_pallas_call_jvp_rule"):
        ops.flash_attention(q, k, k)
    with torch.no_grad():
        assert ops.flash_attention(q, k, k).shape == q.shape


def test_train_cli_on_card(dev, tmp_path):
    """``python -m repro_torch.launch.train --reduced`` trains on the card
    by default."""
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--steps", "4", "--batch-size", "2", "--seq-len", "32",
         "--ckpt-every", "2", "--workdir", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "over 4 steps" in proc.stdout and "on cuda" in proc.stdout
