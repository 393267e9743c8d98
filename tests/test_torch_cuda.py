"""The port's CUDA kernels against their plain versions, and the LM
path between card and CPU, on the card.

Marked ``cuda``: each test skips when no CUDA device is present, so on
a CPU-only machine they count as skipped.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX (the card's machine has none); the plain
versions were checked against JAX in tests/test_torch_kernels.py.
"""

import json
import math
import os
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


SM90_HEAD_DIMS = (24, 40, 64, 128, 160, 192)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("T,S", [(200, 200), (130, 333), (300, 111)],
                         ids=["T=S", "T<S", "T>S"])
@pytest.mark.parametrize("hd", SM90_HEAD_DIMS)
def test_flash_attention_sm90_route(dev, hd, T, S, causal):
    """bf16 goes through the tensor-core kernel at every head_dim of the
    configs and the JAX tests, with T = S, T < S (chunked prefill) and
    T > S (rows with no key exactly 0), S never a multiple of the 64-key
    tile, causal and full; each output within one bf16 rounding of the
    plain f32 output."""
    from repro_torch.kernels import flash_attention as flash_mod
    q, k, v = _qkv(dev, 2, 8, 2, T, S, hd, seed=hd + T + S,
                   dtype=torch.bfloat16)
    before = dict(flash_mod.launches_by_route)
    got = flash_mod.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_mod.launches_by_route == {
        "sm90": before["sm90"] + 1, "cuda_core": before["cuda_core"]}
    assert got.dtype == torch.bfloat16
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want, rtol=2 ** -8, atol=1e-5)
    if causal and T > S:
        assert not got[:, :, :T - S].any()


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("T,S", [(200, 200), (130, 333), (300, 111)],
                         ids=["T=S", "T<S", "T>S"])
@pytest.mark.parametrize("hd", (12, 100))
def test_flash_attention_cuda_core_bf16_route(dev, hd, T, S, causal):
    """bf16 with a head_dim that is not a multiple of 8 (TMA's 16-byte
    row stride) stays on the CUDA-core kernel's bf16 entry, held to the
    same one-bf16-rounding gate."""
    from repro_torch.kernels import flash_attention as flash_mod
    q, k, v = _qkv(dev, 2, 8, 2, T, S, hd, seed=hd + T + S,
                   dtype=torch.bfloat16)
    before = dict(flash_mod.launches_by_route)
    got = flash_mod.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_mod.launches_by_route == {
        "sm90": before["sm90"], "cuda_core": before["cuda_core"] + 1}
    assert got.dtype == torch.bfloat16
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want, rtol=2 ** -8, atol=1e-5)
    if causal and T > S:
        assert not got[:, :, :T - S].any()


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
