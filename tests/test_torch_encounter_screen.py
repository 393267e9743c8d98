"""Port's encounter screen and spatial hash vs the JAX package's.

The same seeded numpy inputs go through ``repro.kernels.encounter_screen``
(Pallas in interpret mode and the jit path, as
tests/test_encounter_screen.py runs them) and through
``repro_torch.kernels.encounter_screen`` on CPU tensors, where the kernel
wrapper runs its plain PyTorch version.  Shapes and tolerances are those
of tests/test_encounter_screen.py: ``hit`` exact, ``t_idx`` exact where
there is a hit, distances within rtol 1e-5 / atol 1e-2 m.  The CUDA
kernel itself is held against the plain version on the card
(tests/test_torch_cuda.py and chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from repro.geometry import gridhash as jgrid
from repro.kernels import encounter_screen as jscreen
from repro_torch.geometry import gridhash as tgrid
from repro_torch.kernels import encounter_screen as tscreen
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

H, V = 926.0, 152.4


def _batch(C, K, T, seed=0, spread=0.02):
    """Clustered random (C, K, T) planes with ragged validity (the
    reference test's generator)."""
    rng = np.random.default_rng(seed)
    lat = (40.0 + rng.normal(0, spread, (C, K, 1))
           + rng.normal(0, 1e-4, (C, K, T))).astype(np.float32)
    lon = (-100.0 + rng.normal(0, spread, (C, K, 1))
           + rng.normal(0, 1e-4, (C, K, T))).astype(np.float32)
    alt = rng.uniform(400, 900, (C, K, 1)).astype(np.float32) \
        + rng.normal(0, 5, (C, K, T)).astype(np.float32)
    val = np.zeros((C, K, T), np.float32)
    for c in range(C):
        for k in range(K):
            s = int(rng.integers(0, max(1, T // 2)))
            e = int(rng.integers(s + 1, T + 1))
            val[c, k, s:e] = 1.0
    return lat, lon, alt, val


def _assert_screen_close(got, want):
    np.testing.assert_array_equal(got["hit"], want["hit"])
    where = want["hit"] > 0.5
    np.testing.assert_array_equal(got["t_idx"][where], want["t_idx"][where])
    for key in ("min_dh", "min_dv"):
        np.testing.assert_allclose(got[key][where], want[key][where],
                                   rtol=1e-5, atol=1e-2)


@pytest.mark.parametrize("backend", ["pallas", "jit"])
@pytest.mark.parametrize("C,K,T", [
    (1, 8, 128), (2, 16, 128), (3, 8, 256), (1, 24, 384), (5, 32, 128),
])
def test_screen_aligned_matches_jax(backend, C, K, T):
    args = _batch(C, K, T, seed=C * 31 + K + T)
    want = jscreen.screen_aligned(*args, h_thresh_m=H, v_thresh_m=V,
                                  backend=backend)
    jscreen.reset_screen_stats()
    tscreen.reset_screen_stats()
    jscreen.screen_aligned(*args, h_thresh_m=H, v_thresh_m=V,
                           backend=backend)
    got = tscreen.screen_aligned(*args, h_thresh_m=H, v_thresh_m=V,
                                 device="cpu")
    _assert_screen_close(got, want)
    assert tscreen.get_screen_stats() == jscreen.get_screen_stats()
    plain = tscreen.screen_aligned(*args, h_thresh_m=H, v_thresh_m=V,
                                   backend="ref", device="cpu")
    for key in got:
        np.testing.assert_array_equal(plain[key], got[key])


@pytest.mark.parametrize("C,K,T", [(1, 8, 128), (2, 24, 256)])
def test_plain_version_matches_torch_oracle(C, K, T):
    lat, lon, alt, val = (torch.from_numpy(x)
                          for x in _batch(C, K, T, seed=K + T))
    got = tscreen.encounter_screen(lat, lon, alt, val, h_m=H, v_m=V)
    for c in range(C):
        want = tref.encounter_screen_ref(lat[c], lon[c], alt[c], val[c],
                                         h_thresh_m=H, v_thresh_m=V)
        hit = want[0] > 0.5
        assert torch.equal(got[0][c], want[0])
        assert torch.equal(got[3][c][hit], want[3][hit])
        for g, w in zip(got[1:3], want[1:3]):
            torch.testing.assert_close(g[c][hit], w[hit], rtol=1e-5,
                                       atol=1e-2)


def test_lower_triangle_and_no_hit_hold_reference_constants():
    args = _batch(2, 16, 256, seed=9)
    args[3][:, 12:] = 0.0                   # four rows never valid
    got = tscreen.screen_aligned(*args, h_thresh_m=H, v_thresh_m=V,
                                 device="cpu")
    want = jscreen.screen_aligned(*args, h_thresh_m=H, v_thresh_m=V,
                                  backend="pallas")
    miss = want["hit"] < 0.5
    assert miss[:, np.tril_indices(16)[0], np.tril_indices(16)[1]].all()
    assert miss[:, 12:, :].all() and miss[:, :, 12:].all()
    for key, fill in (("hit", 0.0), ("min_dh", 1e30), ("min_dv", 1e30),
                      ("t_idx", 0.0)):
        np.testing.assert_array_equal(got[key][miss], want[key][miss])
        assert (got[key][miss] == np.float32(fill)).all()


def _trails(mod, n, seed=0, spread=0.01):
    """n clustered single-segment rows on a shared 15 s grid, as the
    given package's ScreenRows."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        r = np.random.default_rng(seed * 1000 + i)
        t0 = float(rng.integers(0, 40)) * 15.0
        la = 40.0 + float(rng.normal(0, spread))
        lo = -100.0 + float(rng.normal(0, spread))
        al = float(rng.uniform(400, 700))
        rows.append(mod.ScreenRow(
            row_id=f"a{i:04d}#s000", group=f"a{i:04d}", t0=t0,
            lat=(la + np.cumsum(r.normal(0, 1e-4, 8))).astype(np.float32),
            lon=(lo + np.cumsum(r.normal(0, 1e-4, 8))).astype(np.float32),
            alt=(al + r.normal(0, 3, 8)).astype(np.float32), dt_s=15.0))
    return rows


@pytest.mark.parametrize("cell_t_s", [3600.0, 300.0])
def test_grid_and_brute_force_match_jax(cell_t_s):
    jrows, trows = _trails(jscreen, 40, seed=3), _trails(tscreen, 40, seed=3)
    jcfg = jscreen.ScreenConfig(dt_s=15.0, backend="jit")
    tcfg = tscreen.ScreenConfig(dt_s=15.0, device="cpu")
    jgrid_spec = jgrid.GridSpec(cell_deg=0.25, cell_t_s=cell_t_s)
    tgrid_spec = tgrid.GridSpec(cell_deg=0.25, cell_t_s=cell_t_s)
    jscreen.reset_screen_stats()
    tscreen.reset_screen_stats()
    want, wstats = jscreen.screen_rows_grid(jrows, grid=jgrid_spec,
                                            config=jcfg)
    got, gstats = tscreen.screen_rows_grid(trows, grid=tgrid_spec,
                                           config=tcfg)
    assert want and gstats == wstats
    assert tscreen.get_screen_stats() == jscreen.get_screen_stats()
    assert [(c["a"], c["b"], c["t_s"]) for c in got] == \
        [(c["a"], c["b"], c["t_s"]) for c in want]
    for g, w in zip(got, want):
        assert g["h_m"] == pytest.approx(w["h_m"], abs=1e-2)
        assert g["v_m"] == pytest.approx(w["v_m"], abs=1e-2)
    brute = tscreen.brute_force_screen(trows, config=tcfg)
    assert brute == jscreen.brute_force_screen(jrows, config=jcfg)
    assert [(c["a"], c["b"], c["t_s"]) for c in got] == \
        [(c["a"], c["b"], c["t_s"]) for c in brute]


def test_empty_and_singleton_cells_skip_kernel():
    a = _trails(tscreen, 1)[0]
    tscreen.reset_screen_stats()
    cands, stats = tscreen.screen_cells(
        {(0, 1, 160, 320): [a], (0, 1, 160, 321): []},
        config=tscreen.ScreenConfig(dt_s=15.0, device="cpu"))
    assert cands == []
    assert stats["cells_skipped"] == 2 and stats["cells_screened"] == 0
    assert tscreen.get_screen_stats()["kernel_calls"] == 0


def test_screen_config_defaults_to_the_card():
    if torch.cuda.device_count():
        pytest.skip("a card is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tscreen.ScreenConfig()
    assert tscreen.ScreenConfig(device="cpu").device == "cpu"
    with pytest.raises(ValueError, match="unknown screen backend"):
        tscreen.ScreenConfig(backend="pallas", device="cpu")


def _samples(seed, n=200):
    rng = np.random.default_rng(seed)
    times = np.sort(rng.uniform(0, 7200, n))
    lat = rng.uniform(-89, 89, n) if seed % 2 else \
        40 + np.cumsum(rng.normal(0, 0.05, n))
    lon = rng.uniform(-180, 180, n) if seed % 2 else \
        179.5 + np.cumsum(rng.normal(0, 0.05, n))
    alt = rng.uniform(-100, 12000, n)
    return times, lat, lon, alt


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("cell_deg", [0.25, 1.0])
def test_gridhash_matches_jax(seed, cell_deg):
    times, lat, lon, alt = _samples(seed)
    jspec = jgrid.GridSpec(cell_deg=cell_deg)
    tspec = tgrid.GridSpec(cell_deg=cell_deg)
    assert tgrid.cells_for_samples(times, lat, lon, alt, spec=tspec,
                                   h_pad_m=926.0, v_pad_m=152.4) == \
        jgrid.cells_for_samples(times, lat, lon, alt, spec=jspec,
                                h_pad_m=926.0, v_pad_m=152.4)
    rows = []
    for k in range(6):
        t, la, lo, al = _samples(seed * 10 + k, n=40)
        rows.append((f"r{k}", t, la, lo, al))
    assert tgrid.bin_samples(rows, spec=tspec, h_pad_m=5000.0,
                             v_pad_m=300.0) == \
        jgrid.bin_samples(rows, spec=jspec, h_pad_m=5000.0, v_pad_m=300.0)


# ---------------------------------------------------------------------------
# the CUDA kernel's decomposition: plan rule and time-strip emulation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T", [128, 1024, 4608])
def test_plan_packs_the_workflow_launch_into_the_small_regime(T):
    p = tscreen.plan(1, 8, T, 132)
    assert p.regime == "small"
    assert p.strips == p.block_strips * p.warps_per_unit
    assert p.warps_per_unit in (1, 2, 4, 8)


def test_plan_needs_no_strips_for_many_cells():
    p = tscreen.plan(66_000, 8, 128, 132)
    assert p.regime == "small" and p.strips == 1 and p.block_strips == 1


@pytest.mark.parametrize("n_sm", [132, 114])
def test_plan_fills_the_card_at_large_k(n_sm):
    p = tscreen.plan(4, 240, 4608, n_sm)
    assert p.regime == "large" and p.warps_per_unit == 1
    assert p.blocks >= 2 * n_sm
    assert p.blocks == 4 * 36 * p.strips        # live tiles only (8 x 8 -> 36)


@pytest.mark.parametrize("K", [8, 16, 24, 32, 40, 64, 240])
@pytest.mark.parametrize("C,T", [(1, 128), (1, 4608), (4, 1024), (300, 256)])
def test_plan_strips_never_exceed_t_over_32(C, K, T):
    p = tscreen.plan(C, K, T, 132)
    assert 1 <= p.strips <= T // 32
    assert p.regime == ("small" if K <= 24 else "large")


def _lexicographic_merge(parts):
    """Fold strip partials (hit, min_dh, min_dv, t_idx) as the kernel
    does: OR, min, and the lexicographic minimum of (min_dh, t_idx)."""
    hit, mdh, mdv, tix = parts[0]
    for h2, d2, v2, t2 in parts[1:]:
        take = (d2 < mdh) | ((d2 == mdh) & (t2 < tix))
        hit = torch.maximum(hit, h2)
        mdh = torch.where(take, d2, mdh)
        tix = torch.where(take, t2, tix)
        mdv = torch.minimum(mdv, v2)
    return hit, mdh, mdv, tix


def _emulate_kernel(lat, lon, alt, val, strips, *, reverse=False):
    """The kernel's decomposition in plain PyTorch: every pair walks only
    its joint window [max(first_i, first_j), min(last_i, last_j)] (first
    and last nonzero val), cut into ``strips`` interleaved strips of
    32-sample chunks; the plain version runs on each (pair, strip) and
    the strips fold lexicographically."""
    C, K, T = lat.shape
    t = torch.arange(T)
    nz = val != 0
    first = torch.where(nz, t, T).amin(-1)
    last = torch.where(nz, t, -1).amax(-1)
    ii, jj = torch.triu_indices(K, K, 1)
    P = ii.numel()
    lo = torch.maximum(first[:, ii], first[:, jj])[..., None]
    hi = torch.minimum(last[:, ii], last[:, jj])[..., None]
    window = ((t >= lo) & (t <= hi)).reshape(C * P, 1, T)

    def pairs(x):
        return torch.stack([x[:, ii], x[:, jj]], dim=2).reshape(C * P, 2, T)

    parts = []
    for s in range(strips):
        in_strip = ((t // 32) % strips == s)[None, None, :]
        res = tscreen._screen_batch_plain(
            pairs(lat), pairs(lon), pairs(alt),
            pairs(val) * (window & in_strip), h_m=H, v_m=V)
        parts.append([r[:, 0, 1].reshape(C, P) for r in res])
    if reverse:
        parts.reverse()
    merged = _lexicographic_merge(parts)
    out = [torch.zeros((C, K, K)), torch.full((C, K, K), 1e30),
           torch.full((C, K, K), 1e30), torch.zeros((C, K, K))]
    for o, m in zip(out, merged):
        o[:, ii, jj] = m
    return tuple(out)


def _kernel_cases(case):
    """Seeded (C, K, T) planes for the decomposition tests."""
    rng = np.random.default_rng(sum(map(ord, case)))
    if case == "random":
        return _batch(3, 8, 384, seed=21)
    if case == "ties":
        # Stationary rows: each pair's dh is the same at every jointly
        # valid sample, so the minimum ties across strips and t_idx must
        # be the pair's first jointly valid sample.
        C, K, T = 2, 8, 512
        lat = np.broadcast_to(40.0 + rng.normal(0, 0.002, (C, K, 1)),
                              (C, K, T)).astype(np.float32).copy()
        lon = np.broadcast_to(-100.0 + rng.normal(0, 0.002, (C, K, 1)),
                              (C, K, T)).astype(np.float32).copy()
        alt = np.broadcast_to(rng.uniform(500, 560, (C, K, 1)),
                              (C, K, T)).astype(np.float32).copy()
        s = rng.integers(0, T // 2, (C, K, 1))
        e = rng.integers(T // 2, T, (C, K, 1))
        val = ((np.arange(T) >= s) & (np.arange(T) < e)).astype(np.float32)
        return lat, lon, alt, val
    if case == "holes":
        lat, lon, alt, val = _batch(2, 16, 384, seed=22, spread=0.004)
        val[rng.random(val.shape) < 0.3] = 0.0   # holes inside the spans
        return lat, lon, alt, val
    if case == "empty":
        # Row k is valid only on its own slot of the grid: no two rows
        # are ever jointly valid, in any cell.
        lat, lon, alt, _ = _batch(2, 8, 256, seed=23, spread=0.0)
        val = np.zeros_like(lat)
        for k in range(8):
            val[:, k, k * 32:(k + 1) * 32] = 1.0
        return lat, lon, alt, val
    raise ValueError(case)


@pytest.mark.parametrize("strips", [1, 2, 3, 8])
@pytest.mark.parametrize("case", ["random", "ties", "holes", "empty"])
def test_strip_decomposition_is_bitwise_the_plain_version(case, strips):
    planes = _kernel_cases(case)
    args = [torch.from_numpy(np.ascontiguousarray(x)) for x in planes]
    want = tscreen._screen_batch_plain(*args, h_m=H, v_m=V)
    for reverse in (False, True):           # the merge is order free
        got = _emulate_kernel(*args, strips, reverse=reverse)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    hit = want[0] > 0.5
    if case == "empty":
        assert not hit.any()
    else:
        assert hit.any()
    if case == "ties":
        t = torch.arange(args[3].shape[-1])
        first = torch.where(args[3] != 0, t, 10**6).amin(-1)
        joint = torch.maximum(first[:, :, None], first[:, None, :])
        assert torch.equal(want[3][hit], joint[hit].float())
    jax_res = jscreen.screen_aligned(*planes, h_thresh_m=H, v_thresh_m=V,
                                     backend="jit")
    _assert_screen_close({k: v.numpy() for k, v in zip(
        ("hit", "min_dh", "min_dv", "t_idx"), got)}, jax_res)


def test_kernel_wrapper_counts_launch_shapes_only_on_the_card():
    tscreen.launches_by_shape.clear()
    before = tscreen.launches
    args = [torch.from_numpy(x) for x in _batch(1, 8, 128, seed=4)]
    got = tscreen.encounter_screen(*args, h_m=H, v_m=V)
    assert len(got) == 4 and all(g.shape == (1, 8, 8) for g in got)
    assert tscreen.launches == before and tscreen.launches_by_shape == {}
