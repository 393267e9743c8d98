"""How track_interp and dynamic_rates split a launch, and their plain
versions against the JAX package at the shapes that drive each path of
the CUDA kernels (ragged widths, decreasing queries, short tracks).

``plan`` is plain Python, so its fixed rule is checked here on the CPU;
the kernels themselves are held bitwise against the plain versions on
the card (tests/test_torch_cuda.py, chip_smoke.py phase 2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import dynamic_rates as rates_mod
from repro_torch.kernels import ops as tops
from repro_torch.kernels import track_interp as interp_mod

torch.set_num_threads(1)


@pytest.mark.parametrize("B,N,C,M,want", [
    # The process phase's buckets: 8, 4, 2 and 1 rows a block, each
    # thread with 48 bytes to restage its output.
    (1024, 128, 3, 128, ("shared", 8, 32, 128, 8 * 2048 + 48 * 256, True)),
    (1024, 128, 3, 256, ("shared", 4, 64, 256, 4 * 2048 + 48 * 256, True)),
    (1024, 128, 3, 512, ("shared", 2, 128, 512, 2 * 2048 + 48 * 256, True)),
    (1024, 128, 3, 1024, ("shared", 1, 256, 1024, 2048 + 48 * 256, True)),
    # The workflows' few-row launches: one block.
    (1, 128, 3, 1024, ("shared", 1, 256, 1, 2048 + 48 * 256, True)),
    (3, 256, 3, 128, ("shared", 8, 32, 1, 8 * 4096 + 48 * 256, True)),
    # Wide rows: 48 KB caps the rows a block takes.
    (10, 1024, 3, 128, ("shared", 3, 32, 4, 3 * 16384 + 48 * 96, True)),
    # The longest rows: one a block, past 48 KB, or values gathered.
    (3, 12288, 3, 1024, ("shared", 1, 256, 3, 196608 + 48 * 256, True)),
    (3, 12288, 5, 1024, ("gather", 1, 256, 3, 49152, True)),
    (3, 4096, 14, 64, ("gather", 3, 32, 1, 3 * 16384, True)),
    # Ragged widths take the scalar path (no restaging); row bytes round
    # up to 16; a thread loops past M = 1024.
    (5, 100, 3, 257, ("shared", 2, 96, 3, 2 * 1600, False)),
    (5, 101, 2, 1024, ("shared", 1, 256, 5, 1216, True)),
    (5, 300, 3, 2048, ("shared", 1, 256, 5, 4800 + 48 * 256, True)),
    (70_000, 8, 3, 16, ("shared", 8, 32, 8750, 8 * 128 + 48 * 256, True)),
])
def test_interp_plan(B, N, C, M, want):
    assert tuple(interp_mod.plan(B, N, C, M)) == want


def test_interp_plan_misaligned_bases_take_scalar_path():
    assert not interp_mod.plan(8, 128, 3, 256, aligned=False).vec
    assert interp_mod.plan(8, 128, 3, 256, aligned=True).vec


@pytest.mark.parametrize("B,M,want", [
    (1024, 128, (8, 32, 128, True)),
    (1024, 256, (4, 64, 256, True)),
    (1024, 512, (2, 128, 512, True)),
    (1024, 1024, (1, 256, 1024, True)),
    (1, 1024, (1, 256, 1, True)),
    (3, 4096, (1, 256, 3, True)),
    (70, 16, (8, 32, 9, True)),
    (6, 257, (2, 96, 3, False)),
    (6, 33, (8, 32, 1, False)),
])
def test_rates_plan(B, M, want):
    assert tuple(rates_mod.plan(B, M)) == want


def test_plans_cover_every_group_once():
    """Each row's M / 4 groups of 4 are covered once by its threads,
    rows never straddle a warp, and both kernels split a row alike."""
    for M in range(1, 2200, 13):
        p = rates_mod.plan(100, M)
        assert p.per_row % 32 == 0 and p.rows * p.per_row <= 256
        groups = -(-M // 4)
        covered = sorted(g0 + t for g0 in range(0, groups, p.per_row)
                         for t in range(p.per_row) if g0 + t < groups)
        assert covered == list(range(groups))
        assert p.per_row - 32 < max(groups, 32)
        i = interp_mod.plan(100, 128, 3, M)
        assert (i.rows, i.per_row) == (p.rows, p.per_row)
    assert not rates_mod.plan(8, 256, aligned=False).vec


def _tracks(B, N, C, M, seed):
    rng = np.random.default_rng(seed)
    t_in = np.sort(rng.uniform(0, 900, (B, N)), axis=1).astype(np.float32)
    count = rng.integers(2, N + 1, size=B).astype(np.int32)
    for b in range(B):
        c = count[b]
        t_in[b, c:] = t_in[b, c - 1] + np.arange(1, N - c + 1)
    v_in = rng.normal(size=(B, C, N)).astype(np.float32)
    lo = t_in[:, :1] - 50
    hi = t_in[np.arange(B), count - 1][:, None] + 50
    t_out = (lo + (hi - lo) * np.linspace(0, 1, M)[None, :]).astype(
        np.float32)
    return t_in, v_in, count, t_out


@pytest.mark.parametrize("M", [130, 255])
@pytest.mark.parametrize("order", ["increasing", "decreasing"])
def test_track_interp_plain_matches_jax_ragged_and_ordered(M, order):
    t_in, v_in, count, t_out = _tracks(3, 100, 3, M, seed=M)
    if order == "decreasing":
        t_out = t_out[:, ::-1].copy()
    got = tops.track_interp(t_in, v_in, count, t_out).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jops.track_interp(t_in, v_in, count, t_out)),
        rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        got, np.asarray(jref.track_interp_ref(t_in, v_in, count, t_out)),
        rtol=1e-5, atol=1e-4)
    # Reversing the queries reverses the output, query for query.
    rev = tops.track_interp(t_in, v_in, count, t_out[:, ::-1].copy())
    assert np.array_equal(rev.numpy()[:, ::-1], got)


def _eastward(B, M, count, seed):
    rng = np.random.default_rng(seed)
    v = np.zeros((B, 3, M), np.float32)
    v[:, 0] = 40 + np.cumsum(rng.normal(0, 1e-4, (B, M)), axis=1)
    v[:, 1] = -100 + np.cumsum(rng.uniform(5e-4, 2e-3, (B, M)), axis=1)
    v[:, 2] = 1000 + np.cumsum(rng.normal(0, 2, (B, M)), axis=1)
    return v, np.full(B, count, np.int32)


@pytest.mark.parametrize("count", [0, 1, 2])
@pytest.mark.parametrize("M", [16, 130])
def test_dynamic_rates_plain_matches_jax_short_tracks(count, M):
    v, c = _eastward(2, M, count, seed=count * 3 + M)
    got = tops.dynamic_rates(v, c, 1.0).numpy()
    for want in (jops.dynamic_rates(v, c, 1.0),
                 jref.dynamic_rates_ref(jnp.asarray(v), jnp.asarray(c), 1.0)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                                   atol=1e-3)
    assert not got[:, :, count:].any()
    if count == 1:
        assert not got.any()      # one point: no motion, heading 0


@pytest.mark.parametrize("M", [33, 130, 255])
def test_dynamic_rates_plain_matches_jax_ragged_width(M):
    v, c = _eastward(3, M, M, seed=M)
    c[1] = M // 2
    got = tops.dynamic_rates(v, c, 1.0).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jops.dynamic_rates(v, c, 1.0)), rtol=1e-4, atol=1e-3)


def test_plain_versions_launch_nothing():
    """On CPU tensors the wrappers run the plain versions and count no
    launch, shape or plan."""
    before = (interp_mod.launches, dict(interp_mod.launches_by_shape),
              rates_mod.launches, dict(rates_mod.launches_by_shape))
    t_in, v_in, count, t_out = (torch.from_numpy(x)
                                for x in _tracks(2, 16, 3, 8, seed=1))
    interp_mod.track_interp(t_in, v_in, count, t_out)
    v, c = _eastward(2, 8, 8, seed=1)
    rates_mod.dynamic_rates(torch.from_numpy(v), torch.from_numpy(c), 1.0)
    assert before == (interp_mod.launches, dict(interp_mod.launches_by_shape),
                      rates_mod.launches, dict(rates_mod.launches_by_shape))


def test_c_entry_points_match_their_ctypes_signatures():
    """Every extern "C" entry point under csrc/ takes as many arguments
    as _build.SIGNATURES binds, pointers as c_void_p, ints as c_int and
    floats as c_float: a mismatch shows only on the card otherwise."""
    import ctypes
    import re

    from repro_torch.kernels import _build
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float,
             "long long": ctypes.c_longlong}
    found = {}
    for src in _build._sources():
        text = src.read_text()
        for name, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                     text):
            types = []
            for arg in args.split(","):
                decl = " ".join(arg.split()[:-1])
                types.append(ctypes.c_void_p if "*" in arg
                             else kinds[decl.replace("const ", "")])
            found[name] = tuple(types)
    assert found == {k: tuple(v) for k, v in _build.SIGNATURES.items()}
