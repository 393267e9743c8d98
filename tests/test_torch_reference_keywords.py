"""The reference's keywords on the port's entry points.

``ops.track_interp(block_m=)``, ``ops.agl_lookup(oracle_rows=)``,
``ops.flash_attention(block_q=, block_k=)``,
``encounter_screen.screen_aligned(interpret=)``,
``segment_pipeline.process_segments(agl_oracle=, interpret=, donate=)``
and ``Trainer.remesh(new_mesh=)`` take the JAX package's keywords with
its defaults.  On the CPU each call with values other than the defaults
returns bitwise what the call without them returns, and agrees with the
reference called with the same keywords at the parity tests'
tolerances (tests/test_torch_kernels.py,
tests/test_torch_flash_attention.py, tests/test_torch_encounter_screen.py,
tests/test_torch_segment_pipeline.py).  Bad values raise ``ValueError``;
``use_pallas`` raises ``TypeError`` naming ``use_kernels``.
"""

import numpy as np
import pytest
import torch

from repro.kernels import encounter_screen as jscreen
from repro.kernels import ops as jops
from repro.kernels import segment_pipeline as jpipe
from repro_torch.configs import get_arch
from repro_torch.kernels import encounter_screen as tscreen
from repro_torch.kernels import ops as tops
from repro_torch.kernels import segment_pipeline as tpipe
from repro_torch.train import optimizer as O
from repro_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

GRID = (0.0, 26.0, 0.0, 59.0, 8.0)
H_M, V_M = 926.0, 152.4


def _tracks(B=3, N=100, C=3, M=257, seed=0):
    rng = np.random.default_rng(seed)
    t_in = np.sort(rng.uniform(0, 900, (B, N)), axis=1).astype(np.float32)
    count = rng.integers(2, N + 1, size=B).astype(np.int32)
    for b in range(B):
        c = count[b]
        t_in[b, c:] = t_in[b, c - 1] + np.arange(1, N - c + 1)
    v_in = rng.normal(size=(B, C, N)).astype(np.float32)
    t_out = rng.uniform(-100, 1000, (B, M)).astype(np.float32)
    return t_in, v_in, count, t_out


def _agl(B=4, M=300, H=200, W=400, seed=1):
    rng = np.random.default_rng(seed)
    dem = rng.uniform(0, 3000, (H, W)).astype(np.float32)
    fi = rng.uniform(2, 100, (B, M)).astype(np.float32)
    fj = rng.uniform(2, 200, (B, M)).astype(np.float32)
    alt = rng.uniform(0, 4000, (B, M)).astype(np.float32)
    return dem, fi, fj, alt


def _qkv(dtype, B=1, H=4, KV=2, T=200, S=300, hd=64, seed=2):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dtype)
            for s in ((B, H, T, hd), (B, KV, S, hd), (B, KV, S, hd))]


def _screen_batch(C=2, K=16, T=256, seed=3):
    rng = np.random.default_rng(seed)
    lat = (40.0 + rng.normal(0, 0.02, (C, K, 1))
           + rng.normal(0, 1e-4, (C, K, T))).astype(np.float32)
    lon = (-100.0 + rng.normal(0, 0.02, (C, K, 1))
           + rng.normal(0, 1e-4, (C, K, T))).astype(np.float32)
    alt = (rng.uniform(400, 900, (C, K, 1))
           + rng.normal(0, 5, (C, K, T))).astype(np.float32)
    val = np.zeros((C, K, T), np.float32)
    for c in range(C):
        for k in range(K):
            s = int(rng.integers(0, T // 2))
            val[c, k, s:int(rng.integers(s + 1, T + 1))] = 1.0
    return lat, lon, alt, val


def _bucket(B=3, K=128, seed=4):
    """One bucket of B tracks of at most K knots drifting east, and a
    DEM: the inputs of tests/test_torch_segment_pipeline.py."""
    rng = np.random.default_rng(seed)
    dem = rng.uniform(0, 2500, (209, 473)).astype(np.float32)
    t_in = np.zeros((B, K), np.float32)
    v_in = np.zeros((B, 3, K), np.float32)
    count_in = np.zeros((B,), np.int32)
    t_out = np.zeros((B, K), np.float32)
    count_out = np.zeros((B,), np.int32)
    for b in range(B):
        n, m = int(rng.integers(10, K + 1)), int(rng.integers(2, K + 1))
        t = np.cumsum(rng.uniform(1.0, 6.0, n))
        t_in[b, :n] = t - t[0]
        t_in[b, n:] = t_in[b, n - 1] + np.arange(1, K - n + 1)
        v_in[b, 0, :n] = rng.uniform(1, 3) + np.cumsum(rng.normal(0, 2e-4, n))
        v_in[b, 1, :n] = rng.uniform(2, 20) + np.cumsum(
            rng.uniform(5e-4, 2e-3, n))
        v_in[b, 2, :n] = 1500 + np.cumsum(rng.normal(0, 2, n))
        v_in[b, :, n:] = v_in[b, :, n - 1:n]
        count_in[b] = n
        t_out[b, :m] = np.arange(m)
        t_out[b, m:] = t_out[b, m - 1]
        count_out[b] = m
    return dem, (t_in, v_in, count_in, t_out, count_out)


@pytest.mark.parametrize("backend", ["kernel", "ref"])
def test_track_interp_block_m_changes_no_output(backend):
    args = _tracks()
    plain = tops.track_interp(*args, backend=backend)
    got = tops.track_interp(*args, backend=backend, block_m=128)
    assert torch.equal(got, plain)
    want = np.asarray(jops.track_interp(*args, block_m=128))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("backend", ["kernel", "ref"])
def test_agl_lookup_oracle_rows_changes_no_output(backend):
    dem, fi, fj, alt = _agl()
    every = np.ones(fi.shape[0], bool)
    plain = tops.agl_lookup(dem, fi, fj, alt, backend=backend)
    for rows in (every, torch.from_numpy(every), every.tolist()):
        got = tops.agl_lookup(dem, fi, fj, alt, backend=backend,
                              oracle_rows=rows)
        assert torch.equal(got, plain)
    want = np.asarray(jops.agl_lookup(dem, fi, fj, alt, oracle_rows=every))
    np.testing.assert_allclose(plain.numpy(), want, rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,S", [(200, 300), (256, 256)])
def test_flash_attention_blocks_change_no_output(dtype, T, S):
    q, k, v = _qkv(dtype, T=T, S=S)
    plain = tops.flash_attention(q, k, v)
    got = tops.flash_attention(q, k, v, block_q=64, block_k=64)
    assert torch.equal(got, plain)
    if dtype == torch.float32:
        want = np.asarray(jops.flash_attention(
            *(x.numpy() for x in (q, k, v)), block_q=64, block_k=64))
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_flash_attention_rows_with_no_key_are_zero_at_any_block():
    """Causal with T > S: the first T - S rows see no key.  The port
    writes them as 0 whatever the blocks; the reference's value there
    depends on its blocks."""
    q, k, v = _qkv(torch.float32, T=300, S=100)
    for bq, bk in ((128, 128), (64, 64), (32, 256)):
        out = tops.flash_attention(q, k, v, block_q=bq, block_k=bk)
        assert not out[:, :, :200].any()


@pytest.mark.parametrize("backend", ["kernel", "ref"])
def test_screen_aligned_interpret_changes_no_output(backend):
    args = _screen_batch()
    kw = dict(h_thresh_m=H_M, v_thresh_m=V_M, backend=backend, device="cpu")
    plain = tscreen.screen_aligned(*args, **kw)
    for interpret in (False, True, None):
        got = tscreen.screen_aligned(*args, interpret=interpret, **kw)
        for key in plain:
            np.testing.assert_array_equal(got[key], plain[key])
    want = jscreen.screen_aligned(*args, h_thresh_m=H_M, v_thresh_m=V_M,
                                  backend="pallas", interpret=True)
    np.testing.assert_array_equal(plain["hit"], want["hit"])
    hit = want["hit"] > 0.5
    np.testing.assert_array_equal(plain["t_idx"][hit], want["t_idx"][hit])
    for key in ("min_dh", "min_dv"):
        np.testing.assert_allclose(plain[key][hit], want[key][hit],
                                   rtol=1e-5, atol=1e-2)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_process_segments_reference_keywords_change_no_output(use_kernels):
    dem, args = _bucket()
    dem_t = torch.from_numpy(dem)
    plain = tpipe.process_segments(dem_t, *args, grid=GRID,
                                   use_kernels=use_kernels)
    got = tpipe.process_segments(dem_t, *args, grid=GRID,
                                 use_kernels=use_kernels, agl_oracle=True,
                                 interpret=False, donate=True)
    assert torch.equal(got, plain)
    want = jpipe.process_segments(dem, *args, grid=GRID,
                                  use_pallas=use_kernels, agl_oracle=True,
                                  interpret=True, donate=False)
    tol = {"vrate": 0.5, "gspeed": 0.5, "heading": 0.1, "turn": 0.5}
    for name, plane in zip(tpipe.FIELDS, got.numpy()):
        np.testing.assert_allclose(plane, np.asarray(want[name]),
                                   rtol=1e-4, atol=tol.get(name, 1e-2),
                                   err_msg=name)


def test_ops_process_segments_agl_variants_agree():
    dem, args = _bucket(seed=5)
    outs = [tops.process_segments(dem, *args, grid=GRID, agl_oracle=flag)
            for flag in (False, True)]
    assert torch.equal(*outs)


def _pipeline_with(**kw):
    dem, args = _bucket()
    return tpipe.process_segments(torch.from_numpy(dem), *args, grid=GRID,
                                  **kw)


@pytest.mark.parametrize("call", [
    lambda: tops.track_interp(*_tracks(), block_m=0),
    lambda: tops.track_interp(*_tracks(), block_m=True),
    lambda: tops.track_interp(*_tracks(), block_m=2.5),
    lambda: tops.agl_lookup(*_agl(), oracle_rows=np.ones(3, bool)),
    lambda: tops.agl_lookup(*_agl(), oracle_rows=np.ones(4, np.int32)),
    lambda: tops.agl_lookup(*_agl(), oracle_rows=np.ones((4, 1), bool)),
    lambda: tops.flash_attention(*_qkv(torch.float32), block_q=-1),
    lambda: tops.flash_attention(*_qkv(torch.float32), block_k=0),
    lambda: tscreen.screen_aligned(*_screen_batch(), h_thresh_m=H_M,
                                   v_thresh_m=V_M, interpret="yes",
                                   device="cpu"),
    lambda: _pipeline_with(donate=1),
], ids=["block_m=0", "block_m=True", "block_m=2.5", "oracle_rows_len3",
        "oracle_rows_int", "oracle_rows_2d", "block_q=-1", "block_k=0",
        "interpret=str", "donate=1"])
def test_bad_reference_keywords_raise_value_error(call):
    with pytest.raises(ValueError):
        call()


@pytest.mark.parametrize("flag", [True, False])
def test_use_pallas_is_refused_naming_use_kernels(flag):
    with pytest.raises(TypeError, match="use_kernels"):
        _pipeline_with(use_pallas=flag)


def test_remesh_takes_new_mesh_by_name(tmp_path):
    cfg = get_arch("minicpm-2b", reduced=True)
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(4):
        toks = np.minimum(rng.zipf(1.5, size=(4, 33)),
                          cfg.vocab_size - 1).astype(np.int32)
        batches.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    tr = Trainer(cfg, O.OptimizerConfig(),
                 TrainerConfig(workdir=str(tmp_path), ckpt_every=0,
                               log_every=100), device="cpu")
    tr.run(iter(batches[:2]), 2)
    before = [t.detach().clone() for t in O.tree_leaves(tr.params)]
    tr.remesh(new_mesh="cpu")
    assert tr.step == 3 and tr.device.type == "cpu"
    after = O.tree_leaves(tr.params)
    assert len(after) == len(before)
    assert all(torch.equal(a, b) for a, b in zip(after, before))
    log = tr.run(iter(batches[2:]), 2)
    tr.close()
    assert [r["step"] for r in log[-2:]] == [3, 4]
    assert all(np.isfinite(r["loss"]) for r in log)

