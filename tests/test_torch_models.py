"""The port's LM layers and model vs the JAX package's, on the CPU.

Layers get the same numpy inputs; models get the JAX package's own
parameters through ``params_from_numpy``.  In f32 (configs replaced to
param/activation dtype float32) logits agree within 1e-4 * max|logits|
and layer outputs within rtol/atol 1e-5; in bf16 within the JAX tests'
rel < 0.03 (tests/test_flash_attention.py), since the two frameworks
round bf16 products at other places.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import get_arch
from repro_torch.models import layers as L
from repro_torch.models import model as M

F32_CFG = dict(param_dtype="float32", activation_dtype="float32")
ARCHS = ["stablelm-12b", "minicpm-2b", "granite-34b", "nemotron-4-340b"]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-6)


def _close(got: torch.Tensor, want, tol=1e-5):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _configs(name, **kw):
    return (dataclasses.replace(jax_get_arch(name, reduced=True), **kw),
            dataclasses.replace(get_arch(name, reduced=True), **kw))


def _params(jcfg, cfg, seed=0):
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, M.params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                 device="cpu")


def _attn_params(rng, D, H, KV, hd):
    return {"wq": rng.normal(0, D ** -0.5, (D, H, hd)),
            "wk": rng.normal(0, D ** -0.5, (D, KV, hd)),
            "wv": rng.normal(0, D ** -0.5, (D, KV, hd)),
            "wo": rng.normal(0, (H * hd) ** -0.5, (H, hd, D))}


def _both(tree):
    """f32 numpy tree -> (jnp tree, torch tree)."""
    return ({k: jnp.asarray(v, jnp.float32) for k, v in tree.items()},
            {k: torch.from_numpy(np.asarray(v, np.float32))
             for k, v in tree.items()})


def test_configs_are_the_reference_data():
    from repro.configs import all_arch_names
    from repro_torch.configs import all_arch_names as port_names
    assert port_names() == all_arch_names()
    for name in all_arch_names():
        for reduced in (False, True):
            assert dataclasses.asdict(get_arch(name, reduced)) == \
                dataclasses.asdict(jax_get_arch(name, reduced))


def test_rms_norm_and_rope():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 12, 3, 40)).astype(np.float32)
    scale = rng.normal(1, 0.1, 40).astype(np.float32)
    _close(L.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(scale)))
    pos = rng.integers(0, 4096, (2, 12)).astype(np.int32)
    for theta in (10_000.0, 500_000.0):
        _close(L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            theta),
               JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
               tol=2e-5)


@pytest.mark.parametrize("activation,gated", [
    ("silu", True), ("gelu", False), ("relu2", False)])
def test_mlp(activation, gated):
    rng = np.random.default_rng(1)
    D, Fd = 48, 96
    x = rng.normal(size=(2, 10, D)).astype(np.float32)
    jp, tp = _both({"wi": rng.normal(0, D ** -0.5, (D, 2 if gated else 1,
                                                      Fd)),
                    "wo": rng.normal(0, Fd ** -0.5, (Fd, D))})
    _close(L.mlp(torch.from_numpy(x), tp, activation),
           JL.mlp(jnp.asarray(x), jp, activation))


@pytest.mark.parametrize("impl,window", [
    ("xla", None), ("flash", None), ("xla", 5), ("flash", 5)])
def test_attention_train(impl, window):
    rng = np.random.default_rng(2)
    B, T, D, H, KV, hd = 2, 24, 64, 4, 2, 16
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    jp, tp = _both(_attn_params(rng, D, H, KV, hd))
    kw = dict(n_heads=H, n_kv=KV, head_dim=hd, theta=10_000.0,
              window=window, impl=impl)
    _close(L.attention_train(torch.from_numpy(x), tp, **kw),
           JL.attention_train(jnp.asarray(x), jp, **kw))


@pytest.mark.parametrize("window", [None, 6])
def test_attention_decode(window):
    """A cache part written (positions 3 and 9 of 8 slots: the second one
    wraps the ring), so both the valid mask and the ring slot count."""
    rng = np.random.default_rng(3)
    B, S, D, H, KV, hd = 2, 8, 64, 4, 2, 16
    x = rng.normal(size=(B, 1, D)).astype(np.float32)
    jp, tp = _both(_attn_params(rng, D, H, KV, hd))
    k = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    pos = np.array([3, 9], np.int32)
    kw = dict(n_heads=H, n_kv=KV, head_dim=hd, theta=10_000.0,
              window=window)
    out, cache = L.attention_decode(
        torch.from_numpy(x), {"k": torch.from_numpy(k),
                              "v": torch.from_numpy(v),
                              "pos": torch.from_numpy(pos)}, tp, **kw)
    jout, jcache = JL.attention_decode(
        jnp.asarray(x), {"k": jnp.asarray(k), "v": jnp.asarray(v),
                         "pos": jnp.asarray(pos)}, jp, **kw)
    _close(out, jout)
    for key in ("k", "v"):
        _close(cache[key], jcache[key])
    assert cache["pos"].tolist() == [4, 10]


def test_init_params_tree_matches_reference():
    """Names, shapes and dtypes equal the JAX package's for every ported
    config; values are drawn with the scales it uses."""
    for name in ARCHS:
        jcfg, cfg = _configs(name)
        want = jax.tree_util.tree_flatten_with_path(
            JM.init_params(jcfg, jax.random.PRNGKey(0)))[0]
        got = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        flat = {}

        def walk(tree, path=()):
            for k, val in tree.items():
                if isinstance(val, dict):
                    walk(val, path + (k,))
                else:
                    flat[path + (k,)] = val
        walk(got)
        assert len(flat) == len(want)
        for path, leaf in want:
            key = tuple(p.key for p in path)
            t = flat[key]
            assert tuple(t.shape) == leaf.shape, key
            assert str(t.dtype).split(".")[-1] == str(leaf.dtype), key
    wq = got["blocks"]["s0"]["mixer"]["wq"].float()
    assert abs(wq.std().item() * cfg.d_model ** 0.5 - 1.0) < 0.05


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_forward_and_loss_match_reference(name, impl):
    jcfg, cfg = _configs(name, attention_impl=impl, **F32_CFG)
    jp, tp = _params(jcfg, cfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 48)).astype(np.int32)
    labels = rng.integers(-1, cfg.vocab_size, (2, 48)).astype(np.int32)
    want = np.asarray(JM.forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                 remat=False))
    got = M.forward(cfg, tp, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got.numpy(), want) < 1e-4
    batch = {"tokens": toks, "labels": labels}
    jloss = float(JM.loss_fn(jcfg, jp, {k: jnp.asarray(v)
                                        for k, v in batch.items()},
                             remat=False))
    loss = M.loss_fn(cfg, tp, {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    assert abs(loss.item() - jloss) <= 1e-5 * abs(jloss)


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_and_decode_match_reference(name):
    """prefill's logits and cache, then two decode steps (the cache
    carried), equal the JAX package's; and prefill(T) + decode equals
    forward(T + 1)'s last logits, the gate of tests/test_models.py."""
    jcfg, cfg = _configs(name, **F32_CFG)
    jp, tp = _params(jcfg, cfg, seed=2)
    rng = np.random.default_rng(0)
    B, T = 2, 20
    toks = rng.integers(0, cfg.vocab_size, (B, T + 2)).astype(np.int32)
    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :T])},
                        cache_len=T + 4)
    tl, tc = M.prefill(cfg, tp, {"tokens": torch.from_numpy(toks[:, :T])},
                       cache_len=T + 4)
    assert _rel(tl.numpy(), np.asarray(jl)) < 1e-4
    for key in ("k", "v", "pos"):
        np.testing.assert_allclose(tc["s0"][key].numpy(),
                                   np.asarray(jc["s0"][key]),
                                   rtol=1e-5, atol=1e-5)
    for t in (T, T + 1):
        step = toks[:, t:t + 1]
        jd, jc = JM.decode_step(jcfg, jp, jc, {"tokens": jnp.asarray(step)})
        td, tc = M.decode_step(cfg, tp, tc,
                               {"tokens": torch.from_numpy(step)})
        assert td.shape == (B, 1, cfg.vocab_size)
        assert _rel(td.numpy(), np.asarray(jd)) < 1e-4
    full = M.forward(cfg, tp, {"tokens": torch.from_numpy(toks)})
    assert _rel(td[:, 0].numpy(), full[:, T + 1].numpy()) < 1e-4


def test_prefill_ring_cache_with_sliding_window():
    """A window shorter than the prompt keeps the last positions in ring
    layout, as the reference does."""
    jcfg, cfg = _configs("stablelm-12b", sliding_window=8, **F32_CFG)
    jp, tp = _params(jcfg, cfg, seed=4)
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (1, 13)).astype(np.int32)
    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :12])},
                        cache_len=16)
    tl, tc = M.prefill(cfg, tp, {"tokens": torch.from_numpy(toks[:, :12])},
                       cache_len=16)
    assert tc["s0"]["k"].shape[2] == 8
    assert _rel(tl.numpy(), np.asarray(jl)) < 1e-4
    np.testing.assert_allclose(tc["s0"]["k"].numpy(),
                               np.asarray(jc["s0"]["k"]), rtol=1e-5,
                               atol=1e-5)
    jd, _ = JM.decode_step(jcfg, jp, jc, {"tokens": jnp.asarray(toks[:, 12:])})
    td, _ = M.decode_step(cfg, tp, tc, {"tokens": torch.from_numpy(
        toks[:, 12:])})
    assert _rel(td.numpy(), np.asarray(jd)) < 1e-4


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_bf16_forward_and_decode(impl):
    """The configs' own bf16 dtypes: forward, and decode's cache dtypes
    (v turns f32 after a step, as JAX's type promotion makes it)."""
    jcfg, cfg = _configs("stablelm-12b", attention_impl=impl)
    jp, tp = _params(jcfg, cfg)
    assert tp["embed"].dtype == torch.bfloat16
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 64)).astype(np.int32)
    want = JM.forward(jcfg, jp, {"tokens": jnp.asarray(toks)}, remat=False)
    got = M.forward(cfg, tp, {"tokens": torch.from_numpy(toks)})
    assert _rel(got.numpy(), np.asarray(want)) < 0.03
    _, jc = JM.decode_step(jcfg, jp, JM.init_cache(jcfg, 2, 8),
                           {"tokens": jnp.asarray(toks[:, :1])})
    _, tc = M.decode_step(cfg, tp, M.init_cache(cfg, 2, 8, device="cpu"),
                          {"tokens": torch.from_numpy(toks[:, :1])})
    for key in ("k", "v", "pos"):
        assert str(tc["s0"][key].dtype).split(".")[-1] == \
            str(jc["s0"][key].dtype)


@pytest.mark.parametrize("name", [
    "jamba-v0.1-52b", "rwkv6-3b", "qwen3-moe-30b-a3b", "musicgen-medium"])
def test_unported_blocks_raise(name):
    cfg = get_arch(name, reduced=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        M.forward(cfg, {}, {"tokens": np.zeros((1, 4), np.int32)})


def test_entry_points_default_to_the_card():
    """Without a card, the functions that make tensors raise unless told
    "cpu"; with one they default to it."""
    cfg = get_arch("stablelm-12b", reduced=True)
    gen = torch.Generator().manual_seed(0)
    if torch.cuda.device_count():
        assert M.init_cache(cfg, 1, 4)["s0"]["k"].device.type == "cuda"
        return
    for make in (lambda: M.init_params(cfg, gen),
                 lambda: M.init_cache(cfg, 1, 4),
                 lambda: M.params_from_numpy(cfg, {"embed": np.zeros(2)})):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    params = M.init_params(cfg, gen, "cpu")
    assert params["embed"].device.type == "cpu"


@pytest.mark.parametrize("fill", [0, 7])
@pytest.mark.parametrize("name", ["stablelm-12b", "minicpm-2b"])
def test_init_cache_fill_matches_reference(name, fill):
    """init_cache(cfg, B, L, fill): pos holds fill, k and v are zero, leaf
    for leaf as the reference's init_cache(cfg, B, L, fill)."""
    jcfg, cfg = _configs(name)
    want = JM.init_cache(jcfg, 2, 8, fill)
    got = M.init_cache(cfg, 2, 8, fill, device="cpu")
    assert sorted(got) == sorted(want)
    for sub, leaves in want.items():
        assert sorted(got[sub]) == sorted(leaves)
        for key, w in leaves.items():
            g = got[sub][key]
            w = np.asarray(w)
            assert tuple(g.shape) == w.shape, (sub, key)
            assert str(g.dtype).split(".")[-1] == str(w.dtype), (sub, key)
            np.testing.assert_array_equal(g.float().numpy(),
                                          w.astype(np.float32))
        assert (got[sub]["pos"] == fill).all()
        assert not got[sub]["k"].any() and not got[sub]["v"].any()


def test_init_cache_device_is_keyword_only():
    """A positional fourth argument is the reference's fill, never a
    device."""
    cfg = get_arch("stablelm-12b", reduced=True)
    with pytest.raises(TypeError):
        M.init_cache(cfg, 1, 4, 0, "cpu")
    params = inspect.signature(M.init_cache).parameters
    assert list(params)[3] == "fill"
    assert params["device"].kind is inspect.Parameter.KEYWORD_ONLY
