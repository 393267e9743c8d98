"""The port's LM layers and model vs the JAX package's, on the CPU.

Layers get the same numpy inputs; models get the JAX package's own
parameters through ``params_from_numpy``.  Every config of
``src/repro/configs`` runs, reduced: attention, Mamba and RWKV-6
blocks, dense and MoE feed-forward layers, token and ``embeds`` input.
In f32 (configs replaced to param/activation dtype float32) logits
agree within 1e-4 * max|logits| and layer outputs within rtol/atol
1e-5; in bf16 within the JAX tests' rel < 0.03
(tests/test_flash_attention.py), since the two frameworks round bf16
products at other places.
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
from repro.models import ssm as JSSM
from repro_torch.configs import get_arch
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import ssm as SSM

F32_CFG = dict(param_dtype="float32", activation_dtype="float32")
ARCHS = ["stablelm-12b", "minicpm-2b", "granite-34b", "nemotron-4-340b",
         "qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b", "jamba-v0.1-52b",
         "rwkv6-3b", "musicgen-medium", "pixtral-12b"]
# prefill + decode against forward without MoE capacity drops, as
# tests/test_models.py::test_prefill_decode_matches_forward runs it.
NO_DROPS = dict(capacity_factor=8.0)


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


def _inputs(cfg, B, T, seed=0):
    """Seeded token ids, or frame/patch embeddings for a stubbed
    frontend, as numpy: {'tokens': (B, T)} or {'embeds': (B, T, D)}."""
    rng = np.random.default_rng(seed)
    if cfg.frontend is not None:
        return {"embeds": rng.normal(size=(B, T, cfg.d_model))
                .astype(np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, T))
            .astype(np.int32)}


def _cut(batch, a, b):
    return {k: v[:, a:b] for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


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


@pytest.mark.parametrize("name", ARCHS)
def test_init_params_tree_matches_reference(name):
    """Names, shapes and dtypes equal the JAX package's for every
    config; values are drawn with the scales it uses, constants (norms,
    A_log, D, mu, w0, u, biases) equal its constants."""
    jcfg, cfg = _configs(name)
    want = dict(_leaves(jax.tree_util.tree_map(
        np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0)))))
    got = dict(_leaves(M.init_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu")))
    assert sorted(got) == sorted(want)
    for key, leaf in want.items():
        t = got[key]
        assert tuple(t.shape) == leaf.shape, key
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype), key
        if key[-1] == "A_log":
            # log(1..d_state): XLA's CPU log is one ulp off the correctly
            # rounded value at log(7); torch's is not.
            np.testing.assert_allclose(t.numpy(), leaf, rtol=2 ** -23)
        elif not np.asarray(leaf, np.float32).std():
            np.testing.assert_array_equal(t.float().numpy(),
                                          np.asarray(leaf, np.float32))
    if "attn" in cfg.block_pattern:
        i = cfg.block_pattern.index("attn")
        wq = got[("blocks", f"s{i}", "mixer", "wq")].float()
        assert abs(wq.std().item() * cfg.d_model ** 0.5 - 1.0) < 0.05
    if cfg.moe_period:
        i = cfg.moe_offset
        wi = got[("blocks", f"s{i}", "ffn", "wi")].float()
        assert abs(wi.std().item() * cfg.n_experts ** 0.5 - 1.0) < 0.05


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_forward_and_loss_match_reference(name, impl):
    jcfg, cfg = _configs(name, attention_impl=impl, **F32_CFG)
    jp, tp = _params(jcfg, cfg)
    rng = np.random.default_rng(0)
    batch = _inputs(cfg, 2, 48)
    batch["labels"] = rng.integers(-1, cfg.vocab_size, (2, 48)).astype(
        np.int32)
    want = np.asarray(JM.forward(jcfg, jp, _jb(batch), remat=False))
    got = M.forward(cfg, tp, _tb(batch))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got.numpy(), want) < 1e-4
    jloss = float(JM.loss_fn(jcfg, jp, _jb(batch), remat=False))
    loss = M.loss_fn(cfg, tp, _tb(batch))
    assert abs(loss.item() - jloss) <= 1e-5 * abs(jloss)


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_and_decode_match_reference(name):
    """prefill's logits and cache, then two decode steps (the cache
    carried), equal the JAX package's, every cache leaf included; and
    prefill(T) + decode equals forward(T + 1)'s last logits, the gate of
    tests/test_models.py (MoE without capacity drops, as there).  Cache
    leaves agree within rtol/atol 1e-5, but RWKV-6's wkv state, an f32
    sum over the chunk's tokens whose elements near 0 carry the larger
    elements' rounding (abs error up to 4e-5 at values up to 3.3): it is
    held within 1e-5 of its largest value (read: 3.7e-06)."""
    jcfg, cfg = _configs(name, **F32_CFG, **NO_DROPS)
    jp, tp = _params(jcfg, cfg, seed=2)
    B, T = 2, 20
    batch = _inputs(cfg, B, T + 2)
    jl, jc = JM.prefill(jcfg, jp, _jb(_cut(batch, 0, T)), cache_len=T + 4)
    tl, tc = M.prefill(cfg, tp, _tb(_cut(batch, 0, T)), cache_len=T + 4)
    assert _rel(tl.numpy(), np.asarray(jl)) < 1e-4
    for t in (T, T + 1):
        want = dict(_leaves(jc))
        assert sorted(dict(_leaves(tc))) == sorted(want)
        for path, leaf in _leaves(tc):
            if path[-1] == "wkv":
                assert _rel(leaf.numpy(), np.asarray(want[path])) < 1e-5
            else:
                _close(leaf, want[path], 1e-5)
        step = _cut(batch, t, t + 1)
        jd, jc = JM.decode_step(jcfg, jp, jc, _jb(step))
        td, tc = M.decode_step(cfg, tp, tc, _tb(step))
        assert td.shape == (B, 1, cfg.vocab_size)
        assert _rel(td.numpy(), np.asarray(jd)) < 1e-4
    full = M.forward(cfg, tp, _tb(batch))
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


def _jax_eager_forward(jcfg, jp, batch):
    """The reference's forward composed op by op from its public pieces
    (``encode_inputs``, ``superblock_apply``, ``rms_norm``, the unembed
    einsum).  ``JM.forward`` scans a compiled body instead, and XLA keeps
    bf16 intermediates in f32 inside its fusions, so in bf16 the two
    reference paths differ (test_bf16_decode_drift_matches_reference
    prints by how much); with MoE layers rounding flips router choices
    and the difference passes any bf16 gate."""
    x = JM.encode_inputs(jcfg, jp, batch)
    for sb in range(jcfg.n_superblocks):
        x = JM.superblock_apply(jcfg, jax.tree.map(lambda a: a[sb],
                                                   jp["blocks"]), x, sb)
    x = JL.rms_norm(x, jp["final_norm"], jcfg.rms_eps)
    return jnp.einsum("btd,dv->btv", x, jp["unembed"],
                      preferred_element_type=jnp.float32)


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "rwkv6-3b",
                                  "jamba-v0.1-52b"])
def test_bf16_sublayers_match_reference(name):
    """The configs' own bf16 dtypes through every MoE, RWKV-6, Mamba and
    attention sublayer: each fed the reference's own input (so one
    layer's rounding is not amplified by the next), within 0.03 of the
    reference's ``_apply_sublayer``."""
    jcfg, cfg = _configs(name)
    jp, tp = _params(jcfg, cfg)
    x = JM.encode_inputs(jcfg, jp, _jb(_inputs(cfg, 2, 64)))
    for sb in range(cfg.n_superblocks):
        jblock = jax.tree.map(lambda a: a[sb], jp["blocks"])
        block = M._index(tp["blocks"], sb)
        for i, kind in enumerate(cfg.block_pattern):
            is_moe = cfg.is_moe_layer(sb * cfg.pattern_period + i)
            want = JM._apply_sublayer(jcfg, kind, is_moe, jblock[f"s{i}"], x)
            got = M._apply_sublayer(cfg, kind, is_moe, block[f"s{i}"],
                                    M._tensor(np.asarray(x)))
            assert got.dtype == torch.bfloat16
            rel = _rel(got.float().numpy(), np.asarray(want, np.float32))
            assert rel < 0.03, (sb, i, kind, is_moe, rel)
            x = want


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "rwkv6-3b",
                                  "jamba-v0.1-52b"])
def test_bf16_forward_and_cache_dtypes(name):
    """A bf16 forward, and after a decode step every cache leaf has the
    reference's dtype and shape (attention v turns f32, Mamba conv stays
    in the activation dtype, the ssm and wkv states stay f32).  Where no
    router can flip (rwkv6), the logits are within 0.03 of the
    reference's forward composed op by op; with MoE layers they are only
    finite, as the reference's own two paths differ there."""
    jcfg, cfg = _configs(name)
    jp, tp = _params(jcfg, cfg)
    batch = _inputs(cfg, 2, 64)
    got = M.forward(cfg, tp, _tb(batch))
    assert got.dtype == torch.float32
    assert got.shape == (2, 64, cfg.vocab_size)
    assert bool(torch.isfinite(got).all())
    if not cfg.moe_period:
        want = _jax_eager_forward(jcfg, jp, _jb(batch))
        assert _rel(got.numpy(), np.asarray(want)) < 0.03
    step = _cut(batch, 0, 1)
    _, jc = JM.decode_step(jcfg, jp, JM.init_cache(jcfg, 2, 8), _jb(step))
    _, tc = M.decode_step(cfg, tp, M.init_cache(cfg, 2, 8, device="cpu"),
                          _tb(step))
    want = dict(_leaves(jc))
    got = dict(_leaves(tc))
    assert sorted(got) == sorted(want)
    for path, leaf in want.items():
        assert str(got[path].dtype).split(".")[-1] == str(leaf.dtype), path
        assert tuple(got[path].shape) == leaf.shape, path


def _drift(cfg, mod, params, batch, T):
    """(max|prefill(T) + decode - forward(T + 1)[T]| / max|forward|, the
    forward's logits), with ``mod`` the reference's model module
    (``batch`` jnp arrays) or the port's (torch tensors)."""
    head = {k: v[:, :T] for k, v in batch.items()}
    last = {k: v[:, T:] for k, v in batch.items()}
    if mod is JM:
        _, cache = JM.prefill(cfg, params, head, cache_len=T + 4)
        dec, _ = JM.decode_step(cfg, params, cache, last)
        full = JM.forward(cfg, params, batch, remat=False)
        full = np.asarray(full)
        return _rel(np.asarray(dec[:, 0]), full[:, T]), full
    _, cache = M.prefill(cfg, params, head, cache_len=T + 4)
    dec, _ = M.decode_step(cfg, params, cache, last)
    full = M.forward(cfg, params, batch)
    full = full.numpy()
    return _rel(dec[:, 0].numpy(), full[:, T]), full


@pytest.mark.parametrize("name", ["stablelm-12b", "qwen3-moe-30b-a3b",
                                  "rwkv6-3b", "jamba-v0.1-52b"])
def test_bf16_decode_drift_matches_reference(name, capsys):
    """In the configs' bf16 dtypes prefill(64) + decode does not equal
    forward(65) exactly: the two paths sum in other orders (RWKV-6 in
    chunks of 32 against 13, MoE routes flip), and each bf16 rounding
    turns an f32 difference into an ulp.  The witness is the reference
    run op by op (``jax.disable_jit``), which rounds every bf16 result as
    its source is written and as the port does.  Its compiled form keeps
    bf16 intermediates in f32 inside XLA's fusions and drifts less or
    more by seed (rwkv6: 1.4e-07 at seed 0, 0.01 and 0.0033 at seeds 1
    and 2), so it is printed, not held.  The port stays under the 0.05
    gate of tests/test_models.py and within 1.5 times the witness's
    drift (port / witness read 0.58 to 1.2 over these four)."""
    jcfg, cfg = _configs(name, **NO_DROPS)
    jp, tp = _params(jcfg, cfg)
    T = 64
    batch = _inputs(cfg, 2, T + 1)
    port, _ = _drift(cfg, M, tp, _tb(batch), T)
    compiled, full = _drift(jcfg, JM, jp, _jb(batch), T)
    with jax.disable_jit():
        witness, full_op = _drift(jcfg, JM, jp, _jb(batch), T)
    with capsys.disabled():
        print(f"\n{name} bf16 prefill + decode vs forward: port {port:.4g}, "
              f"reference op by op {witness:.4g}, reference compiled "
              f"{compiled:.4g}; reference forward, compiled vs op by op "
              f"{_rel(full, full_op):.4g}")
    assert port < 0.05
    assert port <= 1.5 * witness


def test_bf16_rwkv6_mixers_round_as_reference():
    """RWKV-6's bf16 time mix and channel mix, each fed the reference's
    own input, against the reference run op by op: the five ddlerp
    interpolations are bitwise the reference's, and a mixer's output
    differs only where an f32 sum's order flips a bf16 rounding, in
    under 1 % of its elements (read: 0.02-0.11 %) and by under one bf16
    ulp of its largest value (2^-8 of max|ref|; read: up to 0.0023).
    Each mixer in bf16 also sits as far from itself in f32 (on the
    widened weights) as the reference's does, within a tenth (read:
    equal to four digits, the time mix up to 0.0239): the distance that
    chip_smoke.py's sublayer gate holds at full width is the
    reference's arithmetic."""
    jcfg, cfg = _configs("rwkv6-3b")
    jp, tp = _params(jcfg, cfg)

    def wide(tree):
        return {k: wide(v) if isinstance(v, dict) else v.float()
                for k, v in tree.items()}

    def same_distance_from_f32(fn, jfn, h, th, jp_, tp_, what):
        port = _rel(fn(th, tp_).float().numpy(),
                    fn(th.float(), wide(tp_)).numpy())
        ref = _rel(np.asarray(jfn(h, jp_), np.float32),
                   np.asarray(jfn(h.astype(jnp.float32), jax.tree.map(
                       lambda a: a.astype(jnp.float32), jp_))))
        assert abs(port - ref) <= 0.1 * ref, (what, port, ref)

    def held(got, want, what):
        got = got.float().numpy()
        want = np.asarray(jnp.asarray(want, jnp.float32))
        diff = np.abs(got - want)
        assert (diff > 0).mean() < 0.01, what
        assert diff.max() < 2.0 ** -8 * np.abs(want).max(), what

    hd = cfg.rwkv_head_dim
    with jax.disable_jit():
        x = JM.encode_inputs(jcfg, jp, _jb(_inputs(cfg, 2, 64)))
        for sb in range(cfg.n_superblocks):
            jb = jax.tree.map(lambda a: a[sb], jp["blocks"])["s0"]
            tb = M._index(tp["blocks"], sb)["s0"]
            h = JL.rms_norm(x, jb["norm1"], jcfg.rms_eps)
            th = M._tensor(np.asarray(h))
            xx, txx = JSSM._token_shift(h), SSM._token_shift(th)
            for n in "rkvwg":
                want = JSSM._ddlerp(h, xx, *(jb["mixer"][f"{w}_{n}"] for w in
                                             ("mu", "lora_a", "lora_b")))
                got = SSM._ddlerp(th, txx, *(tb["mixer"][f"{w}_{n}"] for w in
                                             ("mu", "lora_a", "lora_b")))
                np.testing.assert_array_equal(
                    got.float().numpy(), np.asarray(want, np.float32))
            o = JSSM.rwkv6_time_mix(h, jb["mixer"],
                                    head_dim=jcfg.rwkv_head_dim)
            held(SSM.rwkv6_time_mix(th, tb["mixer"],
                                    head_dim=cfg.rwkv_head_dim), o,
                 ("time", sb))
            same_distance_from_f32(
                lambda a, q: SSM.rwkv6_time_mix(a, q, head_dim=hd),
                lambda a, q: JSSM.rwkv6_time_mix(a, q, head_dim=hd),
                h, th, jb["mixer"], tb["mixer"], ("time", sb))
            h2 = JL.rms_norm(x + o, jb["norm2"], jcfg.rms_eps)
            th2 = M._tensor(np.asarray(h2))
            held(SSM.rwkv6_channel_mix(th2, tb["ffn"]),
                 JSSM.rwkv6_channel_mix(h2, jb["ffn"]), ("channel", sb))
            same_distance_from_f32(SSM.rwkv6_channel_mix,
                                   JSSM.rwkv6_channel_mix, h2, th2,
                                   jb["ffn"], tb["ffn"], ("channel", sb))
            x = JM._apply_sublayer(jcfg, "rwkv6", False, jb, x)


@pytest.mark.parametrize("name", ARCHS)
def test_every_config_runs_and_frontends_are_not_served(name):
    """Every config initialises and runs forward on its own input kind
    (nothing is refused any more); the stubbed frontends stay refused by
    BatchedServer and launch/serve.py, as in the reference."""
    from repro_torch.launch import serve
    from repro_torch.serving import BatchedServer
    cfg = get_arch(name, reduced=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    logits = M.forward(cfg, params, _inputs(cfg, 1, 4))
    assert logits.shape == (1, 4, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    if cfg.frontend is None:
        BatchedServer(cfg, params, slots=1, prompt_len=4, cache_len=8,
                      device="cpu")
        return
    with pytest.raises(ValueError, match="embeds"):
        BatchedServer(cfg, params, device="cpu")
    with pytest.raises(SystemExit, match="token-input"):
        serve.main(["--arch", name, "--device", "cpu"])


@pytest.mark.parametrize("name", ["jamba-v0.1-52b", "rwkv6-3b"])
def test_nested_init_cache_matches_reference(name):
    """Mamba and RWKV-6 states (the RWKV-6 cache two levels deep) leaf
    for leaf as the reference's init_cache, fill touching only the
    attention pos."""
    jcfg, cfg = _configs(name)
    want = dict(_leaves(JM.init_cache(jcfg, 2, 8, 7)))
    got = dict(_leaves(M.init_cache(cfg, 2, 8, 7, device="cpu")))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g, w = got[path], np.asarray(w)
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path
        np.testing.assert_array_equal(g.float().numpy(),
                                      w.astype(np.float32))


def test_remat_arguments_match_reference():
    """forward and loss_fn take the reference's remat and remat_policy
    (values do not depend on them, as in tests/test_models.py::
    test_remat_matches_no_remat); an unknown policy raises KeyError, as
    the reference's REMAT_POLICIES lookup does."""
    jcfg, cfg = _configs("stablelm-12b", **F32_CFG)
    jp, tp = _params(jcfg, cfg, seed=3)
    batch = _inputs(cfg, 2, 24)
    batch["labels"] = np.roll(batch["tokens"], -1, axis=1)
    jloss = float(JM.loss_fn(jcfg, jp, _jb(batch), remat=False))
    for kw in (dict(remat=True), dict(remat=False),
               dict(remat_policy="dots_no_batch"),
               dict(remat=True, remat_policy="everything")):
        loss = M.loss_fn(cfg, tp, _tb(batch), **kw)
        assert abs(loss.item() - jloss) <= 1e-5 * abs(jloss), kw
    want = M.forward(cfg, tp, _tb(batch))
    assert torch.equal(M.forward(cfg, tp, _tb(batch), remat=False), want)
    for fn in (lambda: M.loss_fn(cfg, tp, _tb(batch), remat_policy="all"),
               lambda: M.forward(cfg, tp, _tb(batch), False, "none"),
               lambda: M.forward_trunk(cfg, tp, want, remat_policy="x")):
        with pytest.raises(KeyError):
            fn()
    with pytest.raises(KeyError):
        JM.loss_fn(jcfg, jp, _jb(batch), remat_policy="all")


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
