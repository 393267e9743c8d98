"""The head groupings and widths of granite-34b, llama4-maverick and
nemotron-4-340b, against the JAX package on the CPU.

granite-34b puts 48 query heads on one KV head, llama4-maverick 40 on
8 (groups of 5); the model's attention maps each query head to its KV
head by that grouping, in the flash kernel (whose plain version runs
here) and in the xla form, train and decode.  These tests hold both at
those groupings with a narrow head_dim, and whole reduced models that
keep them, against the JAX package's layers and model on the same numpy
inputs.  They also hold the two bounded f32 transients of the port:
``layers.moe`` runs its expert products a chunk of experts at a time
and ``model._unembed`` its f32 logits a slice of the vocabulary at a
time, both within ``layers.F32_CHUNK_BYTES``;
both must give the reference's values at every chunk size, a size that
divides nothing included.

Tolerances, each the repo's for its kind of output: f32 layer outputs
rtol/atol 1e-5 (tests/test_torch_models.py), the flash kernel rtol/atol
2e-5 in f32 and one bf16 rounding (rtol 2^-8, atol 1e-5) of the
oracle's f32 output in bf16 (tests/test_torch_flash_attention.py), MoE
outputs rtol 1e-5 / atol 1e-6 (tests/test_torch_moe.py), f32 logits
1e-4 of max|logits| (tests/test_torch_models.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import model as M

F32_CFG = dict(param_dtype="float32", activation_dtype="float32")
# (n_heads, n_kv_heads): granite-34b's MQA and llama4-maverick's groups
# of 5.
GROUPINGS = [(48, 1), (40, 8)]
GROUPING_IDS = ["granite-48-on-1", "llama4-40-on-8"]
HD = 16


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-6)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _attn_params(rng, D, H, KV, hd):
    tree = {"wq": rng.normal(0, D ** -0.5, (D, H, hd)),
            "wk": rng.normal(0, D ** -0.5, (D, KV, hd)),
            "wv": rng.normal(0, D ** -0.5, (D, KV, hd)),
            "wo": rng.normal(0, (H * hd) ** -0.5, (H, hd, D))}
    return ({k: jnp.asarray(v, jnp.float32) for k, v in tree.items()},
            {k: torch.from_numpy(np.asarray(v, np.float32))
             for k, v in tree.items()})


# ---------------------------------------------------------------------------
# Attention at the groupings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H,KV", GROUPINGS, ids=GROUPING_IDS)
def test_flash_kernel_plain_version_at_grouping(H, KV):
    """The port's flash attention (its plain version on the CPU) against
    the JAX package's Pallas kernel in interpret mode and its oracle,
    causal, T = S = 128, f32 (2e-5); in bf16 within one bf16 rounding of
    the oracle's f32 output."""
    rng = np.random.default_rng(H * 10 + KV)
    B, T = 1, 128
    q = rng.normal(size=(B, H, T, HD)).astype(np.float32)
    k = rng.normal(size=(B, KV, T, HD)).astype(np.float32)
    v = rng.normal(size=(B, KV, T, HD)).astype(np.float32)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    pallas = np.asarray(jax_ops.flash_attention(jq, jk, jv, causal=True))
    oracle = np.asarray(jax_ref.flash_attention_ref(jq, jk, jv, causal=True))
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=True)
    assert got.shape == (B, H, T, HD)
    _close(got.numpy(), pallas, 2e-5)
    _close(got.numpy(), oracle, 2e-5)
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    want = np.asarray(jax_ref.flash_attention_ref(
        *(jnp.asarray(t.float().numpy()) for t in tb), causal=True))
    got16 = ops.flash_attention(*tb, causal=True)
    assert got16.dtype == torch.bfloat16
    np.testing.assert_allclose(got16.float().numpy(), want, rtol=2 ** -8,
                               atol=1e-5)


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("H,KV", GROUPINGS, ids=GROUPING_IDS)
def test_attention_train_at_grouping(H, KV, impl):
    """The attention layer, xla form (the grouped reshape into KV groups
    of H / KV heads) and flash, against the JAX package's, f32 1e-5."""
    rng = np.random.default_rng(H + KV)
    B, T, D = 2, 40, 64
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    jp, tp = _attn_params(rng, D, H, KV, HD)
    kw = dict(n_heads=H, n_kv=KV, head_dim=HD, theta=10_000.0, window=None,
              impl=impl)
    _close(L.attention_train(torch.from_numpy(x), tp, **kw).numpy(),
           JL.attention_train(jnp.asarray(x), jp, **kw))


@pytest.mark.parametrize("H,KV", GROUPINGS, ids=GROUPING_IDS)
def test_attention_decode_at_grouping(H, KV):
    """One decode step against a part-written cache (positions 3 and 9 of
    8 slots), output and written k and v against the JAX package's, f32
    1e-5."""
    rng = np.random.default_rng(3 * H + KV)
    B, S, D = 2, 8, 64
    x = rng.normal(size=(B, 1, D)).astype(np.float32)
    jp, tp = _attn_params(rng, D, H, KV, HD)
    k = rng.normal(size=(B, S, KV, HD)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, HD)).astype(np.float32)
    pos = np.array([3, 9], np.int32)
    kw = dict(n_heads=H, n_kv=KV, head_dim=HD, theta=500_000.0)
    out, cache = L.attention_decode(
        torch.from_numpy(x), {"k": torch.from_numpy(k),
                              "v": torch.from_numpy(v),
                              "pos": torch.from_numpy(pos)}, tp, **kw)
    jout, jcache = JL.attention_decode(
        jnp.asarray(x), {"k": jnp.asarray(k), "v": jnp.asarray(v),
                         "pos": jnp.asarray(pos)}, jp, **kw)
    _close(out.numpy(), jout)
    for key in ("k", "v"):
        _close(cache[key].numpy(), jcache[key])


# ---------------------------------------------------------------------------
# Whole models that keep the groupings
# ---------------------------------------------------------------------------

# Reduced granite-34b and llama4-maverick with the full configs' head
# groupings (48 on 1; 40 on 8) at head_dim 16 (llama4's d_model 160, as
# the configs require a d_model that 40 heads divide); nemotron-4-340b
# reduced keeps its squared-ReLU MLP and untied unembedding.
WIDE = {
    "granite-34b": dict(n_heads=48, n_kv_heads=1, head_dim=HD),
    "llama4-maverick-400b-a17b": dict(n_heads=40, n_kv_heads=8,
                                      head_dim=HD, d_model=160),
    "nemotron-4-340b": {},
}
NO_DROPS = dict(capacity_factor=8.0)


def _configs(name, **kw):
    kw = {**WIDE[name], **kw}
    return (dataclasses.replace(jax_get_arch(name, reduced=True), **kw),
            dataclasses.replace(get_arch(name, reduced=True), **kw))


def _params(jcfg, cfg, seed=0):
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, M.params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                 device="cpu")


def _tokens(cfg, B, T, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32)


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("name", list(WIDE))
def test_forward_matches_reference(name, impl):
    """f32 logits of the whole reduced model within 1e-4 of max|logits|
    of the JAX package's, and the loss within 1e-5."""
    jcfg, cfg = _configs(name, attention_impl=impl, **F32_CFG)
    jp, tp = _params(jcfg, cfg)
    toks = _tokens(cfg, 2, 48)
    labels = np.random.default_rng(1).integers(
        -1, cfg.vocab_size, (2, 48)).astype(np.int32)
    want = np.asarray(JM.forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                 remat=False))
    got = M.forward(cfg, tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == want.shape
    assert _rel(got.numpy(), want) < 1e-4
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    jloss = float(JM.loss_fn(jcfg, jp, jb, remat=False))
    assert abs(M.loss_fn(cfg, tp, tb).item() - jloss) <= 1e-5 * abs(jloss)


@pytest.mark.parametrize("name", list(WIDE))
def test_prefill_and_decode_match_reference(name):
    """prefill's logits and two decode steps (cache carried) against the
    JAX package's, 1e-4 of max|logits|; and prefill(T) + decode against
    forward(T + 2)'s last logits (MoE without capacity drops)."""
    jcfg, cfg = _configs(name, **F32_CFG, **NO_DROPS)
    jp, tp = _params(jcfg, cfg, seed=2)
    B, T = 2, 20
    toks = _tokens(cfg, B, T + 2, seed=2)
    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :T])},
                        cache_len=T + 4)
    tl, tc = M.prefill(cfg, tp, {"tokens": torch.from_numpy(toks[:, :T])},
                       cache_len=T + 4)
    assert _rel(tl.numpy(), np.asarray(jl)) < 1e-4
    for t in (T, T + 1):
        step = toks[:, t:t + 1]
        jd, jc = JM.decode_step(jcfg, jp, jc, {"tokens": jnp.asarray(step)})
        td, tc = M.decode_step(cfg, tp, tc, {"tokens": torch.from_numpy(step)})
        assert _rel(td.numpy(), np.asarray(jd)) < 1e-4
    full = M.forward(cfg, tp, {"tokens": torch.from_numpy(toks)})
    assert _rel(td[:, 0].numpy(), full[:, T + 1].numpy()) < 1e-4


def test_bf16_granite_grouping_matches_reference():
    """granite's grouping in its own bf16 dtypes, xla and flash: the
    whole reduced model within the JAX tests' bf16 gate (rel < 0.03) of
    the JAX package's forward."""
    for impl in ("xla", "flash"):
        jcfg, cfg = _configs("granite-34b", attention_impl=impl)
        jp, tp = _params(jcfg, cfg)
        toks = _tokens(cfg, 2, 64)
        want = JM.forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                          remat=False)
        got = M.forward(cfg, tp, {"tokens": torch.from_numpy(toks)})
        assert _rel(got.numpy(), np.asarray(want)) < 0.03


# ---------------------------------------------------------------------------
# The MoE's expert products a chunk of experts at a time
# ---------------------------------------------------------------------------

def _moe_params(rng, E, D, F, gated):
    z = 2 if gated else 1
    tree = {"router": rng.normal(0, 0.1, (D, E)).astype(np.float32),
            "wi": rng.normal(0, 0.05, (E, D, z, F)).astype(np.float32),
            "wo": rng.normal(0, 0.05, (E, F, D)).astype(np.float32)}
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(v) for k, v in tree.items()})


def _chunked_moe(monkeypatch, x, p, chunk, **kw):
    """``layers.moe`` on ``x`` with ``F32_CHUNK_BYTES`` set so that its
    expert products run ``chunk`` experts a chunk (None: the default
    budget)."""
    if chunk is not None:
        B, T, D = x.shape
        _, _, z, F = p["wi"].shape
        S = B * T
        gs = L._largest_divisor_leq(S, kw["group_size"])
        rows = S // gs * max(int(kw["capacity_factor"] * kw["top_k"] * gs
                                 / kw["n_experts"]), 1)
        monkeypatch.setattr(L, "F32_CHUNK_BYTES",
                            chunk * L.expert_bytes(D, z, F, rows))
        assert L.experts_per_chunk(kw["n_experts"], D, z, F, rows) == min(
            chunk, kw["n_experts"])
    out = L.moe(x, p, **kw)
    monkeypatch.undo()
    return out


@pytest.mark.parametrize("chunk", [None, 1, 3, 5, 64],
                         ids=lambda c: f"chunk={c}")
@pytest.mark.parametrize("cf", ["ample", 0.5])
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("E", [8, 32])
def test_chunked_moe_matches_reference(monkeypatch, E, top_k, cf, chunk):
    """``layers.moe`` with its expert products ``chunk`` experts at a
    time (3 and 5 divide neither E; 64 exceeds both; None is the default
    budget, one chunk here) against the JAX package's ``moe``, with
    capacity drops (cf 0.5) and without, rtol 1e-5 / atol 1e-6."""
    rng = np.random.default_rng(E + 10 * top_k)
    B, T, D, F = 2, 32, 16, 24
    capacity_factor = float(E) / top_k if cf == "ample" else cf
    # Top-1 takes a gated expert FFN (llama4's), top-2 an ungated one.
    jp, tp = _moe_params(rng, E, D, F, gated=top_k == 1)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    kw = dict(n_experts=E, top_k=top_k, activation="silu",
              capacity_factor=capacity_factor, group_size=32)
    want = np.asarray(JL.moe(jnp.asarray(x), jp, **kw))
    got = _chunked_moe(monkeypatch, torch.from_numpy(x), tp, chunk, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    whole = _chunked_moe(monkeypatch, torch.from_numpy(x), tp, E, **kw)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-6,
                               atol=1e-7)


def test_chunked_moe_bf16_and_its_f32_twin(monkeypatch):
    """In bf16, chunked experts equal the whole product within one bf16
    rounding; the f32 twin on the bf16 weights (``einsum`` widens them a
    chunk at a time) equals the twin on weights widened beforehand,
    bitwise: phases 7b and 7c of chip_smoke.py hold every bf16 MoE
    against its f32 twin this way (llama4's 128 widened experts would
    not fit the card)."""
    rng = np.random.default_rng(11)
    E, D, F = 8, 32, 48
    _, tp = _moe_params(rng, E, D, F, gated=True)
    p16 = {k: (v if k == "router" else v.to(torch.bfloat16))
           for k, v in tp.items()}
    x = torch.from_numpy(rng.normal(size=(2, 32, D)).astype(np.float32))
    kw = dict(n_experts=E, top_k=1, activation="silu",
              capacity_factor=float(E), group_size=64)
    whole = _chunked_moe(monkeypatch, x.to(torch.bfloat16), p16, E, **kw)
    for chunk in (1, 3):
        got = _chunked_moe(monkeypatch, x.to(torch.bfloat16), p16, chunk,
                           **kw)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), whole.float().numpy(),
                                   rtol=2 ** -8, atol=1e-5)
    widened = {k: v.float() for k, v in p16.items()}
    for chunk in (1, 3, None):
        twin = _chunked_moe(monkeypatch, x, p16, chunk, **kw)
        assert twin.dtype == torch.float32
        assert torch.equal(twin, _chunked_moe(monkeypatch, x, widened, chunk,
                                              **kw))


def test_moe_chunk_rule_at_full_width():
    """The byte rule: a chunk's widened operands and f32 outputs
    within F32_CHUNK_BYTES.  llama4-maverick (128 experts of 5120 x 2 x
    8192, 20 rows a group at capacity 1.25) runs 4 experts a chunk;
    qwen3-moe-30b-a3b's 128 small experts 95 (two chunks); jamba's 16
    large ones 2."""
    def chunk(name, rows):
        cfg = get_arch(name)
        return L.experts_per_chunk(cfg.n_experts, cfg.d_model,
                                   2 if cfg.gated_mlp else 1, cfg.d_ff, rows)
    assert chunk("llama4-maverick-400b-a17b", 20) == 4
    assert chunk("qwen3-moe-30b-a3b", 160) == 95
    assert chunk("jamba-v0.1-52b", 320) == 2
    cfg = get_arch("llama4-maverick-400b-a17b")
    n = chunk(cfg.name, 20)
    D, F = cfg.d_model, cfg.d_ff
    assert 4 * n * (20 * D + 3 * D * F + 20 * 2 * F + 20 * D) \
        <= L.F32_CHUNK_BYTES < 4 * (n + 1) * (20 * D + 3 * D * F
                                              + 20 * 2 * F + 20 * D)
    assert L.experts_per_chunk(8, 1 << 20, 2, 1 << 20, 1) == 1


def test_model_with_chunked_experts_matches_reference(monkeypatch):
    """The llama4 grouping's reduced model with a byte budget that puts
    3 of its 8 experts in a chunk: forward and prefill + decode against
    the JAX package's, 1e-4 of max|logits|."""
    jcfg, cfg = _configs("llama4-maverick-400b-a17b", **F32_CFG, **NO_DROPS)
    z, D, Fd = 2, cfg.d_model, cfg.d_ff
    # 24 rows: the forward's one group of 2 x 12 tokens at capacity 8.
    monkeypatch.setattr(L, "F32_CHUNK_BYTES",
                        3 * L.expert_bytes(D, z, Fd, 24))
    assert L.experts_per_chunk(cfg.n_experts, D, z, Fd, 24) == 3
    jp, tp = _params(jcfg, cfg, seed=3)
    toks = _tokens(cfg, 2, 12, seed=3)
    want = np.asarray(JM.forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                 remat=False))
    got = M.forward(cfg, tp, {"tokens": torch.from_numpy(toks)})
    assert _rel(got.numpy(), want) < 1e-4
    _, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :11])},
                       cache_len=16)
    _, tc = M.prefill(cfg, tp, {"tokens": torch.from_numpy(toks[:, :11])},
                      cache_len=16)
    jd, _ = JM.decode_step(jcfg, jp, jc, {"tokens": jnp.asarray(toks[:, 11:])})
    td, _ = M.decode_step(cfg, tp, tc, {"tokens": torch.from_numpy(
        toks[:, 11:])})
    assert _rel(td.numpy(), np.asarray(jd)) < 1e-4


# ---------------------------------------------------------------------------
# The unembedding a slice of the vocabulary at a time
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,cols", [("nemotron-4-340b", 100),
                                       ("nemotron-4-340b", 512),
                                       ("minicpm-2b", 77)])
def test_chunked_unembed_matches_reference(monkeypatch, name, cols):
    """``_unembed`` with a byte budget of ``cols`` vocabulary columns a
    slice (100 and 77 divide neither vocabulary of 512; 512 is one
    slice; minicpm's table is tied, so its slices are columns of the
    embedding's transpose): forward and a decode step against the JAX
    package's, 1e-4 of max|logits|."""
    jcfg = dataclasses.replace(jax_get_arch(name, reduced=True), **F32_CFG)
    cfg = dataclasses.replace(get_arch(name, reduced=True), **F32_CFG)
    monkeypatch.setattr(L, "F32_CHUNK_BYTES", 4 * cfg.d_model * cols)
    assert M.vocab_per_chunk(cfg.d_model, cfg.vocab_size) == cols
    jp, tp = _params(jcfg, cfg, seed=5)
    toks = _tokens(cfg, 2, 24, seed=5)
    want = np.asarray(JM.forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                 remat=False))
    got = M.forward(cfg, tp, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got.numpy(), want) < 1e-4
    jd, _ = JM.decode_step(jcfg, jp, JM.init_cache(jcfg, 2, 8),
                           {"tokens": jnp.asarray(toks[:, :1])})
    td, _ = M.decode_step(cfg, tp, M.init_cache(cfg, 2, 8, device="cpu"),
                          {"tokens": torch.from_numpy(toks[:, :1])})
    assert _rel(td.numpy(), np.asarray(jd)) < 1e-4


def test_chunked_unembed_gradient_matches_whole(monkeypatch):
    """Training goes through the sliced unembedding too: the loss and
    every gradient leaf equal the whole product's within f32 rounding
    (1e-5 of each leaf's largest value)."""
    cfg = dataclasses.replace(get_arch("nemotron-4-340b", reduced=True),
                              **F32_CFG)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = _tokens(cfg, 2, 16, seed=6)
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])}

    def grads():
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in params.items() if k != "blocks"}
        loss = M.loss_fn(cfg, {**params, **leaves}, batch)
        loss.backward()
        return loss.item(), {k: v.grad for k, v in leaves.items()}

    loss, want = grads()
    monkeypatch.setattr(L, "F32_CHUNK_BYTES", 4 * cfg.d_model * 100)
    got_loss, got = grads()
    assert abs(got_loss - loss) <= 1e-6 * abs(loss)
    for k, g in want.items():
        assert (got[k] - g).abs().max() <= 1e-5 * g.abs().max(), k
