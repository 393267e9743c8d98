"""The LM's arms under training, the port against the JAX package, on
the CPU (their training steps against the reference's are in
tests/test_torch_train_arms_steps.py).

Gradients across carried state: ``mamba_train`` at (T, chunk) = (512,
256) and (48, 16) and ``rwkv6_time_mix`` at T = 96 (three chunks of
32) and 37 (37 one-step chunks, 37 being prime), the chunks in one
group and two at a time, with RWKV-6's channel mix, against ``jax.grad`` for the input and every weight, within 1e-4
of max|leaf| (as the whole-model gradients of tests/test_torch_train.py).
``layers.moe`` likewise at a capacity factor that drops tokens, whole
and with its expert products a chunk of experts at a time.

Then chip_smoke.py's phase 10b (``phase_train_arms``) on the reduced
configs on the CPU, so that its own code fails here before it fails on
the card, and ``layers.einsum``'s widening under grad, which keeps its
bf16 operands for the backward.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models import ssm as JS
from repro_torch.models import layers as L
from repro_torch.models import ssm as S

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_moe import _params as _moe_params  # noqa: E402
from test_torch_ssm import _mamba_params, _rwkv_params  # noqa: E402

REPO = os.path.join(os.path.dirname(__file__), "..")
GRAD_TOL = 1e-4                 # of max|leaf|, elementwise


def _both(tree: dict) -> tuple:
    """A flat f32 numpy dict -> (jnp dict, torch dict)."""
    tree = {k: np.asarray(v, np.float32) for k, v in tree.items()}
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(v.copy()) for k, v in tree.items()})


def _grads_match(jfn, tfn, params: dict, x: np.ndarray, seed: int):
    """d<fn(x, p), c>/d(x, p) of the port against ``jax.grad`` of the
    reference, for a seeded cotangent c: within GRAD_TOL of max|leaf|."""
    jp, tp = _both(params)
    c = np.random.default_rng(seed).normal(size=x.shape).astype(np.float32)
    jg = jax.jit(jax.grad(lambda x, p: jnp.sum(jfn(x, p) * c),
                          argnums=(0, 1)))(jnp.asarray(x), jp)
    xs = torch.from_numpy(x).requires_grad_(True)
    leaves = {k: v.requires_grad_(True) for k, v in tp.items()}
    got = torch.autograd.grad((tfn(xs, leaves) * torch.from_numpy(c)).sum(),
                              [xs, *leaves.values()])
    want = [jg[0]] + [jg[1][k] for k in leaves]
    for name, a, b in zip(["input", *leaves], got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=GRAD_TOL * np.abs(b).max() + 1e-12,
                                   err_msg=name)


@pytest.mark.parametrize("T,chunk", [(512, 256), (48, 16)])
def test_mamba_gradients_cross_chunks_as_jax_grad(T, chunk):
    """Two chunks of 256 and three of 16: the gradient passes back
    through the state each chunk carries into the next."""
    rng = np.random.default_rng(T)
    p = _mamba_params(rng)
    x = rng.normal(size=(2, T, 32)).astype(np.float32)
    kw = dict(d_state=8, chunk=chunk)
    _grads_match(lambda x, p: JS.mamba_train(x, p, **kw),
                 lambda x, p: S.mamba_train(x, p, **kw), p, x, seed=T)


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("T", [96, 37])
def test_rwkv6_gradients_cross_chunks_as_jax_grad(monkeypatch, T, grouped):
    """The time mix in three chunks of 32 and in 37 one-step chunks,
    then the channel mix on the same input; ``grouped``: the chunks two
    at a time (``layers.F32_CHUNK_BYTES`` set to two chunks' carried
    states), so the state also crosses from group to group."""
    if grouped:
        monkeypatch.setattr(L, "F32_CHUNK_BYTES", 2 * 2 * 4 * 16 * 16 * 4)
        assert L.per_chunk(37, 2 * 4 * 16 * 16 * 4) == 2
    rng = np.random.default_rng(T)
    p, channel = _rwkv_params(rng)
    x = rng.normal(size=(2, T, 64)).astype(np.float32)
    _grads_match(lambda x, p: JS.rwkv6_time_mix(x, p, head_dim=16),
                 lambda x, p: S.rwkv6_time_mix(x, p, head_dim=16), p, x,
                 seed=T)
    _grads_match(JS.rwkv6_channel_mix, S.rwkv6_channel_mix, channel, x,
                 seed=T + 1)


@pytest.mark.parametrize("chunk_experts", [None, 1, 3])
@pytest.mark.parametrize("gated", [True, False])
def test_moe_gradients_with_drops_as_jax_grad(monkeypatch, chunk_experts,
                                              gated):
    """8 experts, top 2, groups of 16 at capacity factor 0.5 (a queue of
    2 an expert: most choices drop), the expert products whole or 1 and
    3 experts a chunk (``layers.F32_CHUNK_BYTES`` set to that many
    experts' bytes)."""
    B, T, D, F, E, K, gs, cf = 2, 32, 16, 24, 8, 2, 16, 0.5
    rng = np.random.default_rng(7 + gated)
    p = _moe_params(rng, E, D, F, gated)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    cap = max(int(cf * K * gs / E), 1)
    z, rows = 2 if gated else 1, B * T // gs * cap
    if chunk_experts:
        monkeypatch.setattr(L, "F32_CHUNK_BYTES",
                            chunk_experts * L.expert_bytes(D, z, F, rows))
        assert L.experts_per_chunk(E, D, z, F, rows) == chunk_experts
    kw = dict(n_experts=E, top_k=K, activation="silu", capacity_factor=cf,
              group_size=gs)
    xg = torch.from_numpy(x).reshape(B * T // gs, gs, D)
    keep = L._route(xg, torch.from_numpy(p["router"]), K, cap)[3]
    assert 0 < int((~keep).sum()) < keep.numel()          # tokens drop
    _grads_match(lambda x, p: JL.moe(x, p, **kw),
                 lambda x, p: L.moe(x, p, **kw), p, x, seed=3)


def test_phase_train_arms_runs_on_the_cpu(tmp_path):
    """chip_smoke.py's phase 10b with ``device="cpu"`` on the reduced
    configs: the Trainer steps of rwkv6, musicgen (embeds) and
    qwen3-moe with their gates (finite, falling losses; no kernel
    launched), jamba's value_and_grad, every sublayer witness and
    rwkv6's whole-model witness (each raises if it fails)."""
    sys.path.insert(0, os.path.abspath(REPO))
    import chip_smoke
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = chip_smoke.phase_train_arms(device="cpu", reduced=True,
                                          root=str(tmp_path))
    finally:
        torch.set_num_threads(threads)
    trained = [a["arch"] for a in chip_smoke.TRAIN_ARMS]
    for arch in trained:
        row = out[arch]
        assert row["n_layers"] < 8 or "jamba" in arch
        assert row["losses"][-1] < row["losses"][0]
        assert not any(row["launches"].values())
        assert sorted(row["witness"]) == sorted(
            [*next(a["witness"] for a in chip_smoke.TRAIN_ARMS
                   if a["arch"] == arch)]
            + (["whole"] if arch == "rwkv6-3b" else []))
    jamba = out[chip_smoke.TRAIN_ARMS_GRAD["arch"]]
    assert all(r["finite"] for r in jamba["runs"].values())
    assert sorted(jamba["witness"]) == ["mamba", "moe"]
    for row in [out[a] for a in trained] + [jamba]:
        for label, wit in row["witness"].items():
            fd = wit["fd"]
            assert max(r["rel"] for r in fd.values()) \
                <= chip_smoke.TRAIN_FD_RTOL, (row["arch"], label)


@pytest.mark.parametrize("readings,ladder,rel", [
    ({1.0: 0.5, 3.0: 0.01, 10.0: 0.03, 0.3: 0.5, 30.0: 0.5, 0.1: 0.5,
      100.0: 0.001, 0.03: 0.5, 0.01: 0.5, 300.0: 0.5, 0.003: 0.5,
      0.001: 0.5, 1000.0: 0.5}, None, 0.03),      # no adjacent pair
    ({1.0: 0.5, 3.0: 0.01, 0.3: 0.5, 10.0: 0.015}, None, 0.015),
    ({1.0: 0.019}, (1.0,), 0.019),                  # phase 10's one e
    ({1.0: 0.021}, (1.0,), 0.021)])
def test_fd_leaf_needs_two_adjacent_steps(readings, ladder, rel):
    """chip_smoke._fd_leaf walks the ladder outward from e and stops at
    the first two adjacent steps that both meet TRAIN_FD_RTOL; one step
    alone (3 e, then 100 e in the first case) passes nothing.  Its
    reading is the larger of the best adjacent pair's."""
    sys.path.insert(0, os.path.abspath(REPO))
    import chip_smoke
    ladder = ladder or chip_smoke.FD_LADDER
    taken = []

    def diff(e: float) -> dict:
        k = min(ladder, key=lambda k: abs(k * chip_smoke.TRAIN_FD_DL / 2.0
                                          - e))
        taken.append(k)
        return {"rel": readings[k]}
    got = chip_smoke._fd_leaf(diff, 2.0, ladder)
    assert got["rel"] == pytest.approx(rel)
    assert sorted(taken) == sorted(readings)        # walked this far
    assert [t["k"] for t in got["tries"]] == sorted(readings)


@pytest.mark.parametrize("eq,sa,sb", [
    ("btd,de->bte", (2, 8, 16), (16, 24)),
    ("bthk,bthk->bth", (2, 8, 3, 4), (2, 8, 3, 4)),
    ("gsec,gsd->gecd", (1, 8, 4, 2), (1, 8, 16)),
    ("bcshk,bcshv->bchkv", (1, 2, 4, 3, 5), (1, 2, 4, 3, 5))])
def test_widening_einsum_keeps_its_bf16_operands(eq, sa, sb):
    """``layers.einsum`` with an f32 output on bf16 operands under grad
    keeps the operands as they came for its backward (no widened copy
    is saved), and its gradients are autograd's of the casts, within
    one bf16 rounding of each operand."""
    gen = torch.Generator().manual_seed(0)
    a, b = (torch.randn(s, generator=gen).to(torch.bfloat16)
            for s in (sa, sb))
    saved = []
    leaves = [t.clone().requires_grad_(True) for t in (a, b)]
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        out = L.einsum(eq, *leaves, torch.float32)
    assert saved and all(t.dtype == torch.bfloat16 for t in saved)
    c = torch.randn(out.shape, generator=gen)
    got = torch.autograd.grad((out * c).sum(), leaves)
    ref = [t.clone().requires_grad_(True) for t in (a, b)]
    want = torch.autograd.grad((torch.einsum(
        eq, ref[0].float(), ref[1].float()) * c).sum(), ref)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g.float(), w.float(), rtol=2 ** -8,
                                   atol=1e-6)
