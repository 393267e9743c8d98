"""The port's flash attention (plain version on the CPU) vs the JAX
package's Pallas kernel (interpret mode) and its oracle.

The same numpy inputs go through ``repro.kernels.ops.flash_attention``,
``repro.kernels.ref.flash_attention_ref`` and the port's
``repro_torch.kernels.ops.flash_attention``; the shapes and tolerances
are those of tests/test_flash_attention.py (rtol/atol 2e-5 in f32, max
error < 0.05 in bf16), and a bf16 output is also held to one bf16
rounding of the oracle's f32 output (rtol 2^-8, atol 1e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import ops

SHAPES = [
    (1, 4, 2, 256, 256, 64, True),
    (2, 8, 2, 128, 384, 64, True),      # S > T (chunked-prefill offset)
    (1, 2, 2, 256, 256, 128, False),
    (1, 12, 4, 384, 384, 192, True),    # nemotron head_dim
    (2, 4, 1, 256, 512, 64, True),      # MQA
    (1, 4, 4, 200, 300, 64, True),      # unaligned lengths
]


def _qkv(B, H, KV, T, S, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, T, hd)).astype(np.float32),
            rng.normal(size=(B, KV, S, hd)).astype(np.float32),
            rng.normal(size=(B, KV, S, hd)).astype(np.float32))


@pytest.mark.parametrize("B,H,KV,T,S,hd,causal", SHAPES)
def test_port_matches_jax_kernel_and_oracle(B, H, KV, T, S, hd, causal):
    q, k, v = _qkv(B, H, KV, T, S, hd, B * 31 + T)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    pallas = np.asarray(jax_ops.flash_attention(jq, jk, jv, causal=causal))
    oracle = np.asarray(jax_ref.flash_attention_ref(jq, jk, jv,
                                                    causal=causal))
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal)
    assert got.dtype == torch.float32 and got.shape == (B, H, T, hd)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=2e-5, atol=2e-5)


def test_bf16_inputs():
    rng = np.random.default_rng(7)
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((1, 4, 128, 64), (1, 2, 128, 64), (1, 2, 128, 64))]
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in arrs)
    want = np.asarray(jax_ref.flash_attention_ref(jq, jk, jv))
    pallas = np.asarray(jax_ops.flash_attention(jq, jk, jv)
                        .astype(jnp.float32))
    # The bf16-rounded inputs, bit for bit: JAX rounds f32 to nearest even
    # as torch does.
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs)
    for t, j in zip((tq, tk, tv), (jq, jk, jv)):
        assert np.array_equal(t.float().numpy(),
                              np.asarray(j.astype(jnp.float32)))
    got = ops.flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - want).max() < 0.05
    assert np.abs(got.float().numpy() - pallas).max() < 0.05
    # Tighter: one bf16 rounding (unit roundoff 2^-8) of the oracle's f32
    # output on the same bf16 values.
    want32 = np.asarray(jax_ref.flash_attention_ref(
        *(j.astype(jnp.float32) for j in (jq, jk, jv))))
    np.testing.assert_allclose(got.float().numpy(), want32, rtol=2 ** -8,
                               atol=1e-5)


@pytest.mark.parametrize("T,S", [(256, 128), (200, 100), (64, 1)])
def test_rows_with_no_key_are_zero(T, S):
    """Causal with T > S: query t sees keys <= t - (T - S), so rows
    t < T - S see none and come out 0 (the JAX kernel gives 0 or a
    block's share of v there, its oracle the mean of v).  Every other
    row matches the JAX oracle."""
    q, k, v = _qkv(1, 4, 2, T, S, 32, T + S)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v)).numpy()
    empty = T - S
    assert not got[:, :, :empty].any()
    oracle = np.asarray(jax_ref.flash_attention_ref(
        *map(jnp.asarray, (q, k, v))))
    np.testing.assert_allclose(got[:, :, empty:], oracle[:, :, empty:],
                               rtol=2e-5, atol=2e-5)


def test_strided_views_and_backends_agree():
    """The attention layer hands over transposed views; ops makes them
    contiguous, and ``backend='ref'`` is the same plain version."""
    q, k, v = _qkv(2, 4, 2, 48, 48, 16, 3)
    tq, tk, tv = (torch.from_numpy(a).transpose(1, 2).contiguous()
                  .transpose(1, 2) for a in (q, k, v))
    assert not tq.is_contiguous()
    got = ops.flash_attention(tq, tk, tv)
    ref = ops.flash_attention(tq, tk, tv, backend="ref")
    assert torch.equal(got, ref)
    np.testing.assert_allclose(
        got.numpy(), flash_mod.flash_attention_ref(
            *map(torch.from_numpy, (q, k, v))).numpy(), rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown backend"):
        ops.flash_attention(tq, tk, tv, backend="pallas")


def test_wrapper_never_runs_plain_version_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel or raises: here
    a meta tensor is refused by the input checks, and nothing launches."""
    before = flash_mod.launches
    q = torch.empty((1, 2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="not cuda"):
        flash_mod.flash_attention(q, q, q)
    assert flash_mod.launches == before


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.bfloat16, 24, "sm90"), (torch.bfloat16, 40, "sm90"),
    (torch.bfloat16, 64, "sm90"), (torch.bfloat16, 128, "sm90"),
    (torch.bfloat16, 160, "sm90"), (torch.bfloat16, 192, "sm90"),
    (torch.bfloat16, 12, "cuda_core"), (torch.bfloat16, 100, "cuda_core"),
    (torch.float32, 160, "cuda_core"), (torch.float32, 64, "cuda_core"),
])
def test_route_rule(dtype, hd, want):
    """bf16 with head_dim % 8 == 0 goes to the tensor-core kernel; f32 and
    any other bf16 head_dim stay on the CUDA-core kernel.  Every
    head_dim of the configs and the JAX tests takes the sm90 route in
    bf16."""
    assert flash_mod.route(dtype, hd) == want


def _emulate_sm90(q, k, v, *, causal, split_p):
    """The sm90 kernel's arithmetic on bf16 inputs, in f32 on the CPU.

    Per 64-key tile: S = q k^T from the raw bf16 values (each product
    exact in f32, f32 sums), scaled by hd^-0.5 afterwards; the online
    softmax in f32 (masked scores -inf, l summed from the f32 p, acc
    rescaled by exp(m_prev - m_new)); P.V with P split into hi = bf16(p)
    and lo = bf16(p - hi), both into the f32 acc (``split_p``), or P
    rounded once to bf16; acc / l rounded to bf16 once.
    """
    B, H, T, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    g = H // KV
    qf = q.float()
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    m = torch.full((B, H, T, 1), -torch.inf)
    l = torch.zeros((B, H, T, 1))
    acc = torch.zeros((B, H, T, hd))
    t = torch.arange(T)[:, None]
    for k0 in range(0, S, 64):
        cols = torch.arange(k0, min(k0 + 64, S))
        s = (qf @ kf[:, :, cols].transpose(-1, -2)) * hd ** -0.5
        if causal:
            s = torch.where(cols[None, :] <= t + (S - T), s, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        m_use = torch.where(m_new == -torch.inf, 0.0, m_new)
        p = torch.exp(s - m_use)
        corr = torch.exp(m - m_use)
        l = l * corr + p.sum(-1, keepdim=True)
        hi = p.bfloat16().float()
        pv = hi @ vf[:, :, cols]
        if split_p:
            pv = pv + (p - hi).bfloat16().float() @ vf[:, :, cols]
        acc = acc * corr + pv
        m = m_new
    return torch.where(l > 0, acc / l, 0.0).bfloat16()


def _stablelm_heads_bf16():
    """stablelm-12b's head shape (hd 160, GQA 4:1) at T = S = 512, as
    bf16 tensors and the JAX oracle's f32 output on the same values."""
    rng = np.random.default_rng(14)
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((1, 8, 512, 160), (1, 2, 512, 160), (1, 2, 512, 160))]
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs)
    want = np.asarray(jax_ref.flash_attention_ref(
        *(jnp.asarray(t.float().numpy()) for t in (tq, tk, tv))))
    return tq, tk, tv, want


def test_sm90_arithmetic_meets_one_bf16_rounding():
    """P split into bf16 hi and lo keeps the kernel's bf16 output within
    one bf16 rounding (rtol 2^-8, atol 1e-5) of the JAX oracle's f32
    output on the same bf16 values."""
    tq, tk, tv, want = _stablelm_heads_bf16()
    got = _emulate_sm90(tq, tk, tv, causal=True, split_p=True)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -8,
                               atol=1e-5)


def test_one_bf16_rounding_of_p_breaks_the_gate():
    """Rounding P once to bf16 before P.V, as FlashAttention-2/3 do on the
    tensor cores, puts a large share of outputs outside that gate: the
    reason the kernel issues P.V twice (hi and lo)."""
    tq, tk, tv, want = _stablelm_heads_bf16()
    got = _emulate_sm90(tq, tk, tv, causal=True, split_p=False)
    outside = np.abs(got.float().numpy() - want) > 1e-5 + 2 ** -8 * np.abs(
        want)
    assert outside.mean() > 0.05
