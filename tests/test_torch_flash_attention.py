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
    # head_dims the kernels take padded (rows of 16 bytes) or at 256,
    # the widest they take: 12 and 100 (not multiples of 8), stablelm's
    # 160 less 4, Gemma-2-9B's 256.
    (1, 4, 2, 200, 300, 12, True),
    (1, 4, 2, 200, 300, 100, True),
    (1, 4, 2, 200, 300, 156, True),
    (1, 4, 2, 200, 300, 256, True),
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
    (torch.bfloat16, 12, "sm90"), (torch.bfloat16, 100, "sm90"),
    (torch.float32, 160, "sm90_f32"), (torch.float32, 64, "sm90_f32"),
    (torch.float32, 192, "sm90_f32"), (torch.float32, 12, "sm90_f32"),
    (torch.float32, 100, "sm90_f32"),
    (torch.bfloat16, 1, "sm90"), (torch.bfloat16, 200, "sm90"),
    (torch.bfloat16, 256, "sm90"), (torch.float32, 1, "sm90_f32"),
    (torch.float32, 200, "sm90_f32"), (torch.float32, 256, "sm90_f32"),
])
def test_route_rule(dtype, hd, want):
    """Every head_dim from 1 to 256 goes to a tensor-core kernel chosen
    by dtype: sm90 in bf16, sm90_f32 (split TF32) in f32.  A head_dim
    whose rows are not a multiple of 16 bytes (12, 100 in bf16) is
    zero-padded by the wrapper first."""
    assert flash_mod.route(dtype, hd) == want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16])
@pytest.mark.parametrize("hd", [257, 512])
def test_route_takes_head_dims_past_256(dtype, hd):
    """A head_dim above 256 goes to the wide kernel in every dtype the
    card takes, as the reference's kernel takes any head_dim; the plain
    version, and so a CPU tensor, takes it too."""
    assert flash_mod.route(dtype, hd) == "wide"
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 1, 8, 8, hd, hd))
    got = flash_mod.flash_attention(q, k, v)
    assert got.shape == (1, 2, 8, hd)
    torch.testing.assert_close(got, flash_mod.flash_attention_ref(q, k, v))


def _emulate_sm90(q, k, v, *, causal, split_p, key_tile=64, scale=None):
    """The sm90 kernel's arithmetic on bf16 inputs, in f32 on the CPU.

    Per key tile (64 keys up to hd 192, 32 above): S = q k^T from the
    raw bf16 values (each product exact in f32, f32 sums), scaled by
    ``scale`` (hd^-0.5 by default) afterwards; the online
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
    scale = hd ** -0.5 if scale is None else scale
    for k0 in range(0, S, key_tile):
        cols = torch.arange(k0, min(k0 + key_tile, S))
        s = (qf @ kf[:, :, cols].transpose(-1, -2)) * scale
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


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as cvt.rna.tf32.f32 rounds a finite f32: add half of TF32's
    last place to the magnitude's bits, then clear the 13 bits TF32 does
    not keep."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    """The kernel's split: hi = x rounded to TF32, lo = x - hi (exact in
    f32), which the tensor cores read truncated to TF32."""
    hi = _tf32(x)
    lo = (x - hi).contiguous().view(torch.int32)
    return hi, (lo & ~0x1FFF).view(torch.float32)


def _emulate_sm90_f32(q, k, v, *, causal, split, key_tile=32, scale=None):
    """The sm90_f32 kernel's arithmetic on f32 inputs, on the CPU.

    Per key tile (32 keys at hd 160, 16 above 160): S from the split-TF32
    product (``_split``), hi.hi and lo.hi + hi.lo summed apart, scaled by
    ``scale`` (hd^-0.5 by default) afterwards; the
    online softmax in f32 (masked scores -inf, l summed from the f32 p,
    acc rescaled by exp(m_prev - m_new)); O += P v, again split; acc / l
    once.  Each product of two TF32 values is exact in f32, so only the
    order of the f32 sums differs from the tensor cores'.  With
    ``split=False`` each product is one TF32 product of the operands
    rounded to TF32.
    """
    B, H, T, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    g = H // KV
    kf = k.repeat_interleave(g, dim=1)
    vf = v.repeat_interleave(g, dim=1)
    qh, ql = _split(q)
    m = torch.full((B, H, T, 1), -torch.inf)
    l = torch.zeros((B, H, T, 1))
    acc = torch.zeros((B, H, T, hd))
    t = torch.arange(T)[:, None]
    scale = hd ** -0.5 if scale is None else scale
    for k0 in range(0, S, key_tile):
        cols = torch.arange(k0, min(k0 + key_tile, S))
        kh, kl = _split(kf[:, :, cols].transpose(-1, -2))
        vh, vl = _split(vf[:, :, cols])
        s = qh @ kh
        if split:
            s = s + (ql @ kh + qh @ kl)
        s = s * scale
        if causal:
            s = torch.where(cols[None, :] <= t + (S - T), s, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        m_use = torch.where(m_new == -torch.inf, 0.0, m_new)
        p = torch.exp(s - m_use)
        corr = torch.exp(m - m_use)
        l = l * corr + p.sum(-1, keepdim=True)
        ph, pl = _split(p)
        pv = ph @ vh
        if split:
            pv = (pl @ vh + ph @ vl) + pv
        acc = acc * corr + pv
        m = m_new
    return torch.where(l > 0, acc / l, 0.0)


def _stablelm_heads_f32():
    """stablelm-12b's head shape (hd 160, GQA 4:1) at T = S = 512 in f32,
    and the JAX oracle's output on the same values."""
    q, k, v = _qkv(1, 8, 2, 512, 512, 160, 24)
    want = np.asarray(jax_ref.flash_attention_ref(
        *map(jnp.asarray, (q, k, v))))
    return (*map(torch.from_numpy, (q, k, v)), want)


def test_tf32_rounding_is_exact_split():
    """hi + lo carries x to within 2^-21 |x| and both are TF32 values
    (the 13 low bits clear); hi is the nearest TF32 value, ties away
    from zero."""
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=4096).astype(np.float32))
    hi, lo = _split(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    assert ((hi - x).abs() <= 2.0 ** -11 * x.abs()).all()
    assert ((hi + lo - x).abs() < 2.0 ** -21 * x.abs()).all()
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert _tf32(tie).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]


def test_split_tf32_arithmetic_meets_f32_gate():
    """Three TF32 products per split product (lo.lo dropped) keep the
    kernel's f32 output within the f32 tolerance (rtol/atol 2e-5) of the
    JAX oracle at stablelm's heads."""
    q, k, v, want = _stablelm_heads_f32()
    got = _emulate_sm90_f32(q, k, v, causal=True, split=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_one_tf32_product_breaks_the_f32_gate():
    """One TF32 product per product, as wgmma or mma.sync take f32 by
    default, puts most outputs outside that gate (0.595 of them here):
    the reason the kernel runs each product three times."""
    q, k, v, want = _stablelm_heads_f32()
    got = _emulate_sm90_f32(q, k, v, causal=True, split=False).numpy()
    outside = np.abs(got - want) > 2e-5 + 2e-5 * np.abs(want)
    assert outside.mean() > 0.5


def _padded(x, width):
    return torch.nn.functional.pad(x, (0, width - x.shape[-1]))


@pytest.mark.parametrize("T,S", [(200, 300), (256, 256), (300, 111)])
def test_padded_head_dim_is_bitwise_the_unpadded_arithmetic(T, S):
    """What the wrapper does for a head_dim whose rows are not a multiple
    of 16 bytes: q, k and v zero-padded (hd 100 -> 104), the kernel run
    at the padded width with the true hd's scale, the first hd columns
    kept.  Zero columns add exact zeros to every score, and split into
    hi = lo = 0, so both kernels' arithmetic gives bitwise the output of
    the unpadded head_dim."""
    q, k, v = map(torch.from_numpy, _qkv(1, 4, 2, T, S, 100, T + S))
    pq, pk, pv = (_padded(x, 104) for x in (q, k, v))
    f32 = _emulate_sm90_f32(q, k, v, causal=True, split=True)
    f32_pad = _emulate_sm90_f32(pq, pk, pv, causal=True, split=True,
                                scale=100 ** -0.5)
    assert torch.equal(f32_pad[..., :100], f32)
    assert not f32_pad[..., 100:].any()
    bq, bk, bv = (x.bfloat16() for x in (q, k, v))
    bf16 = _emulate_sm90(bq, bk, bv, causal=True, split_p=True)
    bf16_pad = _emulate_sm90(*(_padded(x, 104) for x in (bq, bk, bv)),
                             causal=True, split_p=True, scale=100 ** -0.5)
    assert torch.equal(bf16_pad[..., :100], bf16)


def test_kernel_arithmetic_meets_its_gates_at_head_dim_256():
    """At hd 256, the widest head_dim the kernels take, with their tile
    plans there (32-key tiles in bf16, 16 in f32): the bf16 arithmetic
    within one bf16 rounding of the JAX oracle's f32 output on the same
    bf16 values, the split-TF32 arithmetic within 2e-5 of the oracle."""
    q, k, v = _qkv(1, 4, 2, 256, 256, 256, 25)
    want = np.asarray(jax_ref.flash_attention_ref(
        *map(jnp.asarray, (q, k, v))))
    got = _emulate_sm90_f32(*map(torch.from_numpy, (q, k, v)), causal=True,
                            split=True, key_tile=16)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    bq, bk, bv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    want16 = np.asarray(jax_ref.flash_attention_ref(
        *(jnp.asarray(t.float().numpy()) for t in (bq, bk, bv))))
    got16 = _emulate_sm90(bq, bk, bv, causal=True, split_p=True,
                          key_tile=32)
    np.testing.assert_allclose(got16.float().numpy(), want16, rtol=2 ** -8,
                               atol=1e-5)
