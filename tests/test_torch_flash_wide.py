"""The wide flash kernels' arithmetic (head_dims above 256) emulated on
the CPU and held to the reference's kernel and oracle.

``csrc/flash_attention_wide.cu`` (bf16, f16) and
``csrc/flash_attention_wide_f32.cu`` (f32) run on the card only; this file
repeats what they compute, in f32 on the CPU (``_emulate_wide``): the
head_dim zero-padded to 16-byte rows, the output columns cut into chunks
by ``flash_attention.wide_plan``, per chunk and key tile S = q k^T summed
over head_dim slices and scaled by hd^-0.5 after the product, the online
softmax per key tile, and P.V with P split into hi and lo (bf16; f16
after scaling p by 2^15), or, in f32, each operand split into a TF32 hi
(rounded to nearest) and a lo that the tensor cores read truncated to
TF32, three products a pair of operands.  The same numpy inputs go
through ``repro.kernels.ops.flash_attention`` (interpret mode) and the
reference's oracle ``repro.kernels.ref.flash_attention_ref`` on their f32
values.  Gates: one rounding of each dtype from the oracle (rtol 2^-8 in
bf16 and 2^-11 in f16, each with atol 1e-5; 2e-5 in f32) and two from the
reference kernel's output (itself one rounding from its f32 result).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import ref as port_ref

DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16,
          "float32": torch.float32}
#: (rtol, atol) of one rounding to each output dtype.
GATE = {torch.float16: (2.0 ** -11, 1e-5), torch.bfloat16: (2.0 ** -8, 1e-5),
        torch.float32: (2e-5, 2e-5)}
#: (keys a tile, head columns a slice) of each kernel.
TILES = {torch.float16: (64, 64), torch.bfloat16: (64, 64),
         torch.float32: (32, 32)}


def _tf32(x: torch.Tensor, rounded: bool) -> torch.Tensor:
    """f32 ``x`` as TF32: rounded to nearest (ties away from zero, the
    kernels' split()) or truncated (how the tensor cores read an f32
    operand)."""
    bits = x.contiguous().view(torch.int32)
    if rounded:
        bits = bits + 0x1000
    return (bits & -0x2000).view(torch.float32)


def _split(x: torch.Tensor, dtype: torch.dtype, scale: float = 1.0):
    """(hi, lo) of ``x * scale`` as the kernels split it, both as the
    tensor cores read them: E(x') and E(x' - hi) in 16 bits; in f32 x
    rounded to TF32 and x - hi truncated to TF32."""
    x = x * scale
    if dtype == torch.float32:
        hi = _tf32(x, rounded=True)
        return hi, _tf32(x - hi, rounded=False)
    hi = x.to(dtype).float()
    return hi, (x - hi).to(dtype).float()


def _emulate_wide(q, k, v, *, causal, split=True):
    """The wide kernels' arithmetic on q, k, v of one dtype, in f32 on
    the CPU; ``split=False`` takes every f32 operand as one TF32 value
    (rounded) and P in one product, the design the f32 kernel does not
    use."""
    dtype = q.dtype
    B, H, T, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    width = -(-hd * q.element_size() // 16) * 16 // q.element_size()
    pad = [0, width - hd]
    qf, kf, vf = (torch.nn.functional.pad(x.float(), pad) for x in (q, k, v))
    kf, vf = (x.repeat_interleave(H // KV, dim=1) for x in (kf, vf))
    key_tile, slice_cols = TILES[dtype]
    p_scale = 2.0 ** 15 if dtype == torch.float16 else 1.0
    n_chunks, cw = flash_mod.wide_plan(hd)
    t = torch.arange(T)[:, None]
    out = torch.zeros((B, H, T, hd))
    for c in range(n_chunks):
        cols = slice(c * cw, min(c * cw + cw, hd))
        m = torch.full((B, H, T, 1), -torch.inf)
        l = torch.zeros((B, H, T, 1))
        acc = torch.zeros((B, H, T, cols.stop - cols.start))
        for k0 in range(0, S, key_tile):
            keys = torch.arange(k0, min(k0 + key_tile, S))
            s = torch.zeros((B, H, T, len(keys)))
            for d0 in range(0, width, slice_cols):
                qs = qf[..., d0:d0 + slice_cols]
                ks = kf[:, :, keys, d0:d0 + slice_cols]
                if dtype != torch.float32:
                    s = s + qs @ ks.transpose(-1, -2)
                elif split:
                    qh, ql = _split(qs, dtype)
                    kh, kl = _split(ks, dtype)
                    s = s + (qh @ kh.transpose(-1, -2)
                             + (ql @ kh.transpose(-1, -2)
                                + qh @ kl.transpose(-1, -2)))
                else:
                    s = s + (_tf32(qs, True)
                             @ _tf32(ks, True).transpose(-1, -2))
            s = s * hd ** -0.5
            if causal:
                s = torch.where(keys[None, :] <= t + (S - T), s, -torch.inf)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            m_use = torch.where(m_new == -torch.inf, 0.0, m_new)
            p = torch.exp(s - m_use)
            corr = torch.exp(m - m_use)
            l = l * corr + p.sum(-1, keepdim=True)
            vt = vf[:, :, keys, cols]
            if dtype != torch.float32:
                ph, pl = _split(p, dtype, p_scale)
                pv = ph @ vt + pl @ vt
            elif split:
                ph, pl = _split(p, dtype)
                vh, vl = _split(vt, dtype)
                pv = pl @ vh + ph @ vl + ph @ vh
            else:
                pv = _tf32(p, True) @ _tf32(vt, True)
            acc = acc * corr + pv
            m = m_new
        out[..., cols] = torch.where(l != 0, acc / (l * p_scale), 0.0)
    return out.to(dtype)


def _inputs(shape, name, seed):
    """q, k, v at ``shape`` (B, H, KV, T, S, hd) in dtype ``name``: the
    same values in JAX and in torch, and the oracle's f32 output."""
    B, H, KV, T, S, hd = shape
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((B, H, T, hd), (B, KV, S, hd), (B, KV, S, hd))]
    js = [jnp.asarray(a, name) for a in arrs]
    ts = [torch.from_numpy(a).to(DTYPES[name]) for a in arrs]
    for j, t in zip(js, ts):
        assert np.array_equal(t.float().numpy(),
                              np.asarray(j.astype(jnp.float32)))
    oracle = np.asarray(jax_ref.flash_attention_ref(
        *(j.astype(jnp.float32) for j in js), causal=True))
    return js, ts, oracle


def _within(got, want, dtype, rounds=1):
    rtol, atol = GATE[dtype]
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=rounds * rtol, atol=rounds * atol)


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("hd", [257, 320, 512, 1024])
def test_wide_arithmetic_meets_each_dtype_gate(hd, name):
    """Causal with T < S, GQA 2:1, at head_dims that take 2, 2, 2 and 4
    chunks (257 zero-padded): the emulated kernel within one rounding of
    the oracle and two of the reference kernel (interpret mode)."""
    shape = (1, 4, 2, 40, 72, hd)
    js, (tq, tk, tv), oracle = _inputs(shape, name, hd)
    got = _emulate_wide(tq, tk, tv, causal=True)
    assert got.dtype == DTYPES[name] and got.shape == (1, 4, 40, hd)
    got = got.float().numpy()
    _within(got, oracle, DTYPES[name])
    pallas = jax_ops.flash_attention(*js, causal=True)
    _within(got, np.asarray(pallas.astype(jnp.float32)), DTYPES[name],
            rounds=2)


@pytest.mark.parametrize("name", list(DTYPES))
def test_wide_rows_with_no_key_are_zero(name):
    """T > S, causal: the first T - S rows see no key and come out as
    exact zeros (l = 0), as the port's plain version writes them (the
    reference's kernel and oracle give such rows other values, each its
    own); the other rows within one rounding of the oracle."""
    _, (tq, tk, tv), oracle = _inputs((1, 2, 1, 90, 50, 320), name, 5)
    got = _emulate_wide(tq, tk, tv, causal=True)
    assert not got[:, :, :40].any()
    plain = port_ref.flash_attention_ref(tq, tk, tv, causal=True)
    _within(got.float().numpy(), plain.numpy(), DTYPES[name])
    _within(got[:, :, 40:].float().numpy(), oracle[:, :, 40:], DTYPES[name])


def test_one_tf32_product_misses_the_f32_gate():
    """Each f32 operand rounded once to TF32 and one product a pair (no
    split): a large share of outputs fall outside the f32 gate (rtol and
    atol 2e-5) at hd 320, where the split products meet it."""
    _, (tq, tk, tv), oracle = _inputs((1, 4, 2, 40, 72, 320), "float32", 3)
    got = _emulate_wide(tq, tk, tv, causal=True, split=False).numpy()
    rtol, atol = GATE[torch.float32]
    outside = np.abs(got - oracle) > atol + rtol * np.abs(oracle)
    assert outside.mean() > 0.5
    _within(_emulate_wide(tq, tk, tv, causal=True).numpy(), oracle,
            torch.float32)


@pytest.mark.parametrize("hd,plan", [
    (257, (2, 160)), (264, (2, 160)), (320, (2, 160)), (384, (2, 192)),
    (512, (2, 256)), (576, (3, 192)), (768, (3, 256)), (1024, (4, 256)),
    (2048, (8, 256)), (2050, (9, 256)), (4096, (16, 256))])
def test_wide_plan(hd, plan):
    """The fewest chunks of at most 256 columns, each a multiple of 32
    wide: every output column in exactly one chunk."""
    n, cw = flash_mod.wide_plan(hd)
    assert (n, cw) == plan
    assert cw % 32 == 0 and cw <= flash_mod.WIDE_MAX_CHUNK
    assert (n - 1) * cw < hd <= n * cw


@pytest.mark.parametrize("hd", [1, 64, 256])
def test_wide_plan_refuses_the_narrow_routes_widths(hd):
    """The plan is the wide kernels' only: head_dims up to MAX_HEAD_DIM
    go to the sm90 routes and have none."""
    with pytest.raises(ValueError):
        flash_mod.wide_plan(hd)
