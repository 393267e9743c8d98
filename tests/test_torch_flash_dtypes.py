"""flash_attention on every input the reference's kernel takes: f16,
every mix of f16, bf16 and f32, f64, and head_dims above 256.

The reference's kernel (``repro.kernels.flash_attention``) casts each
input to f32 on its own and returns its f32 result in q's dtype; with x64
off ``jnp.asarray`` narrows f64 to f32 first.  The same numpy inputs go
through ``repro.kernels.ops.flash_attention`` (interpret mode), the
reference's oracle ``repro.kernels.ref.flash_attention_ref`` on the f32
values of the same inputs, and the port's ``ops.flash_attention`` (its
plain version on the CPU).  Gates: the output has the reference's dtype;
it lies within one rounding of that dtype of the oracle's f32 output
(rtol 2^-11 in f16 and 2^-8 in bf16, each with atol 1e-5; rtol/atol 2e-5
in f32, tests/test_flash_attention.py's); and within two such roundings
of the reference kernel's own output, itself one rounding from its f32
result.

Also here: the route rule as a table, and the sm90 kernel's f16
arithmetic emulated on the CPU (``_emulate_sm90_f16``): its split of P,
hi = f16(p 2^15) and lo = f16(p 2^15 - hi), meets one f16 rounding; a
single rounding of p does not, nor does the same split without the scale
where p falls in f16's subnormal range.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import ops

DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16,
          "float32": torch.float32}
#: (rtol, atol) of one rounding to each output dtype.
GATE = {torch.float16: (2.0 ** -11, 1e-5), torch.bfloat16: (2.0 ** -8, 1e-5),
        torch.float32: (2e-5, 2e-5)}


def _normal(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _pair(a: np.ndarray, name: str):
    """``a`` rounded to dtype ``name`` in JAX and in torch: the same
    values bit for bit (both round f32 to nearest even)."""
    j = jnp.asarray(a, name)
    t = torch.from_numpy(a).to(DTYPES[name])
    assert np.array_equal(t.float().numpy(), np.asarray(j.astype(jnp.float32)))
    return j, t


def _oracle32(js, causal=True):
    """The reference's oracle on the f32 values of the given inputs."""
    return np.asarray(jax_ref.flash_attention_ref(
        *(j.astype(jnp.float32) for j in js), causal=causal))


def _within(got, want, dtype, rounds=1):
    rtol, atol = GATE[dtype]
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=rounds * rtol, atol=rounds * atol)


def _check(names, shape, seed, causal=True):
    """q, k, v of dtypes ``names`` at ``shape`` (B, H, KV, T, S, hd)
    through the reference's kernel and the port: dtypes and both gates."""
    B, H, KV, T, S, hd = shape
    arrs = _normal(((B, H, T, hd), (B, KV, S, hd), (B, KV, S, hd)), seed)
    js, ts = zip(*(_pair(a, n) for a, n in zip(arrs, names)))
    pallas = jax_ops.flash_attention(*js, causal=causal)
    got = ops.flash_attention(*ts, causal=causal)
    out = DTYPES[names[0]]
    assert str(pallas.dtype) == names[0] and got.dtype == out
    assert got.shape == (B, H, T, hd)
    got = got.float().numpy()
    _within(got, _oracle32(js, causal), out)
    _within(got, np.asarray(pallas.astype(jnp.float32)), out, rounds=2)


@pytest.mark.parametrize("shape,causal", [
    ((1, 4, 2, 256, 256, 64), True),
    ((2, 8, 2, 128, 384, 64), True),       # S > T (chunked-prefill offset)
    ((1, 2, 2, 256, 256, 128), False),
    ((1, 8, 2, 200, 300, 160), True),      # stablelm's heads, unaligned
    ((1, 4, 2, 200, 300, 12), True),       # zero-padded on the card
])
def test_f16_matches_jax_kernel(shape, causal):
    _check(("float16",) * 3, shape, sum(shape), causal)


@pytest.mark.parametrize("names", list(itertools.product(DTYPES, repeat=3)),
                         ids="-".join)
def test_every_mix_of_dtypes_matches_jax_kernel(names):
    """q, k and v each in f16, bf16 or f32: the output is q's dtype, one
    rounding of it from the f32 result on the same values."""
    _check(names, (1, 4, 2, 128, 160, 32), 3)


@pytest.mark.parametrize("which", ["qkv", "q", "kv"])
def test_f64_is_taken_as_f32(which):
    """f64 inputs are narrowed to f32, as ``jnp.asarray`` does with x64
    off in the reference's kernel: an f32 output, within the f32 gate of
    the reference's kernel and oracle (f64 q and f32 k, v, and the
    reverse, as well)."""
    arrs = _normal(((1, 4, 128, 64), (1, 2, 160, 64), (1, 2, 160, 64)), 11)
    arrs64 = [a.astype(np.float64) * (1 + 1e-9) if n in which else a
              for a, n in zip(arrs, "qkv")]
    pallas = jax_ops.flash_attention(*arrs64)
    want = np.asarray(jax_ref.flash_attention_ref(
        *(jnp.asarray(a) for a in arrs64)))
    got = ops.flash_attention(*map(torch.from_numpy, arrs64))
    assert str(pallas.dtype) == "float32" and got.dtype == torch.float32
    _within(got.numpy(), want, torch.float32)
    _within(got.numpy(), np.asarray(pallas), torch.float32)
    assert ops.flash_attention(*map(torch.from_numpy, arrs64),
                               backend="ref").dtype == torch.float32


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("hd", [257, 320, 512])
def test_head_dims_past_256_match_jax_kernel(hd, name):
    """The widths the card serves on the wide route, causal with T < S
    and GQA 2:1, in each of its three dtypes."""
    _check((name,) * 3, (1, 4, 2, 96, 160, hd), hd)


ROUTES = [
    # (q, k, v dtypes), head_dim -> route, the kernel's dtype, output dtype
    (("bfloat16",) * 3, 160, "sm90", "bfloat16", "bfloat16"),
    (("float16",) * 3, 160, "sm90_f16", "float16", "float16"),
    (("float16",) * 3, 12, "sm90_f16", "float16", "float16"),
    (("float16",) * 3, 256, "sm90_f16", "float16", "float16"),
    (("float32",) * 3, 160, "sm90_f32", "float32", "float32"),
    (("float16",) * 3, 257, "wide", "float16", "float16"),
    (("bfloat16",) * 3, 320, "wide", "bfloat16", "bfloat16"),
    (("float32",) * 3, 1024, "wide", "float32", "float32"),
    (("bfloat16", "float32", "float32"), 128, "sm90_f32", "float32",
     "bfloat16"),
    (("float16", "bfloat16", "bfloat16"), 64, "sm90_f32", "float32",
     "float16"),
    (("float32", "float16", "float32"), 320, "wide", "float32", "float32"),
    (("float64",) * 3, 160, "sm90_f32", "float32", "float32"),
    (("float64",) * 3, 512, "wide", "float32", "float32"),
    (("float64", "float16", "float16"), 96, "sm90_f32", "float32",
     "float32"),
]


@pytest.mark.parametrize("names,hd,want,kernel,out", ROUTES)
def test_route_table(names, hd, want, kernel, out):
    """Every input class goes to a kernel: by the common dtype up to hd
    256 (f16 and bf16 to sm90, f32 to split TF32), the wide kernel above;
    a mix of dtypes, or f64, in f32, its output in q's dtype (f32 for
    f64)."""
    q, k, v = (getattr(torch, n) for n in names)
    assert flash_mod.route(q, hd, k, v) == want
    assert flash_mod.kernel_dtype(q, k, v) == getattr(torch, kernel)
    assert flash_mod.out_dtype(q) == getattr(torch, out)


def test_route_refuses_no_head_dim_but_zero():
    assert flash_mod.route(torch.float16, 1) == "sm90_f16"
    assert flash_mod.route(torch.float16, 10 ** 6) == "wide"
    with pytest.raises(ValueError, match="head_dim 0"):
        flash_mod.route(torch.float32, 0)


def test_mixed_inputs_off_the_cpu_reach_the_kernel_checks():
    """Meta tensors of mixed dtypes are cast to the kernel's dtype and
    refused by the input checks (not cuda): nothing launches and the
    plain version never runs off the CPU."""
    before = dict(flash_mod.launches_by_route)
    q = torch.empty((1, 2, 8, 320), device="meta", dtype=torch.float16)
    k = torch.empty((1, 1, 8, 320), device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not cuda"):
        flash_mod.flash_attention(q, k, k)
    assert flash_mod.launches_by_route == before


def _emulate_sm90_f16(q, k, v, *, causal, split, key_tile=64,
                      p_scale=2.0 ** 15):
    """The sm90 kernel's arithmetic on f16 inputs, in f32 on the CPU.

    Per key tile (64 keys up to hd 192, 32 above): S = q k^T from the raw
    f16 values (each product exact in f32, f32 sums), scaled by hd^-0.5
    afterwards; the online softmax in f32 (masked scores -inf, l summed
    from the f32 p, acc rescaled by exp(m_prev - m_new)).  P.V with
    ``split``: "scaled" (the kernel) takes p' = p * ``p_scale`` and puts
    hi = f16(p') and lo = f16(p' - hi) into the f32 acc, and the epilogue
    divides by l * ``p_scale``; "unscaled" the same with no scale;
    "single" rounds p once to f16.  acc / l is rounded to f16 once.
    """
    B, H, T, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    g = H // KV
    qf = q.float()
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    scale_p = p_scale if split == "scaled" else 1.0
    m = torch.full((B, H, T, 1), -torch.inf)
    l = torch.zeros((B, H, T, 1))
    acc = torch.zeros((B, H, T, hd))
    t = torch.arange(T)[:, None]
    for k0 in range(0, S, key_tile):
        cols = torch.arange(k0, min(k0 + key_tile, S))
        s = (qf @ kf[:, :, cols].transpose(-1, -2)) * hd ** -0.5
        if causal:
            s = torch.where(cols[None, :] <= t + (S - T), s, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        m_use = torch.where(m_new == -torch.inf, 0.0, m_new)
        p = torch.exp(s - m_use)
        corr = torch.exp(m - m_use)
        l = l * corr + p.sum(-1, keepdim=True)
        ps = p * scale_p
        hi = ps.half().float()
        pv = hi @ vf[:, :, cols]
        if split != "single":
            pv = pv + (ps - hi).half().float() @ vf[:, :, cols]
        acc = acc * corr + pv
        m = m_new
    return torch.where(l > 0, acc / (l * scale_p), 0.0).half()


def _heads_f16(H, KV, T, hd, seed):
    arrs = _normal(((1, H, T, hd), (1, KV, T, hd), (1, KV, T, hd)), seed)
    js, ts = zip(*(_pair(a, "float16") for a in arrs))
    return ts, _oracle32(js)


@pytest.mark.parametrize("H,KV,T,hd,key_tile", [
    (8, 2, 512, 160, 64),      # stablelm-12b's heads
    (4, 2, 256, 256, 32),      # the widest tensor-core width, its tile
])
def test_sm90_f16_arithmetic_meets_one_f16_rounding(H, KV, T, hd, key_tile):
    """The kernel's f16 arithmetic (P split after scaling by 2^15) keeps
    its output within one f16 rounding (rtol 2^-11, atol 1e-5) of the
    JAX oracle's f32 output on the same f16 values."""
    (tq, tk, tv), want = _heads_f16(H, KV, T, hd, 14)
    got = _emulate_sm90_f16(tq, tk, tv, causal=True, split="scaled",
                            key_tile=key_tile)
    _within(got.float().numpy(), want, torch.float16)
    unscaled = _emulate_sm90_f16(tq, tk, tv, causal=True, split="unscaled",
                                 key_tile=key_tile)
    _within(unscaled.float().numpy(), want, torch.float16)


def test_one_f16_rounding_of_p_breaks_the_gate():
    """Rounding P once to f16 before P.V puts a large share of stablelm's
    head outputs outside that gate (0.12 of them here): the reason the
    kernel issues P.V twice (hi and lo)."""
    (tq, tk, tv), want = _heads_f16(8, 2, 512, 160, 14)
    got = _emulate_sm90_f16(tq, tk, tv, causal=True, split="single")
    rtol, atol = GATE[torch.float16]
    outside = np.abs(got.float().numpy() - want) > atol + rtol * np.abs(want)
    assert outside.mean() > 0.05


def test_f16_split_needs_the_scale_where_p_is_subnormal():
    """Rows where 4095 equal weights p = exp(-10.84) ~ 1.95e-5 sit below
    f16's smallest normal (2^-14) and carry 7 % of the row's sum: there hi
    = f16(p) keeps at most 2^-24 of it and lo = f16(p - hi) rounds to 0,
    so the unscaled split is off by 3.3 f16 roundings (as one rounding of
    p is), while p * 2^15 splits into normal hi and lo and meets the
    gate."""
    S, hd = 4096, 16
    q = torch.zeros(1, 1, 4, hd)
    q[..., 0] = 1.0
    k = torch.zeros(1, 1, S, hd)
    k[0, 0, 1:, 0] = -43.375          # score -43.375 / 4 against key 0's 0
    v = torch.zeros(1, 1, S, hd)
    v[0, 0, 1:] = 1.0
    q, k, v = q.half(), k.half(), v.half()
    want = _oracle32([jnp.asarray(x.float().numpy(), jnp.float16)
                      for x in (q, k, v)], causal=False)
    rtol, atol = GATE[torch.float16]

    def outside(split):
        got = _emulate_sm90_f16(q, k, v, causal=False, split=split)
        return (np.abs(got.float().numpy() - want)
                > atol + rtol * np.abs(want)).mean()

    assert outside("scaled") == 0.0
    assert outside("unscaled") == 1.0
    assert outside("single") == 1.0
