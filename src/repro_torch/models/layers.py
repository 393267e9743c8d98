"""Core layers: RMSNorm, RoPE, GQA attention (train + cached decode), MLPs.

Port of ``repro/models/layers.py`` (``moe`` and the sharding constraints
wait for the MoE slice).  Every dtype step is the JAX package's: where
JAX asks an einsum for ``preferred_element_type=F32`` the port upcasts
both operands and multiplies in f32 (exact for bf16 operands: their
products fit f32, and the sums are f32 as on the TPU), and where it asks
for the activation dtype the port multiplies in that dtype.  RoPE and
the softmax run in f32 and cast back, as there.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops

F32 = torch.float32
NEG_INF = -1e30


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor,
           out: torch.dtype) -> torch.Tensor:
    """``jnp.einsum(eq, a, b, preferred_element_type=out)``: f32 output
    means an f32 product; otherwise the product runs in the operands'
    common dtype and the result is cast to ``out``."""
    dt = F32 if out == F32 else torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt)).to(out)


# ---------------------------------------------------------------------------
# Norms & activations
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.to(F32)).to(x.dtype)


def activation_fn(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":                       # jax.nn.gelu: tanh form
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu2":                      # squared ReLU (nemotron-4)
        return lambda x: torch.square(F.relu(x))
    raise ValueError(f"unknown activation {name!r}")


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=F32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, T, H, hd); positions: (B, T) int32."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)            # (hd/2,)
    angles = positions[..., None].to(F32) * freqs            # (B, T, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

def attention_train(x: torch.Tensor, p: dict, *, n_heads: int, n_kv: int,
                    head_dim: int, theta: float,
                    window: Optional[int] = None,
                    impl: str = "xla") -> torch.Tensor:
    """Full causal (optionally sliding-window) attention.

    x: (B, T, D). p: {'wq','wk','wv','wo'} with
      wq (D, H, hd), wk/wv (D, KV, hd), wo (H, hd, D).
    impl='flash' runs the blocked online-softmax kernel through
    ``kops.flash_attention`` (no sliding window there: a windowed layer
    takes the 'xla' form, as in the JAX package); 'xla' is the plain
    product-and-softmax form.
    """
    B, T, D = x.shape
    pos = torch.arange(T, dtype=torch.int32, device=x.device)
    pos = pos[None].expand(B, T)
    q = einsum("btd,dhk->bthk", x, p["wq"], x.dtype)
    k = einsum("btd,dhk->bthk", x, p["wk"], x.dtype)
    v = einsum("btd,dhk->bthk", x, p["wv"], x.dtype)
    q = apply_rope(q, pos, theta)
    k = apply_rope(k, pos, theta)

    if impl == "flash" and window is None:
        o = kops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=True)
        o = o.transpose(1, 2).to(x.dtype)
        return einsum("bthk,hkd->btd", o, p["wo"], x.dtype)

    g = n_heads // n_kv
    q = q.reshape(B, T, n_kv, g, head_dim)
    scale = head_dim ** -0.5
    logits = einsum("bqhgk,bshk->bhgqs", q, k, F32) * scale
    # logits: (B, KV, g, T, T)
    qi = torch.arange(T, device=x.device)[:, None]
    ki = torch.arange(T, device=x.device)[None, :]
    mask = ki <= qi
    if window is not None:
        mask &= (qi - ki) < window
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    o = einsum("bhgqs,bshk->bqhgk", probs, v, F32)
    o = o.reshape(B, T, n_heads, head_dim).to(x.dtype)
    return einsum("bthk,hkd->btd", o, p["wo"], x.dtype)


def attention_decode(x: torch.Tensor, cache: dict, p: dict, *, n_heads: int,
                     n_kv: int, head_dim: int, theta: float,
                     window: Optional[int] = None
                     ) -> tuple[torch.Tensor, dict]:
    """One-token decode against a KV cache.

    x: (B, 1, D); cache: {'k','v': (B, S, KV, hd), 'pos': (B,) int32}.
    The cache is a ring buffer when ``window`` is set (hybrid long ctx).
    As in the JAX package, the written v cache takes the f32 type of the
    new v row (type promotion), whatever the cache held before.
    """
    B, _, D = x.shape
    S = cache["k"].shape[1]
    pos = cache["pos"]                                  # (B,)
    q = einsum("btd,dhk->bthk", x, p["wq"], F32)
    k = einsum("btd,dhk->bthk", x, p["wk"], F32)
    v = einsum("btd,dhk->bthk", x, p["wv"], F32)
    q = apply_rope(q.to(x.dtype), pos[:, None], theta)
    k = apply_rope(k.to(x.dtype), pos[:, None], theta)

    slot = pos.long() % S                               # ring slot
    oh = F.one_hot(slot, S).to(k.dtype)                 # (B, S)
    k_cache = cache["k"] * (1.0 - oh)[..., None, None] \
        + oh[..., None, None] * k[:, 0][:, None]
    v_cache = cache["v"] * (1.0 - oh)[..., None, None] \
        + oh[..., None, None] * v[:, 0][:, None]

    g = n_heads // n_kv
    qh = q.reshape(B, n_kv, g, head_dim)
    scale = head_dim ** -0.5
    logits = einsum("bhgk,bshk->bhgs", qh, k_cache, F32) * scale
    sidx = torch.arange(S, device=x.device)[None, :]    # (1, S)
    # Absolute position currently held by each ring slot: the largest
    # q <= pos with q % S == slot (negative => never written).
    qpos = pos[:, None] - ((pos[:, None] - sidx) % S)
    valid = qpos >= 0
    if window is not None:
        valid &= (pos[:, None] - qpos) < window
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    o = einsum("bhgs,bshk->bhgk", probs, v_cache, F32)
    o = o.reshape(B, 1, n_heads, head_dim).to(x.dtype)
    out = einsum("bthk,hkd->btd", o, p["wo"], F32).to(x.dtype)
    new_cache = {"k": k_cache, "v": v_cache, "pos": pos + 1}
    return out, new_cache


# ---------------------------------------------------------------------------
# MLP (gated)
# ---------------------------------------------------------------------------

def mlp(x: torch.Tensor, p: dict, activation: str) -> torch.Tensor:
    """MLP. Gated (wi: (D,2,F)): act(x@wi0) * (x@wi1) @ wo.
    Plain (wi: (D,1,F)): act(x@wi0) @ wo — nemotron/granite/musicgen."""
    act = activation_fn(activation)
    h = einsum("btd,dcf->btcf", x, p["wi"], F32)   # f32 into the gate
    if p["wi"].shape[1] == 2:
        h = act(h[:, :, 0]) * h[:, :, 1]
    else:
        h = act(h[:, :, 0])
    return einsum("btf,fd->btd", h.to(x.dtype), p["wo"], x.dtype)
