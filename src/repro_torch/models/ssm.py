"""State-space + linear-attention mixers: Mamba (Jamba) and RWKV-6.

Port of ``repro/models/ssm.py``, with the same O(T) parallel forms:
  * Mamba: selective scan, chunked; within a chunk the JAX package's
    ``jax.lax.associative_scan`` (the same odd/even recursion, so the
    same combine tree), across chunks a loop carrying the state.  The
    decay ``a = exp(dt * A)`` reaches 0 in f32 over a long chunk, so the
    scan multiplies decays and never divides by a cumulative product.
  * RWKV-6 (Finch): data-dependent per-channel decay.  Training/prefill
    use a chunked scan (carry = (H, dk, dv) state per chunk); decode is
    the same function at ``chunk=1``.  The chunked form divides by the
    within-chunk decay, which the clip of the log decay to [-8, 1] and
    ``chunk <= 32`` keep inside f32's range.

Decode paths carry explicit state dicts (the SSM equivalent of a KV
cache): conv tail + ssm state for Mamba; token-shift + wkv state for
RWKV-6.  Dtypes follow the JAX package step for step (``L.einsum`` with
its ``preferred_element_type``).  ``softplus`` is ``jax.nn.softplus``'s
``logaddexp(x, 0)``; ``torch.nn.functional.softplus`` would switch to
the identity above 20, a difference below f32's resolution there.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.layers import einsum

F32 = torch.float32


def _chunks_of(T: int, chunk: int) -> tuple[int, int]:
    """(n_chunks, chunk_len) with chunk_len the largest divisor of T that
    is <= chunk (power-of-2 T gives exactly ``chunk``)."""
    ck = min(chunk, T)
    while T % ck:
        ck -= 1
    return T // ck, ck


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------

def _causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x (B, T, Di), w (Di, K), b (Di,)."""
    K, T = w.shape[1], x.shape[1]
    # along the sequence, which no layout shards (see model.prefill)
    pads = L.same_local(lambda t: F.pad(t, (0, 0, K - 1, 0)), x)
    out = torch.zeros(x.shape, dtype=F32, device=x.device)
    for j in range(K):                       # K is tiny (4): unrolled taps
        out = out + pads[:, j:j + T].to(F32) * w[:, j].to(F32)
    return (out + b.to(F32)).to(x.dtype)


def _scan_combine(left, right):
    return right[0] * left[0], right[0] * left[1] + right[1]


def _associative_scan(elems: tuple) -> tuple:
    """``jax.lax.associative_scan(combine, elems, axis=1)`` for the
    linear recurrence's combine ``(l, r) -> (r_a * l_a, r_a * l_b +
    r_b)``: JAX's recursion (combine adjacent pairs, scan those, combine
    again into the even positions, interleave), so each output is the
    same product of the same factors."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    odd = _associative_scan(_scan_combine(
        tuple(e[:, 0:n - 1:2] for e in elems),
        tuple(e[:, 1::2] for e in elems)))
    if n % 2 == 0:
        even = _scan_combine(tuple(e[:, :-1] for e in odd),
                             tuple(e[:, 2::2] for e in elems))
    else:
        even = _scan_combine(odd, tuple(e[:, 2::2] for e in elems))
    out = []
    for e, ev, od in zip(elems, even, odd):
        r = torch.empty_like(e)
        r[:, 0] = e[:, 0]
        r[:, 2::2] = ev
        r[:, 1::2] = od
        out.append(r)
    return tuple(out)


def _selective_scan(a: torch.Tensor, bx: torch.Tensor,
                    chunk: int) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + bx_t over (B, T, Di, S) from h_{-1} = 0:
    chunks of the associative scan, the state carried across them."""
    B, T = a.shape[:2]
    n_chunks, ck = _chunks_of(T, chunk)
    h0 = torch.zeros((B,) + tuple(a.shape[2:]), dtype=F32, device=a.device)
    hs = []
    for c in range(n_chunks):
        # within-chunk associative scan; fold in the carried state
        aa, hh = _associative_scan((a[:, c * ck:(c + 1) * ck],
                                    bx[:, c * ck:(c + 1) * ck]))
        hh = hh + aa * h0[:, None]
        h0 = hh[:, -1]
        hs.append(hh)
    return torch.cat(hs, dim=1)                              # (B,T,Di,S)


def _selective_scan_chunks_together(a: torch.Tensor, bx: torch.Tensor,
                                    chunk: int) -> torch.Tensor:
    """:func:`_selective_scan` with every chunk's associative scan run at
    once (a chunk axis folded into the batch) and only the carried state
    stepped chunk by chunk: each element sees the same operations in
    the same order, so the values are bitwise the loop's."""
    B, T = a.shape[:2]
    n_chunks, ck = _chunks_of(T, chunk)
    rest = tuple(a.shape[2:])
    aa, hh = _associative_scan((a.reshape(B * n_chunks, ck, *rest),
                                bx.reshape(B * n_chunks, ck, *rest)))
    aa = aa.reshape(B, n_chunks, ck, *rest)
    hh = hh.reshape(B, n_chunks, ck, *rest)
    h0 = torch.zeros((B,) + rest, dtype=F32, device=a.device)
    carry = []
    for c in range(n_chunks):
        carry.append(h0)
        h0 = hh[:, c, -1] + aa[:, c, -1] * h0
    h = hh + aa * torch.stack(carry, dim=1)[:, :, None]
    return h.reshape(B, T, *rest)


def mamba_train(x: torch.Tensor, p: dict, *, d_state: int,
                chunk: int = 256, return_state: bool = False):
    """Mamba mixer over a full sequence.

    p: in_proj (D, 2*Di), conv_w (Di, K), conv_b (Di,),
       x_proj (Di, R+2*S), dt_proj (R, Di), dt_bias (Di,),
       A_log (Di, S), D (Di,), out_proj (Di, D).
    """
    B, T, _ = x.shape
    xz = einsum("btd,de->bte", x, p["in_proj"], F32).to(x.dtype)
    x1_raw, z = torch.chunk(xz, 2, dim=-1)                  # (B, T, Di)
    x1 = F.silu(_causal_conv1d(x1_raw, p["conv_w"], p["conv_b"]).to(F32)
                ).to(x.dtype)
    R = p["dt_proj"].shape[0]
    xdb = einsum("bti,ie->bte", x1, p["x_proj"], F32)      # (B,T,R+2S)
    dt_r, B_ssm, C_ssm = torch.tensor_split(xdb, [R, R + d_state], dim=-1)
    dt = _softplus(einsum("btr,ri->bti", dt_r, p["dt_proj"], F32)
                   + p["dt_bias"].to(F32))
    A = -torch.exp(p["A_log"].to(F32))                      # (Di, S)

    a = torch.exp(dt[..., None] * A)                        # (B,T,Di,S)
    bx = (dt * x1.to(F32))[..., None] * B_ssm[:, :, None, :]

    if L.is_dtensor(a):
        # Independent per (batch, channel, state): shard by shard, the
        # chunks scanned together (bitwise the loop's values, with a
        # few hundred ops in place of ~600 a chunk).
        h = L.same_local(
            lambda a, bx: _selective_scan_chunks_together(a, bx, chunk),
            a, bx)
    else:
        h = _selective_scan(a, bx, chunk)
    h0 = h[:, -1]                                            # (B,Di,S)
    y = einsum("btis,bts->bti", h, C_ssm, F32)
    y = y + p["D"].to(F32) * x1.to(F32)
    y = (y * F.silu(z.to(F32))).to(x.dtype)
    out = einsum("bti,id->btd", y, p["out_proj"], F32).to(x.dtype)
    if return_state:
        K = p["conv_w"].shape[1]
        tail = (x1_raw[:, T - (K - 1):] if T >= K - 1
                else L.same_local(
                    lambda t: F.pad(t, (0, 0, K - 1 - T, 0)), x1_raw))
        return out, {"conv": tail, "ssm": h0}
    return out


def mamba_init_state(cfg_d_inner: int, d_state: int, d_conv: int, B: int,
                     dtype, device=None) -> dict:
    return {
        "conv": torch.zeros((B, d_conv - 1, cfg_d_inner), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((B, cfg_d_inner, d_state), dtype=F32,
                           device=device),
    }


def mamba_decode(x: torch.Tensor, state: dict, p: dict, *,
                 d_state: int) -> tuple[torch.Tensor, dict]:
    """One-token Mamba step. x (B, 1, D)."""
    xz = einsum("btd,de->bte", x, p["in_proj"], F32).to(x.dtype)
    x1, z = torch.chunk(xz[:, 0], 2, dim=-1)                 # (B, Di)
    # conv over [state, new]
    window = torch.cat([state["conv"], x1[:, None]], dim=1)  # (B,K,Di)
    x1c = einsum("bki,ik->bi", window.to(F32), p["conv_w"], F32) \
        + p["conv_b"].to(F32)
    x1c = F.silu(x1c).to(x.dtype)
    R = p["dt_proj"].shape[0]
    xdb = einsum("bi,ie->be", x1c, p["x_proj"], F32)
    dt_r, B_ssm, C_ssm = torch.tensor_split(xdb, [R, R + d_state], dim=-1)
    dt = _softplus(einsum("br,ri->bi", dt_r, p["dt_proj"], F32)
                   + p["dt_bias"].to(F32))
    A = -torch.exp(p["A_log"].to(F32))
    a = torch.exp(dt[..., None] * A[None])                   # (B,Di,S)
    bx = (dt * x1c.to(F32))[..., None] * B_ssm[:, None, :]
    h = a * state["ssm"] + bx
    y = einsum("bis,bs->bi", h, C_ssm, F32)
    y = y + p["D"].to(F32) * x1c.to(F32)
    y = (y * F.silu(z.to(F32))).to(x.dtype)
    out = einsum("bi,id->bd", y, p["out_proj"], F32).to(x.dtype)
    return out[:, None], {"conv": window[:, 1:], "ssm": h}


# ---------------------------------------------------------------------------
# RWKV-6 (Finch)
# ---------------------------------------------------------------------------

def _token_shift(x: torch.Tensor,
                 prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """xx[t] = x[t-1] (zeros or carried state at t=0). x (B,T,D)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1)


def _ddlerp(x, xx, mu, lora_a, lora_b):
    """Data-dependent token-shift interpolation (RWKV-6 ddlerp)."""
    base = x + (xx - x) * mu.to(x.dtype)
    m = einsum("btd,dr->btr", base, lora_a, F32)
    m = einsum("btr,rd->btd", torch.tanh(m), lora_b, F32).to(x.dtype)
    return x + (xx - x) * (mu.to(x.dtype) + m)


def rwkv6_time_mix(x: torch.Tensor, p: dict, *, head_dim: int,
                   chunk: int = 32, state: Optional[dict] = None,
                   return_state: bool = False):
    """RWKV-6 time mixing over a sequence (chunked recurrence).

    p: mu_{r,k,v,w,g} (D,), lora_a_* (D,R), lora_b_* (R,D),
       w0 (D,), wr/wk/wv/wg (D,D), wo (D,D), u (H, dk),
       ln_scale (D,) — per-head group norm scale.
    """
    B, T, D = x.shape
    H = D // head_dim
    prev = state["shift"] if state is not None else None
    xx = _token_shift(x, prev)

    xr = _ddlerp(x, xx, p["mu_r"], p["lora_a_r"], p["lora_b_r"])
    xk = _ddlerp(x, xx, p["mu_k"], p["lora_a_k"], p["lora_b_k"])
    xv = _ddlerp(x, xx, p["mu_v"], p["lora_a_v"], p["lora_b_v"])
    xw = _ddlerp(x, xx, p["mu_w"], p["lora_a_w"], p["lora_b_w"])
    xg = _ddlerp(x, xx, p["mu_g"], p["lora_a_g"], p["lora_b_g"])

    r = einsum("btd,de->bte", xr, p["wr"], F32)
    k = einsum("btd,de->bte", xk, p["wk"], F32)
    v = einsum("btd,de->bte", xv, p["wv"], F32)
    g = F.silu(einsum("btd,de->bte", xg, p["wg"], F32))
    # data-dependent decay (per channel), kept in log space
    lw = p["w0"].to(F32) + einsum(
        "btr,rd->btd",
        torch.tanh(einsum("btd,dr->btr", xw, p["lora_a_w2"], F32)),
        p["lora_b_w2"], F32)
    # Clamp so exp(-cumsum(logw)) stays inside f32 range for chunk <= 32
    # (the chunked form divides by within-chunk decay).
    logw = -torch.exp(torch.clamp(lw, -8.0, 1.0))           # log decay < 0

    # The recurrence is independent per (batch, head): DTensors run it
    # shard by shard, batch-sharded, heads whole (40 heads of rwkv6-3b
    # do not divide a 16-wide 'model' axis).
    o, S = L.batch_local(
        lambda r, k, v, logw, S, u: _wkv(r, k, v, logw, S, u, head_dim,
                                         chunk),
        [r, k, v, logw, state["wkv"] if state is not None else None],
        [p["u"]])
    o = o * p["ln_scale"].to(F32)
    o = (o * g).to(x.dtype)
    out = einsum("btd,de->bte", o, p["wo"], F32).to(x.dtype)
    if return_state:
        return out, {"shift": x[:, -1:], "wkv": S}
    return out


def _wkv(r, k, v, logw, S, u, head_dim: int, chunk: int):
    """The chunked WKV recurrence of (B, T, D) r, k, v and log decays
    from the state S (B, H, dk, dv; zeros when None), with the bonus u
    (H, dk), then the per-head group norm: (o (B, T, D), S at the end)."""
    B, T, D = r.shape
    H = D // head_dim
    r = r.reshape(B, T, H, head_dim)
    k = k.reshape(B, T, H, head_dim)
    v = v.reshape(B, T, H, head_dim)
    logw = logw.reshape(B, T, H, head_dim)
    u = u.to(F32)                                            # (H, dk)

    n_chunks, ck = _chunks_of(T, chunk)
    ti = torch.arange(ck, device=r.device)[:, None]
    si = torch.arange(ck, device=r.device)[None, :]
    below = si < ti
    if S is None:
        S = torch.zeros((B, H, head_dim, head_dim), dtype=F32,
                        device=r.device)
    os_ = []
    for c in range(n_chunks):
        sl = slice(c * ck, (c + 1) * ck)
        rr, kk, vv, ww = r[:, sl], k[:, sl], v[:, sl], logw[:, sl]
        cw = torch.cumsum(ww, dim=1)            # inclusive log-decay prefix
        # Contribution of the pre-chunk state S to o_t:
        # r_t . (diag(exp(cw_{t-1})) S) with cw_{t-1} = cw_t - ww_t.
        decay_in = torch.exp(cw - ww)           # (B, ck, H, dk)
        qd = rr * decay_in                      # (B,t,H,dk)
        o_inter = einsum("bthk,bhkv->bthv", qd, S, F32)
        # intra-chunk: pairwise decays exp(cw_{t-1} - cw_s) for s < t,
        # bonus u at s == t.
        kd = kk * torch.exp(-cw)                # (B,s,H,dk)
        att = einsum("bthk,bshk->bhts", qd, kd, F32)
        att = torch.where(below, att, 0.0)
        bonus = einsum("bthk,bthk->bth", rr, u[None, None] * kk, F32)
        o_intra = einsum("bhts,bshv->bthv", att, vv, F32)
        o_intra = o_intra + bonus[..., None] * vv
        # state update to end of chunk: S' = diag(exp(cw_L)) S +
        #   sum_s exp(cw_L - cw_s) k_s v_s^T
        cw_last = cw[:, -1:]                     # (B,1,H,dk)
        S = torch.exp(cw_last[:, 0])[..., None] * S \
            + einsum("bshk,bshv->bhkv", kk * torch.exp(cw_last - cw), vv,
                     F32)
        os_.append(o_inter + o_intra)
    o = torch.cat(os_, dim=1)                    # (B, T, H, dk)

    # per-head group norm, then gate and output projection
    mean = torch.mean(o, dim=-1, keepdim=True)
    var = torch.var(o, dim=-1, keepdim=True, correction=0)
    o = (o - mean) * torch.rsqrt(var + 64e-5)
    return o.reshape(B, T, D), S


def rwkv6_time_mix_decode(x: torch.Tensor, state: dict, p: dict, *,
                          head_dim: int) -> tuple[torch.Tensor, dict]:
    """Single-token RWKV-6 step (recurrent form). x (B, 1, D)."""
    return rwkv6_time_mix(x, p, head_dim=head_dim, chunk=1, state=state,
                          return_state=True)


def rwkv6_channel_mix(x: torch.Tensor, p: dict,
                      state: Optional[dict] = None,
                      return_state: bool = False):
    """RWKV-6 channel mix: r = sigmoid(Wr xr); k = relu(Wk xk)^2;
    out = r * (Wv k). p: mu_r, mu_k (D,), wr (D,D), wk (D,F), wv (F,D)."""
    prev = state["shift"] if state is not None else None
    xx = _token_shift(x, prev)
    xr = x + (xx - x) * p["mu_r"].to(x.dtype)
    xk = x + (xx - x) * p["mu_k"].to(x.dtype)
    r = torch.sigmoid(einsum("btd,de->bte", xr, p["wr"], F32))
    k = torch.square(F.relu(einsum("btd,df->btf", xk, p["wk"], F32)))
    out = r * einsum("btf,fd->btd", k.to(x.dtype), p["wv"], F32)
    out = out.to(x.dtype)
    if return_state:
        return out, {"shift": x[:, -1:]}
    return out


def rwkv6_init_state(B: int, D: int, head_dim: int, dtype,
                     device=None) -> dict:
    H = D // head_dim
    return {
        "time": {"shift": torch.zeros((B, 1, D), dtype=dtype,
                                      device=device),
                 "wkv": torch.zeros((B, H, head_dim, head_dim), dtype=F32,
                                    device=device)},
        "channel": {"shift": torch.zeros((B, 1, D), dtype=dtype,
                                         device=device)},
    }
