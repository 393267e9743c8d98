"""Plain float32 decoder: the reference that decides a run's ``correct``.

Written from the configuration's numbers alone, in plain PyTorch; it
imports nothing of the program under test and reads none of its state.
It takes the benchmark's own parameter tensors (drawn from the seed,
the same ones the program is handed) and widens them to float32 a layer
at a time, so it runs at the timed sizes on one card.

The layers follow the decoder the program implements, and so depart
from the published models where the program does (each configuration
file lists them under ``departures``):

* RMSNorm with a scale, ``x * rsqrt(mean(x^2) + eps) * scale``, before
  attention, before the feed-forward layer, and before the unembedding.
* Grouped-query attention: rotary embedding over the whole head, halves
  rotated (``[x1 cos - x2 sin, x2 cos + x1 sin]``, frequencies
  ``theta ** (-2i / hd)``), causal softmax, scale ``hd ** -0.5``; no q/k
  norm, no bias.
* SiLU-gated MLP: ``silu(x W0) * (x W1) W2``.
* Mixture of experts with a capacity: the router's softmax over all
  experts in float32; the top k by descending probability (ties to the
  lower expert id); in each group of ``gs`` tokens of one call (``gs``
  the largest divisor of the call's token count up to the group size),
  each expert keeps its first ``max(int(cf * k * gs / E), 1)`` choices
  in the order token-major, choice-minor, and drops the rest; the kept
  choices add ``p * expert(x)`` with ``p`` the softmax probability (not
  renormalised over the k).  The published models route without a
  capacity; the program's grouping decides which choices drop, so the
  reference is told the program's calls (which tokens went through one
  call, in which order) and groups them as the program does.
* Sequential residual: ``x += attn(norm1(x)); x += ffn(norm2(x))``.

``precision="fp8"`` is the control: every product's operands are
rounded to float8 e4m3 (a scale per row of each operand, along the
contracted dimension) before a float32 product.  The router, which the
configuration states in float32, stays float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

F32 = torch.float32
E4M3_MAX = 448.0


@dataclasses.dataclass(frozen=True)
class Sizes:
    """The numbers of one configuration the reference needs."""
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    rope_theta: float
    rms_eps: float
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 2048

    @classmethod
    def from_arch(cls, arch: dict) -> "Sizes":
        return cls(n_layers=arch["n_layers"], d_model=arch["d_model"],
                   n_heads=arch["n_heads"], n_kv_heads=arch["n_kv_heads"],
                   head_dim=arch["head_dim"], d_ff=arch["d_ff"],
                   vocab_size=arch["vocab_size"],
                   rope_theta=float(arch["rope_theta"]),
                   rms_eps=float(arch["rms_eps"]),
                   n_experts=arch.get("n_experts", 0),
                   top_k=arch.get("top_k", 0),
                   capacity_factor=arch.get("capacity_factor", 1.25),
                   moe_group_size=arch.get("moe_group_size", 2048))

    @property
    def moe(self) -> bool:
        return self.n_experts > 0


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (the slice's largest magnitude maps to 448), back in f32."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).to(F32) * s


class _Products:
    """Matrix products in float32, or in the control's float8."""

    def __init__(self, precision: str):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.low = precision == "fp8"

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a (..., K) @ b (K, N)."""
        if self.low:
            a, b = _fp8(a, -1), _fp8(b, 0)
        return a @ b

    def bmm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a (..., M, K) @ b (..., K, N)."""
        if self.low:
            a, b = _fp8(a, -1), _fp8(b, -2)
        return a @ b


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * scale.to(F32)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., L, H, hd), pos (L,): halves rotated by pos * theta^(-2i/hd)."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=F32,
                                       device=x.device) / hd)
    ang = pos.to(F32)[:, None] * inv                       # (L, hd/2)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def group_size(n_tokens: int, cap: int) -> int:
    """The largest divisor of ``n_tokens`` that is at most ``cap``."""
    for d in range(min(cap, n_tokens), 0, -1):
        if n_tokens % d == 0:
            return d
    return 1


def capacity(sz: Sizes, gs: int) -> int:
    return max(int(sz.capacity_factor * sz.top_k * gs / sz.n_experts), 1)


class Decoder:
    """The reference over a set of token sequences.

    ``params`` is the benchmark's parameter tree (``weights.draw``):
    ``embed`` (V, D), ``final_norm`` (D,), ``unembed`` (D, V), and under
    ``blocks/s0`` the layers stacked on a leading axis: ``norm1``,
    ``norm2`` (L, D); ``mixer/wq`` (L, D, H, hd), ``wk``, ``wv`` (L, D,
    KV, hd), ``wo`` (L, H, hd, D); ``ffn/wi`` (L, D, 2, F) and ``wo`` (L,
    F, D), or for experts ``ffn/router`` (L, D, E), ``wi`` (L, E, D, 2,
    F), ``wo`` (L, E, F, D)."""

    def __init__(self, sizes: Sizes, params: dict, precision: str = "f32",
                 attn_bytes: int = 1 << 30):
        self.sz = sizes
        self.p = params
        self.prod = _Products(precision)
        self.attn_bytes = attn_bytes

    # -- one layer -----------------------------------------------------------

    def _attention(self, hn: torch.Tensor, w: dict) -> torch.Tensor:
        """hn (R, L, D) -> (R, L, D): causal GQA within each sequence."""
        sz, mm = self.sz, self.prod
        R, L, D = hn.shape
        H, KV, hd = sz.n_heads, sz.n_kv_heads, sz.head_dim
        g = H // KV
        q = mm.mm(hn, w["wq"].to(F32).reshape(D, H * hd)).view(R, L, H, hd)
        k = mm.mm(hn, w["wk"].to(F32).reshape(D, KV * hd)).view(R, L, KV, hd)
        v = mm.mm(hn, w["wv"].to(F32).reshape(D, KV * hd)).view(R, L, KV, hd)
        pos = torch.arange(L, device=hn.device)
        q = rope(q, pos, sz.rope_theta).view(R, L, KV, g, hd)
        k = rope(k, pos, sz.rope_theta)
        q = q.permute(0, 2, 3, 1, 4)                     # (R, KV, g, L, hd)
        kt = k.permute(0, 2, 3, 1)                       # (R, KV, hd, L)
        vv = v.permute(0, 2, 1, 3)                       # (R, KV, L, hd)
        o = torch.empty((R, KV, g, L, hd), dtype=F32, device=hn.device)
        scale = hd ** -0.5
        # Blocks of sequences and of queries, each block's scores within
        # ``attn_bytes``; a block of queries ending at q1 reads keys < q1.
        per_row = H * L * 4
        qb = max(1, min(L, self.attn_bytes // per_row))
        rb = max(1, self.attn_bytes // (per_row * qb))
        for r0 in range(0, R, rb):
            r1 = min(R, r0 + rb)
            for q0 in range(0, L, qb):
                q1 = min(L, q0 + qb)
                s = mm.bmm(q[r0:r1, :, :, q0:q1],
                           kt[r0:r1, :, None, :, :q1]) * scale
                qi = torch.arange(q0, q1, device=hn.device)[:, None]
                ki = torch.arange(q1, device=hn.device)[None, :]
                s = s.masked_fill(ki > qi, float("-inf"))
                pr = torch.softmax(s, dim=-1)
                o[r0:r1, :, :, q0:q1] = mm.bmm(pr, vv[r0:r1, :, None, :q1])
        o = o.permute(0, 3, 1, 2, 4).reshape(R, L, H * hd)
        return mm.mm(o, w["wo"].to(F32).reshape(H * hd, D))

    def _mlp(self, x: torch.Tensor, w: dict, rows: int = 8192):
        """x (N, D) -> (N, D), a block of rows at a time."""
        mm = self.prod
        D, F_ = self.sz.d_model, self.sz.d_ff
        wi = w["wi"].to(F32).reshape(D, 2 * F_)
        wo = w["wo"].to(F32)
        out = torch.empty_like(x)
        for r0 in range(0, x.shape[0], rows):
            h = mm.mm(x[r0:r0 + rows], wi)
            out[r0:r0 + rows] = mm.mm(F.silu(h[:, :F_]) * h[:, F_:], wo)
        return out

    def _moe(self, x: torch.Tensor, w: dict,
             calls: Sequence[torch.Tensor]) -> torch.Tensor:
        """x (N, D) -> (N, D): each call's tokens (indices into x, in the
        program's order) routed in groups as the program groups them."""
        sz, mm = self.sz, self.prod
        E, K, D, F_ = sz.n_experts, sz.top_k, sz.d_model, sz.d_ff
        probs = torch.softmax(x @ w["router"].to(F32), dim=-1)  # (N, E)
        by_gs: dict = {}
        for c in calls:
            gs = group_size(len(c), sz.moe_group_size)
            by_gs.setdefault(gs, []).append(c.view(-1, gs))
        tok_l, exp_l, gate_l = [], [], []
        for gs, parts in by_gs.items():
            idx = torch.cat(parts)                             # (G, gs)
            pv, pe = torch.sort(probs[idx], dim=-1, descending=True,
                                stable=True)
            pv, pe = pv[..., :K], pe[..., :K]                  # (G, gs, K)
            flat = pe.reshape(idx.shape[0], gs * K)
            onehot = F.one_hot(flat, E).to(torch.int32)
            rank = (torch.cumsum(onehot, dim=1, dtype=torch.int32)
                    * onehot).sum(-1) - 1                      # (G, gs*K)
            keep = (rank < capacity(sz, gs)).view(-1)
            tok_l.append(idx[..., None].expand(-1, -1, K).reshape(-1)[keep])
            exp_l.append(pe.reshape(-1)[keep])
            gate_l.append(pv.reshape(-1)[keep])
        tok, exp, gate = (torch.cat(t) for t in (tok_l, exp_l, gate_l))
        order = torch.argsort(exp, stable=True)
        tok, exp, gate = tok[order], exp[order], gate[order]
        counts = torch.bincount(exp, minlength=E).tolist()
        out = torch.zeros_like(x)
        start = 0
        for e, n in enumerate(counts):
            if n == 0:
                continue
            t, gt = tok[start:start + n], gate[start:start + n]
            start += n
            h = mm.mm(x[t], w["wi"][e].to(F32).reshape(D, 2 * F_))
            y = mm.mm(F.silu(h[:, :F_]) * h[:, F_:], w["wo"][e].to(F32))
            out.index_add_(0, t, y * gt[:, None])
        return out

    # -- the whole model -----------------------------------------------------

    def logits(self, seqs: Sequence[torch.Tensor],
               rows: Sequence[tuple[int, int]],
               calls: Optional[Sequence[Sequence[tuple[int, int]]]] = None
               ) -> torch.Tensor:
        """The float32 logits (len(rows), V) of ``rows`` ((sequence,
        position) pairs), each position predicting the next token.

        ``seqs`` are 1-D token tensors on the parameters' device.  For a
        model with experts, ``calls`` lists every call the program made
        over these tokens, each as its (sequence, position) pairs in the
        program's order; every token of every sequence is in one call."""
        sz, blocks = self.sz, self.p["blocks"]["s0"]
        dev = self.p["embed"].device
        R, L = len(seqs), max(len(s) for s in seqs)
        tokens = torch.zeros((R, L), dtype=torch.long, device=dev)
        for i, s in enumerate(seqs):
            tokens[i, :len(s)] = s.to(dev)
        flat = None
        if sz.moe:
            if calls is None:
                raise ValueError("a model with experts needs the calls")
            flat = [torch.tensor([r * L + p for r, p in c], device=dev)
                    for c in calls]
        x = self.p["embed"][tokens].to(F32)                    # (R, L, D)
        for li in range(sz.n_layers):
            w = {k: (v[li] if not isinstance(v, dict)
                     else {kk: vv[li] for kk, vv in v.items()})
                 for k, v in blocks.items()}
            hn = rms_norm(x, w["norm1"], sz.rms_eps)
            x = x + self._attention(hn, w["mixer"])
            hn = rms_norm(x, w["norm2"], sz.rms_eps).view(R * L, -1)
            if sz.moe:
                x = x + self._moe(hn, w["ffn"], flat).view(R, L, -1)
            else:
                x = x + self._mlp(hn, w["ffn"]).view(R, L, -1)
        idx = torch.tensor([r * L + p for r, p in rows], device=dev)
        h = rms_norm(x.view(R * L, -1)[idx], self.p["final_norm"],
                     sz.rms_eps)
        return self.prod.mm(h, self.p["unembed"].to(F32))


def row_err(prog: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per row, the widest gap between the program's and the
    reference's logits, over the root mean square of the reference's."""
    rms = math.sqrt(float((ref * ref).mean()))
    return (prog.to(F32) - ref).abs().amax(dim=-1) / rms


def logit_err(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest of :func:`row_err` over the rows."""
    return float(row_err(prog, ref).max())
