"""Core layers: RMSNorm, RoPE, GQA attention (train + cached decode),
MLPs, and capacity-based MoE.

Port of ``repro/models/layers.py``.  Every dtype step is the JAX package's: where
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
from torch.profiler import record_function

from repro_torch.kernels import ops as kops

F32 = torch.float32
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# DTensor layouts (the dry run and the Trainer on a device mesh)
# ---------------------------------------------------------------------------
#
# A plain tensor passes these helpers untouched.  A DTensor is laid out
# as FSDP x TP: parameters are gathered over the batch axes ('pod',
# 'data') where they are used and stay sharded over 'model';
# activations are sharded over the batch axes on their first dim and
# replicated over 'model'.  XLA's partitioner picks such layouts itself;
# DTensor propagates whatever its inputs hold, so the model states them.

_BATCH_AXES = ("pod", "data")


def is_dtensor(x) -> bool:
    if type(x) is torch.Tensor or not isinstance(x, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _redistribute(x, placements):
    placements = tuple(placements)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def as_batch(x):
    """A DTensor activation with its first dim sharded over the batch
    axes that divide it ('pod' first, as ``batch_spec``) and every other
    dim replicated; a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    n, out = 1, []
    for name, size in zip(mesh.mesh_dim_names, mesh.shape):
        if name in _BATCH_AXES and x.ndim and x.shape[0] % (n * size) == 0:
            n *= size
            out.append(Shard(0))
        else:
            out.append(Replicate())
    return _redistribute(x, out)


def as_batch_vocab(x):
    """A DTensor (B, T, V) whose last dim stays sharded where it is, and
    whose batch is laid out as :func:`as_batch` lays it out on the other
    mesh dims (nothing else sharded, nothing partial)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    last = x.ndim - 1
    n, out = 1, []
    for name, size, p in zip(mesh.mesh_dim_names, mesh.shape, x.placements):
        if p.is_shard() and p.dim == last:
            out.append(p)
        elif name in _BATCH_AXES and x.shape[0] % (n * size) == 0:
            n *= size
            out.append(Shard(0))
        else:
            out.append(Replicate())
    return _redistribute(_reduce_partial(x), out)


def sharding_dims(x) -> list:
    """(mesh dim, tensor dim) of each mesh dim of more than one rank
    that shards the DTensor ``x`` (a dim of one rank shards nothing)."""
    mesh = x.device_mesh
    return [(i, p.dim) for i, p in enumerate(x.placements)
            if p.is_shard() and mesh.shape[i] > 1]


def replicated(x):
    """A DTensor replicated over the whole mesh; a plain tensor as it
    is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    return _redistribute(x, [Replicate()] * x.device_mesh.ndim)


def gather_param(w):
    """A DTensor parameter gathered over the batch axes (FSDP), still
    sharded over the others; a plain tensor as it is."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate
    return _redistribute(w, [
        Replicate() if name in _BATCH_AXES else pl
        for name, pl in zip(w.device_mesh.mesh_dim_names, w.placements)])


def _mesh_of(tensors):
    return next(t.device_mesh for t in tensors if is_dtensor(t))


def _as_dtensor(x, mesh):
    from torch.distributed.tensor import DTensor, Replicate
    if x is None or is_dtensor(x):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _wrap_local(out, mesh, placements):
    from torch.distributed.tensor import DTensor
    if isinstance(out, (tuple, list)):
        return type(out)(_wrap_local(o, mesh, placements) for o in out)
    if isinstance(out, dict):
        return {k: _wrap_local(v, mesh, placements) for k, v in out.items()}
    if not isinstance(out, torch.Tensor):
        return out
    pl = [p if (not p.is_shard() or p.dim < out.ndim) else None
          for p in placements]
    if None in pl:
        raise ValueError("a local output lacks a sharded dim")
    n = [1] * out.ndim
    for p, size in zip(pl, mesh.shape):
        if p.is_shard():
            n[p.dim] *= size
    shape = torch.Size(d * k for d, k in zip(out.shape, n))
    return DTensor.from_local(out, mesh, pl, run_check=False, shape=shape,
                              stride=_contiguous_stride(shape))


def batch_local(fn, xs, ws=()):
    """``fn(*xs, *ws)`` run shard by shard, for a function that is
    independent along dim 0 of each ``xs`` (the batch, or groups of
    tokens) and reads the ``ws`` (parameters) whole.  DTensor ``xs`` are
    laid out by :func:`as_batch` and the ``ws`` replicated; every
    tensor ``fn`` returns is batch-led and placed like ``xs[0]``.  For
    ops DTensor has no sharding strategy for, and for long chains of
    small ops (the scans) whose sharding propagation would cost more
    than the ops; the result equals the unsharded call's.  Plain
    tensors take ``fn`` as it is."""
    if not any(is_dtensor(t) for t in (*xs, *ws)):
        return fn(*xs, *ws)
    from torch.distributed.tensor import Partial, Replicate
    mesh = _mesh_of((*xs, *ws))
    xs = [as_batch(_as_dtensor(x, mesh)) for x in xs]
    lead = xs[0].placements
    # a parameter read by every batch shard gets a partial gradient
    wgrad = [Partial() if p.is_shard() else Replicate() for p in lead]
    ws = [replicated(_as_dtensor(w, mesh)) for w in ws]
    out = fn(*[None if x is None else x.to_local() for x in xs],
             *[w.to_local(grad_placements=wgrad) for w in ws])
    return _wrap_local(out, mesh, lead)


def same_local(fn, *xs):
    """``fn(*xs)`` run shard by shard for a function that is elementwise
    independent over every dim the first DTensor shards (the others are
    placed alike); its outputs are placed like it.  Plain tensors take
    ``fn`` as it is."""
    if not any(is_dtensor(t) for t in xs):
        return fn(*xs)
    lead = _reduce_partial(xs[0])
    mesh = lead.device_mesh
    xs = [lead] + [_redistribute(_reduce_partial(_as_dtensor(x, mesh)),
                                 lead.placements) for x in xs[1:]]
    return _wrap_local(fn(*[x.to_local() for x in xs]), mesh,
                       lead.placements)


class _RowsInRange(torch.autograd.Function):
    """``table[ids - v0]`` where ``v0 <= ids < v0 + len(table)``, zero
    rows elsewhere; the gradient adds into the table's rows."""

    @staticmethod
    def forward(ctx, ids, table, v0: int):
        inside = (ids >= v0) & (ids < v0 + table.shape[0])
        idx = torch.where(inside, ids - v0, 0)
        ctx.save_for_backward(idx, inside)
        ctx.rows = table.shape[0]
        return table[idx] * inside[..., None].to(table.dtype)

    @staticmethod
    def backward(ctx, grad):
        idx, inside = ctx.saved_tensors
        g = grad * inside[..., None].to(grad.dtype)
        table_grad = torch.zeros((ctx.rows, grad.shape[-1]),
                                 dtype=grad.dtype, device=grad.device)
        table_grad.index_add_(0, idx.reshape(-1),
                              g.reshape(-1, grad.shape[-1]))
        return None, table_grad, None


def embedding_sharded(ids, table):
    """``table[ids]`` for DTensors: ``ids`` laid out by
    :func:`as_batch`, ``table`` (V, D) sharded over its rows or
    replicated on each mesh dim.  Each shard looks up the ids its rows
    hold (zeros elsewhere) and the rows are summed over the row shards:
    DTensor has no strategy for indexing a sharded table, and its
    ``F.embedding`` strategy cannot take a gradient back through a
    reduction.  The same rows."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    ids = as_batch(ids)
    mesh = ids.device_mesh
    table = _redistribute(table, [p if (p.is_shard() and p.dim == 0)
                                  else Replicate() for p in table.placements])
    if not sharding_dims(table):
        # rows whole on every shard: the plain lookup
        grad_pl = [Partial() if (i.is_shard() and mesh.shape[k] > 1)
                   else Replicate()
                   for k, i in enumerate(ids.placements)]
        y = table.to_local(grad_placements=grad_pl)[ids.to_local()]
        return _wrap_local(y, mesh, ids.placements)
    coord = mesh.get_coordinate() or [0] * mesh.ndim
    v0, rows = 0, table.shape[0]
    for i, p in enumerate(table.placements):
        if p.is_shard():
            rows //= mesh.shape[i]
            v0 += coord[i] * rows
    out_pl = [Partial() if t.is_shard() else p
              for p, t in zip(ids.placements, table.placements)]
    grad_pl = [Partial() if (i.is_shard() and not t.is_shard()) else t
               for i, t in zip(ids.placements, table.placements)]
    y = _RowsInRange.apply(ids.to_local(),
                           table.to_local(grad_placements=grad_pl), v0)
    shape = torch.Size((*ids.shape, table.shape[1]))
    return DTensor.from_local(y, mesh, out_pl, run_check=False, shape=shape,
                              stride=_contiguous_stride(shape))


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor,
           out: torch.dtype) -> torch.Tensor:
    """``jnp.einsum(eq, a, b, preferred_element_type=out)``: f32 output
    means an f32 product; otherwise the product runs in the operands'
    common dtype and the result is cast to ``out``."""
    dt = F32 if out == F32 else torch.promote_types(a.dtype, b.dtype)
    if is_dtensor(a) or is_dtensor(b):
        return _einsum_sharded(eq, a.to(dt), b.to(dt)).to(out)
    return torch.einsum(eq, a.to(dt), b.to(dt)).to(out)


def _einsum_sharded(eq: str, a, b):
    """``torch.einsum`` of two DTensors (a plain operand is replicated),
    by the einsum sharding rule applied mesh dim by mesh dim: where one
    operand shards a letter the other holds too, the other is sharded
    alike (a local slice); where both shard different letters, the
    second is gathered; the output shards the letter where it keeps it
    and is a partial sum where it is contracted.  The local einsum then
    runs shard by shard.  DTensor's own einsum strategy search is
    exponential in the mesh dims and turns slow on 4-5-D operands of a
    3-D mesh; this rule needs no search and gives the same product."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = _mesh_of((a, b))
    a, b = (_reduce_partial(_as_dtensor(x, mesh)) for x in (a, b))
    ins, lo = eq.split("->")
    la, lb = ins.split(",")
    sizes = {**dict(zip(lb, b.shape)), **dict(zip(la, a.shape))}
    pa, pb, po = list(a.placements), list(b.placements), []
    for i, n in enumerate(mesh.shape):
        ca = la[pa[i].dim] if pa[i].is_shard() else None
        cb = lb[pb[i].dim] if pb[i].is_shard() else None
        if ca is not None and cb is not None and ca != cb:
            pb[i], cb = Replicate(), None
        c = ca or cb
        if c is not None and sizes[c] % n:
            pa[i] = pb[i] = Replicate()
            c = None
        if c is None:
            po.append(Replicate())
            continue
        if c in la:
            pa[i] = Shard(la.index(c))
        if c in lb:
            pb[i] = Shard(lb.index(c))
        po.append(Shard(lo.index(c)) if c in lo else Partial())
    a = _redistribute(a, pa)
    b = _redistribute(b, pb)
    # An operand replicated where the output is sharded or partial
    # gets a partial gradient there (each shard holds a summand).
    ga, gb = ([Partial() if (not p.is_shard() and not o.is_replicate())
               else p for p, o in zip(pl, po)] for pl in (pa, pb))
    y = torch.einsum(eq, a.to_local(grad_placements=ga),
                     b.to_local(grad_placements=gb))
    shape = torch.Size(sizes[c] for c in lo)
    return DTensor.from_local(y, mesh, po, run_check=False, shape=shape,
                              stride=_contiguous_stride(shape))


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def _reduce_partial(x):
    from torch.distributed.tensor import Replicate
    if any(p.is_partial() for p in x.placements):
        return _redistribute(x, [Replicate() if p.is_partial() else p
                                 for p in x.placements])
    return x


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

    if is_dtensor(q) and any(d == 2 for _, d in sharding_dims(q)):
        o = _attention_heads_sharded(q, k, v, n_heads // n_kv, head_dim,
                                     window)
    else:
        o = same_local(lambda q, k, v: _attention_grouped(
            q, k, v, n_heads, n_kv, head_dim, window), q, k, v)
    return einsum("bthk,hkd->btd", o, p["wo"], x.dtype)


def _attention_grouped(q, k, v, n_heads: int, n_kv: int, head_dim: int,
                       window: Optional[int]):
    """Causal GQA attention of rotated q (B, T, H, hd) and k, v (B, T,
    KV, hd): each group of g q heads against its kv head."""
    B, T = q.shape[:2]
    g = n_heads // n_kv
    q = q.reshape(B, T, n_kv, g, head_dim)
    scale = head_dim ** -0.5
    logits = einsum("bqhgk,bshk->bhgqs", q, k, F32) * scale
    # logits: (B, KV, g, T, T)
    qi = torch.arange(T, device=q.device)[:, None]
    ki = torch.arange(T, device=q.device)[None, :]
    mask = ki <= qi
    if window is not None:
        mask &= (qi - ki) < window
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    o = einsum("bhgqs,bshk->bqhgk", probs, v, F32)
    return o.reshape(B, T, n_heads, head_dim).to(q.dtype)


def _attention_heads_sharded(q, k, v, g: int, head_dim: int,
                             window: Optional[int]):
    """The causal attention of DTensors q (B, T, H, hd) and k, v (B, T,
    KV, hd), tensor-parallel over q heads: each kv head is repeated for
    its g q heads, so that every head shard holds its own k and v and
    the products stay shard-local (splitting H into (KV, g) cannot keep
    a head sharding whose shards cut across kv groups).  The same
    attention as the grouped form."""
    B, T, H, _ = q.shape

    def per_head(t):
        t = t[:, :, :, None].expand(B, t.shape[1], t.shape[2], g, head_dim)
        return _redistribute(t.reshape(B, t.shape[1], H, head_dim),
                             q.placements)
    return same_local(
        lambda q, k, v: _causal_per_head(q, k, v, head_dim, window),
        q, per_head(k), per_head(v))


def _causal_per_head(q, k, v, head_dim: int, window: Optional[int]):
    T = q.shape[1]
    logits = einsum("bqhk,bshk->bhqs", q, k, F32) * head_dim ** -0.5
    qi = torch.arange(T, device=q.device)[:, None]
    ki = torch.arange(T, device=q.device)[None, :]
    mask = ki <= qi
    if window is not None:
        mask &= (qi - ki) < window
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return einsum("bhqs,bshk->bqhk", probs, v, F32).to(q.dtype)


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
    # A DTensor q (one token) is replicated over the heads: the cache is
    # sharded by sequence, and the grouped reshape cannot keep a head
    # sharding whose shards cut across kv groups.
    qh = as_batch(q).reshape(B, n_kv, g, head_dim)
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
# MLP (gated) + MoE
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


def _largest_divisor_leq(n: int, cap: int) -> int:
    d = min(cap, n)
    while n % d:
        d -= 1
    return d


def _rank_in_expert(eid: torch.Tensor) -> torch.Tensor:
    """Position of each entry of ``eid`` (G, SK) within its expert's
    queue, first come first ranked: a stable sort of the expert ids, the
    left ``searchsorted`` of each sorted id, scattered back to its
    place."""
    SK = eid.shape[1]
    order = torch.argsort(eid, dim=-1, stable=True)
    e_sorted = torch.gather(eid, 1, order)
    start = torch.searchsorted(e_sorted, e_sorted, right=False)
    pos_sorted = (torch.arange(SK, device=eid.device) - start).to(torch.int32)
    return torch.zeros_like(pos_sorted).scatter_(1, order, pos_sorted)


def _route(xg: torch.Tensor, router: torch.Tensor, top_k: int,
           cap: int) -> tuple:
    """(gate_vals, gate_idx, pos, keep) of the groups ``xg`` (G, Sg, D):
    the f32 router's softmax, its top-k (values and expert ids, (G, Sg,
    K)), each choice's rank in its expert's queue and whether that rank
    is under ``cap``; gate values of dropped choices are zeroed."""
    if is_dtensor(xg) or is_dtensor(router):
        return batch_local(lambda x, r: _route(x, r, top_k, cap), [xg],
                           [router])
    G, gs, _ = xg.shape
    gate_logits = einsum("gsd,de->gse", xg.to(F32), router, F32)
    probs = torch.softmax(gate_logits, dim=-1)                 # (G, Sg, E)
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)
    gate_vals = gate_vals[..., :top_k]
    gate_idx = gate_idx[..., :top_k]
    pos = _rank_in_expert(gate_idx.reshape(G, gs * top_k))
    pos = pos.reshape(G, gs, top_k)
    keep = pos < cap
    return gate_vals * keep, gate_idx, pos, keep


def moe(x: torch.Tensor, p: dict, *, n_experts: int, top_k: int,
        activation: str, capacity_factor: float = 1.25,
        group_size: int = 2048) -> torch.Tensor:
    """Capacity-based top-k MoE with grouped dispatch.

    p: {'router': (D, E), 'wi': (E, D, 2|1, F), 'wo': (E, F, D)}.
    Tokens over capacity are dropped (the residual passes through).
    Tokens are routed within groups of ``group_size`` (GShard-style):
    the dispatch one-hot products grow with the square of the group.

    As in the JAX package: the router, its softmax and the top-k in f32;
    the capacity ``max(int(capacity_factor * top_k * gs / E), 1)`` in
    Python floats; the rank of each (token, k) in its expert's queue by
    a stable sort; one-hots in ``x.dtype``.  The top-k is a stable
    descending sort, so equal probabilities go to the lower expert index
    first, as ``jax.lax.top_k`` sends them (``torch.topk`` promises no
    order among ties).  The reference's three-operand combine einsum
    runs here as each chosen expert's gate (a contraction over k) times
    the dispatch mask, both in ``x.dtype``; its 0/1 factors keep the
    result exact.  The reference's ``_constrain`` sharding hints
    have no counterpart: without a device mesh they do nothing.

    The stages run under ``torch.profiler.record_function`` labels
    (``moe.route``, ``moe.dispatch``, ``moe.experts``, ``moe.combine``)
    so that a profile splits the layer's device time by stage.
    """
    B, T, D = x.shape
    E = n_experts
    S = B * T
    gs = _largest_divisor_leq(S, group_size)
    G = S // gs
    xg = x.reshape(G, gs, D)
    cap = max(int(capacity_factor * top_k * gs / E), 1)
    with record_function("moe.route"):
        gate_vals, gate_idx, pos, keep = _route(xg, p["router"], top_k, cap)
    with record_function("moe.dispatch"):
        onehot = F.one_hot(gate_idx, E).to(x.dtype)           # (G,Sg,K,E)
        pos_oh = F.one_hot(torch.where(keep, pos, cap).long(),
                           cap + 1).to(x.dtype)[..., :cap]     # (G,Sg,K,c)
        disp = einsum("gske,gskc->gsec", onehot, pos_oh, x.dtype)
        gate_e = einsum("gsk,gske->gse", gate_vals.to(x.dtype), onehot,
                        x.dtype)
        comb = disp * gate_e[..., None]
        xin = einsum("gsec,gsd->gecd", disp, xg, F32).to(x.dtype)
    with record_function("moe.experts"):
        # Expert FFN as 3-D batched products over (E, G*cap, ...).
        z = p["wi"].shape[2]
        Fd = p["wi"].shape[3]
        xe = xin.transpose(0, 1).reshape(E, G * cap, D)
        wi = p["wi"].reshape(E, D, z * Fd)
        h = einsum("ecd,edf->ecf", xe, wi, F32).reshape(E, G * cap, z, Fd)
        act = activation_fn(activation)
        if z == 2:
            h = act(h[:, :, 0]) * h[:, :, 1]
        else:
            h = act(h[:, :, 0])
        eout = einsum("ecf,efd->ecd", h.to(x.dtype), p["wo"],
                      F32).to(x.dtype)
        eout = eout.reshape(E, G, cap, D).transpose(0, 1)      # (G,E,c,D)
    with record_function("moe.combine"):
        yf = einsum("gsec,gecd->gsd", comb, eout, F32).to(x.dtype)
    return yf.reshape(B, T, D)
