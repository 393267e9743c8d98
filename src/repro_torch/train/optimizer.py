"""AdamW with optionally block-quantized (int8) moments.

Port of ``repro/train/optimizer.py``.  Full-precision Adam costs 8
bytes/param of optimizer state on top of bf16 params; moments can be
stored as int8 with one f32 scale per 256-entry block (~2.03 B/param
per moment).  Quantize/dequantize is elementwise.

Trees are nested dicts of tensors; leaves are taken in the JAX
package's order (dict keys sorted), so sums over leaves add in the same
order.  :func:`apply_updates` writes the new parameters and moments
into the given tensors under ``torch.no_grad()`` — the port's
counterpart of the reference's ``donate_argnums`` — and returns the
same dicts.  Large leaves are updated in slices along their leading
axes (at most :data:`UPDATE_CHUNK` elements each, :func:`_chunks`),
which keeps the f32 temporaries of one slice, not of the whole leaf.
The update is elementwise, so its values do not depend on the slicing;
the global norm's f32 sum of squares is added slice by slice (its order
of additions is the port's own, as torch's and XLA's reductions differ
anyway).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Literal, Optional

import torch

from repro_torch.models.layers import is_dtensor
from repro_torch.models.model import tree_map

F32 = torch.float32
QBLOCK = 256
#: Most elements of one leaf updated at once (see the module docstring).
UPDATE_CHUNK = 1 << 26


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    kind: Literal["adamw", "sgd"] = "adamw"
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: Literal["float32", "bfloat16", "int8"] = "float32"
    # int8 moment quantization
    qblock: int = QBLOCK


# -- trees ------------------------------------------------------------------

def tree_leaves(tree) -> list:
    """Leaves of a nested dict in JAX's order (keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(structure, leaves) -> Any:
    """``leaves`` (in :func:`tree_leaves` order) in the shape of
    ``structure``; a leaf left over raises ``ValueError``."""
    it = iter(leaves)
    out = _fill(structure, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def _fill(structure, it):
    if isinstance(structure, dict):
        return {k: _fill(structure[k], it) for k in sorted(structure)}
    return next(it)


def _flatten_up_to(structure, tree) -> list:
    """The subtrees of ``tree`` at the leaves of ``structure`` (a moment
    tree's int8 leaves are {'q', 'scale'} dicts), in leaf order."""
    if isinstance(structure, dict):
        return [x for k in sorted(structure)
                for x in _flatten_up_to(structure[k], tree[k])]
    return [tree]


# -- int8 blockwise quantization ------------------------------------------

def _pad_len(n: int, b: int) -> int:
    return (-n) % b


def quantize_blockwise(x: torch.Tensor, qblock: int = QBLOCK,
                       companding: str = "sqrt") -> dict:
    """x (any shape) -> {'q': int8 flat+pad, 'scale': f32 (nblocks,)}.

    ``companding='sqrt'`` stores sign(x)*sqrt(|x|/blockmax) in int8, which
    keeps the relative error bounded for the small-magnitude elements
    Adam's sqrt(v) denominator is sensitive to.  ``torch.round`` rounds
    half to even, as ``jnp.round`` does.
    """
    flat = x.reshape(-1).to(F32)
    pad = _pad_len(flat.shape[0], qblock)
    flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, qblock)
    bmax = torch.amax(torch.abs(blocks), dim=1)
    safe = torch.where(bmax > 0, bmax, torch.ones_like(bmax))
    if companding == "sqrt":
        unit = torch.sqrt(torch.abs(blocks) / safe[:, None]) \
            * torch.sign(blocks)
    else:
        unit = blocks / safe[:, None]
    q = torch.clamp(torch.round(unit * 127.0), -127, 127).to(torch.int8)
    return {"q": q, "scale": bmax / 127.0}


def dequantize_blockwise(qs: dict, shape, qblock: int = QBLOCK,
                         companding: str = "sqrt") -> torch.Tensor:
    unit = qs["q"].to(F32) / 127.0
    bmax = qs["scale"] * 127.0
    if companding == "sqrt":
        vals = torch.square(unit) * torch.sign(unit) * bmax[:, None]
    else:
        vals = unit * bmax[:, None]
    flat = vals.reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape)


# -- row-wise int8 (shape-preserving) ----------------------------------------

def _row_block(last_dim: int, qblock: int) -> int:
    b = min(qblock, max(last_dim, 1))
    while last_dim % b:
        b -= 1
    return b


def quantize_rowwise(x: torch.Tensor, qblock: int = QBLOCK) -> dict:
    """Blockwise int8 along the LAST axis, sqrt-companded; ``q`` keeps the
    tensor's shape (so slices of a leaf quantize alone)."""
    shape = tuple(x.shape)
    last = shape[-1] if shape else 1
    b = _row_block(last, qblock)
    blocks = x.reshape(*shape[:-1], last // b, b).to(F32)
    bmax = torch.amax(torch.abs(blocks), dim=-1)
    safe = torch.where(bmax > 0, bmax, torch.ones_like(bmax))
    unit = torch.sqrt(torch.abs(blocks) / safe[..., None]) \
        * torch.sign(blocks)
    q = torch.clamp(torch.round(unit * 127.0), -127, 127).to(torch.int8)
    return {"q": q.reshape(shape), "scale": bmax}


def dequantize_rowwise(qs: dict, shape, qblock: int = QBLOCK
                       ) -> torch.Tensor:
    shape = tuple(shape)
    last = shape[-1] if shape else 1
    b = _row_block(last, qblock)
    unit = qs["q"].reshape(*shape[:-1], last // b, b).to(F32) / 127.0
    vals = torch.square(unit) * torch.sign(unit) * qs["scale"][..., None]
    return vals.reshape(shape)


# -- state ------------------------------------------------------------------

def _moment_like(p: torch.Tensor, cfg: OptimizerConfig):
    if cfg.state_dtype == "int8":
        last = p.shape[-1] if p.ndim else 1
        b = _row_block(last, cfg.qblock)
        return {"q": torch.zeros(p.shape, dtype=torch.int8,
                                 device=p.device),
                "scale": torch.zeros((*p.shape[:-1], last // b), dtype=F32,
                                     device=p.device)}
    return torch.zeros(p.shape, dtype=getattr(torch, cfg.state_dtype),
                       device=p.device)


def init_opt_state(params, cfg: OptimizerConfig) -> dict:
    """Zero moments shaped like ``params`` on their devices (the meta
    device gives shapes and dtypes alone), and an int32 step count on
    the first leaf's device."""
    first = tree_leaves(params)[0]
    state: dict[str, Any] = {
        "count": torch.zeros((), dtype=torch.int32, device=first.device)}
    if cfg.kind == "adamw":
        state["m"] = tree_map(lambda p: _moment_like(p, cfg), params)
        state["v"] = tree_map(lambda p: _moment_like(p, cfg), params)
    elif cfg.kind == "sgd":
        state["m"] = tree_map(lambda p: _moment_like(p, cfg), params)
    return state


def _whole_rows(x, qblock: int):
    """A DTensor whose last dim is sharded across the row blocks of
    :func:`quantize_rowwise` (blocks that straddle two shards) with that
    dim gathered, so that each shard holds whole blocks: a gather that a
    partitioner placing blocks by shard would not need.  Anything else
    as it is."""
    if not is_dtensor(x) or x.ndim == 0:
        return x
    from torch.distributed.tensor import Replicate
    last = x.shape[-1]
    nblk = last // _row_block(last, qblock)
    pl = list(x.placements)
    cut = [i for i, p in enumerate(pl)
           if p.is_shard() and p.dim in (-1, x.ndim - 1)]
    n = 1
    for i in cut:
        n *= x.device_mesh.shape[i]
    if not cut or nblk % n == 0:
        return x
    for i in cut:
        pl[i] = Replicate()
    return x.redistribute(x.device_mesh, pl)


def _read_moment(mom, shape, cfg: OptimizerConfig) -> torch.Tensor:
    if cfg.state_dtype == "int8":
        if is_dtensor(mom["q"]):
            q = _whole_rows(mom["q"], cfg.qblock)
            scale = (mom["scale"] if q is mom["q"] else _whole_rows(
                mom["scale"].redistribute(q.device_mesh, q.placements),
                cfg.qblock))
            out = dequantize_rowwise({"q": q, "scale": scale}, shape,
                                     cfg.qblock)
            return out.redistribute(out.device_mesh, mom["q"].placements)
        return dequantize_rowwise(mom, shape, cfg.qblock)
    return mom.to(F32)


def _write_moment(dst, val: torch.Tensor, cfg: OptimizerConfig) -> None:
    """Store ``val`` into the moment ``dst`` in place."""
    if cfg.state_dtype == "int8":
        qs = quantize_rowwise(_whole_rows(val, cfg.qblock), cfg.qblock)
        dst["q"].copy_(qs["q"])
        dst["scale"].copy_(qs["scale"])
    else:
        dst.copy_(val)


def _chunks(p: torch.Tensor) -> list:
    """Indices of ``p`` picking at most UPDATE_CHUNK elements each
    (``...``, the whole tensor, when it is small or has fewer than two
    axes): slices of its first axis, and where one index of an axis
    still holds more, slices of the next (a stacked MoE leaf's
    superblock: qwen3-moe's wi holds 403M elements), never of the last
    axis, along which int8 moments quantize."""
    if p.ndim < 2 or p.numel() <= UPDATE_CHUNK or is_dtensor(p):
        return [...]
    return _split(tuple(p.shape), ())


def _split(shape: tuple, at: tuple) -> list:
    per = 1
    for n in shape[1:]:
        per *= n
    if per > UPDATE_CHUNK and len(shape) > 2:
        return [c for i in range(shape[0])
                for c in _split(shape[1:], at + (i,))]
    rows = max(1, UPDATE_CHUNK // per)
    return [at + (slice(i, i + rows),) for i in range(0, shape[0], rows)]


def _sub(mom, sl):
    if isinstance(mom, dict):
        return {k: v[sl] for k, v in mom.items()}
    return mom[sl]


# -- update -----------------------------------------------------------------

def global_norm(tree, groups: Optional[list] = None) -> torch.Tensor:
    """sqrt of the sum of squares, the leaves summed in JAX's order (each
    leaf's squares in the slices of :func:`_chunks`, so a bf16 leaf's f32
    copy is never made whole).  With ``groups`` (per leaf, the process
    groups over which its shards split it) the leaves are local shards
    and each leaf's sum is reduced over its groups first."""
    if groups is None:
        return torch.sqrt(sum(torch.sum(torch.square(x[sl].to(F32)))
                              for x in tree_leaves(tree)
                              for sl in _chunks(x)))
    from repro_torch.distribution.collectives import all_reduce
    total = 0
    for x, gs in zip(tree_leaves(tree), groups):
        s = sum(torch.sum(torch.square(x[sl].to(F32))) for sl in _chunks(x))
        for g in gs:
            s = all_reduce(s, "sum", g)
        total = total + s
    return torch.sqrt(total)


def _shard_groups(x) -> list:
    """The process groups of the mesh dims (of more than one rank) that
    shard the DTensor ``x``."""
    mesh = x.device_mesh
    return [mesh.get_group(i) for i, p in enumerate(x.placements)
            if p.is_shard() and mesh.shape[i] > 1]


def _local(tree):
    return tree_map(lambda t: t.to_local() if is_dtensor(t) else t, tree)


@torch.no_grad()
def apply_updates(params, grads, opt_state, cfg: OptimizerConfig,
                  lr: Optional[torch.Tensor] = None):
    """One optimizer step, written into ``params`` and ``opt_state``.
    Returns (params, opt_state, metrics), the same dicts, as the
    reference returns (new_params, new_opt_state, metrics).

    Moment trees may have quant-dict leaves (int8 mode), so they are
    flattened only down to the params' structure.  ``lr`` may be a
    number or a 0-d tensor (a schedule's value).

    DTensor leaves (a device mesh): each gradient is first placed as its
    parameter (the gradient reduction).  With f32/bf16 moments, which
    shard as their parameters, the update then runs on the local shards
    (it is elementwise) and the global norm adds each leaf's local sum
    reduced over its shards; int8 moments, whose scales may shard
    otherwise, update as DTensors."""
    leaves_p = tree_leaves(params)
    if is_dtensor(leaves_p[0]):
        grads = tree_unflatten(params, [
            g.redistribute(p.device_mesh, p.placements)
            for p, g in zip(leaves_p, _flatten_up_to(params, grads))])
        if cfg.state_dtype != "int8":
            groups = [_shard_groups(p) for p in leaves_p]
            _, _, metrics = _apply(_local(params), _local(grads),
                                   _local(opt_state), cfg, lr, groups)
            return params, opt_state, metrics
    return _apply(params, grads, opt_state, cfg, lr)


def _apply(params, grads, opt_state, cfg: OptimizerConfig, lr,
           groups: Optional[list] = None):
    lr = cfg.lr if lr is None else lr
    opt_state["count"].add_(1)
    count = opt_state["count"]
    gnorm = global_norm(grads, groups)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)

    leaves_p = tree_leaves(params)
    leaves_g = _flatten_up_to(params, grads)

    if cfg.kind == "sgd":
        leaves_m = _flatten_up_to(params, opt_state["m"])
        for p, g, m in zip(leaves_p, leaves_g, leaves_m):
            for sl in _chunks(p):
                ps, ms = p[sl], _sub(m, sl)
                gs = g[sl].to(F32) * clip
                mv = _read_moment(ms, ps.shape, cfg) * 0.9 + gs
                ps.copy_(ps.to(F32) - lr * mv)
                _write_moment(ms, mv, cfg)
        return params, opt_state, {"grad_norm": gnorm}

    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** count.to(F32)
    bc2 = 1.0 - b2 ** count.to(F32)
    leaves_m = _flatten_up_to(params, opt_state["m"])
    leaves_v = _flatten_up_to(params, opt_state["v"])
    for p, g, m, v in zip(leaves_p, leaves_g, leaves_m, leaves_v):
        for sl in _chunks(p):
            ps, ms, vs = p[sl], _sub(m, sl), _sub(v, sl)
            gs = g[sl].to(F32) * clip
            mv = _read_moment(ms, ps.shape, cfg) * b1 + (1 - b1) * gs
            vv = _read_moment(vs, ps.shape, cfg) * b2 \
                + (1 - b2) * torch.square(gs)
            step = (mv / bc1) / (torch.sqrt(vv / bc2) + cfg.eps)
            pf = ps.to(F32)
            ps.copy_(pf - lr * (step + cfg.weight_decay * pf))
            _write_moment(ms, mv, cfg)
            _write_moment(vs, vv, cfg)
    return params, opt_state, {"grad_norm": gnorm}
