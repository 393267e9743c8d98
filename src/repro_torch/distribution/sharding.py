"""Sharding rules: FSDP ('data') x TP/EP ('model') x pure-DP ('pod').

Port of ``repro/distribution/sharding.py``; the rule tables and
``make_spec`` are the reference's, word for word.

Design:
  * 'pod' is pure data-parallel: params replicated across pods, gradients
    all-reduced across the inter-pod links once per step.
  * 'data' is the FSDP axis: params sharded along a non-TP dim.
  * 'model' is tensor/expert parallel: attention q-heads, MLP hidden,
    Mamba inner channels, MoE experts.

Every rule is a priority list of axis groups per tensor dim; the engine
assigns the first group whose product divides the dim (so kv=1 MQA or
E=16 MoE never produce invalid shardings — they just fall back to
replication).

A spec is a :class:`P` (one entry per tensor dim: ``None``, an axis
name, or a tuple of names).  The tree functions return a
:class:`NamedSharding` (mesh + spec) per leaf, as the reference does;
on a ``DeviceMesh`` its ``placements`` are the DTensor placements
(:func:`to_placements`), and :func:`distribute` places a tensor by it.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Optional, Sequence

import torch

from repro_torch.launch.mesh import AbstractMesh, abstract

FSDP = ("data",)
DP = ("pod", "data")      # batch axes (pod first so 2x16 folds cleanly)
TP = ("model",)


class P(tuple):
    """A partition spec: one entry per tensor dim (``None``, an axis
    name, or a tuple of axis names), as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


# Per-dim candidate axis groups, in priority order.
Rule = Sequence[Optional[Sequence[Sequence[str]]]]

# (name-pattern, rank) -> rule (one entry per trailing dim; leading stack
# dims of scanned params are handled by the caller). First match with the
# right rank wins.
_PARAM_RULES: list[tuple[str, Rule]] = [
    # embeddings
    (r"\bembed$", [[TP], [FSDP]]),
    (r"\bunembed$", [[FSDP], [TP]]),
    # attention (rank 3)
    (r"mixer/wq$", [[FSDP], [TP], None]),
    # shard KV heads when they divide TP, else REPLICATE — never shard
    # head_dim (RoPE's rotate-half split would cross shard boundaries).
    (r"mixer/wk$|mixer/wv$", [[FSDP], [TP], None]),
    (r"mixer/wo$", [[TP], None, [FSDP]]),
    # rwkv time mix (rank 2: D x D)
    (r"mixer/w[rkvgo]$", [[FSDP], [TP]]),
    (r"mixer/lora_a_\w+$", [[FSDP], None]),
    (r"mixer/lora_b_\w+$", [None, [TP]]),
    (r"mixer/u$", [[TP], None]),
    # dense mlp / rwkv channel mix
    (r"ffn/wi$", [[FSDP], None, [TP]]),                   # (D, g, F)
    (r"ffn/wo$", [[TP], [FSDP]]),                         # (F, D)
    (r"ffn/wr$", [[FSDP], [TP]]),                         # rwkv channel
    (r"ffn/wk$", [[FSDP], [TP]]),                         # (D, F)
    (r"ffn/wv$", [[TP], [FSDP]]),                         # (F, D)
    # moe router
    (r"ffn/router$", [None, None]),
    # mamba
    (r"mixer/in_proj$", [[FSDP], [TP]]),
    (r"mixer/conv_w$", [[TP], None]),
    (r"mixer/conv_b$", [[TP]]),
    (r"mixer/x_proj$", [[TP], None]),
    (r"mixer/dt_proj$", [None, [TP]]),
    (r"mixer/dt_bias$", [[TP]]),
    (r"mixer/A_log$", [[TP], None]),
    (r"mixer/D$", [[TP]]),
    (r"mixer/out_proj$", [[TP], [FSDP]]),
]


def make_spec(rule: Rule, shape: Sequence[int], mesh) -> P:
    """Greedy assignment: first divisible axis-group per dim wins."""
    mesh = abstract(mesh)
    used: set[str] = set()
    out: list[Any] = []
    rule = list(rule) + [None] * (len(shape) - len(rule))
    for dim_size, candidates in zip(shape, rule):
        chosen = None
        for group in candidates or []:
            axes = tuple(a for a in group
                         if a in mesh.axis_names and a not in used)
            if not axes:
                continue
            n = math.prod(mesh.shape[a] for a in axes)
            if n > 1 and dim_size % n == 0:
                chosen = axes if len(axes) > 1 else axes[0]
                used.update(axes)
                break
        out.append(chosen)
    return P(*out)


def _rule_for(path_str: str, rank: int, is_moe_leaf: bool) -> Rule:
    if is_moe_leaf:
        # EP over 'model'.
        if path_str.endswith("wi"):
            return [[TP], [FSDP], None, None]              # (E, D, g, F)
        if path_str.endswith("wo"):
            return [[TP], None, [FSDP]]                    # (E, F, D)
    for pat, rule in _PARAM_RULES:
        if re.search(pat, path_str) and len(rule) == rank:
            return rule
    return [None] * rank


# ---------------------------------------------------------------------------
# Specs -> DTensor placements
# ---------------------------------------------------------------------------

def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def to_placements(spec: Sequence, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: per mesh dim,
    ``Shard(d)`` for the tensor dim ``d`` that names it, else
    ``Replicate()``.  Two axes on one dim become two ``Shard(d)``
    entries in mesh-dim order, which lays out as JAX's ("pod", "data")
    (pod-major); axes named against mesh order raise."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(abstract(mesh).axis_names)
    placements: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in mesh order "
                             f"{tuple(names)}")
        for i in idx:
            placements[i] = Shard(d)
    return tuple(placements)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec (the counterpart of JAX's ``NamedSharding``)."""
    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return to_placements(self.spec, self.mesh)


def distribute(x: torch.Tensor, sharding: NamedSharding):
    """``x`` (the whole tensor, the same on every rank) as a DTensor
    placed by ``sharding`` on its ``DeviceMesh``."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, sharding.mesh, sharding.placements)


# ---------------------------------------------------------------------------
# Tree walks (nested dicts, paths as the reference's ``_leaf_path_str``)
# ---------------------------------------------------------------------------

def _map_with_path(fn, tree, path: str = ""):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    return fn(path, tree)


def tree_map_shardings(fn, tree, shardings):
    """``fn(leaf, sharding)`` over a tree and its sharding tree."""
    if isinstance(tree, dict):
        return {k: tree_map_shardings(fn, v, shardings[k])
                for k, v in tree.items()}
    return fn(tree, shardings)


def _param_spec(path: str, shape: Sequence[int], mesh) -> P:
    shape = list(shape)
    stacked = path.startswith("blocks")
    core = shape[1:] if stacked else shape
    is_moe = ("ffn" in path and
              ((path.endswith("wi") and len(core) == 4)
               or (path.endswith("wo") and len(core) == 3)))
    rule = _rule_for(path, len(core), is_moe)
    spec = make_spec(rule, core, mesh)
    if stacked:
        spec = P(None, *spec)
    return spec


def param_shardings(params_tree, mesh):
    """NamedSharding tree matching params (works on meta tensors).

    Leaves under 'blocks' have a leading stacked-layer dim (never
    sharded). MoE leaves are recognized by rank (wi rank 4+stack / wo
    rank 3+stack under ffn with expert dim first).
    """
    return _map_with_path(
        lambda ps, leaf: NamedSharding(mesh, _param_spec(ps, leaf.shape,
                                                         mesh)),
        params_tree)


def batch_spec(mesh, batch_size: int, extra_dims: int = 1) -> P:
    """Shard the batch dim over as many DP axes as divide it."""
    mesh = abstract(mesh)
    used: list[str] = []
    n = 1
    for a in DP:
        if a in mesh.axis_names:
            m = mesh.shape[a]
            if batch_size % (n * m) == 0:
                used.append(a)
                n *= m
    lead = tuple(used) if len(used) > 1 else (used[0] if used else None)
    return P(lead, *([None] * extra_dims))


def batch_shardings(mesh, batch_tree):
    return _map_with_path(
        lambda _, leaf: NamedSharding(
            mesh, batch_spec(mesh, leaf.shape[0], len(leaf.shape) - 1)),
        batch_tree)


_CACHE_RULES: list[tuple[str, Rule]] = [
    # KV cache (B, S, KV, hd) sharded on SEQUENCE over TP (batch over
    # DP): decode attention keeps logits (B, H, S/tp) shard-local and
    # only reduces the softmax stats + the (B, H, hd) output partials.
    (r"\bk$|\bv$", [[DP, FSDP], [TP, FSDP], None, None]),
    (r"\bpos$", [None]),
    # mamba: conv (B, K-1, Di), ssm (B, Di, S)
    (r"\bconv$", [[DP, FSDP], None, [TP]]),
    (r"\bssm$", [[DP, FSDP], [TP], None]),
    # rwkv: shift (B, 1, D), wkv (B, H, dk, dv)
    (r"\bshift$", [[DP, FSDP], None, None]),
    (r"\bwkv$", [[DP, FSDP], [TP], None, None]),
]


def _cache_spec(path: str, shape: Sequence[int], mesh) -> P:
    core = list(shape)[1:]               # drop stacked superblock dim
    rule = [None] * len(core)
    for pat, r in _CACHE_RULES:
        if re.search(pat, path):
            rule = r
            break
    spec = make_spec(rule, core, mesh)
    return P(None, *spec)


def cache_shardings(cache_tree, mesh):
    """Shardings for the stacked decode cache (leading superblock dim)."""
    return _map_with_path(
        lambda ps, leaf: NamedSharding(mesh, _cache_spec(ps, leaf.shape,
                                                         mesh)),
        cache_tree)


def _moment_sharding(leaf, psh: NamedSharding, mesh):
    if not isinstance(leaf, dict):
        return psh
    # {'q': param-shape, 'scale': ...}
    pspec = tuple(psh.spec)
    pspec = pspec + (None,) * (leaf["q"].ndim - len(pspec))
    nblk = leaf["scale"].shape[-1] if leaf["scale"].ndim else 1
    last = pspec[-1] if pspec else None
    # keep last-axis sharding on the scale only if it divides
    scale_last = None
    if last is not None:
        n = math.prod(abstract(mesh).shape[a] for a in _axes(last))
        if nblk % n == 0:
            scale_last = last
    sspec = pspec[:-1] + (scale_last,) if pspec else ()
    return {"q": NamedSharding(mesh, P(*pspec)),
            "scale": NamedSharding(mesh, P(*sspec))}


def opt_state_shardings(opt_state_tree, params_tree, params_shardings,
                        mesh):
    """Adam m/v shard exactly like their params. Row-wise int8 moments
    keep the parameter's shape ('q') so they inherit the SAME sharding;
    their per-block scales drop the last-axis entry unless the block
    count divides it."""
    def shard_moment_tree(tree, shardings):
        if isinstance(shardings, dict):
            return {k: shard_moment_tree(tree[k], shardings[k])
                    for k in shardings}
        return _moment_sharding(tree, shardings, mesh)

    result: dict = {"count": NamedSharding(mesh, P())}
    for key in ("m", "v"):
        if key in opt_state_tree:
            result[key] = shard_moment_tree(opt_state_tree[key],
                                            params_shardings)
    return result


__all__ = ["AbstractMesh", "NamedSharding", "P", "batch_shardings",
           "batch_spec", "cache_shardings", "distribute", "make_spec",
           "opt_state_shardings", "param_shardings", "to_placements",
           "tree_map_shardings"]
