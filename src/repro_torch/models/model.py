"""Decoder LM assembled from the ArchConfig block pattern.

Port of ``repro/models/model.py``: the inference path (forward, loss
value, prefill, cached decode) for every block kind (attention, Mamba,
RWKV-6), dense and MoE feed-forward layers, and the token or
stubbed-frontend (``embeds``) input.  Parameters are a dict of tensors
under the JAX package's names, with each block leaf stacked over
superblocks on a leading axis, so that :func:`params_from_numpy`
carries the reference's parameters across leaf for leaf.  The JAX
package scans over that axis; the port loops.

Public API:
  init_params(cfg, generator, device)       -> params dict
  params_from_numpy(cfg, tree, device)      -> params dict
  forward(cfg, params, batch)               -> logits (train/prefill path)
  loss_fn(cfg, params, batch)               -> scalar loss (value only)
  init_cache(cfg, B, cache_len, fill=0, *, device) -> decode cache dict
  prefill(cfg, params, batch, cache_len)    -> logits, cache
  decode_step(cfg, params, cache, batch)    -> logits, cache
  superblock_apply(cfg, block_params, x, sb_index=0) -> x

The functions that make tensors put them on the card unless ``device``
names another (``"cpu"``); the others run where the parameters are.
``forward`` and ``loss_fn`` are differentiable (``launch/steps.py``
trains through them), with the reference's rematerialization policies.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distribution.collectives import all_reduce
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import ssm as S

F32 = torch.float32


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def _adtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.activation_dtype)


def tree_map(fn, tree):
    """``fn`` over every tensor of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def gather_params(tree):
    """Every DTensor leaf gathered over the batch axes where it is used
    (FSDP, :func:`L.gather_param`); plain tensors as they are."""
    return tree_map(L.gather_param, tree)


def _index(tree, i: int):
    """Superblock ``i``'s slice of a stacked tree (for inspecting one
    superblock; the model's own loops take :func:`_unbind`)."""
    return tree_map(lambda x: x[i], tree)


def _unbind(tree, n: int) -> list:
    """The ``n`` per-superblock slices of a stacked tree, taken with one
    ``unbind`` per leaf: its backward is one ``stack``, where a select
    per superblock would write a dense gradient of the whole leaf each
    time."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return tree.unbind(0)


def _put(dst: dict, src: dict, i: int) -> None:
    """Copy every leaf of ``src`` into slot ``i`` of ``dst``'s leaf."""
    for k, v in src.items():
        if isinstance(v, dict):
            _put(dst[k], v, i)
        else:
            dst[k][i].copy_(v)


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

_META = torch.device("meta")


def _device(gen: Optional[torch.Generator]) -> torch.device:
    """Where ``gen`` draws; no generator draws shapes alone (meta)."""
    return _META if gen is None else gen.device


def _init(gen: Optional[torch.Generator], shape, dtype,
          scale: Optional[float] = None) -> torch.Tensor:
    """N(0, 1) * scale drawn in f32, cast to ``dtype`` (``shape[0] **
    -0.5`` by default, as the JAX package's ``_init``)."""
    scale = scale if scale is not None else shape[0] ** -0.5
    return torch.randn(shape, generator=gen, dtype=F32,
                       device=_device(gen)).mul_(scale).to(dtype)


def _full(shape, value: float, dtype,
          gen: Optional[torch.Generator]) -> torch.Tensor:
    return torch.full(shape, value, dtype=dtype, device=_device(gen))


def _init_ffn(cfg: ArchConfig, gen: torch.Generator) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    g = 2 if cfg.gated_mlp else 1
    dt = _dtype(cfg)
    return {"wi": _init(gen, (d, g, f), dt), "wo": _init(gen, (f, d), dt)}


def _init_moe(cfg: ArchConfig, gen: torch.Generator) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    g = 2 if cfg.gated_mlp else 1
    dt = _dtype(cfg)
    return {"router": _init(gen, (d, e), F32),
            "wi": _init(gen, (e, d, g, f), dt),
            "wo": _init(gen, (e, f, d), dt)}


def _init_attn(cfg: ArchConfig, gen: torch.Generator) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    dt = _dtype(cfg)
    return {"wq": _init(gen, (d, h, hd), dt),
            "wk": _init(gen, (d, kv, hd), dt),
            "wv": _init(gen, (d, kv, hd), dt),
            "wo": _init(gen, (h, hd, d), dt, scale=(h * hd) ** -0.5)}


def _init_mamba(cfg: ArchConfig, gen: torch.Generator) -> dict:
    d, di, ds, K = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.d_conv
    R = max(d // 16, 1)
    dt = _dtype(cfg)
    a_log = torch.log(torch.arange(1, ds + 1, dtype=F32,
                                   device=_device(gen)))
    return {
        "in_proj": _init(gen, (d, 2 * di), dt),
        "conv_w": _init(gen, (di, K), dt, scale=0.3),
        "conv_b": _full((di,), 0.0, dt, gen),
        "x_proj": _init(gen, (di, R + 2 * ds), dt),
        "dt_proj": _init(gen, (R, di), dt),
        "dt_bias": _full((di,), -2.0, dt, gen),
        "A_log": a_log.expand(di, ds).clone(),
        "D": _full((di,), 1.0, F32, gen),
        "out_proj": _init(gen, (di, d), dt),
    }


def _init_rwkv_time(cfg: ArchConfig, gen: torch.Generator) -> dict:
    d = cfg.d_model
    H, hd = cfg.n_rwkv_heads, cfg.rwkv_head_dim
    R = max(d // 32, 8)
    dt = _dtype(cfg)
    p: dict[str, Any] = {}
    for nm in ("r", "k", "v", "w", "g"):
        p[f"mu_{nm}"] = _full((d,), 0.5, F32, gen)
        p[f"lora_a_{nm}"] = _init(gen, (d, R), dt)
        p[f"lora_b_{nm}"] = _full((R, d), 0.0, dt, gen)
    p["w0"] = _full((d,), -2.0, F32, gen)
    p["lora_a_w2"] = _init(gen, (d, R), dt)
    p["lora_b_w2"] = _full((R, d), 0.0, dt, gen)
    for nm in ("wr", "wk", "wv", "wg", "wo"):
        p[nm] = _init(gen, (d, d), dt)
    p["u"] = _full((H, hd), 0.0, F32, gen)
    p["ln_scale"] = _full((d,), 1.0, F32, gen)
    return p


def _init_rwkv_channel(cfg: ArchConfig, gen: torch.Generator) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    dt = _dtype(cfg)
    return {"mu_r": _full((d,), 0.5, F32, gen),
            "mu_k": _full((d,), 0.5, F32, gen),
            "wr": _init(gen, (d, d), dt),
            "wk": _init(gen, (d, f), dt),
            "wv": _init(gen, (f, d), dt)}


def init_sublayer_params(cfg: ArchConfig, generator: torch.Generator,
                         layer_idx: int) -> dict:
    """One sublayer's parameters (not stacked), on the generator's
    device."""
    kind = cfg.layer_kind(layer_idx)
    gen = generator
    d = cfg.d_model
    p: dict[str, Any] = {"norm1": _full((d,), 1.0, F32, gen),
                         "norm2": _full((d,), 1.0, F32, gen)}
    if kind == "attn":
        p["mixer"] = _init_attn(cfg, gen)
    elif kind == "mamba":
        p["mixer"] = _init_mamba(cfg, gen)
    elif kind == "rwkv6":
        p["mixer"] = _init_rwkv_time(cfg, gen)
    else:
        raise ValueError(kind)
    if kind == "rwkv6":
        p["ffn"] = _init_rwkv_channel(cfg, gen)
    elif cfg.is_moe_layer(layer_idx):
        p["ffn"] = _init_moe(cfg, gen)
    else:
        p["ffn"] = _init_ffn(cfg, gen)
    return p


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator],
                device=None, shardings=None) -> dict:
    """Random parameters of the JAX package's shapes, scales and dtypes,
    drawn from ``generator`` on its device and placed on ``device``
    (default: the card).  The two frameworks' generators differ, so the
    values do not match JAX's; tests carry JAX's parameters across with
    :func:`params_from_numpy` instead.  Sublayers are drawn one at a
    time and copied into the stacked leaves, so a full-width model needs
    one sublayer's parameters (and its largest f32 draw) beside its
    own.  ``generator=None`` with ``device="meta"`` gives the shapes and
    dtypes alone, allocating nothing (``launch.steps.param_specs``).

    ``shardings`` (a tree of ``distribution.sharding.NamedSharding``
    like the parameters') gives DTensors on its mesh: each top-level
    leaf is placed as it is drawn, and each sublayer's draw is cut to
    this rank's shards of the stacked leaves, so that one leaf or one
    sublayer at most is whole beside the shards.  The values are the
    unsharded call's."""
    device = ops.resolve_device(device)
    gen = generator
    dt = _dtype(cfg)

    def top(key: str, x: torch.Tensor) -> torch.Tensor:
        x = x.to(device)
        return x if shardings is None else _distribute(x, shardings[key])

    params: dict[str, Any] = {
        "embed": top("embed", _init(gen, (cfg.vocab_size, cfg.d_model), dt,
                                    scale=0.02))}
    params["final_norm"] = top("final_norm",
                               _full((cfg.d_model,), 1.0, F32, gen))
    if not cfg.tie_embeddings:
        params["unembed"] = top("unembed", _init(
            gen, (cfg.d_model, cfg.vocab_size), dt))
    n, period = cfg.n_superblocks, cfg.pattern_period
    blocks: dict[str, Any] = {}
    for sb in range(n):
        for i in range(period):
            one = init_sublayer_params(cfg, gen, sb * period + i)
            if shardings is None:
                if sb == 0:
                    blocks[f"s{i}"] = tree_map(
                        lambda x: torch.empty((n,) + tuple(x.shape),
                                              dtype=x.dtype, device=device),
                        one)
                _put(blocks[f"s{i}"], one, sb)
            else:
                sh = shardings["blocks"][f"s{i}"]
                if sb == 0:
                    blocks[f"s{i}"] = _zip_map(
                        lambda x, h: _empty_stacked(n, x, h), one, sh)
                _zip_map(lambda x, h, dst: dst.to_local()[sb].copy_(
                    _sublayer_shard(x.to(device), h)), one, sh,
                    blocks[f"s{i}"])
            del one
    params["blocks"] = blocks
    return params


def _zip_map(fn, tree, *others):
    """``fn`` over the leaves of ``tree`` and of ``others`` (trees of
    its structure)."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, *(o[k] for o in others))
                for k, v in tree.items()}
    return fn(tree, *others)


def _distribute(x: torch.Tensor, sharding):
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, sharding.mesh, sharding.placements)


def _empty_stacked(n: int, x: torch.Tensor, sharding):
    """An uninitialised DTensor of ``(n, *x.shape)`` placed by
    ``sharding``, allocating this rank's shards alone."""
    from torch.distributed.tensor import empty
    return empty((n,) + tuple(x.shape), dtype=x.dtype,
                 device_mesh=sharding.mesh, placements=sharding.placements)


def _sublayer_shard(x: torch.Tensor, stacked_sharding) -> torch.Tensor:
    """This rank's shard of one sublayer's leaf ``x``, as a slot of the
    stacked leaf placed by ``stacked_sharding`` holds it (the stacked
    dim is never sharded, so its ``Shard(d)`` is ``x``'s ``Shard(d-1)``)."""
    from torch.distributed.tensor import Shard, distribute_tensor
    pl = [Shard(p.dim - 1) if p.is_shard() else p
          for p in stacked_sharding.placements]
    return distribute_tensor(x, stacked_sharding.mesh, pl).to_local()


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":              # ml_dtypes, from JAX
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_numpy(cfg: ArchConfig, tree: dict, device=None) -> dict:
    """The port's parameters from the JAX package's, as numpy arrays
    (``jax.tree.map(np.asarray, M.init_params(cfg, key))``): the same
    names, shapes, dtypes and values, on ``device`` (default: the card)."""
    device = ops.resolve_device(device)
    return tree_map(lambda a: _tensor(a).to(device), tree)


# ---------------------------------------------------------------------------
# Forward (train / prefill trunk)
# ---------------------------------------------------------------------------

def _moe(cfg: ArchConfig, p: dict, h: torch.Tensor) -> torch.Tensor:
    return L.moe(h, p, n_experts=cfg.n_experts, top_k=cfg.top_k,
                 activation=cfg.activation,
                 capacity_factor=cfg.capacity_factor,
                 group_size=cfg.moe_group_size)


def _apply_sublayer(cfg: ArchConfig, kind: str, is_moe: bool, p: dict,
                    x: torch.Tensor) -> torch.Tensor:
    x = L.as_batch(x)
    h = L.rms_norm(x, p["norm1"], cfg.rms_eps)
    if kind == "attn":
        h = L.attention_train(h, p["mixer"], n_heads=cfg.n_heads,
                              n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim_,
                              theta=cfg.rope_theta,
                              window=cfg.sliding_window,
                              impl=cfg.attention_impl)
    elif kind == "mamba":
        h = S.mamba_train(h, p["mixer"], d_state=cfg.d_state)
    elif kind == "rwkv6":
        h = S.rwkv6_time_mix(h, p["mixer"], head_dim=cfg.rwkv_head_dim)
    x = x + L.as_batch(h)
    h = L.rms_norm(x, p["norm2"], cfg.rms_eps)
    if kind == "rwkv6":
        h = S.rwkv6_channel_mix(h, p["ffn"])
    elif is_moe:
        h = _moe(cfg, p["ffn"], h)
    else:
        h = L.mlp(h, p["ffn"], cfg.activation)
    return x + L.as_batch(h)


def superblock_apply(cfg: ArchConfig, block_params: dict,
                     x: torch.Tensor, sb_index: int = 0) -> torch.Tensor:
    """One period of the block pattern (DTensor parameters gathered over
    the batch axes for it, as the reference's FSDP gathers each scanned
    superblock)."""
    block_params = gather_params(block_params)
    for i, kind in enumerate(cfg.block_pattern):
        layer_idx = sb_index * cfg.pattern_period + i
        x = _apply_sublayer(cfg, kind, cfg.is_moe_layer(layer_idx),
                            block_params[f"s{i}"], x)
    return x


def _save_products_without_batch(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``"dots_no_batch"``
    (``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``): keep
    the outputs of the products with no batch dimension — the weight
    products, which ``torch.einsum`` runs as ``bmm`` with a batch of 1 —
    and recompute everything else (the attention's and the experts'
    batched products included)."""
    from torch.utils.checkpoint import CheckpointPolicy
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default) or (
            op is aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_no_batch_context():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    return create_selective_checkpoint_contexts(_save_products_without_batch)


# The JAX package's rematerialization policies, by name: the selective
# checkpoint context of each (None: recompute everything, as
# ``nothing_saveable``); "everything" saves every residual, which is no
# rematerialization at all.
REMAT_POLICIES = {"nothing": None, "dots_no_batch": _dots_no_batch_context,
                  "everything": None}


def forward_trunk(cfg: ArchConfig, params: dict, x: torch.Tensor,
                  remat: bool = True,
                  remat_policy: str = "nothing") -> torch.Tensor:
    """The superblocks in turn.  With ``remat`` (and a policy other than
    "everything") each superblock runs under
    ``torch.utils.checkpoint.checkpoint``: backward recomputes its
    activations, all of them ("nothing") or all but the products without
    a batch dimension ("dots_no_batch"), as the reference's
    ``jax.checkpoint`` of its scan body does.  Values do not depend on
    either argument; an unknown policy raises ``KeyError`` as there."""
    context = REMAT_POLICIES[remat_policy]
    # Without a graph being recorded there is nothing to rematerialize.
    remat = (remat and remat_policy != "everything"
             and torch.is_grad_enabled())
    blocks = _unbind(params["blocks"], cfg.n_superblocks)
    for sb, block_p in enumerate(blocks):
        if not remat:
            x = superblock_apply(cfg, block_p, x, sb)
            continue
        kw = {} if context is None else {"context_fn": context}
        x = torch.utils.checkpoint.checkpoint(
            superblock_apply, cfg, block_p, x, sb, use_reentrant=False,
            **kw)
    return x


def encode_inputs(cfg: ArchConfig, params: dict,
                  batch: dict) -> torch.Tensor:
    """Token embedding, or the stubbed modality frontend's embeddings."""
    if L.is_dtensor(params["embed"]):
        return _encode_sharded(cfg, params, batch)
    dev = params["embed"].device
    if cfg.frontend is not None:
        return torch.as_tensor(batch["embeds"], device=dev).to(_adtype(cfg))
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    return params["embed"][tokens.long()].to(_adtype(cfg))


def _encode_sharded(cfg: ArchConfig, params: dict,
                    batch: dict) -> torch.Tensor:
    """:func:`encode_inputs` on DTensors (the vocab-sharded embedding
    through :func:`L.embedding_sharded`); the same rows."""
    if cfg.frontend is not None:
        return L.as_batch(batch["embeds"].to(_adtype(cfg)))
    tokens = L.as_batch(batch["tokens"]).long()
    embed = L.gather_param(params["embed"])
    return L.as_batch(L.embedding_sharded(tokens, embed).to(_adtype(cfg)))


def _unembed(cfg: ArchConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    x = L.rms_norm(L.as_batch(x), L.gather_param(params["final_norm"]),
                   cfg.rms_eps)
    unembed = (L.gather_param(params["embed"]).T if cfg.tie_embeddings
               else L.gather_param(params["unembed"]))
    return L.einsum("btd,dv->btv", x, unembed, F32)


def forward(cfg: ArchConfig, params: dict, batch: dict,
            remat: bool = True, remat_policy: str = "nothing"
            ) -> torch.Tensor:
    """batch {'tokens': (B, T)} or {'embeds': (B, T, D)} -> logits
    (B, T, V) f32.  ``remat`` and ``remat_policy`` as in
    :func:`forward_trunk`."""
    x = encode_inputs(cfg, params, batch)
    x = forward_trunk(cfg, params, x, remat=remat, remat_policy=remat_policy)
    return _unembed(cfg, params, x)


def loss_fn(cfg: ArchConfig, params: dict, batch: dict,
            z_loss: float = 1e-4, remat: bool = True,
            remat_policy: str = "nothing") -> torch.Tensor:
    """Mean next-token NLL plus the z-loss over labels >= 0 (value only)."""
    logits = forward(cfg, params, batch, remat=remat,
                     remat_policy=remat_policy)         # (B, T, V) f32
    if L.is_dtensor(logits):
        return _loss_sharded(logits, batch["labels"], z_loss)
    labels = torch.as_tensor(batch["labels"], device=logits.device).long()
    valid = (labels >= 0).to(F32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        torch.clamp(labels, min=0)[..., None])[..., 0]
    nll = (lse - gold) * valid
    zl = z_loss * torch.square(lse) * valid
    return (nll.sum() + zl.sum()) / torch.clamp(valid.sum(), min=1.0)


def _all_reduce(t: torch.Tensor, op: str, groups) -> torch.Tensor:
    """``t`` reduced over each process group in turn."""
    for g in groups:
        t = all_reduce(t, op, g)
    return t


class _VocabShardedLoss(torch.autograd.Function):
    """Per-token NLL and z-loss of one shard's logits (b, T, Vl) f32,
    whose vocabulary starts at ``v0``, the row maximum, the sum of
    exponentials and the gold logit reduced over the vocab shards'
    ``groups``.  The gradient is local: (softmax - onehot) and the
    z-loss term, from the saved softmax."""

    @staticmethod
    def forward(ctx, logits, labels, v0: int, groups, z_loss: float):
        valid = (labels >= 0).to(F32)
        m = _all_reduce(torch.amax(logits, dim=-1), "max", groups)
        e = torch.exp(logits - m[..., None])
        se = _all_reduce(torch.sum(e, dim=-1), "sum", groups)
        lse = m + torch.log(se)
        lab = torch.clamp(labels, min=0) - v0
        inside = (lab >= 0) & (lab < logits.shape[-1])
        idx = torch.where(inside, lab, 0)
        gold = torch.gather(logits, -1, idx[..., None])[..., 0]
        gold = _all_reduce(gold * inside.to(F32), "sum", groups)
        ctx.save_for_backward(e / se[..., None], idx, inside, valid, lse)
        ctx.z_loss = z_loss
        return (lse - gold) * valid, z_loss * torch.square(lse) * valid

    @staticmethod
    def backward(ctx, g_nll, g_zl):
        soft, idx, inside, valid, lse = ctx.saved_tensors
        onehot = torch.zeros_like(soft).scatter_(
            -1, idx[..., None], inside[..., None].to(F32))
        grad = (g_nll * valid)[..., None] * (soft - onehot) \
            + (g_zl * valid * 2.0 * ctx.z_loss * lse)[..., None] * soft
        return grad, None, None, None, None


def _loss_sharded(logits, labels, z_loss: float):
    """:func:`loss_fn`'s value on DTensor logits (B, T, V), each shard
    holding its rows of the batch.  Where the vocabulary is sharded
    (``gather`` has no sharding strategy, and DTensor's own reductions
    gather the whole logits in the backward): the vocab-parallel cross
    entropy, each shard's vocabulary slice local, three (B, T)
    all-reduces over the vocab shards — the same loss, its rounding not
    ``torch.logsumexp``'s.  Where it is whole: the plain formulas on
    each shard's rows."""
    from torch.distributed.tensor import DTensor, Replicate
    logits = L.as_batch_vocab(logits)
    mesh = logits.device_mesh
    labels = L._redistribute(
        L.as_batch(labels),
        [p if p.is_shard() and p.dim == 0 else Replicate()
         for p in logits.placements]).long()
    vocab = [i for i, d in L.sharding_dims(logits) if d == 2]
    lg, lab = logits.to_local(), labels.to_local()
    if vocab:
        coord = mesh.get_coordinate() or [0] * mesh.ndim
        vl, v0 = lg.shape[-1], 0
        for i in reversed(vocab):             # the last mesh dim is minor
            v0 += coord[i] * vl
            vl *= mesh.shape[i]
        nll, zl = _VocabShardedLoss.apply(
            lg, lab, v0, [mesh.get_group(i) for i in vocab], z_loss)
    else:
        valid = (lab >= 0).to(F32)
        lse = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1,
                            torch.clamp(lab, min=0)[..., None])[..., 0]
        nll = (lse - gold) * valid
        zl = z_loss * torch.square(lse) * valid
    tok = [p if p.is_shard() and p.dim == 0 else Replicate()
           for p in logits.placements]
    nll, zl = (DTensor.from_local(t, mesh, tok, run_check=False,
                                  shape=labels.shape,
                                  stride=labels.stride()) for t in (nll, zl))
    valid = (labels >= 0).to(F32)
    return (nll.sum() + zl.sum()) / torch.clamp(valid.sum(), min=1.0)


# ---------------------------------------------------------------------------
# Serving: prefill + cached decode
# ---------------------------------------------------------------------------

def _attn_cache_len(cfg: ArchConfig, cache_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(cfg.sliding_window, cache_len)
    return cache_len


def init_sublayer_cache(cfg: ArchConfig, kind: str, B: int, cache_len: int,
                        dtype, *, device=None) -> dict:
    if kind == "attn":
        s = _attn_cache_len(cfg, cache_len)
        shape = (B, s, cfg.n_kv_heads, cfg.head_dim_)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device),
                "pos": torch.zeros((B,), dtype=torch.int32, device=device)}
    if kind == "mamba":
        return S.mamba_init_state(cfg.d_inner, cfg.d_state, cfg.d_conv, B,
                                  dtype, device)
    if kind == "rwkv6":
        return S.rwkv6_init_state(B, cfg.d_model, cfg.rwkv_head_dim, dtype,
                                  device)
    raise ValueError(kind)


def init_cache(cfg: ArchConfig, B: int, cache_len: int, fill: int = 0, *,
               device=None) -> dict:
    """Stacked per-superblock caches, a leading n_superblocks axis on
    every leaf of each sublayer s<i>'s cache: attention k and v (B, S,
    KV, hd) in the activation dtype and pos (B,) int32; Mamba conv and
    ssm; RWKV-6 time and channel states.  ``fill`` goes into the 2-D
    int32 leaves (attention pos), as in the reference.  On ``device``
    (keyword only; default: the card)."""
    device = ops.resolve_device(device)
    dtype = _adtype(cfg)
    n = cfg.n_superblocks
    one = {f"s{i}": init_sublayer_cache(cfg, kind, B, cache_len, dtype,
                                        device=device)
           for i, kind in enumerate(cfg.block_pattern)}

    def stack(x):
        x = x.expand((n,) + tuple(x.shape)).clone()
        if fill and x.dtype == torch.int32 and x.ndim == 2:
            x.fill_(fill)
        return x
    return tree_map(stack, one)


def _stack(caches: list) -> dict:
    return {k: (_stack([c[k] for c in caches]) if isinstance(v, dict)
                else torch.stack([c[k] for c in caches]))
            for k, v in caches[0].items()}


def _apply_sublayer_decode(cfg: ArchConfig, kind: str, is_moe: bool,
                           p: dict, cache: dict, x: torch.Tensor):
    x = L.as_batch(x)
    h = L.rms_norm(x, p["norm1"], cfg.rms_eps)
    if kind == "attn":
        h, new_cache = L.attention_decode(
            h, cache, p["mixer"], n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            head_dim=cfg.head_dim_, theta=cfg.rope_theta,
            window=cfg.sliding_window)
    elif kind == "mamba":
        h, new_cache = S.mamba_decode(h, cache, p["mixer"],
                                      d_state=cfg.d_state)
    elif kind == "rwkv6":
        h, tstate = S.rwkv6_time_mix_decode(h, cache["time"], p["mixer"],
                                            head_dim=cfg.rwkv_head_dim)
        new_cache = {"time": tstate, "channel": cache["channel"]}
    x = x + L.as_batch(h)
    h = L.rms_norm(x, p["norm2"], cfg.rms_eps)
    if kind == "rwkv6":
        h, cstate = S.rwkv6_channel_mix(h, p["ffn"], state=cache["channel"],
                                        return_state=True)
        new_cache = {"time": new_cache["time"], "channel": cstate}
    elif is_moe:
        h = _moe(cfg, p["ffn"], h)
    else:
        h = L.mlp(h, p["ffn"], cfg.activation)
    return x + L.as_batch(h), new_cache


def decode_step(cfg: ArchConfig, params: dict, cache: dict,
                batch: dict) -> tuple[torch.Tensor, dict]:
    """One-token decode. batch: {'tokens': (B, 1)} or {'embeds': (B, 1,
    D)} -> logits (B, 1, V) f32 and the new cache (the old one is left as
    it was).  MoE layers are picked by their index within the period, as
    the reference's scan body picks them."""
    x = encode_inputs(cfg, params, batch)
    blocks = _unbind(params["blocks"], cfg.n_superblocks)
    caches = _unbind(cache, cfg.n_superblocks)
    new_caches = []
    for sb in range(cfg.n_superblocks):
        block_p, blk_cache = gather_params(blocks[sb]), caches[sb]
        nc_sb = {}
        for i, kind in enumerate(cfg.block_pattern):
            x, nc_sb[f"s{i}"] = _apply_sublayer_decode(
                cfg, kind, cfg.is_moe_layer(i), block_p[f"s{i}"],
                blk_cache[f"s{i}"], x)
        new_caches.append(nc_sb)
    return _unembed(cfg, params, x), _stack(new_caches)


def _attn_prefill_cache(cfg: ArchConfig, hn: torch.Tensor, p: dict,
                        cache_len: int) -> dict:
    """The attention cache of a prompt: rotated k and v, zero-padded to
    the cache length, or its last positions in ring layout."""
    B, T = hn.shape[0], hn.shape[1]
    dtype = _adtype(cfg)
    s = _attn_cache_len(cfg, cache_len)
    k = L.einsum("btd,dhk->bthk", hn, p["wk"], F32).to(dtype)
    v = L.einsum("btd,dhk->bthk", hn, p["wv"], F32).to(dtype)
    pos = torch.arange(T, dtype=torch.int32, device=hn.device)[None]
    k = L.apply_rope(k, pos.expand(B, T), cfg.rope_theta)
    # Along the sequence, which no layout shards: DTensors pad and roll
    # shard by shard (torch 2.11's DTensor cannot redistribute for pad).
    if s >= T:
        pad = (0, 0, 0, 0, 0, s - T)
        kc, vc = (L.same_local(
            lambda t: torch.nn.functional.pad(t, pad), t) for t in (k, v))
    else:   # keep the last s positions (ring layout: slot=pos%s)
        roll = (T - s) % s
        kc, vc = (L.same_local(
            lambda t: torch.roll(t[:, T - s:], shifts=roll, dims=1), t)
            for t in (k, v))
    return {"k": kc, "v": vc,
            "pos": torch.full((B,), T, dtype=torch.int32, device=hn.device)}


def prefill(cfg: ArchConfig, params: dict, batch: dict,
            cache_len: Optional[int] = None) -> tuple[torch.Tensor, dict]:
    """Process a full prompt, returning logits and a primed cache.

    Attention here takes the 'xla' form whatever ``attention_impl`` says,
    as in the JAX package; MoE layers are picked by their index within
    the period, as there."""
    x = encode_inputs(cfg, params, batch)
    cache_len = cache_len or x.shape[1]
    caches = []
    for block_p in _unbind(params["blocks"], cfg.n_superblocks):
        block_p = gather_params(block_p)
        nc_sb = {}
        for i, kind in enumerate(cfg.block_pattern):
            p = block_p[f"s{i}"]
            x = L.as_batch(x)
            hn = L.rms_norm(x, p["norm1"], cfg.rms_eps)
            if kind == "attn":
                hm = L.attention_train(hn, p["mixer"], n_heads=cfg.n_heads,
                                       n_kv=cfg.n_kv_heads,
                                       head_dim=cfg.head_dim_,
                                       theta=cfg.rope_theta,
                                       window=cfg.sliding_window)
                nc = _attn_prefill_cache(cfg, hn, p["mixer"], cache_len)
            elif kind == "mamba":
                hm, nc = _mamba_prefill(cfg, hn, p["mixer"])
            elif kind == "rwkv6":
                hm, tstate = S.rwkv6_time_mix(hn, p["mixer"],
                                              head_dim=cfg.rwkv_head_dim,
                                              return_state=True)
                nc = {"time": tstate}
            x = x + L.as_batch(hm)
            hn = L.rms_norm(x, p["norm2"], cfg.rms_eps)
            if kind == "rwkv6":
                hf, nc["channel"] = S.rwkv6_channel_mix(hn, p["ffn"],
                                                        return_state=True)
            elif cfg.is_moe_layer(i):
                hf = _moe(cfg, p["ffn"], hn)
            else:
                hf = L.mlp(hn, p["ffn"], cfg.activation)
            x = x + L.as_batch(hf)
            nc_sb[f"s{i}"] = nc
        caches.append(nc_sb)
    return _unembed(cfg, params, x), _stack(caches)


def _mamba_prefill(cfg: ArchConfig, x: torch.Tensor, p: dict):
    """Mamba over the prompt + final state for decode (single pass)."""
    return S.mamba_train(x, p, d_state=cfg.d_state, return_state=True)
