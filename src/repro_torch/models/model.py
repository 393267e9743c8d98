"""Decoder LM assembled from the ArchConfig block pattern.

Port of ``repro/models/model.py`` for the attention-only dense stack:
the inference path (forward, loss value, prefill, cached decode).
Parameters are a dict of tensors under the JAX package's names, with
each block leaf stacked over superblocks on a leading axis, so that
:func:`params_from_numpy` carries the reference's parameters across
leaf for leaf.  The JAX package scans over that axis; the port loops.

Public API:
  init_params(cfg, generator, device)       -> params dict
  params_from_numpy(cfg, tree, device)      -> params dict
  forward(cfg, params, batch)               -> logits (train/prefill path)
  loss_fn(cfg, params, batch)               -> scalar loss (value only)
  init_cache(cfg, B, cache_len, fill=0, *, device) -> decode cache dict
  prefill(cfg, params, batch, cache_len)    -> logits, cache
  decode_step(cfg, params, cache, batch)    -> logits, cache

The functions that make tensors put them on the card unless ``device``
names another (``"cpu"``); the others run where the parameters are.

Mamba and RWKV-6 blocks, MoE layers and modality frontends raise
``NotImplementedError``: they wait for later slices of the port
(ROADMAP, queue 1).  Gradients and training wait too.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L

F32 = torch.float32


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def _adtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.activation_dtype)


def check_supported(cfg: ArchConfig) -> None:
    """Raise unless the port runs every layer of ``cfg``."""
    kinds = set(cfg.block_pattern) - {"attn"}
    if kinds:
        raise NotImplementedError(
            f"{cfg.name}: {sorted(kinds)} blocks (repro/models/ssm.py) are "
            f"not ported yet (ROADMAP queue 1, LM stack: MoE and ssm.py)")
    if cfg.moe_period:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers (layers.moe) are not ported yet "
            f"(ROADMAP queue 1, LM stack: MoE and ssm.py)")
    if cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend} frontend's embeds input is not "
            f"ported yet (ROADMAP queue 1, LM stack)")


def tree_map(fn, tree):
    """``fn`` over every tensor of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _index(tree, i: int):
    return tree_map(lambda x: x[i], tree)


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

def _init(gen: torch.Generator, shape, dtype, scale: Optional[float] = None,
          stack: int = 0) -> torch.Tensor:
    """N(0, 1) * scale in f32, cast to ``dtype`` (``shape[0] ** -0.5`` by
    default, as the JAX package's ``_init``); with ``stack`` > 0, that
    many draws stacked on a leading axis, one at a time so the f32
    temporary stays one draw."""
    scale = scale if scale is not None else shape[0] ** -0.5
    out = torch.empty(((stack,) if stack else ()) + tuple(shape),
                      dtype=dtype, device=gen.device)
    for dst in (out if stack else [out]):
        dst.copy_(torch.randn(shape, generator=gen, dtype=F32,
                              device=gen.device) * scale)
    return out


def _ones(n_stack: int, d: int, device) -> torch.Tensor:
    return torch.ones((n_stack, d), dtype=F32, device=device)


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random parameters of the JAX package's shapes, scales and dtypes,
    drawn from ``generator`` on its device and placed on ``device``
    (default: the card).  The two frameworks' generators differ, so the
    values do not match JAX's; tests carry JAX's parameters across with
    :func:`params_from_numpy` instead."""
    check_supported(cfg)
    device = ops.resolve_device(device)
    gen = generator
    dt = _dtype(cfg)
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    f, n = cfg.d_ff, cfg.n_superblocks
    g = 2 if cfg.gated_mlp else 1
    params: dict[str, Any] = {
        "embed": _init(gen, (cfg.vocab_size, d), dt, scale=0.02),
        "final_norm": torch.ones((d,), dtype=F32, device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = _init(gen, (d, cfg.vocab_size), dt)
    params["blocks"] = {
        f"s{i}": {
            "norm1": _ones(n, d, gen.device),
            "norm2": _ones(n, d, gen.device),
            "mixer": {
                "wq": _init(gen, (d, h, hd), dt, stack=n),
                "wk": _init(gen, (d, kv, hd), dt, stack=n),
                "wv": _init(gen, (d, kv, hd), dt, stack=n),
                "wo": _init(gen, (h, hd, d), dt, scale=(h * hd) ** -0.5,
                            stack=n)},
            "ffn": {"wi": _init(gen, (d, g, f), dt, stack=n),
                    "wo": _init(gen, (f, d), dt, stack=n)},
        } for i in range(cfg.pattern_period)}
    return tree_map(lambda x: x.to(device), params)


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
    check_supported(cfg)
    device = ops.resolve_device(device)
    return tree_map(lambda a: _tensor(a).to(device), tree)


# ---------------------------------------------------------------------------
# Forward (train / prefill trunk)
# ---------------------------------------------------------------------------

def _apply_sublayer(cfg: ArchConfig, p: dict,
                    x: torch.Tensor) -> torch.Tensor:
    h = L.rms_norm(x, p["norm1"], cfg.rms_eps)
    h = L.attention_train(h, p["mixer"], n_heads=cfg.n_heads,
                          n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim_,
                          theta=cfg.rope_theta, window=cfg.sliding_window,
                          impl=cfg.attention_impl)
    x = x + h
    h = L.rms_norm(x, p["norm2"], cfg.rms_eps)
    return x + L.mlp(h, p["ffn"], cfg.activation)


def forward_trunk(cfg: ArchConfig, params: dict,
                  x: torch.Tensor) -> torch.Tensor:
    for sb in range(cfg.n_superblocks):
        block_p = _index(params["blocks"], sb)
        for i in range(cfg.pattern_period):
            x = _apply_sublayer(cfg, block_p[f"s{i}"], x)
    return x


def encode_inputs(cfg: ArchConfig, params: dict,
                  batch: dict) -> torch.Tensor:
    """Token embedding."""
    check_supported(cfg)
    tokens = torch.as_tensor(batch["tokens"], device=params["embed"].device)
    return params["embed"][tokens.long()].to(_adtype(cfg))


def _unembed(cfg: ArchConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    x = L.rms_norm(x, params["final_norm"], cfg.rms_eps)
    unembed = (params["embed"].T if cfg.tie_embeddings
               else params["unembed"])
    return L.einsum("btd,dv->btv", x, unembed, F32)


def forward(cfg: ArchConfig, params: dict, batch: dict) -> torch.Tensor:
    """batch {'tokens': (B, T)} -> logits (B, T, V) f32."""
    x = encode_inputs(cfg, params, batch)
    return _unembed(cfg, params, forward_trunk(cfg, params, x))


def loss_fn(cfg: ArchConfig, params: dict, batch: dict,
            z_loss: float = 1e-4) -> torch.Tensor:
    """Mean next-token NLL plus the z-loss over labels >= 0 (value only)."""
    logits = forward(cfg, params, batch)                # (B, T, V) f32
    labels = torch.as_tensor(batch["labels"], device=logits.device).long()
    valid = (labels >= 0).to(F32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        torch.clamp(labels, min=0)[..., None])[..., 0]
    nll = (lse - gold) * valid
    zl = z_loss * torch.square(lse) * valid
    return (nll.sum() + zl.sum()) / torch.clamp(valid.sum(), min=1.0)


# ---------------------------------------------------------------------------
# Serving: prefill + cached decode
# ---------------------------------------------------------------------------

def _attn_cache_len(cfg: ArchConfig, cache_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(cfg.sliding_window, cache_len)
    return cache_len


def init_cache(cfg: ArchConfig, B: int, cache_len: int, fill: int = 0, *,
               device=None) -> dict:
    """Stacked per-superblock caches: for each sublayer s<i>, k and v
    (n_superblocks, B, S, KV, hd) in the activation dtype, zero, and pos
    (n_superblocks, B) int32 holding ``fill`` (the reference fills its
    2-D int32 leaves, which are these), on ``device`` (keyword only;
    default: the card)."""
    check_supported(cfg)
    device = ops.resolve_device(device)
    dtype = _adtype(cfg)
    s = _attn_cache_len(cfg, cache_len)
    shape = (cfg.n_superblocks, B, s, cfg.n_kv_heads, cfg.head_dim_)
    return {f"s{i}": {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((cfg.n_superblocks, B), fill, dtype=torch.int32,
                          device=device)}
        for i in range(cfg.pattern_period)}


def _stack(caches: list) -> dict:
    return {k: (_stack([c[k] for c in caches]) if isinstance(v, dict)
                else torch.stack([c[k] for c in caches]))
            for k, v in caches[0].items()}


def decode_step(cfg: ArchConfig, params: dict, cache: dict,
                batch: dict) -> tuple[torch.Tensor, dict]:
    """One-token decode. batch: {'tokens': (B, 1)} -> logits (B, 1, V)
    f32 and the new cache (the old one is left as it was)."""
    x = encode_inputs(cfg, params, batch)
    new_caches = []
    for sb in range(cfg.n_superblocks):
        block_p = _index(params["blocks"], sb)
        blk_cache = _index(cache, sb)
        nc_sb = {}
        for i in range(cfg.pattern_period):
            p = block_p[f"s{i}"]
            h = L.rms_norm(x, p["norm1"], cfg.rms_eps)
            h, nc_sb[f"s{i}"] = L.attention_decode(
                h, blk_cache[f"s{i}"], p["mixer"], n_heads=cfg.n_heads,
                n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim_,
                theta=cfg.rope_theta, window=cfg.sliding_window)
            x = x + h
            h = L.rms_norm(x, p["norm2"], cfg.rms_eps)
            x = x + L.mlp(h, p["ffn"], cfg.activation)
        new_caches.append(nc_sb)
    return _unembed(cfg, params, x), _stack(new_caches)


def prefill(cfg: ArchConfig, params: dict, batch: dict,
            cache_len: Optional[int] = None) -> tuple[torch.Tensor, dict]:
    """Process a full prompt, returning logits and a primed cache.

    Attention here takes the 'xla' form whatever ``attention_impl`` says,
    as in the JAX package."""
    x = encode_inputs(cfg, params, batch)
    B, T = x.shape[0], x.shape[1]
    cache_len = cache_len or T
    dtype = _adtype(cfg)
    s = _attn_cache_len(cfg, cache_len)
    pos = torch.arange(T, dtype=torch.int32, device=x.device)[None]
    pos = pos.expand(B, T)
    caches = []
    for sb in range(cfg.n_superblocks):
        block_p = _index(params["blocks"], sb)
        nc_sb = {}
        for i in range(cfg.pattern_period):
            p = block_p[f"s{i}"]
            hn = L.rms_norm(x, p["norm1"], cfg.rms_eps)
            hm = L.attention_train(hn, p["mixer"], n_heads=cfg.n_heads,
                                   n_kv=cfg.n_kv_heads,
                                   head_dim=cfg.head_dim_,
                                   theta=cfg.rope_theta,
                                   window=cfg.sliding_window)
            k = L.einsum("btd,dhk->bthk", hn, p["mixer"]["wk"],
                          F32).to(dtype)
            v = L.einsum("btd,dhk->bthk", hn, p["mixer"]["wv"],
                          F32).to(dtype)
            k = L.apply_rope(k, pos, cfg.rope_theta)
            if s >= T:
                pad = (0, 0, 0, 0, 0, s - T)
                kc = torch.nn.functional.pad(k, pad)
                vc = torch.nn.functional.pad(v, pad)
            else:   # keep the last s positions (ring layout: slot=pos%s)
                roll = (T - s) % s
                kc = torch.roll(k[:, T - s:], shifts=roll, dims=1)
                vc = torch.roll(v[:, T - s:], shifts=roll, dims=1)
            nc_sb[f"s{i}"] = {
                "k": kc, "v": vc,
                "pos": torch.full((B,), T, dtype=torch.int32,
                                  device=x.device)}
            x = x + hm
            hn = L.rms_norm(x, p["norm2"], cfg.rms_eps)
            x = x + L.mlp(hn, p["ffn"], cfg.activation)
        caches.append(nc_sb)
    return _unembed(cfg, params, x), _stack(caches)
