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
Gradients and training wait for a later slice (ROADMAP, queue 1).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
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


def _index(tree, i: int):
    return tree_map(lambda x: x[i], tree)


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

def _init(gen: torch.Generator, shape, dtype,
          scale: Optional[float] = None) -> torch.Tensor:
    """N(0, 1) * scale drawn in f32, cast to ``dtype`` (``shape[0] **
    -0.5`` by default, as the JAX package's ``_init``)."""
    scale = scale if scale is not None else shape[0] ** -0.5
    return torch.randn(shape, generator=gen, dtype=F32,
                       device=gen.device).mul_(scale).to(dtype)


def _full(shape, value: float, dtype, gen: torch.Generator) -> torch.Tensor:
    return torch.full(shape, value, dtype=dtype, device=gen.device)


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
    a_log = torch.log(torch.arange(1, ds + 1, dtype=F32, device=gen.device))
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


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random parameters of the JAX package's shapes, scales and dtypes,
    drawn from ``generator`` on its device and placed on ``device``
    (default: the card).  The two frameworks' generators differ, so the
    values do not match JAX's; tests carry JAX's parameters across with
    :func:`params_from_numpy` instead.  Sublayers are drawn one at a
    time and copied into the stacked leaves, so a full-width model needs
    one sublayer's parameters (and its largest f32 draw) beside its
    own."""
    device = ops.resolve_device(device)
    gen = generator
    dt = _dtype(cfg)
    params: dict[str, Any] = {
        "embed": _init(gen, (cfg.vocab_size, cfg.d_model), dt, scale=0.02),
        "final_norm": _full((cfg.d_model,), 1.0, F32, gen),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = _init(gen, (cfg.d_model, cfg.vocab_size), dt)
    params = tree_map(lambda x: x.to(device), params)
    n, period = cfg.n_superblocks, cfg.pattern_period
    blocks: dict[str, Any] = {}
    for sb in range(n):
        for i in range(period):
            one = init_sublayer_params(cfg, gen, sb * period + i)
            if sb == 0:
                blocks[f"s{i}"] = tree_map(
                    lambda x: torch.empty((n,) + tuple(x.shape),
                                          dtype=x.dtype, device=device),
                    one)
            _put(blocks[f"s{i}"], one, sb)
            del one
    params["blocks"] = blocks
    return params


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
    x = x + h
    h = L.rms_norm(x, p["norm2"], cfg.rms_eps)
    if kind == "rwkv6":
        h = S.rwkv6_channel_mix(h, p["ffn"])
    elif is_moe:
        h = _moe(cfg, p["ffn"], h)
    else:
        h = L.mlp(h, p["ffn"], cfg.activation)
    return x + h


def superblock_apply(cfg: ArchConfig, block_params: dict,
                     x: torch.Tensor, sb_index: int = 0) -> torch.Tensor:
    """One period of the block pattern."""
    for i, kind in enumerate(cfg.block_pattern):
        layer_idx = sb_index * cfg.pattern_period + i
        x = _apply_sublayer(cfg, kind, cfg.is_moe_layer(layer_idx),
                            block_params[f"s{i}"], x)
    return x


# The JAX package's rematerialization policies, by name.
REMAT_POLICIES = ("nothing", "dots_no_batch", "everything")


def forward_trunk(cfg: ArchConfig, params: dict, x: torch.Tensor,
                  remat: bool = True,
                  remat_policy: str = "nothing") -> torch.Tensor:
    """The superblocks in turn.  ``remat`` and ``remat_policy`` are the
    reference's arguments, with its defaults; an unknown policy raises
    ``KeyError`` as there.  Values do not depend on either: they take
    effect once training is ported (ROADMAP, queue 1)."""
    if remat_policy not in REMAT_POLICIES:
        raise KeyError(remat_policy)
    for sb in range(cfg.n_superblocks):
        x = superblock_apply(cfg, _index(params["blocks"], sb), x, sb)
    return x


def encode_inputs(cfg: ArchConfig, params: dict,
                  batch: dict) -> torch.Tensor:
    """Token embedding, or the stubbed modality frontend's embeddings."""
    dev = params["embed"].device
    if cfg.frontend is not None:
        return torch.as_tensor(batch["embeds"], device=dev).to(_adtype(cfg))
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    return params["embed"][tokens.long()].to(_adtype(cfg))


def _unembed(cfg: ArchConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    x = L.rms_norm(x, params["final_norm"], cfg.rms_eps)
    unembed = (params["embed"].T if cfg.tie_embeddings
               else params["unembed"])
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
    x = x + h
    h = L.rms_norm(x, p["norm2"], cfg.rms_eps)
    if kind == "rwkv6":
        h, cstate = S.rwkv6_channel_mix(h, p["ffn"], state=cache["channel"],
                                        return_state=True)
        new_cache = {"time": new_cache["time"], "channel": cstate}
    elif is_moe:
        h = _moe(cfg, p["ffn"], h)
    else:
        h = L.mlp(h, p["ffn"], cfg.activation)
    return x + h, new_cache


def decode_step(cfg: ArchConfig, params: dict, cache: dict,
                batch: dict) -> tuple[torch.Tensor, dict]:
    """One-token decode. batch: {'tokens': (B, 1)} or {'embeds': (B, 1,
    D)} -> logits (B, 1, V) f32 and the new cache (the old one is left as
    it was).  MoE layers are picked by their index within the period, as
    the reference's scan body picks them."""
    x = encode_inputs(cfg, params, batch)
    new_caches = []
    for sb in range(cfg.n_superblocks):
        block_p = _index(params["blocks"], sb)
        blk_cache = _index(cache, sb)
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
    if s >= T:
        pad = (0, 0, 0, 0, 0, s - T)
        kc = torch.nn.functional.pad(k, pad)
        vc = torch.nn.functional.pad(v, pad)
    else:   # keep the last s positions (ring layout: slot=pos%s)
        roll = (T - s) % s
        kc = torch.roll(k[:, T - s:], shifts=roll, dims=1)
        vc = torch.roll(v[:, T - s:], shifts=roll, dims=1)
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
    for sb in range(cfg.n_superblocks):
        block_p = _index(params["blocks"], sb)
        nc_sb = {}
        for i, kind in enumerate(cfg.block_pattern):
            p = block_p[f"s{i}"]
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
            x = x + hm
            hn = L.rms_norm(x, p["norm2"], cfg.rms_eps)
            if kind == "rwkv6":
                hf, nc["channel"] = S.rwkv6_channel_mix(hn, p["ffn"],
                                                        return_state=True)
            elif cfg.is_moe_layer(i):
                hf = _moe(cfg, p["ffn"], hn)
            else:
                hf = L.mlp(hn, p["ffn"], cfg.activation)
            x = x + hf
            nc_sb[f"s{i}"] = nc
        caches.append(nc_sb)
    return _unembed(cfg, params, x), _stack(caches)


def _mamba_prefill(cfg: ArchConfig, x: torch.Tensor, p: dict):
    """Mamba over the prompt + final state for decode (single pass)."""
    return S.mamba_train(x, p, d_state=cfg.d_state, return_state=True)
