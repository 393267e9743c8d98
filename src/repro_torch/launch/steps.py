"""Step functions + abstract input specs for every (arch x shape) cell.

Port of ``repro/launch/steps.py``:
  * train_step: fwd + bwd + AdamW update, in place
  * prefill_step: prompt -> logits + primed cache (no graph recorded)
  * decode_step: one token against a cache (no graph recorded)

The specs are tensors on the ``meta`` device — shapes and dtypes, no
allocation — leaf for leaf the reference's ``jax.eval_shape`` trees.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import model as M
from repro_torch.train.optimizer import (
    OptimizerConfig, apply_updates, init_opt_state, tree_leaves,
    tree_unflatten)

META = torch.device("meta")


# ---------------------------------------------------------------------------
# Step functions
# ---------------------------------------------------------------------------

def value_and_grad(cfg: ArchConfig, params: dict, batch: dict, **kw):
    """(loss, grads) of :func:`M.loss_fn` at ``params``, grads a tree of
    ``params``' structure and dtypes (a parameter the loss does not
    reach gets zeros, as under ``jax.grad``).  Gradients are taken with
    respect to detached views of the parameters, which share their
    storage: the caller's tensors keep ``requires_grad=False``, so
    serving the same tensors later records no graph."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = M.loss_fn(cfg, tree_unflatten(params, leaves), batch, **kw)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), tree_unflatten(params, grads)


def make_train_step(cfg: ArchConfig, opt_cfg: OptimizerConfig,
                    remat: bool = True):
    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(cfg, params, batch, remat=remat)
        params, opt_state, metrics = apply_updates(
            params, grads, opt_state, opt_cfg)
        metrics["loss"] = loss
        return params, opt_state, metrics
    return train_step


def make_prefill_step(cfg: ArchConfig, cache_len: int):
    @torch.no_grad()
    def prefill_step(params, batch):
        return M.prefill(cfg, params, batch, cache_len=cache_len)
    return prefill_step


def make_decode_step(cfg: ArchConfig):
    @torch.no_grad()
    def decode_step(params, cache, batch):
        return M.decode_step(cfg, params, cache, batch)
    return decode_step


# ---------------------------------------------------------------------------
# Abstract specs (meta tensors, no allocation)
# ---------------------------------------------------------------------------

def sds(shape, dtype) -> torch.Tensor:
    """The counterpart of ``jax.ShapeDtypeStruct``: a meta tensor."""
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict[str, Any]:
    """Model inputs for one shape cell (tokens/embeds/labels)."""
    B, S = shape.global_batch, shape.seq_len
    adt = getattr(torch, cfg.activation_dtype)
    if shape.kind == "train":
        batch: dict[str, Any] = {"labels": sds((B, S), torch.int32)}
        if cfg.frontend is not None:
            batch["embeds"] = sds((B, S, cfg.d_model), adt)
        else:
            batch["tokens"] = sds((B, S), torch.int32)
        return batch
    if shape.kind == "prefill":
        if cfg.frontend is not None:
            return {"embeds": sds((B, S, cfg.d_model), adt)}
        return {"tokens": sds((B, S), torch.int32)}
    if shape.kind == "decode":
        if cfg.frontend is not None:
            return {"embeds": sds((B, 1, cfg.d_model), adt)}
        return {"tokens": sds((B, 1), torch.int32)}
    raise ValueError(shape.kind)


def param_specs(cfg: ArchConfig) -> Any:
    return M.init_params(cfg, None, META)


def opt_state_specs(cfg: ArchConfig, opt_cfg: OptimizerConfig) -> Any:
    return init_opt_state(param_specs(cfg), opt_cfg)


def cache_specs(cfg: ArchConfig, shape: ShapeConfig) -> Any:
    return M.init_cache(cfg, shape.global_batch, shape.seq_len, device=META)

