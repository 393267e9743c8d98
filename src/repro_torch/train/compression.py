"""Gradient compression for the inter-pod all-reduce (beyond-paper).

Port of ``repro/train/compression.py``: int8 block-quantized gradients
with stochastic rounding —

    q = clip(round_stochastic(g / scale), -127, 127)       (int8)
    scale = max|g| / 127 per 256-block                      (f32)
    psum(q_int32) / n_pods * scale_combined                 (dequantize)

Stochastic rounding keeps the estimator unbiased.  The random draws
come from an explicit ``torch.Generator``.

:func:`compressed_psum_leaf` is the reference's per-leaf arithmetic over
the pods' leaves stacked on a leading axis: its ``psum`` over ``'pod'``
is a sum over that axis, and every pod rounds with the same draws, as
every pod of the reference's ``shard_map`` holds the same key.
:func:`make_compressed_allreduce` is the same arithmetic over a device
mesh's ``'pod'`` dim, each rank holding its pod's leaves, with
functional collectives: the int8 payload summed in int32, the scales
gathered and summed in pod order (so the result is bitwise the stacked
version's).
"""

from __future__ import annotations

import torch

F32 = torch.float32
QBLOCK = 256


def _stochastic_round(x: torch.Tensor,
                      generator: torch.Generator) -> torch.Tensor:
    return _round_up_below(x, torch.rand(x.shape, generator=generator,
                                         dtype=F32, device=x.device))


def _round_up_below(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """floor(x), plus one where the uniform draw ``u`` < frac(x)."""
    floor = torch.floor(x)
    return floor + (u < x - floor)


def _blocks(flat: torch.Tensor, qblock: int) -> torch.Tensor:
    """(..., n) -> (..., nblocks, qblock) f32, the last axis zero-padded
    to a multiple of ``qblock``."""
    flat = torch.nn.functional.pad(flat.to(F32),
                                   (0, (-flat.shape[-1]) % qblock))
    return flat.reshape(*flat.shape[:-1], -1, qblock)


def _quantize_blocks(blocks: torch.Tensor, u: torch.Tensor):
    """Stochastic int8 of (..., nblocks, qblock) blocks with the draws
    ``u`` (nblocks, qblock): (q int8, scale f32 (..., nblocks))."""
    scale = torch.amax(torch.abs(blocks), dim=-1) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(_round_up_below(blocks / safe[..., None], u),
                    -127, 127).to(torch.int8)
    return q, scale


def _draws(blocks: torch.Tensor, generator: torch.Generator):
    return torch.rand(blocks.shape[-2:], generator=generator, dtype=F32,
                      device=blocks.device)


def quantize_stochastic(g: torch.Tensor, generator: torch.Generator,
                        qblock: int = QBLOCK):
    """g (any shape) -> (q int8 (nblocks, qblock), scale f32 (nblocks,))."""
    blocks = _blocks(g.reshape(-1), qblock)
    return _quantize_blocks(blocks, _draws(blocks, generator))


def dequantize(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.to(F32) * scale[:, None]).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(tuple(shape))


def compressed_psum_leaf(gs: torch.Tensor, generator: torch.Generator,
                         qblock: int = QBLOCK) -> torch.Tensor:
    """Mean over the leading (pod) axis of ``gs`` (n_pods, *shape) with
    the int8 wire format: each pod's leaf quantized with the same draws,
    the int8 payloads summed in int32 and the scales in f32, dequantized
    by the mean scale.  Returns (*shape) in ``gs``'s dtype."""
    n = gs.shape[0]
    shape = tuple(gs.shape[1:])
    blocks = _blocks(gs.reshape(n, -1), qblock)
    q, scale = _quantize_blocks(blocks, _draws(blocks, generator))
    qsum = q.to(torch.int32).sum(0)
    ssum = scale.sum(0)
    mean_scale = ssum / n
    deq = qsum.to(F32) * mean_scale[:, None] / n
    flat = deq.reshape(-1)
    m = 1
    for s in shape:
        m *= s
    return flat[:m].reshape(shape).to(gs.dtype)


def _psum_leaf_over(g: torch.Tensor, generator: torch.Generator, group,
                    qblock: int = QBLOCK) -> torch.Tensor:
    """:func:`compressed_psum_leaf` of the group's leaves, each rank
    holding its own ``g``: the same draws on every rank (a generator
    seeded alike), the int32 payload all-reduced, the f32 scales
    gathered and summed in rank order as the stacked sum adds them."""
    from repro_torch.distribution.collectives import all_gather, all_reduce
    n = group.size()
    blocks = _blocks(g.reshape(-1), qblock)
    q, scale = _quantize_blocks(blocks, _draws(blocks, generator))
    qsum = all_reduce(q.to(torch.int32), "sum", group)
    ssum = all_gather(scale, group).sum(0)
    mean_scale = ssum / n
    deq = qsum.to(F32) * mean_scale[:, None] / n
    flat = deq.reshape(-1)
    return flat[:g.numel()].reshape(g.shape).to(g.dtype)


def make_compressed_allreduce(mesh, axis: str = "pod"):
    """(tree, generator) -> tree with leaves mean-reduced over the
    ``axis`` dim of the ``DeviceMesh`` ``mesh`` (the rank's pod group)
    in the int8 wire format.  Every rank passes a generator seeded
    alike; leaves draw from it in the tree's leaf order (dict keys
    sorted)."""
    from repro_torch.train.optimizer import tree_leaves, tree_unflatten
    group = mesh.get_group(axis)

    def fn(tree, generator: torch.Generator):
        out = [_psum_leaf_over(leaf, generator, group)
               for leaf in tree_leaves(tree)]
        return tree_unflatten(tree, out)
    return fn
