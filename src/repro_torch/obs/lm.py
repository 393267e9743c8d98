"""Ranges and counters of the LM forward, on the profiler's clock.

The model path (``models/model.py``, ``models/layers.py``) names its
stages with :func:`stage` and counts its work with the ``count_*``
helpers.  Recording is on exactly while ``torch.profiler`` records, or
inside :func:`recording` (for an operator without a
profiler).  When it is off, :func:`stage` returns one shared no-op
context manager and every counter helper returns after one test: no
range is entered, nothing is launched on the device and nothing is
synchronised.

When it is on:

* each stage is a ``record_function`` range named from :data:`STAGES`,
  so that a profile's kernels fall under the stage that launched them,
  on the same Kineto timeline as the kernels.  The ranges are flat: no
  stage opens inside another.  Nothing else is put on the device's
  stream: a CUDA event recorded during a profile moves the profiler's
  attribution of device time to ranges (measured on the H100: the MoE
  ranges read 4 points more of busy time with a timing event at each
  stage, inside its range or just outside it), so stage time is read
  from the profile;
* ``tokens`` counts the positions the forward embeds, and
  ``product_ops`` the operations of every ``layers.einsum`` (2 x the
  product of the sizes of every index), from the operands' shapes on
  the host, by the dtype the product runs in;
* ``moe_choices`` (G * Sg * K), ``moe_slots`` (G * E * capacity) and
  ``moe_kept`` (the choices under capacity) count the MoE's routing.

The keep masks are held as they are and summed on the device when a
snapshot is taken, so a recorded call launches nothing for its counts
and waits for nothing.  A recording that holds more than ``_HOLD`` of
them sums them then.

``obs.Tracer`` is the other clock of this package: host spans of the
runtime, the store and the workflow on ``time.monotonic``.  The LM's
time is the card's, which only the profiler's timeline can attribute,
so these ranges live there.
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.autograd import profiler as _profiler

STAGES = ("embed", "norm", "attn.qkv", "attn.rope", "attn.core", "attn.out",
          "mlp", "moe.route", "moe.dispatch", "moe.experts", "moe.combine",
          "mamba", "rwkv6.time", "rwkv6.channel", "unembed")
_NAMES = frozenset(STAGES)
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16",
           torch.float16: "f16"}
_HOLD = 4096

_OFF = contextlib.nullcontext()
_forced = 0
_count = {"tokens": 0, "moe_choices": 0, "moe_slots": 0}
_ops: dict = {}
_kept: dict = {}          # device -> int64 scalar on that device
_keep: list = []          # keep masks not summed yet


def on() -> bool:
    """Whether ranges and counters record now."""
    return _forced > 0 or _profiler._is_profiler_enabled


@contextlib.contextmanager
def recording():
    """Record ranges and counters without a profiler."""
    global _forced
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


def stage(name: str):
    """The range of one stage of the forward (a name of :data:`STAGES`),
    or the shared no-op when recording is off."""
    if not on():
        return _OFF
    if name not in _NAMES:
        raise ValueError(f"unknown stage {name!r}; stages: {STAGES}")
    return torch.profiler.record_function(name)


@functools.lru_cache(maxsize=None)
def _operands(eq: str) -> tuple:
    la, lb = eq.split("->")[0].split(",")
    return la, lb


def count_tokens(shape) -> None:
    """Positions one forward embeds (its embeddings' ``shape``, batch
    and sequence first)."""
    if not on():
        return
    _count["tokens"] += int(shape[0]) * int(shape[1])


def count_einsum(eq: str, a: torch.Tensor, b: torch.Tensor,
                 dtype: torch.dtype) -> None:
    """Operations of ``einsum(eq, a, b)`` run in ``dtype``."""
    if not on():
        return
    la, lb = _operands(eq)
    sizes = {**dict(zip(lb, b.shape)), **dict(zip(la, a.shape))}
    ops = 2
    for n in sizes.values():
        ops *= int(n)
    key = _DTYPES.get(dtype, str(dtype).replace("torch.", ""))
    _ops[key] = _ops.get(key, 0) + ops


def count_moe(choices: int, slots: int, keep: torch.Tensor) -> None:
    """One MoE layer's routing: its choices, its expert slots, and
    ``keep`` (True where a choice is under capacity)."""
    if not on():
        return
    _count["moe_choices"] += int(choices)
    _count["moe_slots"] += int(slots)
    _keep.append(keep)
    if len(_keep) > _HOLD:
        _sum_kept()


def _sum_kept() -> None:
    """Add the held keep masks to their device's count."""
    for keep in _keep:
        n = keep.sum(dtype=torch.int64)
        if hasattr(n, "full_tensor"):          # a DTensor: the global count
            n = n.full_tensor()
        acc = _kept.get(n.device)
        if acc is None:
            acc = _kept[n.device] = torch.zeros((), dtype=torch.int64,
                                                device=n.device)
        acc.add_(n)
    _keep.clear()


def counters() -> dict:
    """A snapshot of the counters (plain numbers)."""
    _sum_kept()
    return {"product_ops": dict(_ops), **_count,
            "moe_kept": sum(int(t.item()) for t in _kept.values())}


def reset() -> None:
    """Clear every counter."""
    _ops.clear()
    _count.update(dict.fromkeys(_count, 0))
    _kept.clear()
    _keep.clear()
