"""Collective bytes per category from a traced FX graph.

The port's counterpart of ``repro/roofline/hlo_parse.py``.  PyTorch
emits no XLA HLO, so the reference's HLO text parser (its shape regexes
and instruction grammar) has no counterpart.  What the port traces is an
FX graph of local ``aten`` ops (``make_fx``, or :mod:`.trace`), whose
collectives are ``_c10d_functional`` nodes that name their process
group; every node carries its output in ``meta['val']``.  From it:

  * :func:`parse_graph_shapes` — node name -> output bytes;
  * :func:`collective_bytes` — operand and wire bytes per category
    under the reference's ring model.

Categories (FX op -> reference category)::

    _c10d_functional.all_reduce[_coalesced]              all-reduce
    _c10d_functional.all_gather_into_tensor[_coalesced]  all-gather
    _c10d_functional.reduce_scatter_tensor[_coalesced]   reduce-scatter
    _c10d_functional.all_to_all_single                   all-to-all
    a send (isend, a permute)                            collective-permute

``wait_tensor`` is the "-done" half of an asynchronous collective and is
not counted.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Optional

import torch


def _val_bytes(val) -> int:
    if isinstance(val, torch.Tensor):
        return val.numel() * val.element_size()
    if isinstance(val, (list, tuple)):
        return sum(_val_bytes(v) for v in val)
    return 0


def _graph(gm):
    return gm.graph if hasattr(gm, "graph") else gm


def parse_graph_shapes(gm) -> dict[str, int]:
    """name -> output bytes for every node of the graph (tuples and
    lists of tensors summed)."""
    return {n.name: _val_bytes(n.meta.get("val"))
            for n in _graph(gm).nodes}


@dataclasses.dataclass
class CollectiveStats:
    """Per-category operand bytes + estimated per-chip wire bytes."""
    operand_bytes: dict[str, float]
    wire_bytes: dict[str, float]

    @property
    def total_operand_bytes(self) -> float:
        return sum(self.operand_bytes.values())

    @property
    def total_wire_bytes(self) -> float:
        return sum(self.wire_bytes.values())


def op_name(target) -> str:
    """'namespace.op' of an FX target (``aten.mm``,
    ``_c10d_functional.all_reduce``); '' for what is not an op."""
    name = getattr(target, "name", None)
    if callable(name):
        full = name()                        # OpOverload: 'ns::op.overload'
        return full.split(".")[0].replace("::", ".")
    return ""


def category(target) -> Optional[str]:
    """The reference's collective category of a node's target, or
    None."""
    name = op_name(target)
    ns, _, op = name.partition(".")
    if ns not in ("_c10d_functional", "c10d_functional", "c10d",
                  "_dtensor"):
        return None
    if op.startswith("all_reduce"):
        return "all-reduce"
    if op.startswith("all_gather"):
        return "all-gather"
    if op.startswith("reduce_scatter"):
        return "reduce-scatter"
    if op.startswith("all_to_all") or op == "shard_dim_alltoall":
        return "all-to-all"
    if "permute" in op or op in ("isend", "send"):
        return "collective-permute"
    return None


def _group_name(node) -> Optional[str]:
    """The process group a collective node names (its last str
    argument)."""
    for a in reversed(list(node.args) + list(node.kwargs.values())):
        if isinstance(a, str):
            return a
    return None


def group_size(node, default: int,
               group_sizes: Optional[dict[str, int]] = None) -> int:
    """Size of the group a collective node names: from ``group_sizes``
    (name -> size) when given, else from the live process group of that
    name, else ``default``."""
    name = _group_name(node)
    if group_sizes is not None and name in group_sizes:
        return max(int(group_sizes[name]), 1)
    if name is not None:
        try:
            from torch.distributed.distributed_c10d import (
                _resolve_process_group)
            return max(_resolve_process_group(name).size(), 1)
        except Exception:
            pass
    return default


def _operand_bytes(node) -> float:
    first = node.args[0] if node.args else None
    items = first if isinstance(first, (list, tuple)) else [first]
    return float(sum(_val_bytes(a.meta.get("val"))
                     for a in items if hasattr(a, "meta")))


def collective_bytes(gm, n_devices: int = 1,
                     group_sizes: Optional[dict[str, int]] = None
                     ) -> CollectiveStats:
    """Sum operand bytes of every collective node in the graph.

    Wire-byte model per chip (ring algorithms over a group of size g):
      all-reduce:        2 * (g-1)/g * operand
      all-gather:        (g-1)/g * output          (operand = output/g)
      reduce-scatter:    (g-1)/g * operand
      all-to-all:        (g-1)/g * operand
      collective-permute: operand
    """
    op_bytes: dict[str, float] = defaultdict(float)
    wire: dict[str, float] = defaultdict(float)
    for node in _graph(gm).nodes:
        if node.op != "call_function":
            continue
        kind = category(node.target)
        if kind is None:
            continue
        operand = _operand_bytes(node)
        out = float(_val_bytes(node.meta.get("val")))
        g = group_size(node, n_devices, group_sizes)
        op_bytes[kind] += operand
        if kind == "all-reduce":
            wire[kind] += 2.0 * (g - 1) / g * operand
        elif kind == "all-gather":
            wire[kind] += (g - 1) / g * out
        elif kind in ("reduce-scatter", "all-to-all"):
            wire[kind] += (g - 1) / g * operand
        else:  # collective-permute
            wire[kind] += operand
    return CollectiveStats(dict(op_bytes), dict(wire))
