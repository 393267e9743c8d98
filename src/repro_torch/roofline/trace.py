"""Record one chip's local program as an FX graph, with no device.

The dry run runs a step on DTensors whose local shards are
:class:`Traced` tensors: wrappers over ``meta`` tensors that append each
``aten`` op they meet (and each ``_c10d_functional`` collective that
DTensor runs on them) to an FX graph, with its output in
``meta['val']``.  The graph holds the same local ops and collectives
that ``make_fx`` records; it is recorded this way because DTensor
turns its sharding-propagation caches off under ``make_fx``, which
makes a full-width trace take minutes a cell instead of seconds.

From the graph (:class:`LocalTrace`):
  * ``flops()`` — ``FlopCounterMode`` while the graph runs again on
    meta tensors;
  * ``bytes_accessed()`` — each op's input and output bytes, unfused,
    views excluded (they move nothing), so an upper bound on what a
    fusing compiler would move;
  * ``peak_temp_bytes()`` — a liveness walk: the most bytes of op
    outputs alive at any node (inputs and views not counted).

These are the port's own estimates, not XLA's ``cost_analysis()`` or
``memory_analysis()``.
"""

from __future__ import annotations

import operator
from typing import Any

import torch
import torch.fx
from torch.utils._pytree import tree_flatten, tree_map

from repro_torch.roofline.graph_parse import _val_bytes


class Traced(torch.Tensor):
    """A meta tensor that records the ops it meets in its trace."""

    @staticmethod
    def __new__(cls, inner: torch.Tensor, trace: "LocalTrace", node):
        r = torch.Tensor._make_wrapper_subclass(
            cls, inner.shape, strides=inner.stride(), dtype=inner.dtype,
            device=inner.device, requires_grad=False)
        r.inner = inner
        r.trace = trace
        r.node = node
        return r

    def __repr__(self) -> str:
        return f"Traced({tuple(self.inner.shape)}, {self.inner.dtype})"

    __torch_function__ = torch._C._disabled_torch_function_impl

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        trace = next(a.trace for a in tree_flatten((args, kwargs))[0]
                     if isinstance(a, Traced))
        return trace.record(func, args, kwargs)


def _is_view(func) -> bool:
    """True when the op's outputs alias its inputs (views and in-place
    ops): they allocate nothing."""
    schema = getattr(func, "_schema", None)
    return bool(schema is not None and schema.returns
                and schema.returns[0].alias_info is not None)


class LocalTrace:
    """An FX graph of one chip's local ops, built as they run."""

    def __init__(self):
        self.graph = torch.fx.Graph()
        self._n_inputs = 0

    # -- recording ------------------------------------------------------

    def input(self, t: torch.Tensor, name: str = "arg") -> Traced:
        """A placeholder for a local shard (a meta tensor)."""
        inner = t if t.device.type == "meta" else t.to("meta")
        node = self.graph.placeholder(f"{name}_{self._n_inputs}")
        self._n_inputs += 1
        node.meta["val"] = inner
        return Traced(inner, self, node)

    def _node_of(self, x):
        if isinstance(x, Traced):
            return x.node
        if isinstance(x, torch.Tensor):          # a plain local constant
            return self.input(x, "const").node
        return x

    def record(self, func, args, kwargs):
        inner_args = tree_map(
            lambda x: x.inner if isinstance(x, Traced) else (
                x.to("meta") if isinstance(x, torch.Tensor)
                and x.device.type != "meta" else x), args)
        inner_kwargs = tree_map(
            lambda x: x.inner if isinstance(x, Traced) else x, kwargs)
        out = func(*inner_args, **inner_kwargs)
        node = self.graph.call_function(
            func, tree_map(self._node_of, args),
            tree_map(self._node_of, kwargs))
        node.meta["val"] = out
        # outputs that are an input's own tensor (in-place ops) return
        # that input's wrapper
        by_id = {id(x.inner): x for x in tree_flatten((args, kwargs))[0]
                 if isinstance(x, Traced)}
        if isinstance(out, torch.Tensor):
            same = by_id.get(id(out))
            return Traced(out, self, node) if same is None else same
        if isinstance(out, (tuple, list)):
            res = []
            for i, o in enumerate(out):
                if isinstance(o, torch.Tensor):
                    if id(o) in by_id:
                        res.append(by_id[id(o)])
                        continue
                    item = self.graph.call_function(
                        operator.getitem, (node, i))
                    item.meta["val"] = o
                    res.append(Traced(o, self, item))
                else:
                    res.append(o)
            return type(out)(res) if isinstance(out, tuple) else res
        return out

    # -- reading ----------------------------------------------------------

    def _ops(self):
        return [n for n in self.graph.nodes if n.op == "call_function"
                and hasattr(n.target, "_schema")]

    @property
    def n_nodes(self) -> int:
        return len(self.graph.nodes)

    def flops(self) -> float:
        """FLOPs of the graph run again on meta tensors under
        ``FlopCounterMode``."""
        from torch.utils.flop_counter import FlopCounterMode
        env: dict[Any, Any] = {}
        counter = FlopCounterMode(display=False)
        with counter:
            for n in self.graph.nodes:
                if n.op == "placeholder":
                    env[n] = n.meta["val"]
                elif n.op == "call_function":
                    a = tree_map(lambda x: env.get(x, x)
                                 if isinstance(x, torch.fx.Node) else x,
                                 n.args)
                    k = tree_map(lambda x: env.get(x, x)
                                 if isinstance(x, torch.fx.Node) else x,
                                 n.kwargs)
                    if _counts_flops(n.target):
                        env[n] = n.target(*a, **k)
                    else:
                        # ops the counter does not count need not run
                        env[n] = n.meta["val"]
        return float(counter.get_total_flops())

    def bytes_accessed(self) -> float:
        total = 0
        for n in self._ops():
            if _is_view(n.target):
                continue
            ins = [a.meta.get("val") for a in tree_flatten(
                (n.args, n.kwargs))[0] if isinstance(a, torch.fx.Node)]
            total += _val_bytes(ins) + _val_bytes(n.meta.get("val"))
        return float(total)

    def peak_temp_bytes(self) -> int:
        nodes = list(self.graph.nodes)
        last_use: dict = {}
        for i, n in enumerate(nodes):
            for a in n.all_input_nodes:
                last_use[a] = i
        alive = 0
        peak = 0
        dying: dict[int, list] = {}
        for i, n in enumerate(nodes):
            if n.op == "call_function" and hasattr(n.target, "_schema") \
                    and not _is_view(n.target):
                b = _val_bytes(n.meta.get("val"))
                alive += b
                dying.setdefault(last_use.get(n, i), []).append(b)
            peak = max(peak, alive)
            for b in dying.pop(i, []):
                alive -= b
        return int(peak)


def _counts_flops(target) -> bool:
    from torch.utils.flop_counter import flop_registry
    return getattr(target, "_overloadpacket", None) in flop_registry
