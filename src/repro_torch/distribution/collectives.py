"""Functional collectives on plain tensors over one process group.

``torch.ops._c10d_functional`` ops, each followed by its
``wait_tensor``: they run on NCCL, gloo and the dry run's fake group
alike, and a traced program holds them by name (see
``roofline/graph_parse.py``).
"""

from __future__ import annotations

import torch

_F = torch.ops._c10d_functional


def all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    """``t`` reduced (``op``: "sum", "max", ...) over ``group``."""
    return _F.wait_tensor(_F.all_reduce(t.contiguous(), op,
                                        group.group_name))


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """The group's ``t`` stacked on a new leading axis, in rank order."""
    n = group.size()
    out = _F.wait_tensor(_F.all_gather_into_tensor(
        t.contiguous(), n, group.group_name))
    return out.reshape(n, *t.shape)
