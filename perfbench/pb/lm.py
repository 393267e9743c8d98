"""The program's own ranges and counters of its LM forward, as the
per-layer readers and ``perfbench/stages.py`` take them.

The program (``repro_torch.obs.lm``) names the stages of its forward
with ``record_function`` ranges and counts its products and its MoE
routing, while a profiler records: in a run, in the traced stretch
alone.  :func:`snapshot` is its counters, or None where the program has
no such module (an older program).  Every reading the readers take is a
ratio of numbers from one snapshot, so none of them depends on the
counters holding exactly one call.

:func:`gaps_by_stage` names each idle gap between device operations of
a profile by the innermost range open on the host when it began (a
stage, else the harness's ``bench.forward``, else ``harness``); device-
side copies of the ranges are left out of the device operations by name
as well as by ``is_user_annotation``, which not every build of the
profiler sets.  It is the body ``trace.reduce``'s gap naming should
take, and goes from here once ``reduce`` names gaps by stage.
"""

from __future__ import annotations

import bisect

import torch

from pb import trace

# The program's ``obs.lm.STAGES`` (a test holds them equal).
STAGES = ("embed", "norm", "attn.qkv", "attn.rope", "attn.core", "attn.out",
          "mlp", "moe.route", "moe.dispatch", "moe.experts", "moe.combine",
          "mamba", "rwkv6.time", "rwkv6.channel", "unembed")
ANNOTATIONS = frozenset(STAGES + trace.HOST_RANGES + trace.MOE_STAGES)


def program():
    """The program's ``obs.lm`` module, or None where it has none."""
    try:
        from repro_torch.obs import lm
    except ImportError:
        return None
    return lm


def snapshot():
    """The program's counters now, or None where it keeps none."""
    lm = program()
    return None if lm is None else lm.counters()


def counters(ctx):
    """The program's counters of the traced stretch, or None."""
    if ctx.kind != "score" or not ctx.trace:
        return None
    return snapshot()


def gaps_by_stage(prof, top: int = 10) -> list:
    """The ``top`` longest idle gaps between device operations, as
    [where, seconds], each named by the innermost range open on the host
    when the gap began."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        named = getattr(e, "is_user_annotation", False) or \
            e.name in ANNOTATIONS
        if e.device_type == cuda:
            if not named:
                dev.append([s, t])
        elif e.name in ANNOTATIONS:
            host.append((s, t, e.name))
    host.sort()
    starts = [s for s, _, _ in host]
    merged = trace._merge(dev)
    gaps = []
    for (_, a), (b, _) in zip(merged, merged[1:]):
        # the open range that began last is the innermost
        where, i = "harness", bisect.bisect_right(starts, a)
        while i > 0:
            i -= 1
            if a < host[i][1]:
                where = host[i][2]
                break
        gaps.append((where, (b - a) / 1e6))
    gaps.sort(key=lambda g: -g[1])
    return [[n, v] for n, v in gaps[:top]]
