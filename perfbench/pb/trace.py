"""A profiled stretch and what the per-layer readers take from it.

``Profile`` runs a callable under ``torch.profiler`` (CPU and CUDA
activity) between two synchronisations.  ``reduce`` turns the trace into
plain numbers: device busy seconds (the union of the device's operation
intervals), device seconds by operation name and by kind of kernel,
device seconds under the program's MoE ranges, and the idle gaps
between device operations, each named by the benchmark's host range
(``bench.*``) open when it began.
"""

from __future__ import annotations

import time

import torch

MOE_STAGES = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")
HOST_RANGES = ("bench.forward",)
NAME_CHARS = 120


def kernel_kind(name: str) -> str:
    """GEMMs (f32, bf16 and f16 apart), the flash kernel, copies (the
    casts among them), and the rest.  cuBLASLt's ``nvjet`` kernels are
    tensor-core GEMMs: with TF32 off they take 16-bit operands."""
    low = name.lower()
    if "flash_attention" in low:
        return "flash"
    if any(w in low for w in ("gemm", "xmma", "cutlass", "nvjet")):
        if any(w in low for w in ("bf16", "bfloat16", "_bsb")):
            return "gemm_bf16"
        if any(w in low for w in ("f16", "fp16", "half", "_hsh")):
            return "gemm_f16"
        if "nvjet" in low:
            return "gemm_bf16"
        return "gemm_f32"
    if "copy" in low:
        return "copy"
    return "other"


def profile(fn) -> tuple:
    """(profiler, wall seconds) of ``fn()`` run between two
    synchronisations of the card."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof, wall


def _merge(iv: list) -> list:
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(prof, wall_s: float, top: int = 10) -> dict:
    """Plain numbers from a trace (seconds throughout)."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        annotation = (getattr(e, "is_user_annotation", False)
                      or e.name in HOST_RANGES or e.name in MOE_STAGES)
        if e.device_type == cuda and not annotation:
            dev.append((e.name, s, t))
        elif e.device_type != cuda and e.name in HOST_RANGES:
            host.append((e.name, s, t))
    by_name: dict = {}
    for n, s, t in dev:
        by_name[n] = by_name.get(n, 0.0) + (t - s) / 1e6
    kinds: dict = {}
    for n, v in by_name.items():
        k = kernel_kind(n)
        kinds[k] = kinds.get(k, 0.0) + v
    merged = _merge([[s, t] for _, s, t in dev])
    busy = sum(t - s for s, t in merged) / 1e6
    gaps = []
    for (_, a), (b, _) in zip(merged, merged[1:]):
        where = "harness"
        for n, s, t in host:
            if s <= a < t:
                where = n
                break
        gaps.append((where, (b - a) / 1e6))
    gaps.sort(key=lambda g: -g[1])
    moe = dict.fromkeys(MOE_STAGES, 0.0)
    cpu = torch.autograd.DeviceType.CPU
    for e in prof.key_averages():
        if e.key in moe and e.device_type == cpu:
            moe[e.key] += getattr(e, "device_time_total", 0.0) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    ops = [(n if len(n) <= NAME_CHARS else n[:NAME_CHARS] + "...", v)
           for n, v in ops]
    return {"busy_s": busy, "window_s": wall_s, "by_kind": kinds,
            "moe_s": moe, "n_device_ops": len(dev),
            "device_ops": [[n, v] for n, v in ops],
            "idle_gaps": [[n, v] for n, v in gaps[:top]]}
