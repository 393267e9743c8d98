"""LR schedules: cosine, linear, and WSD (minicpm-2b's warmup-stable-decay).

Port of ``repro/train/schedules.py``.  Pure functions step -> lr.  The
step is an integer (a Python int or an int tensor) and the arithmetic
runs in f32 on 0-d CPU tensors, as the JAX package's traced ``jnp``
ops do on its int32 step: integer differences, f32 true division,
Python constants taken as f32.  The result is a 0-d f32 CPU tensor,
which multiplies a tensor on any device without a copy.
"""

from __future__ import annotations

import math

import torch

F32 = torch.float32


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.int32)


def _div(num: torch.Tensor, den: int) -> torch.Tensor:
    """``num / jnp.maximum(den, 1)`` for an int32 ``num``: both cast to
    f32, then divided."""
    return num.to(F32) / float(max(den, 1))


def linear_warmup(step, warmup_steps: int, peak: float):
    return peak * torch.clamp(_div(_step(step), warmup_steps), max=1.0)


def cosine(step, *, peak: float, warmup_steps: int, total_steps: int,
           floor: float = 0.1):
    step = _step(step)
    warm = linear_warmup(step, warmup_steps, peak)
    t = torch.clamp(_div(step - warmup_steps, total_steps - warmup_steps),
                    0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < warmup_steps, warm, peak * cos)


def wsd(step, *, peak: float, warmup_steps: int, stable_steps: int,
        decay_steps: int, floor: float = 0.1):
    """Warmup-Stable-Decay (MiniCPM, arXiv:2404.06395): linear warmup,
    long constant plateau, then a short exponential-ish decay to floor."""
    step = _step(step)
    warm = linear_warmup(step, warmup_steps, peak)
    decay_start = warmup_steps + stable_steps
    t = torch.clamp(_div(step - decay_start, decay_steps), 0.0, 1.0)
    decay = peak * (floor ** t)         # exponential decay to floor*peak
    return torch.where(step < warmup_steps, warm,
                       torch.where(step < decay_start,
                                   torch.tensor(peak, dtype=F32), decay))


def get_schedule(name: str, **kw):
    if name == "cosine":
        return lambda s: cosine(s, **kw)
    if name == "wsd":
        return lambda s: wsd(s, **kw)
    if name == "constant":
        return lambda s: torch.tensor(kw["peak"], dtype=F32)
    raise ValueError(name)
