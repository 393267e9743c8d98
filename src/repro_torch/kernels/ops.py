"""Public wrappers for the kernels.

Port of ``repro/kernels/ops.py``.  Each op runs where its tensors live:
``backend='kernel'`` (the default) calls the kernel wrappers, which
launch the CUDA kernels on CUDA tensors and run the plain versions on
CPU tensors; ``backend='ref'`` composes the plain versions directly,
and is only ever the caller's explicit choice.  The segment processor,
the LM's attention and ``chip_smoke.py`` call these, never the kernels
directly.
"""

from __future__ import annotations

import threading
from typing import Literal

import numpy as np
import torch

from repro_torch.kernels import ref, segment_pipeline
from repro_torch.kernels.agl_lookup import agl_lookup as _agl_kernel
from repro_torch.kernels.dynamic_rates import dynamic_rates as _rates_kernel
from repro_torch.kernels.flash_attention import (
    flash_attention as _flash_kernel)
from repro_torch.kernels.track_interp import track_interp as _interp_kernel

Backend = Literal["kernel", "ref"]
BACKENDS = ("kernel", "ref")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the card.  A
    CUDA device on a machine without one raises; nothing falls back to
    the CPU unless the caller names it.  The card is counted through
    NVML (``device_count``), which leaves the CUDA driver uninitialised,
    so worker processes may still be forked after this check."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and torch.cuda.device_count() == 0:
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; choose from "
                         f"{BACKENDS}")


# ---------------------------------------------------------------------------
# Pipeline instrumentation.
# ---------------------------------------------------------------------------

_STATS_LOCK = threading.Lock()
_STATS = {"intermediate_transfers": 0, "compile_hits": 0,
          "compile_misses": 0}
_SEEN_FUSED_SHAPES: set = set()


def reset_pipeline_stats(forget_shapes: bool = True) -> None:
    """Zero the transfer/compile counters.  ``forget_shapes=False``
    keeps the seen-shape set so already-seen bucket shapes keep
    counting as hits (steady-state measurement)."""
    with _STATS_LOCK:
        for k in _STATS:
            _STATS[k] = 0
        if forget_shapes:
            _SEEN_FUSED_SHAPES.clear()


def get_pipeline_stats() -> dict:
    with _STATS_LOCK:
        return dict(_STATS)


def note_intermediate_transfer(n: int = 1) -> None:
    """Record a mid-pipeline host<->device hop (unfused path only)."""
    with _STATS_LOCK:
        _STATS["intermediate_transfers"] += n


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).contiguous()


def track_interp(t_in, v_in, count, t_out, *, backend: Backend = "kernel"):
    """(B,N),(B,C,N),(B,),(B,M) -> (B,M,C). See ref.track_interp_ref."""
    _check_backend(backend)
    args = (_f32(t_in), _f32(v_in),
            torch.as_tensor(count, dtype=torch.int32), _f32(t_out))
    if backend == "ref":
        return ref.track_interp_ref(*args)
    return _interp_kernel(*args)


def dynamic_rates(v, count, dt, *, backend: Backend = "kernel"):
    """(B,3,M),(B,) -> (B,4,M). See ref.dynamic_rates_ref."""
    _check_backend(backend)
    v = _f32(v)
    count = torch.as_tensor(count, dtype=torch.int32)
    if backend == "ref":
        return ref.dynamic_rates_ref(v, count, dt)
    return _rates_kernel(v, count, float(dt))


def agl_lookup(dem, fi, fj, alt_msl, *, backend: Backend = "kernel"):
    """(H,W),(B,M),(B,M),(B,M) -> (B,M) AGL. See ref.agl_lookup_ref.

    The kernel path first clips the indices to [0, H - 1.001] and
    [0, W - 1.001], as the reference's row routing does before its tile
    kernel or its oracle; the one gather kernel then serves every row,
    whatever its extent, so no row is routed anywhere else.
    """
    _check_backend(backend)
    dem = _f32(dem)
    fi, fj, alt_msl = (_f32(x).to(dem.device) for x in (fi, fj, alt_msl))
    if backend == "ref":
        return ref.agl_lookup_ref(dem, fi, fj, alt_msl)
    H, W = dem.shape
    fi = torch.clamp(fi, 0.0, float(np.float32(H - 1.001)))
    fj = torch.clamp(fj, 0.0, float(np.float32(W - 1.001)))
    return _agl_kernel(dem, fi, fj, alt_msl)


def process_segments(dem, t_in, v_in, count_in, t_out, count_out, *,
                     grid, dt: float = 1.0, backend: Backend = "kernel",
                     agl_oracle: bool = False) -> torch.Tensor:
    """Device-resident segment pipeline: interp + AGL + rates + masks.

    See :func:`segment_pipeline.process_segments`.  ``dem`` is a tensor
    (an array becomes a CPU tensor); the pipeline runs on its device.
    ``agl_oracle`` keeps the reference's bucket variant flag: it is part
    of the shape key counted below, and both variants run the same
    gather kernel.

    Returns:
      (9, B, K) f32 tensor on ``dem``'s device, planes in
      :data:`segment_pipeline.FIELDS` order, masked to ``count_out``.
    """
    _check_backend(backend)
    dem = torch.as_tensor(dem, dtype=torch.float32)
    use_kernels = backend == "kernel"
    key = (tuple(dem.shape), tuple(np.shape(t_in)), tuple(np.shape(t_out)),
           tuple(float(g) for g in grid), float(dt), use_kernels,
           bool(agl_oracle))
    with _STATS_LOCK:
        if key in _SEEN_FUSED_SHAPES:
            _STATS["compile_hits"] += 1
        else:
            _SEEN_FUSED_SHAPES.add(key)
            _STATS["compile_misses"] += 1
    return segment_pipeline.process_segments(
        dem, t_in, v_in, count_in, t_out, count_out, grid=grid, dt=dt,
        use_kernels=use_kernels)


def flash_attention(q, k, v, *, causal: bool = True,
                    backend: Backend = "kernel") -> torch.Tensor:
    """Blocked online-softmax attention (GQA): q (B,H,T,hd), k/v
    (B,KV,S,hd) -> (B,H,T,hd) in q's dtype, query t attending keys
    <= t + (S - T) when ``causal``.  Views (the attention layer hands
    over transposed ones) are made contiguous here; the kernel takes any
    T and S, so nothing is padded.  See ref.flash_attention_ref.

    It has no gradient, on either backend or device: with grad mode on
    and q, k or v requiring grad it raises ``NotImplementedError``, as
    ``jax.grad`` of the reference's kernel fails in ``pallas_call``'s
    JVP rule (``_pallas_call_jvp_rule``).  The kernels are bound through
    ``ctypes``, so their output would otherwise carry no ``grad_fn`` and
    a backward would silently drop the q/k/v gradients.  Train with
    ``attention_impl="xla"``, as every config does."""
    if torch.is_grad_enabled() and any(
            isinstance(x, torch.Tensor) and x.requires_grad
            for x in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no gradient: the reference's Pallas "
            "kernel cannot be differentiated either (jax.grad fails in "
            "pallas_call's JVP rule, _pallas_call_jvp_rule); train with "
            "attention_impl='xla'")
    _check_backend(backend)
    q, k, v = (torch.as_tensor(x).contiguous() for x in (q, k, v))
    if backend == "ref":
        return ref.flash_attention_ref(q, k, v, causal=causal).to(q.dtype)
    return _flash_kernel(q, k, v, causal=causal)
