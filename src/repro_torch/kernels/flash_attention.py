"""flash_attention: blocked causal online-softmax GQA attention (CUDA).

Port of the TPU kernel ``repro/kernels/flash_attention.py``.  Two CUDA
kernels serve it, chosen by one fixed rule (:func:`route`):

- ``"sm90"``, ``csrc/flash_attention_sm90.cu``: bf16 inputs whose
  head_dim is a multiple of 8 and at most 192, on Hopper's tensor cores
  (wgmma, TMA loads through an mbarrier ring, warp specialisation).  The
  8 is TMA's 16-byte row stride.
- ``"cuda_core"``, ``csrc/flash_attention.cu``: f32 inputs (wgmma takes
  f32 only as TF32, which would miss the f32 tolerance) and bf16 inputs
  with any other head_dim, computed in f32 on the CUDA cores.

:func:`flash_attention` launches the routed kernel on CUDA tensors and
runs the plain version on CPU tensors.  Nothing falls back: a build or
launch failure raises.
"""

from __future__ import annotations

import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

__all__ = ["flash_attention", "flash_attention_ref", "route", "launches",
           "launches_by_route", "MAX_HEAD_DIM"]

#: Kernel launches since the last reset (set to 0 to reset).
launches = 0
#: The same launches by route (set the values to 0 to reset).
launches_by_route = {"sm90": 0, "cuda_core": 0}
_count_lock = threading.Lock()

#: Largest head_dim either kernel takes.
MAX_HEAD_DIM = 192
_ENTRY = {("sm90", torch.bfloat16): "flash_attention_bf16_sm90",
          ("cuda_core", torch.float32): "flash_attention_f32",
          ("cuda_core", torch.bfloat16): "flash_attention_bf16"}


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that serves inputs of ``dtype`` and ``head_dim``:
    ``"sm90"`` for bf16 with head_dim % 8 == 0 (and <= 192), else
    ``"cuda_core"``."""
    if (dtype == torch.bfloat16 and head_dim % 8 == 0
            and head_dim <= MAX_HEAD_DIM):
        return "sm90"
    return "cuda_core"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q (B,H,T,hd), k/v (B,KV,S,hd), f32 or bf16, contiguous ->
    (B,H,T,hd) in q's dtype.  Query t attends keys <= t + (S - T) when
    ``causal``; a row with no such key is 0.  See
    ref.flash_attention_ref."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal).to(q.dtype)
    return _launch(route(q.dtype, q.shape[-1]), q, k, v, causal=causal)


def _launch(route_name: str, q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor, *, causal: bool = True) -> torch.Tensor:
    """Launch ``route_name``'s kernel on CUDA tensors and count it.
    :func:`flash_attention` calls this with the routed kernel; chip_smoke
    calls it to time the CUDA-core bf16 entry beside the sm90 kernel."""
    global launches
    B, H, T, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    entry = _ENTRY.get((route_name, q.dtype))
    if entry is None:
        raise TypeError(f"flash_attention: no {route_name!r} kernel for "
                        f"{q.dtype} (float32 or bfloat16; sm90 takes "
                        f"bfloat16 only)")
    _build.check_inputs(
        "flash_attention",
        {"q": (q, q.dtype), "k": (k, q.dtype), "v": (v, q.dtype)},
        {"q": (B, H, T, hd), "k": (B, KV, S, hd), "v": (B, KV, S, hd)})
    if KV < 1 or H % KV:
        raise ValueError(f"flash_attention: H={H} is not a multiple of "
                         f"KV={KV}")
    if not 1 <= hd <= MAX_HEAD_DIM or (route_name == "sm90" and hd % 8):
        raise ValueError(f"flash_attention: head_dim {hd} outside what "
                         f"the {route_name} kernel takes")
    if route_name == "sm90":
        # TMA reads from 16-byte-aligned bases; a view that starts
        # between them is copied (fresh allocations are aligned).
        q, k, v = (x if x.data_ptr() % 16 == 0 else x.clone()
                   for x in (q, k, v))
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = getattr(_build.lib(), entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, KV, T, S, hd, int(causal), hd ** -0.5,
            _build.stream_of(q))
    _build.check(rc, "flash_attention")
    with _count_lock:
        launches += 1
        launches_by_route[route_name] += 1
    return out
