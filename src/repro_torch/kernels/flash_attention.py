"""flash_attention: blocked causal online-softmax GQA attention (CUDA).

Port of the TPU kernel ``repro/kernels/flash_attention.py``; the kernel
is ``csrc/flash_attention.cu``.  :func:`flash_attention` launches it on
CUDA tensors and runs the plain version on CPU tensors.
"""

from __future__ import annotations

import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

__all__ = ["flash_attention", "flash_attention_ref", "launches",
           "MAX_HEAD_DIM"]

#: Kernel launches since the last reset (set to 0 to reset).
launches = 0
_count_lock = threading.Lock()

#: Largest head_dim the kernel's register blocking takes.
MAX_HEAD_DIM = 192
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q (B,H,T,hd), k/v (B,KV,S,hd), f32 or bf16, contiguous ->
    (B,H,T,hd) in q's dtype.  Query t attends keys <= t + (S - T) when
    ``causal``; a row with no such key is 0.  See
    ref.flash_attention_ref."""
    global launches
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal).to(q.dtype)
    B, H, T, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    if q.dtype not in _ENTRY:
        raise TypeError(f"flash_attention: q is {q.dtype}, needs float32 "
                        f"or bfloat16")
    _build.check_inputs(
        "flash_attention",
        {"q": (q, q.dtype), "k": (k, q.dtype), "v": (v, q.dtype)},
        {"q": (B, H, T, hd), "k": (B, KV, S, hd), "v": (B, KV, S, hd)})
    if KV < 1 or H % KV:
        raise ValueError(f"flash_attention: H={H} is not a multiple of "
                         f"KV={KV}")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {hd} outside "
                         f"[1, {MAX_HEAD_DIM}]")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = getattr(_build.lib(), _ENTRY[q.dtype])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, KV, T, S, hd, int(causal), hd ** -0.5,
            _build.stream_of(q))
    _build.check(rc, "flash_attention")
    with _count_lock:
        launches += 1
    return out
