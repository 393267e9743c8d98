"""flash_attention: blocked causal online-softmax GQA attention (CUDA).

Port of the TPU kernel ``repro/kernels/flash_attention.py``.  Two CUDA
kernels serve it, on Hopper's tensor cores, chosen by dtype
(:func:`route`) for every head_dim from 1 to :data:`MAX_HEAD_DIM`:

- ``"sm90"``, ``csrc/flash_attention_sm90.cu``: bf16 inputs (wgmma, TMA
  loads through an mbarrier ring, warp specialisation).
- ``"sm90_f32"``, ``csrc/flash_attention_f32_sm90.cu``: f32 inputs, as
  split TF32 (each operand split into a TF32 high and low part, three
  products into f32: within the f32 tolerance, where one TF32 product
  is not); wgmma, with k and v split once per CTA in shared memory.

Both load rows of 16 bytes (TMA's row stride, cp.async's chunk): a
head_dim that is not a multiple of 8 in bf16 or of 4 in f32 is copied
once into zero-padded q, k and v, and the kernel runs at the padded
width with the true head_dim's scale (the zero columns add exact zeros
to every score) and writes the output's first head_dim columns.

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
launches_by_route = {"sm90": 0, "sm90_f32": 0}
_count_lock = threading.Lock()

#: Largest head_dim the kernels take (the plain version takes any).
MAX_HEAD_DIM = 256
_ROUTES = {torch.bfloat16: ("sm90", "flash_attention_bf16_sm90"),
           torch.float32: ("sm90_f32", "flash_attention_f32_sm90")}


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that serves inputs of ``dtype`` and ``head_dim``:
    ``"sm90"`` for bf16 and ``"sm90_f32"`` for f32, at every head_dim
    from 1 to :data:`MAX_HEAD_DIM`."""
    if not 1 <= head_dim <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {head_dim} is outside "
                         f"1..{MAX_HEAD_DIM}, the widths its kernels take")
    if dtype not in _ROUTES:
        raise TypeError(f"flash_attention: no kernel for {dtype} (float32 "
                        f"or bfloat16)")
    return _ROUTES[dtype][0]


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
    _build.check_inputs(
        "flash_attention",
        {"q": (q, q.dtype), "k": (k, q.dtype), "v": (v, q.dtype)},
        {"q": (B, H, T, hd), "k": (B, KV, S, hd), "v": (B, KV, S, hd)})
    if KV < 1 or H % KV:
        raise ValueError(f"flash_attention: H={H} is not a multiple of "
                         f"KV={KV}")
    route_name = route(q.dtype, hd)
    entry = _ROUTES[q.dtype][1]
    # Rows of 16 bytes: pad the head_dim with zero columns (a fresh copy,
    # the caller's tensors untouched) where it falls short.
    width = -(-hd * q.element_size() // 16) * 16 // q.element_size()
    if width != hd:
        q, k, v = (_zero_padded(x, width) for x in (q, k, v))
    # TMA and cp.async read 16 bytes from 16-byte-aligned addresses; a
    # view that starts between them is copied (fresh allocations are
    # aligned).
    q, k, v = (x if x.data_ptr() % 16 == 0 else x.clone()
               for x in (q, k, v))
    out = q.new_empty((B, H, T, hd))
    with torch.cuda.device(q.device):
        rc = getattr(_build.lib(), entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, KV, T, S, width, hd, int(causal), hd ** -0.5,
            _build.stream_of(q))
    _build.check(rc, "flash_attention")
    with _count_lock:
        launches += 1
        launches_by_route[route_name] += 1
    return out


def _zero_padded(x: torch.Tensor, width: int) -> torch.Tensor:
    """x with zero columns appended up to ``width``: only the new columns
    are zeroed before the copy (F.pad zeroes the whole buffer first)."""
    out = x.new_empty((*x.shape[:-1], width))
    out[..., x.shape[-1]:].zero_()
    out[..., :x.shape[-1]].copy_(x)
    return out
