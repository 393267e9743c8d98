"""flash_attention: blocked causal online-softmax GQA attention (CUDA).

Port of the TPU kernel ``repro/kernels/flash_attention.py``, which casts
each input to f32 on its own and returns its f32 result in q's dtype, so
it takes any float dtype and any head_dim.  Three CUDA sources serve it,
chosen by :func:`route`:

- ``"sm90"`` and ``"sm90_f16"``, ``csrc/flash_attention_sm90.cu``
  instantiated for bf16 and for f16 (wgmma, TMA loads through an mbarrier
  ring, warp specialisation), head_dim 1 to :data:`MAX_HEAD_DIM`.
- ``"sm90_f32"``, ``csrc/flash_attention_f32_sm90.cu``: f32 inputs, as
  split TF32 (each operand split into a TF32 high and low part, three
  products into f32: within the f32 tolerance, where one TF32 product
  is not); wgmma, with k and v split once per CTA in shared memory; head_dim
  1 to :data:`MAX_HEAD_DIM`.
- ``"wide"``: every head_dim above :data:`MAX_HEAD_DIM` on the tensor
  cores, ``csrc/flash_attention_wide.cu`` in bf16 and f16 (wgmma, TMA
  loads through an mbarrier ring, a producer warp) and
  ``csrc/flash_attention_wide_f32.cu`` in f32 (split TF32 on wgmma):
  the output columns cut into chunks by :func:`wide_plan`, whose width
  the wrapper passes to the kernel, the scores recomputed over the whole
  head_dim for each chunk.

Inputs that are not all one of f16, bf16 and f32 (a mix of dtypes, or
f64) are taken in f32: each is widened exactly, or f64 narrowed as
``jnp.asarray`` does with x64 off, and the f32 output is cast to q's
dtype (f32 for an f64 q: :func:`out_dtype`), as the reference casts its
f32 result.

Every kernel loads rows of 16 bytes (TMA's row stride, cp.async's
chunk) from 16-byte-aligned bases: a head_dim that is not a multiple of 8
in f16 and bf16 or of 4 in f32 is copied once into zero-padded q, k and
v, and the kernel runs at the padded width with the true head_dim's
scale (the zero columns add exact zeros to every score) and writes the
output's first head_dim columns (hd 257 runs at 264 in 16 bits and 260
in f32); a view that starts between two 16-byte boundaries is copied.

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
           "launches_by_route", "MAX_HEAD_DIM", "WIDE_MAX_CHUNK", "wide_plan",
           "kernel_dtype", "out_dtype"]

#: Kernel launches since the last reset (set to 0 to reset).
launches = 0
#: The same launches by route (set the values to 0 to reset).
launches_by_route = {"sm90": 0, "sm90_f16": 0, "sm90_f32": 0, "wide": 0}
_count_lock = threading.Lock()

#: Widest head_dim of the sm90 routes; wider ones go to "wide".
MAX_HEAD_DIM = 256
#: Widest output chunk of the wide kernels (their kMaxCW).
WIDE_MAX_CHUNK = 256
#: dtype -> (tensor-core route, its C entry, the wide kernel's C entry).
_KERNELS = {
    torch.bfloat16: ("sm90", "flash_attention_bf16_sm90",
                     "flash_attention_wide_bf16"),
    torch.float16: ("sm90_f16", "flash_attention_f16_sm90",
                    "flash_attention_wide_f16"),
    torch.float32: ("sm90_f32", "flash_attention_f32_sm90",
                    "flash_attention_wide_f32"),
}


def kernel_dtype(q_dtype: torch.dtype, k_dtype: torch.dtype | None = None,
                 v_dtype: torch.dtype | None = None) -> torch.dtype:
    """The dtype the kernels take q, k and v in: their common dtype when it
    is f16, bf16 or f32, else f32 (a mix of dtypes, or f64)."""
    dtypes = {q_dtype, k_dtype or q_dtype, v_dtype or q_dtype}
    dt = dtypes.pop() if len(dtypes) == 1 else torch.float32
    return dt if dt in _KERNELS else torch.float32


def out_dtype(q_dtype: torch.dtype) -> torch.dtype:
    """The output's dtype: q's, with f64 narrowed to f32 (the reference
    takes an f64 q as f32, as ``jnp.asarray`` does with x64 off)."""
    return torch.float32 if q_dtype == torch.float64 else q_dtype


def route(dtype: torch.dtype, head_dim: int,
          k_dtype: torch.dtype | None = None,
          v_dtype: torch.dtype | None = None) -> str:
    """The kernel that serves q of ``dtype`` (k and v of ``k_dtype`` and
    ``v_dtype``, q's when not given) at ``head_dim``: ``"wide"`` above
    :data:`MAX_HEAD_DIM`, else by :func:`kernel_dtype`: ``"sm90"`` for
    bf16, ``"sm90_f16"`` for f16, ``"sm90_f32"`` for f32 and every mix
    or other dtype."""
    if head_dim < 1:
        raise ValueError(f"flash_attention: head_dim {head_dim} < 1")
    if head_dim > MAX_HEAD_DIM:
        return "wide"
    return _KERNELS[kernel_dtype(dtype, k_dtype, v_dtype)][0]


def wide_plan(head_dim: int) -> tuple[int, int]:
    """(n_chunks, chunk width) of the wide kernels at a ``head_dim`` above
    :data:`MAX_HEAD_DIM`: the fewest chunks of at most
    :data:`WIDE_MAX_CHUNK` output columns, their width rounded up to a
    multiple of 32 (so 160 to 256, the widths the kernels are compiled
    for); chunk c owns columns [c w, c w + w).  The wrapper passes the
    width to the kernel, which refuses any other.  Each CTA recomputes the
    scores over the whole head_dim for its chunk."""
    if head_dim <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {head_dim} is not "
                         f"above {MAX_HEAD_DIM}")
    n = -(-head_dim // WIDE_MAX_CHUNK)
    width = -(-head_dim // (32 * n)) * 32
    return -(-head_dim // width), width


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q (B,H,T,hd), k/v (B,KV,S,hd), contiguous, any float dtypes ->
    (B,H,T,hd) in :func:`out_dtype` of q's.  Query t attends keys <= t +
    (S - T) when ``causal``; a row with no such key is 0.  See
    ref.flash_attention_ref."""
    global launches
    od = out_dtype(q.dtype)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal).to(od)
    B, H, T, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    route_name = route(q.dtype, hd, k.dtype, v.dtype)
    dt = kernel_dtype(q.dtype, k.dtype, v.dtype)
    q, k, v = (x if x.dtype == dt else x.to(dt) for x in (q, k, v))
    _build.check_inputs(
        "flash_attention",
        {"q": (q, dt), "k": (k, dt), "v": (v, dt)},
        {"q": (B, H, T, hd), "k": (B, KV, S, hd), "v": (B, KV, S, hd)})
    if KV < 1 or H % KV:
        raise ValueError(f"flash_attention: H={H} is not a multiple of "
                         f"KV={KV}")
    entry = _KERNELS[dt][2 if route_name == "wide" else 1]
    # Rows of 16 bytes: pad the head_dim with zero columns (a fresh copy,
    # the caller's tensors untouched) where it falls short.
    width = -(-hd * q.element_size() // 16) * 16 // q.element_size()
    if width != hd:
        q, k, v = (_zero_padded(x, width) for x in (q, k, v))
    # TMA and cp.async read 16 bytes from 16-byte-aligned addresses; a
    # view that starts between them is copied (fresh allocations are
    # aligned).
    q, k, v = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (q, k, v))
    out = q.new_empty((B, H, T, hd))
    # The wide kernels take the chunk width of the plan after hd_out.
    plan = (wide_plan(hd)[1],) if route_name == "wide" else ()
    with torch.cuda.device(q.device):
        rc = getattr(_build.lib(), entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, KV, T, S, width, hd, *plan, int(causal), hd ** -0.5,
            _build.stream_of(q))
    _build.check(rc, "flash_attention")
    with _count_lock:
        launches += 1
        launches_by_route[route_name] += 1
    return out if out.dtype == od else out.to(od)


def _zero_padded(x: torch.Tensor, width: int) -> torch.Tensor:
    """x with zero columns appended up to ``width``: only the new columns
    are zeroed before the copy (F.pad zeroes the whole buffer first)."""
    out = x.new_empty((*x.shape[:-1], width))
    out[..., x.shape[-1]:].zero_()
    out[..., :x.shape[-1]].copy_(x)
    return out
