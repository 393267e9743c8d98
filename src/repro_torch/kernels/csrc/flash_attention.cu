// Blocked causal online-softmax GQA attention: q (B,H,T,hd), k/v
// (B,KV,S,hd) -> (B,H,T,hd), f32 or bf16 in and out, f32 inside.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (_kernel / flash_attention_pallas), which walks a (B, H, T/128, S/128)
// grid whose last axis runs in order on one core, carrying the running
// row maximum m, row sum l and output accumulator acc in VMEM scratch
// from one key block to the next.  Hopper runs blocks in parallel and in
// no order, so here the key walk is a loop inside one block: one block
// per (b, h, tile of 64 query rows), all on grid.x (heaviest causal
// tiles first), keeping m, l and acc in registers for the whole walk.
//
// Bound: operations.  Each (query, key) pair the causal mask keeps costs
// 2*hd flops for the score and 2*hd for the weighted sum, against 4*hd
// bytes of q, k, v and o per query row at f32; past a few hundred keys
// the products dominate.  This first version runs them on the CUDA cores
// in f32: per key tile of 64, the block stages k (then v) converted to
// f32 in shared memory, each of 256 threads computes a 4 x 4 block of
// scores from registers (8 shared loads per 16 fused multiply-adds),
// the 16 threads that share a row reduce its maximum and sum with warp
// shuffles, and the probabilities go through shared memory into a
// 4 rows x ceil(hd/16) columns register block of acc.  Tiles strictly
// above the causal diagonal are never visited.  This kernel serves
// inputs whose head_dim is not a multiple of 8, in f32 and in bf16;
// other inputs go to the tensor-core kernels, flash_attention_sm90.cu
// (bf16) and flash_attention_f32_sm90.cu (f32, as split TF32).  The
// routing rule is in kernels/flash_attention.py.
//
// Numerics follow the TPU kernel: q is scaled by hd^-0.5 before the
// product, scores and statistics are f32, acc is rescaled by
// exp(m_prev - m_new) and divided by l once at the end.  Masked scores
// are -inf, and the statistics treat a row that has seen no valid key
// yet as m = 0, so such a row keeps l = 0 and acc = 0 and is written as
// 0 (the TPU kernel writes 0 when it skips such a row's blocks, and a
// block-size-dependent share of v when it visits one); a NaN row stays
// NaN.  Any T, S, H % KV
// == 0 and hd <= 192; rows past T and keys past S are masked by length,
// so no padding is needed.  This source builds with -fmad=true: the
// kernel is held to a tolerance (rtol/atol 2e-5 in f32), not bitwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;    // 16 x 16 threads
constexpr int kRows = kBQ / 16;  // query rows per thread
constexpr int kKeys = kBK / 16;  // keys per thread in a score tile
constexpr int kLdP = kBK + 4;    // probability row stride (no bank clash)
constexpr int kMaxHeadDim = 192;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// kDims: columns of acc per thread, ceil(hd / 16) rounded up to 4, 8, 12.
template <typename Elem, int kDims>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const Elem* __restrict__ q, const Elem* __restrict__ k,
                       const Elem* __restrict__ v, Elem* __restrict__ o,
                       int H, int KV, int T, int S, int hd, int ld,
                       int q_tiles, int causal, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;               // [kBQ][ld] q * scale
  float* kvs = qs + kBQ * ld;     // [kBK][ld] k, then v, of one tile
  float* ps = kvs + kBK * ld;     // [kBQ][kLdP] probabilities

  const int tid = threadIdx.x;
  const int tx = tid & 15;        // keys tx + 16 j; acc columns tx + 16 j
  const int ty = tid >> 4;        // rows ty * kRows + i
  const int bh = blockIdx.x / q_tiles;
  const int qt = q_tiles - 1 - (blockIdx.x - bh * q_tiles);
  const int h = bh % H;
  const int b = bh / H;
  const int kvh = h / (H / KV);
  const int q0 = qt * kBQ;
  const int q_rows = min(kBQ, T - q0);
  const int offset = S - T;       // query t sees keys <= t + offset
  const long long q_base = (static_cast<long long>(b) * H + h) * T * hd
      + static_cast<long long>(q0) * hd;
  const long long kv_base = (static_cast<long long>(b) * KV + kvh) * S * hd;

  for (int i = tid; i < kBQ * hd; i += kThreads) {
    const int r = i / hd;
    const int d = i - r * hd;
    qs[r * ld + d] = r < q_rows ? load_f32(q + q_base + i) * scale : 0.0f;
  }

  float m[kRows], l[kRows], acc[kRows][kDims];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kDims; ++j) acc[i][j] = 0.0f;
  }

  // Keys past the last row's diagonal are masked for every row here.
  const int k_end = causal ? min(S, q0 + q_rows + offset) : S;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    const int nk = min(kBK, S - k0);
    const long long tile = kv_base + static_cast<long long>(k0) * hd;
    __syncthreads();              // the last tile's readers are done
    for (int i = tid; i < kBK * hd; i += kThreads) {
      const int r = i / hd;
      const int d = i - r * hd;
      kvs[r * ld + d] = r < nk ? load_f32(k + tile + i) : 0.0f;
    }
    __syncthreads();

    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < hd; ++d) {
      float qv[kRows], kv[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(ty * kRows + i) * ld + d];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) kv[j] = kvs[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int t = q0 + ty * kRows + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int c = k0 + tx + 16 * j;
        const bool ok = c < S && (!causal || c <= t + offset);
        s[i][j] = ok ? s[i][j] : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // The 16 threads of a row are one half-warp: xor 8..1 stays in it.
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float m_use = m_new == -INFINITY ? 0.0f : m_new;
      const float corr = expf(m[i] - m_use);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float p = expf(s[i][j] - m_use);
        ps[(ty * kRows + i) * kLdP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kDims; ++j) acc[i][j] *= corr;
    }

    __syncthreads();              // scores read k; ps is complete
    for (int i = tid; i < kBK * hd; i += kThreads) {
      const int r = i / hd;
      const int d = i - r * hd;
      kvs[r * ld + d] = r < nk ? load_f32(v + tile + i) : 0.0f;
    }
    __syncthreads();
    for (int c = 0; c < nk; ++c) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = ps[(ty * kRows + i) * kLdP + c];
#pragma unroll
      for (int j = 0; j < kDims; ++j) {
        const int d = tx + 16 * j;
        const float vv = d < hd ? kvs[c * ld + d] : 0.0f;
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][j] += pv[i] * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty * kRows + i;
    if (r >= q_rows) continue;
    Elem* out = o + q_base + static_cast<long long>(r) * hd;
#pragma unroll
    for (int j = 0; j < kDims; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) store_from_f32(out + d, l[i] != 0.0f ? acc[i][j] / l[i] : 0.0f);
    }
  }
}

template <typename Elem, int kDims>
int launch(const Elem* q, const Elem* k, const Elem* v, Elem* o, int B, int H,
           int KV, int T, int S, int hd, int causal, float scale,
           cudaStream_t stream) {
  const int ld = hd | 1;          // odd row stride: no bank clash on k rows
  const int q_tiles = (T + kBQ - 1) / kBQ;
  const long long blocks = static_cast<long long>(B) * H * q_tiles;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(kBQ + kBK) * ld + static_cast<size_t>(kBQ) * kLdP);
  auto kernel = flash_attention_kernel<Elem, kDims>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      q, k, v, o, H, KV, T, S, hd, ld, q_tiles, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename Elem>
int dispatch(const Elem* q, const Elem* k, const Elem* v, Elem* o, int B,
             int H, int KV, int T, int S, int hd, int causal, float scale,
             void* stream) {
  if (hd < 1 || hd > kMaxHeadDim || KV < 1 || H % KV != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd <= 64) return launch<Elem, 4>(q, k, v, o, B, H, KV, T, S, hd, causal, scale, st);
  if (hd <= 128) return launch<Elem, 8>(q, k, v, o, B, H, KV, T, S, hd, causal, scale, st);
  return launch<Elem, 12>(q, k, v, o, B, H, KV, T, S, hd, causal, scale, st);
}

}  // namespace

extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, float* o, int B, int H,
                                   int KV, int T, int S, int hd, int causal,
                                   float scale, void* stream) {
  return dispatch(q, k, v, o, B, H, KV, T, S, hd, causal, scale, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int B, int H,
                                    int KV, int T, int S, int hd, int causal,
                                    float scale, void* stream) {
  using bf16 = __nv_bfloat16;
  return dispatch(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<bf16*>(o), B, H,
                  KV, T, S, hd, causal, scale, stream);
}
