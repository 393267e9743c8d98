// Causal online-softmax GQA attention for head_dims above 256, in f16,
// bf16 or f32 (one template over the element type E): q (B,H,T,hd), k/v
// (B,KV,S,hd) in E -> (B,H,T,hd) in E, f32 inside, on CUDA cores.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py (_kernel,
// lines 44-93; pl.pallas_call at line 124) for every head_dim the
// tensor-core kernels (csrc/flash_attention_sm90.cu,
// csrc/flash_attention_f32_sm90.cu) do not take: wgmma's widest product is
// 256 columns, and an accumulator of 512 f32 columns a row does not fit in
// a warpgroup's registers.  No upper limit on head_dim.
//
// Bound: operations.  Each (query, key) pair the mask keeps costs 2*hd
// flops for the score and 2*hd for the weighted sum.  This kernel runs
// them on CUDA cores in f32 (67 TFLOP/s on an H100 SXM) and recomputes the
// score once per output chunk: 2*hd*ceil(hd / 256) + 2*hd flops a pair.
//
// Design (simple first; its redesign on the tensor cores is queued).  One
// CTA of 256 threads per (64-row q tile, output chunk, b, h), all on
// grid.x with every head's heaviest causal tile first.  The output
// columns are cut into ceil(hd / 256) chunks of equal width (a multiple of
// 16, at most 256): chunk c owns columns [c * cw, c * cw + cw).  Per key
// tile of 64 keys a CTA
//  - computes S = q k^T over the whole head_dim, streaming q and k through
//    shared memory 32 columns at a time (each converted to f32 once), each
//    thread a 4 x 4 block of S in f32 fmaf chains;
//  - runs the online softmax in f32 on its rows (a row is spread over the
//    16 threads of a half-warp: max and sum by shuffles), writes P to
//    shared memory, and loads its own 64 x cw slice of v;
//  - adds P v into a 4 x (cw / 16) block of the output a thread.
// S is thus recomputed once per chunk, ceil(hd / 256) times (twice at hd
// 257-512, four times at 1024).
//
// Numerics: every product and sum in f32 (q and k widened exactly), the
// plain version's recurrence (masked scores -inf, a row that has seen no
// valid key keeps m = 0 for its exponentials, acc rescaled by
// exp(m_prev - m_new)), acc / l rounded once to E; a row whose l = 0 is
// written as 0 (a NaN row stays NaN).  Builds with -fmad=true.
//
// Shapes: any T and S (query t sees keys <= t + S - T when causal), any
// head_dim >= 1 read element by element (no padding, any alignment),
// H % KV == 0, query head h reading kv head h / (H / KV).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;           // query rows per CTA
constexpr int kBK = 64;           // keys per tile
constexpr int kDK = 32;           // q/k columns per shared-memory pass
constexpr int kMaxCW = 256;       // widest output chunk
constexpr int kThreads = 256;     // 16 x 16
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kBQ == kBK && kBQ * kDK % kThreads == 0,
              "one loop stages a q and a k pass");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename E>
__device__ __forceinline__ E from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Max and sum over the 16 threads of a half-warp (one row's).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int s = 1; s < 16; s <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, s));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int s = 1; s < 16; s <<= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
  return x;
}

// Thread (ty, tx) = (tid / 16, tid % 16) owns rows ty + 16 i (i < 4), keys
// tx + 16 j (j < 4) of S, and output columns c0 + tx + 16 jj (jj < nj).
template <typename E>
__global__ void __launch_bounds__(kThreads)
flash_attention_wide_kernel(const E* __restrict__ q, const E* __restrict__ k,
                            const E* __restrict__ v, E* __restrict__ o, int H,
                            int KV, int T, int S, int hd, int hd_out, int cw,
                            int n_chunks, int BH, int causal, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                          // [kBQ][kDK + 1]
  float* ks = qs + kBQ * (kDK + 1);          // [kBK][kDK + 1]
  float* ps = ks + kBK * (kDK + 1);          // [kBQ][kBK + 1]
  float* vs = ps + kBQ * (kBK + 1);          // [kBK][cw]

  const long long per_tile = static_cast<long long>(BH) * n_chunks;
  const int q_tiles = static_cast<int>(gridDim.x / per_tile);
  const int qt = q_tiles - 1 - static_cast<int>(blockIdx.x / per_tile);
  const int rem = static_cast<int>(blockIdx.x % per_tile);
  const int bh = rem / n_chunks;
  const int chunk = rem - bh * n_chunks;
  const int b = bh / H;
  const int kvh = (bh - b * H) / (H / KV);
  const int q0 = qt * kBQ;
  const int q_rows = min(kBQ, T - q0);
  const int offset = S - T;        // query t sees keys <= t + offset
  const int k_end = causal ? min(S, q0 + q_rows + offset) : S;
  const int n_tiles = k_end > 0 ? (k_end + kBK - 1) / kBK : 0;
  const int c0 = chunk * cw;
  const int nj = cw / 16;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const E* qb = q + static_cast<long long>(bh) * T * hd;
  const E* kb = k + (static_cast<long long>(b) * KV + kvh) * S * hd;
  const E* vb = v + (static_cast<long long>(b) * KV + kvh) * S * hd;

  float acc[4][kMaxCW / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < kMaxCW / 16; ++jj) acc[i][jj] = 0.0f;
  float m[4], l[4];                // l: this thread's share of the row sum
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
    for (int d0 = 0; d0 < hd; d0 += kDK) {
      __syncthreads();             // the previous pass is done with qs, ks
#pragma unroll
      for (int r = 0; r < kBQ * kDK / kThreads; ++r) {
        const int e = tid + kThreads * r;
        const int row = e / kDK, col = e % kDK;
        const bool in_col = d0 + col < hd;
        qs[row * (kDK + 1) + col] =
            (q0 + row < T && in_col)
                ? to_f32(qb[static_cast<long long>(q0 + row) * hd + d0 + col])
                : 0.0f;
        ks[row * (kDK + 1) + col] =
            (k0 + row < S && in_col)
                ? to_f32(kb[static_cast<long long>(k0 + row) * hd + d0 + col])
                : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int d = 0; d < kDK; ++d) {
        float a[4], bk[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * (kDK + 1) + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) bk[j] = ks[(tx + 16 * j) * (kDK + 1) + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], bk[j], sc[i][j]);
      }
    }
    // Scale and mask, then the online softmax row by row.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        const float x = sc[i][j] * scale;
        sc[i][j] = (c < S && (!causal || c <= t + offset)) ? x : -INFINITY;
        mx = fmaxf(mx, sc[i][j]);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float m_use = m_new == -INFINITY ? 0.0f : m_new;
      const float corr = exp2f((m[i] - m_use) * kLog2e);
      const float mb = m_use * kLog2e;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(fmaf(sc[i][j], kLog2e, -mb));
        ps[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < kMaxCW / 16; ++jj) acc[i][jj] *= corr;
    }
    // This chunk's slice of the v tile.
    for (int e = tid; e < kBK * cw; e += kThreads) {
      const int row = e / cw, col = e - (e / cw) * cw;
      vs[e] = (k0 + row < S && c0 + col < hd_out)
                  ? to_f32(vb[static_cast<long long>(k0 + row) * hd + c0 + col])
                  : 0.0f;
    }
    __syncthreads();
    // O += P v.
    for (int kk = 0; kk < kBK; ++kk) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = ps[(ty + 16 * i) * (kBK + 1) + kk];
      const float* vrow = vs + kk * cw + tx;
#pragma unroll
      for (int jj = 0; jj < kMaxCW / 16; ++jj) {
        if (jj < nj) {
          const float x = vrow[16 * jj];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(pr[i], x, acc[i][jj]);
        }
      }
    }
  }

  // Epilogue: the row sum over its 16 threads, acc / l, one rounding to E.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float li = row_sum(l[i]);
    const int t = q0 + ty + 16 * i;
    if (t >= T) continue;
    const bool any = li != 0.0f;         // a NaN row stays NaN
    E* out = o + (static_cast<long long>(bh) * T + t) * hd_out + c0;
#pragma unroll
    for (int jj = 0; jj < kMaxCW / 16; ++jj) {
      const int c = tx + 16 * jj;
      if (jj < nj && c0 + c < hd_out)
        out[c] = from_f32<E>(any ? acc[i][jj] / li : 0.0f);
    }
  }
}

// q, k, v have rows of hd; o has rows of hd_out <= hd (the columns past
// hd_out of q and k still count in the scores).
template <typename E>
int run(const void* q, const void* k, const void* v, void* o, int B, int H,
        int KV, int T, int S, int hd, int hd_out, int causal, float scale,
        void* stream) {
  if (hd < 1 || hd_out < 1 || hd_out > hd || KV < 1 || H % KV != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || H == 0 || T == 0) return 0;
  if (S == 0) {                   // no key at all: every row is 0
    cudaMemsetAsync(o, 0, static_cast<size_t>(B) * H * T * hd_out * sizeof(E),
                    st);
    return static_cast<int>(cudaGetLastError());
  }
  // Chunks of equal width, a multiple of 16 and at most kMaxCW.
  const int n_chunks = (hd_out + kMaxCW - 1) / kMaxCW;
  const int cw = ((hd_out + n_chunks - 1) / n_chunks + 15) / 16 * 16;
  const long long q_tiles = (T + kBQ - 1) / kBQ;
  const long long blocks =
      q_tiles * static_cast<long long>(B) * H * n_chunks;
  if (blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const size_t smem =
      sizeof(float) * (kBQ * (kDK + 1) + kBK * (kDK + 1) + kBQ * (kBK + 1) +
                       static_cast<size_t>(kBK) * cw);
  auto kernel = flash_attention_wide_kernel<E>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<E*>(o), H, KV, T, S, hd, hd_out,
      cw, n_chunks, B * H, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_wide_f32(const void* q, const void* k,
                                        const void* v, void* o, int B, int H,
                                        int KV, int T, int S, int hd,
                                        int hd_out, int causal, float scale,
                                        void* stream) {
  return run<float>(q, k, v, o, B, H, KV, T, S, hd, hd_out, causal, scale,
                    stream);
}

extern "C" int flash_attention_wide_f16(const void* q, const void* k,
                                        const void* v, void* o, int B, int H,
                                        int KV, int T, int S, int hd,
                                        int hd_out, int causal, float scale,
                                        void* stream) {
  return run<__half>(q, k, v, o, B, H, KV, T, S, hd, hd_out, causal, scale,
                     stream);
}

extern "C" int flash_attention_wide_bf16(const void* q, const void* k,
                                         const void* v, void* o, int B, int H,
                                         int KV, int T, int S, int hd,
                                         int hd_out, int causal, float scale,
                                         void* stream) {
  return run<__nv_bfloat16>(q, k, v, o, B, H, KV, T, S, hd, hd_out, causal,
                            scale, stream);
}
