// Piecewise-linear track resampling: (B,N) knots, (B,C,N) values,
// (B,) counts, (B,M) query times -> (B,M,C).
//
// Replaces the TPU kernel src/repro/kernels/track_interp.py
// (_kernel / track_interp_pallas), which recasts the resample as two
// masked (MB x N) @ (N x C) MXU products because gathers and searches
// are slow on the TPU's vector unit.  On Hopper the direct form is the
// cheap one: per query a binary search over the row's knots and a
// two-point lerp.
//
// Bound: bytes.  Each query reads one time and writes C values, and
// each row's first `count` knots (time and C values) are read once; the
// arithmetic is a dozen flops and log2(N) compares per query.  At the
// process phase's buckets (B = 1024 rows) every block of a launch is
// resident at once, so the time is the launch, one block's dependent
// chain and the bytes.  The design shortens the chain and moves the
// bytes in wide, coalesced accesses:
//   * a block owns whole rows (several at M <= 512, so it still has 256
//     threads of queries); its threads cp.async the row's first `count`
//     knot times and, on the "shared" route, its C value planes into
//     shared memory once (16-byte copies where the bases allow), then
//     one barrier.  The first query times are loaded before that wait,
//     so the two latencies overlap;
//   * each thread takes 4 consecutive queries (one 16-byte load of
//     t_out where M % 4 == 0 and the bases are aligned, else scalar
//     loads): a binary search for the first, a forward walk from it for
//     the next ones when they do not decrease (the same upper_bound as a
//     fresh search, since the knots are sorted), a fresh search when
//     they do;
//   * the lerp reads shared memory.  At C = 3 a warp's 128 queries are
//     384 contiguous floats of the output: they are restaged through
//     shared memory so that each 16-byte store instruction of the warp
//     writes 512 contiguous bytes, not 32 pieces 48 bytes apart (every
//     caller's tracks are lat/lon/alt); other C store scalars;
//   * the "gather" route keeps only the knot times in shared memory and
//     reads the two bracketing values from device memory, for rows whose
//     (1 + C) * N floats do not fit a block's 227 KB.
// kernels/track_interp.py's plan() picks the route, the rows per block
// and the shared bytes by a fixed rule; blocks ride on grid.x, so B is
// not held to grid.y's 65535.
//
// Numerics follow kernels/ref.py's track_interp_ref op for op: clamp to
// [t0, t_{count-1}], searchsorted(side="right") clipped to [1, count-1],
// w = 0 on zero-length intervals, (1-w)*v_l + w*v_r.  Built with
// -fmad=false so no product is fused into a sum.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxSmem = 232448;       // bytes a block can use on an H100
constexpr int kWalk = 4;               // forward steps before a search

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src) : "memory");
}

// The `lane`-th of `stride` threads copies its share of n floats.
__device__ __forceinline__ void stage(float* dst, const float* src, int n,
                                      bool al16, int lane, int stride) {
  if (al16) {
    for (int i = lane; i < (n + 3) >> 2; i += stride) {
      cp_async16(dst + 4 * i, src + 4 * i);
    }
  } else {
    for (int i = lane; i < n; i += stride) cp_async4(dst + i, src + i);
  }
}

// The number of knots[lo..hi) <= q, plus lo: upper_bound on [lo, hi).
__device__ __forceinline__ int upper_bound(const float* knots, int lo, int hi,
                                           float q) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (knots[mid] <= q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <bool VEC>
__device__ __forceinline__ void load_queries(const float* row, int m0, int M,
                                             float q[4]) {
  if (VEC) {
    const float4 t = *reinterpret_cast<const float4*>(row + m0);
    q[0] = t.x; q[1] = t.y; q[2] = t.z; q[3] = t.w;
  } else {
    q[0] = row[m0];
#pragma unroll
    for (int j = 1; j < 4; ++j) q[j] = m0 + j < M ? row[m0 + j] : q[j - 1];
  }
}

// One value of the lerp: query j's bracket (id[j] - 1, id[j]), channel c.
template <bool GATHER>
__device__ __forceinline__ float lerp(const float* vals, const float* v_row,
                                      int N, int c, int idx, float w) {
  const float* p = GATHER ? v_row + static_cast<long long>(c) * N
                          : vals + c * N;
  const float vl = GATHER ? __ldg(p + idx - 1) : p[idx - 1];
  const float vr = GATHER ? __ldg(p + idx) : p[idx];
  return (1.0f - w) * vl + w * vr;
}

// CC is the channel count when known at compile time (3, the track's
// lat/lon/alt), else 0 and the runtime C_rt is used.  Dynamic shared
// memory holds `rows` rows of (GATHER ? 1 : 1 + C) planes of N floats,
// then, for VEC and C = 3, 12 floats a thread to restage the output.
template <bool VEC, bool GATHER, int CC>
__global__ void __launch_bounds__(kMaxThreads)
track_interp_kernel(const float* __restrict__ t_in,
                    const float* __restrict__ v_in,
                    const int* __restrict__ count,
                    const float* __restrict__ t_out,
                    float* __restrict__ out, int B, int N, int C_rt, int M,
                    int rows, int per_row) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool kStageOut = VEC && CC == 3;
  const int C = CC ? CC : C_rt;
  const int row_floats = GATHER ? N : (1 + C) * N;
  const int r = threadIdx.x / per_row;
  const int lane = threadIdx.x - r * per_row;      // per_row % 32 == 0
  const int wl = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * rows + r;
  const bool live = b < B;                         // uniform in a warp
  float* knots = smem + r * row_floats;
  float* vals = knots + N;
  const float* q_row = t_out + b * M;
  const int groups = (M + 3) >> 2;

  // The first group's query times go out before the staging waits.
  float q[4];
  if (live && lane < groups) load_queries<VEC>(q_row, 4 * lane, M, q);
  int n = 2;
  if (live) {
    // count >= 2 is the contract; clamping into [2, N] keeps a bad count
    // inside the row instead of reading past it.
    n = min(max(count[b], 2), N);
    const bool al16 = (N & 3) == 0
        && ((reinterpret_cast<uintptr_t>(t_in)
             | reinterpret_cast<uintptr_t>(v_in)) & 15) == 0;
    stage(knots, t_in + b * N, n, al16, lane, per_row);
    if (!GATHER) {
      for (int c = 0; c < C; ++c) {
        stage(vals + c * N, v_in + (b * C + c) * N, n, al16, lane, per_row);
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  if (!live) return;

  const int last = n - 1;
  const float t0 = knots[0];
  const float tl = knots[last];
  const float* v_row = v_in + b * C * N;
  // A warp takes 32 consecutive query groups a step, so the loop and the
  // warp's restaging of the output stay uniform across it.
  for (int g0 = lane - wl; g0 < groups; g0 += per_row) {
    const int g = g0 + wl;
    const int m0 = 4 * g;
    const bool active = g < groups;
    int id[4];
    float w[4];
    if (active) {
      if (g != lane) load_queries<VEC>(q_row, m0, M, q);
      int ub = 0;
      float prev = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = q[j];
        x = x < t0 ? t0 : x;
        x = x > tl ? tl : x;
        if (j > 0 && x >= prev) {
          // Every knot below ub is <= prev <= x: walk on from there.
          int s = 0;
          while (s < kWalk && ub < n && knots[ub] <= x) { ++ub; ++s; }
          if (s == kWalk) ub = upper_bound(knots, ub, n, x);
        } else {
          ub = upper_bound(knots, 0, n, x);
        }
        prev = x;
        int idx = ub < 1 ? 1 : ub;
        idx = idx > last ? last : idx;
        const float tj = knots[idx - 1];
        const float tj1 = knots[idx];
        id[j] = idx;
        w[j] = tj1 > tj ? (x - tj) / (tj1 - tj) : 0.0f;
      }
    }

    if constexpr (kStageOut) {
      // A thread's 4 queries are 12 contiguous floats of the output, and
      // the warp's 32 lanes 384: restage them through shared memory so
      // each 16-byte store instruction of the warp writes 512 contiguous
      // bytes instead of 32 pieces 48 bytes apart.
      float4* warp_buf = reinterpret_cast<float4*>(
          smem + ((rows * row_floats + 3) & ~3)) + 3 * (threadIdx.x - wl);
      if (active) {
        float e[12];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            e[3 * j + c] = lerp<GATHER>(vals, v_row, N, c, id[j], w[j]);
          }
        }
        warp_buf[3 * wl] = make_float4(e[0], e[1], e[2], e[3]);
        warp_buf[3 * wl + 1] = make_float4(e[4], e[5], e[6], e[7]);
        warp_buf[3 * wl + 2] = make_float4(e[8], e[9], e[10], e[11]);
      }
      __syncwarp();
      float4* dst = reinterpret_cast<float4*>(out + (b * M + 4 * g0) * 3);
      const int n4 = 3 * min(32, groups - g0);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        if (wl + 32 * k < n4) dst[wl + 32 * k] = warp_buf[wl + 32 * k];
      }
      __syncwarp();
    } else if (active) {
      float* o = out + (b * M + m0) * C;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (m0 + j >= M) break;
        for (int c = 0; c < C; ++c) {
          o[j * C + c] = lerp<GATHER>(vals, v_row, N, c, id[j], w[j]);
        }
      }
    }
  }
}

// How a launch splits its work (kernels/track_interp.py's plan()).
struct Split {
  int rows, per_row, blocks, smem;
};

template <bool VEC, bool GATHER, int CC>
int launch(const float* t_in, const float* v_in, const int* count,
           const float* t_out, float* out, int B, int N, int C, int M,
           Split sp, cudaStream_t stream) {
  auto kernel = track_interp_kernel<VEC, GATHER, CC>;
  if (sp.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sp.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<sp.blocks, sp.rows * sp.per_row, sp.smem, stream>>>(
      t_in, v_in, count, t_out, out, B, N, C, M, sp.rows, sp.per_row);
  return static_cast<int>(cudaGetLastError());
}

template <bool VEC, bool GATHER>
int launch_c(const float* t_in, const float* v_in, const int* count,
             const float* t_out, float* out, int B, int N, int C, int M,
             Split sp, cudaStream_t stream) {
  return C == 3
      ? launch<VEC, GATHER, 3>(t_in, v_in, count, t_out, out, B, N, C, M, sp,
                               stream)
      : launch<VEC, GATHER, 0>(t_in, v_in, count, t_out, out, B, N, C, M, sp,
                               stream);
}

}  // namespace

// rows, per_row (a multiple of 32), blocks (ceil(B / rows)) and smem
// come from kernels/track_interp.py's plan(); gather selects the route,
// vec the 16-byte path (M % 4 == 0, t_out and out 16-byte aligned).
extern "C" int track_interp_f32(const float* t_in, const float* v_in,
                                const int* count, const float* t_out,
                                float* out, int B, int N, int C, int M,
                                int rows, int per_row, int blocks, int smem,
                                int gather, int vec, void* stream) {
  if (B == 0 || M == 0) return 0;
  if (rows < 1 || per_row < 32 || per_row % 32 || rows * per_row > kMaxThreads
      || smem < 0 || smem > kMaxSmem
      || (static_cast<long long>(B) + rows - 1) / rows != blocks) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const Split sp{rows, per_row, blocks, smem};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = vec ? (gather ? launch_c<true, true> : launch_c<true, false>)
                : (gather ? launch_c<false, true> : launch_c<false, false>);
  return go(t_in, v_in, count, t_out, out, B, N, C, M, sp, s);
}
