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
// Bound: memory and launch.  Each query reads one time and writes C
// values, and the knots come from L2 after the first block of a row;
// the arithmetic is a dozen flops and log2(N) compares per query.  The
// design keeps device traffic at the bytes that must move: one block
// per (row, tile of 256 queries) stages the row's `count` knot times in
// shared memory once (at most N floats), so the search never touches
// device memory, and each thread reads its two bracketing value columns
// straight from the (B,C,N) planes.  Rows and tiles share grid.x
// (block = row * tiles + tile), so B is not held to grid.y's 65535.
//
// Numerics follow kernels/ref.py's track_interp_ref op for op: clamp to
// [t0, t_{count-1}], searchsorted(side="right") clipped to [1, count-1],
// w = 0 on zero-length intervals, (1-w)*v_l + w*v_r.  Built with
// -fmad=false so no product is fused into a sum.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void track_interp_kernel(const float* __restrict__ t_in,
                                    const float* __restrict__ v_in,
                                    const int* __restrict__ count,
                                    const float* __restrict__ t_out,
                                    float* __restrict__ out,
                                    int N, int C, int M, int tiles) {
  extern __shared__ float knots[];          // the row's first `count` times
  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x - b * tiles;
  // count >= 2 is the contract; clamping into [2, N] keeps a bad count
  // inside the row instead of reading past it.
  const int n = min(max(count[b], 2), N);
  const float* t_row = t_in + static_cast<long long>(b) * N;
  for (int i = threadIdx.x; i < n; i += blockDim.x) knots[i] = t_row[i];
  __syncthreads();

  const int m = tile * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const int last = n - 1;
  const float t0 = knots[0];
  const float tl = knots[last];
  float q = t_out[static_cast<long long>(b) * M + m];
  q = q < t0 ? t0 : q;
  q = q > tl ? tl : q;

  // upper_bound: the number of knots <= q.
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (knots[mid] <= q) lo = mid + 1; else hi = mid;
  }
  int idx = lo < 1 ? 1 : lo;
  idx = idx > last ? last : idx;

  const float tj = knots[idx - 1];
  const float tj1 = knots[idx];
  const float w = tj1 > tj ? (q - tj) / (tj1 - tj) : 0.0f;
  const float* v_row = v_in + static_cast<long long>(b) * C * N;
  float* o = out + (static_cast<long long>(b) * M + m) * C;
  for (int c = 0; c < C; ++c) {
    const float vl = v_row[c * N + idx - 1];
    const float vr = v_row[c * N + idx];
    o[c] = (1.0f - w) * vl + w * vr;
  }
}

}  // namespace

extern "C" int track_interp_f32(const float* t_in, const float* v_in,
                                const int* count, const float* t_out,
                                float* out, int B, int N, int C, int M,
                                void* stream) {
  if (B == 0 || M == 0) return 0;
  const int tiles = (M + kThreads - 1) / kThreads;
  const long long blocks = static_cast<long long>(B) * tiles;
  if (blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const size_t smem = static_cast<size_t>(N) * sizeof(float);
  track_interp_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      t_in, v_in, count, t_out, out, N, C, M, tiles);
  return static_cast<int>(cudaGetLastError());
}
