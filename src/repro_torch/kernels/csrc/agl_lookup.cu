// AGL altitude: MSL minus the bilinear DEM elevation at fractional
// (row, col) indices.  dem (H,W), fi/fj/alt (B,M) -> (B,M).
//
// Replaces the TPU kernel src/repro/kernels/agl_lookup.py
// (_kernel / agl_lookup_pallas), which prefetches one 128 x 256 DEM tile
// per track into VMEM and turns the four-point gather into an
// (M x TH) @ (TH x TW) MXU product plus a weighted row sum, because fine
// gathers are the TPU memory system's worst case.  Tracks that may
// leave their tile go to a jnp gather instead.
//
// Bound: memory.  Per point the kernel reads fi, fj, alt (12 bytes),
// writes 4 bytes and gathers 4 DEM cells; a track is a short, smooth
// path, so its cells are neighbours and come from L1/L2 after the first
// touch.  The design is one thread per point with a direct four-point
// gather from the whole DEM: no tile, so no tile limit and no second
// path for wide tracks, and neighbouring threads read neighbouring
// fi/fj/alt/out addresses.
//
// Numerics follow kernels/ref.py's agl_lookup_ref: clip to
// [0, H - 1.000001] and [0, W - 1.000001] (the bounds are rounded to f32
// on the host, as the JAX oracle rounds them), clamp the far neighbour
// into the grid as the JAX gather does, and sum the four weighted terms
// left to right.  Built with -fmad=false.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void agl_lookup_kernel(const float* __restrict__ dem,
                                  const float* __restrict__ fi,
                                  const float* __restrict__ fj,
                                  const float* __restrict__ alt,
                                  float* __restrict__ out,
                                  long long n, int H, int W,
                                  float fi_max, float fj_max) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (p >= n) return;
  float x = fi[p];
  float y = fj[p];
  // !(x >= 0) also sends a NaN index to 0, so no read leaves the grid.
  x = !(x >= 0.0f) ? 0.0f : x;
  x = x > fi_max ? fi_max : x;
  y = !(y >= 0.0f) ? 0.0f : y;
  y = y > fj_max ? fj_max : y;
  const int i0 = static_cast<int>(floorf(x));
  const int j0 = static_cast<int>(floorf(y));
  const int i1 = min(i0 + 1, H - 1);
  const int j1 = min(j0 + 1, W - 1);
  const float di = x - static_cast<float>(i0);
  const float dj = y - static_cast<float>(j0);
  const long long r0 = static_cast<long long>(i0) * W;
  const long long r1 = static_cast<long long>(i1) * W;
  const float z00 = dem[r0 + j0];
  const float z01 = dem[r0 + j1];
  const float z10 = dem[r1 + j0];
  const float z11 = dem[r1 + j1];
  const float elev = (1.0f - di) * (1.0f - dj) * z00
                     + (1.0f - di) * dj * z01
                     + di * (1.0f - dj) * z10
                     + di * dj * z11;
  out[p] = alt[p] - elev;
}

}  // namespace

extern "C" int agl_lookup_f32(const float* dem, const float* fi,
                              const float* fj, const float* alt, float* out,
                              long long n, int H, int W, float fi_max,
                              float fj_max, void* stream) {
  if (n == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  agl_lookup_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      dem, fi, fj, alt, out, n, H, W, fi_max, fj_max);
  return static_cast<int>(cudaGetLastError());
}
