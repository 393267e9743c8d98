// Dynamic rates over resampled tracks: v (B,3,M) lat/lon/alt on a
// uniform grid, count (B,) -> (B,4,M) vertical rate, ground speed,
// heading and turn rate; zero at and past count.
//
// Replaces the TPU kernel src/repro/kernels/dynamic_rates.py
// (_kernel / dynamic_rates_pallas): a clamped central-difference
// stencil held in VMEM, one grid step per track.
//
// Bound: memory and launch.  Each position reads 12 bytes and writes
// 16; the arithmetic (a cos, a sqrt, an atan2 and a few divides) is far
// below what the card could do in the time the bytes take.  The design
// keeps every intermediate out of device memory: one block per
// (row, tile of 256 positions) stages lat/lon/alt for the tile plus a
// two-sample halo on each side in shared memory, computes the heading
// at every position the tile's turn rates need (the tile and one more
// on each side) into shared memory, synchronises, and then writes the
// four outputs of each position once.  Rows and tiles share grid.x
// (block = row * tiles + tile), so B is not held to grid.y's 65535.
//
// Numerics follow kernels/ref.py's dynamic_rates_ref op for op:
// neighbours li = max(i-1, 0) and ri = min(i+1, max(count-1, 0)),
// deg2rad as lat * f32(pi/180), and the heading difference wrapped with
// a floor-mod, as jnp's and torch's % are (CUDA's fmodf truncates, so
// the sign is fixed up by hand).  Built with -fmad=false.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;
constexpr int kHalo = 2;
constexpr float kMPerDeg = 111111.0f;
constexpr float kDeg2Rad = 0.017453292519943295f;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;

struct Stencil {
  int li, ri;
  float denom;
};

__device__ __forceinline__ Stencil stencil(int p, int last, float dt) {
  Stencil s;
  s.li = max(p - 1, 0);
  s.ri = min(p + 1, max(last, 0));
  s.denom = static_cast<float>(max(s.ri - s.li, 1)) * dt;
  return s;
}

__device__ __forceinline__ float floor_mod(float x, float y) {
  float r = fmodf(x, y);
  if (r != 0.0f && ((r < 0.0f) != (y < 0.0f))) r += y;
  return r;
}

__global__ void dynamic_rates_kernel(const float* __restrict__ v,
                                     const int* __restrict__ count,
                                     float* __restrict__ out, int M,
                                     float dt, int tiles) {
  // Shared slot s holds position base + s, base = m0 - kHalo.
  __shared__ float lat[kTile + 2 * kHalo];
  __shared__ float lon[kTile + 2 * kHalo];
  __shared__ float alt[kTile + 2 * kHalo];
  __shared__ float heading[kTile + 2 * kHalo];

  const int b = blockIdx.x / tiles;
  const int m0 = (blockIdx.x - b * tiles) * kTile;
  const int base = m0 - kHalo;
  const int n = min(count[b], M);
  const int last = n - 1;
  const float* vb = v + static_cast<long long>(b) * 3 * M;

  for (int s = threadIdx.x; s < kTile + 2 * kHalo; s += blockDim.x) {
    const int p = base + s;
    if (p >= 0 && p < M) {
      lat[s] = vb[p];
      lon[s] = vb[M + p];
      alt[s] = vb[2 * M + p];
    }
  }
  __syncthreads();

  // Every stencil read below stays inside [0, last], and a position's
  // neighbours are at most kHalo away, so each read lands in the tile
  // or its halo.  Heading is needed at the tile and one more each side.
  for (int s = threadIdx.x + 1; s < kTile + 2 * kHalo - 1; s += blockDim.x) {
    const int p = base + s;
    if (p < 0 || p > last) continue;
    const Stencil st = stencil(p, last, dt);
    const int l = st.li - base, r = st.ri - base;
    const float dn = (lat[r] - lat[l]) / st.denom * kMPerDeg;
    const float de = (lon[r] - lon[l]) / st.denom * kMPerDeg
                     * cosf(lat[s] * kDeg2Rad);
    heading[s] = atan2f(de, dn);
  }
  __syncthreads();

  const int i = m0 + threadIdx.x;
  if (i >= M) return;
  float* ob = out + static_cast<long long>(b) * 4 * M;
  if (i > last) {
    ob[i] = 0.0f;
    ob[M + i] = 0.0f;
    ob[2 * M + i] = 0.0f;
    ob[3 * M + i] = 0.0f;
    return;
  }
  const int s = i - base;
  const Stencil st = stencil(i, last, dt);
  const int l = st.li - base, r = st.ri - base;
  const float vrate = (alt[r] - alt[l]) / st.denom;
  const float dn = (lat[r] - lat[l]) / st.denom * kMPerDeg;
  const float de = (lon[r] - lon[l]) / st.denom * kMPerDeg
                   * cosf(lat[s] * kDeg2Rad);
  const float gspeed = sqrtf(dn * dn + de * de);
  float dh = (heading[r] - heading[l]) / st.denom * dt;
  dh = floor_mod(dh + kPi, kTwoPi) - kPi;
  ob[i] = vrate;
  ob[M + i] = gspeed;
  ob[2 * M + i] = heading[s];
  ob[3 * M + i] = dh / dt;
}

}  // namespace

extern "C" int dynamic_rates_f32(const float* v, const int* count,
                                 float* out, int B, int M, float dt,
                                 void* stream) {
  if (B == 0 || M == 0) return 0;
  const int tiles = (M + kTile - 1) / kTile;
  const long long blocks = static_cast<long long>(B) * tiles;
  if (blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  dynamic_rates_kernel<<<static_cast<unsigned>(blocks), kTile, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      v, count, out, M, dt, tiles);
  return static_cast<int>(cudaGetLastError());
}
