// Dynamic rates over resampled tracks: v (B,3,M) lat/lon/alt on a
// uniform grid, count (B,) -> (B,4,M) vertical rate, ground speed,
// heading and turn rate; zero at and past count.
//
// Replaces the TPU kernel src/repro/kernels/dynamic_rates.py
// (_kernel / dynamic_rates_pallas): a clamped central-difference
// stencil held in VMEM, one grid step per track.
//
// Bound: bytes, barely.  Each valid position reads 12 bytes and every
// position writes 16, while its arithmetic (a cosf, an atan2f, a sqrtf,
// a floor-mod and five divisions) costs SASS instructions that take
// about as long to issue as the bytes take to move.  So the design
// computes each of them once, and keeps the launch's blocks resident:
//   * no shared memory and no barrier: a warp owns 128 consecutive
//     positions of one row, 4 per thread (16-byte loads of lat/lon/alt
//     and 16-byte stores of each output plane where M % 4 == 0 and the
//     bases are aligned, scalar accesses otherwise); rows never straddle
//     a warp, and a block takes several rows when M is small
//     (kernels/dynamic_rates.py's plan());
//   * the +-1 neighbours of a thread's 4 positions come from the
//     adjacent lanes by shuffles, and so do the +-1 neighbour headings
//     the turn rate needs; only a warp's two edge lanes load their halo
//     position and compute its heading themselves, in one branch;
//   * cosf(lat), dn and de are computed once per position and serve
//     both the heading and the ground speed;
//   * where dt is a power of two (the pipeline's 1 s grid) every
//     denominator is one, and the divisions become products with exact
//     reciprocals: the same bits, without the IEEE division's
//     refinement and slow-path branch (see quot below);
//   * at most 64 registers a thread, 4 blocks an SM.
// Blocks ride on grid.x, so B is not held to grid.y's 65535.
//
// Numerics follow kernels/ref.py's dynamic_rates_ref op for op as
// PyTorch runs it on the card: neighbours li = max(i-1, 0) and
// ri = min(i+1, max(count-1, 0)), deg2rad as lat * f32(pi/180), the
// heading difference wrapped with a floor-mod, as jnp's and torch's %
// are (CUDA's fmodf truncates, so the sign is fixed up by hand), and
// the final division by the Python scalar dt as a product with
// 1.0f / dt, as PyTorch divides a tensor by a scalar on the card.  A
// count above M counts as M.  Built with -fmad=false.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kMPerDeg = 111111.0f;
constexpr float kDeg2Rad = 0.017453292519943295f;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;

__device__ __forceinline__ float floor_mod(float x, float y) {
  float r = fmodf(x, y);
  if (r != 0.0f && ((r < 0.0f) != (y < 0.0f))) r += y;
  return r;
}

// x / d for the stencil's denominators.  With POW2, d is a power of two
// and rd its reciprocal, also one: then x * rd is the same real number
// as x / d, so one correctly rounded product equals the correctly
// rounded quotient bit for bit (subnormals included; nvcc's default
// -ftz=false -prec-div=true), and saves the division's refinement and
// its slow-path branch.
template <bool POW2>
__device__ __forceinline__ float quot(float x, float d, float rd) {
  return POW2 ? x * rd : x / d;
}

// The stencil at p: ri - li is 2 inside, 1 at one end, 0 for a
// one-point track (then 1); the denominator is that times dt.
struct Denom {
  float d, rd;
};

__device__ __forceinline__ Denom denom_at(int p, int last, float dt,
                                          float rdt) {
  const bool two = p > 0 && p < last;
  Denom s;
  s.d = (two ? 2.0f : 1.0f) * dt;
  s.rd = (two ? 0.5f : 1.0f) * rdt;
  return s;
}

struct Motion {
  float dn, de;
};

// North and east velocity at a position of latitude `lat` from its
// clamped neighbours, in the plain version's order of operations.
template <bool POW2>
__device__ __forceinline__ Motion motion(float lat_l, float lat_r,
                                         float lon_l, float lon_r, float lat,
                                         Denom s) {
  Motion m;
  m.dn = quot<POW2>(lat_r - lat_l, s.d, s.rd) * kMPerDeg;
  m.de = quot<POW2>(lon_r - lon_l, s.d, s.rd) * kMPerDeg
         * cosf(lat * kDeg2Rad);
  return m;
}

template <bool VEC>
__device__ __forceinline__ void load4(const float* row, int p0, int n,
                                      float x[4]) {
  if (VEC && p0 < n) {
    const float4 t = *reinterpret_cast<const float4*>(row + p0);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) x[k] = p0 + k < n ? row[p0 + k] : 0.0f;
  }
}

template <bool VEC>
__device__ __forceinline__ void store4(float* row, int p0, int M,
                                       const float x[4]) {
  if (VEC) {
    *reinterpret_cast<float4*>(row + p0) = make_float4(x[0], x[1], x[2],
                                                       x[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (p0 + k < M) row[p0 + k] = x[k];
    }
  }
}

// At most 64 registers a thread, so 4 blocks of 256 fit an SM: at the
// process phase's widths more warps in flight hide the transcendentals'
// latency better than more registers a thread would.
template <bool VEC, bool POW2>
__global__ void __launch_bounds__(kMaxThreads, 4)
dynamic_rates_kernel(const float* __restrict__ v,
                     const int* __restrict__ count,
                     float* __restrict__ out, int B, int M, float dt,
                     int rows, int per_row) {
  // per_row is a multiple of 32, so a warp lies in one row and every
  // branch on b, n or g0 below is uniform across it.
  const int r = threadIdx.x / per_row;
  const int lane = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * rows + r;
  if (b >= B) return;
  const int n = min(count[b], M);
  const int last = n - 1;
  // The plain version's last step, turn = dh / dt, divides by a Python
  // scalar, which PyTorch on the card computes as dh * (1.0f / dt): so
  // does this kernel.  With POW2 the reciprocal is exact.
  const float rdt = 1.0f / dt;
  const float* lat_r = v + b * 3 * M;
  const float* lon_r = lat_r + M;
  const float* alt_r = lon_r + M;
  float* o = out + b * 4 * M;
  const int groups = (M + 3) >> 2;

  for (int g0 = threadIdx.x - r * per_row - lane; g0 < groups;
       g0 += per_row) {
    const int p0 = 4 * (g0 + lane);
    float la[4], lo[4], al[4];
    load4<VEC>(lat_r, p0, n, la);
    load4<VEC>(lon_r, p0, n, lo);
    load4<VEC>(alt_r, p0, n, al);

    // Positions p0 - 1 and p0 + 4 from the neighbouring lanes.  Lane 0
    // needs p0 - 1 (and its heading) when p0 is a valid position past
    // the first, lane 31 needs p0 + 4 when that is valid: those two load
    // their halo position h themselves, in one branch.
    float laL = __shfl_up_sync(kFull, la[3], 1);
    float loL = __shfl_up_sync(kFull, lo[3], 1);
    float alL = __shfl_up_sync(kFull, al[3], 1);
    float laR = __shfl_down_sync(kFull, la[0], 1);
    float loR = __shfl_down_sync(kFull, lo[0], 1);
    float alR = __shfl_down_sync(kFull, al[0], 1);
    const bool edge = lane == 0 ? p0 > 0 && p0 <= last
                    : lane == 31 && p0 + 4 <= last;
    const int h = lane == 0 ? p0 - 1 : p0 + 4;
    float h_lat = 0.0f;
    if (edge) {
      h_lat = lat_r[h];
      const float h_lon = lon_r[h], h_alt = alt_r[h];
      if (lane == 0) {
        laL = h_lat; loL = h_lon; alL = h_alt;
      } else {
        laR = h_lat; loR = h_lon; alR = h_alt;
      }
    }
    // Window slot s holds position p0 - 1 + s.
    const float wla[6] = {laL, la[0], la[1], la[2], la[3], laR};
    const float wlo[6] = {loL, lo[0], lo[1], lo[2], lo[3], loR};
    const float wal[6] = {alL, al[0], al[1], al[2], al[3], alR};

    // Position p0 + k's neighbours are slots k (or k + 1 at p = 0) and
    // k + 2 (or k + 1 at p = last): selects, so the window stays in
    // registers.
    float vrate[4], gspeed[4], heading[4];
    Denom den[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int p = p0 + k;
      const bool has_l = p > 0, has_r = p < last;
      den[k] = denom_at(p, last, dt, rdt);
      vrate[k] = quot<POW2>((has_r ? wal[k + 2] : wal[k + 1])
                            - (has_l ? wal[k] : wal[k + 1]),
                            den[k].d, den[k].rd);
      const Motion mo = motion<POW2>(
          has_l ? wla[k] : wla[k + 1], has_r ? wla[k + 2] : wla[k + 1],
          has_l ? wlo[k] : wlo[k + 1], has_r ? wlo[k + 2] : wlo[k + 1],
          wla[k + 1], den[k]);
      gspeed[k] = sqrtf(mo.dn * mo.dn + mo.de * mo.de);
      heading[k] = atan2f(mo.de, mo.dn);
    }

    // Headings at p0 - 1 and p0 + 4, the same way: the edge lanes'
    // halo position h lies inside the track, with neighbours h - 1 and
    // min(h + 1, last).
    float hL = __shfl_up_sync(kFull, heading[3], 1);
    float hR = __shfl_down_sync(kFull, heading[0], 1);
    if (edge) {
      const int hr = h < last ? h + 1 : h;
      const Motion m = motion<POW2>(lat_r[h - 1], lat_r[hr], lon_r[h - 1],
                                    lon_r[hr], h_lat,
                                    denom_at(h, last, dt, rdt));
      const float hh = atan2f(m.de, m.dn);
      if (lane == 0) hL = hh; else hR = hh;
    }
    const float wh[6] = {hL, heading[0], heading[1], heading[2], heading[3],
                         hR};

    float turn[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int p = p0 + k;
      float dh = quot<POW2>((p < last ? wh[k + 2] : wh[k + 1])
                            - (p > 0 ? wh[k] : wh[k + 1]),
                            den[k].d, den[k].rd) * dt;
      dh = floor_mod(dh + kPi, kTwoPi) - kPi;
      turn[k] = dh * rdt;
      if (p > last) {
        vrate[k] = 0.0f; gspeed[k] = 0.0f; heading[k] = 0.0f; turn[k] = 0.0f;
      }
    }
    if (p0 < M) {
      store4<VEC>(o, p0, M, vrate);
      store4<VEC>(o + M, p0, M, gspeed);
      store4<VEC>(o + 2 * M, p0, M, heading);
      store4<VEC>(o + 3 * M, p0, M, turn);
    }
  }
}

template <bool VEC, bool POW2>
void launch(const float* v, const int* count, float* out, int B, int M,
            float dt, int rows, int per_row, int blocks,
            cudaStream_t stream) {
  dynamic_rates_kernel<VEC, POW2><<<blocks, rows * per_row, 0, stream>>>(
      v, count, out, B, M, dt, rows, per_row);
}

// Whether dt > 0 is a power of two whose reciprocal, and that of 2 dt,
// are normal floats too.
bool pow2(float dt) {
  int e = 0;
  return dt > 0.0f && frexpf(dt, &e) == 0.5f && e > -124 && e < 126;
}

}  // namespace

// rows, per_row (a multiple of 32) and blocks (ceil(B / rows)) come
// from kernels/dynamic_rates.py's plan(); vec selects the 16-byte path
// (M % 4 == 0, v and out 16-byte aligned).
extern "C" int dynamic_rates_f32(const float* v, const int* count,
                                 float* out, int B, int M, float dt,
                                 int rows, int per_row, int blocks, int vec,
                                 void* stream) {
  if (B == 0 || M == 0) return 0;
  if (rows < 1 || per_row < 32 || per_row % 32 || rows * per_row > kMaxThreads
      || (static_cast<long long>(B) + rows - 1) / rows != blocks) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const bool p2 = pow2(dt);
  auto go = vec ? (p2 ? launch<true, true> : launch<true, false>)
                : (p2 ? launch<false, true> : launch<false, false>);
  go(v, count, out, B, M, dt, rows, per_row, blocks,
     static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
