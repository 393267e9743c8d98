// Causal online-softmax GQA attention for bf16 and f16 on Hopper's tensor
// cores: q (B,H,T,hd), k/v (B,KV,S,hd) in E -> (B,H,T,hd) in E, f32
// inside, E = __nv_bfloat16 or __half (one template, two entry points).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py (_kernel,
// lines 44-93; pl.pallas_call at line 124) for bf16 and f16 inputs of
// every head_dim from 1 to 256; csrc/flash_attention_f32_sm90.cu serves
// f32 inputs (as split TF32), csrc/flash_attention_wide.cu head_dims above
// 256.  The kernel takes hd % 8 == 0 (TMA's 16-byte
// row stride); the wrapper (kernels/flash_attention.py) zero-pads any
// other head_dim to the next multiple of 8 and passes the true hd's
// scale, so the extra columns add exact zeros to every score.
//
// Bound: operations.  Each (query, key) pair the mask keeps costs 2*hd
// flops for the score and 2*hd for the weighted sum (4*hd at 989 TFLOP/s
// in bf16 and in f16 on an H100 SXM).  This kernel issues 2*hd + 4*hd
// (see P.V below), so its own floor is 1.5x the function's.
//
// Design.  One CTA per (b, h, 128-row q tile), all on grid.x with every
// head's heaviest causal tile first (neighbouring CTAs then share a kv
// head in L2).  Two consumer warpgroups and a producer warp, 288 threads:
//  - the producer (warp 8; one thread) loads the q tile once by TMA and
//    streams key tiles of k and v through a ring in shared memory, each
//    stage guarded by k-full, v-full and empty mbarriers: 64 keys in 3
//    stages up to hd 192, 32 keys in 4 stages above (key_tile,
//    ring_stages);
//  - two consumer warpgroups (warps 0-7) own 64 q rows each.  Per
//    key tile: S = q k^T by wgmma from shared memory (m64n64k16 or
//    m64n32k16, both operands K-major, f32 accumulators), then the
//    softmax in registers on the accumulator layout, then O += P v by
//    wgmma with P from registers and v MN-major in shared memory
//    (transpose bit set).
// Registers bound the widest head_dims: O alone takes hd / 2 f32
// registers a consumer thread (128 at 256), S kBK / 2 and P's hi and lo
// kBK / 2 more, and ptxas gives the consumers 168 registers a thread
// (ptxas -v), at 288 threads as it did at 384 with setmaxnreg handing
// them 240 at run time (so the producer is one warp, and no setmaxnreg
// is issued).  The 32-key tile above hd 192 halves S and P (32
// registers in place of 64); even so hd 256 spills, and hd 192 (PERF.md
// records the bytes and times).  A block of 256 threads, thread 0 issuing
// the loads between its own products, gets 255 registers and spills
// nothing, but ties each warpgroup to the other's pace: on the H100 it
// ran 1-30 % slower at hd 128 to 200, and 7-10 % faster at hd 256 and
// 64 (PERF.md); one block is kept for every width.  The ring of four
// stages of 32 keys keeps 128 keys in flight within the 227 KB of shared
// memory a block may use.
// Tiles strictly above the causal diagonal are never loaded; a consumer
// whose 64 rows see none of a loaded tile skips its products.
//
// Shared memory: tiles are stored in 64-byte-swizzled atoms of 32 2-byte
// columns (TMA box 32 x rows, CU_TENSOR_MAP_SWIZZLE_64B; wgmma layout
// B64).  hd = 160 is 5 atoms, so nothing is wasted there (a 128-byte
// swizzle would need 64-column atoms and 20 % zero padding at 160); other
// head_dims round up to a multiple of 32 (24 -> 32, 40 -> 64, 200 ->
// 224), TMA fills the columns past hd with zeros, and the extra output
// columns are not written.  At hd 192: q 48 KB + 3 stages x (k + v) 48 KB
// = 192 KB; at hd 256: q 64 KB + 4 stages x (k + v) 32 KB = 192 KB (three
// stages of 64 keys would need 256 KB).
//
// Numerics.  bf16 x bf16 and f16 x f16 products are exact in f32, so S
// from the raw q and k with f32 accumulation, scaled by hd^-0.5 afterwards,
// differs from the TPU kernel's (q * scale) k^T by f32 rounding alone.
// The softmax is the plain version's f32 recurrence: masked scores are
// -inf, a row that has seen no valid key keeps m = 0 for its
// exponentials, l sums the f32 p, acc is rescaled by exp(m_prev - m_new),
// and a row whose l = 0 is written as 0 (a NaN row stays NaN).  P itself
// is not rounded once to bf16 (that breaks the gate of one bf16 rounding
// of the f32 result,
// rtol 2^-8, for about a quarter of the outputs at T = 2048): it is split
// into hi = bf16(p) and lo = bf16(p - hi), and both go through the P.V
// wgmma into the same f32 accumulator.  The epilogue divides by l and
// rounds to bf16 once.  In f16 the split is the same on p * 2^15 (exact):
// f16 has three more significand bits than bf16 but its normal range ends
// at 2^-14, where lo = p - hi falls for p below about 2^-3 and hi itself
// below 2^-14; scaled, hi stays normal down to p = 2^-29 and lo down to
// p = 2^-18, and p * 2^15 <= 2^15 stays below f16's largest value.  The
// epilogue divides by l * 2^15 (exact) and rounds to f16 once
// (tests/test_torch_flash_dtypes.py emulates both splits and a single
// rounding of p).  Builds with -fmad=true (held to a tolerance).
//
// Shapes: any T and S (query t sees keys <= t + S - T when causal),
// H % KV == 0, 16-byte-aligned bases.  q, k, v are 3-D tensor maps
// (hd, rows, heads), so rows past T or S read as zeros and are masked by
// length.  A barrier that never completes traps instead of hanging.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

// What differs between the two element types.
template <typename E>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  using Pair = __nv_bfloat162;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static constexpr float kPScale = 1.0f;   // p is split as it is
  static __device__ __forceinline__ Pair pack(float a, float b) {
    return __floats2bfloat162_rn(a, b);
  }
  static __device__ __forceinline__ float2 unpack(Pair h) {
    return __bfloat1622float2(h);
  }
  static __device__ __forceinline__ __nv_bfloat16 one(float a) {
    return __float2bfloat16_rn(a);
  }
};

template <>
struct Elem<__half> {
  using Pair = __half2;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  static constexpr float kPScale = 32768.0f;   // 2^15: see Numerics
  static __device__ __forceinline__ Pair pack(float a, float b) {
    return __floats2half2_rn(a, b);
  }
  static __device__ __forceinline__ float2 unpack(Pair h) {
    return __half22float2(h);
  }
  static __device__ __forceinline__ __half one(float a) {
    return __float2half_rn(a);
  }
};

template <typename E>
constexpr bool kIsF16 = std::is_same_v<E, __half>;

constexpr int kBQ = 128;          // query rows per CTA (2 x 64)
constexpr int kAtom = 32;         // 2-byte columns per 64-byte swizzle row
constexpr int kThreads = 288;     // two consumer warpgroups + producer warp
constexpr int kMaxHeadDim = 256;

// Keys per k/v tile and ring depth for a padded head_dim (see Design).
__host__ __device__ constexpr int key_tile(int hdp) {
  return hdp <= 192 ? 64 : 32;
}
__host__ __device__ constexpr int ring_stages(int hdp) {
  return hdp <= 192 ? 3 : 4;
}
constexpr float kLog2e = 1.4426950408889634f;
constexpr long long kHangCycles = 1LL << 34;   // ~10 s at 1.7 GHz

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > kHangCycles) __trap();
  }
}

// TMA: the box at (c0, c1, c2) of a 3-D tensor map into shared memory,
// completing `bar`'s transaction bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor for a 64-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout B64.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(2) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving register reads and writes of `d` across
// an asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (m64 x n32, f32) {+}= A (smem, K-major) * B (smem, K-major)^T.
template <typename E>
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t da, uint64_t db,
                                             int scale_d) {
#define FA_WGMMA(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, " \
      "%16, %17, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
      : "l"(da), "l"(db), "r"(scale_d))
  if constexpr (kIsF16<E>) FA_WGMMA("f16"); else FA_WGMMA("bf16");
#undef FA_WGMMA
}


// d (m64 x n64, f32) {+}= A (smem, K-major) * B (smem, K-major)^T.
template <typename E>
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db,
                                             int scale_d) {
#define FA_WGMMA(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, " \
      "%32, %33, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "l"(da), "l"(db), "r"(scale_d))
  if constexpr (kIsF16<E>) FA_WGMMA("f16"); else FA_WGMMA("bf16");
#undef FA_WGMMA
}

template <typename E, int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (N == 32) wgmma_ss_n32<E>(d, da, db, scale_d);
  else wgmma_ss_n64<E>(d, da, db, scale_d);
}

// d (m64 x n32, f32) += A (registers, pairs of E) * B (smem, MN-major).
template <typename E>
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                             uint64_t db) {
#define FA_WGMMA(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, " \
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
  if constexpr (kIsF16<E>) FA_WGMMA("f16"); else FA_WGMMA("bf16");
#undef FA_WGMMA
}

// d (m64 x n64, f32) += A (registers, pairs of E) * B (smem, MN-major).
template <typename E>
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db) {
#define FA_WGMMA(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, " \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
  if constexpr (kIsF16<E>) FA_WGMMA("f16"); else FA_WGMMA("bf16");
#undef FA_WGMMA
}

// d (m64 x n96, f32) += A (registers, pairs of E) * B (smem, MN-major).
template <typename E>
__device__ __forceinline__ void wgmma_rs_n96(float* d, const uint32_t* a,
                                             uint64_t db) {
#define FA_WGMMA(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n96k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, " \
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
  if constexpr (kIsF16<E>) FA_WGMMA("f16"); else FA_WGMMA("bf16");
#undef FA_WGMMA
}

// d (m64 x n128, f32) += A (registers, pairs of E) * B (smem, MN-major).
template <typename E>
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                             uint64_t db) {
#define FA_WGMMA(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, " \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
  if constexpr (kIsF16<E>) FA_WGMMA("f16"); else FA_WGMMA("bf16");
#undef FA_WGMMA
}

// d (m64 x n160, f32) += A (registers, pairs of E) * B (smem, MN-major).
template <typename E>
__device__ __forceinline__ void wgmma_rs_n160(float* d, const uint32_t* a,
                                             uint64_t db) {
#define FA_WGMMA(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n160k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, " \
      "{%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
  if constexpr (kIsF16<E>) FA_WGMMA("f16"); else FA_WGMMA("bf16");
#undef FA_WGMMA
}

// d (m64 x n192, f32) += A (registers, pairs of E) * B (smem, MN-major).
template <typename E>
__device__ __forceinline__ void wgmma_rs_n192(float* d, const uint32_t* a,
                                             uint64_t db) {
#define FA_WGMMA(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n192k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, " \
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
  if constexpr (kIsF16<E>) FA_WGMMA("f16"); else FA_WGMMA("bf16");
#undef FA_WGMMA
}

// d (m64 x n224, f32) += A (registers, pairs of E) * B (smem, MN-major).
template <typename E>
__device__ __forceinline__ void wgmma_rs_n224(float* d, const uint32_t* a,
                                             uint64_t db) {
#define FA_WGMMA(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %117, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n224k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111}, " \
      "{%112, %113, %114, %115}, %116, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
  if constexpr (kIsF16<E>) FA_WGMMA("f16"); else FA_WGMMA("bf16");
#undef FA_WGMMA
}

// d (m64 x n256, f32) += A (registers, pairs of E) * B (smem, MN-major).
template <typename E>
__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t* a,
                                             uint64_t db) {
#define FA_WGMMA(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, " \
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
  if constexpr (kIsF16<E>) FA_WGMMA("f16"); else FA_WGMMA("bf16");
#undef FA_WGMMA
}

template <typename E, int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (N == 32) wgmma_rs_n32<E>(d, a, db);
  else if constexpr (N == 64) wgmma_rs_n64<E>(d, a, db);
  else if constexpr (N == 96) wgmma_rs_n96<E>(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128<E>(d, a, db);
  else if constexpr (N == 160) wgmma_rs_n160<E>(d, a, db);
  else if constexpr (N == 192) wgmma_rs_n192<E>(d, a, db);
  else if constexpr (N == 224) wgmma_rs_n224<E>(d, a, db);
  else wgmma_rs_n256<E>(d, a, db);
}

template <typename E>
__device__ __forceinline__ uint32_t pack2(float lo_col, float hi_col) {
  typename Elem<E>::Pair h = Elem<E>::pack(lo_col, hi_col);
  return *reinterpret_cast<uint32_t*>(&h);
}

// kHdp: head_dim rounded up to a multiple of kAtom (32 .. 256).
template <typename E, int kHdp>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            E* __restrict__ o, int H, int KV,
                            int T, int S, int hd_out, int BH, int causal,
                            float scale) {
  constexpr int kBK = key_tile(kHdp);
  constexpr int kStages = ring_stages(kHdp);
  constexpr int kChunks = kHdp / kAtom;
  constexpr uint32_t kQBytes = kBQ * kHdp * 2;
  constexpr uint32_t kTileBytes = kBK * kHdp * 2;
  constexpr uint32_t kQChunk = kBQ * kAtom * 2;   // one atom column of q
  constexpr uint32_t kKChunk = kBK * kAtom * 2;   // ... of a k or v tile

  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = q_s + kQBytes;
  const uint32_t v_s = k_s + kStages * kTileBytes;
  const uint32_t bars = v_s + kStages * kTileBytes;
  // bars: q full, then per stage k full, v full, empty.
  const uint32_t q_full = bars;
  const uint32_t k_full = bars + 8;
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t empty = v_full + 8 * kStages;

  const int q_tiles = gridDim.x / BH;
  const int qt = q_tiles - 1 - static_cast<int>(blockIdx.x) / BH;
  const int bh = static_cast<int>(blockIdx.x) - (q_tiles - 1 - qt) * BH;
  const int b = bh / H;
  const int kvh = (bh - b * H) / (H / KV);
  const int q0 = qt * kBQ;
  const int q_rows = min(kBQ, T - q0);
  const int offset = S - T;        // query t sees keys <= t + offset
  // Keys past the last row's diagonal are masked for every row here.
  const int k_end = causal ? min(S, q0 + q_rows + offset) : S;
  const int n_tiles = k_end > 0 ? (k_end + kBK - 1) / kBK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);           // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer warp: one thread issues every TMA load ----
    if (threadIdx.x == 256) {
      const int zkv = b * KV + kvh;
      mbar_expect_tx(q_full, kQBytes);
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
        tma_load(q_s + c * kQChunk, &q_map, q_full, c * kAtom, q0, bh);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const uint32_t parity = (i / kStages) & 1;
        mbar_wait(empty + 8 * s, parity ^ 1);  // round 0 passes at once
        mbar_expect_tx(k_full + 8 * s, kTileBytes);
#pragma unroll
        for (int c = 0; c < kChunks; ++c)
          tma_load(k_s + s * kTileBytes + c * kKChunk, &k_map, k_full + 8 * s,
                   c * kAtom, i * kBK, zkv);
        mbar_expect_tx(v_full + 8 * s, kTileBytes);
#pragma unroll
        for (int c = 0; c < kChunks; ++c)
          tma_load(v_s + s * kTileBytes + c * kKChunk, &v_map, v_full + 8 * s,
                   c * kAtom, i * kBK, zkv);
      }
    }
  } else {
    // ---- two consumer warpgroups, 64 q rows each ----
    const int ct = threadIdx.x;
    const int cw = ct >> 7;                  // consumer warpgroup
    const int warp = (ct >> 5) & 3;
    const int lane = ct & 31;
    const int wg_first = q0 + 64 * cw;       // this warpgroup's first row
    // Accumulator layout (m64nN f32): this thread holds rows row0 and
    // row0 + 8, columns 8 j + col0 + {0, 1}, as d[4 j + {0, 1}] (row0)
    // and d[4 j + {2, 3}] (row0 + 8).
    const int row0 = wg_first + 16 * warp + (lane >> 2);
    const int col0 = 2 * (lane & 3);
    const uint32_t q_wg = q_s + cw * 64 * kAtom * 2;

    float acc[kHdp / 2];
#pragma unroll
    for (int i = 0; i < kHdp / 2; ++i) acc[i] = 0.0f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.0f, 0.0f};             // this thread's share of the row sum

    mbar_wait(q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const uint32_t parity = (i / kStages) & 1;
      const int k0 = i * kBK;
      mbar_wait(k_full + 8 * s, parity);
      if (!causal || k0 <= wg_first + 63 + offset) {
        // S = q k^T over kHdp / 16 steps of 16 columns.
        float sc[kBK / 2];
        const uint32_t k_tile = k_s + s * kTileBytes;
        wgmma_fence();
        fence_regs<kBK / 2>(sc);
#pragma unroll
        for (int kk = 0; kk < kHdp / 16; ++kk) {
          const uint32_t col = (kk & 1) * 32;   // bytes into the atom row
          wgmma_ss<E, kBK>(sc,
                          smem_desc(q_wg + (kk >> 1) * kQChunk + col, 16, 512),
                          smem_desc(k_tile + (kk >> 1) * kKChunk + col, 16,
                                    512),
                          kk > 0);
        }
        wgmma_commit();
        fence_regs<kBK / 2>(sc);
        wgmma_wait_all();
        fence_regs<kBK / 2>(sc);

        // Scale, then mask where this tile crosses S or the diagonal.
        const bool edge = k0 + kBK > S ||
                          (causal && k0 + kBK - 1 > wg_first + offset);
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = sc[4 * j + e] * scale;
            if (edge) {
              const int c = k0 + 8 * j + col0 + (e & 1);
              const int t = row0 + 8 * (e >> 1);
              x = (c < S && (!causal || c <= t + offset)) ? x : -INFINITY;
            }
            sc[4 * j + e] = x;
          }
        }
        // Online softmax in f32; a row is spread over 4 lanes.
        float corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < kBK / 8; ++j)
            mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[r], mx);
          const float m_use = m_new == -INFINITY ? 0.0f : m_new;
          corr[r] = exp2f((m[r] - m_use) * kLog2e);
          const float mb = m_use * kLog2e;
          float sum = 0.0f;
#pragma unroll
          for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float p = exp2f(fmaf(sc[4 * j + 2 * r + e], kLog2e, -mb));
              sc[4 * j + 2 * r + e] = p;
              sum += p;
            }
          }
          l[r] = l[r] * corr[r] + sum;
          m[r] = m_new;
        }
#pragma unroll
        for (int j = 0; j < kHdp / 8; ++j) {
          acc[4 * j + 0] *= corr[0];
          acc[4 * j + 1] *= corr[0];
          acc[4 * j + 2] *= corr[1];
          acc[4 * j + 3] *= corr[1];
        }
        // P as the A operand (registers) of m64nNk16: step kk takes
        // d[8 kk .. 8 kk + 7] as four pairs.  hi = E(p'), lo = E(p' - hi)
        // for p' = p * kPScale: hi + lo carries p to about 2^-17 in bf16
        // and 2^-22 in f16.
        uint32_t hi[kBK / 16][4], lo[kBK / 16][4];
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const float p0 = sc[8 * kk + 2 * x] * Elem<E>::kPScale;
            const float p1 = sc[8 * kk + 2 * x + 1] * Elem<E>::kPScale;
            const typename Elem<E>::Pair h = Elem<E>::pack(p0, p1);
            const float2 hf = Elem<E>::unpack(h);
            hi[kk][x] = *reinterpret_cast<const uint32_t*>(&h);
            lo[kk][x] = pack2<E>(p0 - hf.x, p1 - hf.y);
          }
        }
        // O += P v, for hi and then lo.
        mbar_wait(v_full + 8 * s, parity);
        const uint32_t v_tile = v_s + s * kTileBytes;
        wgmma_fence();
        fence_regs<kHdp / 2>(acc);
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_rs<E, kHdp>(acc, hi[kk],
                            smem_desc(v_tile + kk * 16 * kAtom * 2, kKChunk, 512));
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_rs<E, kHdp>(acc, lo[kk],
                            smem_desc(v_tile + kk * 16 * kAtom * 2, kKChunk, 512));
        wgmma_commit();
        fence_regs<kHdp / 2>(acc);
        wgmma_wait_all();
        fence_regs<kHdp / 2>(acc);
      } else {
        // Every key of this tile is above this warpgroup's diagonal.
        mbar_wait(v_full + 8 * s, parity);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }

    // Epilogue: the row sum over its 4 lanes, acc / (l * kPScale), one
    // rounding to E.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = row0 + 8 * r;
      if (t >= T) continue;
      E* out = o + (static_cast<long long>(bh) * T + t) * hd_out;
      const bool any = l[r] != 0.0f;      // a NaN row stays NaN
      const float den = l[r] * Elem<E>::kPScale;   // exact
#pragma unroll
      for (int j = 0; j < kHdp / 8; ++j) {
        const int c = 8 * j + col0;
        if (c < hd_out) {
          const float a0 = any ? acc[4 * j + 2 * r] / den : 0.0f;
          const float a1 = any ? acc[4 * j + 2 * r + 1] / den : 0.0f;
          if (hd_out % 2 == 0) {          // c + 1 < hd_out, 4-byte aligned
            *reinterpret_cast<typename Elem<E>::Pair*>(out + c) =
                Elem<E>::pack(a0, a1);
          } else {
            out[c] = Elem<E>::one(a0);
            if (c + 1 < hd_out) out[c + 1] = Elem<E>::one(a1);
          }
        }
      }
    }
  }
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, not in the runtime: fetched
// through cudaGetDriverEntryPoint, so the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// (hd, rows, heads) of 2-byte `type`, row stride hd; boxes of kAtom x
// box_rows x 1.
bool make_map(EncodeTiled encode, CUtensorMap* map, CUtensorMapDataType type,
              const void* ptr, int hd, int rows, int heads, int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(hd) * 2,
                                 static_cast<cuuint64_t>(hd) * rows * 2};
  const cuuint32_t box[3] = {kAtom, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, type, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename E, int kHdp>
int launch(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
           E* o, int B, int H, int KV, int T, int S,
           int hd_out, int causal, float scale, cudaStream_t stream) {
  const long long q_tiles = (T + kBQ - 1) / kBQ;
  const long long blocks = q_tiles * B * H;
  if (blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  constexpr int kStages = ring_stages(kHdp);
  const size_t smem = 1024 + static_cast<size_t>(kBQ) * kHdp * 2 +
                      2 * kStages * static_cast<size_t>(key_tile(kHdp)) *
                          kHdp * 2 +
                      8 * (1 + 3 * kStages);
  auto kernel = flash_attention_sm90_kernel<E, kHdp>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      qm, km, vm, o, H, KV, T, S, hd_out, B * H, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// q, k, v have rows of hd (a multiple of 8, padded with zero columns
// where the head_dim is not); o has rows of hd_out <= hd, the head_dim,
// and gets the first hd_out columns.
template <typename E>
int run(const void* q, const void* k, const void* v, void* o, int B, int H,
        int KV, int T, int S, int hd, int hd_out, int causal, float scale,
        void* stream) {
  if (hd < 8 || hd > kMaxHeadDim || hd % 8 != 0 || hd_out < 1 ||
      hd_out > hd || KV < 1 || H % KV != 0 ||
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) &
       15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || H == 0 || T == 0) return 0;
  if (S == 0) {                   // no key at all: every row is 0
    cudaMemsetAsync(o, 0, static_cast<size_t>(B) * H * T * hd_out * 2, st);
    return static_cast<int>(cudaGetLastError());
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int hdp = (hd + kAtom - 1) / kAtom * kAtom;
  const CUtensorMapDataType type = Elem<E>::kMap;
  CUtensorMap qm, km, vm;
  if (!make_map(encode, &qm, type, q, hd, T, B * H, kBQ) ||
      !make_map(encode, &km, type, k, hd, S, B * KV, key_tile(hdp)) ||
      !make_map(encode, &vm, type, v, hd, S, B * KV, key_tile(hdp))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* out = static_cast<E*>(o);
  switch (hdp) {
    case 32: return launch<E, 32>(qm, km, vm, out, B, H, KV, T, S, hd_out, causal, scale, st);
    case 64: return launch<E, 64>(qm, km, vm, out, B, H, KV, T, S, hd_out, causal, scale, st);
    case 96: return launch<E, 96>(qm, km, vm, out, B, H, KV, T, S, hd_out, causal, scale, st);
    case 128: return launch<E, 128>(qm, km, vm, out, B, H, KV, T, S, hd_out, causal, scale, st);
    case 160: return launch<E, 160>(qm, km, vm, out, B, H, KV, T, S, hd_out, causal, scale, st);
    case 192: return launch<E, 192>(qm, km, vm, out, B, H, KV, T, S, hd_out, causal, scale, st);
    case 224: return launch<E, 224>(qm, km, vm, out, B, H, KV, T, S, hd_out, causal, scale, st);
    default: return launch<E, 256>(qm, km, vm, out, B, H, KV, T, S, hd_out, causal, scale, st);
  }
}

}  // namespace

extern "C" int flash_attention_bf16_sm90(const void* q, const void* k,
                                         const void* v, void* o, int B, int H,
                                         int KV, int T, int S, int hd,
                                         int hd_out, int causal, float scale,
                                         void* stream) {
  return run<__nv_bfloat16>(q, k, v, o, B, H, KV, T, S, hd, hd_out, causal,
                            scale, stream);
}

extern "C" int flash_attention_f16_sm90(const void* q, const void* k,
                                        const void* v, void* o, int B, int H,
                                        int KV, int T, int S, int hd,
                                        int hd_out, int causal, float scale,
                                        void* stream) {
  return run<__half>(q, k, v, o, B, H, KV, T, S, hd, hd_out, causal, scale,
                     stream);
}
