// Causal online-softmax GQA attention for head_dims above 256 in bf16 and
// f16 on Hopper's tensor cores: q (B,H,T,hd), k/v (B,KV,S,hd) in E ->
// (B,H,T,hd) in E, f32 inside, E = __nv_bfloat16 or __half (one template,
// two entry points).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py (_kernel,
// lines 44-93; pl.pallas_call at line 124) for bf16 and f16 inputs of
// every head_dim the sm90 kernel (csrc/flash_attention_sm90.cu) does not
// take; csrc/flash_attention_wide_f32.cu serves f32 inputs at the same
// widths.  The two are separate sources, as the <= 256 kernels are: here
// both products take their operands from shared memory as TMA lands them,
// while the f32 kernel splits every operand in its threads first (no TMA,
// no producer warp), so one template would share little but the softmax.
// wgmma's widest product is 256 columns, and an accumulator of more than
// 256 f32 columns a row does not fit in a warpgroup's registers.  No
// upper limit on head_dim.  The kernel takes hd % 8 == 0 (TMA's 16-byte
// row stride); the wrapper (kernels/flash_attention.py) zero-pads any
// other head_dim to the next multiple of 8, passes the true hd's scale,
// and copies a base that is not 16-byte aligned.
//
// Bound: operations.  Each (query, key) pair the mask keeps costs 2*hd
// flops for the score and 2*hd for the weighted sum (989 TFLOP/s in bf16
// and f16 on an H100 SXM).  This kernel recomputes the score once per
// output chunk and issues P.V twice (hi and lo, below): 2*hd*n_chunks +
// 4*hd a kept pair is its design floor.
//
// Design.  One CTA per (64-row q tile, output chunk, b, h), all on grid.x
// with every head's heaviest causal tile first and the chunks of one (q
// tile, b, h) next to each other, so that L2 serves their common q and k
// reads.  The output columns are cut into n_chunks = ceil(hd_out / cw)
// chunks of equal width cw, which the caller passes: its plan
// (kernels/flash_attention.py:wide_plan) gives a multiple of 32 (one
// 64-byte swizzle atom of v) from kMinCW to kMaxCW, and any other cw is
// refused.  Chunk c owns columns [c * cw, c * cw + cw).  One consumer
// warpgroup owns the 64 rows and a producer warp (one thread) issues
// every TMA load, 160 threads; at that count ptxas may give a thread 255
// registers, and the consumers hold O (cw / 2), S (32) and P's hi and lo
// (32).  Per key tile of 64 keys:
//  - S = q k^T by wgmma (m64n64k16, both operands K-major from shared
//    memory) over the whole padded head_dim, 64 columns a step: the
//    producer streams q's and k's slices of 64 columns together through
//    a ring of kStages stages, each guarded by full and empty mbarriers.
//    q is streamed, not resident: 64 rows of q take 128 KB at hd 1024 in
//    16 bits, and one streamed path serves every width;
//  - the online softmax in registers on the accumulator layout, as in
//    the sm90 kernel;
//  - O += P v[:, chunk] by wgmma (m64n<cw>k16) with P from registers and
//    the chunk's v slice MN-major in shared memory (transpose bit set),
//    through a ring of two v stages; TMA loads the slice at the chunk's
//    column offset.
// The scores are thus recomputed once per chunk.  Tiles strictly above
// the causal diagonal are never loaded.
//
// Shared memory: tiles are stored in 64-byte-swizzled atoms of 32 2-byte
// columns (TMA box 32 x 64, CU_TENSOR_MAP_SWIZZLE_64B; wgmma layout B64),
// as in the sm90 kernel.  A ring stage is 16 KB (q and k, 64 columns
// each), a v stage cw * 128 bytes: 4 * 16 + 2 * 32 = 128 KB at cw 256.
// TMA fills the columns past hd with zeros; an atom wholly past hd is not
// loaded (its products are skipped for q and k; for v, its output
// columns are not written).
//
// Numerics, as the sm90 kernel's: S from the raw q and k (bf16 x bf16 and
// f16 x f16 products exact in f32, f32 sums), scaled by hd^-0.5 after the
// product; the plain version's f32 softmax recurrence (masked scores
// -inf, a row that has seen no valid key keeps m = 0 for its
// exponentials, l sums the f32 p, acc rescaled by exp(m_prev - m_new));
// P split into hi = E(p') and lo = E(p' - hi), p' = p * 2^15 in f16 and p
// in bf16, both through P.V into the same f32 accumulator; acc / (l *
// 2^15 or l) rounded to E once; a row whose l = 0 is written as 0 (a NaN
// row stays NaN).  Builds with -fmad=true (held to a tolerance).
//
// Shapes: any T and S (query t sees keys <= t + S - T when causal),
// H % KV == 0, 16-byte-aligned bases.  q, k, v are 3-D tensor maps (hd,
// rows, heads), so rows past T or S read as zeros and are masked by
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

constexpr int kBQ = 64;           // query rows per CTA (one warpgroup)
constexpr int kBK = 64;           // keys per tile
constexpr int kAtom = 32;         // 2-byte columns per 64-byte swizzle row
constexpr int kSliceAtoms = 2;    // q and k atoms per ring stage
constexpr int kStages = 4;        // ring stages of q and k slices
constexpr int kVStages = 2;       // stages of v chunk tiles
constexpr int kThreads = 160;     // a consumer warpgroup + a producer warp
constexpr int kMaxCW = 256;       // widest output chunk (wgmma's widest N)
constexpr int kMinCW = kMaxCW / 2 + 32;   // narrowest the plan gives
constexpr int kAtomBytes = 64 * 64;   // one atom of 64 rows (q, k or v)
constexpr int kStageBytes = 2 * kSliceAtoms * kAtomBytes;   // q + k
constexpr float kLog2e = 1.4426950408889634f;
constexpr long long kHangCycles = 1LL << 34;   // ~10 s at 1.7 GHz
static_assert(kBQ == 64 && kBK == 64, "one box shape for q, k and v");

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
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving register reads and writes of `d` across
// an asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
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
  if constexpr (N == 96) wgmma_rs_n96<E>(d, a, db);
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

// kCW: the output chunk's width, a multiple of 32 (96 .. 256).
template <typename E, int kCW>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_wide_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            E* __restrict__ o, int H, int KV, int T, int S,
                            int hd, int hd_out, int n_chunks, int BH,
                            int causal, float scale) {
  constexpr int kVAtoms = kCW / kAtom;
  constexpr uint32_t kVBytes = kVAtoms * kAtomBytes;

  // Ring stage s: q's atoms, then k's (kSliceAtoms each); then the v
  // stages, then the barriers: per ring stage full and empty, per v stage
  // v full and v empty.
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ring = base;
  const uint32_t v_s = ring + kStages * kStageBytes;
  const uint32_t bars = v_s + kVStages * kVBytes;
  const uint32_t full = bars;
  const uint32_t empty = full + 8 * kStages;
  const uint32_t v_full = empty + 8 * kStages;
  const uint32_t v_empty = v_full + 8 * kVStages;

  const int per_tile = BH * n_chunks;
  const int q_tiles = static_cast<int>(gridDim.x) / per_tile;
  const int blk = static_cast<int>(blockIdx.x);
  const int qt = q_tiles - 1 - blk / per_tile;
  const int rem = blk - (q_tiles - 1 - qt) * per_tile;
  const int bh = rem / n_chunks;
  const int chunk = rem - bh * n_chunks;
  const int b = bh / H;
  const int kvh = (bh - b * H) / (H / KV);
  const int q0 = qt * kBQ;
  const int q_rows = min(kBQ, T - q0);
  const int offset = S - T;        // query t sees keys <= t + offset
  // Keys past the last row's diagonal are masked for every row here.
  const int k_end = causal ? min(S, q0 + q_rows + offset) : S;
  const int n_tiles = k_end > 0 ? (k_end + kBK - 1) / kBK : 0;
  const int n_atoms = (hd + kAtom - 1) / kAtom;
  const int n_slices = (n_atoms + kSliceAtoms - 1) / kSliceAtoms;
  const int c0 = chunk * kCW;
  const int v_atoms = min(kVAtoms, n_atoms - c0 / kAtom);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4);           // one arrival per consumer warp
    }
    for (int s = 0; s < kVStages; ++s) {
      mbar_init(v_full + 8 * s, 1);
      mbar_init(v_empty + 8 * s, 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producer warp: one thread issues every TMA load ----
    if (threadIdx.x == 128) {
      const int zkv = b * KV + kvh;
      int g = 0;                             // ring slices issued
      for (int i = 0; i < n_tiles; ++i) {
        for (int sl = 0; sl < n_slices; ++sl, ++g) {
          const int s = g % kStages;
          mbar_wait(empty + 8 * s, ((g / kStages) & 1) ^ 1);  // round 0 passes
          const int na = min(kSliceAtoms, n_atoms - kSliceAtoms * sl);
          const uint32_t q_dst = ring + s * kStageBytes;
          const uint32_t k_dst = q_dst + kSliceAtoms * kAtomBytes;
          mbar_expect_tx(full + 8 * s, 2 * na * kAtomBytes);
          for (int a = 0; a < na; ++a) {
            const int col = (kSliceAtoms * sl + a) * kAtom;
            tma_load(q_dst + a * kAtomBytes, &q_map, full + 8 * s, col, q0,
                     bh);
            tma_load(k_dst + a * kAtomBytes, &k_map, full + 8 * s, col,
                     i * kBK, zkv);
          }
        }
        const int vs = i % kVStages;
        mbar_wait(v_empty + 8 * vs, ((i / kVStages) & 1) ^ 1);
        mbar_expect_tx(v_full + 8 * vs, v_atoms * kAtomBytes);
        for (int a = 0; a < v_atoms; ++a)
          tma_load(v_s + vs * kVBytes + a * kAtomBytes, &v_map,
                   v_full + 8 * vs, c0 + a * kAtom, i * kBK, zkv);
      }
    }
  } else {
    // ---- the consumer warpgroup: 64 q rows, one output chunk ----
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    // Accumulator layout (m64nN f32): this thread holds rows row0 and
    // row0 + 8, columns 8 j + col0 + {0, 1}, as d[4 j + {0, 1}] (row0)
    // and d[4 j + {2, 3}] (row0 + 8).
    const int row0 = q0 + 16 * warp + (lane >> 2);
    const int col0 = 2 * (lane & 3);

    float acc[kCW / 2];
#pragma unroll
    for (int i = 0; i < kCW / 2; ++i) acc[i] = 0.0f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.0f, 0.0f};             // this thread's share of the row sum

    int g = 0;                               // ring slices consumed
    for (int i = 0; i < n_tiles; ++i) {
      const int k0 = i * kBK;
      // S = q k^T, 16 columns a wgmma, a ring stage (up to 64 columns) a
      // commit group; a stage is released once the next group's commit
      // and wait_group 1 say its products are done.
      float sc[kBK / 2];
      wgmma_fence();
      fence_regs<kBK / 2>(sc);
      for (int sl = 0; sl < n_slices; ++sl, ++g) {
        const int s = g % kStages;
        mbar_wait(full + 8 * s, (g / kStages) & 1);
        const int na = min(kSliceAtoms, n_atoms - kSliceAtoms * sl);
        const uint32_t q_src = ring + s * kStageBytes;
        const uint32_t k_src = q_src + kSliceAtoms * kAtomBytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 2 * kSliceAtoms; ++kk) {
          if (kk < 2 * na) {
            const uint32_t off = (kk >> 1) * kAtomBytes + (kk & 1) * 32;
            wgmma_ss_n64<E>(sc, smem_desc(q_src + off, 16, 512),
                            smem_desc(k_src + off, 16, 512), sl > 0 || kk > 0);
          }
        }
        wgmma_commit();
        fence_regs<kBK / 2>(sc);
        if (sl > 0) {
          wgmma_wait<1>();
          fence_regs<kBK / 2>(sc);
          __syncwarp();
          if (lane == 0) mbar_arrive(empty + 8 * ((g - 1) % kStages));
        }
      }
      wgmma_wait<0>();
      fence_regs<kBK / 2>(sc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * ((g - 1) % kStages));

      // Scale, then mask where this tile crosses S or the diagonal.
      const bool edge = k0 + kBK > S || (causal && k0 + kBK - 1 > q0 + offset);
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
      for (int j = 0; j < kCW / 8; ++j) {
        acc[4 * j + 0] *= corr[0];
        acc[4 * j + 1] *= corr[0];
        acc[4 * j + 2] *= corr[1];
        acc[4 * j + 3] *= corr[1];
      }
      // P as the A operand (registers) of m64nNk16: step kk takes
      // d[8 kk .. 8 kk + 7] as four pairs.  hi = E(p'), lo = E(p' - hi)
      // for p' = p * kPScale.
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
      // O += P v[:, chunk], for hi and then lo.
      const int vs = i % kVStages;
      mbar_wait(v_full + 8 * vs, (i / kVStages) & 1);
      const uint32_t v_tile = v_s + vs * kVBytes;
      wgmma_fence();
      fence_regs<kCW / 2>(acc);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_rs<E, kCW>(acc, hi[kk],
                         smem_desc(v_tile + kk * 16 * 64, kAtomBytes, 512));
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_rs<E, kCW>(acc, lo[kk],
                         smem_desc(v_tile + kk * 16 * 64, kAtomBytes, 512));
      wgmma_commit();
      fence_regs<kCW / 2>(acc);
      wgmma_wait<0>();
      fence_regs<kCW / 2>(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(v_empty + 8 * vs);
    }

    // Epilogue: the row sum over its 4 lanes, acc / (l * kPScale), one
    // rounding to E, this chunk's columns below hd_out.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = row0 + 8 * r;
      if (t >= T) continue;
      E* out = o + (static_cast<long long>(bh) * T + t) * hd_out + c0;
      const bool any = l[r] != 0.0f;      // a NaN row stays NaN
      const float den = l[r] * Elem<E>::kPScale;   // exact
#pragma unroll
      for (int j = 0; j < kCW / 8; ++j) {
        const int c = 8 * j + col0;
        if (c0 + c < hd_out) {
          const float a0 = any ? acc[4 * j + 2 * r] / den : 0.0f;
          const float a1 = any ? acc[4 * j + 2 * r + 1] / den : 0.0f;
          if (hd_out % 2 == 0) {          // c + 1 in the row, 4-byte aligned
            *reinterpret_cast<typename Elem<E>::Pair*>(out + c) =
                Elem<E>::pack(a0, a1);
          } else {
            out[c] = Elem<E>::one(a0);
            if (c0 + c + 1 < hd_out) out[c + 1] = Elem<E>::one(a1);
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

// (hd, rows, heads) of 2-byte `type`, row stride hd; boxes of kAtom x 64 x
// 1 (q, k and v alike: kBQ = kBK = 64).
bool make_map(EncodeTiled encode, CUtensorMap* map, CUtensorMapDataType type,
              const void* ptr, int hd, int rows, int heads) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(hd) * 2,
                                 static_cast<cuuint64_t>(hd) * rows * 2};
  const cuuint32_t box[3] = {kAtom, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, type, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename E, int kCW>
int launch(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
           E* o, int B, int H, int KV, int T, int S, int hd, int hd_out,
           int causal, float scale, cudaStream_t stream) {
  const int n_chunks = (hd_out + kCW - 1) / kCW;
  const long long q_tiles = (T + kBQ - 1) / kBQ;
  const long long blocks = q_tiles * B * H * n_chunks;
  if (blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const size_t smem = 1024 + static_cast<size_t>(kStages) * kStageBytes +
                      static_cast<size_t>(kVStages) * (kCW / kAtom) *
                          kAtomBytes +
                      8 * 2 * (kStages + kVStages);
  auto kernel = flash_attention_wide_kernel<E, kCW>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      qm, km, vm, o, H, KV, T, S, hd, hd_out, n_chunks, B * H, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation of chunk width cw: kMinCW .. kMaxCW in steps of 32.
template <typename E, int kCW>
int dispatch(int cw, const CUtensorMap& qm, const CUtensorMap& km,
             const CUtensorMap& vm, E* o, int B, int H, int KV, int T, int S,
             int hd, int hd_out, int causal, float scale, cudaStream_t st) {
  if (cw == kCW)
    return launch<E, kCW>(qm, km, vm, o, B, H, KV, T, S, hd, hd_out, causal,
                          scale, st);
  if constexpr (kCW < kMaxCW) {
    return dispatch<E, kCW + 32>(cw, qm, km, vm, o, B, H, KV, T, S, hd,
                                 hd_out, causal, scale, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q, k, v have rows of hd (a multiple of 8, padded with zero columns
// where the head_dim is not); o has rows of hd_out <= hd, the head_dim,
// and gets the first hd_out columns.  cw is the chunk width of the
// caller's plan (wide_plan): a multiple of 32 from kMinCW to kMaxCW.
template <typename E>
int run(const void* q, const void* k, const void* v, void* o, int B, int H,
        int KV, int T, int S, int hd, int hd_out, int cw, int causal,
        float scale, void* stream) {
  if (hd < 8 || hd % 8 != 0 || hd_out < 1 || hd_out > hd || cw < kMinCW ||
      cw > kMaxCW || cw % 32 != 0 || KV < 1 || H % KV != 0 ||
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
  const CUtensorMapDataType type = Elem<E>::kMap;
  CUtensorMap qm, km, vm;
  if (!make_map(encode, &qm, type, q, hd, T, B * H) ||
      !make_map(encode, &km, type, k, hd, S, B * KV) ||
      !make_map(encode, &vm, type, v, hd, S, B * KV)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch<E, kMinCW>(cw, qm, km, vm, static_cast<E*>(o), B, H, KV,
                             T, S, hd, hd_out, causal, scale, st);
}

}  // namespace

extern "C" int flash_attention_wide_bf16(const void* q, const void* k,
                                         const void* v, void* o, int B, int H,
                                         int KV, int T, int S, int hd,
                                         int hd_out, int cw, int causal,
                                         float scale, void* stream) {
  return run<__nv_bfloat16>(q, k, v, o, B, H, KV, T, S, hd, hd_out, cw,
                            causal, scale, stream);
}

extern "C" int flash_attention_wide_f16(const void* q, const void* k,
                                        const void* v, void* o, int B, int H,
                                        int KV, int T, int S, int hd,
                                        int hd_out, int cw, int causal,
                                        float scale, void* stream) {
  return run<__half>(q, k, v, o, B, H, KV, T, S, hd, hd_out, cw, causal,
                     scale, stream);
}
