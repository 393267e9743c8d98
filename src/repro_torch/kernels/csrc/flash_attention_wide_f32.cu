// Causal online-softmax GQA attention for head_dims above 256 in f32 on
// Hopper's tensor cores: q (B,H,T,hd), k/v (B,KV,S,hd) f32 -> (B,H,T,hd)
// f32.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py (_kernel,
// lines 44-93; pl.pallas_call at line 124) for f32 inputs of every
// head_dim the f32 kernel (csrc/flash_attention_f32_sm90.cu) does not
// take; csrc/flash_attention_wide.cu serves bf16 and f16 at the same
// widths (why two sources: see its header).  No upper limit on head_dim.
// The kernel takes hd % 4 == 0 (cp.async's 16-byte rows); the wrapper
// (kernels/flash_attention.py) zero-pads any other head_dim to the next
// multiple of 4, passes the true hd's scale, and copies a base that is
// not 16-byte aligned.
//
// Bound: operations.  Each (query, key) pair the mask keeps costs 2*hd
// flops for the score and 2*hd for the weighted sum; an f32-accurate
// product costs three TF32 products (495 TFLOP/s dense TF32 on an H100
// SXM), so 3 * 4*hd a kept pair is the function's bound.  This kernel
// recomputes the score once per output chunk: 3 * (2*hd*n_chunks +
// 2*hd) a kept pair is its design floor.
//
// Numerics: the split-TF32 product of the f32 kernel.  Each f32 operand x
// of S = q k^T and of O += P v splits exactly into hi, x rounded to
// nearest TF32, and lo = x - hi (split() below), which the tensor cores
// read truncated to TF32; a product is lo.hi + hi.lo + hi.hi into f32
// accumulators (hi.hi for S in one, the other two in another).  S is
// scaled by hd^-0.5 after the product.  The softmax is the plain
// version's f32 recurrence: masked scores are -inf, a row that has seen
// no valid key keeps m = 0 for its exponentials, l sums the f32 p, acc is
// rescaled by exp(m_prev - m_new); the epilogue divides by l once, and a
// row whose l = 0 is written as 0 (a NaN row stays NaN).  Builds with
// -fmad=true (held to a tolerance).
//
// Design.  One CTA per (128-row q tile, output chunk, b, h), all on
// grid.x with every head's heaviest causal tile first and the chunks of
// one (q tile, b, h) next to each other; the chunk width cw is the
// caller's, as for the bf16 and f16 kernel (wide_plan).  Two warpgroups
// own 64 q rows each, 256 threads, no producer warp: every operand passes
// through the threads to be split, so they also issue its loads
// (cp.async), as the f32 kernel does.  Both products run on wgmma TF32 (m64nNk8), B K-major from shared
// memory, A from registers.  Per key tile of kBK = 32 keys:
//  - S = q k^T over the whole padded head_dim, 32 columns a step: raw q
//    (128 x 32) and k (32 x 32) slices land by cp.async in a ring of
//    kStages stages, kStages - 1 slices ahead; all 256 threads split the
//    k slice once into hi and lo tiles laid out as wgmma's B operand,
//    and each thread loads and splits its own q fragments in registers.
//    q is streamed, not resident: 128 rows of f32 q take 160 KB at hd 320;
//  - the online softmax in registers on the accumulator layout;
//  - O += P v[:, chunk]: the chunk's raw v tile (32 x cw) lands with the
//    tile's first slice, is split once into hi and lo tiles (K-major, as
//    the f32 kernel's v), and P's hi and lo come from S's registers.
// The scores are thus recomputed once per chunk.  Registers: O takes cw /
// 2 a thread (128 at cw 256), S's two accumulators 16 each, a slice's q
// fragments 32, P's hi and lo 32.  Shared memory at cw 256: ring 4 x 21
// KB, k split 8 KB, raw v 33 KB, v split 64 KB = 189 KB.  Tiles strictly
// above the causal diagonal are never loaded; a warpgroup whose 64 rows
// see none of a loaded tile skips its products (but splits with the
// other).  Each slice's products are waited before the next slice lands.
// ptxas gives the cw 192 to 256 instantiations 255 registers and spills
// 16 to 80 bytes; capping cw at 192 (six chunks at hd 1024, not four)
// ran 1.46x slower there on the H100 (PERF.md).  Two other plans
// were built and timed beside this one and kept out, both slower at every
// wide shape of chip_smoke.py's phase 6: q split into shared memory too,
// with A read from there (wgmma's A from shared memory at n32 triples its
// shared-memory reads: 1.55x this kernel's time at hd 1024), and a second
// k split buffer so that the next slice lands and splits while this
// slice's products run (no spill, yet 1.14x at hd 1024).
//
// Shapes: any T and S (query t sees keys <= t + S - T when causal),
// H % KV == 0, 16-byte-aligned bases.  Rows past T or S and columns past
// hd are zero-filled by cp.async and masked by length.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;          // query rows per CTA (2 x 64)
constexpr int kBK = 32;           // keys per tile
constexpr int kSlice = 32;        // head columns a ring stage
constexpr int kStages = 4;        // ring stages of raw q and k slices
constexpr int kThreads = 256;     // two warpgroups
constexpr int kLdKr = kSlice + 8; // raw k row stride (floats)
constexpr int kMaxCW = 256;       // widest output chunk (wgmma's widest N)
constexpr int kMinCW = kMaxCW / 2 + 32;   // narrowest the plan gives
// A ring stage: q (kBQ x kSlice, swizzled: q_at), then k (kBK x kLdKr).
constexpr int kStageFloats = kBQ * kSlice + kBK * kLdKr;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// x = hi + lo exactly in f32, hi = x rounded to nearest TF32 (ties away
// from zero, as cvt.rna.tf32.f32): csrc/flash_attention_f32_sm90.cu's
// split(), which tests/test_torch_cuda.py holds to cvt.rna bit for bit.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// 16 bytes from global to shared memory; zeros when !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Where column `col` (< kSlice) of row `r` of a raw q slice lives: the
// 8-column groups of a row are XOR-swizzled by r % 4, so the 64-bit
// fragment loads of a half-warp (rows g = 0 .. 3, columns 8 kk + 2c) fall
// in 16 distinct bank pairs.  A 4-float chunk stays whole.
__device__ __forceinline__ int q_at(int r, int col) {
  return r * kSlice + (col ^ ((r & 3) << 3));
}

// kRows rows of kCols floats, head columns [c0, c0 + kCols) of `src` (row
// stride hd), into shared memory at `dst`: row stride kLd floats, or,
// with kSwizzled, the layout of q_at.  Rows >= n_valid and columns >= hd
// read as zeros (from `safe`, a valid address).
template <int kRows, int kCols, int kLd, bool kSwizzled = false>
__device__ __forceinline__ void load_slice(uint32_t dst, const float* src,
                                           int n_valid, int hd, int c0,
                                           const float* safe) {
  constexpr int kChunks = kCols / 4;           // 16-byte chunks a row
  constexpr int kRounds = (kRows * kChunks + kThreads - 1) / kThreads;
#pragma unroll
  for (int j = 0; j < kRounds; ++j) {
    const int i = static_cast<int>(threadIdx.x) + j * kThreads;
    const int r = i / kChunks;
    const int c = (i - r * kChunks) * 4;
    if (kRows * kChunks % kThreads == 0 || i < kRows * kChunks) {
      const bool ok = r < n_valid && c0 + c < hd;
      const int at = kSwizzled ? q_at(r, c) : r * kLd + c;
      cp_async16(dst + at * 4,
                 ok ? src + static_cast<long long>(r) * hd + c0 + c : safe,
                 ok);
    }
  }
}

// wgmma shared-memory descriptor for a tile without swizzle (core matrices
// of 8 rows x 16 bytes): start address, leading (K) and stride (M/N) byte
// offsets between core matrices, in 16-byte units.
__device__ __forceinline__ uint64_t desc_none(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
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

// Keeps the A fragment registers `a` alive and unchanged up to here: the
// compiler sees a use, while an asynchronous wgmma still reads them.
__device__ __forceinline__ void keep_regs(const uint32_t* a) {
  asm volatile("" :: "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]) : "memory");
}

// Keeps the compiler from moving register reads and writes of `d` across
// an asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (m64 x n32, f32) += A (registers, TF32) * B (smem, K-major).
__device__ __forceinline__ void wgmma_tf32_n32(float* d, const uint32_t* a,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64 x n96, f32) += A (registers, TF32) * B (smem, K-major).
__device__ __forceinline__ void wgmma_tf32_n96(float* d, const uint32_t* a,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64 x n128, f32) += A (registers, TF32) * B (smem, K-major).
__device__ __forceinline__ void wgmma_tf32_n128(float* d, const uint32_t* a,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64 x n160, f32) += A (registers, TF32) * B (smem, K-major).
__device__ __forceinline__ void wgmma_tf32_n160(float* d, const uint32_t* a,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
      "{%80, %81, %82, %83}, %84, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64 x n192, f32) += A (registers, TF32) * B (smem, K-major).
__device__ __forceinline__ void wgmma_tf32_n192(float* d, const uint32_t* a,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64 x n224, f32) += A (registers, TF32) * B (smem, K-major).
__device__ __forceinline__ void wgmma_tf32_n224(float* d, const uint32_t* a,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %117, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n224k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111}, "
      "{%112, %113, %114, %115}, %116, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64 x n256, f32) += A (registers, TF32) * B (smem, K-major).
__device__ __forceinline__ void wgmma_tf32_n256(float* d, const uint32_t* a,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a,
                                           uint64_t db) {
  if constexpr (N == 32) wgmma_tf32_n32(d, a, db);
  else if constexpr (N == 96) wgmma_tf32_n96(d, a, db);
  else if constexpr (N == 128) wgmma_tf32_n128(d, a, db);
  else if constexpr (N == 160) wgmma_tf32_n160(d, a, db);
  else if constexpr (N == 192) wgmma_tf32_n192(d, a, db);
  else if constexpr (N == 224) wgmma_tf32_n224(d, a, db);
  else wgmma_tf32_n256(d, a, db);
}

// Shared memory of one CTA, in floats: the ring, k's split tiles, the raw
// v tile, v's split tiles.
__host__ __device__ constexpr int smem_floats(int cw) {
  return kStages * kStageFloats + 2 * kBK * kSlice + kBK * (cw + 4) +
         2 * kBK * cw;
}

// kCW: the output chunk's width, a multiple of 32 (96 .. 256).
template <int kCW>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_wide_f32_kernel(const float* __restrict__ q,
                                const float* __restrict__ k,
                                const float* __restrict__ v,
                                float* __restrict__ o, int H, int KV, int T,
                                int S, int hd, int hd_out, int n_chunks,
                                int BH, int causal, float scale) {
  constexpr int kLdVr = kCW + 4;         // raw v row stride (floats)
  constexpr int kKBlock = 8 * kBK;       // split k: one 8-column step
  constexpr int kVBlock = 8 * kCW;       // split v: one 8-key step
  constexpr int kNT = kCW / 8;           // 8-column tiles of the output
  constexpr int kKT = kBK / 8;           // 8-key steps of a tile
  constexpr int kST = kSlice / 8;        // 8-column steps of a slice

  // The ring (kStages x kStageFloats); ks [kST][kBK / 8][2][8][4] (per
  // 8-column step of S = q k^T a K-major B operand, n = key, k = head
  // column), hi then lo; vr [kBK][kLdVr] raw; vs [kKT][kCW / 8][2][8][4]
  // (per 8-key step of P v, n = head column, k = key), hi then lo; each
  // split tile of 8 x 16-byte core matrices, the two along k 128 bytes
  // apart, those along n 256 bytes apart.
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* ks_hi = ring + kStages * kStageFloats;
  float* ks_lo = ks_hi + kBK * kSlice;
  float* vr = ks_lo + kBK * kSlice;
  float* vs_hi = vr + kBK * kLdVr;
  float* vs_lo = vs_hi + kBK * kCW;

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
  const int offset = S - T;         // query t sees keys <= t + offset
  // Keys past the last row's diagonal are masked for every row here.
  const int k_end = causal ? min(S, q0 + q_rows + offset) : S;
  const int n_tiles = k_end > 0 ? (k_end + kBK - 1) / kBK : 0;
  const int n_slices = (hd + kSlice - 1) / kSlice;
  const int total = n_tiles * n_slices;
  const int c0 = chunk * kCW;
  const float* q_tile = q + (static_cast<long long>(bh) * T + q0) * hd;
  const long long kv_base = static_cast<long long>(b * KV + kvh) * S * hd;
  const float* k_head = k + kv_base;
  const float* v_head = v + kv_base;

  // Slice gi of the walk (key tile gi / n_slices, head columns 32 (gi %
  // n_slices) ..) into its ring stage; nothing past the walk's end.
  auto issue = [&](int gi) {
    if (gi >= total) return;
    const int ti = gi / n_slices;
    const int col = (gi - ti * n_slices) * kSlice;
    const uint32_t stage = smem_u32(ring + (gi % kStages) * kStageFloats);
    load_slice<kBQ, kSlice, kSlice, true>(stage, q_tile, q_rows, hd, col,
                                          q_tile);
    load_slice<kBK, kSlice, kLdKr>(
        stage + kBQ * kSlice * 4, k_head + static_cast<long long>(ti) * kBK * hd,
        S - ti * kBK, hd, col, k_head);
  };
#pragma unroll
  for (int gi = 0; gi < kStages - 1; ++gi) {
    issue(gi);
    cp_async_commit();
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;          // fragment row (and row + 8)
  const int c = lane & 3;           // fragment column (and column + 4)
  const int w0 = q0 + 16 * warp;    // this warp's first row
  const int wg0 = q0 + 64 * (warp >> 2);   // its warpgroup's first row
  // Accumulator layout (m64nN f32): this thread holds rows row0 and row0
  // + 8, columns 8 j + 2 c + {0, 1}, as x[4 j + {0, 1}] (row0) and x[4 j +
  // {2, 3}] (row0 + 8).
  const int row0 = w0 + g;
  const bool live = wg0 < T;        // wgmma takes the whole warpgroup
  const int q_row = 16 * warp + g;  // and q_row + 8, in the q slice

  float acc[kCW / 2];
#pragma unroll
  for (int j = 0; j < kCW / 2; ++j) acc[j] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};        // this thread's share of the row sum

  int gs = 0;                       // slices consumed
  for (int i = 0; i < n_tiles; ++i) {
    const int k0 = i * kBK;
    const bool active = live && (!causal || k0 <= wg0 + 63 + offset);
    // S = q k^T on wgmma: hi.hi into sh, lo.hi + hi.lo into sl.
    float sh[kBK / 2], sl[kBK / 2];
#pragma unroll
    for (int j = 0; j < kBK / 2; ++j) sh[j] = sl[j] = 0.0f;
    for (int s = 0; s < n_slices; ++s, ++gs) {
      cp_async_wait<kStages - 2>();  // slice gs has landed
      __syncthreads();               // ... for every thread; its stage - 1,
                                     // ks and the raw v tile are free
      issue(gs + kStages - 1);
      if (s == 0) {
        // This tile's v, in the same group, 4 rows a round.  The rounds
        // and the v split below stay rolled: unrolled, the compiler keeps
        // every round's addresses live across the walk, and the kernel
        // spills.
#pragma unroll 1
        for (int r0 = 0; r0 < kBK; r0 += 4) {
          load_slice<4, kCW, kLdVr>(
              smem_u32(vr + r0 * kLdVr),
              v_head + static_cast<long long>(k0 + r0) * hd, S - k0 - r0, hd,
              c0, v_head);
        }
      }
      cp_async_commit();
      const float* stage = ring + (gs % kStages) * kStageFloats;
      const float* kr = stage + kBQ * kSlice;
      // Split the k slice once for both warpgroups.  Core-matrix column
      // cc holds, at 8-column step kk, head column 8 kk + 2 cc and column
      // cc + 4 head column 8 kk + 2 cc + 1 (the permuted order of q's
      // fragments below).
#pragma unroll
      for (int u0 = 0; u0 < kBK * kSlice / 2; u0 += kThreads) {
        const int u = u0 + threadIdx.x;
        const int cc = u & 3;
        const int r = (u >> 2) & 7;                    // key % 8
        const int rest = u >> 5;
        const int kk = rest % kST;
        const int key = 8 * (rest / kST) + r;
        const float2 x = *reinterpret_cast<const float2*>(
            kr + key * kLdKr + 8 * kk + 2 * cc);
        const int dst = kk * kKBlock + (key >> 3) * 64 + r * 4 + cc;
        uint32_t h0, l0, h1, l1;
        split(x.x, h0, l0);
        split(x.y, h1, l1);
        reinterpret_cast<uint32_t*>(ks_hi)[dst] = h0;
        reinterpret_cast<uint32_t*>(ks_hi)[dst + 32] = h1;
        reinterpret_cast<uint32_t*>(ks_lo)[dst] = l0;
        reinterpret_cast<uint32_t*>(ks_lo)[dst + 32] = l1;
      }
      // This thread's q fragments of the slice, split in registers:
      // within each group of 8 head columns A column c takes head column
      // 2c and c + 4 takes 2c + 1 (one 64-bit load each).
      uint32_t ah[kST][4], al[kST][4];
      if (active) {
#pragma unroll
        for (int kk = 0; kk < kST; ++kk) {
          const float2 qa = *reinterpret_cast<const float2*>(
              stage + q_at(q_row, 8 * kk + 2 * c));
          const float2 qb = *reinterpret_cast<const float2*>(
              stage + q_at(q_row + 8, 8 * kk + 2 * c));
          split(qa.x, ah[kk][0], al[kk][0]);  // (row g,     column c)
          split(qb.x, ah[kk][1], al[kk][1]);  // (row g + 8, column c)
          split(qa.y, ah[kk][2], al[kk][2]);  // (row g,     column c + 4)
          split(qb.y, ah[kk][3], al[kk][3]);  // (row g + 8, column c + 4)
        }
      }
      // Shared-memory writes by threads, read by wgmma (the async proxy).
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();               // ks ready
      if (active) {
        wgmma_fence();
        fence_regs<kBK / 2>(sh);
        fence_regs<kBK / 2>(sl);
#pragma unroll
        for (int kk = 0; kk < kST; ++kk) {
          const uint64_t dh = desc_none(smem_u32(ks_hi + kk * kKBlock), 128,
                                        256);
          const uint64_t dl = desc_none(smem_u32(ks_lo + kk * kKBlock), 128,
                                        256);
          wgmma_tf32<kBK>(sl, al[kk], dh);
          wgmma_tf32<kBK>(sl, ah[kk], dl);
          wgmma_tf32<kBK>(sh, ah[kk], dh);
        }
        wgmma_commit();
        fence_regs<kBK / 2>(sh);
        fence_regs<kBK / 2>(sl);
        wgmma_wait_all();
#pragma unroll
        for (int kk = 0; kk < kST; ++kk) {
          keep_regs(ah[kk]);
          keep_regs(al[kk]);
        }
        fence_regs<kBK / 2>(sh);
        fence_regs<kBK / 2>(sl);
      }
    }
    if (n_slices < kStages) {        // the v tile's group is not yet waited
      cp_async_wait<0>();
      __syncthreads();
    }

    uint32_t ph[kKT][4], pl[kKT][4];
    if (active) {
      // Scale, then mask where this tile crosses S or the diagonal.
      const bool edge = k0 + kBK > S ||
                        (causal && k0 + kBK - 1 > w0 + offset);
      float sc[kKT][4];
#pragma unroll
      for (int j = 0; j < kKT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = (sh[4 * j + e] + sl[4 * j + e]) * scale;
          if (edge) {
            const int col = k0 + 8 * j + 2 * c + (e & 1);
            const int t = row0 + 8 * (e >> 1);
            x = (col < S && (!causal || col <= t + offset)) ? x : -INFINITY;
          }
          sc[j][e] = x;
        }
      }
      // Online softmax in f32; a row is spread over the 4 lanes of a quad.
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < kKT; ++j)
          mx = fmaxf(mx, fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        const float m_use = m_new == -INFINITY ? 0.0f : m_new;
        corr[r] = exp2f((m[r] - m_use) * kLog2e);
        const float mb = m_use * kLog2e;
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < kKT; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2f(fmaf(sc[j][2 * r + e], kLog2e, -mb));
            sc[j][2 * r + e] = p;
            sum += p;
          }
        }
        l[r] = l[r] * corr[r] + sum;
        m[r] = m_new;
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        acc[4 * j + 0] *= corr[0];
        acc[4 * j + 1] *= corr[0];
        acc[4 * j + 2] *= corr[1];
        acc[4 * j + 3] *= corr[1];
      }
      // P's A fragments over 8-key steps whose keys run in the order 0 2
      // 4 6 1 3 5 7: column c is key 2c (the thread's own sc[kk][0] and
      // [2]) and column c + 4 key 2c + 1 (sc[kk][1] and [3]), as v's
      // split tiles are laid out.
#pragma unroll
      for (int kk = 0; kk < kKT; ++kk) {
        split(sc[kk][0], ph[kk][0], pl[kk][0]);
        split(sc[kk][2], ph[kk][1], pl[kk][1]);
        split(sc[kk][1], ph[kk][2], pl[kk][2]);
        split(sc[kk][3], ph[kk][3], pl[kk][3]);
      }
    }
    // Split the chunk's v tile once for both warpgroups: at 8-key step kk
    // core-matrix column cc holds key 8 kk + 2 cc and column cc + 4 key 8
    // kk + 2 cc + 1 (P's permuted order).
#pragma unroll 1
    for (int u0 = 0; u0 < kBK * kCW / 2; u0 += kThreads) {
      const int u = u0 + threadIdx.x;
      const int cc = u & 3;                          // key 8 kk + 2 cc
      const int r = (u >> 2) & 7;                    // n % 8
      const int rest = u >> 5;
      const int kk = rest / (kCW / 8);
      const int n = 8 * (rest - kk * (kCW / 8)) + r;
      const int dst = kk * kVBlock + (n >> 3) * 64 + r * 4 + cc;
      const float* src = vr + (8 * kk + 2 * cc) * kLdVr + n;
      const float x0 = src[0], x1 = src[kLdVr];
      uint32_t h0, l0, h1, l1;
      split(x0, h0, l0);
      split(x1, h1, l1);
      reinterpret_cast<uint32_t*>(vs_hi)[dst] = h0;
      reinterpret_cast<uint32_t*>(vs_hi)[dst + 32] = h1;
      reinterpret_cast<uint32_t*>(vs_lo)[dst] = l0;
      reinterpret_cast<uint32_t*>(vs_lo)[dst + 32] = l1;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();                 // vs ready; vr free
    if (active) {
      wgmma_fence();
      fence_regs<kCW / 2>(acc);
#pragma unroll
      for (int kk = 0; kk < kKT; ++kk) {
        const uint64_t dh = desc_none(smem_u32(vs_hi + kk * kVBlock), 128, 256);
        const uint64_t dl = desc_none(smem_u32(vs_lo + kk * kVBlock), 128, 256);
        wgmma_tf32<kCW>(acc, pl[kk], dh);
        wgmma_tf32<kCW>(acc, ph[kk], dl);
        wgmma_tf32<kCW>(acc, ph[kk], dh);
      }
      wgmma_commit();
      fence_regs<kCW / 2>(acc);
      wgmma_wait_all();
#pragma unroll
      for (int kk = 0; kk < kKT; ++kk) {
        keep_regs(ph[kk]);
        keep_regs(pl[kk]);
      }
      fence_regs<kCW / 2>(acc);
    }
  }
  cp_async_wait<0>();

  // Epilogue: the row sum over its 4 lanes, acc / l; a row that saw no
  // key (l = 0) is 0, a NaN row stays NaN.  This chunk's columns below
  // hd_out.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = row0 + 8 * r;
    if (t >= T) continue;
    float* out = o + (static_cast<long long>(bh) * T + t) * hd_out + c0;
    const bool any = l[r] != 0.0f;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int col = 8 * j + 2 * c;
      if (c0 + col < hd_out) {
        const float a0 = any ? acc[4 * j + 2 * r] / l[r] : 0.0f;
        const float a1 = any ? acc[4 * j + 2 * r + 1] / l[r] : 0.0f;
        if (hd_out % 2 == 0) {            // col + 1 in the row, 8-byte aligned
          *reinterpret_cast<float2*>(out + col) = make_float2(a0, a1);
        } else {
          out[col] = a0;
          if (c0 + col + 1 < hd_out) out[col + 1] = a1;
        }
      }
    }
  }
}

template <int kCW>
int launch(const float* q, const float* k, const float* v, float* o, int B,
           int H, int KV, int T, int S, int hd, int hd_out, int causal,
           float scale, cudaStream_t stream) {
  const int n_chunks = (hd_out + kCW - 1) / kCW;
  const long long q_tiles = (T + kBQ - 1) / kBQ;
  const long long blocks = q_tiles * B * H * n_chunks;
  if (blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const size_t smem = sizeof(float) * smem_floats(kCW);
  auto kernel = flash_attention_wide_f32_kernel<kCW>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      q, k, v, o, H, KV, T, S, hd, hd_out, n_chunks, B * H, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation of chunk width cw: kMinCW .. kMaxCW in steps of 32.
template <int kCW>
int dispatch(int cw, const float* q, const float* k, const float* v,
             float* o, int B, int H, int KV, int T, int S, int hd,
             int hd_out, int causal, float scale, cudaStream_t st) {
  if (cw == kCW)
    return launch<kCW>(q, k, v, o, B, H, KV, T, S, hd, hd_out, causal,
                       scale, st);
  if constexpr (kCW < kMaxCW) {
    return dispatch<kCW + 32>(cw, q, k, v, o, B, H, KV, T, S, hd, hd_out,
                              causal, scale, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, k, v have rows of hd (a multiple of 4, padded with zero columns
// where the head_dim is not); o has rows of hd_out <= hd, the head_dim,
// and gets the first hd_out columns.  cw is the chunk width of the
// caller's plan (wide_plan): a multiple of 32 from kMinCW to kMaxCW.
extern "C" int flash_attention_wide_f32(const void* qp, const void* kp,
                                        const void* vp, void* op, int B,
                                        int H, int KV, int T, int S, int hd,
                                        int hd_out, int cw, int causal,
                                        float scale, void* stream) {
  const auto* q = static_cast<const float*>(qp);
  const auto* k = static_cast<const float*>(kp);
  const auto* v = static_cast<const float*>(vp);
  auto* o = static_cast<float*>(op);
  if (hd < 4 || hd % 4 != 0 || hd_out < 1 || hd_out > hd || cw < kMinCW ||
      cw > kMaxCW || cw % 32 != 0 || KV < 1 || H % KV != 0 ||
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) &
       15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || H == 0 || T == 0) return 0;
  if (S == 0) {                   // no key at all: every row is 0
    cudaMemsetAsync(o, 0, static_cast<size_t>(B) * H * T * hd_out * 4, st);
    return static_cast<int>(cudaGetLastError());
  }
  return dispatch<kMinCW>(cw, q, k, v, o, B, H, KV, T, S, hd, hd_out, causal,
                          scale, st);
}
