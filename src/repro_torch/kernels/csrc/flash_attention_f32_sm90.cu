// Causal online-softmax GQA attention for f32 on Hopper's tensor cores:
// q (B,H,T,hd), k/v (B,KV,S,hd) f32 -> (B,H,T,hd) f32.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py (_kernel,
// lines 44-93; pl.pallas_call at line 124) for f32 inputs of every
// head_dim from 1 to 256; csrc/flash_attention_sm90.cu serves bf16
// inputs.  The kernel takes hd % 4 == 0 (cp.async's 16-byte rows); the
// wrapper (kernels/flash_attention.py) zero-pads any other head_dim to
// the next multiple of 4 and passes the true hd's scale, so the extra
// columns add exact zeros to every score (and split into hi = lo = 0).
//
// Bound: operations.  Each (query, key) pair the mask keeps costs 2*hd
// flops for the score and 2*hd for the weighted sum.  The tensor cores
// take f32 only as TF32 (10 mantissa bits), and one TF32 product misses
// the f32 gate (rtol/atol 2e-5), so an f32-accurate product costs three
// TF32 products (below): 3 * 4*hd per kept pair at 495 TFLOP/s (dense
// TF32 on an H100 SXM) is the function's bound, 0.41x of the 4*hd at 67
// TFLOP/s that the CUDA cores' f32 rate would allow.
//
// Numerics: the split-TF32 product.  Each f32 operand x of S = q k^T and
// of O += P v splits exactly into hi, x rounded to nearest TF32, and lo =
// x - hi (split() below).  hi must be the rounding: raw f32 bits would be
// read truncated by the tensor cores, and x - hi would then not be the
// part of x that they miss.  A product is computed as lo.hi + hi.lo + hi.hi
// into f32 accumulators (lo.lo, below 2^-22 of the product, is dropped):
// about 21 bits of the f32 product.  The softmax is the plain version's
// f32 recurrence: masked scores are -inf, a row that has seen no valid
// key keeps m = 0 for its exponentials, l sums the f32 p, acc is rescaled
// by exp(m_prev - m_new), and a row whose l = 0 is written as 0 (a NaN
// row stays NaN).
// The epilogue divides by l once.  Builds with -fmad=true (held to a
// tolerance, not bitwise).
//
// Two departures from the other flash kernels' contract, both inside the
// f32 gate: S is scaled by hd^-0.5 after the product (they scale q
// first), and lo goes to the tensor cores unrounded, where they truncate
// it (a split that also rounds lo, cvt.rna(x - hi), costs one more
// operation per operand for under 2^-21 |x|).  A finite x that rounds
// to +-inf (|x| >= (2 - 2^-11) * 2^127) splits into hi = +-inf and lo =
// -+inf, so its products are NaN where the plain version's are finite;
// the same holds for a split that rounds lo.
//
// Design.  Both products run on wgmma TF32 (m64nNk8), which takes its B
// operand K-major from shared memory and its A operand from registers.
// One CTA per (b, h, 128-row q tile), all on grid.x with every head's
// heaviest causal tile first; two warpgroups own 64 q rows each.  q stays
// raw in shared memory for the whole walk; its A fragments are loaded and
// split in registers, four 8-column steps to a commit group (two from hd
// 224 on: s_group), two groups in flight.  Each k and v tile (kBK keys:
// 64 up to hd 96, 32 up to 160, 16 above) lands raw by cp.async, and all
// 256 threads then split it once into hi and lo tiles laid out as
// wgmma's B operand (no swizzle: 8 x 16-byte core matrices); the next
// tile's cp.async overlaps the products.  q's rows are not padded but
// XOR-swizzled (q_at), which keeps its fragment loads free of bank
// conflicts.  At hd 160: q 80 KB + raw 41 KB + split 80 KB = 202 KB; at
// hd 256: q 128 KB + raw 33 KB + split 64 KB = 225 KB, under the 227 KB
// a block may use (with q's rows padded by 8 floats, as before, it
// would need 229 KB).  Tiles strictly above the causal diagonal are
// never loaded; a warpgroup whose 64 rows see none of a loaded tile
// skips its products.
// At hd 256 two other plans fit: loading k and v through registers
// straight into the split tiles, with no raw landing, or 64 query rows a
// CTA (one consumer warpgroup: half the rows over which each tile's
// split is spread, and no second warpgroup to overlap).  The landing is
// kept: the direct load, built and timed beside it on the H100, took
// 9 to 17 % longer at hd 160, 200 and 256 (PERF.md), as the landing's
// cp.async overlaps the products where the direct load waits.  The
// direct plan was not kept; the 64-row CTA was not built.
//  - S = q k^T: within each group of 8 head columns the reduction order
//    is permuted (A column c takes head column 2c, c + 4 takes 2c + 1),
//    so a thread's two q values of a row are one 64-bit load (q_at:
//    conflict-free); k's split tiles use the same order.
//  - The accumulator of S holds keys 2c and 2c + 1 in one thread, and the
//    A fragment of P v wants columns c and c + 4: with the keys of each
//    group of 8 permuted the same way in P and in v's split tiles, S's
//    registers are P's fragment as they stand (no shuffle, no shared
//    round trip).
// A first version ran both products on mma.sync m16n8k8 with operands
// split in each warp: mma.sync's TF32 rate is well under wgmma's, and the
// splits outnumbered the products (PERF.md).  Head_dims round up to a
// multiple of 32 for the template; the columns past hd stay zero in
// shared memory and are not written.
//
// Shapes: any T and S (query t sees keys <= t + S - T when causal),
// H % KV == 0, 16-byte-aligned bases.  Rows past T or S are zero-filled
// by cp.async and masked by length.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;          // query rows per CTA
constexpr int kWarps = kBQ / 16;  // 16 rows a warp (one m16 tile)
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxHeadDim = 256;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// x = hi + lo exactly in f32.  hi is x rounded to nearest TF32, ties away
// from zero: the value cvt.rna.tf32.f32 gives for every finite x and for
// +-inf, in two integer operations (ptxas wraps the same add and mask in
// a finiteness test and a select; tests/test_torch_cuda.py holds the two
// alike bit for bit).  lo = x - hi goes to the tensor cores as it
// is: they read a TF32 operand's sign, exponent and top 10 mantissa
// bits, so lo is truncated there; |lo| <= 2^-11 |x|, so that costs under
// 2^-21 |x|.  A NaN x leaves lo NaN, so NaN still reaches the products.
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Where column `col` of row `r` of the q tile lives in shared memory (row
// stride kHdp floats): the 8-column groups of a row are XOR-swizzled by
// r % 4, so the 64-bit fragment loads of a half-warp (rows g = 0 .. 3,
// columns 8 kk + 2c) fall in 16 distinct bank pairs without padding the
// rows.  A 4-float chunk stays whole.
template <int kHdp>
__device__ __forceinline__ int q_at(int r, int col) {
  return r * kHdp + (col ^ ((r & 3) << 3));
}

// kRows rows of hd floats from `src` (row stride hd) into shared memory at
// `dst`: row stride kLd floats, or, with kSwizzled, the q layout of q_at;
// rows >= n_valid read as zeros (from `safe`, a valid address).  Columns
// hd .. kHdp are left as they are.
template <int kRows, int kHdp, int kLd, bool kSwizzled = false>
__device__ __forceinline__ void load_tile(uint32_t dst, const float* src,
                                          int n_valid, int hd,
                                          const float* safe) {
  constexpr int kChunks = kHdp / 4;            // 16-byte chunks a row
  constexpr int kRounds = (kRows * kChunks + kThreads - 1) / kThreads;
#pragma unroll
  for (int j = 0; j < kRounds; ++j) {
    const int i = static_cast<int>(threadIdx.x) + j * kThreads;
    const int r = i / kChunks;
    const int c = (i - r * kChunks) * 4;
    if (i < kRows * kChunks && c < hd) {
      const bool ok = r < n_valid;
      const int at = kSwizzled ? q_at<kHdp>(r, c) : r * kLd + c;
      cp_async16(dst + at * 4,
                 ok ? src + static_cast<long long>(r) * hd + c : safe, ok);
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
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
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

// d (m64 x n16, f32) += A (registers, TF32) * B (smem, K-major).
__device__ __forceinline__ void wgmma_tf32_n16(float* d, const uint32_t* a,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
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

// d (m64 x n64, f32) += A (registers, TF32) * B (smem, K-major).
__device__ __forceinline__ void wgmma_tf32_n64(float* d, const uint32_t* a,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
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
  if constexpr (N == 16) wgmma_tf32_n16(d, a, db);
  else if constexpr (N == 32) wgmma_tf32_n32(d, a, db);
  else if constexpr (N == 64) wgmma_tf32_n64(d, a, db);
  else if constexpr (N == 96) wgmma_tf32_n96(d, a, db);
  else if constexpr (N == 128) wgmma_tf32_n128(d, a, db);
  else if constexpr (N == 160) wgmma_tf32_n160(d, a, db);
  else if constexpr (N == 192) wgmma_tf32_n192(d, a, db);
  else if constexpr (N == 224) wgmma_tf32_n224(d, a, db);
  else wgmma_tf32_n256(d, a, db);
}

// Keys per tile: the largest of 64, 32, 16 whose buffers fit beside q.
__host__ __device__ constexpr int key_tile(int hdp) {
  return hdp <= 96 ? 64 : hdp <= 160 ? 32 : 16;
}

// S steps (8 head columns each) to a wgmma commit group: 4, or 2 from hd
// 224 on, where O's accumulator (hdp / 2 registers a thread) leaves too
// few registers for two groups of four steps' split q fragments.
__host__ __device__ constexpr int s_group(int hdp) {
  return hdp <= 192 ? 4 : 2;
}

// Shared memory of one CTA, in floats (see the kernel): q, the raw
// landing tiles of k and v, their split tiles.
__host__ __device__ constexpr int smem_floats(int hdp) {
  return kBQ * hdp + key_tile(hdp) * (2 * hdp + 12) +
         4 * key_tile(hdp) * hdp;
}

// kHdp: head_dim rounded up to a multiple of 32.
template <int kHdp>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_f32_sm90_kernel(const float* __restrict__ q,
                                const float* __restrict__ k,
                                const float* __restrict__ v,
                                float* __restrict__ o, int H, int KV, int T,
                                int S, int hd, int hd_out, int BH,
                                int causal, float scale) {
  constexpr int kBK = key_tile(kHdp);
  constexpr int kLdKr = kHdp + 8;       // raw k row stride (floats)
  constexpr int kLdVr = kHdp + 4;       // raw v row stride
  constexpr int kKBlock = 8 * kBK;      // split k: one 8-column step
  constexpr int kVBlock = 8 * kHdp;     // split v: one 8-key step
  constexpr int kNT = kHdp / 8;         // 8-column tiles of the output
  constexpr int kKT = kBK / 8;          // 8-key steps of a k/v tile
  constexpr int kGroup = s_group(kHdp); // S steps to a wgmma commit group
  static_assert(kHdp / 8 % kGroup == 0, "whole groups");

  // q [kBQ][kHdp] (swizzled, q_at), kr [kBK][kLdKr] and vr [kBK][kLdVr]
  // raw (kr and vr: the landing tile); then the tile split for wgmma, hi
  // and lo apart: ks [kHdp / 8][kBK / 8][2][8][4] (per 8-column step of S
  // = q k^T a K-major B operand, n = key, k = head column) and vs [kKT]
  // [kHdp / 8][2][8][4] (per 8-key step of P v, n = head column, k =
  // key), each of 8 x 16-byte core matrices, the two along k 128 bytes
  // apart, those along n 256 bytes apart.
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* kr = qs + kBQ * kHdp;
  float* vr = kr + kBK * kLdKr;
  float* ks_hi = vr + kBK * kLdVr;
  float* ks_lo = ks_hi + kBK * kHdp;
  float* vs_hi = ks_lo + kBK * kHdp;
  float* vs_lo = vs_hi + kBK * kHdp;

  const int q_tiles = static_cast<int>(gridDim.x) / BH;
  const int qt = q_tiles - 1 - static_cast<int>(blockIdx.x) / BH;
  const int bh = static_cast<int>(blockIdx.x) - (q_tiles - 1 - qt) * BH;
  const int b = bh / H;
  const int kvh = (bh - b * H) / (H / KV);
  const int q0 = qt * kBQ;
  const int q_rows = min(kBQ, T - q0);
  const int offset = S - T;         // query t sees keys <= t + offset
  // Keys past the last row's diagonal are masked for every row here.
  const int k_end = causal ? min(S, q0 + q_rows + offset) : S;
  const int n_tiles = k_end > 0 ? (k_end + kBK - 1) / kBK : 0;
  const float* q_tile = q + (static_cast<long long>(bh) * T + q0) * hd;
  const long long kv_base = static_cast<long long>(b * KV + kvh) * S * hd;
  const float* k_head = k + kv_base;
  const float* v_head = v + kv_base;

  // Zero shared memory once: the columns past hd are never loaded.
  {
    float4* p = reinterpret_cast<float4*>(smem);
    constexpr int n = smem_floats(kHdp) / 4;
    for (int i = threadIdx.x; i < n; i += kThreads)
      p[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();

  load_tile<kBQ, kHdp, kHdp, true>(smem_u32(qs), q_tile, q_rows, hd, q_tile);
  auto load_kv = [&](int tile) {
    const int k0 = tile * kBK;
    const long long off = static_cast<long long>(k0) * hd;
    load_tile<kBK, kHdp, kLdKr>(smem_u32(kr), k_head + off, S - k0, hd,
                                k_head);
    load_tile<kBK, kHdp, kLdVr>(smem_u32(vr), v_head + off, S - k0, hd,
                                v_head);
  };
  if (n_tiles > 0) load_kv(0);
  cp_async_commit();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;          // fragment row (and row + 8)
  const int c = lane & 3;           // fragment column (and column + 4)
  const int w0 = q0 + 16 * warp;    // this warp's first row
  const int wg0 = q0 + 64 * (warp >> 2);   // its warpgroup's first row
  // Accumulator layout (m16n8 and m64nN f32 alike): this thread holds
  // rows row0 and row0 + 8, columns 8 j + 2 c + {0, 1}, as x[4 j + {0,
  // 1}] (row0) and x[4 j + {2, 3}] (row0 + 8).
  const int row0 = w0 + g;
  const bool live = wg0 < T;        // wgmma takes the whole warpgroup
  const int q_row = 16 * warp + g;  // and q_row + 8, swizzled alike

  float acc[kHdp / 2];
#pragma unroll
  for (int j = 0; j < kHdp / 2; ++j) acc[j] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};        // this thread's share of the row sum

  for (int i = 0; i < n_tiles; ++i) {
    const int k0 = i * kBK;
    cp_async_wait_all();            // q and tile i have landed
    __syncthreads();                // ... for every thread; ks, vs are free
    // Split the tile once for all eight warps.  Core-matrix column c
    // holds, at 8-column step kk of k, head column 8 kk + 2c and column
    // c + 4 head column 8 kk + 2c + 1 (the S product's permuted order);
    // at 8-key step kk of v, key 8 kk + 2c and key 8 kk + 2c + 1 (P v's
    // permuted order).
#pragma unroll
    for (int u0 = 0; u0 < kBK * kHdp / 2; u0 += kThreads) {
      const int u = u0 + threadIdx.x;
      const int cc = u & 3;
      const int r = (u >> 2) & 7;                    // key % 8
      const int rest = u >> 5;
      const int kk = rest % (kHdp / 8);
      const int key = 8 * (rest / (kHdp / 8)) + r;
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
#pragma unroll
    for (int u0 = 0; u0 < kBK * kHdp / 2; u0 += kThreads) {
      const int u = u0 + threadIdx.x;
      const int cc = u & 3;                          // key 8 kk + 2 cc
      const int r = (u >> 2) & 7;                    // n % 8
      const int rest = u >> 5;
      const int kk = rest / (kHdp / 8);
      const int n = 8 * (rest - kk * (kHdp / 8)) + r;
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
    // Shared-memory writes by threads, read by wgmma (the async proxy).
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();                // ks, vs ready; kr, vr free
    if (i + 1 < n_tiles) load_kv(i + 1);
    cp_async_commit();

    if (live && (!causal || k0 <= wg0 + 63 + offset)) {
      // S = q k^T on wgmma: hi.hi into sh, lo.hi + hi.lo into sl.  q's A
      // fragments are split in registers, kGroup 8-column steps to a
      // commit group and two groups in flight: a group's registers stay
      // untouched until wait_group 1 after the next group's commit says
      // its products are done.
      float sh[kBK / 2], sl[kBK / 2];
#pragma unroll
      for (int j = 0; j < kBK / 2; ++j) sh[j] = sl[j] = 0.0f;
      uint32_t ah[2][kGroup][4], al[2][kGroup][4];
      fence_regs<kBK / 2>(sh);
      fence_regs<kBK / 2>(sl);
#pragma unroll
      for (int s0 = 0; s0 < kHdp / 8; s0 += kGroup) {
        const int x = (s0 / kGroup) & 1;
#pragma unroll
        for (int gi = 0; gi < kGroup; ++gi) {
          const int kk = s0 + gi;
          const float2 qa = *reinterpret_cast<const float2*>(
              qs + q_at<kHdp>(q_row, 8 * kk + 2 * c));
          const float2 qb = *reinterpret_cast<const float2*>(
              qs + q_at<kHdp>(q_row + 8, 8 * kk + 2 * c));
          split(qa.x, ah[x][gi][0], al[x][gi][0]);  // (row g,     column c)
          split(qb.x, ah[x][gi][1], al[x][gi][1]);  // (row g + 8, column c)
          split(qa.y, ah[x][gi][2], al[x][gi][2]);  // (row g,     column c + 4)
          split(qb.y, ah[x][gi][3], al[x][gi][3]);  // (row g + 8, column c + 4)
        }
        wgmma_fence();
#pragma unroll
        for (int gi = 0; gi < kGroup; ++gi) {
          const int kk = s0 + gi;
          const uint64_t dh = desc_none(smem_u32(ks_hi + kk * kKBlock), 128, 256);
          const uint64_t dl = desc_none(smem_u32(ks_lo + kk * kKBlock), 128, 256);
          wgmma_tf32<kBK>(sl, al[x][gi], dh);
          wgmma_tf32<kBK>(sl, ah[x][gi], dl);
          wgmma_tf32<kBK>(sh, ah[x][gi], dh);
        }
        wgmma_commit();
        if (s0 > 0) {
          wgmma_wait<1>();
#pragma unroll
          for (int gi = 0; gi < kGroup; ++gi) {
            keep_regs(ah[x ^ 1][gi]);
            keep_regs(al[x ^ 1][gi]);
          }
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int gi = 0; gi < kGroup; ++gi) {
        keep_regs(ah[(kHdp / 8 / kGroup - 1) & 1][gi]);
        keep_regs(al[(kHdp / 8 / kGroup - 1) & 1][gi]);
      }
      fence_regs<kBK / 2>(sh);
      fence_regs<kBK / 2>(sl);

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

      // O += P v on wgmma, over 8-key steps whose keys run in the order
      // 0 2 4 6 1 3 5 7: P's A fragment column c is key 2c (the thread's
      // own sc[kk][0] and [2]) and column c + 4 key 2c + 1 (sc[kk][1] and
      // [3]), as v's split tiles are laid out.
      uint32_t ph[kKT][4], pl[kKT][4];
#pragma unroll
      for (int kk = 0; kk < kKT; ++kk) {
        split(sc[kk][0], ph[kk][0], pl[kk][0]);
        split(sc[kk][2], ph[kk][1], pl[kk][1]);
        split(sc[kk][1], ph[kk][2], pl[kk][2]);
        split(sc[kk][3], ph[kk][3], pl[kk][3]);
      }
      wgmma_fence();
      fence_regs<kHdp / 2>(acc);
#pragma unroll
      for (int kk = 0; kk < kKT; ++kk) {
        const uint64_t dh = desc_none(smem_u32(vs_hi + kk * kVBlock), 128, 256);
        const uint64_t dl = desc_none(smem_u32(vs_lo + kk * kVBlock), 128, 256);
        wgmma_tf32<kHdp>(acc, pl[kk], dh);
        wgmma_tf32<kHdp>(acc, ph[kk], dl);
        wgmma_tf32<kHdp>(acc, ph[kk], dh);
      }
      wgmma_commit();
      fence_regs<kHdp / 2>(acc);
      wgmma_wait<0>();
      fence_regs<kHdp / 2>(acc);
    }
  }
  cp_async_wait_all();

  // Epilogue: the row sum over its 4 lanes, acc / l; a row that saw no
  // key (l = 0) is 0, a NaN row stays NaN.
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
    float* out = o + (static_cast<long long>(bh) * T + t) * hd_out;
    const bool any = l[r] != 0.0f;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int col = 8 * j + 2 * c;
      if (col < hd_out) {
        const float a0 = any ? acc[4 * j + 2 * r] / l[r] : 0.0f;
        const float a1 = any ? acc[4 * j + 2 * r + 1] / l[r] : 0.0f;
        if (hd_out % 2 == 0) {            // col + 1 < hd_out, 8-byte aligned
          *reinterpret_cast<float2*>(out + col) = make_float2(a0, a1);
        } else {
          out[col] = a0;
          if (col + 1 < hd_out) out[col + 1] = a1;
        }
      }
    }
  }
}

template <int kHdp>
int launch(const float* q, const float* k, const float* v, float* o, int B,
           int H, int KV, int T, int S, int hd, int hd_out, int causal,
           float scale, cudaStream_t stream) {
  const long long q_tiles = (T + kBQ - 1) / kBQ;
  const long long blocks = q_tiles * B * H;
  if (blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const size_t smem = sizeof(float) * smem_floats(kHdp);
  auto kernel = flash_attention_f32_sm90_kernel<kHdp>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      q, k, v, o, H, KV, T, S, hd, hd_out, B * H, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v have rows of hd (a multiple of 4, padded with zero columns
// where the head_dim is not); o has rows of hd_out <= hd, the head_dim,
// and gets the first hd_out columns.
extern "C" int flash_attention_f32_sm90(const float* q, const float* k,
                                        const float* v, float* o, int B,
                                        int H, int KV, int T, int S, int hd,
                                        int hd_out, int causal, float scale,
                                        void* stream) {
  if (hd < 4 || hd > kMaxHeadDim || hd % 4 != 0 || hd_out < 1 ||
      hd_out > hd || KV < 1 || H % KV != 0 ||
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
  switch ((hd + 31) / 32 * 32) {
    case 32: return launch<32>(q, k, v, o, B, H, KV, T, S, hd, hd_out, causal, scale, st);
    case 64: return launch<64>(q, k, v, o, B, H, KV, T, S, hd, hd_out, causal, scale, st);
    case 96: return launch<96>(q, k, v, o, B, H, KV, T, S, hd, hd_out, causal, scale, st);
    case 128: return launch<128>(q, k, v, o, B, H, KV, T, S, hd, hd_out, causal, scale, st);
    case 160: return launch<160>(q, k, v, o, B, H, KV, T, S, hd, hd_out, causal, scale, st);
    case 192: return launch<192>(q, k, v, o, B, H, KV, T, S, hd, hd_out, causal, scale, st);
    case 224: return launch<224>(q, k, v, o, B, H, KV, T, S, hd, hd_out, causal, scale, st);
    default: return launch<256>(q, k, v, o, B, H, KV, T, S, hd, hd_out, causal, scale, st);
  }
}
