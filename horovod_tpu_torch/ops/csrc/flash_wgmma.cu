// Flash attention on Hopper's tensor cores (sm_90a): the forward, dQ and
// dK/dV kernels for bfloat16 q/k/v, with a bfloat16 dO or (the lse
// variant's gradient) a float32 dO, and for float32 q/k/v; the split pass
// that cuts fp32 tensors into bf16 planes; and the C entry points.
//
// Replace the three Pallas kernels of horovod_tpu/ops/pallas_attention.py:
//   fwd_wgmma_kernel <- _fwd_kernel  (:77, launched by _flash_fwd at :131)
//   dq_wgmma_kernel  <- _dq_kernel   (:174, launched by _flash_bwd at :274)
//   dkv_wgmma_kernel <- _dkv_kernel  (:215, launched by _flash_bwd at :293)
// They compute what those kernels compute, and round where they round: S and
// every product accumulate in fp32, P is rounded to bf16 before P.V and
// P^T.dO, dS to bf16 before dS.K and dS^T.Q (pallas_attention.py:112, :207,
// :245, :252); dQ's P is not rounded.  delta = rowsum(dO * O) is computed by
// the caller.  Causal key j is visible to query i iff j <= i.
//
// fp32 products on bf16 tensor cores: split_kernel splits an fp32 tensor
// into bf16 planes, each the bf16 rounding of what the planes before it
// leave (every difference exact in fp32), and a product runs as wgmmas of
// plane pairs.  (tf32 wgmma would need no split, but reads K-major
// operands only, and P.V, P^T.dO, dS.K and dS^T.Q read V, dO, K and Q
// MN-major.)  An operand computed in registers (P, dS) splits the same way
// there.
//   * F32DO (bf16 q/k/v, the lse variant's fp32 dO): dO arrives as two
//     planes, hi = bf16(dO) and lo = bf16(dO - hi), which hold it to about
//     2^-17.  dP = dO.V^T is hi.V^T + lo.V^T (V is exact in bf16).  P^T.dO
//     takes P unrounded (p.astype(fp32) is a no-op in the reference):
//     dV += P_hi.hi + P_lo.hi + P_hi.lo; the dropped P_lo.lo is about
//     2^-16 of a term, far below the bf16 output's rounding.  dS is rounded
//     to bf16 as on the bf16 route.
//   * F32IN (fp32 q/k/v, hence fp32 dO and outputs): the reference's casts
//     of P and dS round nothing, and the outputs are fp32, so two planes
//     are not enough: an element of a sum of 1000 terms each off by up to
//     2^-16 lands past the fp32 check's 1e-4 (tests/test_torch_flash_fp32.py
//     emulates it).  Q, K, V and dO arrive as three planes (hi, mid, lo:
//     24 bits, fp32's own), P and dS split into three in registers, and
//     every product (S = Q.K^T and O += P.V in the forward; S = Q.K^T,
//     dP = dO.V^T and dQ += dS.K in dQ; S^T = K.Q^T, dP^T = V.dO^T,
//     dV += P^T.dO and dK += dS^T.Q in dK/dV) is six wgmmas: the plane
//     pairs whose magnitudes multiply to at least 2^-16 of the term
//     (pair_a, pair_b); dQ issues them smallest first (dq_pair).  The
//     causal and ragged masks zero P before it splits, so every plane is
//     zero there.
//
// Layout: q/k/v/dO are read as [B, S, H, D] through element strides for b,
// s and h (d contiguous), so the caller makes no head-major copy; the
// outputs are contiguous [B, S, H, D], lse/delta/dlse fp32 [B, S, H].
// Head dims: the kernels are instantiated at DP = 16, 32, 64, 128 and 256
// columns and serve any head dim D that is a multiple of 8 up to DP (the
// least DP not below D; HVD_DISPATCH_D).  The tensor maps span the real D,
// so TMA fills columns D..DP-1 with zeros, which add nothing to any product,
// and the stores skip them.  D must be a multiple of 8 so that a row of a
// contiguous bf16 tensor is a whole number of 16-byte units, as TMA needs.
//
// What bounds them on this card, and what the design does about it:
//   * At the flagship shape (B 8, S 1024, H 16, D 64, causal) the forward
//     does 17 GFLOP against 68 MB of traffic, dQ 26 GFLOP against 85 MB and
//     dK/dV 34 GFLOP against 102 MB: all near the H100's ~295 FLOP/byte
//     ridge (the forward's bound is its bytes, dQ's and dK/dV's their
//     operations), so they need the bf16
//     tensor-core rate and full-rate loads.  Every product is a wgmma
//     (m64nNk16, fp32 accumulators in registers), and the [S, S] scores
//     never leave registers: the score accumulator is masked,
//     exponentiated and packed to bf16 in place, and that packed fragment
//     is the register A operand of the next wgmma (the m64 accumulator
//     layout is the A-fragment layout).  The F32DO kernels run 4/3 (dQ) and
//     7/4 (dK/dV) of the bf16 route's wgmmas for the split's extra products,
//     the F32IN kernels six times as many, and the split pass moves 8 or 10
//     bytes an element (fp32 in, two or three bf16 planes out).
//   * Loads: a producer warp issues TMA copies of [rows, D] tiles of the
//     strided [B, S, H, D] views into 128/64/32-byte swizzled shared memory
//     (the swizzle of the wgmma descriptors), completing on mbarriers, into
//     a two-stage ring, so the next tile's copy overlaps this tile's math.
//     Rows past S read as zeros (the tensor map's bounds).
//   * One consumer warpgroup per block (64 rows) and up to two blocks per
//     SM: one block's softmax overlaps the other's wgmma.
//   * Registers at DP 256: the forward walks key tiles of 64 (its m64 x 256
//     output accumulator takes 128 registers a thread), and dK/dV gives each
//     block 128 of the 256 output columns (two such accumulators would not
//     fit), so two blocks of a key tile each recompute S^T and dP^T.  Its
//     F32DO instantiation takes query tiles of 32 so that the Q, hi and lo
//     ring fits in shared memory.
//   * Shared memory and registers of the F32IN planes: the forward and dQ
//     take key tiles of 64 at DP <= 32, 32 at DP 64 and 128 and 16 at DP
//     256; dK/dV query tiles of 32 at DP <= 64 and 16 above (which keeps the
//     split fragments of P and dS beside the accumulators in registers).
//     At DP 256 three planes of K and V for 64 keys (192 KB) leave no room
//     for the query ring, so a dK/dV block takes 32 keys: its wgmmas still
//     make 64 rows, rows 32-63 read the next 4 KB of its own shared memory,
//     and those rows are never stored.  Its blocks take 64 output columns
//     each (four per key tile, each recomputing S^T and dP^T): two m64 x
//     128 accumulators spill beside the six-pair products.  A dQ block at
//     DP 256 takes 32 query rows the same way (Q's and dO's resident planes
//     for 64 rows would take 192 KB): a row of dS feeds only its own row of
//     dQ, so rows 32-63 reach no stored element.  Its key tiles of 16 make
//     S and dP of m64n16 wgmmas, far below the tensor cores' rate: that
//     instantiation is slow (PERF.md), and no main path runs it.
//   * Causal blocks skip the tiles above the diagonal and mask only the
//     tiles that cross it; the heaviest tiles are handed out first.  Each
//     output element has one writer: no atomics, deterministic results.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

// Selects the template width DP that serves head dim D: the least of 16,
// 32, 64, 128 and 256 not below D.  The kernels read columns D..DP-1 as
// zeros and write none of them.  A D that is not a multiple of 8 in
// [8, 256] is an invalid value.
#define HVD_DISPATCH_D(D, CALL)                                  \
  if ((D) < 8 || (D) > 256 || (D) % 8)                           \
    return (int)cudaErrorInvalidValue;                           \
  if ((D) <= 16) { constexpr int DP = 16; return CALL; }         \
  if ((D) <= 32) { constexpr int DP = 32; return CALL; }         \
  if ((D) <= 64) { constexpr int DP = 64; return CALL; }         \
  if ((D) <= 128) { constexpr int DP = 128; return CALL; }       \
  { constexpr int DP = 256; return CALL; }

namespace {

constexpr int STAGES = 2;        // depth of the producer's ring
constexpr int CONSUMER = 128;    // one consumer warpgroup
constexpr int NT = CONSUMER + 32;  // and one producer warp
constexpr int FQ = 64;           // forward: query rows per block
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Forward: key rows per tile.
template <int DP, bool F32IN> __host__ __device__ constexpr int fwd_keys() {
  if (F32IN) return DP > 128 ? 16 : DP > 32 ? 32 : 64;
  return DP > 128 ? 64 : 128;
}
// dQ: query rows per block and key rows per tile.
template <int DP, bool F32IN> __host__ __device__ constexpr int dq_rows() {
  return F32IN && DP > 128 ? 32 : 64;
}
template <int DP, bool F32IN> __host__ __device__ constexpr int dq_keys() {
  return F32IN ? fwd_keys<DP, true>() : 64;
}
// dK/dV: key rows per block, query rows per tile, and output columns per
// block.
template <int DP, bool F32IN> __host__ __device__ constexpr int dkv_keys() {
  return F32IN && DP > 128 ? 32 : 64;
}
template <int DP, bool F32DO, bool F32IN>
__host__ __device__ constexpr int dkv_rows() {
  if (F32IN) return DP > 64 ? 16 : 32;
  return F32DO && DP > 128 ? 32 : 64;
}
template <int DP, bool F32IN> __host__ __device__ constexpr int dkv_cols() {
  return DP > 128 ? (F32IN ? 64 : 128) : DP;
}

// The F32IN products: plane pairs (plane of a, plane of b; hi 0, mid 1,
// lo 2) whose magnitudes multiply to at least 2^-16 of a.b.  The dropped
// pairs (mid.lo, lo.mid, lo.lo) are under 2^-24 of it.
constexpr int NPAIRS = 6;
__host__ __device__ constexpr int pair_a(int i) {
  return i == 2 || i == 3 ? 1 : i == 5 ? 2 : 0;
}
__host__ __device__ constexpr int pair_b(int i) {
  return i == 1 || i == 3 ? 1 : i == 4 ? 2 : 0;
}
// The order in which dQ issues the pairs: the smallest (the lo and mid.mid
// products, about 2^-16 of a term) first and hi.hi last, so that the small
// terms are summed at their own scale before the large one joins them.  The
// tensor cores' fp32 accumulation keeps less of a small term added to a
// large sum: with hi.hi first, dQ's worst element at the flagship's width
// read 0.86 of the fp32 check's tolerance on an H100, in this order 0.16
// (PERF.md).
__host__ __device__ constexpr int dq_pair(int i) { return NPAIRS - 1 - i; }

// Shared-memory layout of a bf16 [rows, DP] tile: DP is cut into regions of
// CW columns (one swizzled row of SW bytes); region i holds columns
// [i CW, (i+1) CW) of every row, rows SW bytes apart, regions rows * SW
// bytes apart.  SW is 128 bytes at DP >= 64 (two regions at DP 128, four at
// 256), 64 at DP 32 and 32 at DP 16; TMA writes the same swizzle that wgmma
// reads.
template <int DP>
struct Tile {
  static constexpr int SW = DP >= 64 ? 128 : 2 * DP;
  static constexpr int CW = SW / 2;
  static constexpr int NR = DP / CW;
  static constexpr CUtensorMapSwizzle SWIZZLE =
      SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                : SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  __host__ __device__ static constexpr int bytes(int rows) { return rows * DP * 2; }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// --- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// --- TMA -------------------------------------------------------------------

// Copy rows [row0, row0 + rows) of the (b, h) slice, all DP columns, into a
// tile laid out as Tile<DP> describes; completes `rows * DP * 2` bytes on
// bar (columns past the map's D arrive as zeros and count all the same).
template <int DP>
__device__ __forceinline__ void tma_tile(uint8_t* dst, const CUtensorMap* map,
                                         uint64_t* bar, int rows, int row0,
                                         int b, int h) {
  using L = Tile<DP>;
#pragma unroll
  for (int r = 0; r < L::NR; ++r) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(
            smem_u32(dst + r * rows * L::SW)),
        "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(r * L::CW), "r"(h),
        "r"(row0), "r"(b)
        : "memory");
  }
}

// --- wgmma -----------------------------------------------------------------

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle mode of SW-byte rows.
template <int SW>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  constexpr uint64_t mode = SW == 128 ? 1 : SW == 64 ? 2 : 3;
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (mode << 62);
}

// K-major operand: rows [r0, r0 + 64 or N) of a [rows, DP] tile, columns
// [16 kk, 16 kk + 16) as the depth.  8-row groups are 8 SW bytes apart.
template <int DP>
__device__ __forceinline__ uint64_t desc_k(const uint8_t* tile, int rows,
                                           int r0, int kk) {
  using L = Tile<DP>;
  const int col = 16 * kk;
  return make_desc<L::SW>(
      smem_u32(tile + (col / L::CW) * rows * L::SW + r0 * L::SW +
               (col % L::CW) * 2),
      16, 8 * L::SW);
}

// MN-major operand B (transposed): rows [16 kk, 16 kk + 16) of a [rows, DP]
// tile as the depth and the columns from c0 (a multiple of CW) on as N;
// column regions are rows * SW bytes apart (the leading offset), 8-row
// groups 8 SW bytes (the stride).
template <int DP>
__device__ __forceinline__ uint64_t desc_mn(const uint8_t* tile, int rows,
                                            int kk, int c0) {
  using L = Tile<DP>;
  return make_desc<L::SW>(
      smem_u32(tile + (c0 / L::CW) * rows * L::SW + 16 * kk * L::SW),
      rows * L::SW, 8 * L::SW);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Keeps the compiler from moving reads or writes of wgmma operands across
// the asynchronous instructions that own them.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (m64 x N fp32 accumulator) += A (64 x 16, K-major smem) . B (N x 16,
// K-major smem)^T; `acc` 0 overwrites d.
template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int acc);
// d (m64 x N) += A (64 x 16, bf16 registers) . B (16 x N, MN-major smem).
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                         uint64_t db);

template <> __device__ __forceinline__ void
wgmma_ss<16>(float (&d)[8], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(acc));
}

template <> __device__ __forceinline__ void
wgmma_ss<32>(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

template <> __device__ __forceinline__ void
wgmma_ss<64>(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

template <> __device__ __forceinline__ void
wgmma_ss<128>(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

template <> __device__ __forceinline__ void
wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <> __device__ __forceinline__ void
wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <> __device__ __forceinline__ void
wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <> __device__ __forceinline__ void
wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Columns [16 kk, 16 kk + 16) of an m64 accumulator, rounded to bf16, as
// the A fragment of a register-A wgmma: the two layouts coincide.
template <int NR>
__device__ __forceinline__ void a_frag(const float (&d)[NR], int kk,
                                       uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = pack_bf16(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

// The same columns as two A fragments, hi = bf16(x) and lo = bf16(x - hi):
// hi + lo holds x to about 2^-17 of it.
template <int NR>
__device__ __forceinline__ void a_frag_split(const float (&d)[NR], int kk,
                                             uint32_t (&hi)[4],
                                             uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x0 = d[8 * kk + 2 * i], x1 = d[8 * kk + 2 * i + 1];
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i] = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
  }
}

// The same columns as three A fragments (F32IN): hi = bf16(x), mid =
// bf16(x - hi) and lo = bf16(x - hi - mid), each difference exact in fp32;
// their sum holds x to about 2^-24 of it.
template <int NR>
__device__ __forceinline__ void a_frag_split3(const float (&d)[NR], int kk,
                                              uint32_t (&f)[3][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x0 = d[8 * kk + 2 * i], x1 = d[8 * kk + 2 * i + 1];
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float r0 = x0 - __low2float(h), r1 = x1 - __high2float(h);
    const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
    f[0][i] = *reinterpret_cast<const uint32_t*>(&h);
    f[1][i] = *reinterpret_cast<const uint32_t*>(&m);
    f[2][i] = pack_bf16(r0 - __low2float(m), r1 - __high2float(m));
  }
}

// d (m64 x N) += A . B, B the columns [c0, c0 + N) of a [rows, DP] tile read
// MN-major with rows [16 kk, 16 kk + 16) as the depth.  N over 128 runs as
// 128-column wgmmas: n128 accumulators side by side are the wider one.
template <int DP, int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4],
                                       const uint8_t* tile, int rows, int kk,
                                       int c0) {
  if constexpr (N <= 128) {
    wgmma_rs<N>(d, a, desc_mn<DP>(tile, rows, kk, c0));
  } else {
#pragma unroll
    for (int n = 0; n < N / 128; ++n)
      wgmma_rs<128>(*reinterpret_cast<float(*)[64]>(d + 64 * n), a,
                    desc_mn<DP>(tile, rows, kk, c0 + 128 * n));
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return (uint8_t*)(((uintptr_t)p + 1023) & ~(uintptr_t)1023);
}

// In an m64 x N accumulator, thread t of the warpgroup holds rows
// 16 (t / 32) + (t % 32) / 4 and 8 below it, and of each 8-column chunk j
// the columns 8 j + 2 (t % 4) + {0, 1}: d[4 j + e] is row + 8 (e / 2),
// column 8 j + 2 (t % 4) + e % 2.  Outputs have D columns (a multiple of
// 8), so a chunk is stored whole or not at all.

// The tensor maps of a kernel's operands, one per plane: hi first; F32IN
// also mid and lo; F32DO dO's lo second.  Entries a kernel does not read
// repeat the hi map.
struct Maps {
  CUtensorMap q[3], k[3], v[3], dout[3];
};

// Load planes [0, NPL) of rows [row0, row0 + rows) into consecutive tiles
// from dst, completing on bar.
template <int DP, int NPL>
__device__ __forceinline__ void tma_planes(uint8_t* dst,
                                           const CUtensorMap (&map)[3],
                                           uint64_t* bar, int rows, int row0,
                                           int b, int h) {
#pragma unroll
  for (int pl = 0; pl < NPL; ++pl)
    tma_tile<DP>(dst + pl * Tile<DP>::bytes(rows), &map[pl], bar, rows, row0,
                 b, h);
}

// Forward.  One block per (64-row query tile, b*h); the consumer warpgroup
// walks key tiles of FK up to the causal limit with the online softmax in
// registers (m and l per row, in log2 units), and writes o and lse.  F32IN:
// Q, K and V arrive as three planes each, P splits into three, and the
// output is fp32.
template <typename TO, int DP, bool F32IN>
__global__ void __launch_bounds__(NT, DP >= 128 ? 1 : 2)
fwd_wgmma_kernel(const __grid_constant__ Maps maps, TO* __restrict__ o,
                 float* __restrict__ lse, int H, int S, int D, float scale,
                 int causal) {
  using L = Tile<DP>;
  constexpr int FK = fwd_keys<DP, F32IN>();
  constexpr int NPI = F32IN ? 3 : 1;  // planes of q, k and v
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align1024(smem_raw);               // [NPI][FQ, DP]
  uint8_t* Ks = Qs + NPI * L::bytes(FQ);           // [STAGES][NPI][FK, DP]
  uint8_t* Vs = Ks + STAGES * NPI * L::bytes(FK);  // [STAGES][NPI][FK, DP]
  uint64_t* q_full = (uint64_t*)(Vs + STAGES * NPI * L::bytes(FK));
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * FQ;  // heaviest tiles first
  const int k_end = causal ? min(S, q0 + FQ) : S;
  const int n_tiles = (k_end + FK - 1) / FK;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], CONSUMER);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMER) {  // producer warp: one lane issues every copy
    if (tid == CONSUMER) {
      mbar_expect_tx(q_full, NPI * L::bytes(FQ));
      tma_planes<DP, NPI>(Qs, maps.q, q_full, FQ, q0, b, h);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % STAGES;
        if (t >= STAGES) mbar_wait(&empty[st], ((t / STAGES) - 1) & 1);
        mbar_expect_tx(&k_full[st], NPI * L::bytes(FK));
        tma_planes<DP, NPI>(Ks + st * NPI * L::bytes(FK), maps.k, &k_full[st],
                            FK, t * FK, b, h);
        mbar_expect_tx(&v_full[st], NPI * L::bytes(FK));
        tma_planes<DP, NPI>(Vs + st * NPI * L::bytes(FK), maps.v, &v_full[st],
                            FK, t * FK, b, h);
      }
    }
    return;
  }

  const int lane = tid & 31, quad = lane & 3;
  const int row0 = q0 + 16 * (tid >> 5) + (lane >> 2);  // and row0 + 8
  const float sl2 = scale * LOG2E;
  float oacc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) oacc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % STAGES;
    const uint32_t ph = (t / STAGES) & 1;
    const int k0 = t * FK;
    const uint8_t* Kt = Ks + st * NPI * L::bytes(FK);  // its planes in turn
    const uint8_t* Vt = Vs + st * NPI * L::bytes(FK);

    // S = Q K^T for this key tile (F32IN: over the plane pairs).
    float s[FK / 2];
    mbar_wait(&k_full[st], ph);
    wg_fence();
    if constexpr (F32IN) {
#pragma unroll
      for (int pr = 0; pr < NPAIRS; ++pr)
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          wgmma_ss<FK>(s, desc_k<DP>(Qs + pair_a(pr) * L::bytes(FQ), FQ, 0, kk),
                       desc_k<DP>(Kt + pair_b(pr) * L::bytes(FK), FK, 0, kk),
                       pr + kk);
    } else {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss<FK>(s, desc_k<DP>(Qs, FQ, 0, kk), desc_k<DP>(Kt, FK, 0, kk), kk);
    }
    wg_commit();
    wg_wait();
    reg_fence(s);

    // Scores in log2 units; the mask only where the tile crosses S or the
    // causal diagonal.
    const bool edge = k0 + FK > S || (causal && k0 + FK - 1 > q0);
#pragma unroll
    for (int j = 0; j < FK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e] * sl2;
        if (edge) {
          const int col = k0 + 8 * j + 2 * quad + (e & 1);
          const int row = row0 + 8 * (e >> 1);
          if (col >= S || (causal && col > row)) x = -INFINITY;
        }
        s[4 * j + e] = x;
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < FK / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
      mx = quad_max(mx);  // finite: key 0 (causal) or some key < S is visible
      corr[i] = exp2f(m[i] - mx);
      m[i] = mx;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int j = 0; j < FK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[4 * j + e] - m[e >> 1]);
        l[e >> 1] += p;  // this thread's share of the row sum, unrounded P
        s[4 * j + e] = p;
      }
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      oacc[4 * j] *= corr[0];
      oacc[4 * j + 1] *= corr[0];
      oacc[4 * j + 2] *= corr[1];
      oacc[4 * j + 3] *= corr[1];
    }

    // O += bf16(P) V, P straight from the registers (F32IN: P split into
    // three, over the plane pairs).
    if constexpr (F32IN) {
      uint32_t pf[FK / 16][3][4];
#pragma unroll
      for (int kk = 0; kk < FK / 16; ++kk) a_frag_split3(s, kk, pf[kk]);
      mbar_wait(&v_full[st], ph);
      wg_fence();
#pragma unroll
      for (int pr = 0; pr < NPAIRS; ++pr)
#pragma unroll
        for (int kk = 0; kk < FK / 16; ++kk)
          mma_rs<DP, DP>(oacc, pf[kk][pair_a(pr)],
                         Vt + pair_b(pr) * L::bytes(FK), FK, kk, 0);
    } else {
      uint32_t pa[FK / 16][4];
#pragma unroll
      for (int kk = 0; kk < FK / 16; ++kk) a_frag(s, kk, pa[kk]);
      mbar_wait(&v_full[st], ph);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < FK / 16; ++kk)
        mma_rs<DP, DP>(oacc, pa[kk], Vt, FK, kk, 0);
    }
    wg_commit();
    wg_wait();
    reg_fence(oacc);
    mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s_row = row0 + 8 * i;
    const float li = quad_sum(l[i]);
    if (s_row >= S) continue;
    const long long row = ((long long)b * S + s_row) * H + h;
    const float inv = 1.f / li;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      if (8 * j < D)
        store2(o + row * D + 8 * j + 2 * quad, oacc[4 * j + 2 * i] * inv,
               oacc[4 * j + 2 * i + 1] * inv);
    if (quad == 0) lse[row] = m[i] * LN2 + logf(li);
  }
}

// dK/dV in the transposed form.  One block per (BK-row key tile, b*h, NC
// output columns from c0); K and V stay in shared memory while the producer
// streams the query tiles from the causal start (Q and dO, or dO's planes,
// by TMA; lse and delta - dlse by the producer's lanes).  Per tile:
// S^T = K Q^T and dP^T = V dO^T by wgmma, P^T = exp(S^T scale - lse) and
// dS^T = P^T (dP^T - delta + dlse) in registers, dV += bf16(P^T) dO
// (F32DO: P^T split, three products) and dK += bf16(dS^T) Q by register-A
// wgmma.  F32IN: K, V, Q and dO arrive as three planes each, P^T and dS^T
// split into three, every product runs over the plane pairs, and dK and dV
// are fp32.
template <int DP, bool F32DO, bool F32IN>
__global__ void __launch_bounds__(NT, DP >= 128 ? 1 : 2)
dkv_wgmma_kernel(const __grid_constant__ Maps maps,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const float* __restrict__ dlse,
                 std::conditional_t<F32IN, float, __nv_bfloat16>* __restrict__ dk,
                 std::conditional_t<F32IN, float, __nv_bfloat16>* __restrict__ dv,
                 int H, int S, int D, float scale, int causal) {
  static_assert(F32DO || !F32IN, "fp32 q/k/v come with an fp32 dO");
  using L = Tile<DP>;
  constexpr int BK = dkv_keys<DP, F32IN>(), BQ = dkv_rows<DP, F32DO, F32IN>();
  constexpr int NC = dkv_cols<DP, F32IN>();
  constexpr int NPI = F32IN ? 3 : 1;            // planes of q, k and v
  constexpr int NP = F32IN ? 3 : F32DO ? 2 : 1;  // planes of dO
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Ks = align1024(smem_raw);                // [NPI][BK, DP]
  uint8_t* Vs = Ks + NPI * L::bytes(BK);            // [NPI][BK, DP]
  uint8_t* Qs = Vs + NPI * L::bytes(BK);            // [STAGES][NPI][BQ, DP]
  uint8_t* dOs = Qs + STAGES * NPI * L::bytes(BQ);  // [STAGES][NP][BQ, DP]
  float* stats = (float*)(dOs + STAGES * NP * L::bytes(BQ));  // [STAGES][2][BQ]
  uint64_t* kv_full = (uint64_t*)(stats + STAGES * 2 * BQ);
  uint64_t* q_full = kv_full + 1;
  uint64_t* empty = q_full + STAGES;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * BK;  // causal: low key tiles carry the most work
  const int c0 = blockIdx.z * NC;
  const int q_start = causal ? k0 : 0;
  const int n_tiles = (S - q_start + BQ - 1) / BQ;

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&q_full[s], 32);  // every producer lane stores stats
      mbar_init(&empty[s], CONSUMER);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMER) {  // producer warp
    const int lane = tid - CONSUMER;
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * NPI * L::bytes(BK));
      tma_planes<DP, NPI>(Ks, maps.k, kv_full, BK, k0, b, h);
      tma_planes<DP, NPI>(Vs, maps.v, kv_full, BK, k0, b, h);
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % STAGES, q0 = q_start + t * BQ;
      if (t >= STAGES) mbar_wait(&empty[st], ((t / STAGES) - 1) & 1);
      // Rows past S get lse = +inf (P = 0) and delta - dlse = 0.
      float* lse_s = stats + st * 2 * BQ;
      for (int r = lane; r < BQ; r += 32) {
        const int s_row = q0 + r;
        float ls = INFINITY, dd = 0.f;
        if (s_row < S) {
          const long long row = ((long long)b * S + s_row) * H + h;
          ls = lse[row] * LOG2E;
          dd = delta[row] - (dlse ? dlse[row] : 0.f);
        }
        lse_s[r] = ls;
        lse_s[BQ + r] = dd;
      }
      if (lane == 0) {
        mbar_expect_tx(&q_full[st], (NPI + NP) * L::bytes(BQ));
        tma_planes<DP, NPI>(Qs + st * NPI * L::bytes(BQ), maps.q, &q_full[st],
                            BQ, q0, b, h);
        tma_planes<DP, NP>(dOs + st * NP * L::bytes(BQ), maps.dout,
                           &q_full[st], BQ, q0, b, h);
      } else {
        mbar_arrive(&q_full[st]);
      }
    }
    return;
  }

  const int lane = tid & 31, quad = lane & 3;
  const int krow = 16 * (tid >> 5) + (lane >> 2);  // key row in the tile, and +8
  const float sl2 = scale * LOG2E;
  float dkacc[NC / 2], dvacc[NC / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) dkacc[i] = dvacc[i] = 0.f;

  mbar_wait(kv_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % STAGES, q0 = q_start + t * BQ;
    const uint32_t ph = (t / STAGES) & 1;
    const uint8_t* Qt = Qs + st * NPI * L::bytes(BQ);   // its planes in turn
    const uint8_t* dOt = dOs + st * NP * L::bytes(BQ);  // hi, then mid or lo
    const float* lse_s = stats + st * 2 * BQ;
    const float* dd_s = lse_s + BQ;

    float s[BQ / 2], dp[BQ / 2];
    mbar_wait(&q_full[st], ph);
    wg_fence();
    if constexpr (F32IN) {
      // A loop over the pairs at DP 256, where the unrolled pairs' K and V
      // descriptors, hoisted out of the tile loop, spill.
#pragma unroll (DP > 128 ? 1 : NPAIRS)
      for (int pr = 0; pr < NPAIRS; ++pr)
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          wgmma_ss<BQ>(s, desc_k<DP>(Ks + pair_a(pr) * L::bytes(BK), BK, 0, kk),
                       desc_k<DP>(Qt + pair_b(pr) * L::bytes(BQ), BQ, 0, kk),
                       pr + kk);
          wgmma_ss<BQ>(dp, desc_k<DP>(Vs + pair_a(pr) * L::bytes(BK), BK, 0, kk),
                       desc_k<DP>(dOt + pair_b(pr) * L::bytes(BQ), BQ, 0, kk),
                       pr + kk);
        }
    } else {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss<BQ>(s, desc_k<DP>(Ks, BK, 0, kk), desc_k<DP>(Qt, BQ, 0, kk), kk);
#pragma unroll
      for (int pn = 0; pn < NP; ++pn)
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          wgmma_ss<BQ>(dp, desc_k<DP>(Vs, BK, 0, kk),
                       desc_k<DP>(dOt + pn * L::bytes(BQ), BQ, 0, kk), pn + kk);
    }
    wg_commit();
    wg_wait();
    reg_fence(s);
    reg_fence(dp);

    // Key row r, query column c: mask where the query precedes the key.
    const bool diag = causal && q0 < k0 + BK - 1;
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * quad + (e & 1);
        float p = exp2f(s[4 * j + e] * sl2 - lse_s[c]);
        if (diag && q0 + c < k0 + krow + 8 * (e >> 1)) p = 0.f;
        dp[4 * j + e] = p * (dp[4 * j + e] - dd_s[c]);
        s[4 * j + e] = p;
      }

    if constexpr (F32IN) {
      uint32_t pf[BQ / 16][3][4], df[BQ / 16][3][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        a_frag_split3(s, kk, pf[kk]);
        a_frag_split3(dp, kk, df[kk]);
      }
      wg_fence();
#pragma unroll
      for (int pr = 0; pr < NPAIRS; ++pr)
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          mma_rs<DP, NC>(dvacc, pf[kk][pair_a(pr)],
                         dOt + pair_b(pr) * L::bytes(BQ), BQ, kk, c0);
          mma_rs<DP, NC>(dkacc, df[kk][pair_a(pr)],
                         Qt + pair_b(pr) * L::bytes(BQ), BQ, kk, c0);
        }
    } else {
      uint32_t pa[BQ / 16][4], plo[F32DO ? BQ / 16 : 1][4], da[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        if constexpr (F32DO)
          a_frag_split(s, kk, pa[kk], plo[kk]);
        else
          a_frag(s, kk, pa[kk]);
        a_frag(dp, kk, da[kk]);
      }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        mma_rs<DP, NC>(dvacc, pa[kk], dOt, BQ, kk, c0);
      if constexpr (F32DO) {
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          mma_rs<DP, NC>(dvacc, plo[kk], dOt, BQ, kk, c0);
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          mma_rs<DP, NC>(dvacc, pa[kk], dOt + L::bytes(BQ), BQ, kk, c0);
      }
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        mma_rs<DP, NC>(dkacc, da[kk], Qt, BQ, kk, c0);
    }
    wg_commit();
    wg_wait();
    reg_fence(dvacc);
    reg_fence(dkacc);
    mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s_row = k0 + krow + 8 * i;
    // Rows from BK on (BK 32) are the next key tile's: not this block's.
    if ((BK < 64 && krow + 8 * i >= BK) || s_row >= S) continue;
    const long long row = ((long long)b * S + s_row) * H + h;
#pragma unroll
    for (int j = 0; j < NC / 8; ++j) {
      const int c = c0 + 8 * j + 2 * quad;
      if (c0 + 8 * j >= D) continue;
      store2(dk + row * D + c, dkacc[4 * j + 2 * i] * scale,
             dkacc[4 * j + 2 * i + 1] * scale);
      store2(dv + row * D + c, dvacc[4 * j + 2 * i], dvacc[4 * j + 2 * i + 1]);
    }
  }
}

// dQ.  One block per (BQ-row query tile, b*h), the forward's shape: Q and
// dO (or their planes) stay in shared memory while the producer streams K
// and V tiles up to the causal limit.  Per tile: S = Q K^T and dP = dO V^T
// (F32DO: hi V^T + lo V^T) by wgmma, P = exp(S scale - lse) and dS = P (dP -
// delta + dlse) in registers, and dQ += bf16(dS) K by register-A wgmma
// against K read MN-major (as the forward reads V).  A thread's two query
// rows keep their lse and delta - dlse in registers, read once.  F32IN: Q,
// K, V and dO arrive as three planes each, dS splits into three, every
// product runs over the plane pairs, and dQ is fp32.
template <int DP, bool F32DO, bool F32IN>
__global__ void __launch_bounds__(NT, DP >= 128 ? 1 : 2)
dq_wgmma_kernel(const __grid_constant__ Maps maps,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const float* __restrict__ dlse,
                std::conditional_t<F32IN, float, __nv_bfloat16>* __restrict__ dq,
                int H, int S, int D, float scale, int causal) {
  static_assert(F32DO || !F32IN, "fp32 q/k/v come with an fp32 dO");
  using L = Tile<DP>;
  constexpr int BQ = dq_rows<DP, F32IN>(), BK = dq_keys<DP, F32IN>();
  constexpr int NPI = F32IN ? 3 : 1;            // planes of q, k and v
  constexpr int NP = F32IN ? 3 : F32DO ? 2 : 1;  // planes of dO
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align1024(smem_raw);               // [NPI][BQ, DP]
  uint8_t* dOs = Qs + NPI * L::bytes(BQ);          // [NP][BQ, DP]
  uint8_t* Ks = dOs + NP * L::bytes(BQ);           // [STAGES][NPI][BK, DP]
  uint8_t* Vs = Ks + STAGES * NPI * L::bytes(BK);  // [STAGES][NPI][BK, DP]
  uint64_t* q_full = (uint64_t*)(Vs + STAGES * NPI * L::bytes(BK));
  uint64_t* kv_full = q_full + 1;
  uint64_t* empty = kv_full + STAGES;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tiles first
  const int k_end = causal ? min(S, q0 + BQ) : S;
  const int n_tiles = (k_end + BK - 1) / BK;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&empty[s], CONSUMER);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMER) {  // producer warp: one lane issues every copy
    if (tid == CONSUMER) {
      mbar_expect_tx(q_full, (NPI + NP) * L::bytes(BQ));
      tma_planes<DP, NPI>(Qs, maps.q, q_full, BQ, q0, b, h);
      tma_planes<DP, NP>(dOs, maps.dout, q_full, BQ, q0, b, h);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % STAGES;
        if (t >= STAGES) mbar_wait(&empty[st], ((t / STAGES) - 1) & 1);
        mbar_expect_tx(&kv_full[st], 2 * NPI * L::bytes(BK));
        tma_planes<DP, NPI>(Ks + st * NPI * L::bytes(BK), maps.k, &kv_full[st],
                            BK, t * BK, b, h);
        tma_planes<DP, NPI>(Vs + st * NPI * L::bytes(BK), maps.v, &kv_full[st],
                            BK, t * BK, b, h);
      }
    }
    return;
  }

  const int lane = tid & 31, quad = lane & 3;
  const int qrow = 16 * (tid >> 5) + (lane >> 2);  // row in the block, and +8
  const int row0 = q0 + qrow;
  const float sl2 = scale * LOG2E;
  // Rows past S get lse = +inf (P = 0) and delta - dlse = 0.
  float lse2[2], dd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s_row = row0 + 8 * i;
    lse2[i] = INFINITY;
    dd[i] = 0.f;
    if (s_row < S) {
      const long long row = ((long long)b * S + s_row) * H + h;
      lse2[i] = lse[row] * LOG2E;
      dd[i] = delta[row] - (dlse ? dlse[row] : 0.f);
    }
  }
  float dqacc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dqacc[i] = 0.f;

  mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % STAGES;
    const uint32_t ph = (t / STAGES) & 1;
    const int k0 = t * BK;
    const uint8_t* Kt = Ks + st * NPI * L::bytes(BK);  // its planes in turn
    const uint8_t* Vt = Vs + st * NPI * L::bytes(BK);

    float s[BK / 2], dp[BK / 2];
    mbar_wait(&kv_full[st], ph);
    wg_fence();
    if constexpr (F32IN) {
      // The pairs smallest first (see dq_pair), in a loop at DP 256 as in
      // dK/dV.
#pragma unroll (DP > 128 ? 1 : NPAIRS)
      for (int i = 0; i < NPAIRS; ++i) {
        const int pr = dq_pair(i);
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          wgmma_ss<BK>(s, desc_k<DP>(Qs + pair_a(pr) * L::bytes(BQ), BQ, 0, kk),
                       desc_k<DP>(Kt + pair_b(pr) * L::bytes(BK), BK, 0, kk),
                       i + kk);
          wgmma_ss<BK>(dp, desc_k<DP>(dOs + pair_a(pr) * L::bytes(BQ), BQ, 0, kk),
                       desc_k<DP>(Vt + pair_b(pr) * L::bytes(BK), BK, 0, kk),
                       i + kk);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss<BK>(s, desc_k<DP>(Qs, BQ, 0, kk), desc_k<DP>(Kt, BK, 0, kk), kk);
#pragma unroll
      for (int pn = 0; pn < NP; ++pn)
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          wgmma_ss<BK>(dp, desc_k<DP>(dOs + pn * L::bytes(BQ), BQ, 0, kk),
                       desc_k<DP>(Vt, BK, 0, kk), pn + kk);
    }
    wg_commit();
    wg_wait();
    reg_fence(s);
    reg_fence(dp);

    // The mask only where the tile crosses S or the causal diagonal.  Keys
    // past S are zero rows, but exp(0 - lse) may overflow, and inf * 0 is
    // NaN: they are masked, not left to the zeros.
    const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[4 * j + e] * sl2 - lse2[e >> 1]);
        if (edge) {
          const int col = k0 + 8 * j + 2 * quad + (e & 1);
          const int row = row0 + 8 * (e >> 1);
          if (col >= S || (causal && col > row)) p = 0.f;
        }
        dp[4 * j + e] = p * (dp[4 * j + e] - dd[e >> 1]);
      }

    // dQ += bf16(dS) K, dS straight from the registers (F32IN: dS split
    // into three, over the plane pairs).
    if constexpr (F32IN) {
      uint32_t df[BK / 16][3][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) a_frag_split3(dp, kk, df[kk]);
      wg_fence();
#pragma unroll
      for (int i = 0; i < NPAIRS; ++i) {
        const int pr = dq_pair(i);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          mma_rs<DP, DP>(dqacc, df[kk][pair_a(pr)],
                         Kt + pair_b(pr) * L::bytes(BK), BK, kk, 0);
      }
    } else {
      uint32_t da[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) a_frag(dp, kk, da[kk]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        mma_rs<DP, DP>(dqacc, da[kk], Kt, BK, kk, 0);
    }
    wg_commit();
    wg_wait();
    reg_fence(dqacc);
    mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s_row = row0 + 8 * i;
    // Rows from BQ on (BQ 32) are the next query tile's: not this block's.
    if ((BQ < 64 && qrow + 8 * i >= BQ) || s_row >= S) continue;
    const long long row = ((long long)b * S + s_row) * H + h;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      if (8 * j < D)
        store2(dq + row * D + 8 * j + 2 * quad, dqacc[4 * j + 2 * i] * scale,
               dqacc[4 * j + 2 * i + 1] * scale);
  }
}

// The bf16 planes of fp32 tensors for the F32DO and F32IN kernels: plane 0
// is bf16(x), and each further plane the bf16 rounding of what the planes
// before it leave of x (each difference exact in fp32): NPL 2 gives hi and
// lo (about 2^-17 of x left), NPL 3 hi, mid and lo (about 2^-24).
// Elementwise.  Input t (blockIdx.y) is a [B, S, H, D] view with (b, s, h)
// element strides st[t] and d contiguous, its base and strides 16-byte
// aligned; its planes go to out[NPL t + p], each a contiguous [B, S, H, D]
// of n4 groups of four.  Bound by its bytes (4 in, 2 NPL out per element):
// float4 loads, one group a thread.
constexpr int SPLIT_MAX = 3;  // q, k and v
struct SplitIn {
  const float* x[SPLIT_MAX];
  long long st[SPLIT_MAX][3];
};

template <int NPL>
__global__ void __launch_bounds__(256)
split_kernel(const SplitIn in, int S, int H, int D4, int n4,
             uint2* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  // This block's input, chosen without indexing the parameter by a
  // run-time value (which would copy it to local memory).
  const int t = blockIdx.y;
  const float* x = in.x[0];
  long long sb = in.st[0][0], ss = in.st[0][1], sh = in.st[0][2];
#pragma unroll
  for (int j = 1; j < SPLIT_MAX; ++j)
    if (t == j) {
      x = in.x[j];
      sb = in.st[j][0];
      ss = in.st[j][1];
      sh = in.st[j][2];
    }
  int r = i / D4;
  const int d = 4 * (i - r * D4);
  const int h = r % H;
  r /= H;
  const int s = r % S, b = r / S;
  float4 v = *reinterpret_cast<const float4*>(x + b * sb + s * ss + h * sh + d);
  uint2* plane = out + (long long)NPL * t * n4 + i;
#pragma unroll
  for (int p = 0; p < NPL; ++p, plane += n4) {
    const __nv_bfloat162 h01 = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 h23 = __floats2bfloat162_rn(v.z, v.w);
    *plane = make_uint2(*reinterpret_cast<const uint32_t*>(&h01),
                        *reinterpret_cast<const uint32_t*>(&h23));
    v = make_float4(v.x - __low2float(h01), v.y - __high2float(h01),
                    v.z - __low2float(h23), v.w - __high2float(h23));
  }
}

// --- host side -------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime's entry point
// (no link against libcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = (EncodeTiled)p;
  }
  return fn;
}

// A 4-D map (d, h, s, b) over a bf16 [B, S, H, D] view with element
// strides st = (b, s, h), boxes of `rows` rows and one column region of
// Tile<DP>.  Its extent in d is the real D: TMA fills the columns from D to
// DP with zeros.
template <int DP>
int make_map(CUtensorMap* map, const void* ptr, const long long* st, int B,
             int S, int H, int D, int rows) {
  using L = Tile<DP>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)L::CW, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                            const_cast<void*>(ptr), dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, L::SWIZZLE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The maps of an operand's planes: ptr[0] (its hi plane, or the tensor)
// with element strides st, and ptr[1..np) of the same layout; entries from
// np on repeat the hi map, unread.
template <int DP>
int make_planes(CUtensorMap (&m)[3], const void* const* ptr, int np,
                const long long* st, int B, int S, int H, int D, int rows) {
  for (int pl = 0; pl < 3; ++pl) {
    if (pl >= np) {
      m[pl] = m[0];
      continue;
    }
    int err = make_map<DP>(&m[pl], ptr[pl], st, B, S, H, D, rows);
    if (err) return err;
  }
  return 0;
}

// The maps of q, k and v (element strides st, st + 3, st + 6), with q_rows
// and k_rows rows a box; lo: null, or their mid and lo planes (F32IN), as
// {q mid, q lo, k mid, k lo, v mid, v lo}.
template <int DP>
int make_qkv_maps(Maps& maps, const void* q, const void* k, const void* v,
                  const void* const* lo, const long long* st, int B, int S,
                  int H, int D, int q_rows, int k_rows) {
  CUtensorMap* dst[3] = {maps.q, maps.k, maps.v};
  const void* hi[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const void* ptr[3] = {hi[i], lo ? lo[2 * i] : nullptr,
                          lo ? lo[2 * i + 1] : nullptr};
    CUtensorMap m[3];
    int err = make_planes<DP>(m, ptr, lo ? 3 : 1, st + 3 * i, B, S, H, D,
                              i == 0 ? q_rows : k_rows);
    if (err) return err;
    for (int pl = 0; pl < 3; ++pl) dst[i][pl] = m[pl];
  }
  return 0;
}

constexpr size_t BARRIER_BYTES = 64;

template <typename TO, int DP, bool F32IN>
int launch_fwd(const void* q, const void* k, const void* v,
               const void* const* lo, void* o, void* lse, const long long* st,
               int B, int S, int H, int D, float scale, int causal,
               cudaStream_t stream) {
  using L = Tile<DP>;
  constexpr int FK = fwd_keys<DP, F32IN>();
  constexpr int NPI = F32IN ? 3 : 1;
  Maps maps;
  int err = make_qkv_maps<DP>(maps, q, k, v, lo, st, B, S, H, D, FQ, FK);
  if (err) return err;
  for (int pl = 0; pl < 3; ++pl) maps.dout[pl] = maps.q[0];
  const size_t smem =
      1024 + NPI * (L::bytes(FQ) + 2 * STAGES * L::bytes(FK)) + BARRIER_BYTES;
  auto kernel = fwd_wgmma_kernel<TO, DP, F32IN>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * H, (S + FQ - 1) / FQ);
  kernel<<<grid, NT, smem, stream>>>(maps, (TO*)o, (float*)lse, H, S, D,
                                     scale, causal);
  return (int)cudaGetLastError();
}

// The maps of the backward kernels' operands: q, k and v as make_qkv_maps
// makes them, and dO's planes: dout (hi), and dout_lo (F32DO: its lo
// plane), or lo[6] and lo[7] (F32IN: its mid and lo planes), with q_rows
// rows a box.
template <int DP, bool F32DO, bool F32IN>
int make_bwd_maps(Maps& maps, const void* q, const void* k, const void* v,
                  const void* const* lo, const void* dout,
                  const void* dout_lo, const long long* st, int B, int S,
                  int H, int D, int q_rows, int k_rows) {
  constexpr int NP = F32IN ? 3 : F32DO ? 2 : 1;
  int err = make_qkv_maps<DP>(maps, q, k, v, lo, st, B, S, H, D, q_rows,
                              k_rows);
  if (err) return err;
  const void* dptr[3] = {dout, F32IN ? lo[6] : dout_lo,
                         F32IN ? lo[7] : nullptr};
  return make_planes<DP>(maps.dout, dptr, NP, st + 9, B, S, H, D, q_rows);
}

template <int DP, bool F32DO, bool F32IN>
int launch_dkv(const void* q, const void* k, const void* v,
               const void* const* lo, const void* dout, const void* dout_lo,
               const void* lse, const void* delta, const void* dlse, void* dk,
               void* dv, const long long* st, int B, int S, int H, int D,
               float scale, int causal, cudaStream_t stream) {
  using L = Tile<DP>;
  using TG = std::conditional_t<F32IN, float, __nv_bfloat16>;
  constexpr int BK = dkv_keys<DP, F32IN>(), BQ = dkv_rows<DP, F32DO, F32IN>();
  constexpr int NC = dkv_cols<DP, F32IN>();
  constexpr int NPI = F32IN ? 3 : 1, NP = F32IN ? 3 : F32DO ? 2 : 1;
  Maps maps;
  int err = make_bwd_maps<DP, F32DO, F32IN>(maps, q, k, v, lo, dout, dout_lo,
                                            st, B, S, H, D, BQ, BK);
  if (err) return err;
  const size_t smem = 1024 + 2 * NPI * L::bytes(BK) +
                      (NPI + NP) * STAGES * L::bytes(BQ) +
                      STAGES * 2 * BQ * sizeof(float) + BARRIER_BYTES;
  auto kernel = dkv_wgmma_kernel<DP, F32DO, F32IN>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * H, (S + BK - 1) / BK, DP / NC);
  kernel<<<grid, NT, smem, stream>>>(maps, (const float*)lse,
                                     (const float*)delta, (const float*)dlse,
                                     (TG*)dk, (TG*)dv, H, S, D, scale, causal);
  return (int)cudaGetLastError();
}

template <int DP, bool F32DO, bool F32IN>
int launch_dq(const void* q, const void* k, const void* v,
              const void* const* lo, const void* dout, const void* dout_lo,
              const void* lse, const void* delta, const void* dlse, void* dq,
              const long long* st, int B, int S, int H, int D, float scale,
              int causal, cudaStream_t stream) {
  using L = Tile<DP>;
  using TG = std::conditional_t<F32IN, float, __nv_bfloat16>;
  constexpr int BQ = dq_rows<DP, F32IN>(), BK = dq_keys<DP, F32IN>();
  constexpr int NPI = F32IN ? 3 : 1, NP = F32IN ? 3 : F32DO ? 2 : 1;
  Maps maps;
  int err = make_bwd_maps<DP, F32DO, F32IN>(maps, q, k, v, lo, dout, dout_lo,
                                            st, B, S, H, D, BQ, BK);
  if (err) return err;
  const size_t smem = 1024 + (NPI + NP) * L::bytes(BQ) +
                      2 * STAGES * NPI * L::bytes(BK) + BARRIER_BYTES;
  auto kernel = dq_wgmma_kernel<DP, F32DO, F32IN>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * H, (S + BQ - 1) / BQ);
  kernel<<<grid, NT, smem, stream>>>(maps, (const float*)lse,
                                     (const float*)delta, (const float*)dlse,
                                     (TG*)dq, H, S, D, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// The C entry points.  dtype: 0 = float32, 1 = bfloat16, for q/k/v and the
// outputs.  float32 q/k/v (and dO) reach the kernels as three bf16 planes
// each (from hvd_flash_split): q, k, v (and dout) are then the hi planes,
// and lo the array of the lower planes, {q mid, q lo, k mid, k lo, v mid,
// v lo} (and dO mid, dO lo in the backward); with bfloat16 q/k/v lo is
// null, and dout_lo is the lo plane of the lse variant's float32 dO (dout
// its hi plane) or null for a bfloat16 dO.  strides: host array of (b, s,
// h) element strides for q, k, v (and dO, or its planes, in the backward);
// a lower plane has its hi plane's strides.  D: the head dim, a multiple of
// 8 up to 256.  Each returns a cudaError_t: cudaGetLastError() after the
// launch (0 on success), or cudaErrorInvalidValue where the arguments name
// no instantiation or the tensor map cannot describe the input (a base or
// a (b, s, h) stride that is not a multiple of 16 bytes).
extern "C" {

int hvd_flash_fwd(const void* q, const void* k, const void* v,
                  const void* const* lo, void* o, void* lse,
                  const long long* strides, int B, int S, int H, int D,
                  float scale, int causal, int dtype, int out_f32,
                  void* stream) {
  if ((dtype != 0 && dtype != 1) || (dtype == 0) != (lo != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (lo) {
    HVD_DISPATCH_D(D, (launch_fwd<float, DP, true>(q, k, v, lo, o, lse, strides, B, S, H, D, scale, causal, st)))
  }
  if (out_f32) {
    HVD_DISPATCH_D(D, (launch_fwd<float, DP, false>(q, k, v, lo, o, lse, strides, B, S, H, D, scale, causal, st)))
  }
  HVD_DISPATCH_D(D, (launch_fwd<__nv_bfloat16, DP, false>(q, k, v, lo, o, lse, strides, B, S, H, D, scale, causal, st)))
}

int hvd_flash_dq(const void* q, const void* k, const void* v,
                 const void* const* lo, const void* dout, const void* dout_lo,
                 const void* lse, const void* delta, const void* dlse,
                 void* dq, const long long* strides, int B, int S, int H,
                 int D, float scale, int causal, int dtype, void* stream) {
  if ((dtype != 0 && dtype != 1) || (dtype == 0) != (lo != nullptr) ||
      (lo && dout_lo))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (lo) {
    HVD_DISPATCH_D(D, (launch_dq<DP, true, true>(q, k, v, lo, dout, dout_lo, lse, delta, dlse, dq, strides, B, S, H, D, scale, causal, st)))
  }
  if (dout_lo) {
    HVD_DISPATCH_D(D, (launch_dq<DP, true, false>(q, k, v, lo, dout, dout_lo, lse, delta, dlse, dq, strides, B, S, H, D, scale, causal, st)))
  }
  HVD_DISPATCH_D(D, (launch_dq<DP, false, false>(q, k, v, lo, dout, dout_lo, lse, delta, dlse, dq, strides, B, S, H, D, scale, causal, st)))
}

int hvd_flash_dkv(const void* q, const void* k, const void* v,
                  const void* const* lo, const void* dout,
                  const void* dout_lo, const void* lse, const void* delta,
                  const void* dlse, void* dk, void* dv,
                  const long long* strides, int B, int S, int H, int D,
                  float scale, int causal, int dtype, void* stream) {
  if ((dtype != 0 && dtype != 1) || (dtype == 0) != (lo != nullptr) ||
      (lo && dout_lo))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (lo) {
    HVD_DISPATCH_D(D, (launch_dkv<DP, true, true>(q, k, v, lo, dout, dout_lo, lse, delta, dlse, dk, dv, strides, B, S, H, D, scale, causal, st)))
  }
  if (dout_lo) {
    HVD_DISPATCH_D(D, (launch_dkv<DP, true, false>(q, k, v, lo, dout, dout_lo, lse, delta, dlse, dk, dv, strides, B, S, H, D, scale, causal, st)))
  }
  HVD_DISPATCH_D(D, (launch_dkv<DP, false, false>(q, k, v, lo, dout, dout_lo, lse, delta, dlse, dk, dv, strides, B, S, H, D, scale, causal, st)))
}

// The split pass: n (1-3) fp32 [B, S, H, D] inputs x (16-byte aligned, d
// contiguous, (b, s, h) element strides in strides, multiples of 4), each
// into np (2 or 3) bf16 planes, written to planes as a contiguous
// [n, np, B, S, H, D].
int hvd_flash_split(int n, const void* const* x, const long long* strides,
                    int B, int S, int H, int D, int np, void* planes,
                    void* stream) {
  const long long n4 = (long long)B * S * H * D / 4;
  if (n < 1 || n > SPLIT_MAX || (np != 2 && np != 3) || B < 1 || S < 1 ||
      H < 1 || D < 4 || D % 4 || n4 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  SplitIn in = {};
  for (int t = 0; t < n; ++t) {
    in.x[t] = (const float*)x[t];
    if ((uintptr_t)x[t] % 16) return (int)cudaErrorInvalidValue;
    for (int j = 0; j < 3; ++j) {
      in.st[t][j] = strides[3 * t + j];
      if (in.st[t][j] % 4) return (int)cudaErrorInvalidValue;
    }
  }
  dim3 grid((unsigned)((n4 + 255) / 256), n);
  if (np == 3)
    split_kernel<3><<<grid, 256, 0, (cudaStream_t)stream>>>(
        in, S, H, D / 4, (int)n4, (uint2*)planes);
  else
    split_kernel<2><<<grid, 256, 0, (cudaStream_t)stream>>>(
        in, S, H, D / 4, (int)n4, (uint2*)planes);
  return (int)cudaGetLastError();
}

}  // extern "C"
