// Flash attention for Hopper (sm_90a): the scalar (SIMT) dQ kernel for
// float32, and the C entry points that choose between it and the
// tensor-core kernels of flash_wgmma.cu.
//
// Replaces the Pallas dQ kernel of horovod_tpu/ops/pallas_attention.py for
// float32 q/k/v:
//   dq_kernel   <- _dq_kernel   (launched by _flash_bwd)
// bfloat16 q/k/v take fwd_wgmma_kernel, dq_wgmma_kernel and
// dkv_wgmma_kernel (flash_wgmma.cu), with a bfloat16 dO or the lse
// variant's float32 one; float32 q/k/v take fwd_wgmma_kernel and
// dkv_wgmma_kernel as bf16 hi and lo planes (hvd_flash_split).
// It computes what the Pallas kernel computes: S = Q K^T * scale in fp32,
// causal key j visible to query i iff j <= i; P = exp(S - lse),
// dP = dO V^T, dS = P * (dP - delta + dlse), dQ = dS K * scale.  delta =
// rowsum(dO * O) is computed by the caller.  In float32 the Pallas kernel's
// rounding point (dS to k's dtype) rounds nothing.
//
// Layout: q/k/v/dO are read as [B, S, H, D] through element strides for
// b, s and h (d is contiguous), so the caller needs no head-major copy.
// dq is written contiguous [B, S, H, D]; lse/delta/dlse are fp32
// contiguous [B, S, H].  The kernel is instantiated at DP = 16, 32, 64,
// 128 and 256 columns (HVD_DISPATCH_D) and serves any head dim D that is a
// multiple of 8 up to DP: its tiles read columns D..DP-1 as zeros, which
// add nothing to any product, and the stores skip them.
//
// What bounds it on this card, and what the design does about it:
//   * At the flagship shape (B 8, S 1024, H 16, D 64, causal) dQ does 26
//     GFLOP against 85 MB of traffic, far above the fp32 CUDA cores' ~20
//     FLOP/byte ridge, so it is bound by arithmetic, never by device
//     memory.  The [S, S] score matrix is never written to device memory:
//     each block keeps its score tile in shared memory and its running
//     accumulators in registers.
//   * It multiplies with scalar fp32 FMAs from shared-memory tiles (a 4x4
//     register micro-tile per thread), so it runs at the card's fp32
//     CUDA-core rate, and the shared-memory loads feeding the FMAs are its
//     limit.  Tiles are padded by one float per row so the 16 threads of a
//     half-warp hit 16 banks.  At DP 256 it takes tiles of 32 rows (2x2
//     scores a thread), so that its four [rows, DP] tiles fit in shared
//     memory.
//   * Causal blocks skip the key tiles above the diagonal, and the grid
//     hands out the tiles with the most work first to shorten the tail.
//   * No atomics: every output element has exactly one writer, so results
//     are deterministic run to run.
// Ragged S is masked with bounds checks (the Pallas code halved its
// blocks until they divided S instead).

#include <cuda_runtime.h>
#include <math.h>

#include "flash_attention.cuh"

namespace {

constexpr int NT = 256;   // threads per block: a 16 x 16 grid (ty, tx)

// dQ: query and key rows per tile.
template <int DP> __host__ __device__ constexpr int bwd_rows() {
  return DP > 128 ? 32 : 64;
}

struct Str {  // element strides of a [B, S, H, D] view (d stride is 1)
  long long b, s, h;
};

// Copy rows [row0, row0 + R) of one (b, h) slice into a padded [R, DP]
// fp32 tile; rows at or past S and columns at or past D read as zero.
template <int DP, int R>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          Str st, int row0, int S, int D) {
  constexpr int PD = DP + 1;
  for (int i = threadIdx.x; i < R * DP; i += NT) {
    const int r = i / DP, d = i % DP, s = row0 + r;
    dst[r * PD + d] = s < S && d < D ? src[(long long)s * st.s + d] : 0.f;
  }
}

// Recompute one [R, R] tile of dS into registers: thread (ty, tx)
// holds rows ty + 16 i and columns tx + 16 j.  Qs/dOs hold the query tile,
// Ks/Vs the key tile; lse_s and dd_s (= delta - dlse) the query rows' stats.
template <int DP, int R>
__device__ __forceinline__ void ds_tile(const float* Qs, const float* dOs,
                                        const float* Ks, const float* Vs,
                                        const float* lse_s, const float* dd_s,
                                        int q0, int k0, int S, float scale,
                                        int causal,
                                        float (&ds)[R / 16][R / 16]) {
  constexpr int PD = DP + 1, TM = R / 16;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float sacc[TM][TM], dpacc[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) sacc[i][j] = dpacc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DP; ++d) {
    float qv[TM], dov[TM], kv[TM], vv[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      qv[i] = Qs[(ty + 16 * i) * PD + d];
      dov[i] = dOs[(ty + 16 * i) * PD + d];
    }
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      kv[j] = Ks[(tx + 16 * j) * PD + d];
      vv[j] = Vs[(tx + 16 * j) * PD + d];
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        sacc[i][j] = fmaf(qv[i], kv[j], sacc[i][j]);
        dpacc[i][j] = fmaf(dov[i], vv[j], dpacc[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty + 16 * i, qi = q0 + r;
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int kj = k0 + tx + 16 * j;
      const bool masked = qi >= S || kj >= S || (causal && kj > qi);
      const float pij = masked ? 0.f : expf(sacc[i][j] * scale - lse_s[r]);
      ds[i][j] = pij * (dpacc[i][j] - dd_s[r]);
    }
  }
}

// Per-row statistics of a query tile of R rows: lse and delta - dlse (dlse
// may be null: an lse output that received no gradient).
template <int R>
__device__ __forceinline__ void load_row_stats(float* lse_s, float* dd_s,
                                               const float* __restrict__ lse,
                                               const float* __restrict__ delta,
                                               const float* __restrict__ dlse,
                                               int b, int h, int H, int q0,
                                               int S) {
  const int r = threadIdx.x;
  if (r < R) {
    const int s = q0 + r;
    float l = 0.f, dd = 0.f;
    if (s < S) {
      const long long row = ((long long)b * S + s) * H + h;
      l = lse[row];
      dd = delta[row] - (dlse ? dlse[row] : 0.f);
    }
    lse_s[r] = l;
    dd_s[r] = dd;
  }
}

// dQ.  One block per (query tile, b*h), looping over key tiles up to the
// causal limit; dQ stays in registers until the end.
template <int DP>
__global__ void __launch_bounds__(NT)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          const float* __restrict__ dlse, float* __restrict__ dq, Str sq,
          Str sk, Str sv, Str sdo, int H, int S, int D, float scale,
          int causal) {
  constexpr int R = bwd_rows<DP>();
  constexpr int PD = DP + 1, TM = R / 16, TN = DP / 16, PS = R + 1;
  extern __shared__ float smem[];
  float* Qs = smem;              // [R][PD]
  float* dOs = Qs + R * PD;      // [R][PD]
  float* Ks = dOs + R * PD;      // [R][PD]
  float* Vs = Ks + R * PD;       // [R][PD]
  float* dSs = Vs + R * PD;      // [R][PS]
  float* lse_s = dSs + R * PS;   // [R]
  float* dd_s = lse_s + R;       // [R]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * R;

  load_tile<DP, R>(Qs, q + b * sq.b + h * sq.h, sq, q0, S, D);
  load_tile<DP, R>(dOs, dout + b * sdo.b + h * sdo.h, sdo, q0, S, D);
  load_row_stats<R>(lse_s, dd_s, lse, delta, dlse, b, h, H, q0, S);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const int k_end = causal ? min(S, q0 + R) : S;
  for (int k0 = 0; k0 < k_end; k0 += R) {
    __syncthreads();
    load_tile<DP, R>(Ks, kb, sk, k0, S, D);
    load_tile<DP, R>(Vs, vb, sv, k0, S, D);
    __syncthreads();
    float ds[TM][TM];
    ds_tile<DP, R>(Qs, dOs, Ks, Vs, lse_s, dd_s, q0, k0, S, scale, causal, ds);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) dSs[(ty + 16 * i) * PS + tx + 16 * j] = ds[i][j];
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < R; ++c) {
      float dsv[TM], kv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) dsv[i] = dSs[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < TN; ++j) kv[j] = Ks[c * PD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= S) continue;
    const long long row = ((long long)b * S + s) * H + h;
#pragma unroll
    for (int j = 0; j < TN; ++j)
      if (tx + 16 * j < D) dq[row * D + tx + 16 * j] = acc[i][j] * scale;
  }
}

template <int DP> constexpr size_t dq_smem() {
  constexpr int R = bwd_rows<DP>();
  return sizeof(float) * (size_t)(4 * R * (DP + 1) + R * (R + 1) + 2 * R);
}
Str str_at(const long long* s, int i) { return Str{s[3 * i], s[3 * i + 1], s[3 * i + 2]}; }

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int DP>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, const void* dlse, void* dq,
              const long long* st, int B, int S, int H, int D, float scale,
              int causal, cudaStream_t stream) {
  constexpr int R = bwd_rows<DP>();
  const size_t smem = dq_smem<DP>();
  auto kernel = dq_kernel<DP>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (S + R - 1) / R);
  kernel<<<grid, NT, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)delta, (const float*)dlse, (float*)dq,
      str_at(st, 0), str_at(st, 1), str_at(st, 2), str_at(st, 3), H, S, D,
      scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for q/k/v and the outputs.  The
// forward and dK/dV take float32 q/k/v (and dO) as bf16 planes (from
// hvd_flash_split): q, k, v (and dout) are then the hi planes, lo the three
// lo planes of q, k and v (and dout_lo dO's); with bfloat16 q/k/v lo is
// null, and dout_lo is the lo plane of the lse variant's float32 dO (dout
// its hi plane) or null for a bfloat16 dO.  dQ takes float32 q/k/v and dO
// as they are (dout_lo null).  strides: host array of (b, s, h) element
// strides for q, k, v (and dO, or its planes, in the backward launchers);
// a lo plane has its hi plane's strides.  D: the head dim, a multiple of 8
// up to 256.
// Each returns cudaGetLastError() after the launch (0 on success).
extern "C" {

int hvd_flash_fwd(const void* q, const void* k, const void* v,
                  const void* const* lo, void* o, void* lse,
                  const long long* strides, int B, int S, int H, int D,
                  float scale, int causal, int dtype, int out_f32,
                  void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if ((dtype == 0) != (lo != nullptr)) return (int)cudaErrorInvalidValue;
  return hvd_flash_fwd_wgmma(q, k, v, lo, o, lse, strides, B, S, H, D, scale,
                             causal, out_f32, (cudaStream_t)stream);
}

int hvd_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                 const void* dout_lo, const void* lse, const void* delta,
                 const void* dlse, void* dq, const long long* strides, int B,
                 int S, int H, int D, float scale, int causal, int dtype,
                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return hvd_flash_dq_wgmma(q, k, v, dout, dout_lo, lse, delta, dlse, dq,
                              strides, B, S, H, D, scale, causal, st);
  if (dtype != 0 || dout_lo) return (int)cudaErrorInvalidValue;
  HVD_DISPATCH_D(D, (launch_dq<DP>(q, k, v, dout, lse, delta, dlse, dq, strides, B, S, H, D, scale, causal, st)))
}

int hvd_flash_dkv(const void* q, const void* k, const void* v,
                  const void* const* lo, const void* dout,
                  const void* dout_lo, const void* lse, const void* delta,
                  const void* dlse, void* dk, void* dv,
                  const long long* strides, int B, int S, int H, int D,
                  float scale, int causal, int dtype, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if ((dtype == 0) != (lo != nullptr)) return (int)cudaErrorInvalidValue;
  return hvd_flash_dkv_wgmma(q, k, v, lo, dout, dout_lo, lse, delta, dlse,
                             dk, dv, strides, B, S, H, D, scale, causal,
                             (cudaStream_t)stream);
}

}  // extern "C"
