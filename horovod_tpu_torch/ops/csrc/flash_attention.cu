// Flash attention for Hopper (sm_90a): the scalar (SIMT) forward, dQ and
// dK/dV kernels for float32, and the C entry points that choose between them
// and the tensor-core kernels of flash_wgmma.cu.
//
// Replaces the three Pallas kernels of horovod_tpu/ops/pallas_attention.py:
//   fwd_kernel  <- _fwd_kernel  (launched by _flash_fwd), float32
//   dq_kernel   <- _dq_kernel   (launched by _flash_bwd), float32
//   dkv_kernel  <- _dkv_kernel  (launched by _flash_bwd), float32
// bfloat16 q/k/v take fwd_wgmma_kernel, dq_wgmma_kernel and
// dkv_wgmma_kernel (flash_wgmma.cu), with a bfloat16 dO or the lse
// variant's float32 one.
// They compute what those kernels compute: S = Q K^T * scale in fp32, causal
// key j visible to query i iff j <= i, online softmax with O = acc / l and
// lse = m + log l; backward P = exp(S - lse), dP = dO V^T,
// dS = P * (dP - delta + dlse), dQ = dS K * scale, dV = P^T dO,
// dK = dS^T Q * scale.  delta = rowsum(dO * O) is computed by the caller.
// In float32 the Pallas kernels' rounding points (dS to q's dtype, P to
// dO's) round nothing.
//
// Layout: q/k/v/dO are read as [B, S, H, D] through element strides for
// b, s and h (d is contiguous), so the caller needs no head-major copy.
// o/dq/dk/dv are written contiguous [B, S, H, D]; lse/delta/dlse are fp32
// contiguous [B, S, H].  The kernels are instantiated at DP = 16, 32, 64,
// 128 and 256 columns (HVD_DISPATCH_D) and serve any head dim D that is a
// multiple of 8 up to DP: their tiles read columns D..DP-1 as zeros, which
// add nothing to any product, and the stores skip them.
//
// What bounds them on this card, and what the design does about it:
//   * At the flagship shape (B 8, S 1024, H 16, D 64, causal) the work is
//     17-34 GFLOP per kernel against 68-102 MB of traffic, far above the fp32
//     CUDA cores' ~20 FLOP/byte ridge, so these kernels are bound by
//     arithmetic, never by device memory.  The [S, S] score matrix is never
//     written to device memory: each block keeps its score tile in shared
//     memory and its running statistics and accumulators in registers.
//   * These kernels multiply with scalar fp32 FMAs from shared-memory
//     tiles (a 4x4 register micro-tile per thread), so they run at the card's
//     fp32 CUDA-core rate, and the shared-memory loads feeding the FMAs are
//     their limit.  Tiles are padded by one float per row so the 16 threads
//     of a half-warp hit 16 banks.  At DP 256 dQ and dK/dV take tiles of 32
//     rows (2x2 scores a thread), so that their four [rows, DP] tiles fit
//     in shared memory.
//   * Causal blocks skip the key (query) tiles above the diagonal, and the
//     grid hands out the tiles with the most work first to shorten the tail.
//   * No atomics: every output element has exactly one writer, so results
//     are deterministic run to run.
// Ragged S is masked with bounds checks (the Pallas code halved its
// blocks until they divided S instead).

#include <cuda_runtime.h>
#include <math.h>

#include "flash_attention.cuh"

namespace {

constexpr int NT = 256;   // threads per block: a 16 x 16 grid (ty, tx)
constexpr int FR = 64;    // forward: query and key rows per tile

// dQ and dK/dV: query and key rows per tile.
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

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Forward.  One block per (query tile, b*h): loops over key tiles up to the
// causal limit, keeps m and l in shared memory and the output accumulator
// in registers, and writes o and lse.
template <int DP>
__global__ void __launch_bounds__(NT)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ o,
           float* __restrict__ lse,
           Str sq, Str sk, Str sv, int H, int S, int D, float scale, int causal) {
  constexpr int PD = DP + 1, TM = FR / 16, TN = DP / 16, PS = FR + 1;
  extern __shared__ float smem[];
  float* Qs = smem;              // [FR][PD]
  float* Ks = Qs + FR * PD;      // [FR][PD]
  float* Vs = Ks + FR * PD;      // [FR][PD]
  float* Ps = Vs + FR * PD;      // [FR][PS] scores, then probabilities
  float* m_s = Ps + FR * PS;     // [FR] running max
  float* l_s = m_s + FR;         // [FR] running sum
  float* c_s = l_s + FR;         // [FR] this tile's rescale factor

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * FR;  // heaviest tiles first

  load_tile<DP, FR>(Qs, q + b * sq.b + h * sq.h, sq, q0, S, D);
  if (tid < FR) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const int k_end = causal ? min(S, q0 + FR) : S;
  for (int k0 = 0; k0 < k_end; k0 += FR) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<DP, FR>(Ks, kb, sk, k0, S, D);
    load_tile<DP, FR>(Vs, vb, sv, k0, S, D);
    __syncthreads();

    float sacc[TM][TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) sacc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      float qv[TM], kv[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) qv[i] = Qs[(ty + 16 * i) * PD + d];
#pragma unroll
      for (int j = 0; j < TM; ++j) kv[j] = Ks[(tx + 16 * j) * PD + d];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) sacc[i][j] = fmaf(qv[i], kv[j], sacc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int qi = q0 + r, kj = k0 + c;
        const bool masked = kj >= S || (causal && kj > qi);
        Ps[r * PS + c] = masked ? -INFINITY : sacc[i][j] * scale;
      }
    __syncthreads();

    // Online softmax: warp w owns rows 8w .. 8w+7, each lane two columns.
    for (int rr = 0; rr < 8; ++rr) {
      const int r = warp * 8 + rr;
      const float a0 = Ps[r * PS + lane], a1 = Ps[r * PS + lane + 32];
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(a0, a1)));
      const float p0 = a0 == -INFINITY ? 0.f : expf(a0 - m_new);
      const float p1 = a1 == -INFINITY ? 0.f : expf(a1 - m_new);
      Ps[r * PS + lane] = p0;
      Ps[r * PS + lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float corr = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
        c_s[r] = corr;
        l_s[r] = corr * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = corr * acc + P V over this key tile.
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float corr = c_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int c = 0; c < FR; ++c) {
      float pv[TM], vv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) pv[i] = Ps[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < TN; ++j) vv[j] = Vs[c * PD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty + 16 * i, s = q0 + r;
    if (s >= S) continue;
    const float l = l_s[r];
    const long long row = ((long long)b * S + s) * H + h;
#pragma unroll
    for (int j = 0; j < TN; ++j)
      if (tx + 16 * j < D) o[row * D + tx + 16 * j] = acc[i][j] / l;
    if (tx == 0) lse[row] = m_s[r] + logf(l);
  }
}

// Recompute one [R, R] tile of P and dS into registers: thread (ty, tx)
// holds rows ty + 16 i and columns tx + 16 j.  Qs/dOs hold the query tile,
// Ks/Vs the key tile; lse_s and dd_s (= delta - dlse) the query rows' stats.
template <int DP, int R>
__device__ __forceinline__ void p_ds_tile(const float* Qs, const float* dOs,
                                          const float* Ks, const float* Vs,
                                          const float* lse_s, const float* dd_s,
                                          int q0, int k0, int S, float scale,
                                          int causal, float (&p)[R / 16][R / 16],
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
      p[i][j] = pij;
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
    float p[TM][TM], ds[TM][TM];
    p_ds_tile<DP, R>(Qs, dOs, Ks, Vs, lse_s, dd_s, q0, k0, S, scale, causal,
                     p, ds);
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

// dK/dV.  One block per (key tile, b*h), looping over query tiles from the
// causal start; dK and dV stay in registers until the end.
template <int DP>
__global__ void __launch_bounds__(NT)
dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           const float* __restrict__ dlse, float* __restrict__ dk,
           float* __restrict__ dv, Str sq, Str sk, Str sv, Str sdo, int H,
           int S, int D, float scale, int causal) {
  constexpr int R = bwd_rows<DP>();
  constexpr int PD = DP + 1, TM = R / 16, TN = DP / 16, PS = R + 1;
  extern __shared__ float smem[];
  float* Ks = smem;              // [R][PD]
  float* Vs = Ks + R * PD;       // [R][PD]
  float* Qs = Vs + R * PD;       // [R][PD]
  float* dOs = Qs + R * PD;      // [R][PD]
  float* Ps = dOs + R * PD;      // [R][PS]
  float* dSs = Ps + R * PS;      // [R][PS]
  float* lse_s = dSs + R * PS;   // [R]
  float* dd_s = lse_s + R;       // [R]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * R;  // causal: low key tiles carry the most work

  load_tile<DP, R>(Ks, k + b * sk.b + h * sk.h, sk, k0, S, D);
  load_tile<DP, R>(Vs, v + b * sv.b + h * sv.h, sv, k0, S, D);
  float dk_acc[TM][TN], dv_acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* dob = dout + b * sdo.b + h * sdo.h;
  const int q_start = causal ? k0 : 0;
  for (int q0 = q_start; q0 < S; q0 += R) {
    __syncthreads();
    load_tile<DP, R>(Qs, qb, sq, q0, S, D);
    load_tile<DP, R>(dOs, dob, sdo, q0, S, D);
    load_row_stats<R>(lse_s, dd_s, lse, delta, dlse, b, h, H, q0, S);
    __syncthreads();
    float p[TM][TM], ds[TM][TM];
    p_ds_tile<DP, R>(Qs, dOs, Ks, Vs, lse_s, dd_s, q0, k0, S, scale, causal,
                     p, ds);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        const int idx = (ty + 16 * i) * PS + tx + 16 * j;
        Ps[idx] = p[i][j];
        dSs[idx] = ds[i][j];
      }
    __syncthreads();
    // Thread (ty, tx) now owns key rows ty + 16 i and columns tx + 16 j.
#pragma unroll 4
    for (int r = 0; r < R; ++r) {
      float pv[TM], dsv[TM], dov[TN], qv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        pv[i] = Ps[r * PS + ty + 16 * i];
        dsv[i] = dSs[r * PS + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        dov[j] = dOs[r * PD + tx + 16 * j];
        qv[j] = Qs[r * PD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          dv_acc[i][j] = fmaf(pv[i], dov[j], dv_acc[i][j]);
          dk_acc[i][j] = fmaf(dsv[i], qv[j], dk_acc[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int s = k0 + ty + 16 * i;
    if (s >= S) continue;
    const long long row = ((long long)b * S + s) * H + h;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      if (tx + 16 * j >= D) continue;
      dk[row * D + tx + 16 * j] = dk_acc[i][j] * scale;
      dv[row * D + tx + 16 * j] = dv_acc[i][j];
    }
  }
}

template <int DP> constexpr size_t fwd_smem() {
  return sizeof(float) * (size_t)(3 * FR * (DP + 1) + FR * (FR + 1) + 3 * FR);
}
template <int DP> constexpr size_t dq_smem() {
  constexpr int R = bwd_rows<DP>();
  return sizeof(float) * (size_t)(4 * R * (DP + 1) + R * (R + 1) + 2 * R);
}
template <int DP> constexpr size_t dkv_smem() {
  constexpr int R = bwd_rows<DP>();
  return sizeof(float) * (size_t)(4 * R * (DP + 1) + 2 * R * (R + 1) + 2 * R);
}

Str str_at(const long long* s, int i) { return Str{s[3 * i], s[3 * i + 1], s[3 * i + 2]}; }

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int DP>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
               const long long* st, int B, int S, int H, int D, float scale,
               int causal, cudaStream_t stream) {
  const size_t smem = fwd_smem<DP>();
  auto kernel = fwd_kernel<DP>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (S + FR - 1) / FR);
  kernel<<<grid, NT, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o,
      (float*)lse, str_at(st, 0), str_at(st, 1), str_at(st, 2), H, S, D,
      scale, causal);
  return (int)cudaGetLastError();
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

template <int DP>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, const void* dlse, void* dk,
               void* dv, const long long* st, int B, int S, int H, int D,
               float scale, int causal, cudaStream_t stream) {
  constexpr int R = bwd_rows<DP>();
  const size_t smem = dkv_smem<DP>();
  auto kernel = dkv_kernel<DP>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (S + R - 1) / R);
  kernel<<<grid, NT, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)delta, (const float*)dlse, (float*)dk,
      (float*)dv, str_at(st, 0), str_at(st, 1), str_at(st, 2), str_at(st, 3),
      H, S, D, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for q/k/v and the outputs.  dout_lo:
// with bfloat16 q/k/v, the lo plane of a float32 dO split into two bf16
// planes (dout is then its hi plane; hvd_flash_split_do, flash_wgmma.cu),
// or null for a bfloat16 dO; with float32 q/k/v, null (dO is float32).
// strides: host array of (b, s, h) element strides for q, k, v (and dO, or
// its planes, in the backward launchers).  D: the head dim, a multiple of 8
// up to 256.  The kernel is chosen by dtype: bfloat16 on the tensor cores,
// float32 on the scalar kernels.
// Each returns cudaGetLastError() after the launch (0 on success).
extern "C" {

int hvd_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  void* lse, const long long* strides, int B, int S, int H,
                  int D, float scale, int causal, int dtype, int out_f32,
                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return hvd_flash_fwd_wgmma(q, k, v, o, lse, strides, B, S, H, D, scale,
                               causal, out_f32, st);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  HVD_DISPATCH_D(D, (launch_fwd<DP>(q, k, v, o, lse, strides, B, S, H, D, scale, causal, st)))
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
                  const void* dout, const void* dout_lo, const void* lse,
                  const void* delta, const void* dlse, void* dk, void* dv,
                  const long long* strides, int B, int S, int H, int D,
                  float scale, int causal, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return hvd_flash_dkv_wgmma(q, k, v, dout, dout_lo, lse, delta, dlse, dk,
                               dv, strides, B, S, H, D, scale, causal, st);
  if (dtype != 0 || dout_lo) return (int)cudaErrorInvalidValue;
  HVD_DISPATCH_D(D, (launch_dkv<DP>(q, k, v, dout, lse, delta, dlse, dk, dv, strides, B, S, H, D, scale, causal, st)))
}

}  // extern "C"
