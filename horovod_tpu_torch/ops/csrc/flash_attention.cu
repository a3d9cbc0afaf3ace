// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV kernels.
//
// Replaces the three Pallas kernels of horovod_tpu/ops/pallas_attention.py:
//   fwd_kernel  <- _fwd_kernel  (launched by _flash_fwd)
//   dq_kernel   <- _dq_kernel   (launched by _flash_bwd)
//   dkv_kernel  <- _dkv_kernel  (launched by _flash_bwd)
// They compute what those kernels compute: S = Q K^T * scale in fp32, causal
// key j visible to query i iff j <= i, online softmax with O = acc / l and
// lse = m + log l; backward P = exp(S - lse), dP = dO V^T,
// dS = P * (dP - delta + dlse), dQ = dS K * scale, dV = P^T dO,
// dK = dS^T Q * scale.  delta = rowsum(dO * O) is computed by the caller.
//
// Layout: q/k/v/dO are read as [B, S, H, D] through element strides for
// b, s and h (d is contiguous), so the caller needs no head-major copy.
// dO has q's type, or float32 with bfloat16 q/k/v: the lse variant's output
// is float32, so its gradient is too, and it is read without rounding.
// o/dq/dk/dv are written contiguous [B, S, H, D]; lse/delta/dlse are fp32
// contiguous [B, S, H].
//
// What bounds them on this card, and what the design does about it:
//   * At the flagship shape (B 8, S 1024, H 16, D 64, bf16, causal) the
//     work is 17-34 GFLOP per kernel against 67-101 MB of traffic: far above
//     the H100's ~295 FLOP/byte ridge, so the kernels are bound by
//     arithmetic, never by device memory.  The [S, S] score matrix is never
//     written to device memory: each block keeps its score tile in shared
//     memory and its running statistics and accumulators in registers.
//   * This first version multiplies with scalar fp32 FMAs from shared-memory
//     tiles (a 4x4 register micro-tile per thread), so it runs at the card's
//     fp32 CUDA-core rate, not its bf16 tensor-core rate, and the shared-
//     memory loads feeding the FMAs are its limit.  Tiles are padded by one
//     float per row so the 16 threads of a half-warp hit 16 banks.  Moving
//     the products to mma/wgmma is later work.
//   * Causal blocks skip the key (query) tiles above the diagonal, and the
//     grid hands out the tiles with the most work first to shorten the tail.
//   * No atomics: every output element has exactly one writer, so results
//     are deterministic run to run.
// Ragged S is masked with bounds checks (the Pallas code halved its
// blocks until they divided S instead).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;    // query rows per tile
constexpr int BK = 64;    // key rows per tile
constexpr int NT = 256;   // threads per block: a 16 x 16 grid (ty, tx)
constexpr int TM = 4;     // tile rows owned by a thread: ty + 16 * i
constexpr int PS = BK + 1;  // padded row stride of a [BQ, BK] score tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Str {  // element strides of a [B, S, H, D] view (d stride is 1)
  long long b, s, h;
};

// Copy rows [row0, row0 + 64) of one (b, h) slice into a padded fp32 tile;
// rows at or past S read as zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          Str st, int row0, int S) {
  constexpr int DP = D + 1;
  for (int i = threadIdx.x; i < 64 * D; i += NT) {
    const int r = i / D, d = i % D, s = row0 + r;
    dst[r * DP + d] = s < S ? to_f(src[(long long)s * st.s + d]) : 0.f;
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
template <typename T, typename TO, int D>
__global__ void __launch_bounds__(NT)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, TO* __restrict__ o, float* __restrict__ lse,
           Str sq, Str sk, Str sv, int H, int S, float scale, int causal) {
  constexpr int DP = D + 1, TN = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;              // [BQ][DP]
  float* Ks = Qs + BQ * DP;      // [BK][DP]
  float* Vs = Ks + BK * DP;      // [BK][DP]
  float* Ps = Vs + BK * DP;      // [BQ][PS] scores, then probabilities
  float* m_s = Ps + BQ * PS;     // [BQ] running max
  float* l_s = m_s + BQ;         // [BQ] running sum
  float* c_s = l_s + BQ;         // [BQ] this tile's rescale factor

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tiles first

  load_tile<T, D>(Qs, q + b * sq.b + h * sq.h, sq, q0, S);
  if (tid < BQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const int k_end = causal ? min(S, q0 + BQ) : S;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(Ks, kb, sk, k0, S);
    load_tile<T, D>(Vs, vb, sv, k0, S);
    __syncthreads();

    float sacc[TM][TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) sacc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[TM], kv[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) qv[i] = Qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < TM; ++j) kv[j] = Ks[(tx + 16 * j) * DP + d];
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
    for (int c = 0; c < BK; ++c) {
      float pv[TM], vv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) pv[i] = Ps[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < TN; ++j) vv[j] = Vs[c * DP + tx + 16 * j];
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
    for (int j = 0; j < TN; ++j) o[row * D + tx + 16 * j] = from_f<TO>(acc[i][j] / l);
    if (tx == 0) lse[row] = m_s[r] + logf(l);
  }
}

// Recompute one [BQ, BK] tile of P and dS into registers: thread (ty, tx)
// holds rows ty + 16 i and columns tx + 16 j.  Qs/dOs hold the query tile,
// Ks/Vs the key tile; lse_s and dd_s (= delta - dlse) the query rows' stats.
template <int D>
__device__ __forceinline__ void p_ds_tile(const float* Qs, const float* dOs,
                                          const float* Ks, const float* Vs,
                                          const float* lse_s, const float* dd_s,
                                          int q0, int k0, int S, float scale,
                                          int causal, float (&p)[TM][TM],
                                          float (&ds)[TM][TM]) {
  constexpr int DP = D + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float sacc[TM][TM], dpacc[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) sacc[i][j] = dpacc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[TM], dov[TM], kv[TM], vv[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      qv[i] = Qs[(ty + 16 * i) * DP + d];
      dov[i] = dOs[(ty + 16 * i) * DP + d];
    }
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      kv[j] = Ks[(tx + 16 * j) * DP + d];
      vv[j] = Vs[(tx + 16 * j) * DP + d];
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

// Per-row statistics of a query tile: lse and delta - dlse (dlse may be
// null: an lse output that received no gradient).
__device__ __forceinline__ void load_row_stats(float* lse_s, float* dd_s,
                                               const float* __restrict__ lse,
                                               const float* __restrict__ delta,
                                               const float* __restrict__ dlse,
                                               int b, int h, int H, int q0,
                                               int S) {
  const int r = threadIdx.x;
  if (r < BQ) {
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
template <typename T, typename TD, int D>
__global__ void __launch_bounds__(NT)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const TD* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          const float* __restrict__ dlse, T* __restrict__ dq, Str sq, Str sk,
          Str sv, Str sdo, int H, int S, float scale, int causal) {
  constexpr int DP = D + 1, TN = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;              // [BQ][DP]
  float* dOs = Qs + BQ * DP;     // [BQ][DP]
  float* Ks = dOs + BQ * DP;     // [BK][DP]
  float* Vs = Ks + BK * DP;      // [BK][DP]
  float* dSs = Vs + BK * DP;     // [BQ][PS]
  float* lse_s = dSs + BQ * PS;  // [BQ]
  float* dd_s = lse_s + BQ;      // [BQ]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;

  load_tile<T, D>(Qs, q + b * sq.b + h * sq.h, sq, q0, S);
  load_tile<TD, D>(dOs, dout + b * sdo.b + h * sdo.h, sdo, q0, S);
  load_row_stats(lse_s, dd_s, lse, delta, dlse, b, h, H, q0, S);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const int k_end = causal ? min(S, q0 + BQ) : S;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();
    load_tile<T, D>(Ks, kb, sk, k0, S);
    load_tile<T, D>(Vs, vb, sv, k0, S);
    __syncthreads();
    float p[TM][TM], ds[TM][TM];
    p_ds_tile<D>(Qs, dOs, Ks, Vs, lse_s, dd_s, q0, k0, S, scale, causal, p, ds);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) dSs[(ty + 16 * i) * PS + tx + 16 * j] = ds[i][j];
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float dsv[TM], kv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) dsv[i] = dSs[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < TN; ++j) kv[j] = Ks[c * DP + tx + 16 * j];
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
    for (int j = 0; j < TN; ++j) dq[row * D + tx + 16 * j] = from_f<T>(acc[i][j] * scale);
  }
}

// dK/dV.  One block per (key tile, b*h), looping over query tiles from the
// causal start; dK and dV stay in registers until the end.
template <typename T, typename TD, int D>
__global__ void __launch_bounds__(NT)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const TD* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           const float* __restrict__ dlse, T* __restrict__ dk,
           T* __restrict__ dv, Str sq, Str sk, Str sv, Str sdo, int H, int S,
           float scale, int causal) {
  constexpr int DP = D + 1, TN = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;              // [BK][DP]
  float* Vs = Ks + BK * DP;      // [BK][DP]
  float* Qs = Vs + BK * DP;      // [BQ][DP]
  float* dOs = Qs + BQ * DP;     // [BQ][DP]
  float* Ps = dOs + BQ * DP;     // [BQ][PS]
  float* dSs = Ps + BQ * PS;     // [BQ][PS]
  float* lse_s = dSs + BQ * PS;  // [BQ]
  float* dd_s = lse_s + BQ;      // [BQ]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * BK;  // causal: low key tiles carry the most work

  load_tile<T, D>(Ks, k + b * sk.b + h * sk.h, sk, k0, S);
  load_tile<T, D>(Vs, v + b * sv.b + h * sv.h, sv, k0, S);
  float dk_acc[TM][TN], dv_acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const T* qb = q + b * sq.b + h * sq.h;
  const TD* dob = dout + b * sdo.b + h * sdo.h;
  const int q_start = causal ? (k0 / BQ) * BQ : 0;
  for (int q0 = q_start; q0 < S; q0 += BQ) {
    __syncthreads();
    load_tile<T, D>(Qs, qb, sq, q0, S);
    load_tile<TD, D>(dOs, dob, sdo, q0, S);
    load_row_stats(lse_s, dd_s, lse, delta, dlse, b, h, H, q0, S);
    __syncthreads();
    float p[TM][TM], ds[TM][TM];
    p_ds_tile<D>(Qs, dOs, Ks, Vs, lse_s, dd_s, q0, k0, S, scale, causal, p, ds);
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
    for (int r = 0; r < BQ; ++r) {
      float pv[TM], dsv[TM], dov[TN], qv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        pv[i] = Ps[r * PS + ty + 16 * i];
        dsv[i] = dSs[r * PS + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        dov[j] = dOs[r * (D + 1) + tx + 16 * j];
        qv[j] = Qs[r * (D + 1) + tx + 16 * j];
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
      dk[row * D + tx + 16 * j] = from_f<T>(dk_acc[i][j] * scale);
      dv[row * D + tx + 16 * j] = from_f<T>(dv_acc[i][j]);
    }
  }
}

constexpr size_t fwd_smem(int D) {
  return sizeof(float) * (size_t)(BQ * (D + 1) + 2 * BK * (D + 1) + BQ * PS + 3 * BQ);
}
constexpr size_t dq_smem(int D) {
  return sizeof(float) * (size_t)(2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * PS + 2 * BQ);
}
constexpr size_t dkv_smem(int D) {
  return sizeof(float) * (size_t)(2 * BK * (D + 1) + 2 * BQ * (D + 1) + 2 * BQ * PS + 2 * BQ);
}

Str str_at(const long long* s, int i) { return Str{s[3 * i], s[3 * i + 1], s[3 * i + 2]}; }

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, typename TO, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
               const long long* st, int B, int S, int H, float scale,
               int causal, cudaStream_t stream) {
  const size_t smem = fwd_smem(D);
  auto kernel = fwd_kernel<T, TO, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (S + BQ - 1) / BQ);
  kernel<<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (TO*)o, (float*)lse,
      str_at(st, 0), str_at(st, 1), str_at(st, 2), H, S, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, typename TD, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, const void* dlse, void* dq,
              const long long* st, int B, int S, int H, float scale,
              int causal, cudaStream_t stream) {
  const size_t smem = dq_smem(D);
  auto kernel = dq_kernel<T, TD, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (S + BQ - 1) / BQ);
  kernel<<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const TD*)dout,
      (const float*)lse, (const float*)delta, (const float*)dlse, (T*)dq,
      str_at(st, 0), str_at(st, 1), str_at(st, 2), str_at(st, 3), H, S,
      scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, typename TD, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, const void* dlse, void* dk,
               void* dv, const long long* st, int B, int S, int H,
               float scale, int causal, cudaStream_t stream) {
  const size_t smem = dkv_smem(D);
  auto kernel = dkv_kernel<T, TD, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (S + BK - 1) / BK);
  kernel<<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const TD*)dout,
      (const float*)lse, (const float*)delta, (const float*)dlse, (T*)dk,
      (T*)dv, str_at(st, 0), str_at(st, 1), str_at(st, 2), str_at(st, 3), H,
      S, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// Selects the template by head dim D; an unsupported D is an invalid value.
#define HVD_DISPATCH_D(D, CALL)                           \
  switch (D) {                                            \
    case 16: { constexpr int HD = 16; return CALL; }      \
    case 32: { constexpr int HD = 32; return CALL; }      \
    case 64: { constexpr int HD = 64; return CALL; }      \
    case 128: { constexpr int HD = 128; return CALL; }    \
    default: return (int)cudaErrorInvalidValue;           \
  }

// dtype: 0 = float32, 1 = bfloat16, for q/k/v and the outputs.  do_f32: dO
// is float32 where q/k/v are bfloat16 (the gradient of the lse variant's
// float32 output); with float32 q/k/v, dO is float32 anyway.  strides: host
// array of (b, s, h) element strides for q, k, v (and dO in the backward
// launchers).
// Each returns cudaGetLastError() after the launch (0 on success).
extern "C" {

int hvd_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  void* lse, const long long* strides, int B, int S, int H,
                  int D, float scale, int causal, int dtype, int out_f32,
                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    HVD_DISPATCH_D(D, (launch_fwd<float, float, HD>(q, k, v, o, lse, strides, B, S, H, scale, causal, st)))
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (out_f32) {
    HVD_DISPATCH_D(D, (launch_fwd<__nv_bfloat16, float, HD>(q, k, v, o, lse, strides, B, S, H, scale, causal, st)))
  }
  HVD_DISPATCH_D(D, (launch_fwd<__nv_bfloat16, __nv_bfloat16, HD>(q, k, v, o, lse, strides, B, S, H, scale, causal, st)))
}

int hvd_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* delta, const void* dlse,
                 void* dq, const long long* strides, int B, int S, int H,
                 int D, float scale, int causal, int dtype, int do_f32,
                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    HVD_DISPATCH_D(D, (launch_dq<float, float, HD>(q, k, v, dout, lse, delta, dlse, dq, strides, B, S, H, scale, causal, st)))
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (do_f32) {
    HVD_DISPATCH_D(D, (launch_dq<__nv_bfloat16, float, HD>(q, k, v, dout, lse, delta, dlse, dq, strides, B, S, H, scale, causal, st)))
  }
  HVD_DISPATCH_D(D, (launch_dq<__nv_bfloat16, __nv_bfloat16, HD>(q, k, v, dout, lse, delta, dlse, dq, strides, B, S, H, scale, causal, st)))
}

int hvd_flash_dkv(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  const void* dlse, void* dk, void* dv,
                  const long long* strides, int B, int S, int H, int D,
                  float scale, int causal, int dtype, int do_f32,
                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    HVD_DISPATCH_D(D, (launch_dkv<float, float, HD>(q, k, v, dout, lse, delta, dlse, dk, dv, strides, B, S, H, scale, causal, st)))
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (do_f32) {
    HVD_DISPATCH_D(D, (launch_dkv<__nv_bfloat16, float, HD>(q, k, v, dout, lse, delta, dlse, dk, dv, strides, B, S, H, scale, causal, st)))
  }
  HVD_DISPATCH_D(D, (launch_dkv<__nv_bfloat16, __nv_bfloat16, HD>(q, k, v, dout, lse, delta, dlse, dk, dv, strides, B, S, H, scale, causal, st)))
}

}  // extern "C"
