// Shared by the flash kernel sources: the head-dim dispatch, and the
// launchers of the tensor-core (wgmma) kernels in flash_wgmma.cu, which
// hvd_flash_fwd, hvd_flash_dq and hvd_flash_dkv (flash_attention.cu) choose
// for bfloat16 q/k/v, and for float32 q/k/v's forward and dK/dV.
// Arguments as there; lo is null, or the three lo planes of float32 q, k
// and v split into bf16 planes (q, k, v their hi planes); dout_lo is the lo
// plane of a float32 dO split into bf16 planes (dout its hi plane), or null
// for a bfloat16 dO.  Each returns a cudaError_t (0 on success),
// cudaErrorInvalidValue where the tensor map cannot describe the input (a
// base or a (b, s, h) stride that is not a multiple of 16 bytes).
#pragma once

#include <cuda_runtime.h>

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

int hvd_flash_fwd_wgmma(const void* q, const void* k, const void* v,
                        const void* const* lo, void* o, void* lse,
                        const long long* strides, int B, int S, int H, int D,
                        float scale, int causal, int out_f32,
                        cudaStream_t stream);

int hvd_flash_dq_wgmma(const void* q, const void* k, const void* v,
                       const void* dout, const void* dout_lo, const void* lse,
                       const void* delta, const void* dlse, void* dq,
                       const long long* strides, int B, int S, int H, int D,
                       float scale, int causal, cudaStream_t stream);

int hvd_flash_dkv_wgmma(const void* q, const void* k, const void* v,
                        const void* const* lo, const void* dout,
                        const void* dout_lo, const void* lse,
                        const void* delta, const void* dlse, void* dk,
                        void* dv, const long long* strides, int B, int S,
                        int H, int D, float scale, int causal,
                        cudaStream_t stream);
