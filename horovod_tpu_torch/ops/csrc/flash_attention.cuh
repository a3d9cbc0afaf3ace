// Shared by the flash kernel sources: the head-dim dispatch, and the
// launchers of the tensor-core (wgmma) kernels in flash_wgmma.cu, which
// hvd_flash_fwd, hvd_flash_dq and hvd_flash_dkv (flash_attention.cu) choose
// for bfloat16 q/k/v with a bfloat16 dO.  Arguments as there; each returns a cudaError_t
// (0 on success), cudaErrorInvalidValue where the tensor map cannot describe
// the input (a base or a (b, s, h) stride that is not a multiple of 16 bytes).
#pragma once

#include <cuda_runtime.h>

// Selects the template by head dim D; an unsupported D is an invalid value.
#define HVD_DISPATCH_D(D, CALL)                           \
  switch (D) {                                            \
    case 16: { constexpr int HD = 16; return CALL; }      \
    case 32: { constexpr int HD = 32; return CALL; }      \
    case 64: { constexpr int HD = 64; return CALL; }      \
    case 128: { constexpr int HD = 128; return CALL; }    \
    default: return (int)cudaErrorInvalidValue;           \
  }

int hvd_flash_fwd_wgmma(const void* q, const void* k, const void* v, void* o,
                        void* lse, const long long* strides, int B, int S,
                        int H, int D, float scale, int causal, int out_f32,
                        cudaStream_t stream);

int hvd_flash_dq_wgmma(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       const void* dlse, void* dq, const long long* strides,
                       int B, int S, int H, int D, float scale, int causal,
                       cudaStream_t stream);

int hvd_flash_dkv_wgmma(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        const void* dlse, void* dk, void* dv,
                        const long long* strides, int B, int S, int H, int D,
                        float scale, int causal, cudaStream_t stream);
