// Typed element-wise reduction kernels for the CPU data plane, plus the
// fp16/bf16 conversions and the Adasum pairwise combine.
//
// Parity: the reference delegates device math to NCCL/MPI and only hand
// rolls the fp16 summation (horovod/common/half.cc:43-77, promote-to-float
// accumulate) and the Adasum combine (adasum/adasum.h:340-402).  We mirror
// both policies: 16-bit dtypes accumulate through fp32 with
// round-to-nearest-even back-conversion, and the Adasum coefficients use
// the same zero-norm guards.
#pragma once

#include <cstddef>
#include <cstdint>

#include "types.h"

namespace hvd {

// True when the CPU carries the AVX2+F16C fast paths (runtime probe;
// the authoritative gate behind the vectorized combines and
// `hvd_simd_available` in the C API).
bool SimdRuntimeAvailable();

// fp16 (IEEE binary16) <-> fp32.
float HalfToFloat(uint16_t h);
uint16_t FloatToHalf(float f);

// bfloat16 <-> fp32 (round-to-nearest-even, matching ml_dtypes/XLA).
inline float Bf16ToFloat(uint16_t b) {
  uint32_t u = static_cast<uint32_t>(b) << 16;
  float f;
  __builtin_memcpy(&f, &u, 4);
  return f;
}
uint16_t FloatToBf16(float f);

// OCP FP8 <-> fp32 (round-to-nearest-even, matching ml_dtypes so mixed
// native/py jobs stay bit-compatible).  e4m3fn: no inf, 0x7f = NaN,
// overflow beyond the rounding range of ±448 -> NaN (ml_dtypes
// semantics).  e5m2 is fp16 truncated to its top byte.
float Fp8E4m3ToFloat(uint8_t v);
uint8_t FloatToFp8E4m3(float f);
inline float Fp8E5m2ToFloat(uint8_t v) {
  return HalfToFloat(static_cast<uint16_t>(v) << 8);
}
uint8_t FloatToFp8E5m2(float f);

// dst[i] = combine(incoming[i], dst[i]) for n elements of dtype dt.
// Argument order matches the Python engine's `_combine(incoming, chunk)`
// so mixed-engine jobs reduce identically.
void CombineInto(void* dst, const void* incoming, size_t n, DataType dt,
                 ReduceOp op);

// dst[i] op= scalar (used for prescale / postscale / average divide).
void ScaleInPlace(void* buf, size_t n, DataType dt, double factor);

// Average divide: halves go through fp32 like the Python engine
// (cpu_backend.py:163-167); other floats divide in their own dtype.
void AverageInPlace(void* buf, size_t n, DataType dt, int64_t world_size);

// Adasum pairwise combine on fp64 buffers: a' = acoef*a + bcoef*b written
// into `out` (may alias a).  Guards: zero norm => coefficient 1.0.
void AdasumPairF64(const double* a, const double* b, double* out, size_t n);

// Widen / narrow between dtype dt and fp64 (Adasum accumulates in fp64,
// mirroring cpu_backend._adasum_flat).
void ToF64(const void* src, double* dst, size_t n, DataType dt);
void FromF64(const double* src, void* dst, size_t n, DataType dt);

}  // namespace hvd
