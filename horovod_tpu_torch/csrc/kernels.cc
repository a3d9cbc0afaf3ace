#include "kernels.h"

#include <algorithm>
#include <cmath>
#include <cstdlib>
#include <cstring>
#include <vector>

#if (defined(__x86_64__) || defined(_M_X64)) && \
    (defined(__GNUC__) || defined(__clang__))
// GCC/Clang only: the fast paths use __attribute__((target)) with a
// raw-CPUID feature probe — other compilers take the scalar loops.
// (__builtin_cpu_supports("f16c") is not accepted before gcc 11, so
// the probe reads CPUID/XCR0 directly instead.)
#define HVD_X86 1
#include <immintrin.h>
#include <cpuid.h>
#endif

namespace hvd {

float HalfToFloat(uint16_t h) {
  uint32_t sign = (h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1f;
  uint32_t mant = h & 0x3ffu;
  uint32_t out;
  if (exp == 0) {
    if (mant == 0) {
      out = sign;
    } else {  // subnormal: value = mant * 2^-24; normalize
      int shift = 0;
      while (!(mant & 0x400u)) {
        mant <<= 1;
        ++shift;
      }
      mant &= 0x3ffu;
      // Leading bit at 2^10 after `shift` shifts -> value
      // (1+frac) * 2^(-14-shift) -> float exp field 113-shift.
      out = sign | ((113 - shift) << 23) | (mant << 13);
    }
  } else if (exp == 31) {
    out = sign | 0x7f800000u | (mant << 13);
  } else {
    out = sign | ((exp + 112) << 23) | (mant << 13);
  }
  float f;
  std::memcpy(&f, &out, 4);
  return f;
}

uint16_t FloatToHalf(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  uint32_t sign = (u >> 16) & 0x8000u;
  int32_t exp = static_cast<int32_t>((u >> 23) & 0xff) - 127 + 15;
  uint32_t mant = u & 0x7fffffu;
  if (((u >> 23) & 0xff) == 0xff) {  // inf / nan
    return static_cast<uint16_t>(sign | 0x7c00u | (mant ? 0x200u : 0));
  }
  if (exp >= 31) {  // overflow -> inf
    return static_cast<uint16_t>(sign | 0x7c00u);
  }
  if (exp <= 0) {  // subnormal or underflow
    if (exp < -10) return static_cast<uint16_t>(sign);
    mant |= 0x800000u;
    int shift = 14 - exp;
    uint32_t sub = mant >> shift;
    uint32_t rem = mant & ((1u << shift) - 1);
    uint32_t half = 1u << (shift - 1);
    if (rem > half || (rem == half && (sub & 1))) ++sub;  // RNE
    return static_cast<uint16_t>(sign | sub);
  }
  uint32_t out = sign | (static_cast<uint32_t>(exp) << 10) | (mant >> 13);
  uint32_t rem = mant & 0x1fffu;
  if (rem > 0x1000u || (rem == 0x1000u && (out & 1))) ++out;  // RNE
  return static_cast<uint16_t>(out);
}

uint16_t FloatToBf16(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7f800000u) == 0x7f800000u && (u & 0x7fffffu)) {
    return static_cast<uint16_t>((u >> 16) | 0x40);  // quiet the NaN
  }
  uint32_t lsb = (u >> 16) & 1;
  u += 0x7fffu + lsb;  // round to nearest even
  return static_cast<uint16_t>(u >> 16);
}

float Fp8E4m3ToFloat(uint8_t v) {
  uint32_t sign = static_cast<uint32_t>(v & 0x80u) << 24;
  uint32_t exp = (v >> 3) & 0xfu;
  uint32_t mant = v & 0x7u;
  uint32_t out;
  if (exp == 0xf && mant == 0x7) {
    out = sign | 0x7fc00000u;  // NaN (e4m3fn has no inf)
  } else if (exp == 0) {
    if (mant == 0) {
      out = sign;
    } else {  // subnormal: value = mant/8 * 2^-6; normalize
      int shift = 0;
      while (!(mant & 0x8u)) {
        mant <<= 1;
        ++shift;
      }
      mant &= 0x7u;
      out = sign | ((121 - shift) << 23) | (mant << 20);
    }
  } else {
    out = sign | ((exp + 120) << 23) | (mant << 20);  // bias 7 -> 127
  }
  float f;
  std::memcpy(&f, &out, 4);
  return f;
}

uint8_t FloatToFp8E4m3(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  uint8_t sign = static_cast<uint8_t>((u >> 24) & 0x80u);
  if ((u & 0x7f800000u) == 0x7f800000u)
    return sign | 0x7f;  // inf and NaN both map to NaN (ml_dtypes)
  int32_t exp = static_cast<int32_t>((u >> 23) & 0xff) - 127 + 7;
  uint32_t mant = u & 0x7fffffu;
  if (exp >= 16) return sign | 0x7f;  // beyond rounding range -> NaN
  if (exp <= 0) {  // subnormal target (quantum 2^-9) or underflow
    if (exp < -3) return sign;
    mant |= 0x800000u;
    int shift = 21 - exp;  // note 21 - exp <= 24 here
    uint32_t sub = mant >> shift;
    uint32_t rem = mant & ((1u << shift) - 1);
    uint32_t half = 1u << (shift - 1);
    if (rem > half || (rem == half && (sub & 1))) ++sub;  // RNE
    return static_cast<uint8_t>(sign | sub);
  }
  uint32_t mag = (static_cast<uint32_t>(exp) << 3) | (mant >> 20);
  uint32_t rem = mant & 0xfffffu;
  if (rem > 0x80000u || (rem == 0x80000u && (mag & 1))) ++mag;  // RNE
  // Rounding into (or past) exp 15 / mant 7 is the NaN encoding —
  // ml_dtypes' overflow-to-NaN for values > 448.  The clamp matters for
  // |f| in [496, 512): there the carry would otherwise run past bit 7
  // and corrupt the sign (encode +/-0.0 instead of NaN).
  if (mag > 0x7fu) mag = 0x7fu;
  return static_cast<uint8_t>(sign | mag);
}

uint8_t FloatToFp8E5m2(float f) {
  // Single-step rounding from f32 (routing through fp16 first would
  // double-round: e.g. 52.004 -> half 52.0 -> ties-even 48, where the
  // one-step nearest e5m2 value is 56, which is what ml_dtypes gives).
  uint32_t u;
  std::memcpy(&u, &f, 4);
  uint8_t sign = static_cast<uint8_t>((u >> 24) & 0x80u);
  uint32_t absu = u & 0x7fffffffu;
  if (absu > 0x7f800000u) return sign | 0x7e;  // NaN (quieted)
  if (absu == 0x7f800000u) return sign | 0x7c;  // inf
  int32_t exp = static_cast<int32_t>((u >> 23) & 0xff) - 127 + 15;
  uint32_t mant = u & 0x7fffffu;
  if (exp >= 31) return sign | 0x7c;  // overflow -> inf
  if (exp <= 0) {  // subnormal target (quantum 2^-16) or underflow
    if (exp < -8) return sign;
    mant |= 0x800000u;
    int shift = 22 - exp;
    uint32_t sub = mant >> shift;
    uint32_t rem = mant & ((1u << shift) - 1);
    uint32_t half = 1u << (shift - 1);
    if (rem > half || (rem == half && (sub & 1))) ++sub;  // RNE
    return static_cast<uint8_t>(sign | sub);
  }
  uint32_t out = static_cast<uint32_t>(sign) |
                 (static_cast<uint32_t>(exp) << 2) | (mant >> 21);
  uint32_t rem = mant & 0x1fffffu;
  if (rem > 0x100000u || (rem == 0x100000u && (out & 1))) ++out;  // RNE
  // Rounding carry rolls exp 30/mant 3 into the inf encoding, matching
  // one-step nearest conversion for values above the max finite 57344.
  return static_cast<uint8_t>(out);
}

namespace {

template <typename T>
void CombineTyped(T* dst, const T* in, size_t n, ReduceOp op) {
  switch (op) {
    case ReduceOp::SUM:
    case ReduceOp::AVERAGE:
    case ReduceOp::ADASUM:
      for (size_t i = 0; i < n; ++i) dst[i] = in[i] + dst[i];
      break;
    case ReduceOp::MIN:
      for (size_t i = 0; i < n; ++i) dst[i] = std::min(in[i], dst[i]);
      break;
    case ReduceOp::MAX:
      for (size_t i = 0; i < n; ++i) dst[i] = std::max(in[i], dst[i]);
      break;
    case ReduceOp::PRODUCT:
      for (size_t i = 0; i < n; ++i) dst[i] = in[i] * dst[i];
      break;
  }
}

float CombineF32(float a, float b, ReduceOp op) {
  switch (op) {
    case ReduceOp::SUM:
    case ReduceOp::AVERAGE:
    case ReduceOp::ADASUM:
      return a + b;
    case ReduceOp::MIN:
      return std::min(a, b);
    case ReduceOp::MAX:
      return std::max(a, b);
    case ReduceOp::PRODUCT:
      return a * b;
  }
  return a + b;
}

void CombineBool(uint8_t* dst, const uint8_t* in, size_t n, ReduceOp op) {
  // numpy bool arithmetic: + is OR, * is AND, min/max likewise.
  switch (op) {
    case ReduceOp::SUM:
    case ReduceOp::AVERAGE:
    case ReduceOp::ADASUM:
    case ReduceOp::MAX:
      for (size_t i = 0; i < n; ++i) dst[i] = (in[i] || dst[i]) ? 1 : 0;
      break;
    case ReduceOp::MIN:
    case ReduceOp::PRODUCT:
      for (size_t i = 0; i < n; ++i) dst[i] = (in[i] && dst[i]) ? 1 : 0;
      break;
  }
}

}  // namespace

namespace {

// ---------------------------------------------------------------------
// SIMD fast paths for the sub-32-bit wire dtypes (parity: half.cc:43-77,
// the reference's F16C/AVX fused fp16 sum).  The ring's per-hop combine
// decodes both operands to f32, reduces, and re-encodes RNE — with
// scalar bit-twiddling that is the hot loop of every compressed-wire
// hop.  F16C gives hardware fp16<->f32; bf16 is two integer ops; fp8
// decodes through a 256-entry table.  Dispatch is runtime-gated on
// AVX2+F16C (so the binary still runs on older hosts) and on
// HVD_NO_SIMD=1 (the microbenchmark's scalar baseline switch).

bool SimdAvailable() {
#ifdef HVD_X86
  static const bool ok = [] {
    // CPUID leaf 1 ECX: bit 27 OSXSAVE, bit 28 AVX, bit 29 F16C.
    unsigned eax = 0, ebx = 0, ecx = 0, edx = 0;
    if (!__get_cpuid(1, &eax, &ebx, &ecx, &edx)) return false;
    const bool osxsave = (ecx >> 27) & 1u;
    const bool avx = (ecx >> 28) & 1u;
    const bool f16c = (ecx >> 29) & 1u;
    if (!(osxsave && avx && f16c)) return false;
    // CPUID leaf 7 subleaf 0 EBX bit 5: AVX2.
    if (!__get_cpuid_count(7, 0, &eax, &ebx, &ecx, &edx)) return false;
    if (!((ebx >> 5) & 1u)) return false;
    // XCR0 must show the OS saves XMM (bit 1) and YMM (bit 2) state,
    // else executing VEX-256 ops faults even though the CPU has them.
    uint32_t xcr0_lo, xcr0_hi;
    __asm__ volatile("xgetbv" : "=a"(xcr0_lo), "=d"(xcr0_hi) : "c"(0));
    return (xcr0_lo & 0x6u) == 0x6u;
  }();
  return ok;
#else
  return false;
#endif
}

bool FastPathsRequested() {
  static const bool on = [] {
    const char* e = std::getenv("HVD_NO_SIMD");
    return !(e && e[0] == '1');
  }();
  return on;
}

bool SimdEnabled() { return FastPathsRequested() && SimdAvailable(); }

// The fp8 pairwise tables are plain C++ (no vector ISA) — every
// architecture gets them; HVD_NO_SIMD=1 still forces the scalar
// codec loops so the microbenchmark has its baseline.
bool TablesEnabled() { return FastPathsRequested(); }

#ifdef HVD_X86

__attribute__((target("avx2")))
inline __m256 CombineVec(__m256 a, __m256 b, ReduceOp op) {
  switch (op) {
    case ReduceOp::MIN:
      return _mm256_min_ps(a, b);
    case ReduceOp::MAX:
      return _mm256_max_ps(a, b);
    case ReduceOp::PRODUCT:
      return _mm256_mul_ps(a, b);
    default:  // SUM / AVERAGE / ADASUM accumulate
      return _mm256_add_ps(a, b);
  }
}

__attribute__((target("avx2,f16c")))
void CombineHalfSimd(uint16_t* d, const uint16_t* s, size_t n,
                     ReduceOp op) {
  size_t i = 0;
  for (; i + 8 <= n; i += 8) {
    __m256 a = _mm256_cvtph_ps(
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(s + i)));
    __m256 b = _mm256_cvtph_ps(
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(d + i)));
    __m256 r = CombineVec(a, b, op);
    _mm_storeu_si128(
        reinterpret_cast<__m128i*>(d + i),
        _mm256_cvtps_ph(r, _MM_FROUND_TO_NEAREST_INT |
                               _MM_FROUND_NO_EXC));
  }
  for (; i < n; ++i)
    d[i] = FloatToHalf(CombineF32(HalfToFloat(s[i]), HalfToFloat(d[i]),
                                  op));
}

__attribute__((target("avx2")))
void CombineBf16Simd(uint16_t* d, const uint16_t* s, size_t n,
                     ReduceOp op) {
  size_t i = 0;
  for (; i + 8 <= n; i += 8) {
    __m256i a32 = _mm256_slli_epi32(
        _mm256_cvtepu16_epi32(_mm_loadu_si128(
            reinterpret_cast<const __m128i*>(s + i))), 16);
    __m256i b32 = _mm256_slli_epi32(
        _mm256_cvtepu16_epi32(_mm_loadu_si128(
            reinterpret_cast<const __m128i*>(d + i))), 16);
    __m256 r = CombineVec(_mm256_castsi256_ps(a32),
                          _mm256_castsi256_ps(b32), op);
    // NaN results (inf + -inf, NaN inputs) need the scalar quietization
    // path to stay bit-identical to FloatToBf16; they are vanishingly
    // rare on gradient traffic, so punt the whole block.
    if (_mm256_movemask_ps(_mm256_cmp_ps(r, r, _CMP_UNORD_Q))) {
      for (size_t j = i; j < i + 8; ++j)
        d[j] = FloatToBf16(CombineF32(Bf16ToFloat(s[j]),
                                      Bf16ToFloat(d[j]), op));
      continue;
    }
    // RNE encode: u += 0x7fff + ((u >> 16) & 1); u >>= 16 — the exact
    // integer form FloatToBf16 uses.
    __m256i u = _mm256_castps_si256(r);
    __m256i lsb = _mm256_and_si256(_mm256_srli_epi32(u, 16),
                                   _mm256_set1_epi32(1));
    u = _mm256_add_epi32(
        u, _mm256_add_epi32(lsb, _mm256_set1_epi32(0x7fff)));
    u = _mm256_srli_epi32(u, 16);
    // pack 8 x u32 (low u16 significant) into 8 x u16
    __m256i packed = _mm256_packus_epi32(
        u, _mm256_permute2x128_si256(u, u, 0x01));
    _mm_storeu_si128(reinterpret_cast<__m128i*>(d + i),
                     _mm256_castsi256_si128(packed));
  }
  for (; i < n; ++i)
    d[i] = FloatToBf16(CombineF32(Bf16ToFloat(s[i]), Bf16ToFloat(d[i]),
                                  op));
}

#endif  // HVD_X86

// fp8 pairwise tables: a combine's domain is only 256×256 inputs, so
// one 64 KB table per (dtype, op-class) makes the per-hop hot loop a
// single lookup per element — with exactness inherited from the scalar
// codecs that fill it (decode → CombineF32 → encode, bit for bit).
// Magic-statics make the lazy build thread-safe; build cost is 65536
// scalar combines, microseconds.
int OpClass(ReduceOp op) {
  switch (op) {
    case ReduceOp::MIN:
      return 1;
    case ReduceOp::MAX:
      return 2;
    case ReduceOp::PRODUCT:
      return 3;
    default:  // SUM / AVERAGE / ADASUM all accumulate via +
      return 0;
  }
}

ReduceOp ClassOp(int cls) {
  switch (cls) {
    case 1:
      return ReduceOp::MIN;
    case 2:
      return ReduceOp::MAX;
    case 3:
      return ReduceOp::PRODUCT;
    default:
      return ReduceOp::SUM;
  }
}

template <int KIND, int OPC>  // KIND: 0 = e4m3fn, 1 = e5m2
const uint8_t* Fp8PairTable() {
  static const std::vector<uint8_t>* table = [] {
    auto* t = new std::vector<uint8_t>(65536);
    for (int a = 0; a < 256; ++a) {
      float fa = KIND == 0 ? Fp8E4m3ToFloat(static_cast<uint8_t>(a))
                           : Fp8E5m2ToFloat(static_cast<uint8_t>(a));
      for (int b = 0; b < 256; ++b) {
        float fb = KIND == 0 ? Fp8E4m3ToFloat(static_cast<uint8_t>(b))
                             : Fp8E5m2ToFloat(static_cast<uint8_t>(b));
        float r = CombineF32(fa, fb, ClassOp(OPC));
        (*t)[(a << 8) | b] =
            KIND == 0 ? FloatToFp8E4m3(r) : FloatToFp8E5m2(r);
      }
    }
    return t;
  }();
  return table->data();
}

template <int KIND>
const uint8_t* Fp8PairTableFor(ReduceOp op) {
  switch (OpClass(op)) {
    case 1:
      return Fp8PairTable<KIND, 1>();
    case 2:
      return Fp8PairTable<KIND, 2>();
    case 3:
      return Fp8PairTable<KIND, 3>();
    default:
      return Fp8PairTable<KIND, 0>();
  }
}

void CombineFp8Pairwise(uint8_t* d, const uint8_t* s, size_t n,
                        const uint8_t* table) {
  for (size_t i = 0; i < n; ++i)
    d[i] = table[(static_cast<size_t>(s[i]) << 8) | d[i]];
}

}  // namespace

bool SimdRuntimeAvailable() { return SimdAvailable(); }

void CombineInto(void* dst, const void* incoming, size_t n, DataType dt,
                 ReduceOp op) {
  switch (dt) {
    case DataType::UINT8:
      CombineTyped(static_cast<uint8_t*>(dst),
                   static_cast<const uint8_t*>(incoming), n, op);
      break;
    case DataType::INT8:
      CombineTyped(static_cast<int8_t*>(dst),
                   static_cast<const int8_t*>(incoming), n, op);
      break;
    case DataType::UINT16:
      CombineTyped(static_cast<uint16_t*>(dst),
                   static_cast<const uint16_t*>(incoming), n, op);
      break;
    case DataType::INT16:
      CombineTyped(static_cast<int16_t*>(dst),
                   static_cast<const int16_t*>(incoming), n, op);
      break;
    case DataType::INT32:
      CombineTyped(static_cast<int32_t*>(dst),
                   static_cast<const int32_t*>(incoming), n, op);
      break;
    case DataType::INT64:
      CombineTyped(static_cast<int64_t*>(dst),
                   static_cast<const int64_t*>(incoming), n, op);
      break;
    case DataType::FLOAT32:
      CombineTyped(static_cast<float*>(dst),
                   static_cast<const float*>(incoming), n, op);
      break;
    case DataType::FLOAT64:
      CombineTyped(static_cast<double*>(dst),
                   static_cast<const double*>(incoming), n, op);
      break;
    case DataType::BOOL:
      CombineBool(static_cast<uint8_t*>(dst),
                  static_cast<const uint8_t*>(incoming), n, op);
      break;
    case DataType::FLOAT16: {
      auto* d = static_cast<uint16_t*>(dst);
      auto* s = static_cast<const uint16_t*>(incoming);
#ifdef HVD_X86
      if (SimdEnabled()) {
        CombineHalfSimd(d, s, n, op);
        break;
      }
#endif
      for (size_t i = 0; i < n; ++i)
        d[i] = FloatToHalf(
            CombineF32(HalfToFloat(s[i]), HalfToFloat(d[i]), op));
      break;
    }
    case DataType::BFLOAT16: {
      auto* d = static_cast<uint16_t*>(dst);
      auto* s = static_cast<const uint16_t*>(incoming);
#ifdef HVD_X86
      if (SimdEnabled()) {
        CombineBf16Simd(d, s, n, op);
        break;
      }
#endif
      for (size_t i = 0; i < n; ++i)
        d[i] = FloatToBf16(
            CombineF32(Bf16ToFloat(s[i]), Bf16ToFloat(d[i]), op));
      break;
    }
    case DataType::FLOAT8_E4M3: {
      auto* d = static_cast<uint8_t*>(dst);
      auto* s = static_cast<const uint8_t*>(incoming);
      if (TablesEnabled()) {  // exact pairwise table, one load/element
        CombineFp8Pairwise(d, s, n, Fp8PairTableFor<0>(op));
        break;
      }
      for (size_t i = 0; i < n; ++i)
        d[i] = FloatToFp8E4m3(
            CombineF32(Fp8E4m3ToFloat(s[i]), Fp8E4m3ToFloat(d[i]), op));
      break;
    }
    case DataType::FLOAT8_E5M2: {
      auto* d = static_cast<uint8_t*>(dst);
      auto* s = static_cast<const uint8_t*>(incoming);
      if (TablesEnabled()) {
        CombineFp8Pairwise(d, s, n, Fp8PairTableFor<1>(op));
        break;
      }
      for (size_t i = 0; i < n; ++i)
        d[i] = FloatToFp8E5m2(
            CombineF32(Fp8E5m2ToFloat(s[i]), Fp8E5m2ToFloat(d[i]), op));
      break;
    }
  }
}

namespace {

template <typename T>
void ScaleTyped(T* buf, size_t n, double factor) {
  for (size_t i = 0; i < n; ++i)
    buf[i] = static_cast<T>(buf[i] * static_cast<T>(factor));
}

}  // namespace

void ScaleInPlace(void* buf, size_t n, DataType dt, double factor) {
  switch (dt) {
    case DataType::FLOAT32:
      ScaleTyped(static_cast<float*>(buf), n, factor);
      break;
    case DataType::FLOAT64:
      ScaleTyped(static_cast<double*>(buf), n, factor);
      break;
    case DataType::FLOAT16: {
      auto* b = static_cast<uint16_t*>(buf);
      float f = static_cast<float>(factor);
      for (size_t i = 0; i < n; ++i)
        b[i] = FloatToHalf(HalfToFloat(b[i]) * f);
      break;
    }
    case DataType::BFLOAT16: {
      auto* b = static_cast<uint16_t*>(buf);
      float f = static_cast<float>(factor);
      for (size_t i = 0; i < n; ++i)
        b[i] = FloatToBf16(Bf16ToFloat(b[i]) * f);
      break;
    }
    case DataType::FLOAT8_E4M3: {
      auto* b = static_cast<uint8_t*>(buf);
      float f = static_cast<float>(factor);
      for (size_t i = 0; i < n; ++i)
        b[i] = FloatToFp8E4m3(Fp8E4m3ToFloat(b[i]) * f);
      break;
    }
    case DataType::FLOAT8_E5M2: {
      auto* b = static_cast<uint8_t*>(buf);
      float f = static_cast<float>(factor);
      for (size_t i = 0; i < n; ++i)
        b[i] = FloatToFp8E5m2(Fp8E5m2ToFloat(b[i]) * f);
      break;
    }
    case DataType::INT32: {
      auto* b = static_cast<int32_t*>(buf);
      for (size_t i = 0; i < n; ++i)
        b[i] = static_cast<int32_t>(b[i] * factor);
      break;
    }
    case DataType::INT64: {
      auto* b = static_cast<int64_t*>(buf);
      for (size_t i = 0; i < n; ++i)
        b[i] = static_cast<int64_t>(b[i] * factor);
      break;
    }
    default: {
      // Small integer types: scale through double, truncate like numpy's
      // astype after float multiply.
      size_t isz = ItemSize(dt);
      auto* b = static_cast<uint8_t*>(buf);
      for (size_t i = 0; i < n; ++i) {
        double v = 0;
        switch (dt) {
          case DataType::UINT8: v = b[i]; break;
          case DataType::INT8: v = reinterpret_cast<int8_t*>(b)[i]; break;
          case DataType::UINT16:
            v = reinterpret_cast<uint16_t*>(b)[i];
            break;
          case DataType::INT16:
            v = reinterpret_cast<int16_t*>(b)[i];
            break;
          case DataType::BOOL: v = b[i]; break;
          default: break;
        }
        v *= factor;
        switch (dt) {
          case DataType::UINT8: b[i] = static_cast<uint8_t>(v); break;
          case DataType::INT8:
            reinterpret_cast<int8_t*>(b)[i] = static_cast<int8_t>(v);
            break;
          case DataType::UINT16:
            reinterpret_cast<uint16_t*>(b)[i] = static_cast<uint16_t>(v);
            break;
          case DataType::INT16:
            reinterpret_cast<int16_t*>(b)[i] = static_cast<int16_t>(v);
            break;
          case DataType::BOOL: b[i] = v != 0; break;
          default: break;
        }
      }
      (void)isz;
      break;
    }
  }
}

void AverageInPlace(void* buf, size_t n, DataType dt, int64_t world_size) {
  switch (dt) {
    case DataType::FLOAT16: {
      auto* b = static_cast<uint16_t*>(buf);
      float inv = static_cast<float>(world_size);
      for (size_t i = 0; i < n; ++i)
        b[i] = FloatToHalf(HalfToFloat(b[i]) / inv);
      break;
    }
    case DataType::BFLOAT16: {
      auto* b = static_cast<uint16_t*>(buf);
      float inv = static_cast<float>(world_size);
      for (size_t i = 0; i < n; ++i)
        b[i] = FloatToBf16(Bf16ToFloat(b[i]) / inv);
      break;
    }
    case DataType::FLOAT8_E4M3: {
      auto* b = static_cast<uint8_t*>(buf);
      float inv = static_cast<float>(world_size);
      for (size_t i = 0; i < n; ++i)
        b[i] = FloatToFp8E4m3(Fp8E4m3ToFloat(b[i]) / inv);
      break;
    }
    case DataType::FLOAT8_E5M2: {
      auto* b = static_cast<uint8_t*>(buf);
      float inv = static_cast<float>(world_size);
      for (size_t i = 0; i < n; ++i)
        b[i] = FloatToFp8E5m2(Fp8E5m2ToFloat(b[i]) / inv);
      break;
    }
    case DataType::FLOAT32: {
      auto* b = static_cast<float*>(buf);
      float w = static_cast<float>(world_size);
      for (size_t i = 0; i < n; ++i) b[i] = b[i] / w;
      break;
    }
    case DataType::FLOAT64: {
      auto* b = static_cast<double*>(buf);
      double w = static_cast<double>(world_size);
      for (size_t i = 0; i < n; ++i) b[i] = b[i] / w;
      break;
    }
    default:
      // Integer average: floor-divide (documented divergence from the
      // Python engine, which promotes to float64; averaging integers is
      // rejected at the API layer anyway).
      ScaleInPlace(buf, n, dt, 1.0 / static_cast<double>(world_size));
      break;
  }
}

void AdasumPairF64(const double* a, const double* b, double* out, size_t n) {
  double dot = 0, an = 0, bn = 0;
  for (size_t i = 0; i < n; ++i) {
    dot += a[i] * b[i];
    an += a[i] * a[i];
    bn += b[i] * b[i];
  }
  double acoef = an > 0 ? 1.0 - dot / (2.0 * an) : 1.0;
  double bcoef = bn > 0 ? 1.0 - dot / (2.0 * bn) : 1.0;
  for (size_t i = 0; i < n; ++i) out[i] = acoef * a[i] + bcoef * b[i];
}

void ToF64(const void* src, double* dst, size_t n, DataType dt) {
  switch (dt) {
    case DataType::UINT8: {
      auto* s = static_cast<const uint8_t*>(src);
      for (size_t i = 0; i < n; ++i) dst[i] = s[i];
      break;
    }
    case DataType::INT8: {
      auto* s = static_cast<const int8_t*>(src);
      for (size_t i = 0; i < n; ++i) dst[i] = s[i];
      break;
    }
    case DataType::UINT16: {
      auto* s = static_cast<const uint16_t*>(src);
      for (size_t i = 0; i < n; ++i) dst[i] = s[i];
      break;
    }
    case DataType::INT16: {
      auto* s = static_cast<const int16_t*>(src);
      for (size_t i = 0; i < n; ++i) dst[i] = s[i];
      break;
    }
    case DataType::INT32: {
      auto* s = static_cast<const int32_t*>(src);
      for (size_t i = 0; i < n; ++i) dst[i] = s[i];
      break;
    }
    case DataType::INT64: {
      auto* s = static_cast<const int64_t*>(src);
      for (size_t i = 0; i < n; ++i) dst[i] = static_cast<double>(s[i]);
      break;
    }
    case DataType::FLOAT16: {
      auto* s = static_cast<const uint16_t*>(src);
      for (size_t i = 0; i < n; ++i) dst[i] = HalfToFloat(s[i]);
      break;
    }
    case DataType::BFLOAT16: {
      auto* s = static_cast<const uint16_t*>(src);
      for (size_t i = 0; i < n; ++i) dst[i] = Bf16ToFloat(s[i]);
      break;
    }
    case DataType::FLOAT32: {
      auto* s = static_cast<const float*>(src);
      for (size_t i = 0; i < n; ++i) dst[i] = s[i];
      break;
    }
    case DataType::FLOAT64:
      std::memcpy(dst, src, n * 8);
      break;
    case DataType::BOOL: {
      auto* s = static_cast<const uint8_t*>(src);
      for (size_t i = 0; i < n; ++i) dst[i] = s[i] ? 1.0 : 0.0;
      break;
    }
    case DataType::FLOAT8_E4M3: {
      auto* s = static_cast<const uint8_t*>(src);
      for (size_t i = 0; i < n; ++i) dst[i] = Fp8E4m3ToFloat(s[i]);
      break;
    }
    case DataType::FLOAT8_E5M2: {
      auto* s = static_cast<const uint8_t*>(src);
      for (size_t i = 0; i < n; ++i) dst[i] = Fp8E5m2ToFloat(s[i]);
      break;
    }
  }
}

void FromF64(const double* src, void* dst, size_t n, DataType dt) {
  switch (dt) {
    case DataType::UINT8: {
      auto* d = static_cast<uint8_t*>(dst);
      for (size_t i = 0; i < n; ++i) d[i] = static_cast<uint8_t>(src[i]);
      break;
    }
    case DataType::INT8: {
      auto* d = static_cast<int8_t*>(dst);
      for (size_t i = 0; i < n; ++i) d[i] = static_cast<int8_t>(src[i]);
      break;
    }
    case DataType::UINT16: {
      auto* d = static_cast<uint16_t*>(dst);
      for (size_t i = 0; i < n; ++i) d[i] = static_cast<uint16_t>(src[i]);
      break;
    }
    case DataType::INT16: {
      auto* d = static_cast<int16_t*>(dst);
      for (size_t i = 0; i < n; ++i) d[i] = static_cast<int16_t>(src[i]);
      break;
    }
    case DataType::INT32: {
      auto* d = static_cast<int32_t*>(dst);
      for (size_t i = 0; i < n; ++i) d[i] = static_cast<int32_t>(src[i]);
      break;
    }
    case DataType::INT64: {
      auto* d = static_cast<int64_t*>(dst);
      for (size_t i = 0; i < n; ++i) d[i] = static_cast<int64_t>(src[i]);
      break;
    }
    case DataType::FLOAT16: {
      auto* d = static_cast<uint16_t*>(dst);
      for (size_t i = 0; i < n; ++i)
        d[i] = FloatToHalf(static_cast<float>(src[i]));
      break;
    }
    case DataType::BFLOAT16: {
      auto* d = static_cast<uint16_t*>(dst);
      for (size_t i = 0; i < n; ++i)
        d[i] = FloatToBf16(static_cast<float>(src[i]));
      break;
    }
    case DataType::FLOAT32: {
      auto* d = static_cast<float*>(dst);
      for (size_t i = 0; i < n; ++i) d[i] = static_cast<float>(src[i]);
      break;
    }
    case DataType::FLOAT64:
      std::memcpy(dst, src, n * 8);
      break;
    case DataType::BOOL: {
      auto* d = static_cast<uint8_t*>(dst);
      for (size_t i = 0; i < n; ++i) d[i] = src[i] != 0.0;
      break;
    }
    case DataType::FLOAT8_E4M3: {
      auto* d = static_cast<uint8_t*>(dst);
      for (size_t i = 0; i < n; ++i)
        d[i] = FloatToFp8E4m3(static_cast<float>(src[i]));
      break;
    }
    case DataType::FLOAT8_E5M2: {
      auto* d = static_cast<uint8_t*>(dst);
      for (size_t i = 0; i < n; ++i)
        d[i] = FloatToFp8E5m2(static_cast<float>(src[i]));
      break;
    }
  }
}

}  // namespace hvd
