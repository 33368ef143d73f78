// GF(256) Reed-Solomon CPU kernel — the baseline denominator for the TPU
// benchmark, equivalent in role to the reference's klauspost/reedsolomon
// SIMD assembly (AVX2/GFNI nibble-shuffle GF multiply; the reference calls
// it from weed/storage/erasure_coding/ec_encoder.go:198).
//
// Three paths, dispatched at runtime:
//   1. AVX512+GFNI: VGF2P8MULB — hardware GF(2^8) multiply, poly 0x11D,
//      which is exactly the RS field. One multiply per 64 bytes per term.
//   2. SSSE3/AVX2: classic 4-bit split-table PSHUFB (two 16-entry nibble
//      tables per coefficient).
//   3. portable scalar table loop.
//
// API: gf256_apply_matrix(matrix[m*k], m, k, shards[k*B] row-major,
//                         out[m*B], B)
//   out[i] = XOR_j matrix[i*k+j] (x) shards[j]   over GF(256)

#include <cstdint>
#include <cstring>

#if defined(__x86_64__)
#include <immintrin.h>
#include <cpuid.h>
#endif

namespace {

constexpr uint32_t kPoly = 0x11D;

struct Tables {
  uint8_t mul[256][256];      // full multiply table
  uint8_t lo[256][16];        // mul[c][v]        (low nibble)
  uint8_t hi[256][16];        // mul[c][v << 4]   (high nibble)
  Tables() {
    uint8_t exp[512];
    int log[256] = {0};
    uint32_t x = 1;
    for (int i = 0; i < 255; i++) {
      exp[i] = static_cast<uint8_t>(x);
      log[x] = i;
      x <<= 1;
      if (x & 0x100) x ^= kPoly;
    }
    for (int i = 255; i < 510; i++) exp[i] = exp[i - 255];
    for (int a = 0; a < 256; a++)
      for (int b = 0; b < 256; b++)
        mul[a][b] = (a && b) ? exp[log[a] + log[b]] : 0;
    for (int c = 0; c < 256; c++)
      for (int v = 0; v < 16; v++) {
        lo[c][v] = mul[c][v];
        hi[c][v] = mul[c][v << 4];
      }
  }
};

const Tables& tables() {
  static Tables t;
  return t;
}

enum class Isa { kScalar, kAvx2, kGfni512 };

Isa detect() {
#if defined(__x86_64__)
  unsigned eax, ebx, ecx, edx;
  // OS must have enabled the wide register state (OSXSAVE + XCR0 bits),
  // not just the CPU advertising the instructions — otherwise AVX ops
  // SIGILL on xsave-disabled kernels/VMs.
  bool osxsave = false;
  if (__get_cpuid(1, &eax, &ebx, &ecx, &edx)) osxsave = ecx & (1u << 27);
  uint64_t xcr0 = 0;
  if (osxsave) {
    uint32_t lo, hi;  // xgetbv via asm: the intrinsic needs -mxsave globally
    __asm__ volatile("xgetbv" : "=a"(lo), "=d"(hi) : "c"(0));
    xcr0 = lo | (static_cast<uint64_t>(hi) << 32);
  }
  bool ymm_ok = (xcr0 & 0x6) == 0x6;          // XMM+YMM state
  bool zmm_ok = (xcr0 & 0xE6) == 0xE6;        // +opmask, ZMM_Hi256, Hi16_ZMM
  if (__get_cpuid_count(7, 0, &eax, &ebx, &ecx, &edx)) {
    bool avx512f = ebx & (1u << 16);
    bool avx512bw = ebx & (1u << 30);
    bool gfni = ecx & (1u << 8);
    bool avx2 = ebx & (1u << 5);
    if (avx512f && avx512bw && gfni && zmm_ok) return Isa::kGfni512;
    if (avx2 && ymm_ok) return Isa::kAvx2;
  }
#endif
  return Isa::kScalar;
}

void row_scalar(const uint8_t* coefs, int k, const uint8_t* shards,
                long stride, uint8_t* out, long b) {
  const Tables& t = tables();
  std::memset(out, 0, b);
  for (int j = 0; j < k; j++) {
    uint8_t c = coefs[j];
    if (!c) continue;
    const uint8_t* row = t.mul[c];
    const uint8_t* in = shards + j * stride;
    for (long p = 0; p < b; p++) out[p] ^= row[in[p]];
  }
}

#if defined(__x86_64__)

__attribute__((target("avx2")))
void row_avx2(const uint8_t* coefs, int k, const uint8_t* shards, long stride,
              uint8_t* out, long b) {
  const Tables& t = tables();
  const __m256i mask = _mm256_set1_epi8(0x0F);
  long p = 0;
  for (; p + 32 <= b; p += 32) {
    __m256i acc = _mm256_setzero_si256();
    for (int j = 0; j < k; j++) {
      uint8_t c = coefs[j];
      if (!c) continue;
      __m256i lo = _mm256_broadcastsi128_si256(
          _mm_loadu_si128(reinterpret_cast<const __m128i*>(t.lo[c])));
      __m256i hi = _mm256_broadcastsi128_si256(
          _mm_loadu_si128(reinterpret_cast<const __m128i*>(t.hi[c])));
      __m256i x = _mm256_loadu_si256(
          reinterpret_cast<const __m256i*>(shards + j * stride + p));
      __m256i xl = _mm256_and_si256(x, mask);
      __m256i xh = _mm256_and_si256(_mm256_srli_epi64(x, 4), mask);
      acc = _mm256_xor_si256(
          acc, _mm256_xor_si256(_mm256_shuffle_epi8(lo, xl),
                                _mm256_shuffle_epi8(hi, xh)));
    }
    _mm256_storeu_si256(reinterpret_cast<__m256i*>(out + p), acc);
  }
  if (p < b) {
    // scalar tail
    for (long q = p; q < b; q++) out[q] = 0;
    for (int j = 0; j < k; j++) {
      uint8_t c = coefs[j];
      if (!c) continue;
      const uint8_t* row = t.mul[c];
      const uint8_t* in = shards + j * stride;
      for (long q = p; q < b; q++) out[q] ^= row[in[q]];
    }
  }
}

// GF2P8AFFINEQB computes, per byte x: out bit i = parity(A.byte[7-i] & x).
// It is polynomial-agnostic (a GF(2) matrix multiply), so unlike GF2P8MULB
// (hardwired to the AES polynomial 0x11B) it can express multiply-by-c in
// our 0x11D field: A.byte[7-i] has bit j set iff bit i of mul(c, 2^j).
uint64_t affine_matrix(uint8_t c) {
  const Tables& t = tables();
  uint64_t a = 0;
  for (int i = 0; i < 8; i++) {
    uint8_t row = 0;
    for (int j = 0; j < 8; j++)
      row |= static_cast<uint8_t>((t.mul[c][1 << j] >> i) & 1) << j;
    a |= static_cast<uint64_t>(row) << (8 * (7 - i));
  }
  return a;
}

// Processes up to 4 output rows per pass so each shard byte is loaded once
// per row-group instead of once per row.
__attribute__((target("avx512f,avx512bw,gfni")))
void rows_gfni(const uint8_t* matrix, int m, int k, const uint8_t* shards,
               long stride, uint8_t* out, long b) {
  for (int i0 = 0; i0 < m; i0 += 4) {
    int mm = (m - i0 < 4) ? (m - i0) : 4;
    __m512i amat[4][64];  // [row][coef] affine matrices, built per group
    for (int i = 0; i < mm; i++)
      for (int j = 0; j < k; j++)
        amat[i][j] = _mm512_set1_epi64(
            static_cast<long long>(affine_matrix(matrix[(i0 + i) * k + j])));
    long p = 0;
    for (; p + 64 <= b; p += 64) {
      __m512i acc[4] = {_mm512_setzero_si512(), _mm512_setzero_si512(),
                        _mm512_setzero_si512(), _mm512_setzero_si512()};
      for (int j = 0; j < k; j++) {
        __m512i x = _mm512_loadu_si512(shards + j * stride + p);
        for (int i = 0; i < mm; i++)
          acc[i] = _mm512_xor_si512(
              acc[i], _mm512_gf2p8affine_epi64_epi8(x, amat[i][j], 0));
      }
      for (int i = 0; i < mm; i++)
        _mm512_storeu_si512(out + (i0 + i) * b + p, acc[i]);
    }
    if (p < b)
      for (int i = 0; i < mm; i++)
        row_scalar(matrix + (i0 + i) * k, k, shards + p, stride,
                   out + (i0 + i) * b + p, b - p);
  }
}

#endif  // __x86_64__

}  // namespace

extern "C" {

// ISA the dispatcher picked: 0=scalar 1=avx2 2=avx512+gfni
int gf256_isa() { return static_cast<int>(detect()); }

void gf256_apply_matrix(const uint8_t* matrix, int m, int k,
                        const uint8_t* shards, uint8_t* out, long b) {
  static Isa isa = detect();
#if defined(__x86_64__)
  if (isa == Isa::kGfni512 && k <= 64) {
    rows_gfni(matrix, m, k, shards, b, out, b);
    return;
  }
#endif
  for (int i = 0; i < m; i++) {
    const uint8_t* coefs = matrix + i * k;
    uint8_t* o = out + i * b;
    switch (isa) {
#if defined(__x86_64__)
      case Isa::kAvx2:
        row_avx2(coefs, k, shards, b, o, b);
        break;
#endif
      default:
        row_scalar(coefs, k, shards, b, o, b);
    }
  }
}

}  // extern "C"
