// CRC32C (Castagnoli) — the needle checksum algorithm.  The reference uses
// Go's hardware-accelerated hash/crc32 Castagnoli table
// (weed/storage/needle/crc.go:7-21); this is the equivalent: SSE4.2
// CRC32 instruction path with a software slicing-by-8 fallback.

#include <cstdint>
#include <cstddef>

#if defined(__x86_64__)
#include <immintrin.h>
#include <cpuid.h>
#endif

namespace {

constexpr uint32_t kPolyRev = 0x82F63B78;  // reversed Castagnoli

struct Crc32cTables {
  uint32_t t[8][256];
  Crc32cTables() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t crc = i;
      for (int j = 0; j < 8; j++)
        crc = (crc >> 1) ^ ((crc & 1) ? kPolyRev : 0);
      t[0][i] = crc;
    }
    for (uint32_t i = 0; i < 256; i++)
      for (int s = 1; s < 8; s++)
        t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

const Crc32cTables& tabs() {
  static Crc32cTables t;
  return t;
}

uint32_t crc_sw(uint32_t crc, const uint8_t* p, size_t n) {
  const Crc32cTables& T = tabs();
  crc = ~crc;
  while (n >= 8) {
    uint64_t w;
    __builtin_memcpy(&w, p, 8);
    w ^= crc;
    crc = T.t[7][w & 0xFF] ^ T.t[6][(w >> 8) & 0xFF] ^
          T.t[5][(w >> 16) & 0xFF] ^ T.t[4][(w >> 24) & 0xFF] ^
          T.t[3][(w >> 32) & 0xFF] ^ T.t[2][(w >> 40) & 0xFF] ^
          T.t[1][(w >> 48) & 0xFF] ^ T.t[0][(w >> 56) & 0xFF];
    p += 8;
    n -= 8;
  }
  while (n--) crc = (crc >> 8) ^ T.t[0][(crc ^ *p++) & 0xFF];
  return ~crc;
}

#if defined(__x86_64__)
bool has_sse42() {
  unsigned eax, ebx, ecx, edx;
  if (__get_cpuid(1, &eax, &ebx, &ecx, &edx)) return ecx & (1u << 20);
  return false;
}

__attribute__((target("sse4.2")))
uint32_t crc_hw(uint32_t crc, const uint8_t* p, size_t n) {
  uint64_t c = ~crc;
  while (n >= 8) {
    uint64_t w;
    __builtin_memcpy(&w, p, 8);
    c = _mm_crc32_u64(c, w);
    p += 8;
    n -= 8;
  }
  uint32_t c32 = static_cast<uint32_t>(c);
  while (n--) c32 = _mm_crc32_u8(c32, *p++);
  return ~c32;
}
#endif

}  // namespace

extern "C" {

// Incremental: pass crc=0 to start, feed previous result to continue.
uint32_t swfs_crc32c(uint32_t crc, const uint8_t* data, size_t n) {
#if defined(__x86_64__)
  static bool hw = has_sse42();
  if (hw) return crc_hw(crc, data, n);
#endif
  return crc_sw(crc, data, n);
}

}  // extern "C"
