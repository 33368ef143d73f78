// GF(2) matrix apply for Reed-Solomon over GF(256) on Hopper's tensor cores
// (sm_90a).  Built by seaweedfs_tpu_torch/ops/_build.py with nvcc into a
// plain-C shared library and called through ctypes from
// seaweedfs_tpu_torch/ops/rs_cuda.py (gf2_matmul).
//
// Replaces the TPU kernel seaweedfs_tpu/ops/rs_tpu.py:_gf2_matmul_kernel
// (launched by _apply_pallas through pl.pallas_call).  Same function, same
// prepared matrix:
//
//   out[p, c] = pack_i( parity( sum_{j,d} A[i*m_pad + p, j*k_pad + d]
//                                        * bit_j(x[d, c]) ) )
//
// for p < m_out, c < b, with A the bit-major int8 0/1 matrix
// [8*m_pad, 8*k_pad] that prepare_matrix builds and x the u8 shards
// [k, b] (k <= k_pad; the k..k_pad zero rows are implicit, never read).
//
// Bound on an H100 SXM (3.35 TB/s): the function must read k*b input bytes
// and write m_out*b output bytes.  For the flat RS(10,4) encode batch at
// the default 4 MiB stride that is 56 MiB, 17.5 us of HBM.
//
// Design: the product is one binary tensor-core instruction,
//   mma.sync.aligned.m16n8k128.row.col.s32.b1.b1.s32.and.popc,
// which counts the set bits of (data row AND matrix column) over K = 128.
// ops/mma_rate.py measured it on the H100 at 230 G instructions/s (4.5 us
// for the encode's product) against 155 G/s for the u8 m16n8k32 form
// (20 us: more than the bytes), so the binary form carries the product.
//   * M is the data: a byte column of x is one row.  K runs over (input
//     shard s, bit j), j inner, 16 shards per instruction: a column's K
//     vector is its shard bytes side by side, so the operand is a 4x4 byte
//     transpose (8 PRMT per 4 registers of 32 K each), not a bit unpack.
//     Thread (g, t) of a warp supplies shards 16ks + t + 4r (r = 0..3) of
//     8 adjacent columns; they are the rows g and g+8 of 4 M-tiles.
//   * N is the 8*m_pad output bits, in blocks of 32 (4 output rows):
//     n = 8q + 2t + e is output row 4*blk + t, bit 2q + e.  The
//     accumulator layout of m16n8 then hands thread (g, t) all 8 bits of
//     output row 4*blk + t for each of its 8 columns, with no shuffle: the
//     parity is bit 0 of each count, and a byte is the low bytes of its 8
//     counts gathered into two words (PRMT, or IMAD where a count fits a
//     byte), two masks and two multiplies that add the 8 bits into the top
//     byte.  Padding rows of m_pad cost tensor work only.
//   * One output row (m_out = 1, the degraded read of one lost shard) has
//     its own form, so three quarters of the epilogue are not spent on
//     padding rows: N is the 8 bits of row 0 (one n-tile), thread (g, t)
//     gets bits 2t and 2t+1 of its columns, places them, and the four
//     partial bytes of a quad are ORed as they leave shared memory.
//   * The matrix operand (at most 8*m_pad x 8*k_pad bits) is built once
//     per block from a_bm into shared memory in fragment order, with a
//     flag per (32-bit block, K step) that skips the all-zero steps after
//     the first (the off-diagonal blocks of a block-diagonal system).
//   * Loads: a persistent grid (2 blocks per SM where shared memory
//     allows) walks tiles of 1024 columns (two passes of each warp over 64
//     columns; one pass, 512 columns, for a call too small to give every
//     block a 1024-column tile).  16-byte cp.async fills a 2-stage ring,
//     so the next tile loads while one computes, and the first load goes
//     out before the matrix build.  Path
//     0: x and b 16-byte aligned, each chunk is 16 columns.  Path 1 (b %
//     16 != 0, unaligned views): each row takes the aligned chunks that
//     cover it, and the operand reads join aligned shared-memory words with
//     a funnel shift by the row's offset.  Every chunk read holds a byte of
//     the tensor, so it lies inside the 256-byte-aligned allocation.
//   * Output bytes are staged in shared memory, 4 rows at a time, and
//     stored as aligned 16-byte words (path 1 shifts them out of shared
//     memory to the row's alignment; the partial words at a tile's two
//     ends go byte by byte).  No unpacked bit plane or count ever leaves
//     the SM; no tile padding, no pad-then-slice.
// Registers, shared memory and the SASS (BMMA) of every instantiation are
// printed by chip_smoke.py from the build's -Xptxas -v log and cuobjdump.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpCols = 64;                  // 4 M-tiles of 16 columns
constexpr int kPassCols = kWarps * kWarpCols;  // columns per warp pass
constexpr int kMaxPasses = 2;                  // warp passes per tile
constexpr int kRowStride = kMaxPasses * kPassCols + 32;  // rows 8 banks apart
constexpr int kShardsPerStep = 16;             // 16 shards x 8 bits = K 128
constexpr int kMaxSmemBytes = 227 * 1024;
constexpr int kTwoBlocksSmem = 112 * 1024;
constexpr uint32_t kLow = 0x01010101u;         // bit 0 of each byte

// ring depth: tile t+1 loads while tile t computes.  Deeper rings (up to
// 8 stages) ran slower on the H100 once two blocks share each SM.
constexpr int kStages = 2;

// argument errors reported as negative codes (positive = cudaError_t)
constexpr int kErrKPad = -1;
constexpr int kErrSmem = -2;
constexpr int kErrArgs = -3;

__device__ __forceinline__ void mma_b1(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t b0) {
  asm("mma.sync.aligned.m16n8k128.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// The same with C = 0: the first product of a sum needs no zeroed registers.
__device__ __forceinline__ void mma_b1_first(int (&d)[4], uint32_t a0,
                                             uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k128.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%7,%7,%7,%7};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a0), "r"(a1), "r"(b0), "r"(0));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 4 words of 4 columns each (one shard per word) -> 4 words of 4 shards
// each (one column per word): a 4x4 byte transpose.
__device__ __forceinline__ void transpose4(uint32_t x0, uint32_t x1,
                                           uint32_t x2, uint32_t x3,
                                           uint32_t* r) {
  const uint32_t t0 = __byte_perm(x0, x1, 0x5140);
  const uint32_t t1 = __byte_perm(x0, x1, 0x7362);
  const uint32_t t2 = __byte_perm(x2, x3, 0x5140);
  const uint32_t t3 = __byte_perm(x2, x3, 0x7362);
  r[0] = __byte_perm(t0, t2, 0x5410);
  r[1] = __byte_perm(t0, t2, 0x7632);
  r[2] = __byte_perm(t1, t3, 0x5410);
  r[3] = __byte_perm(t1, t3, 0x7632);
}

// The low bytes of 4 counts in one word, byte i from count i.  With
// BYTE_COUNTS (every count < 256) the sum a0 + a1<<8 + ... is exact and
// runs on the multiply pipe, leaving the PRMT pipe to the other half.
template <bool BYTE_COUNTS>
__device__ __forceinline__ uint32_t low_bytes(int a0, int a1, int a2, int a3) {
  if constexpr (BYTE_COUNTS) {
    return static_cast<uint32_t>(a0) + (static_cast<uint32_t>(a1) << 8) +
           (static_cast<uint32_t>(a2) << 16) + (static_cast<uint32_t>(a3) << 24);
  } else {
    return __byte_perm(__byte_perm(a0, a1, 0x0040), __byte_perm(a2, a3, 0x0040),
                       0x5410);
  }
}

// The counts of output bits 0..7 of one byte -> the byte, in bits 24..31.
// Bit 0 of each count is its parity.  With lo = bits 0..3 and hi = bits
// 4..7, one per byte at bit 0, (lo * 0x01020408 + hi * 0x10204080) adds
// byte k shifted by k (by k + 4) into the top byte; the lower partial sums
// stay below 2^24, so no carry reaches it.
template <bool BYTE_COUNTS>
__device__ __forceinline__ uint32_t pack_byte(int a0, int a1, int a2, int a3,
                                              int a4, int a5, int a6,
                                              int a7) {
  const uint32_t lo = __byte_perm(__byte_perm(a0, a1, 0x0040),
                                  __byte_perm(a2, a3, 0x0040), 0x5410);
  const uint32_t hi = low_bytes<BYTE_COUNTS>(a4, a5, a6, a7);
  return (lo & kLow) * 0x01020408u + (hi & kLow) * 0x10204080u;
}

// The k rows of tile columns [c0, c0 + tile) into a stage, by 16-byte
// cp.async; warp w loads rows w, w + 8, ..., lane l chunks l, l + 32, ...
// Path 0 (ALIGNED: x and b 16-byte aligned): chunk q holds columns
// c0 + 16q..; chunks past b are zero-filled.  Path 1: a row starting
// s_d = (x + d*b) % 16 bytes into its first aligned chunk takes the
// tile/16 + 1 aligned chunks that cover it (lane 0 also takes the last),
// so column c0 + u sits at byte s_d + u of the stage row; chunks that
// start past the row's end are not read (every chunk read holds a byte of
// the tensor, so it lies inside the allocation, which is 256-byte
// aligned).
template <bool ALIGNED>
__device__ __forceinline__ void fill(uint8_t* st, const uint8_t* x, int k,
                                     long b, long c0, int tile, int warp,
                                     int lane) {
  const int chunks = tile / 16;
  for (int d = warp; d < k; d += kWarps) {
    const uint8_t* row = x + d * b;
    uint8_t* srow = st + d * kRowStride;
    if constexpr (ALIGNED) {
      const uint8_t* src = row + c0;
      if (c0 + tile <= b) {  // a whole tile: no chunk needs a check
#pragma unroll 2
        for (int q = lane; q < chunks; q += 32)
          cp_async16(srow + 16 * q, src + 16 * q, 16);
      } else {
#pragma unroll 2
        for (int q = lane; q < chunks; q += 32) {
          const bool in = c0 + 16 * q < b;
          cp_async16(srow + 16 * q, in ? src + 16 * q : row, in ? 16 : 0);
        }
      }
    } else {
      const uint8_t* base = reinterpret_cast<const uint8_t*>(
          reinterpret_cast<uintptr_t>(row + c0) & ~uintptr_t{15});
      for (int q = lane; q <= chunks; q += 32) {
        const bool in = base + 16 * q < row + b;
        cp_async16(srow + 16 * q, in ? base + 16 * q : base, in ? 16 : 0);
      }
    }
  }
}

// 16 bytes at byte offset o (o >= 0) of a shared-memory row, from aligned
// words joined by funnel shifts.
__device__ __forceinline__ uint4 lds16_at(const uint8_t* srow, int o) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(srow + (o & ~3));
  const int sh = 8 * (o & 3);
  const uint32_t w0 = w[0], w1 = w[1], w2 = w[2], w3 = w[3], w4 = w[4];
  return make_uint4(__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh),
                    __funnelshift_r(w2, w3, sh), __funnelshift_r(w3, w4, sh));
}

__device__ __forceinline__ uint4 or4(uint4 a, uint4 b) {
  return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
}

// Staged bytes [o, o + 16) of output row r; in the one-row form the OR of
// the four partial rows.
template <bool ALIGNED, bool ONE>
__device__ __forceinline__ uint4 staged16(const uint8_t* os, int r, int o) {
  auto at = [&](int rr) {
    const uint8_t* srow = os + rr * kRowStride;
    if constexpr (ALIGNED) return *reinterpret_cast<const uint4*>(srow + o);
    else return lds16_at(srow, o);
  };
  if constexpr (ONE) return or4(or4(at(0), at(1)), or4(at(2), at(3)));
  else return at(r);
}

// The staged output rows (4*blk .. 4*blk + 3; in the one-row form row 0)
// of the tile at c0 -> out, as aligned 16-byte words: warp w stores row
// 4*blk + w % 4, chunks 32*(w / 4) + lane (+ 64).  Path 0: every row is
// aligned.  Path 1: row p starts a_p = (out + p*b) % 16 bytes into an
// aligned chunk; the tile/16 + 1 chunks that cover the tile's bytes are
// shifted out of shared memory and stored whole where they lie wholly
// inside the tile, byte by byte at its two ends (their other bytes belong
// to the neighbouring tiles).
template <bool ALIGNED, bool ONE>
__device__ __forceinline__ void store_rows(const uint8_t* os, uint8_t* out,
                                           int blk, int m_out, long b,
                                           long c0, int tile, int warp,
                                           int lane) {
  const int chunks = tile / 16;
  const int r = warp & 3;
  const int p = 4 * blk + r;
  if (p >= m_out || (ONE && r != 0)) return;
  uint8_t* d0 = out + p * b + c0;
  const int n = b - c0 < tile ? static_cast<int>(b - c0) : tile;
  if constexpr (ALIGNED) {
#pragma unroll 2
    for (int q = 32 * (warp >> 2) + lane; q < chunks; q += 64)
      if (16 * q < n)
        *reinterpret_cast<uint4*>(d0 + 16 * q) = staged16<true, ONE>(os, r, 16 * q);
    return;
  }
  const int a_p = static_cast<int>(reinterpret_cast<uintptr_t>(d0) & 15);
  for (int q = 32 * (warp >> 2) + lane; q <= chunks; q += 64) {
    const int lo = 16 * q - a_p;
    const int from = lo < 0 ? 0 : lo;
    const int to = lo + 16 < n ? lo + 16 : n;
    if (from == lo && to == lo + 16) {
      *reinterpret_cast<uint4*>(d0 + lo) = staged16<false, ONE>(os, r, lo);
    } else {
      for (int i = from; i < to; ++i) {
        uint8_t v = os[r * kRowStride + i];
        if constexpr (ONE)
          v |= os[kRowStride + i] | os[2 * kRowStride + i] | os[3 * kRowStride + i];
        d0[i] = v;
      }
    }
  }
}

// KS: K steps of the instantiation (k_pad / 16); ALIGNED: load path 0;
// ONE: the one-row form (m_out == 1).
template <int KS, bool ALIGNED, bool ONE>
__global__ void __launch_bounds__(kThreads, 2)
gf2_matmul_kernel(const int8_t* __restrict__ a, int m_pad, int k_pad,
                  const uint8_t* __restrict__ x, int k, long b,
                  uint8_t* __restrict__ out, int m_out, int n_blk,
                  int ks_used, int passes) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int stages = kStages;
  constexpr int nq = ONE ? 1 : 4;  // n-tiles per 32-bit block
  const int stage_bytes = k * kRowStride;
  const int n_bk = n_blk * ks_used;  // (32-bit block, K step) pairs
  uint32_t* bfrag = reinterpret_cast<uint32_t*>(smem + stages * stage_bytes);
  uint8_t* ostage = reinterpret_cast<uint8_t*>(bfrag + n_bk * nq * 32);
  int* nz = reinterpret_cast<int*>(ostage + 2 * 4 * kRowStride);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;

  const int tile = passes * kPassCols;
  const long tiles = (b + tile - 1) / tile;
  const long first = blockIdx.x;
  const long mine = first < tiles ? (tiles - 1 - first) / gridDim.x + 1 : 0;

  // the first tiles' loads go out before the matrix build, to overlap it
#pragma unroll
  for (int s = 0; s < stages - 1; ++s) {
    if (s < mine)
      fill<ALIGNED>(smem + s * stage_bytes, x, k, b,
                    (first + s * gridDim.x) * tile, tile, warp, lane);
    cp_async_commit();
  }

  // the matrix operand in fragment order: word (bk*nq + q)*32 + lane is
  // lane's B register for n-tile q of pair bk; bit 8r + j is
  // A[i*m_pad + p, j*k_pad + s] with s = 16ks + t + 4r and (g = lane/4,
  // t = lane%4) p = 4blk + g/2, i = 2q + g%2, or in the one-row form
  // p = 0, i = g.  Shards 16ks..16ks+15 of bit j are one aligned 16-byte
  // word of A's row.
  for (int e = tid; e < n_bk; e += kThreads) nz[e] = 0;
  __syncthreads();
  for (int e = tid; e < n_bk * nq * 32; e += kThreads) {
    const int ln = e & 31, q = (e >> 5) % nq, bk = (e >> 5) / nq;
    const int ks = bk % ks_used, blk = bk / ks_used;
    const int g = ln >> 2, t = ln & 3;
    const int p = ONE ? 0 : 4 * blk + (g >> 1);
    const int i = ONE ? g : 2 * q + (g & 1);
    uint32_t word = 0;
    if (p < m_pad) {
      const int8_t* row = a + static_cast<long>(i * m_pad + p) * (8 * k_pad) +
                          kShardsPerStep * ks;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + j * k_pad));
        const uint32_t vr[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const bool on = ((vr[r] >> (8 * t)) & 0xFFu) != 0 &&
                          kShardsPerStep * ks + t + 4 * r < k;
          word |= (on ? 1u : 0u) << (8 * r + j);
        }
      }
    }
    bfrag[e] = word;
    if (word) nz[bk] = 1;
  }
  __syncthreads();

  const long step = static_cast<long>(gridDim.x) * tile;
  long c0 = first * tile;                         // tile it's columns
  long c_next = c0 + (stages - 1) * step;          // tile it + stages - 1
  int slot = 0;                                    // tile it's stage
  for (long it = 0; it < mine; ++it, c0 += step, c_next += step) {
    cp_async_wait<stages - 2>();
    __syncthreads();  // tile it landed; tile it-1's stage is free
    if (c_next < b)
      fill<ALIGNED>(smem + (slot == 0 ? stages - 1 : slot - 1) * stage_bytes,
                    x, k, b, c_next, tile, warp, lane);
    cp_async_commit();
    const uint8_t* st = smem + slot * stage_bytes;
    slot = slot == stages - 1 ? 0 : slot + 1;

    for (int blk = 0; blk < n_blk; ++blk) {
      uint8_t* os = ostage + (blk & 1) * 4 * kRowStride;
#pragma unroll 1
      for (int pass = 0; pass < passes; ++pass) {
        const int col = pass * kPassCols + warp * kWarpCols + 8 * gid;
        // data operand: rg[ks][u] is column col + u, byte r = shard
        // 16ks + tig + 4r (zero past k)
        uint32_t rg[KS][8];
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          if (ks < ks_used) {
            uint2 xw[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int d = kShardsPerStep * ks + tig + 4 * r;
              if (d >= k) {
                xw[r] = make_uint2(0u, 0u);
              } else if constexpr (ALIGNED) {
                xw[r] = *reinterpret_cast<const uint2*>(st + d * kRowStride + col);
              } else {
                // column col sits s_d bytes further into the stage row
                const int o = static_cast<int>((reinterpret_cast<uintptr_t>(x) + d * b) & 15) + col;
                const uint32_t* w = reinterpret_cast<const uint32_t*>(st + d * kRowStride + (o & ~3));
                const int sh = 8 * (o & 3);
                const uint32_t w0 = w[0], w1 = w[1], w2 = w[2];
                xw[r] = make_uint2(__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh));
              }
            }
            transpose4(xw[0].x, xw[1].x, xw[2].x, xw[3].x, &rg[ks][0]);
            transpose4(xw[0].y, xw[1].y, xw[2].y, xw[3].y, &rg[ks][4]);
          }
        }
        // acc[mt][q]: M-tile mt (rows gid -> column 2mt, gid+8 -> 2mt+1),
        // n-tile q.  K step 0 always runs (a zero matrix block gives zero
        // counts), so no accumulator needs zeroing; later all-zero steps
        // are skipped.
        int acc[4][nq][4];
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          if (ks == 0 || (ks < ks_used && nz[blk * ks_used + ks])) {
            const uint32_t* bf = bfrag + (blk * ks_used + ks) * nq * 32 + lane;
#pragma unroll
            for (int q = 0; q < nq; ++q) {
              const uint32_t bq = bf[32 * q];
#pragma unroll
              for (int mt = 0; mt < 4; ++mt) {
                if (ks == 0)
                  mma_b1_first(acc[mt][q], rg[0][2 * mt], rg[0][2 * mt + 1], bq);
                else
                  mma_b1(acc[mt][q], rg[ks][2 * mt], rg[ks][2 * mt + 1], bq);
              }
            }
          }
        }
        uint32_t lo, hi;  // the thread's 8 staged bytes, columns col..col+7
        if constexpr (ONE) {
          // acc[mt][0]: bits 2t, 2t+1 (regs 0, 1) of column 2mt, and of
          // column 2mt+1 (regs 2, 3); each lands at its bit of the byte
          const uint32_t m0 = 1u << (2 * tig), m1 = 2u << (2 * tig);
          const uint32_t e0 = low_bytes<false>(acc[0][0][0], acc[0][0][2], acc[1][0][0], acc[1][0][2]);
          const uint32_t e1 = low_bytes<KS == 1>(acc[0][0][1], acc[0][0][3], acc[1][0][1], acc[1][0][3]);
          const uint32_t f0 = low_bytes<false>(acc[2][0][0], acc[2][0][2], acc[3][0][0], acc[3][0][2]);
          const uint32_t f1 = low_bytes<KS == 1>(acc[2][0][1], acc[2][0][3], acc[3][0][1], acc[3][0][3]);
          lo = (e0 & kLow) * m0 + (e1 & kLow) * m1;
          hi = (f0 & kLow) * m0 + (f1 & kLow) * m1;
        } else {
          // acc[mt][q]: bits 2q, 2q+1 of output row 4blk + tig, column 2mt
          // (regs 0, 1) and column 2mt+1 (regs 2, 3)
          uint32_t pb[8];
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            pb[2 * mt] = pack_byte<KS == 1>(
                acc[mt][0][0], acc[mt][0][1], acc[mt][1][0], acc[mt][1][1],
                acc[mt][2][0], acc[mt][2][1], acc[mt][3][0], acc[mt][3][1]);
            pb[2 * mt + 1] = pack_byte<KS == 1>(
                acc[mt][0][2], acc[mt][0][3], acc[mt][1][2], acc[mt][1][3],
                acc[mt][2][2], acc[mt][2][3], acc[mt][3][2], acc[mt][3][3]);
          }
          lo = __byte_perm(__byte_perm(pb[0], pb[1], 0x0073),
                           __byte_perm(pb[2], pb[3], 0x0073), 0x5410);
          hi = __byte_perm(__byte_perm(pb[4], pb[5], 0x0073),
                           __byte_perm(pb[6], pb[7], 0x0073), 0x5410);
        }
        *reinterpret_cast<uint2*>(os + tig * kRowStride + col) = make_uint2(lo, hi);
      }
      __syncthreads();
      store_rows<ALIGNED, ONE>(os, out, blk, m_out, b, c0, tile, warp, lane);
    }
  }
}

template <int KS, bool ALIGNED, bool ONE>
int launch_one(const int8_t* a, int m_pad, int k_pad, const uint8_t* x,
               int k, long b, uint8_t* out, int m_out, cudaStream_t stream) {
  const int n_blk = (m_out + 3) / 4;
  // at least one K step, so k = 0 runs the same code and writes zeros
  const int ks_used = k > 0 ? (k + kShardsPerStep - 1) / kShardsPerStep : 1;
  constexpr int stages = kStages;
  const long smem_l = static_cast<long>(stages) * k * kRowStride +
                      static_cast<long>(n_blk) * ks_used * (ONE ? 1 : 4) * 32 * 4 +
                      2 * 4 * kRowStride + n_blk * ks_used * 4;
  if (smem_l > kMaxSmemBytes) return kErrSmem;
  const int smem = static_cast<int>(smem_l);
  static int smem_set = 48 * 1024;  // per instantiation
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        gf2_matmul_kernel<KS, ALIGNED, ONE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = kMaxSmemBytes;
  }
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  // two passes per tile where there are tiles enough for every block;
  // one below that, so a small call still spreads over the card
  const long slots = static_cast<long>(sms) * (smem <= kTwoBlocksSmem ? 2 : 1);
  const int passes = b >= slots * kMaxPasses * kPassCols ? kMaxPasses : 1;
  const long tiles = (b + passes * kPassCols - 1) / (passes * kPassCols);
  const long blocks = tiles < slots ? tiles : slots;
  gf2_matmul_kernel<KS, ALIGNED, ONE><<<static_cast<unsigned>(blocks),
                                        kThreads, smem, stream>>>(
      a, m_pad, k_pad, x, k, b, out, m_out, n_blk, ks_used, passes);
  return static_cast<int>(cudaGetLastError());
}

template <int KS>
int launch(const int8_t* a, int m_pad, int k_pad, const uint8_t* x, int k,
           long b, uint8_t* out, int m_out, cudaStream_t stream, int* path) {
  const bool aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                       (b & 15) == 0 &&
                       (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  if (path) *path = aligned ? 0 : 1;
  if (m_out == 1)
    return aligned ? launch_one<KS, true, true>(a, m_pad, k_pad, x, k, b, out, m_out, stream)
                   : launch_one<KS, false, true>(a, m_pad, k_pad, x, k, b, out, m_out, stream);
  return aligned ? launch_one<KS, true, false>(a, m_pad, k_pad, x, k, b, out, m_out, stream)
                 : launch_one<KS, false, false>(a, m_pad, k_pad, x, k, b, out, m_out, stream);
}

}  // namespace

extern "C" {

// Launches on `stream`, allocates nothing, does not synchronise.  Returns 0,
// a cudaError_t from the launch, or a negative argument error.  *path (if
// not null) is set to the load path the launch took: 0 for 16-byte-aligned
// rows (x, out and b 16-byte aligned), 1 for shifted rows, -1 for no launch.
int gf2_matmul_launch(const void* a_bm, int m_pad, int k_pad, const void* x,
                      int k, long b, void* out, int m_out, void* stream,
                      int* path) {
  if (path) *path = -1;
  if (m_pad <= 0 || k < 0 || k > k_pad || m_out < 0 || m_out > m_pad ||
      b < 0)
    return kErrArgs;
  if (b == 0 || m_out == 0) return 0;
  const int8_t* a = static_cast<const int8_t*>(a_bm);
  const uint8_t* xp = static_cast<const uint8_t*>(x);
  uint8_t* o = static_cast<uint8_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k_pad) {
    case 16: return launch<1>(a, m_pad, k_pad, xp, k, b, o, m_out, s, path);
    case 32: return launch<2>(a, m_pad, k_pad, xp, k, b, o, m_out, s, path);
    case 48: return launch<3>(a, m_pad, k_pad, xp, k, b, o, m_out, s, path);
    case 64: return launch<4>(a, m_pad, k_pad, xp, k, b, o, m_out, s, path);
    default: return kErrKPad;
  }
}

const char* gf2_matmul_error_string(int code) {
  switch (code) {
    case kErrKPad: return "k_pad must be 16, 32, 48 or 64";
    case kErrSmem: return "matrix and tiles exceed the 227 KB shared memory limit";
    case kErrArgs: return "invalid shape arguments";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
