// Parity scrub of device-resident EC volumes, hand-written for Hopper
// (sm_90a): check every parity byte against the resident data shards and
// count the mismatching bytes per (volume, parity row, counting segment).
// Built into the same nvcc library as the other kernels by
// seaweedfs_tpu_torch/ops/_build.py and called through ctypes from
// seaweedfs_tpu_torch/ops/rs_resident.py (scrub, which scrub_volume and
// scrub_all_resident call).
//
// Replaces the scrub programs of seaweedfs_tpu/ops/rs_resident.py:
// _scrub_call (the flat system), _scrub_call_blockdiag (the g-group
// block-diagonal system over the segment-stacked operand) and
// _scrub_all_call (V volumes stacked along the lanes).  Each stacks the
// data shards, runs the TPU kernel _gf2_matmul_kernel (rs_tpu.py) to get
// the parity rows, and lets XLA compare and sum them per 2^28-byte
// segment.  Same function, same prepared matrix: for volume v, parity row
// j < p and every shard byte q < n_lanes, with seg = n_lanes / groups and
// group jg = q / seg (column c = q - jg*seg of the segment-stacked
// operand),
//
//   par    = pack_i( parity( sum_{b,s} A[i*m_pad + jg*p + j, b*k_pad + jg*k + s]
//                                      * bit_b(data_s[q]) ) )
//   out[v, j, q >> seg_log2] += (par != parity_j[q])
//
// Nothing else leaves the kernel: the JAX programs materialise the
// stacked operand and the recomputed parity in device memory; here the
// only output is the zeroed int32 [V, p, n_seg] partials, which the host
// sums per row with 64-bit integers.
//
// Bound on an H100 SXM (3.35 TB/s): the function reads k + p bytes per
// column (14 for RS(10,4)) and writes a few counters, so its byte bound
// is (k+p) * n_lanes / 3.35 TB/s.
//
// Design: the check is a syndrome on the tensor cores,
//   mma.sync.aligned.m16n8k128.row.col.s32.b1.b1.s32.and.popc,
// K1's instruction (gf2_matmul.cu), which counts the set bits of (row AND
// column) over K = 128.
//   * M is 16 byte columns.  K is 16 shard slots x 8 bits, bit inner:
//     slots 0..k-1 are the data shards and k..k+p-1 the parity shards, so
//     a column's K vector is its k + p shard bytes side by side (a 4x4
//     byte transpose of the loaded words, as K1's operand).  Thread (g, t)
//     of a warp supplies slots t, t+4, t+8 and t+12 (byte r of its word =
//     slot t + 4r); slots at or past k + p are zero registers, never
//     loaded.
//   * N is 32 output bits a block of 4 parity rows (p <= 4 one block,
//     p <= 8 two): n = 8q + 2t + e is row 4*blk + t, bit 2q + e, so the
//     accumulator hands thread (g, t) all 8 bit counts of row 4*blk + t
//     for each of its columns, with no shuffle.
//   * B's column for (row j, bit i) is the row's 16-byte syndrome mask:
//     byte s < k is data shard s's mask of the prepared matrix (bit b set
//     iff the matrix entry for data bit b is), byte k + j is 1 << i (the
//     stored parity bit), every other byte 0.  Bit 0 of the count is then
//     (recomputed bit) XOR (stored bit): a byte mismatches exactly when
//     one of its 8 counts is odd, and the epilogue per (column, row) is
//     an OR of 8 low bits and a count.  The parity is never packed and
//     never compared byte by byte.  scrub_fragments puts the masks in
//     fragment order on the host (one word per (group, N-block, n-tile,
//     lane)); each block copies them to shared memory once, and each warp
//     holds its group's words in registers, reloading them only when its
//     group changes.
//   * Cost at RS(10,4): 4 BMMA per 16-column M-tile, 0.25 a column, and
//     about 20 integer instructions a column (transpose, loads from shared
//     memory, epilogue), against about 160 on the CUDA cores (the earlier
//     form, kept below as scrub_cuda_cores_launch for timing).  Both are
//     under the byte time, so the kernel is bound by its reads.
//   * Loads: a persistent grid (two blocks an SM) walks (volume, tile)
//     pairs of up to 32 volumes, volume-major, tile = kTile (2 KiB) shard
//     bytes aligned to kTile, so with seg_log2 >= 12 a tile lies in one
//     counting segment.  Each tile's k + p rows go to shared memory by
//     16-byte cp.async in a ring of kStages tiles (two tiles in flight
//     while one computes);
//     chunks past n_lanes are zero-filled (src-size 0), never read, and a
//     zero column has a zero syndrome.
//   * Block-diagonal layout: the walk stays in shard-byte order and the
//     layout only picks the masks.  A warp's pass covers 64 columns
//     aligned to 64, and seg is a multiple of 128, so the group is the
//     same for a warp's pass (a tile may straddle a group boundary; a pass
//     never does).
//   * Counts: each thread counts its row in registers; when a tile enters
//     another (volume, segment), and at the end, the block reduces them
//     (shuffles over the 8 threads of a row, then shared memory) and does
//     one atomicAdd per (volume, row, segment) with a non-zero count.  A
//     count per segment is below 2^28, so int32 holds it.
// Registers, shared memory and the BMMA count of every instantiation are
// printed by chip_smoke.py from the build's -Xptxas -v log and cuobjdump.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpCols = 64;                      // 4 M-tiles of 16 columns
constexpr int kPassCols = kWarps * kWarpCols;      // columns a block pass
constexpr int kTile = 2048;                        // shard bytes a tile
constexpr int kPasses = kTile / kPassCols;
constexpr int kRowStride = kTile + 32;             // rows 8 banks apart
constexpr int kChunks = kTile / 16;                // 16-byte chunks a row
// ring depth: tiles t+1 and t+2 load while tile t computes; two blocks
// an SM (87 KB of shared memory each at RS(10,4)), so 16 warps hide the
// latency of the loads from shared memory and of the mma.  Measured
// against 4 KiB tiles with one block an SM, and 2 and 4 stages, by
// ops/scrub_variants.py (PERF.md).
constexpr int kStages = 3;
constexpr int kMinBlocks = 2;                      // blocks an SM must hold
constexpr int kMaxSmemBytes = 227 * 1024;

constexpr int kMinSegLog2 = 12;  // a tile lies in one counting segment
constexpr int kMaxSegLog2 = 40;
constexpr int kMaxK = 16;
constexpr int kMaxP = 8;
constexpr int kMaxShards = 16;   // k + p a volume: the 16 K slots
constexpr int kMaxVols = 32;
constexpr int kMaxGroups = 8;
constexpr int kMaxRowSets = 16;  // groups * p in the mask table
constexpr int kMaxFragSets = 8;  // groups * N-blocks
constexpr int kLane = 128;

static_assert(kTile % kPassCols == 0, "a tile is whole passes");
static_assert((1 << kMinSegLog2) % kTile == 0, "a tile lies in one segment");

constexpr int kErrArgs = -1;
constexpr int kErrShape = -2;

struct Params {
  // volume v's shard s (k data, then p parity) at shards[v*(k+p) + s]
  const uint8_t* shards[kMaxVols * kMaxShards];
  int* partials;  // [vols, p, n_seg], zeroed on the stream first
  long n_lanes;
  long seg;    // n_lanes / groups
  long tiles;  // tiles a volume: ceil(n_lanes / kTile)
  int vols;
  int k;
  int p;
  int groups;
  int seg_log2;
  int n_seg;
  // B fragments: word ((jg*n_blk + nb)*4 + q)*32 + lane (scrub_fragments)
  uint32_t bfrag[kMaxFragSets * 4 * 32];
};

static_assert(sizeof(Params) <= 32764, "parameters must fit 32,764 bytes");

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

// 4 words of 4 columns each (one slot per word) -> 4 words of 4 slots
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

// A block's walk over (volume, tile) pairs, volume-major, gridDim.x apart.
struct Cursor {
  long tile;
  int v;
  __device__ __forceinline__ void next(long step, long tiles) {
    tile += step;
    if (tile >= tiles) {
      const long d = tile / tiles;
      v += static_cast<int>(d);
      tile -= d * tiles;
    }
  }
};

// The k + p rows of tile (v, tile) into a stage: thread x takes chunks x,
// x + kThreads, ... of the rows in order; chunks past n_lanes are
// zero-filled from the row's start (no byte is read).
__device__ __forceinline__ void fill(uint8_t* st, const Params& prm,
                                     const Cursor& c, int n_slots) {
  const uint8_t* const* sh = prm.shards + c.v * n_slots;
  const long c0 = c.tile * kTile;
  for (int e = threadIdx.x; e < n_slots * kChunks; e += kThreads) {
    const int s = e / kChunks, ch = e % kChunks;
    const long q = c0 + 16L * ch;
    const bool in = q < prm.n_lanes;
    cp_async16(st + s * kRowStride + 16 * ch, in ? sh[s] + q : sh[s],
               in ? 16 : 0);
  }
}

// Adds the block's counts for (volume v, counting segment sid) into the
// partials: thread (g, t) of a warp holds row 4*nb + t; a shuffle sum over
// the 8 threads of a row, the warps' sums in shared memory, one atomicAdd
// per row with a non-zero sum.  Every thread of the block calls it.
template <int kNB>
__device__ __forceinline__ void flush(int (&cnt)[kNB], const Params& prm,
                                      int v, long sid, int (*red)[kMaxP]) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb) {
    int s = cnt[nb];
    s += __shfl_xor_sync(0xffffffffu, s, 4);
    s += __shfl_xor_sync(0xffffffffu, s, 8);
    s += __shfl_xor_sync(0xffffffffu, s, 16);
    if (lane < 4) red[warp][4 * nb + lane] = s;
    cnt[nb] = 0;
  }
  __syncthreads();
  if (threadIdx.x < prm.p) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red[w][threadIdx.x];
    if (sum)
      atomicAdd(prm.partials + ((long)v * prm.p + threadIdx.x) * prm.n_seg +
                    sid,
                sum);
  }
  __syncthreads();
}

// The block-diagonal group of shard byte q: the boundaries seg, 2*seg, ...
// at or below it.
__device__ __forceinline__ int group_of(long q, const Params& prm) {
  int jg = 0;
  for (int g = 1; g < prm.groups; ++g) jg += q >= g * prm.seg;
  return jg;
}

// kNB: N-blocks of 4 parity rows (1 for p <= 4, 2 for p <= 8).
template <int kNB>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
scrub_mma_kernel(const __grid_constant__ Params prm) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int red[kWarps][kMaxP];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int n_slots = prm.k + prm.p;
  const int stage_bytes = n_slots * kRowStride;
  uint32_t* bsm = reinterpret_cast<uint32_t*>(smem + kStages * stage_bytes);

  const long step = gridDim.x;
  const long total = prm.tiles * prm.vols;
  const long first = blockIdx.x;
  const long mine = first < total ? (total - 1 - first) / step + 1 : 0;
  if (mine == 0) return;  // the same for the whole block

  // the first tiles' loads go out before the fragments are copied
  const Cursor start{first % prm.tiles, static_cast<int>(first / prm.tiles)};
  Cursor fc = start;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < mine) {
      fill(smem + s * stage_bytes, prm, fc, n_slots);
      fc.next(step, prm.tiles);
    }
    cp_async_commit();
  }
  for (int e = tid; e < prm.groups * kNB * 4 * 32; e += kThreads)
    bsm[e] = prm.bfrag[e];

  // slot t + 4r of this thread's A word exists (zero register otherwise)
  bool has[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) has[r] = tig + 4 * r < n_slots;

  Cursor cc = start;
  int cur_v = cc.v;
  long cur_sid = (cc.tile * kTile) >> prm.seg_log2;
  int cnt[kNB] = {};
  uint32_t breg[kNB][4] = {};
  int cur_jg = -1;
  int slot = 0;
  for (long it = 0; it < mine; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile it landed; tile it-1's stage is free
    if (it + kStages - 1 < mine) {
      fill(smem + (slot == 0 ? kStages - 1 : slot - 1) * stage_bytes, prm,
           fc, n_slots);
      fc.next(step, prm.tiles);
    }
    cp_async_commit();
    const long c0 = cc.tile * kTile;
    const long sid = c0 >> prm.seg_log2;
    if (cc.v != cur_v || sid != cur_sid) {  // the same for the whole block
      flush<kNB>(cnt, prm, cur_v, cur_sid, red);
      cur_v = cc.v;
      cur_sid = sid;
    }
    const uint8_t* st = smem + slot * stage_bytes;
    slot = slot == kStages - 1 ? 0 : slot + 1;
    cc.next(step, prm.tiles);
    // the tile's first group, and where in the tile the next one starts
    // (kTile: not in this tile); a pass past it counts its own group
    const int jg0 = group_of(c0, prm);
    const long nxt = (jg0 + 1) * prm.seg - c0;
    const int split = jg0 + 1 < prm.groups && nxt < kTile ? (int)nxt : kTile;

#pragma unroll 2
    for (int pass = 0; pass < kPasses; ++pass) {
      const int base = pass * kPassCols + warp * kWarpCols;
      const long q0 = c0 + base;
      if (q0 >= prm.n_lanes) break;  // the same for the warp
      const int jg = base < split ? jg0 : group_of(q0, prm);
      if (jg != cur_jg) {
#pragma unroll
        for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            breg[nb][q] = bsm[((jg * kNB + nb) * 4 + q) * 32 + lane];
        cur_jg = jg;
      }
      // data operand: rg[u] is column base + 8*gid + u, byte r = slot
      // tig + 4r
      const int col = base + 8 * gid;
      uint2 xw[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        xw[r] = has[r] ? *reinterpret_cast<const uint2*>(
                             st + (tig + 4 * r) * kRowStride + col)
                       : make_uint2(0u, 0u);
      uint32_t rg[8];
      transpose4(xw[0].x, xw[1].x, xw[2].x, xw[3].x, &rg[0]);
      transpose4(xw[0].y, xw[1].y, xw[2].y, xw[3].y, &rg[4]);
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb) {
        // acc[mt][q]: M-tile mt (row gid -> column 2mt, gid+8 -> 2mt+1),
        // n-tile q: bits 2q, 2q+1 of row 4nb + tig (regs 0, 1 and 2, 3)
        int acc[4][4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int mt = 0; mt < 4; ++mt)
            mma_b1_first(acc[mt][q], rg[2 * mt], rg[2 * mt + 1], breg[nb][q]);
        int bad = 0;
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            int o = 0;
#pragma unroll
            for (int q = 0; q < 4; ++q) o |= acc[mt][q][2 * h] | acc[mt][q][2 * h + 1];
            bad += o & 1;
          }
        cnt[nb] += bad;
      }
    }
  }
  flush<kNB>(cnt, prm, cur_v, cur_sid, red);
}

int check_args(int k, int p, int groups, int vols, long n_lanes,
               int seg_log2) {
  if (k < 1 || k > kMaxK || p < 1 || p > kMaxP || k + p > kMaxShards ||
      groups < 1 || groups > kMaxGroups || groups * p > kMaxRowSets ||
      vols < 1 || vols > kMaxVols)
    return kErrArgs;
  if (n_lanes <= 0 || n_lanes % ((long)groups * kLane) ||
      seg_log2 < kMinSegLog2 || seg_log2 > kMaxSegLog2)
    return kErrShape;
  return 0;
}

int n_blocks_of(int p) { return (p + 3) / 4; }

long smem_bytes(int k, int p, int groups) {
  return (long)kStages * (k + p) * kRowStride +
         (long)groups * n_blocks_of(p) * 4 * 32 * 4;
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    sms = n > 0 ? n : 1;
  }
  return sms;
}

// Blocks an SM holds for this instantiation and shared memory (after
// raising the instantiation's dynamic shared memory limit once), or a
// negative cudaError_t.
template <int kNB>
int occupancy(int smem) {
  static bool raised = false;
  if (!raised) {
    // the block's limit holds the static shared memory (red) too
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, scrub_mma_kernel<kNB>);
    if (e != cudaSuccess) return -(int)e;
    e = cudaFuncSetAttribute(
        scrub_mma_kernel<kNB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmemBytes - (int)attr.sharedSizeBytes);
    if (e != cudaSuccess) return -(int)e;
    raised = true;
  }
  int n = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, scrub_mma_kernel<kNB>, kThreads, smem);
  if (e != cudaSuccess) return -(int)e;
  return n;
}

template <int kNB>
int launch(const Params& prm, int smem, cudaStream_t st) {
  const int per_sm = occupancy<kNB>(smem);
  if (per_sm < 0) return -per_sm;
  if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  const long total = prm.tiles * prm.vols;
  const long slots = (long)sm_count() * per_sm;
  const long blocks = total < slots ? total : slots;
  scrub_mma_kernel<kNB><<<(unsigned)blocks, kThreads, smem, st>>>(prm);
  return (int)cudaGetLastError();
}

// The earlier form of the kernel, on the CUDA cores: recompute every
// parity byte from the data shards (one LOP3 per output bit, parity row,
// data shard and 16-byte word, then a byte-parity fold), compare and
// count the non-zero bytes; about 160 integer instructions a column for
// RS(10,4), so its integer instruction rate binds.  Kept only to be timed
// beside the tensor-core kernel (chip_smoke.py phase 6a and a card test);
// nothing on the main path launches it.  It reads bytes s < k of the same
// mask rows and ignores the syndrome bytes.
namespace cuda_cores {

constexpr int kThreads = 256;
constexpr int kBytesPerThread = 16;
constexpr int kStep = kThreads * kBytesPerThread;  // 4 KiB
constexpr int kSteps = 16;
constexpr long kSpan = (long)kStep * kSteps;  // 64 KiB a block

struct Params {
  const uint8_t* shards[kMaxVols * kMaxShards];
  int* partials;
  long n_lanes;
  long seg;
  int k;
  int p;
  int groups;
  int seg_log2;
  int n_seg;
  // masks[(jg*p + j)*8 + i]: byte s < k is data shard s's mask for output
  // bit i of parity row j in group jg
  uint4 masks[kMaxRowSets * 8];
};

static_assert(sizeof(Params) <= 32764, "parameters must fit 32,764 bytes");

__device__ __forceinline__ int nonzero_bytes(uint32_t w) {
  w |= w >> 4;
  w |= w >> 2;
  w |= w >> 1;
  return __popc(w & 0x01010101u);
}

__device__ __forceinline__ uint32_t byte_parity(uint32_t y) {
  y ^= y >> 4;
  y ^= y >> 2;
  y ^= y >> 1;
  return y & 0x01010101u;
}

template <int kP>
__device__ __forceinline__ void flush(int (&cnt)[kMaxP], const Params& prm,
                                      int v, long sid,
                                      int (*red)[kMaxP]) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < kP; ++j) {
    const int s = __reduce_add_sync(0xffffffffu, cnt[j]);
    if (lane == 0) red[warp][j] = s;
    cnt[j] = 0;
  }
  __syncthreads();
  if (threadIdx.x < prm.p) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) sum += red[w][threadIdx.x];
    if (sum)
      atomicAdd(prm.partials + ((long)v * prm.p + threadIdx.x) * prm.n_seg +
                    sid,
                sum);
  }
  __syncthreads();
}

// grid (64 KiB spans, volumes); a block walks its span in 16 steps of
// 4 KiB, each thread 16 aligned bytes a step.  kK, kP: RS(10,4) unrolled,
// any other code kMaxK x kMaxP predicated on k and p.
template <int kK, int kP>
__global__ void __launch_bounds__(kThreads)
scrub_kernel(const __grid_constant__ Params prm) {
  __shared__ int red[kThreads / 32][kMaxP];
  const bool general = kK == kMaxK;
  const int k = general ? prm.k : kK;
  const int p = general ? prm.p : kP;
  const int v = blockIdx.y;
  const uint8_t* const* sh = prm.shards + v * (k + p);
  const long span0 = (long)blockIdx.x * kSpan;
  const int local = threadIdx.x * kBytesPerThread;

  int cnt[kMaxP] = {};
  long cur = span0 >> prm.seg_log2;
  for (int it = 0; it < kSteps; ++it) {
    const long base = span0 + (long)it * kStep;
    if (base >= prm.n_lanes) break;  // the same for every thread
    const long sid = base >> prm.seg_log2;
    if (sid != cur) {
      flush<kP>(cnt, prm, v, cur, red);
      cur = sid;
    }
    const long q = base + local;
    if (q >= prm.n_lanes) continue;

    int jg = 0;
    for (int g = 1; g < prm.groups; ++g) jg += q >= g * prm.seg;

    uint4 xs[kK];
#pragma unroll
    for (int s = 0; s < kK; ++s) {
      if (!general || s < k)
        xs[s] = __ldg(reinterpret_cast<const uint4*>(sh[s] + q));
    }
#pragma unroll
    for (int j = 0; j < kP; ++j) {
      if (general && j >= p) continue;
      const uint4 par = __ldg(reinterpret_cast<const uint4*>(sh[k + j] + q));
      const uint4* gm = prm.masks + (jg * p + j) * 8;
      uint4 o = make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint4 mw = gm[i];
        const uint32_t mv[4] = {mw.x, mw.y, mw.z, mw.w};
        uint4 y = make_uint4(0, 0, 0, 0);
#pragma unroll
        for (int s = 0; s < kK; ++s) {
          if (!general || s < k) {
            // byte s of the row's masks, replicated into all four bytes
            const uint32_t m = __byte_perm(mv[s >> 2], 0, (s & 3) * 0x1111);
            y.x ^= xs[s].x & m;
            y.y ^= xs[s].y & m;
            y.z ^= xs[s].z & m;
            y.w ^= xs[s].w & m;
          }
        }
        o.x |= byte_parity(y.x) << i;
        o.y |= byte_parity(y.y) << i;
        o.z |= byte_parity(y.z) << i;
        o.w |= byte_parity(y.w) << i;
      }
      cnt[j] += nonzero_bytes(o.x ^ par.x) + nonzero_bytes(o.y ^ par.y) +
                nonzero_bytes(o.z ^ par.z) + nonzero_bytes(o.w ^ par.w);
    }
  }
  flush<kP>(cnt, prm, v, cur, red);
}

}  // namespace cuda_cores

}  // namespace

extern "C" {

// The kernel's constants, which the host's model of the walk mirrors:
// shard bytes a tile covers, columns a warp's pass covers (the unit the
// block-diagonal group is picked for), the most volumes a launch takes
// and the least seg_log2.
void scrub_limits(long* tile, int* pass_cols, int* max_vols,
                  int* min_seg_log2) {
  *tile = kTile;
  *pass_cols = kWarpCols;
  *max_vols = kMaxVols;
  *min_seg_log2 = kMinSegLog2;
}

// The B fragments of the tensor-core kernel from the mask table `masks`
// (groups*p*8 rows of 16 bytes; row (jg*p + j)*8 + i holds at byte s the
// K slot s's mask for bit i of parity row j: data masks and the syndrome
// byte): word ((jg*n_blk + nb)*4 + q)*32 + lane, n_blk = ceil(p / 4), is
// lane (g, t)'s B register for n-tile q of N-block nb, column g: byte r
// is slot t + 4r of row 4*nb + g/2, bit 2q + g%2 (zero past row p).
// Writes groups*n_blk*128 words to `out` and returns that count, or a
// negative argument error.
int scrub_fragments(const void* masks, int k, int p, int groups,
                    uint32_t* out) {
  if (check_args(k, p, groups, 1, (long)groups * kLane, kMinSegLog2))
    return kErrArgs;
  const uint8_t* m = static_cast<const uint8_t*>(masks);
  const int n_blk = n_blocks_of(p);
  int e = 0;
  for (int jg = 0; jg < groups; ++jg)
    for (int nb = 0; nb < n_blk; ++nb)
      for (int q = 0; q < 4; ++q)
        for (int lane = 0; lane < 32; ++lane, ++e) {
          const int g = lane >> 2, t = lane & 3;
          const int j = 4 * nb + (g >> 1), i = 2 * q + (g & 1);
          uint32_t word = 0;
          if (j < p) {
            const uint8_t* row = m + ((jg * p + j) * 8 + i) * 16;
            for (int r = 0; r < 4; ++r)
              word |= (uint32_t)row[t + 4 * r] << (8 * r);
          }
          out[e] = word;
        }
  return e;
}

// Blocks an SM holds for a launch of this code (k, p) and `groups`, as
// the launch sizes its persistent grid; or a negative error.
int scrub_blocks_per_sm(int k, int p, int groups) {
  if (check_args(k, p, groups, 1, (long)groups * kLane, kMinSegLog2))
    return kErrArgs;
  const int smem = (int)smem_bytes(k, p, groups);
  const int n = n_blocks_of(p) == 1 ? occupancy<1>(smem) : occupancy<2>(smem);
  return n < 0 ? kErrShape : n;
}

// Zeroes `partials` ([vols, p, n_seg] int32 on the device, n_seg =
// ceil(n_lanes / 2^seg_log2)) and launches one scrub of `vols` volumes on
// `stream`.  `shards` is a host array of vols*(k+p) device pointers,
// volume-major (k data shards, then p parity shards), each 16-byte aligned
// and holding at least n_lanes bytes; `masks` a host array of
// groups*p*8 16-byte rows (see scrub_fragments).  groups == 1 is the flat
// system, groups > 1 the block-diagonal one (n_lanes a multiple of
// groups*128).  Allocates nothing and does not synchronise.  Returns 0, a
// cudaError_t, or a negative argument error.
int scrub_launch(const void* masks, int k, int p, int groups,
                 const void* const* shards, int vols, long n_lanes,
                 int seg_log2, void* partials, void* stream) {
  const int bad = check_args(k, p, groups, vols, n_lanes, seg_log2);
  if (bad) return bad;
  // the launch copies the parameters when it is enqueued, so one block
  // per host thread serves every launch
  static thread_local Params prm;
  std::memset(&prm, 0, sizeof(prm));
  for (int i = 0; i < vols * (k + p); ++i)
    prm.shards[i] = static_cast<const uint8_t*>(shards[i]);
  prm.partials = static_cast<int*>(partials);
  prm.n_lanes = n_lanes;
  prm.seg = n_lanes / groups;
  prm.tiles = (n_lanes + kTile - 1) / kTile;
  prm.vols = vols;
  prm.k = k;
  prm.p = p;
  prm.groups = groups;
  prm.seg_log2 = seg_log2;
  const long n_seg = (n_lanes + (1L << seg_log2) - 1) >> seg_log2;
  prm.n_seg = (int)n_seg;
  scrub_fragments(masks, k, p, groups, prm.bfrag);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(
      partials, 0, sizeof(int) * (size_t)vols * p * n_seg, st);
  if (e != cudaSuccess) return (int)e;
  const int smem = (int)smem_bytes(k, p, groups);
  return n_blocks_of(p) == 1 ? launch<1>(prm, smem, st)
                             : launch<2>(prm, smem, st);
}

// The same call on the CUDA-core form (see namespace cuda_cores): the
// same arguments, masks and partials.
int scrub_cuda_cores_launch(const void* masks, int k, int p, int groups,
                            const void* const* shards, int vols,
                            long n_lanes, int seg_log2, void* partials,
                            void* stream) {
  const int bad = check_args(k, p, groups, vols, n_lanes, seg_log2);
  if (bad) return bad;
  static thread_local cuda_cores::Params prm;
  std::memset(&prm, 0, sizeof(prm));
  for (int i = 0; i < vols * (k + p); ++i)
    prm.shards[i] = static_cast<const uint8_t*>(shards[i]);
  prm.partials = static_cast<int*>(partials);
  prm.n_lanes = n_lanes;
  prm.seg = n_lanes / groups;
  prm.k = k;
  prm.p = p;
  prm.groups = groups;
  prm.seg_log2 = seg_log2;
  const long n_seg = (n_lanes + (1L << seg_log2) - 1) >> seg_log2;
  prm.n_seg = (int)n_seg;
  std::memcpy(prm.masks, masks, sizeof(uint4) * 8 * (size_t)(groups * p));
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(
      partials, 0, sizeof(int) * (size_t)vols * p * n_seg, st);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((n_lanes + cuda_cores::kSpan - 1) /
                            cuda_cores::kSpan),
                  (unsigned)vols);
  if (k == 10 && p == 4)
    cuda_cores::scrub_kernel<10, 4><<<grid, cuda_cores::kThreads, 0, st>>>(prm);
  else
    cuda_cores::scrub_kernel<kMaxK, kMaxP>
        <<<grid, cuda_cores::kThreads, 0, st>>>(prm);
  return (int)cudaGetLastError();
}

const char* scrub_error_string(int code) {
  switch (code) {
    case kErrArgs:
      return "invalid arguments (k 1..16, p 1..8, k+p <= 16, groups 1..8, "
             "groups*p <= 16, 1..32 volumes)";
    case kErrShape:
      return "n_lanes must be a positive multiple of groups*128 and "
             "seg_log2 12..40";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
