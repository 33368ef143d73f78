// Parity scrub of device-resident EC volumes, hand-written for Hopper
// (sm_90a): recompute every parity byte from the resident data shards,
// compare it with the resident parity shard and count the mismatching
// bytes per (volume, parity row, counting segment).  Built into the same
// nvcc library as the other kernels by seaweedfs_tpu_torch/ops/_build.py
// and called through ctypes from seaweedfs_tpu_torch/ops/rs_resident.py
// (scrub, which scrub_volume and scrub_all_resident call).
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
// stacked operand and the recomputed parity in device memory (why the
// reference caps a fused call at 256 MiB of stack); here both live only
// in registers, and the only output is the zeroed int32 [V, p, n_seg]
// partials, which the host sums per row with 64-bit integers.
//
// Bound on an H100 SXM (3.35 TB/s): the function reads k + p bytes per
// column (14 for RS(10,4)) and writes a few counters, so its byte bound
// is (k+p) * n_lanes / 3.35 TB/s.  This first version computes the
// GF(2) product on the CUDA cores, not the tensor cores: per output bit
// the parity of (mask & byte), one LOP3 per (bit, row, data shard, word)
// plus a byte-wise parity fold, about 160 integer instructions per column
// for RS(10,4) — above the byte time on the card's 64 integer lanes per
// SM, so it is bound by its integer issue, not by bytes (PERF.md has its
// share of the bound).  K1's binary-mma mainloop (gf2_matmul.cu) with
// this compare-and-count epilogue is the faster form, for a later change.
//
// Design:
//   * one launch covers up to 32 volumes: grid (spans, volumes).  The
//     parameters (a __grid_constant__ struct, about 6.2 KB) carry every
//     volume's k + p shard base pointers, n_lanes, groups, seg_log2 and
//     the bit masks of the prepared matrix (one 16-byte row per (group,
//     parity row, output bit), byte s the mask of data shard s, as
//     fused_reconstruct.cu takes them), so a block's first memory
//     instruction is a shard load;
//   * a block walks a span of 64 KiB of shard bytes in 16 steps of 4 KiB;
//     each thread owns 16 aligned bytes of a step: one uint4 load per
//     data shard and per parity shard, coalesced across the warp;
//   * the walk is in shard-byte order, so the block-diagonal layout only
//     picks the masks: a thread's group is where its q falls among the
//     groups - 1 boundaries seg, 2*seg, ... (seg is a multiple of 128, so
//     16 bytes never straddle one).  The counting segment is q >>
//     seg_log2, the same as the reference's (jg*seg + c) >> seg_log2;
//   * seg_log2 >= 12, so every 4 KiB step lies in one counting segment
//     and the segment is the same for the whole block.  Each thread
//     counts in registers (at most 256 a span); when a step enters a new
//     segment, and at the end, the block reduces its counts (warp
//     reduce, then shared memory) and does one atomicAdd per (row,
//     segment) it touched with a non-zero count.  A count per segment is
//     below 2^28, so int32 holds it;
//   * steps past n_lanes are skipped, and n_lanes never exceeds a
//     buffer's padded length (checked by the wrapper), so the kernel
//     reads only bytes the cache owns: the zero padding between the true
//     size and n_lanes has zero parity and verifies clean.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBytesPerThread = 16;
constexpr int kStep = kThreads * kBytesPerThread;  // 4 KiB
constexpr int kSteps = 16;
constexpr long kSpan = (long)kStep * kSteps;  // 64 KiB a block
constexpr int kMinSegLog2 = 12;  // a step lies in one counting segment
constexpr int kMaxSegLog2 = 40;
constexpr int kMaxK = 16;
constexpr int kMaxP = 8;
constexpr int kMaxShards = 16;  // k + p a volume
constexpr int kMaxVols = 32;
constexpr int kMaxGroups = 8;
constexpr int kMaxRowSets = 16;  // groups * p in the mask table
constexpr int kLane = 128;

constexpr int kErrArgs = -1;
constexpr int kErrShape = -2;

struct Params {
  // volume v's shard s (k data, then p parity) at shards[v*(k+p) + s]
  const uint8_t* shards[kMaxVols * kMaxShards];
  int* partials;  // [vols, p, n_seg], zeroed on the stream first
  long n_lanes;
  long seg;  // n_lanes / groups
  int k;
  int p;
  int groups;
  int seg_log2;
  int n_seg;
  // masks[(jg*p + j)*8 + i]: byte s is data shard s's mask for output
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

// Adds the block's per-row counts for counting segment `sid` into the
// partials: a warp reduce, the warps' sums in shared memory, one atomicAdd
// per row with a non-zero sum.  Every thread of the block calls it.
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

// kK, kP: the data and parity shards the loops run over.  RS(10,4) has its
// own instantiation with no per-shard predicate; any other code runs
// kMaxK x kMaxP predicated on k and p.
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

}  // namespace

extern "C" {

// The kernel's constants, which the host's model of the walk mirrors:
// bytes a block covers, bytes a step covers, the most volumes a launch
// takes and the least seg_log2.
void scrub_limits(long* span, int* step, int* max_vols, int* min_seg_log2) {
  *span = kSpan;
  *step = kStep;
  *max_vols = kMaxVols;
  *min_seg_log2 = kMinSegLog2;
}

// Zeroes `partials` ([vols, p, n_seg] int32 on the device, n_seg =
// ceil(n_lanes / 2^seg_log2)) and launches one scrub of `vols` volumes on
// `stream`.  `shards` is a host array of vols*(k+p) device pointers,
// volume-major (k data shards, then p parity shards), each 16-byte aligned
// and holding at least n_lanes bytes; `masks` a host array of
// groups*p*8 16-byte rows (see Params).  groups == 1 is the flat system,
// groups > 1 the block-diagonal one (n_lanes a multiple of groups*128).
// Allocates nothing and does not synchronise.  Returns 0, a cudaError_t,
// or a negative argument error.
int scrub_launch(const void* masks, int k, int p, int groups,
                 const void* const* shards, int vols, long n_lanes,
                 int seg_log2, void* partials, void* stream) {
  if (k < 1 || k > kMaxK || p < 1 || p > kMaxP || k + p > kMaxShards ||
      groups < 1 || groups > kMaxGroups || groups * p > kMaxRowSets ||
      vols < 1 || vols > kMaxVols)
    return kErrArgs;
  if (n_lanes <= 0 || n_lanes % ((long)groups * kLane) ||
      seg_log2 < kMinSegLog2 || seg_log2 > kMaxSegLog2)
    return kErrShape;
  // the launch copies the parameters when it is enqueued, so one block
  // per host thread serves every launch
  static thread_local Params prm;
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
  const dim3 grid((unsigned)((n_lanes + kSpan - 1) / kSpan), (unsigned)vols);
  if (k == 10 && p == 4)
    scrub_kernel<10, 4><<<grid, kThreads, 0, st>>>(prm);
  else
    scrub_kernel<kMaxK, kMaxP><<<grid, kThreads, 0, st>>>(prm);
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
