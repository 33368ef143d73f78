// Fused gather + reconstruct + row select for resident degraded reads,
// hand-written for Hopper (sm_90a).  Built into the same nvcc library as
// gf2_matmul.cu by seaweedfs_tpu_torch/ops/_build.py and called through
// ctypes from seaweedfs_tpu_torch/ops/rs_resident.py (fused_reconstruct,
// fused_reconstruct_blockdiag and fused_reconstruct_ragged).
//
// Replaces the TPU kernels of seaweedfs_tpu/ops/rs_resident.py:
//   * _fused_reconstruct (its gather pallas_call, _make_gather_body, and its
//     select pallas_call, _make_select_body): the flat system;
//   * _fused_reconstruct_blockdiag (_make_gather_body_blockdiag and
//     _make_select_body_blockdiag): the g-group block-diagonal system.
// Same function, same prepared matrix and packed meta word.  For request n
// with meta word (units << 5 | row), start = units * 1024, its own fetch
// length fetch_n, and every byte position p < fetch_n:
//
//   jg  = groups > 1 ? (p % tile) / (tile / groups) : 0
//   out[off_n + p] = pack_i( parity( sum_{j,s} A[i*m_pad + jg*w_true + row,
//                                               j*k_pad + jg*k + s]
//                                            * bit_j(surv_s[start + p]) ) )
//
// where off_n is the request's offset in one packed output buffer.  The
// JAX package gives every request of a call the same fetch (one call per
// size bucket, so that XLA compiles few shapes); here one launch takes a
// ragged list, so a burst of degraded reads is one launch and one D2H, and
// each request moves only its own bytes rounded up to 1 KiB (4 KiB for the
// g = 4 block-diagonal system).  The uniform call is the same launch with
// a uniform list.
//
// Bound on an H100 SXM (3.35 TB/s): the function reads k survivor bytes
// for every output byte and writes the output once; its int8 work
// (2 * 8 * 8k per output byte) is under a tenth of that time at the 1,979
// TOP/s int8 peak, so it is bound by bytes.  A burst of 64 small reads
// moves a few MB, about a microsecond of bytes: there the cost is latency,
// the launch and the chain of memory trips before the first survivor byte
// arrives.
//
// Design, for latency:
//   * everything a block needs before its survivor loads rides in the
//     kernel's parameters (a __grid_constant__ struct, up to 32,764 bytes
//     since CUDA 12.1): the survivor pointers, the bit masks and the work
//     list.  A block reads its one 8-byte work entry (constant bank), and
//     its threads' first memory instruction is the survivor load: no meta
//     word or matrix in device memory, no mask prologue, no __syncthreads;
//   * the work list has one entry per block, (request, span): the span's
//     survivor offset and wanted row (a meta word advanced by the span), its
//     output offset, its position in the block-diagonal tile and its length
//     (1..4 KiB), built on the host by the launch entry straight into the
//     parameter block from the requests' meta words and fetch lengths.  The
//     grid is 1-D over the entries;
//   * the bit masks are precomputed on the host once per prepared system:
//     for each (group, wanted row, output bit, survivor) one byte whose bit
//     j is A[i*m_pad + jg*w_true + row, j*k_pad + jg*k + s] != 0, 16 bytes
//     per (group, row, bit); a thread replicates a byte to 32 bits with one
//     PRMT and the output bit is the parity of (mask & byte), one LOP3 per
//     (bit, survivor, word);
//   * each thread owns 16 aligned bytes: one uint4 load per survivor, one
//     uint4 store.  Request starts are multiples of 1024 and every length a
//     multiple of 1024 (of groups*1024 block-diagonal), so there is no
//     ragged edge below 1 KiB and a 16-byte span never straddles a segment;
//   * k = 10 (RS(10,4)) has its own instantiation: ten unrolled survivor
//     loads and no per-survivor predicate, 66 registers against the general
//     form's 119;
//   * the kernel comes in a few parameter sizes (work-list capacities), so
//     a small call does not carry a 32 KB parameter block; a list longer
//     than the largest capacity takes more launches, each counted;
//   * the wrapper checks every window against the survivors' length, every
//     row and the alignment on the host before the launch, so the kernel
//     never reads past a buffer.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kBytesPerThread = 16;
// bytes a block covers: 4 KiB beat 2 and 1 KiB on large calls and bursts
// and lost under a microsecond on one-request calls (PERF.md)
constexpr int kSpan = 4096;
constexpr int kThreads = kSpan / kBytesPerThread;
constexpr int kSpanKib = kSpan / 1024;
constexpr int kMaxK = 16;
constexpr int kMaxGroups = 8;
constexpr int kMaxRowSets = 16;  // groups * rows in the mask table
constexpr int kAlign = 1024;
constexpr int kRowBits = 5;
// work entry: x = (survivor offset in KiB) << 5 | row;
//             y = (output offset in KiB) << 12 | (tile phase in KiB) << 2
//                 | (length in KiB - 1)
constexpr int kLenBits = 2;
constexpr int kPhaseBits = 10;
constexpr int kOutShift = kLenBits + kPhaseBits;
constexpr int kMaxTile = (1 << kPhaseBits) * kAlign;  // block-diagonal tile
// the work-list capacities, smallest first; the launch takes the first
// that holds its list.  The largest fills the 32,764-byte parameter space.
constexpr int kCapSmall = 64;
constexpr int kCapMid = 512;
constexpr int kCapLarge = 3816;

static_assert(kSpan % kAlign == 0 && kSpan / kAlign <= (1 << kLenBits),
              "a block's span is 1..4 KiB");
static_assert(kThreads >= 32 && kThreads <= 1024, "block size");

constexpr int kErrArgs = -1;
constexpr int kErrShape = -2;
constexpr int kErrList = -3;

struct Header {
  const uint8_t* surv[kMaxK];
  uint8_t* out;
  int k;
  int groups;
  int tile;  // bytes (groups > 1)
  int seg;   // tile / groups
  int rows;  // wanted rows per group in the mask table
  // masks[(jg*rows + r)*8 + i]: byte s is survivor s's mask for output
  // bit i of wanted row r in group jg
  uint4 masks[kMaxRowSets * 8];
};

template <int kCap>
struct Params {
  Header h;
  uint2 work[kCap];
};

static_assert(sizeof(Params<kCapLarge>) <= 32764,
              "the largest work list must fit the parameter space");

// kK: the survivors the loops run over.  k == 10 (RS(10,4)) has its own
// instantiation with no per-survivor predicate; any other k runs kMaxK
// predicated on s < k.
template <int kK, int kCap>
__global__ void __launch_bounds__(kThreads)
fused_reconstruct_kernel(const __grid_constant__ Params<kCap> prm) {
  const uint2 e = prm.work[blockIdx.x];
  const int local = threadIdx.x * kBytesPerThread;
  if (local >= (int)((e.y & ((1u << kLenBits) - 1)) + 1) * kAlign) return;
  const Header& h = prm.h;
  const long src = (long)(e.x >> kRowBits) * kAlign + local;

  uint4 xs[kK];
#pragma unroll
  for (int s = 0; s < kK; ++s) {
    if (kK != kMaxK || s < h.k)
      xs[s] = __ldg(reinterpret_cast<const uint4*>(h.surv[s] + src));
  }

  const int row = e.x & ((1u << kRowBits) - 1);
  int jg = 0;
  if (h.groups > 1) {
    const int phase = (e.y >> kLenBits) & ((1u << kPhaseBits) - 1);
    jg = ((phase * kAlign + local) % h.tile) / h.seg;
  }
  const uint4* gm = h.masks + (jg * h.rows + row) * 8;

  uint4 o = make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint4 mw = gm[i];
    const uint32_t mv[4] = {mw.x, mw.y, mw.z, mw.w};
    uint4 y = make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int s = 0; s < kK; ++s) {
      if (kK != kMaxK || s < h.k) {
        // byte s of the row's masks, replicated into all four bytes
        const uint32_t m = __byte_perm(mv[s >> 2], 0, (s & 3) * 0x1111);
        y.x ^= xs[s].x & m;
        y.y ^= xs[s].y & m;
        y.z ^= xs[s].z & m;
        y.w ^= xs[s].w & m;
      }
    }
    // byte-wise parity: bit 0 of each byte becomes the XOR of its 8 bits
    y.x ^= y.x >> 4; y.x ^= y.x >> 2; y.x ^= y.x >> 1;
    y.y ^= y.y >> 4; y.y ^= y.y >> 2; y.y ^= y.y >> 1;
    y.z ^= y.z >> 4; y.z ^= y.z >> 2; y.z ^= y.z >> 1;
    y.w ^= y.w >> 4; y.w ^= y.w >> 2; y.w ^= y.w >> 1;
    o.x |= (y.x & 0x01010101u) << i;
    o.y |= (y.y & 0x01010101u) << i;
    o.z |= (y.z & 0x01010101u) << i;
    o.w |= (y.w & 0x01010101u) << i;
  }
  *reinterpret_cast<uint4*>(h.out + (long)(e.y >> kOutShift) * kAlign +
                            local) = o;
}

// Walks a request list's (request, span) entries in order, requests'
// outputs packed back to back: the work list, built on the host straight
// into the launch's parameter block.
struct ListCursor {
  const int32_t* words;
  const int32_t* fetch_kib;
  int n;
  int tile_kib;  // 0: the flat system (no tile phase)
  int r = 0;     // request
  int pos = 0;   // KiB into it
  long out_kib = 0;  // where request r's output starts

  // writes the next `m` entries, output offsets relative to the first's;
  // -> the first's output offset in KiB
  long fill(uint2* work, int m) {
    const long base = out_kib + pos;
    for (int i = 0; i < m; ++i) {
      const int fk = fetch_kib[r];
      const int len = fk - pos < kSpanKib ? fk - pos : kSpanKib;
      const int phase = tile_kib ? pos % tile_kib : 0;
      work[i].x = (uint32_t)words[r] + ((uint32_t)pos << kRowBits);
      work[i].y = ((uint32_t)(out_kib + pos - base) << kOutShift) |
                  ((uint32_t)phase << kLenBits) | (uint32_t)(len - 1);
      pos += kSpanKib;
      if (pos >= fk) {
        out_kib += fk;
        pos = 0;
        ++r;
      }
    }
    return base;
  }
};

template <int kCap>
int launch_cap(const Header& h, ListCursor& cur, int m, cudaStream_t stream,
               long long* param_bytes) {
  // the launch copies the parameters when it is enqueued, so one block
  // per host thread serves every launch
  static thread_local Params<kCap> prm;
  prm.h = h;
  prm.h.out = h.out + cur.fill(prm.work, m) * kAlign;
  if (h.k == 10)
    fused_reconstruct_kernel<10, kCap><<<m, kThreads, 0, stream>>>(prm);
  else
    fused_reconstruct_kernel<kMaxK, kCap><<<m, kThreads, 0, stream>>>(prm);
  *param_bytes += sizeof(Params<kCap>);
  return (int)cudaGetLastError();
}

// Checks a request list; -> its work entries, or a negative error.
long count_entries(const int32_t* words, const int32_t* fetch_kib, int n,
                   int tile_kib) {
  if (n < 0) return kErrList;
  long entries = 0;
  for (int r = 0; r < n; ++r) {
    const int fk = fetch_kib[r];
    if (words[r] < 0 || fk <= 0 || (tile_kib && fk % tile_kib))
      return kErrList;
    entries += (fk + kSpanKib - 1) / kSpanKib;
  }
  return entries;
}

}  // namespace

extern "C" {

// The kernel's constants, which the host's model of the work list
// mirrors: bytes a block covers and the most entries one launch takes.
void fused_reconstruct_limits(int* span, int* max_blocks) {
  *span = kSpan;
  *max_blocks = kCapLarge;
}

// Builds the work list of n requests and launches it on `stream`: one
// launch, or one per kCapLarge entries, each with the smallest parameter
// block that holds its entries.  Allocates nothing and does not
// synchronise.  Returns 0, a cudaError_t from a launch, or a negative
// argument error; `*launches` and `*param_bytes` count what was launched.
// `survivors` is a host array of k device pointers in the matrix's column
// order; `masks` a host array of groups*rows*8 16-byte rows (see Header);
// request r reads from KiB (words[r] >> 5) of every survivor, wants row
// words[r] & 31 and fetches fetch_kib[r] KiB into `out`, the requests'
// outputs back to back.  groups == 1 is the flat system (K2+K3); groups >
// 1 the block-diagonal one (K4+K5: segment jg of each `tile` chunk uses
// group jg's masks).
int fused_reconstruct_launch(const void* masks, int rows, int groups,
                             int tile, const void* const* survivors, int k,
                             const int32_t* words, const int32_t* fetch_kib,
                             int n, void* out, void* stream, int* launches,
                             long long* param_bytes) {
  *launches = 0;
  *param_bytes = 0;
  if (k <= 0 || k > kMaxK || groups < 1 || groups > kMaxGroups ||
      rows < 1 || groups * rows > kMaxRowSets)
    return kErrArgs;
  if (groups > 1 &&
      (tile <= 0 || tile % (groups * kAlign) || tile > kMaxTile))
    return kErrShape;
  const int tile_kib = groups > 1 ? tile / kAlign : 0;
  long left = count_entries(words, fetch_kib, n, tile_kib);
  if (left < 0) return (int)left;
  Header h = {};
  for (int s = 0; s < k; ++s)
    h.surv[s] = static_cast<const uint8_t*>(survivors[s]);
  h.out = static_cast<uint8_t*>(out);
  h.k = k;
  h.groups = groups;
  h.tile = groups > 1 ? tile : 0;
  h.seg = groups > 1 ? tile / groups : 0;
  h.rows = rows;
  std::memcpy(h.masks, masks, sizeof(uint4) * 8 * (size_t)(groups * rows));
  ListCursor cur{words, fetch_kib, n, tile_kib};
  auto st = static_cast<cudaStream_t>(stream);
  while (left > 0) {
    const int m = left < kCapLarge ? (int)left : kCapLarge;
    const int rc =
        m <= kCapSmall ? launch_cap<kCapSmall>(h, cur, m, st, param_bytes)
        : m <= kCapMid ? launch_cap<kCapMid>(h, cur, m, st, param_bytes)
                       : launch_cap<kCapLarge>(h, cur, m, st, param_bytes);
    if (rc != 0) return rc;
    ++*launches;
    left -= m;
  }
  return 0;
}

// The work list fused_reconstruct_launch builds for the same requests,
// launch after launch, each launch's output offsets relative to its
// first entry's, into work[2 * max_entries]: -> the number of entries,
// or a negative argument error.  For tests of the host's model of it.
long fused_reconstruct_work_list(const int32_t* words,
                                 const int32_t* fetch_kib, int n, int groups,
                                 int tile, uint32_t* work, long max_entries) {
  const int tile_kib = groups > 1 ? tile / kAlign : 0;
  const long total = count_entries(words, fetch_kib, n, tile_kib);
  if (total < 0) return total;
  if (total > max_entries) return kErrList;
  ListCursor cur{words, fetch_kib, n, tile_kib};
  auto* w = reinterpret_cast<uint2*>(work);
  for (long done = 0; done < total; done += kCapLarge)
    cur.fill(w + done, total - done < kCapLarge ? (int)(total - done)
                                                : kCapLarge);
  return total;
}

const char* fused_reconstruct_error_string(int code) {
  switch (code) {
    case kErrArgs:
      return "invalid arguments (k must be 1..16, groups 1..8, "
             "groups*rows <= 16)";
    case kErrShape:
      return "tile must be a multiple of groups*1024, at most 1 MiB";
    case kErrList:
      return "invalid request list (a negative meta word, or a fetch that "
             "is not a positive multiple of 1 KiB and of the tile)";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
