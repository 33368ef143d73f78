// Fused gather + reconstruct + row select for resident degraded reads,
// hand-written for Hopper (sm_90a).  Built into the same nvcc library as
// gf2_matmul.cu by seaweedfs_tpu_torch/ops/_build.py and called through
// ctypes from seaweedfs_tpu_torch/ops/rs_resident.py (fused_reconstruct,
// fused_reconstruct_blockdiag).
//
// Replaces the TPU kernels of seaweedfs_tpu/ops/rs_resident.py:
//   * _fused_reconstruct (its gather pallas_call, _make_gather_body, and its
//     select pallas_call, _make_select_body): the flat system;
//   * _fused_reconstruct_blockdiag (_make_gather_body_blockdiag and
//     _make_select_body_blockdiag): the g-group block-diagonal system.
// Same function, same prepared matrix and packed meta word.  For request n
// with meta word (units << 5 | row), start = units * 1024, and every byte
// position p < fetch:
//
//   jg  = groups > 1 ? (p % tile) / (tile / groups) : 0
//   out[n, p] = pack_i( parity( sum_{j,s} A[i*m_pad + jg*w_true + row,
//                                            j*k_pad + jg*k + s]
//                                         * bit_j(surv_s[start + p]) ) )
//
// The TPU split this into a DMA gather that wrote every request's k
// survivor slices to a flat HBM buffer and a second kernel that multiplied
// all m_pad rows and kept one (a Mosaic workaround: no single-row VMEM
// slices, no 1-D -> 2-D relayout).  Here one launch does it all: a block
// takes one (request, 4 KiB column span), reads its own meta word, loads
// the k survivor words straight from the resident buffers and writes only
// the wanted row.  Nothing is gathered into device memory, and only the 8
// bit-rows of A for the wanted row are used: 1/m_pad of the TPU select's
// arithmetic.
//
// Bound on an H100 SXM (3.35 TB/s): the function must read k * N * fetch
// survivor bytes and 4N meta bytes and write N * fetch output bytes; its
// int8 work (2 * 8 * 8k * N * fetch) is under a tenth of that time at the
// 1,979 TOP/s int8 peak, so it is bound by bytes.  A small call (64 x 6 KiB
// at k = 10) moves 4.3 MB, about 1.3 us: at that size the launch, not the
// bytes, is the cost.
//
// Design (simple first):
//   * the multiply stays in the bit domain on the CUDA cores (the scheme
//     gf2_matmul.cu used before it moved to the tensor cores): for each
//     (group, output bit, survivor) one 8-bit mask, replicated into a
//     uint32, kept in shared memory; the output bit is the parity of
//     (mask & byte), one LOP3 per (bit, survivor, word);
//   * request starts are multiples of 1024 and fetch is a multiple of 1024
//     (of 4096 block-diagonal), so each thread owns 16 aligned bytes: one
//     uint4 load per survivor, one uint4 store, no ragged edge and no
//     misaligned access (the wrapper checks buffer alignment);
//   * a 16-byte span never straddles a segment (segments are multiples of
//     1024), so a thread uses one group's masks throughout;
//   * the wrapper checks every window against the survivors' length on the
//     host before the launch, so the kernel never reads past a buffer.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBytesPerThread = 16;
constexpr int kSpan = kThreads * kBytesPerThread;  // bytes per block
constexpr int kMaxK = 16;
constexpr int kMaxGroups = 8;
constexpr int kMaxN = 65535;  // requests ride the grid's y dimension
constexpr int kAlign = 1024;
constexpr int kRowBits = 5;

constexpr int kErrArgs = -1;
constexpr int kErrShape = -2;

struct Survivors {
  const uint8_t* p[kMaxK];
};

__global__ void __launch_bounds__(kThreads)
fused_reconstruct_kernel(const int8_t* __restrict__ a, int m_pad, int k_pad,
                         Survivors surv, int k,
                         const int32_t* __restrict__ meta, int fetch,
                         uint8_t* __restrict__ out, int w_true, int groups,
                         int tile) {
  // smask[(jg*8 + i)*k + s]: bit j set iff
  // A[i*m_pad + jg*w_true + row, j*k_pad + jg*k + s] != 0, replicated x4
  __shared__ uint32_t smask[kMaxGroups * 8 * kMaxK];
  const int n = blockIdx.y;
  const int32_t word = __ldg(meta + n);
  const int row = word & ((1 << kRowBits) - 1);
  const long start = (long)(word >> kRowBits) * kAlign;

  const int n_masks = groups * 8 * k;
  for (int e = threadIdx.x; e < n_masks; e += blockDim.x) {
    const int s = e % k;
    const int i = (e / k) % 8;
    const int jg = e / (8 * k);
    const int8_t* arow =
        a + (long)(i * m_pad + jg * w_true + row) * (8 * k_pad) + jg * k + s;
    uint32_t m = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) m |= (arow[j * k_pad] != 0 ? 1u : 0u) << j;
    smask[e] = m * 0x01010101u;
  }
  __syncthreads();

  const int p = blockIdx.x * kSpan + threadIdx.x * kBytesPerThread;
  if (p >= fetch) return;
  const int jg = groups > 1 ? (p % tile) / (tile / groups) : 0;
  const uint32_t* gm = smask + jg * 8 * k;

  uint4 xs[kMaxK];
#pragma unroll
  for (int s = 0; s < kMaxK; ++s) {
    if (s < k)
      xs[s] = __ldg(reinterpret_cast<const uint4*>(surv.p[s] + start + p));
  }
  uint4 o = make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint4 y = make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int s = 0; s < kMaxK; ++s) {
      if (s < k) {
        const uint32_t m = gm[i * k + s];
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
  *reinterpret_cast<uint4*>(out + (long)n * fetch + p) = o;
}

int launch(const void* a, int m_pad, int k_pad, const void* const* survivors,
           int k, const void* meta, int n, int fetch, void* out, int w_true,
           int groups, int tile, void* stream) {
  if (m_pad <= 0 || k <= 0 || k > kMaxK || groups < 1 ||
      groups > kMaxGroups || groups * k > k_pad || n < 0 || n > kMaxN ||
      fetch <= 0 || tile <= 0)
    return kErrArgs;
  if (fetch % kAlign || fetch % tile || tile % (groups * kAlign) ||
      w_true < 0 || (groups > 1 && groups * w_true > m_pad))
    return kErrShape;
  if (n == 0) return 0;
  Survivors surv = {};
  for (int s = 0; s < k; ++s)
    surv.p[s] = static_cast<const uint8_t*>(survivors[s]);
  const dim3 grid((fetch + kSpan - 1) / kSpan, n);
  fused_reconstruct_kernel<<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), m_pad, k_pad, surv, k,
      static_cast<const int32_t*>(meta), fetch, static_cast<uint8_t*>(out),
      w_true, groups, tile);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream`, allocates nothing and does not synchronise.
// Returns 0, a cudaError_t from the launch, or a negative argument error.
// `survivors` is a host array of k device pointers in the matrix's column
// order; `meta` is a device array of n packed words.  groups == 1 is the
// flat system (K2+K3: every byte uses row `row`, w_true is unused); groups
// > 1 the block-diagonal one (K4+K5: segment jg of each `tile` chunk uses
// row jg*w_true + row and the columns of diagonal block jg).
int fused_reconstruct_launch(const void* a, int m_pad, int k_pad,
                             const void* const* survivors, int k,
                             const void* meta, int n, int fetch, void* out,
                             int w_true, int groups, int tile, void* stream) {
  return launch(a, m_pad, k_pad, survivors, k, meta, n, fetch, out,
                groups > 1 ? w_true : 0, groups, tile, stream);
}

const char* fused_reconstruct_error_string(int code) {
  switch (code) {
    case kErrArgs:
      return "invalid arguments (k must be 1..16, groups 1..8, groups*k <= "
             "k_pad, n <= 65535)";
    case kErrShape:
      return "fetch and tile must be multiples of 1024 and of groups*1024";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
