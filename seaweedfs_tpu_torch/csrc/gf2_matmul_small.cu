// GF(2) matrix apply for Reed-Solomon over GF(256) on Hopper's CUDA cores
// (sm_90a), for small one-row calls.  Built into the same library as
// gf2_matmul.cu by seaweedfs_tpu_torch/ops/_build.py and called through
// ctypes from seaweedfs_tpu_torch/ops/rs_cuda.py (gf2_matmul_small).
//
// Replaces, with gf2_matmul.cu, the TPU kernel
// seaweedfs_tpu/ops/rs_tpu.py:_gf2_matmul_kernel: the same function and
// prepared matrix,
//
//   out[p, c] = pack_i( parity( sum_{j,d} A[i*m_pad + p, j*k_pad + d]
//                                        * bit_j(x[d, c]) ) )
//
// for p < m_out, c < b (x the u8 shards [k, b], k <= k_pad).
//
// Why a second kernel: the tensor-core kernel (gf2_matmul.cu) stages its
// tiles and output through shared memory, which pays at every size but
// the smallest.  One-row reconstructs of 64 KiB (the host degraded read's
// median needle) and 256 KiB from 16-byte-aligned rows ran 3-5% faster
// here on the H100, timed in turns with it by chip_smoke.py (PERF.md), so
// rs_cuda routes one-row, aligned calls up to SMALL_ONE_ROW_BYTES
// (256 KiB) to this kernel and everything else to the tensor cores.  It
// is bound by launch and memory latency at those sizes, not by its
// integer work.
//
// Design (the port's first K1):
//   * The product stays in the bit domain: multiply-by-constant over
//     GF(256) is, per output bit, the parity of (mask & byte) for an 8-bit
//     mask per (output bit, input shard).  Each block turns A into those
//     masks once, replicated into the 4 bytes of a uint32, and keeps them
//     in shared memory (every thread of a warp reads the same mask: a
//     broadcast, no bank conflict).
//   * Each thread owns 4 adjacent byte columns: one coalesced uint32 load
//     per shard row, XOR-accumulating (x & mask) per output bit, then a
//     byte-wise parity fold and an 8-bit pack, and one uint32 store per
//     output row.  No shared-memory staging and one barrier.
//   * The ragged b edge is masked in the kernel.  A row that starts off a
//     4-byte boundary loads aligned words, two per column word joined by a
//     funnel shift; an aligned word that holds at least one byte of the
//     tensor lies inside its 256-byte-aligned allocation.
//   * It takes any argument gf2_matmul takes (CUDA-core integer work,
//     about 8*m_out*k LOP3 per 4 columns, so it is issue-bound at large
//     m_out*k); rs_cuda sends it only the calls above.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kMaxSmemBytes = 227 * 1024;

// argument errors reported as negative codes (positive = cudaError_t)
constexpr int kErrKPad = -1;
constexpr int kErrSmem = -2;
constexpr int kErrArgs = -3;

template <int KP>
__global__ void __launch_bounds__(kThreads)
gf2_matmul_small_kernel(const int8_t* __restrict__ a, int m_pad,
                  const uint8_t* __restrict__ x, int k, long b,
                  uint8_t* __restrict__ out, int m_out) {
  // smask[(p*8 + i)*KP + d]: bit j set iff A[i*m_pad + p, j*KP + d] != 0,
  // the byte replicated into all four bytes of the word
  extern __shared__ uint32_t smask[];
  const int n_masks = m_out * 8 * KP;
  for (int e = threadIdx.x; e < n_masks; e += blockDim.x) {
    const int d = e % KP;
    const int i = (e / KP) % 8;
    const int p = e / (8 * KP);
    const int8_t* row = a + (long)(i * m_pad + p) * (8 * KP);
    uint32_t m = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) m |= (row[j * KP + d] != 0 ? 1u : 0u) << j;
    smask[e] = m * 0x01010101u;
  }
  __syncthreads();

  const int kq = (k + 3) & ~3;  // masks are consumed four at a time
  const long words = (b + 3) / 4;
  for (long w = (long)blockIdx.x * blockDim.x + threadIdx.x; w < words;
       w += (long)gridDim.x * blockDim.x) {
    const long c0 = w * 4;
    uint32_t xs[KP];
#pragma unroll
    for (int d = 0; d < KP; ++d) {
      uint32_t v = 0;
      if (d < k) {
        // lanes past b hold other bytes; each lane is its own column, and
        // the stores below drop those lanes
        const uintptr_t src = reinterpret_cast<uintptr_t>(x + (long)d * b + c0);
        const int s = (int)(src & 3);
        const uint32_t* base = reinterpret_cast<const uint32_t*>(src - s);
        v = __ldg(base);
        if (s != 0) {
          const uint32_t hi = (c0 + 4 - s < b) ? __ldg(base + 1) : 0u;
          v = __funnelshift_r(v, hi, 8 * s);
        }
      }
      xs[d] = v;
    }
    for (int p = 0; p < m_out; ++p) {
      uint32_t o = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint4* mrow =
            reinterpret_cast<const uint4*>(smask + (p * 8 + i) * KP);
        uint32_t y = 0;
#pragma unroll
        for (int q = 0; q < KP / 4; ++q) {
          if (4 * q < kq) {
            const uint4 mm = mrow[q];
            y ^= xs[4 * q + 0] & mm.x;
            y ^= xs[4 * q + 1] & mm.y;
            y ^= xs[4 * q + 2] & mm.z;
            y ^= xs[4 * q + 3] & mm.w;
          }
        }
        // byte-wise parity: bit 0 of each byte ends up the XOR of its 8 bits
        y ^= y >> 4;
        y ^= y >> 2;
        y ^= y >> 1;
        o |= (y & 0x01010101u) << i;
      }
      uint8_t* dst = out + (long)p * b + c0;
      if ((reinterpret_cast<uintptr_t>(dst) & 3) == 0 && c0 + 4 <= b) {
        *reinterpret_cast<uint32_t*>(dst) = o;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (c0 + c < b) dst[c] = (uint8_t)(o >> (8 * c));
      }
    }
  }
}

template <int KP>
int launch(const int8_t* a, int m_pad, const uint8_t* x, int k, long b,
           uint8_t* out, int m_out, cudaStream_t stream) {
  const int smem = m_out * 8 * KP * (int)sizeof(uint32_t);
  if (smem > kMaxSmemBytes) return kErrSmem;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gf2_matmul_small_kernel<KP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  const long words = (b + 3) / 4;
  long blocks = (words + kThreads - 1) / kThreads;
  if (blocks > (long)sms * kBlocksPerSm) blocks = (long)sms * kBlocksPerSm;
  gf2_matmul_small_kernel<KP><<<(unsigned)blocks, kThreads, smem, stream>>>(
      a, m_pad, x, k, b, out, m_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream`, allocates nothing, does not synchronise.  Returns 0,
// a cudaError_t from the launch, or a negative argument error.
int gf2_matmul_small_launch(const void* a_bm, int m_pad, int k_pad, const void* x,
                      int k, long b, void* out, int m_out, void* stream) {
  if (m_pad <= 0 || k < 0 || k > k_pad || m_out < 0 || m_out > m_pad ||
      b < 0)
    return kErrArgs;
  if (b == 0 || m_out == 0) return 0;
  const int8_t* a = static_cast<const int8_t*>(a_bm);
  const uint8_t* xp = static_cast<const uint8_t*>(x);
  uint8_t* o = static_cast<uint8_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k_pad) {
    case 16: return launch<16>(a, m_pad, xp, k, b, o, m_out, s);
    case 32: return launch<32>(a, m_pad, xp, k, b, o, m_out, s);
    case 48: return launch<48>(a, m_pad, xp, k, b, o, m_out, s);
    case 64: return launch<64>(a, m_pad, xp, k, b, o, m_out, s);
    default: return kErrKPad;
  }
}

const char* gf2_matmul_small_error_string(int code) {
  switch (code) {
    case kErrKPad: return "k_pad must be 16, 32, 48 or 64";
    case kErrSmem: return "mask table exceeds the 227 KB shared memory limit";
    case kErrArgs: return "invalid shape arguments";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
