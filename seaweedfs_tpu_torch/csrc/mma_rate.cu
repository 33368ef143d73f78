// Tensor-core instruction rates of the two forms that can carry the GF(2)
// product of gf2_matmul.cu on Hopper (sm_90a):
//
//   form 0  mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32
//   form 1  mma.sync.aligned.m16n8k128.row.col.s32.b1.b1.s32.and.popc
//   form 2  mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc
//
// Every warp of a full grid issues `iters` rounds of kChains independent
// accumulator chains of one form and nothing else, so the time is the
// card's issue rate for that instruction.  Built on its own by
// seaweedfs_tpu_torch/ops/mma_rate.py, which times it and reports the rate.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChains = 8;

__device__ __forceinline__ void mma_u8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_b1_k128(int (&d)[4],
                                            const uint32_t (&a)[4],
                                            const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k128.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b[0]));
}

__device__ __forceinline__ void mma_b1_k256(int (&d)[4],
                                            const uint32_t (&a)[4],
                                            const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int FORM>
__global__ void __launch_bounds__(kThreads)
mma_rate_kernel(int iters, int* sink) {
  const uint32_t t = threadIdx.x * 0x9E3779B9u + blockIdx.x;
  const uint32_t a[4] = {t, t ^ 0x5bd1e995u, t * 3u, t + 0x7f4a7c15u};
  const uint32_t b[2] = {t >> 3, ~t};
  int acc[kChains][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      if (FORM == 0) mma_u8(acc[c], a, b);
      if (FORM == 1) mma_b1_k128(acc[c], a, b);
      if (FORM == 2) mma_b1_k256(acc[c], a, b);
    }
  }
  int s = 0;
#pragma unroll
  for (int c = 0; c < kChains; ++c) s ^= acc[c][0] ^ acc[c][1] ^ acc[c][2] ^ acc[c][3];
  if (s == 0x7fffffff) sink[0] = s;  // keeps the chains alive
}

}  // namespace

extern "C" {

// Launches `blocks` x 256 threads of form `form` for `iters` rounds and
// returns the elapsed milliseconds in *ms (events around the launch).
// Returns 0 or a cudaError_t; -1 for an unknown form.
int mma_rate_run(int form, int iters, int blocks, float* ms) {
  int* sink = nullptr;
  cudaError_t e = cudaMalloc(&sink, sizeof(int));
  if (e != cudaSuccess) return (int)e;
  cudaEvent_t t0, t1;
  cudaEventCreate(&t0);
  cudaEventCreate(&t1);
  cudaEventRecord(t0);
  switch (form) {
    case 0: mma_rate_kernel<0><<<blocks, kThreads>>>(iters, sink); break;
    case 1: mma_rate_kernel<1><<<blocks, kThreads>>>(iters, sink); break;
    case 2: mma_rate_kernel<2><<<blocks, kThreads>>>(iters, sink); break;
    default:
      cudaFree(sink);
      return -1;
  }
  cudaEventRecord(t1);
  e = cudaEventSynchronize(t1);
  if (e == cudaSuccess) e = cudaGetLastError();
  cudaEventElapsedTime(ms, t0, t1);
  cudaEventDestroy(t0);
  cudaEventDestroy(t1);
  cudaFree(sink);
  return (int)e;
}

int mma_rate_chains() { return kChains; }
int mma_rate_threads() { return kThreads; }

}  // extern "C"
