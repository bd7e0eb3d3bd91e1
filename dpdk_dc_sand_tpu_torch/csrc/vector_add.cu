// E1: the teaching vector add for Hopper (sm_90a).
//
//   out[i] = x[i] + y[i],   f32, i < n
//
// Replaces the TPU kernel examples/vector_add_pallas.py:vector_add -> kernel
// (blocks of 1024 f32 through VMEM, one grid step a block).
//
// What bounds it on the card: bytes. It reads 8n and writes 4n bytes and does
// n additions (12n bytes over 3.35 TB/s: 0.96 ms at n = 1 << 28). One f32
// add is exactly rounded, so the result equals the plain x + y bit for bit.
//
// Design. One pass: the grid covers the n / 4 float4 words exactly, one word
// a thread, neighbouring threads on neighbouring words, so every warp moves
// whole 512-byte segments with 128-bit loads and stores (cuobjdump -sass:
// LDG.E.128.CONSTANT, STG.E.128). On the card a persistent grid striding
// over n, more words a thread and evict-first hints were not faster.
// The n % 4 tail is added by the first threads of block 0 with scalar
// loads. The wrapper checks that the three pointers are 16-byte aligned.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    vector_add_kernel(const float* __restrict__ x, const float* __restrict__ y,
                      float* __restrict__ out, long long n) {
  const long long n4 = n / 4;
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i < n4) {
    const float4 a = reinterpret_cast<const float4*>(x)[i];
    const float4 b = reinterpret_cast<const float4*>(y)[i];
    reinterpret_cast<float4*>(out)[i] = make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  }
  if (blockIdx.x == 0 && threadIdx.x < n - 4 * n4) {
    const long long t = 4 * n4 + threadIdx.x;
    out[t] = x[t] + y[t];
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 when n == 0: no launch;
// cudaErrorInvalidValue when n / 4 words need more blocks than a grid has).
extern "C" int vector_add_launch(const void* x, const void* y, void* out, long long n,
                                 void* stream) {
  if (n <= 0) return cudaSuccess;
  long long blocks = (n / 4 + THREADS - 1) / THREADS;
  if (blocks < 1) blocks = 1;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  vector_add_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
