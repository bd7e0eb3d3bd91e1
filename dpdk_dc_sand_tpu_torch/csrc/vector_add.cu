// E1: the teaching vector add for Hopper (sm_90a).
//
//   out[i] = x[i] + y[i],   f32, i < n
//
// Replaces the TPU kernel examples/vector_add_pallas.py:vector_add -> kernel
// (blocks of 1024 f32 through VMEM, one grid step a block).
//
// Design. A grid-stride loop over float4 words: each thread loads 16 bytes of
// x and of y and stores 16 bytes, neighbouring threads on neighbouring words,
// so every warp moves whole 512-byte segments. The grid is capped at a few
// blocks per SM and strides over the rest. The n % 4 tail is added by the
// first threads of block 0 with scalar loads. The wrapper checks that the
// three pointers are 16-byte aligned.
//
// What bounds it on the card: bytes. It reads 8n and writes 4n bytes and does
// n additions (12n bytes over 3.35 TB/s: 0.96 ms at n = 1 << 28). One f32
// add is exactly rounded, so the result equals the plain x + y bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;  // 16 blocks of 256 threads per SM

__global__ void __launch_bounds__(THREADS)
    vector_add_kernel(const float* __restrict__ x, const float* __restrict__ y,
                      float* __restrict__ out, long long n) {
  const long long n4 = n / 4;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const float4* y4 = reinterpret_cast<const float4*>(y);
  float4* o4 = reinterpret_cast<float4*>(out);
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x; i < n4;
       i += stride) {
    const float4 a = x4[i];
    const float4 b = y4[i];
    o4[i] = make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  }
  if (blockIdx.x == 0 && threadIdx.x < n - 4 * n4) {
    const long long t = 4 * n4 + threadIdx.x;
    out[t] = x[t] + y[t];
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 when n == 0: no launch).
extern "C" int vector_add_launch(const void* x, const void* y, void* out, long long n,
                                 void* stream) {
  if (n <= 0) return cudaSuccess;
  const long long words = n / 4;
  long long blocks = (words + THREADS - 1) / THREADS;
  if (blocks < 1) blocks = 1;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  vector_add_kernel<<<static_cast<int>(blocks), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
