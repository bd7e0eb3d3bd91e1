// P3: the FIR loop-order probe for Hopper (sm_90a).
//
// Replaces the TPU kernel benchmarks/fir_probe.py:make -> kernel of the JAX
// package (reached through pl.pallas_call at fir_probe.py:78). It computes
//   out[j*N1 + r, c] = sum_t x[(j + t)*N1 + r, c] * w[t*N1 + r, c]
// for j < J = 8 spectra and t < TAPS = 16 taps, x bf16, w and out f32, as
// the probe does: f32 products and sums in tap order, each rounded
// (__fmul_rn, __fadd_rn), so the kernel equals its plain version bit for
// bit. It runs the probe's REPS passes on data that stays on chip, and keeps
// the probe's serialising term: pass q adds pass q-1's out[0, 0] (0 for the
// first pass), and out holds the last pass.
//
// Design. The probe's slabs (x 3.0 MB, w 4.2 MB, out 2.1 MB at N1 = N2 =
// 256) fit the 50 MB L2 but not a block's 227 KB, so the rows r, which the
// sums never mix, are split across blocks: block (r, column strip) copies its
// x and w columns into shared memory once and runs every pass from there
// (110 bytes a column: 28 KB for 256 columns). Each thread owns one column.
// TAPOUTER picks the probe's loop order:
//   persi    — for each spectrum j, every tap: 16 x and 16 w loads from
//              shared memory per output;
//   tapouter — for each tap t, one w load applied to all J spectra (J
//              accumulators in registers): 16 w and 128 x loads per J outputs.
// The outer loop is not unrolled, and every step of it offsets its loads by
// a multiple of a zero that the caller passes (so the compiler cannot fold
// it): every pass reloads and recomputes, in the loop order's pattern (the
// TPU probe relied on its compiler doing the same). The passes before the
// last feed a sink stored under a condition that never holds. The
// serialising term is a chain of f32 adds of out[0, 0]'s sum, which every
// thread carries itself (it depends on that one sum alone).
//
// What bounds it on the card: operations, REPS*J*TAPS*N1*N2 f32 FMA (335.5 M
// at the probe's sizes: 0.010 ms at 67 TFLOP/s); its bytes (9.3 MB) take
// 0.003 ms. Shared-memory loads are the likely limit: 256 (persi) or 144
// (tapouter) 2-4-byte loads per thread per 128 products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // columns a block
constexpr int J = 8;          // spectra a pass
constexpr int TAPS = 16;
constexpr int G = J + TAPS - 1;  // x rows a column

template <bool TAPOUTER>
__global__ void __launch_bounds__(THREADS)
    fir_probe_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
                     float* __restrict__ out, int n1, int n2, int reps, int zero) {
  __shared__ float sw[TAPS][THREADS];
  __shared__ __nv_bfloat16 sx[G][THREADS];
  const int r = blockIdx.x, tid = threadIdx.x;
  const int c = blockIdx.y * THREADS + tid;
  const bool on = c < n2;
  if (on) {
#pragma unroll
    for (int g = 0; g < G; ++g) sx[g][tid] = x[(static_cast<long long>(g) * n1 + r) * n2 + c];
#pragma unroll
    for (int t = 0; t < TAPS; ++t) sw[t][tid] = w[(static_cast<long long>(t) * n1 + r) * n2 + c];
  }
  // out[0, 0]'s sum, for the serialising chain.
  float f00 = __fmul_rn(__bfloat162float(x[0]), w[0]);
  for (int t = 1; t < TAPS; ++t) {
    const long long o = static_cast<long long>(t) * n1 * n2;
    f00 = __fadd_rn(f00, __fmul_rn(__bfloat162float(x[o]), w[o]));
  }
  __syncthreads();
  if (!on) return;
  float prev = 0.f;     // pass q-1's out[0, 0]
  uint32_t seen = 0;    // the earlier passes' sums, kept (see below)
  int step = 0;         // z = step * zero: 0, but not to the compiler
  for (int q = 0; q < reps; ++q) {
    const bool last = q == reps - 1;
    if constexpr (TAPOUTER) {
      int z = ++step * zero;
      float acc[J];
#pragma unroll
      for (int j = 0; j < J; ++j) acc[j] = __fmul_rn(__bfloat162float(sx[j + z][tid]), sw[z][tid]);
#pragma unroll 1
      for (int t = 1; t < TAPS; ++t) {
        z = ++step * zero;  // each tap's w is loaded once, here
        const float wt = sw[t + z][tid];
#pragma unroll
        for (int j = 0; j < J; ++j) {
          acc[j] = __fadd_rn(acc[j], __fmul_rn(__bfloat162float(sx[j + t + z][tid]), wt));
        }
      }
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const float v = __fadd_rn(acc[j], prev);
        if (last) {
          out[(static_cast<long long>(j) * n1 + r) * n2 + c] = v;
        } else {
          seen ^= __float_as_uint(v);
        }
      }
    } else {
#pragma unroll 1
      for (int j = 0; j < J; ++j) {
        const int z = ++step * zero;  // each spectrum loads its 16 w again
        float acc = __fmul_rn(__bfloat162float(sx[j + z][tid]), sw[z][tid]);
#pragma unroll
        for (int t = 1; t < TAPS; ++t) {
          acc = __fadd_rn(acc, __fmul_rn(__bfloat162float(sx[j + t + z][tid]), sw[t + z][tid]));
        }
        const float v = __fadd_rn(acc, prev);
        if (last) {
          out[(static_cast<long long>(j) * n1 + r) * n2 + c] = v;
        } else {
          seen ^= __float_as_uint(v);
        }
      }
    }
    prev = __fadd_rn(f00, prev);
  }
  // Stored under a condition that never holds but that the compiler cannot
  // see through: every pass is computed.
  if (zero) out[c] = __uint_as_float(seen);
}

}  // namespace

// x [(J + TAPS - 1)*n1, n2] bf16, w [TAPS*n1, n2] f32 -> out [J*n1, n2] f32
// after reps passes; tapouter = 0 runs persi, 1 tapouter. zero must be 0:
// the kernel's offsets are multiples of it, which the compiler cannot fold.
extern "C" int fir_probe_launch(const void* x, const void* w, void* out, int n1, int n2,
                                int reps, int tapouter, int zero, void* stream) {
  if (n1 < 1 || n1 > 0x7fffffff / G || n2 < 1 || reps < 1 || zero != 0 ||
      (n2 + THREADS - 1) / THREADS > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(n1, (n2 + THREADS - 1) / THREADS);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wf = static_cast<const float*>(w);
  auto* o = static_cast<float*>(out);
  if (tapouter) {
    fir_probe_kernel<true><<<grid, THREADS, 0, st>>>(xb, wf, o, n1, n2, reps, zero);
  } else {
    fir_probe_kernel<false><<<grid, THREADS, 0, st>>>(xb, wf, o, n1, n2, reps, zero);
  }
  return static_cast<int>(cudaGetLastError());
}
