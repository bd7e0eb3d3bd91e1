// K6: polyphase FIR for Hopper (sm_90a) — int8 or f32 frames in, f32 out.
//
// Replaces the TPU kernel dpdk_dc_sand_tpu/ops/pfb_pallas.py: _fir_kernel
// (reached from fir_pallas through pl.pallas_call). It computes
//   out[b, s, f] = sum_t x[b, s + t, f] * w[t, f],  s < n_frames - taps + 1,
// in f32 in tap order with every product and sum rounded on its own
// (__fmul_rn / __fadd_rn: no FMA contraction), as the plain version
// pfb_fir_reference does, so the two agree bit for bit.
//
// What bounds it on the card: bytes. At the flagship (160 streams x 271
// frames x 65536, 16 taps) it must read 2.84 GB of int8 and write 10.74 GB
// of f32: 4.05 ms at 3.35 TB/s. Its 86 GFLOP of f32 (no FMA: one multiply
// and one add per tap) take 1.3 ms at 67 TFLOP/s, so the issue rate is not
// far behind. On the card it runs at about a third of the byte floor;
// loading rows ahead and one lane a thread (more warps) were both slower
// (PERF.md), so what holds it back is still open.
//
// Design. A block owns 512 lanes of F (4 adjacent lanes a thread, one char4
// or float4 load per row) and a run of RUN spectra of one stream. A thread
// keeps its lanes' window coefficients in registers and walks the run with
// a register ring of the last MAXT frame rows (MAXT = 4, 8 or 16, the
// smallest that holds the taps), so each input row is read once per block:
// read amplification 1 + (MAXT - 1) / RUN, the TPU kernel's
// 1 + (taps - 1) / S_BLK. The spectrum loop is unrolled by MAXT so every
// ring slot index is a constant and the ring stays in registers. Stores are
// streaming float4 (the 10.7 GB output should not evict the input from L2).
// Above 16 taps a direct body reads every tap row from global memory (L2
// serves the overlap). Lanes past F and rows past the last frame are
// masked, so every fft, S and tap count is taken; where F % 4 != 0 or a
// base is not aligned the wrapper asks for scalar lane loads.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

namespace {

constexpr int THREADS = 128;  // 4 lanes each: 512 lanes per block
constexpr int RUN = 128;      // spectra per block

struct Args {
  const void* x;
  const float* w;
  float* out;
  int n_frames, fft, n_taps, n_spectra;
  int lane_blocks, runs;
};

template <typename T, bool VEC>
__device__ __forceinline__ float4 load4(const T* p, int left) {
  if constexpr (VEC) {
    if constexpr (std::is_same_v<T, int8_t>) {
      const char4 v = __ldg(reinterpret_cast<const char4*>(p));
      return make_float4(v.x, v.y, v.z, v.w);
    } else {
      return __ldg(reinterpret_cast<const float4*>(p));
    }
  } else {
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = k < left ? static_cast<float>(p[k]) : 0.f;
    return make_float4(v[0], v[1], v[2], v[3]);
  }
}

template <bool VEC>
__device__ __forceinline__ void store4(float* p, float4 v, int left) {
  if constexpr (VEC) {
    __stcs(reinterpret_cast<float4*>(p), v);
  } else {
    const float a[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k < left) p[k] = a[k];
    }
  }
}

__device__ __forceinline__ float4 mul4(float4 x, float4 w) {
  return make_float4(__fmul_rn(x.x, w.x), __fmul_rn(x.y, w.y), __fmul_rn(x.z, w.z),
                     __fmul_rn(x.w, w.w));
}

// acc + x*w, the product rounded before the sum.
__device__ __forceinline__ float4 mac4(float4 acc, float4 x, float4 w) {
  const float4 p = mul4(x, w);
  return make_float4(__fadd_rn(acc.x, p.x), __fadd_rn(acc.y, p.y), __fadd_rn(acc.z, p.z),
                     __fadd_rn(acc.w, p.w));
}

// Block -> (lane block, run, stream); returns false for threads past F.
struct Place {
  int lane, left, s0, s1;
  long long b;
};

__device__ __forceinline__ bool place(const Args& a, Place& p) {
  long long bid = blockIdx.x;
  const int lb = static_cast<int>(bid % a.lane_blocks);
  bid /= a.lane_blocks;
  const int run = static_cast<int>(bid % a.runs);
  p.b = bid / a.runs;
  p.lane = (lb * THREADS + static_cast<int>(threadIdx.x)) * 4;
  p.left = a.fft - p.lane;
  p.s0 = run * RUN;
  p.s1 = min(a.n_spectra, p.s0 + RUN);
  return p.lane < a.fft;
}

template <int MAXT, typename In, bool VEC>
__global__ void __launch_bounds__(THREADS) fir_ring_kernel(Args a) {
  Place p;
  if (!place(a, p)) return;
  const long long fft = a.fft;
  const In* xb = static_cast<const In*>(a.x) + p.b * a.n_frames * fft + p.lane;
  float* ob = a.out + p.b * a.n_spectra * fft + p.lane;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  float4 w[MAXT];
#pragma unroll
  for (int t = 0; t < MAXT; ++t) {
    w[t] = t < a.n_taps ? load4<float, VEC>(a.w + t * fft + p.lane, p.left) : zero;
  }
  // Row s0 + j lives in slot j % MAXT; at output s the ring holds rows
  // s .. s + MAXT - 1 (rows past the last frame read as zero, unused).
  float4 ring[MAXT];
#pragma unroll
  for (int j = 0; j < MAXT - 1; ++j) {
    const int r = p.s0 + j;
    ring[j] = r < a.n_frames ? load4<In, VEC>(xb + r * fft, p.left) : zero;
  }
  for (int s = p.s0; s < p.s1; s += MAXT) {
#pragma unroll
    for (int j = 0; j < MAXT; ++j) {
      if (s + j < p.s1) {
        const int r = s + j + MAXT - 1;
        ring[(j + MAXT - 1) % MAXT] =
            r < a.n_frames ? load4<In, VEC>(xb + r * fft, p.left) : zero;
        float4 acc = mul4(ring[j], w[0]);
#pragma unroll
        for (int t = 1; t < MAXT; ++t) {
          if (t < a.n_taps) acc = mac4(acc, ring[(j + t) % MAXT], w[t]);
        }
        store4<VEC>(ob + (s + j) * fft, acc, p.left);
      }
    }
  }
}

template <typename In, bool VEC>
__global__ void __launch_bounds__(THREADS) fir_direct_kernel(Args a) {
  Place p;
  if (!place(a, p)) return;
  const long long fft = a.fft;
  const In* xb = static_cast<const In*>(a.x) + p.b * a.n_frames * fft + p.lane;
  float* ob = a.out + p.b * a.n_spectra * fft + p.lane;
  for (int s = p.s0; s < p.s1; ++s) {
    float4 acc = mul4(load4<In, VEC>(xb + s * fft, p.left),
                      load4<float, VEC>(a.w + p.lane, p.left));
    for (int t = 1; t < a.n_taps; ++t) {
      acc = mac4(acc, load4<In, VEC>(xb + (s + t) * fft, p.left),
                 load4<float, VEC>(a.w + t * fft + p.lane, p.left));
    }
    store4<VEC>(ob + s * fft, acc, p.left);
  }
}

template <typename In, bool VEC>
void launch(const Args& a, unsigned blocks, cudaStream_t st) {
  if (a.n_taps <= 4) {
    fir_ring_kernel<4, In, VEC><<<blocks, THREADS, 0, st>>>(a);
  } else if (a.n_taps <= 8) {
    fir_ring_kernel<8, In, VEC><<<blocks, THREADS, 0, st>>>(a);
  } else if (a.n_taps <= 16) {
    fir_ring_kernel<16, In, VEC><<<blocks, THREADS, 0, st>>>(a);
  } else {
    fir_direct_kernel<In, VEC><<<blocks, THREADS, 0, st>>>(a);
  }
}

template <typename In>
void launch_in(const Args& a, bool vec, unsigned blocks, cudaStream_t st) {
  if (vec) {
    launch<In, true>(a, blocks, st);
  } else {
    launch<In, false>(a, blocks, st);
  }
}

}  // namespace

// x [batch, n_frames, fft] int8 (in_f32 = 0) or f32; w [n_taps, fft] f32;
// out [batch, n_frames - n_taps + 1, fft] f32. vec: fft % 4 == 0 and the
// bases aligned for char4 / float4 access.
extern "C" int pfb_fir_launch(const void* x, const void* w, void* out, int batch,
                              int n_frames, int fft, int n_taps, int in_f32, int vec,
                              void* stream) {
  const int n_spectra = n_frames - n_taps + 1;
  if (batch < 1 || fft < 1 || n_taps < 1 || n_spectra < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{x, static_cast<const float*>(w), static_cast<float*>(out), n_frames, fft, n_taps,
         n_spectra, (fft + 4 * THREADS - 1) / (4 * THREADS), (n_spectra + RUN - 1) / RUN};
  const long long blocks = static_cast<long long>(a.lane_blocks) * a.runs * batch;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_f32) {
    launch_in<float>(a, vec != 0, static_cast<unsigned>(blocks), st);
  } else {
    launch_in<int8_t>(a, vec != 0, static_cast<unsigned>(blocks), st);
  }
  return static_cast<int>(cudaGetLastError());
}
