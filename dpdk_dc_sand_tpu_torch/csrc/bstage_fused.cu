// K2: fused B-stage for Hopper (sm_90a) — corner turn + multi-beam dot.
//
// Replaces the TPU kernel dpdk_dc_sand_tpu/ops/bstage_pallas.py:_kernel
// (reached from beamform_turned_fused through pl.pallas_call). It computes
//   out[c/pack, p*S+s, (c%pack)*2B + n] =
//       sum_a qr[a,p,s,c]*W[c,a,n] + qi[a,p,s,c]*W[c,A+a,n]
// with int8 samples converted exactly to f32, W in bf16 or f32, and f32
// accumulation (a product of an int8 and a bf16 value is exact in f32).
// The packed [C/pack, P*S, pack*2B] output (pack = 128/2B) is the egress
// layout and is kept; the TPU's block-diagonal 4-channel fold only filled
// MXU lanes and is not ported.
//
// Design. Two bodies. bstage_tc_kernel (bf16 weights, 2B >= 16: the
// flagship) runs each channel's [m x 2A] @ [2A x 2B] product on the tensor
// cores (WMMA bf16, f32 accumulate); see its comment below. bstage_kernel
// (f32 weights, or 2B = 8) is SIMT: one block per (32-channel tile,
// MT-row tile of m = p*S+s). The
// corner turn happens in shared memory: each K step stages a [KT][MT][32]
// int8 slab of the (re, im) planes — 32 contiguous channel bytes per
// (antenna, m) row — and the matching [32][KT][2B] weight slab as f32.
// Thread (channel c, m group) keeps an MPT x 2B register tile (MPT =
// 64/2B) and walks the 2A contraction.
//
// What bounds it on the card: bytes. Per flagship step it reads 2.7 GB of
// int8 planes and 0.34 GB of bf16 weights and writes 2.15 GB of f32 beams
// for 0.17 TFLOP of MACs, so HBM bandwidth (3.35 TB/s) is the ceiling;
// the 32-byte row segments of the turn load are the first thing to widen.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CT = 32;  // channels per block (one per lane)
constexpr int KT = 16;  // contraction rows (2A axis) per K step
constexpr int MG = THREADS / CT;  // m groups per block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <int NB2, typename WT>
__global__ void __launch_bounds__(THREADS)
    bstage_kernel(const int8_t* __restrict__ qr, const int8_t* __restrict__ qi,
                  const WT* __restrict__ w, float* __restrict__ out, int n_ants,
                  int ps, int n_ch) {
  constexpr int MPT = 64 / NB2;   // m rows per thread
  constexpr int MT = MG * MPT;    // m rows per block
  constexpr int WS = KT * NB2 + 4;  // padded per-channel weight stride
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* sx = reinterpret_cast<int8_t*>(smem);                 // [KT][MT][CT]
  float* sw = reinterpret_cast<float*>(smem + KT * MT * CT);    // [CT][WS]

  const int tid = threadIdx.x;
  const int c = tid % CT;
  const int mg = tid / CT;
  const int c0 = blockIdx.x * CT;
  const int m0 = blockIdx.y * MT;
  const int k_all = 2 * n_ants;

  float acc[MPT][NB2];
#pragma unroll
  for (int i = 0; i < MPT; ++i)
#pragma unroll
    for (int n = 0; n < NB2; ++n) acc[i][n] = 0.f;

  for (int k0 = 0; k0 < k_all; k0 += KT) {
    __syncthreads();
    // Turn: 32 channel bytes of row (k, m) as 8 words.
    for (int i = tid; i < KT * MT * (CT / 4); i += THREADS) {
      const int word = i % (CT / 4);
      const int row = i / (CT / 4);
      const int kk = row / MT, m = row % MT, k = k0 + kk;
      int v = 0;
      if (k < k_all) {
        const int8_t* plane = k < n_ants ? qr : qi;
        const int a = k < n_ants ? k : k - n_ants;
        const long long off =
            (static_cast<long long>(a) * ps + m0 + m) * n_ch + c0 + 4 * word;
        v = __ldg(reinterpret_cast<const int*>(plane + off));
      }
      reinterpret_cast<int*>(sx)[row * (CT / 4) + word] = v;
    }
    for (int i = tid; i < CT * KT * NB2; i += THREADS) {
      const int cc = i / (KT * NB2), rem = i % (KT * NB2);
      const int kk = rem / NB2, n = rem % NB2, k = k0 + kk;
      float v = 0.f;
      if (k < k_all) {
        v = to_f32(w[(static_cast<long long>(c0 + cc) * k_all + k) * NB2 + n]);
      }
      sw[cc * WS + kk * NB2 + n] = v;
    }
    __syncthreads();
    const int kn = min(KT, k_all - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float xv[MPT];
#pragma unroll
      for (int i = 0; i < MPT; ++i) {
        xv[i] = static_cast<float>(sx[(kk * MT + mg * MPT + i) * CT + c]);
      }
      const float4* wr = reinterpret_cast<const float4*>(sw + c * WS + kk * NB2);
#pragma unroll
      for (int q = 0; q < NB2 / 4; ++q) {
        const float4 wv = wr[q];
#pragma unroll
        for (int i = 0; i < MPT; ++i) {
          acc[i][4 * q + 0] = fmaf(xv[i], wv.x, acc[i][4 * q + 0]);
          acc[i][4 * q + 1] = fmaf(xv[i], wv.y, acc[i][4 * q + 1]);
          acc[i][4 * q + 2] = fmaf(xv[i], wv.z, acc[i][4 * q + 2]);
          acc[i][4 * q + 3] = fmaf(xv[i], wv.w, acc[i][4 * q + 3]);
        }
      }
    }
  }

  constexpr int PACK = 128 / NB2;
  const int cc = c0 + c;
#pragma unroll
  for (int i = 0; i < MPT; ++i) {
    const int m = m0 + mg * MPT + i;
    float4* dst = reinterpret_cast<float4*>(
        out + (static_cast<long long>(cc / PACK) * ps + m) * 128 + (cc % PACK) * NB2);
#pragma unroll
    for (int q = 0; q < NB2 / 4; ++q) {
      dst[q] = make_float4(acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2],
                           acc[i][4 * q + 3]);
    }
  }
}

template <int NB2, typename WT>
cudaError_t launch(const int8_t* qr, const int8_t* qi, const void* w, float* out,
                   int n_ants, int ps, int n_ch, cudaStream_t stream) {
  constexpr int MT = MG * (64 / NB2);
  const size_t bytes = KT * MT * CT + sizeof(float) * CT * (KT * NB2 + 4);
  cudaError_t err = cudaFuncSetAttribute(
      bstage_kernel<NB2, WT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  if (ps % MT || n_ch % CT) return cudaErrorInvalidValue;
  dim3 grid(n_ch / CT, ps / MT);
  bstage_kernel<NB2, WT><<<grid, THREADS, bytes, stream>>>(
      qr, qi, static_cast<const WT*>(w), out, n_ants, ps, n_ch);
  return cudaGetLastError();
}

template <typename WT>
cudaError_t dispatch(int nb2, const int8_t* qr, const int8_t* qi, const void* w,
                     float* out, int n_ants, int ps, int n_ch, cudaStream_t st) {
  switch (nb2) {
    case 8: return launch<8, WT>(qr, qi, w, out, n_ants, ps, n_ch, st);
    case 16: return launch<16, WT>(qr, qi, w, out, n_ants, ps, n_ch, st);
    case 32: return launch<32, WT>(qr, qi, w, out, n_ants, ps, n_ch, st);
    case 64: return launch<64, WT>(qr, qi, w, out, n_ants, ps, n_ch, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---- tensor-core body (bf16 weights, 2B >= 16) ----
// One block per (32 channels, 32 rows of m). Each K step turns a
// [32 k][32 m][32 c] int8 slab into per-channel column-major [k][m] bf16
// tiles (int8 is exact in bf16) and stages the matching [32 k][2B] bf16
// weights; warps own (channel, 16x16 output tile) WMMA accumulators and
// store them straight into the packed output rows.
namespace wmma = nvcuda::wmma;
constexpr int TC_THREADS = 512;
constexpr int TC_WARPS = TC_THREADS / 32;
constexpr int TC_MT = 32;            // m rows per block
constexpr int TC_KT = 32;            // contraction rows per K step
constexpr int A_LD = TC_MT + 8;      // padded m stride of the turned tiles
constexpr int A_CS = TC_KT * A_LD;   // per-channel turned tile (elements)

template <int NB2>
__global__ void __launch_bounds__(TC_THREADS)
    bstage_tc_kernel(const int8_t* __restrict__ qr, const int8_t* __restrict__ qi,
                     const __nv_bfloat16* __restrict__ w, float* __restrict__ out,
                     int n_ants, int ps, int n_ch) {
  constexpr int NT = NB2 / 16;             // 16-wide n tiles per channel
  constexpr int FPC = (TC_MT / 16) * NT;   // accumulator tiles per channel
  constexpr int FPW = CT * FPC / TC_WARPS; // accumulator tiles per warp
  constexpr int PACK = 128 / NB2;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem);  // [CT][TC_KT][A_LD]
  __nv_bfloat16* sb = sa + CT * A_CS;                           // [CT][TC_KT][NB2]

  const int tid = threadIdx.x, warp = tid / 32;
  const int c0 = blockIdx.x * CT;
  const int m0 = blockIdx.y * TC_MT;
  const int k_all = 2 * n_ants;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FPW];
#pragma unroll
  for (int j = 0; j < FPW; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int k0 = 0; k0 < k_all; k0 += TC_KT) {
    __syncthreads();
    // Turn: row (k, m) holds 32 channel bytes = two 16-byte halves.
    for (int i = tid; i < TC_KT * TC_MT * 2; i += TC_THREADS) {
      const int m = i % TC_MT, half = (i / TC_MT) % 2, kk = i / (2 * TC_MT);
      const int k = k0 + kk;
      int4 v = make_int4(0, 0, 0, 0);
      if (k < k_all) {
        const int8_t* plane = k < n_ants ? qr : qi;
        const int a = k < n_ants ? k : k - n_ants;
        const long long off =
            (static_cast<long long>(a) * ps + m0 + m) * n_ch + c0 + 16 * half;
        v = __ldg(reinterpret_cast<const int4*>(plane + off));
      }
      const int8_t* bytes = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        sa[(16 * half + j) * A_CS + kk * A_LD + m] =
            __float2bfloat16_rn(static_cast<float>(bytes[j]));
      }
    }
    // Weights: [CT][TC_KT][NB2] bf16, 8 per 16-byte load.
    for (int i = tid; i < CT * TC_KT * NB2 / 8; i += TC_THREADS) {
      const int q = i % (NB2 / 8), kk = (i / (NB2 / 8)) % TC_KT;
      const int c = i / (TC_KT * NB2 / 8), k = k0 + kk;
      int4 v = make_int4(0, 0, 0, 0);
      if (k < k_all) {
        v = __ldg(reinterpret_cast<const int4*>(
            w + (static_cast<long long>(c0 + c) * k_all + k) * NB2 + 8 * q));
      }
      *reinterpret_cast<int4*>(sb + (c * TC_KT + kk) * NB2 + 8 * q) = v;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < FPW; ++j) {
      const int f = warp * FPW + j;
      const int c = f / FPC, mt = (f % FPC) / NT, nt = f % NT;
#pragma unroll
      for (int kk = 0; kk < TC_KT; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, sa + c * A_CS + kk * A_LD + mt * 16, A_LD);
        wmma::load_matrix_sync(fb, sb + (c * TC_KT + kk) * NB2 + nt * 16, NB2);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < FPW; ++j) {
    const int f = warp * FPW + j;
    const int c = f / FPC, mt = (f % FPC) / NT, nt = f % NT;
    const int cc = c0 + c;
    float* dst = out + (static_cast<long long>(cc / PACK) * ps + m0 + mt * 16) * 128 +
                 (cc % PACK) * NB2 + nt * 16;
    wmma::store_matrix_sync(dst, acc[j], 128, wmma::mem_row_major);
  }
}

template <int NB2>
cudaError_t launch_tc(const int8_t* qr, const int8_t* qi, const void* w, float* out,
                      int n_ants, int ps, int n_ch, cudaStream_t stream) {
  const size_t bytes = sizeof(__nv_bfloat16) * CT * TC_KT * (A_LD + NB2);
  cudaError_t err = cudaFuncSetAttribute(
      bstage_tc_kernel<NB2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  if (ps % TC_MT || n_ch % CT) return cudaErrorInvalidValue;
  dim3 grid(n_ch / CT, ps / TC_MT);
  bstage_tc_kernel<NB2><<<grid, TC_THREADS, bytes, stream>>>(
      qr, qi, static_cast<const __nv_bfloat16*>(w), out, n_ants, ps, n_ch);
  return cudaGetLastError();
}

}  // namespace

extern "C" int bstage_fused_launch(const void* qr, const void* qi, const void* w,
                                   int w_bf16, void* out, int n_ants, int ps,
                                   int n_ch, int nb2, void* stream) {
  const auto* r = static_cast<const int8_t*>(qr);
  const auto* i = static_cast<const int8_t*>(qi);
  auto* o = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (w_bf16 && nb2 == 16) {
    err = launch_tc<16>(r, i, w, o, n_ants, ps, n_ch, st);
  } else if (w_bf16 && nb2 == 32) {
    err = launch_tc<32>(r, i, w, o, n_ants, ps, n_ch, st);
  } else if (w_bf16 && nb2 == 64) {
    err = launch_tc<64>(r, i, w, o, n_ants, ps, n_ch, st);
  } else {
    err = w_bf16 ? dispatch<__nv_bfloat16>(nb2, r, i, w, o, n_ants, ps, n_ch, st)
                 : dispatch<float>(nb2, r, i, w, o, n_ants, ps, n_ch, st);
  }
  return static_cast<int>(err);
}
