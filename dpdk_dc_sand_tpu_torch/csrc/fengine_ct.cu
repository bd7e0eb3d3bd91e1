// K1: fused F-engine for Hopper (sm_90a) — FIR + two-stage Cooley–Tukey real
// DFT + fine-delay rotation + int8 requant, int8 in / int8 out (or, without
// the requant, f32 out: the QUANT=false epilogue of both bodies).
//
// Replaces the TPU kernel dpdk_dc_sand_tpu/ops/fengine_pallas.py:
// _fengine_kernel_ct (reached from fengine_fused through pl.pallas_call).
// It computes what that kernel computes, at the same rounding points:
//   FIR in f32 in tap order (no FMA contraction) -> operand rounding (bf16,
//   or none in f32 mode) -> stage A [N1,N1]@[N1,N2] (cos, -sin; f32
//   accumulate) -> f32 twiddle -> operand rounding -> half-output stage B
//   against the row-stacked [cos; -sin] [N2,N2] matrix (f32 accumulate) ->
//   re*rc - im*rs, re*rs + im*rc -> rint -> clip +-127 -> int8. The
//   reference's quantise=False output (its channelisation qualification)
//   stops before rint and stores the rotated f32 values.
// Products of bf16 values are exact in f32, so in bf16 mode the result
// differs from the plain version only in the order of f32 additions.
//
// What is NOT carried over: the scalar-prefetch DMA, the u32-bitcast
// _align_tile rotate and the rolling FIR ring are Mosaic mechanics. Here
// the coarse delay is a per-batch pointer offset (starts[b], clamped by
// the wrapper so every read stays inside the stream) and the FIR reads
// its taps straight from global memory (L2 serves the 16x overlap).
//
// Design. One block per (spectrum s, batch b). The 2*N1*N2 complex
// intermediate between the stages does not fit in shared memory at the
// flagship 256x256 (256 KB in bf16), so the block walks k1 in chunks of
// KC rows: stage A for those rows over all n2, then stage B for those rows
// over all k2 < N2/2. Two bodies share that plan:
//
// - fengine_ct_tc_kernel (bf16 DFT operands, N1 >= 16: every flagship
//   launch), 16 warps. The FIR plane is computed once into shared memory
//   as bf16 (exactly the stage-A operand; 132 KB at 256x256) and both
//   stages run on the tensor cores as WMMA 16x16x16 bf16 products with f32
//   accumulators. The DFT matrices are pre-rounded bf16 copies read as
//   fragments from global memory (L2-resident, shared by every block);
//   each A fragment feeds several output tiles of its warp. Fragment
//   epilogues go through a per-warp f32 staging tile.
// - fengine_ct_kernel (f32 DFT operands, or N1 = 8 where a 16-row MMA
//   tile does not fit): SIMT FMA on register micro-tiles. In f32 mode the
//   FIR plane would need 256 KB, so each stage-A K tile recomputes its
//   [KTA, NTA] slice of the FIR from global memory.
//
// What bounds it on the card: the DFT is 2*N1*N1*N2 + N2*N2*2*N1 MACs per
// spectrum (67 M at 256x256; 5.5 TFLOP per flagship step). The SIMT body
// is bound by FP32 issue and shared-memory loads. The tensor-core body
// runs far below the MMA rate: per spectrum it pulls ~7 MB through L2
// (4 MB of f32 window and 1 MB of int8 taps for the FIR, ~2 MB of DFT
// fragments) with one 16-warp block per SM to hide the latency. Sharing
// one window read among several spectra per block was measured slower
// (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int KC = 32;   // k1 rows per chunk (capped at N1)
constexpr int NTA = 64;  // n2 columns per stage-A output tile
constexpr int KTA = 32;  // n1 depth per stage-A K tile (capped at N1)
constexpr int MTB = 64;  // k2 rows per stage-B output tile
constexpr int KTB = 32;  // n2 depth per stage-B K tile

struct Params {
  const int8_t* x;
  long long batch_stride;
  const long long* starts;
  const float* win;
  const float* d1c;
  const float* d1s;
  const float* d2;
  const float* twc;
  const float* tws;
  const float* rotc;
  const float* rots;
  void* outr;  // [B, S, C] int8, or f32 without the requant
  void* outi;
  int n_spectra, n_taps, n1, n2;
  // bf16 copies of d1c, d1s, d2 (round-to-nearest-even of the f32 values)
  // for the tensor-core body.
  const __nv_bfloat16* d1c_bf;
  const __nv_bfloat16* d1s_bf;
  const __nv_bfloat16* d2_bf;
};

template <bool BF16>
__device__ __forceinline__ float op_round(float v) {
  if constexpr (BF16) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

// FIR at in-frame index e: f32, tap order, every product and sum rounded
// separately (as the reference computes it; no FMA contraction).
__device__ __forceinline__ float fir_at(const int8_t* xs, const float* win,
                                        int fft, int taps, int e) {
  float acc = __fmul_rn(static_cast<float>(xs[e]), __ldg(win + e));
  for (int t = 1; t < taps; ++t) {
    const long long o = static_cast<long long>(t) * fft + e;
    acc = __fadd_rn(acc, __fmul_rn(static_cast<float>(xs[o]), __ldg(win + o)));
  }
  return acc;
}

__device__ __forceinline__ int8_t requant(float v) {
  v = fminf(fmaxf(rintf(v), -127.f), 127.f);
  return static_cast<int8_t>(v);
}

// The epilogue of one output: the fine-delay rotation, then the int8 requant
// (QUANT) or the rotated f32 values.
template <bool QUANT>
__device__ __forceinline__ void store_rotated(const Params& p, long long o, float re,
                                              float im, float rc, float rs) {
  const float vr = __fsub_rn(__fmul_rn(re, rc), __fmul_rn(im, rs));
  const float vi = __fadd_rn(__fmul_rn(re, rs), __fmul_rn(im, rc));
  if constexpr (QUANT) {
    static_cast<int8_t*>(p.outr)[o] = requant(vr);
    static_cast<int8_t*>(p.outi)[o] = requant(vi);
  } else {
    static_cast<float*>(p.outr)[o] = vr;
    static_cast<float*>(p.outi)[o] = vi;
  }
}

template <bool BF16, bool QUANT>
__global__ void __launch_bounds__(THREADS) fengine_ct_kernel(Params p) {
  using OpT = std::conditional_t<BF16, __nv_bfloat16, float>;
  extern __shared__ __align__(128) unsigned char smem[];

  const int s = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int n1 = p.n1, n2 = p.n2, fft = n1 * n2, h = n2 / 2, C = fft / 2;
  const int kc = min(KC, n1);
  const int kta = min(KTA, n1);
  const int ts = n2 + 1;  // odd row stride of sT: conflict-free column reads

  const int8_t* xs = p.x + static_cast<long long>(b) * p.batch_stride +
                     p.starts[b] + static_cast<long long>(s) * fft;

  float* sAc = reinterpret_cast<float*>(smem);  // [KC][KTA]
  float* sAs = sAc + KC * KTA;                  // [KC][KTA]
  float* sBc = sAs + KC * KTA;                  // [MTB][KTB]
  float* sBs = sBc + MTB * KTB;                 // [MTB][KTB]
  float* sXt = sBs + MTB * KTB;                 // f32 mode: [KTA][NTA]
  OpT* sTr = reinterpret_cast<OpT*>(sXt + (BF16 ? 0 : KTA * NTA));  // [KC][ts]
  OpT* sTi = sTr + KC * ts;
  // bf16 mode: the whole FIR plane [N1][N2], 16-byte aligned after sT.
  const size_t t_bytes = 2 * KC * ts * sizeof(OpT);
  __nv_bfloat16* sX = reinterpret_cast<__nv_bfloat16*>(
      reinterpret_cast<unsigned char*>(sTr) + ((t_bytes + 15) & ~size_t(15)));

  if constexpr (BF16) {
    for (int e = tid; e < fft; e += THREADS) {
      sX[e] = __float2bfloat16_rn(fir_at(xs, p.win, fft, p.n_taps, e));
    }
    __syncthreads();
  }

  // Stage-A micro tile: 2 k1 rows x 4 n2 columns, re and im.
  const int a_tiles = (kc / 2) * (NTA / 4);
  const bool a_on = tid < a_tiles;
  const int a_r = (tid / (NTA / 4)) * 2;
  const int a_c = (tid % (NTA / 4)) * 4;
  // Stage-B micro tile: 4 k2 rows x 2 k1 columns, four partial sums.
  const int b_tiles = (MTB / 4) * (kc / 2);
  const bool b_on = tid < b_tiles;
  const int b_r = (tid / (kc / 2)) * 4;
  const int b_c = (tid % (kc / 2)) * 2;

  for (int k0 = 0; k0 < n1; k0 += kc) {
    // ---- stage A for k1 in [k0, k0+kc): all n2, NTA columns at a time ----
    for (int c0 = 0; c0 < n2; c0 += NTA) {
      float ar[2][4] = {}, ai[2][4] = {};
      for (int kt = 0; kt < n1; kt += kta) {
        __syncthreads();  // previous tile's readers are done
        for (int i = tid; i < kc * kta; i += THREADS) {
          const int r = i / kta, c = i % kta;
          const int g = (k0 + r) * n1 + kt + c;
          sAc[r * KTA + c] = op_round<BF16>(__ldg(p.d1c + g));
          sAs[r * KTA + c] = op_round<BF16>(__ldg(p.d1s + g));
        }
        if constexpr (!BF16) {
          for (int i = tid; i < kta * NTA; i += THREADS) {
            const int r = i / NTA, c = i % NTA;
            sXt[r * NTA + c] =
                fir_at(xs, p.win, fft, p.n_taps, (kt + r) * n2 + c0 + c);
          }
        }
        __syncthreads();
        if (a_on) {
          for (int kk = 0; kk < kta; ++kk) {
            float xv[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if constexpr (BF16) {
                xv[j] = __bfloat162float(sX[(kt + kk) * n2 + c0 + a_c + j]);
              } else {
                xv[j] = sXt[kk * NTA + a_c + j];
              }
            }
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const float wc = sAc[(a_r + i) * KTA + kk];
              const float ws = sAs[(a_r + i) * KTA + kk];
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                ar[i][j] = fmaf(wc, xv[j], ar[i][j]);
                ai[i][j] = fmaf(ws, xv[j], ai[i][j]);
              }
            }
          }
        }
      }
      if (a_on) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int k1 = k0 + a_r + i, n = c0 + a_c + j;
            const float wc = __ldg(p.twc + k1 * n2 + n);
            const float ws = __ldg(p.tws + k1 * n2 + n);
            const float tr = __fsub_rn(__fmul_rn(ar[i][j], wc), __fmul_rn(ai[i][j], ws));
            const float ti = __fadd_rn(__fmul_rn(ar[i][j], ws), __fmul_rn(ai[i][j], wc));
            if constexpr (BF16) {
              sTr[(a_r + i) * ts + n] = __float2bfloat16_rn(tr);
              sTi[(a_r + i) * ts + n] = __float2bfloat16_rn(ti);
            } else {
              sTr[(a_r + i) * ts + n] = tr;
              sTi[(a_r + i) * ts + n] = ti;
            }
          }
        }
      }
    }

    // ---- stage B for k1 in [k0, k0+kc): k2 < N2/2, MTB rows at a time ----
    for (int r0 = 0; r0 < h; r0 += MTB) {
      float scr[4][2] = {}, ssi[4][2] = {}, sci[4][2] = {}, ssr[4][2] = {};
      for (int kt = 0; kt < n2; kt += KTB) {
        __syncthreads();  // sT complete (first pass) / previous tile read
        for (int i = tid; i < MTB * KTB; i += THREADS) {
          const int r = i / KTB, c = i % KTB;
          sBc[i] = op_round<BF16>(__ldg(p.d2 + (r0 + r) * n2 + kt + c));
          sBs[i] = op_round<BF16>(__ldg(p.d2 + (h + r0 + r) * n2 + kt + c));
        }
        __syncthreads();
        if (b_on) {
          for (int kk = 0; kk < KTB; ++kk) {
            float tr[2], ti[2];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              if constexpr (BF16) {
                tr[j] = __bfloat162float(sTr[(b_c + j) * ts + kt + kk]);
                ti[j] = __bfloat162float(sTi[(b_c + j) * ts + kt + kk]);
              } else {
                tr[j] = sTr[(b_c + j) * ts + kt + kk];
                ti[j] = sTi[(b_c + j) * ts + kt + kk];
              }
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float c = sBc[(b_r + i) * KTB + kk];
              const float sn = sBs[(b_r + i) * KTB + kk];
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                scr[i][j] = fmaf(c, tr[j], scr[i][j]);
                ssi[i][j] = fmaf(sn, ti[j], ssi[i][j]);
                sci[i][j] = fmaf(c, ti[j], sci[i][j]);
                ssr[i][j] = fmaf(sn, tr[j], ssr[i][j]);
              }
            }
          }
        }
      }
      if (b_on) {
        const long long obase = (static_cast<long long>(b) * p.n_spectra + s) * C;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int ch = (r0 + b_r + i) * n1 + k0 + b_c + j;
            const float re = __fsub_rn(scr[i][j], ssi[i][j]);
            const float im = __fadd_rn(sci[i][j], ssr[i][j]);
            const float rc = __ldg(p.rotc + static_cast<long long>(b) * C + ch);
            const float rs = __ldg(p.rots + static_cast<long long>(b) * C + ch);
            store_rotated<QUANT>(p, obase + ch, re, im, rc, rs);
          }
        }
      }
    }
    __syncthreads();  // the next chunk overwrites sT
  }
}

size_t smem_bytes(bool bf16, int n1, int n2) {
  const size_t ts = n2 + 1;
  size_t bytes = sizeof(float) * (2 * KC * KTA + 2 * MTB * KTB);
  if (bf16) {
    bytes += (2 * KC * ts * sizeof(__nv_bfloat16) + 15) & ~size_t(15);
    bytes += static_cast<size_t>(n1) * n2 * sizeof(__nv_bfloat16);
  } else {
    bytes += sizeof(float) * KTA * NTA;
    bytes += 2 * KC * ts * sizeof(float);
  }
  return bytes;
}

template <bool BF16, bool QUANT>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  const size_t bytes = smem_bytes(BF16, p.n1, p.n2);
  cudaError_t err = cudaFuncSetAttribute(
      fengine_ct_kernel<BF16, QUANT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  dim3 grid(p.n_spectra, batch);
  fengine_ct_kernel<BF16, QUANT><<<grid, THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

// ---- tensor-core body (bf16 operands, N1 >= 16) ----
namespace wmma = nvcuda::wmma;
constexpr int TC_KC = 64;  // k1 rows per chunk (capped at N1)
constexpr int A_NJ = 4;    // most stage-A n2 tiles one warp owns (N2 <= 256)
constexpr int XPAD = 8;    // bf16 row padding of the shared planes
constexpr int TC_THREADS = 512;  // 16 warps: the one block an SM holds
constexpr int WARPS = TC_THREADS / 32;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// FIR of 4 consecutive in-frame samples e..e+3 (e % 4 == 0): one float4
// window load and four byte loads per tap keep four chains in flight.
__device__ __forceinline__ void fir4_at(const int8_t* xs, const float* win,
                                        int fft, int taps, int e, float acc[4]) {
  const float4 w = __ldg(reinterpret_cast<const float4*>(win + e));
  acc[0] = __fmul_rn(static_cast<float>(xs[e + 0]), w.x);
  acc[1] = __fmul_rn(static_cast<float>(xs[e + 1]), w.y);
  acc[2] = __fmul_rn(static_cast<float>(xs[e + 2]), w.z);
  acc[3] = __fmul_rn(static_cast<float>(xs[e + 3]), w.w);
#pragma unroll 4
  for (int t = 1; t < taps; ++t) {
    const long long o = static_cast<long long>(t) * fft + e;
    const float4 wt = __ldg(reinterpret_cast<const float4*>(win + o));
    acc[0] = __fadd_rn(acc[0], __fmul_rn(static_cast<float>(xs[o + 0]), wt.x));
    acc[1] = __fadd_rn(acc[1], __fmul_rn(static_cast<float>(xs[o + 1]), wt.y));
    acc[2] = __fadd_rn(acc[2], __fmul_rn(static_cast<float>(xs[o + 2]), wt.z));
    acc[3] = __fadd_rn(acc[3], __fmul_rn(static_cast<float>(xs[o + 3]), wt.w));
  }
}

// A warp's accumulator tile -> 8 values per lane (element lane + 32*q of
// the row-major 16x16 tile) through the warp's 1 KB staging tile.
__device__ __forceinline__ void stage_out(float* wst, const FragC& f, float v[8],
                                          int lane) {
  wmma::store_matrix_sync(wst, f, 16, wmma::mem_row_major);
  __syncwarp();
#pragma unroll
  for (int q = 0; q < 8; ++q) v[q] = wst[lane + 32 * q];
  __syncwarp();
}

template <bool QUANT>
__global__ void __launch_bounds__(TC_THREADS) fengine_ct_tc_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int s = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int n1 = p.n1, n2 = p.n2, fft = n1 * n2, h = n2 / 2, C = fft / 2;
  const int kc = min(TC_KC, n1);
  const int ld = n2 + XPAD;
  const int lg2 = __ffs(n2) - 1;

  const int8_t* xs = p.x + static_cast<long long>(b) * p.batch_stride +
                     p.starts[b] + static_cast<long long>(s) * fft;
  __nv_bfloat16* sX = reinterpret_cast<__nv_bfloat16*>(smem);  // [N1][ld]
  __nv_bfloat16* sTr = sX + n1 * ld;                             // [TC_KC][ld]
  __nv_bfloat16* sTi = sTr + TC_KC * ld;
  float* wst = reinterpret_cast<float*>(sTi + TC_KC * ld) + warp * 256;  // 16x16

  for (int e = 4 * tid; e < fft; e += 4 * TC_THREADS) {
    float acc[4];
    fir4_at(xs, p.win, fft, p.n_taps, e, acc);
    __nv_bfloat16* dst = sX + (e >> lg2) * ld + (e & (n2 - 1));
#pragma unroll
    for (int j = 0; j < 4; ++j) dst[j] = __float2bfloat16_rn(acc[j]);
  }
  __syncthreads();

  const long long obase = (static_cast<long long>(b) * p.n_spectra + s) * C;
  // Stage-A work split: warp -> one 16-row k1 tile (a_mi) and up to A_NJ
  // n2 tiles, so each A fragment loaded from L2 feeds A_NJ products.
  const int MI = kc / 16, NI = n2 / 16;
  const int a_mi = warp % MI, a_ni0 = warp / MI, a_step = WARPS / MI;
  // Stage-B work split: warp -> one 16-row k2 tile and up to 2 k1 tiles.
  const int NJ = kc / 16, NJW = min(2, NJ), b_units = (h / 16) * (NJ / NJW);
  for (int k0 = 0; k0 < n1; k0 += kc) {
    // ---- stage A: [kc x N2] tiles of d1[k0.., :] @ X, cos and -sin ----
    {
      FragC ac[A_NJ], as[A_NJ];
#pragma unroll
      for (int j = 0; j < A_NJ; ++j) {
        wmma::fill_fragment(ac[j], 0.f);
        wmma::fill_fragment(as[j], 0.f);
      }
      for (int kk = 0; kk < n1; kk += 16) {
        FragA fc, fs;
        wmma::load_matrix_sync(fc, p.d1c_bf + (k0 + a_mi * 16) * n1 + kk, n1);
        wmma::load_matrix_sync(fs, p.d1s_bf + (k0 + a_mi * 16) * n1 + kk, n1);
#pragma unroll
        for (int j = 0; j < A_NJ; ++j) {
          const int ni = a_ni0 + j * a_step;
          if (ni < NI) {
            FragBr fx;
            wmma::load_matrix_sync(fx, sX + kk * ld + ni * 16, ld);
            wmma::mma_sync(ac[j], fc, fx, ac[j]);
            wmma::mma_sync(as[j], fs, fx, as[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < A_NJ; ++j) {
        const int ni = a_ni0 + j * a_step;
        if (ni < NI) {
          float ar[8], ai[8];
          stage_out(wst, ac[j], ar, lane);
          stage_out(wst, as[j], ai, lane);
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int i = lane + 32 * q;
            const int r = a_mi * 16 + i / 16, n = ni * 16 + i % 16;
            const float wc = __ldg(p.twc + (k0 + r) * n2 + n);
            const float ws = __ldg(p.tws + (k0 + r) * n2 + n);
            sTr[r * ld + n] = __float2bfloat16_rn(
                __fsub_rn(__fmul_rn(ar[q], wc), __fmul_rn(ai[q], ws)));
            sTi[r * ld + n] = __float2bfloat16_rn(
                __fadd_rn(__fmul_rn(ar[q], ws), __fmul_rn(ai[q], wc)));
          }
        }
      }
    }
    __syncthreads();

    // ---- stage B: out[k2, k1] = d2[k2, :] . T[k1, :], k2 < N2/2 ----
    for (int u = warp; u < b_units; u += WARPS) {
      const int mi = u / (NJ / NJW), nj0 = (u % (NJ / NJW)) * NJW;
      FragC ccr[2], csi[2], cci[2], csr[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fill_fragment(ccr[j], 0.f);
        wmma::fill_fragment(csi[j], 0.f);
        wmma::fill_fragment(cci[j], 0.f);
        wmma::fill_fragment(csr[j], 0.f);
      }
      for (int kt = 0; kt < n2; kt += 16) {
        FragA fc, fs;
        wmma::load_matrix_sync(fc, p.d2_bf + (mi * 16) * n2 + kt, n2);
        wmma::load_matrix_sync(fs, p.d2_bf + (h + mi * 16) * n2 + kt, n2);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (j < NJW) {
            FragBc ftr, fti;
            wmma::load_matrix_sync(ftr, sTr + (nj0 + j) * 16 * ld + kt, ld);
            wmma::load_matrix_sync(fti, sTi + (nj0 + j) * 16 * ld + kt, ld);
            wmma::mma_sync(ccr[j], fc, ftr, ccr[j]);
            wmma::mma_sync(csi[j], fs, fti, csi[j]);
            wmma::mma_sync(cci[j], fc, fti, cci[j]);
            wmma::mma_sync(csr[j], fs, ftr, csr[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (j < NJW) {
          // Same fragment shape and type -> same element mapping: combine
          // re = sum(cos*tr) - sum(-sin*ti), im = sum(cos*ti) + sum(-sin*tr).
          for (int t = 0; t < ccr[j].num_elements; ++t) {
            ccr[j].x[t] = __fsub_rn(ccr[j].x[t], csi[j].x[t]);
            cci[j].x[t] = __fadd_rn(cci[j].x[t], csr[j].x[t]);
          }
          float re[8], im[8];
          stage_out(wst, ccr[j], re, lane);
          stage_out(wst, cci[j], im, lane);
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int i = lane + 32 * q;
            const int ch = (mi * 16 + i / 16) * n1 + k0 + (nj0 + j) * 16 + i % 16;
            const float rc = __ldg(p.rotc + static_cast<long long>(b) * C + ch);
            const float rs = __ldg(p.rots + static_cast<long long>(b) * C + ch);
            store_rotated<QUANT>(p, obase + ch, re[q], im[q], rc, rs);
          }
        }
      }
    }
    __syncthreads();  // the next chunk overwrites sT
  }
}

size_t tc_smem_bytes(int n1, int n2) {
  const size_t ld = n2 + XPAD;
  return sizeof(__nv_bfloat16) * (static_cast<size_t>(n1) + 2 * TC_KC) * ld +
         sizeof(float) * WARPS * 256;
}

template <bool QUANT>
cudaError_t launch_tc(const Params& p, int batch, cudaStream_t stream) {
  const size_t bytes = tc_smem_bytes(p.n1, p.n2);
  cudaError_t err = cudaFuncSetAttribute(
      fengine_ct_tc_kernel<QUANT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  dim3 grid(p.n_spectra, batch);
  fengine_ct_tc_kernel<QUANT><<<grid, TC_THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* dcsand_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// bf16 with N1 >= 16 takes the tensor-core body, everything else the SIMT
// body; quantise = 0 writes f32 outputs instead of int8.
extern "C" int fengine_ct_launch(
    const void* x, long long batch_stride, const void* starts,
    const void* win, const void* d1c, const void* d1s, const void* d2,
    const void* twc, const void* tws, const void* rotc, const void* rots,
    void* outr, void* outi, int batch, int n_spectra, int n_taps, int n1,
    int n2, int bf16, int quantise, const void* d1c_bf, const void* d1s_bf,
    const void* d2_bf, void* stream) {
  // Shapes the tiling assumes (the wrapper's _split_ct guarantees them).
  if (n1 < 8 || (n1 & (n1 - 1)) || n2 < 128 || (n2 & (n2 - 1)) ||
      n_spectra < 1 || batch < 1 || batch > 65535 || n_taps < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{static_cast<const int8_t*>(x), batch_stride,
           static_cast<const long long*>(starts),
           static_cast<const float*>(win), static_cast<const float*>(d1c),
           static_cast<const float*>(d1s), static_cast<const float*>(d2),
           static_cast<const float*>(twc), static_cast<const float*>(tws),
           static_cast<const float*>(rotc), static_cast<const float*>(rots),
           outr, outi,
           n_spectra, n_taps, n1, n2,
           static_cast<const __nv_bfloat16*>(d1c_bf),
           static_cast<const __nv_bfloat16*>(d1s_bf),
           static_cast<const __nv_bfloat16*>(d2_bf)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16 && n1 >= 16) {
    err = quantise ? launch_tc<true>(p, batch, st) : launch_tc<false>(p, batch, st);
  } else if (bf16) {
    err = quantise ? launch<true, true>(p, batch, st) : launch<true, false>(p, batch, st);
  } else {
    err = quantise ? launch<false, true>(p, batch, st) : launch<false, false>(p, batch, st);
  }
  return static_cast<int>(err);
}
