// K7: the decimation-in-time F kernel for Hopper (sm_90a) — FIR + even/odd
// split + two half-length two-stage DFTs + DIT combine + fine-delay
// rotation + int8 requant, int8 in / int8 out.
//
// Replaces the TPU kernel dpdk_dc_sand_tpu/ops/fengine_pallas.py:
// _fengine_kernel (reached from fengine_fused(deint="matmul" | "bitcast")
// through pl.pallas_call). The two names move samples differently on the TPU
// (a 0/1 selection product; int16 byte shifts) but compute the same values,
// so one kernel serves both; the name only picks the N1·N2 split, which is
// a parameter here. The rounding points are the reference's:
//   FIR in f32 in tap order (no FMA contraction) -> round to the DFT type
//   (bf16, or none in f32 mode) -> even stream e[m] = fir[2m], odd stream
//   o[m] = fir[2m+1], each viewed row-major [N1, N2] (N = fft/2 = N1·N2) ->
//   stage A [N1,N1]@[N1,N2] (cos, -sin; f32 accumulate) -> f32 twiddle
//   exp(-2πi k1 n2 / N) -> round -> stage B against [N2,N2] cos and -sin
//   (four f32 sums, combined as re = Σc·tr - Σs·ti, im = Σc·ti + Σs·tr) ->
//   X[k] = E[k] + exp(-iπk/N)·O[k] in f32 -> re·rc - im·rs, re·rs + im·rc
//   (requant gain folded into the planes) -> rint -> clip ±127 -> int8.
// Output bin k = k2·N1 + k1, k < N: the rfft's first N bins.
//
// What bounds it on the card: operations. Per spectrum the two DFTs are
// 4·N1²·N2 + 8·N2²·N1 multiply-adds (67 M at fft 65536: 256·128), so 8 of
// the flagship's 160 streams at S = 256 are 275 GFLOP: 0.28 ms at the bf16
// tensor rate, 4.1 ms at the f32 SIMT rate; its bytes (0.28 GB) take
// 0.08 ms. This body is SIMT FMA on register micro tiles (the first,
// simple form; K1's tensor-core body is the model for a faster one), so it
// is bound by FP32 issue and shared-memory loads.
//
// Design. One block per (spectrum s, stream b), as K1's SIMT body. The
// four [N1, N2] planes between the stages (even and odd, re and im) do not
// fit in shared memory at fft 65536 (512 KB in f32), so the block walks k1
// in chunks of kc rows: stage A for those rows of both streams over all
// n2, then stage B for those rows over all k2, combine, rotate, write. kc
// is KC, halved until the chunk's planes fit (16 rows at N2 = 512, 8 at
// 1024); the launch returns -1 where even 2 rows do not.
// The FIR is not kept: each stage-A K tile recomputes its [KTA, NTA] slice
// of both streams from global memory (L2 serves the N1/KC-fold re-read).
//
// Stage stops (the probe P2: benchmarks/fused_ablate.py of the JAX package,
// the trimmed copy of _fengine_kernel reached through pl.pallas_call at
// fused_ablate.py:198). A compile-time STOP cuts the kernel after a stage,
// so the production instantiation (DIT_FULL) is the code above unchanged.
// Each writes int8 by truncation with saturation, as XLA's conversion does
// in the probe, into the [B, S, N] outputs:
//   DIT_DMA    — the block's input bytes (the taps frames its FIR reads)
//                loaded once; outr 0, outi frame f0's first sample, f0 =
//                s - s % 16 (P2's s_blk);
//   DIT_CONV   — the same loads converted to f32; outi x[f0][0] + x[f0+1][0];
//   DIT_FIR    — the FIR once per sample; its first N samples to outr, the
//                last N to outi (P2's per-spectrum slice);
//   DIT_DEINT  — + the DFT-type rounding and the even / odd split: e[m] to
//                outr[m], o[m] to outi[m];
//   DIT_STAGEA — the chunk loop with stage A only (its FIR recomputation
//                included): the even and odd streams' rounded T re at
//                k1*N2 + n2;
//   DIT_STAGEB — + stage B, no combine: even re and odd re at k2*N1 + k1
//                (the im sums are added times zero, so the compiler keeps
//                all of stage B, which the probe's sink did not need).
// The first four stop before the chunk loop, so they measure the FIR once
// a sample; from DIT_STAGEA on the FIR is recomputed per chunk, as K7 does.
// P2's deint and stagea sinks slice across the spectra of its [N1, s_blk*N2]
// scratch; here a block holds one spectrum, so they write its own values.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int KC = 32;   // most k1 rows per chunk (capped at N1; shrinks with N2)
constexpr size_t MAX_SMEM = 232448;  // what one block may use on sm_90
constexpr int NTA = 64;  // n2 columns per stage-A output tile (capped at N2)
constexpr int KTA = 32;  // n1 depth per stage-A K tile (capped at N1)
constexpr int MTB = 64;  // k2 rows per stage-B output tile (capped at N2)
constexpr int KTB = 32;  // n2 depth per stage-B K tile (capped at N2)

struct Params {
  const int8_t* x;  // [B, n_frames * fft]
  const float* win;  // [taps, fft]
  const float* d1c;  // [N1, N1] cos(2π k1 n1 / N1)
  const float* d1s;  // -sin
  const float* d2c;  // [N2, N2] cos(2π k2 n2 / N2)
  const float* d2s;  // -sin
  const float* twc;  // [N1, N2] cos(2π k1 n2 / N)
  const float* tws;  // -sin
  const float* untc;  // [N2, N1] cos(π k / N), k = k2·N1 + k1
  const float* unts;  // -sin
  const float* rotc;  // [B, N]
  const float* rots;
  int8_t* outr;  // [B, S, N]
  int8_t* outi;
  int n_frames, n_spectra, n_taps, n1, n2, kc;
};

template <bool BF16>
__device__ __forceinline__ float op_round(float v) {
  if constexpr (BF16) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

// FIR at in-frame samples 2m and 2m+1 (the even and odd stream's element m):
// f32, tap order, every product and sum rounded separately.
__device__ __forceinline__ void fir_pair(const int8_t* xs, const float* win, int fft,
                                         int taps, int e, float& ev, float& od) {
  char2 v = *reinterpret_cast<const char2*>(xs + e);
  float2 w = __ldg(reinterpret_cast<const float2*>(win + e));
  ev = __fmul_rn(static_cast<float>(v.x), w.x);
  od = __fmul_rn(static_cast<float>(v.y), w.y);
  for (int t = 1; t < taps; ++t) {
    const long long o = static_cast<long long>(t) * fft + e;
    v = *reinterpret_cast<const char2*>(xs + o);
    w = __ldg(reinterpret_cast<const float2*>(win + o));
    ev = __fadd_rn(ev, __fmul_rn(static_cast<float>(v.x), w.x));
    od = __fadd_rn(od, __fmul_rn(static_cast<float>(v.y), w.y));
  }
}

__device__ __forceinline__ int8_t requant(float v) {
  v = fminf(fmaxf(rintf(v), -127.f), 127.f);
  return static_cast<int8_t>(v);
}

// The stage stops (see the head of the file); the launch takes these numbers.
constexpr int DIT_FULL = 0, DIT_DMA = 1, DIT_CONV = 2, DIT_FIR = 3, DIT_DEINT = 4,
              DIT_STAGEA = 5, DIT_STAGEB = 6;
constexpr int ABLATE_S_BLK = 16;  // P2's s_blk: the DMA and conv probes' frame

// int8 by truncation toward zero, saturated: the value cvt.rzi.sat.s8.f32
// gives.
__device__ __forceinline__ int8_t trunc_s8(float v) {
  return static_cast<int8_t>(max(-128, min(127, __float2int_rz(v))));
}

// The stops before the chunk loop (DIT_DMA .. DIT_DEINT) of spectrum s of
// stream b; xs is its first frame.
template <bool BF16, int STOP>
__device__ __forceinline__ void early_stop(const Params& p, const int8_t* xs, int s, int b) {
  const int tid = threadIdx.x;
  const int n = p.n1 * p.n2, fft = 2 * n;
  const long long obase = (static_cast<long long>(b) * p.n_spectra + s) * n;
  if constexpr (STOP == DIT_DMA || STOP == DIT_CONV) {
    const long long pairs = static_cast<long long>(p.n_taps) * n;  // char2 loads, as fir_pair
    uint32_t bits = 0;
    float sum = 0.f;
    for (long long i = tid; i < pairs; i += THREADS) {
      const char2 v = *reinterpret_cast<const char2*>(xs + 2 * i);
      if constexpr (STOP == DIT_DMA) {
        bits ^= static_cast<uint32_t>(static_cast<uint16_t>(v.x | (v.y << 8)));
      } else {
        sum += static_cast<float>(v.x) + static_cast<float>(v.y);
      }
    }
    // Stored under a condition that never holds but that the compiler
    // cannot see through, so no load or conversion is dropped.
    if (p.n_spectra < 0) p.outr[0] = static_cast<int8_t>(bits ^ __float_as_uint(sum));
    const int8_t* x0 = p.x + (static_cast<long long>(b) * p.n_frames + s - s % ABLATE_S_BLK) * fft;
    int8_t probe = x0[0];
    if constexpr (STOP == DIT_CONV) {
      probe = trunc_s8(static_cast<float>(x0[0]) + static_cast<float>(x0[fft]));
    }
    for (int m = tid; m < n; m += THREADS) {
      p.outr[obase + m] = 0;
      p.outi[obase + m] = probe;
    }
  } else {
    for (int m = tid; m < n; m += THREADS) {
      float ev, od;
      fir_pair(xs, p.win, fft, p.n_taps, 2 * m, ev, od);
      if constexpr (STOP == DIT_FIR) {
        // Samples 2m, 2m+1: the first N to outr, the last N to outi.
        int8_t* o = 2 * m < n ? p.outr + obase + 2 * m : p.outi + obase + 2 * m - n;
        *reinterpret_cast<char2*>(o) = make_char2(trunc_s8(ev), trunc_s8(od));
      } else {
        p.outr[obase + m] = trunc_s8(op_round<BF16>(ev));
        p.outi[obase + m] = trunc_s8(op_round<BF16>(od));
      }
    }
  }
}

template <bool BF16, int STOP = DIT_FULL>
__global__ void __launch_bounds__(THREADS) fengine_dit_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int s = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int n1 = p.n1, n2 = p.n2, n = n1 * n2, fft = 2 * n;
  const int kc = p.kc, kta = min(KTA, n1), nta = min(NTA, n2);
  const int mtb = min(MTB, n2), ktb = min(KTB, n2);
  const int ts = n2 + 1;  // odd row stride of the T planes

  const int8_t* xs = p.x + (static_cast<long long>(b) * p.n_frames + s) * fft;
  if constexpr (STOP >= DIT_DMA && STOP <= DIT_DEINT) {
    early_stop<BF16, STOP>(p, xs, s, b);
    return;
  }

  float* sAc = smem;               // [kc][KTA]
  float* sAs = sAc + kc * KTA;     // [kc][KTA]
  float* sBc = sAs + kc * KTA;     // [MTB][KTB]
  float* sBs = sBc + MTB * KTB;    // [MTB][KTB]
  float* sXe = sBs + MTB * KTB;    // [KTA][NTA] even-stream FIR tile
  float* sXo = sXe + KTA * NTA;    // [KTA][NTA] odd
  float* sTer = sXo + KTA * NTA;   // [kc][ts] even re, then even im, odd re, odd im
  float* sTei = sTer + kc * ts;
  float* sTor = sTei + kc * ts;
  float* sToi = sTor + kc * ts;

  // Stage-A micro tile: 2 k1 rows x 4 n2 columns, both streams, re and im.
  const int a_tiles = (kc / 2) * (nta / 4);
  const bool a_on = tid < a_tiles;
  const int a_r = (tid / (nta / 4)) * 2;
  const int a_c = (tid % (nta / 4)) * 4;
  // Stage-B micro tile: 4 k2 rows x 2 k1 columns, four sums per stream.
  const int b_tiles = (mtb / 4) * (kc / 2);
  const bool b_on = tid < b_tiles;
  const int b_r = (tid / (kc / 2)) * 4;
  const int b_c = (tid % (kc / 2)) * 2;
  const long long obase = (static_cast<long long>(b) * p.n_spectra + s) * n;

  for (int k0 = 0; k0 < n1; k0 += kc) {
    // ---- stage A for k1 in [k0, k0+kc): all n2, nta columns at a time ----
    for (int c0 = 0; c0 < n2; c0 += nta) {
      float er[2][4] = {}, ei[2][4] = {}, orr[2][4] = {}, oi[2][4] = {};
      for (int kt = 0; kt < n1; kt += kta) {
        __syncthreads();  // previous tile's readers are done
        for (int i = tid; i < kc * kta; i += THREADS) {
          const int r = i / kta, c = i % kta;
          const int g = (k0 + r) * n1 + kt + c;
          sAc[r * KTA + c] = op_round<BF16>(__ldg(p.d1c + g));
          sAs[r * KTA + c] = op_round<BF16>(__ldg(p.d1s + g));
        }
        for (int i = tid; i < kta * nta; i += THREADS) {
          const int r = i / nta, c = i % nta;
          float ev, od;
          fir_pair(xs, p.win, fft, p.n_taps, 2 * ((kt + r) * n2 + c0 + c), ev, od);
          sXe[r * NTA + c] = op_round<BF16>(ev);
          sXo[r * NTA + c] = op_round<BF16>(od);
        }
        __syncthreads();
        if (a_on) {
          for (int kk = 0; kk < kta; ++kk) {
            float xe[4], xo[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              xe[j] = sXe[kk * NTA + a_c + j];
              xo[j] = sXo[kk * NTA + a_c + j];
            }
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const float wc = sAc[(a_r + i) * KTA + kk];
              const float ws = sAs[(a_r + i) * KTA + kk];
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                er[i][j] = fmaf(wc, xe[j], er[i][j]);
                ei[i][j] = fmaf(ws, xe[j], ei[i][j]);
                orr[i][j] = fmaf(wc, xo[j], orr[i][j]);
                oi[i][j] = fmaf(ws, xo[j], oi[i][j]);
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
            const int r = a_r + i, col = c0 + a_c + j;
            const float wc = __ldg(p.twc + (k0 + r) * n2 + col);
            const float ws = __ldg(p.tws + (k0 + r) * n2 + col);
            if constexpr (STOP == DIT_STAGEA) {
              const long long o = obase + (k0 + r) * n2 + col;
              p.outr[o] = trunc_s8(op_round<BF16>(
                  __fsub_rn(__fmul_rn(er[i][j], wc), __fmul_rn(ei[i][j], ws))));
              p.outi[o] = trunc_s8(op_round<BF16>(
                  __fsub_rn(__fmul_rn(orr[i][j], wc), __fmul_rn(oi[i][j], ws))));
            } else {
              sTer[r * ts + col] = op_round<BF16>(
                  __fsub_rn(__fmul_rn(er[i][j], wc), __fmul_rn(ei[i][j], ws)));
              sTei[r * ts + col] = op_round<BF16>(
                  __fadd_rn(__fmul_rn(er[i][j], ws), __fmul_rn(ei[i][j], wc)));
              sTor[r * ts + col] = op_round<BF16>(
                  __fsub_rn(__fmul_rn(orr[i][j], wc), __fmul_rn(oi[i][j], ws)));
              sToi[r * ts + col] = op_round<BF16>(
                  __fadd_rn(__fmul_rn(orr[i][j], ws), __fmul_rn(oi[i][j], wc)));
            }
          }
        }
      }
    }

    if constexpr (STOP == DIT_STAGEA) continue;  // (the T planes were not written)
    // ---- stage B for k1 in [k0, k0+kc): all k2, mtb rows at a time ----
    for (int r0 = 0; r0 < n2; r0 += mtb) {
      // [stream][sum][i][j]; sums: cos·tr, -sin·ti, cos·ti, -sin·tr.
      float acc[2][4][4][2] = {};
      for (int kt = 0; kt < n2; kt += ktb) {
        __syncthreads();  // T planes complete (first pass) / previous tile read
        for (int i = tid; i < mtb * ktb; i += THREADS) {
          const int r = i / ktb, c = i % ktb;
          const int g = (r0 + r) * n2 + kt + c;
          sBc[r * KTB + c] = op_round<BF16>(__ldg(p.d2c + g));
          sBs[r * KTB + c] = op_round<BF16>(__ldg(p.d2s + g));
        }
        __syncthreads();
        if (b_on) {
          for (int kk = 0; kk < ktb; ++kk) {
            float t[2][2][2];  // [stream][re, im][j]
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int o = (b_c + j) * ts + kt + kk;
              t[0][0][j] = sTer[o];
              t[0][1][j] = sTei[o];
              t[1][0][j] = sTor[o];
              t[1][1][j] = sToi[o];
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float c = sBc[(b_r + i) * KTB + kk];
              const float sn = sBs[(b_r + i) * KTB + kk];
#pragma unroll
              for (int q = 0; q < 2; ++q) {
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                  acc[q][0][i][j] = fmaf(c, t[q][0][j], acc[q][0][i][j]);
                  acc[q][1][i][j] = fmaf(sn, t[q][1][j], acc[q][1][i][j]);
                  acc[q][2][i][j] = fmaf(c, t[q][1][j], acc[q][2][i][j]);
                  acc[q][3][i][j] = fmaf(sn, t[q][0][j], acc[q][3][i][j]);
                }
              }
            }
          }
        }
      }
      if (b_on) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int ch = (r0 + b_r + i) * n1 + k0 + b_c + j;
            const float xer = __fsub_rn(acc[0][0][i][j], acc[0][1][i][j]);
            const float xei = __fadd_rn(acc[0][2][i][j], acc[0][3][i][j]);
            const float xor_ = __fsub_rn(acc[1][0][i][j], acc[1][1][i][j]);
            const float xoi = __fadd_rn(acc[1][2][i][j], acc[1][3][i][j]);
            if constexpr (STOP == DIT_STAGEB) {
              // The im sums, times zero, keep all of stage B computed.
              p.outr[obase + ch] = trunc_s8(__fadd_rn(xer, __fmul_rn(0.f, xei)));
              p.outi[obase + ch] = trunc_s8(__fadd_rn(xor_, __fmul_rn(0.f, xoi)));
            } else {
              const float uc = __ldg(p.untc + ch), us = __ldg(p.unts + ch);
              const float xr = __fsub_rn(__fadd_rn(xer, __fmul_rn(uc, xor_)), __fmul_rn(us, xoi));
              const float xi = __fadd_rn(__fadd_rn(xei, __fmul_rn(uc, xoi)), __fmul_rn(us, xor_));
              const float rc = __ldg(p.rotc + static_cast<long long>(b) * n + ch);
              const float rs = __ldg(p.rots + static_cast<long long>(b) * n + ch);
              p.outr[obase + ch] = requant(__fsub_rn(__fmul_rn(xr, rc), __fmul_rn(xi, rs)));
              p.outi[obase + ch] = requant(__fadd_rn(__fmul_rn(xr, rs), __fmul_rn(xi, rc)));
            }
          }
        }
      }
    }
    __syncthreads();  // the next chunk overwrites the T planes
  }
}

size_t smem_bytes(int n2, int kc) {
  return sizeof(float) * (2 * kc * KTA + 2 * MTB * KTB + 2 * KTA * NTA +
                          4 * kc * static_cast<size_t>(n2 + 1));
}

template <bool BF16, int STOP = DIT_FULL>
cudaError_t launch(const Params& p, int batch, size_t bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fengine_dit_kernel<BF16, STOP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  dim3 grid(p.n_spectra, batch);
  fengine_dit_kernel<BF16, STOP><<<grid, THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// The stage stops of the bf16 kernel (the probe P2; see the head of the
// file): stop 1..6 = dma, conv, fir, deint, stagea, stageb; outputs as
// fengine_dit_launch's, no rotation planes (no stop reaches the rotation).
// The stops before the chunk loop launch with no shared memory. Returns -1
// where no plan fits.
extern "C" int fengine_dit_stop_launch(
    const void* x, const void* win, const void* d1c, const void* d1s, const void* d2c,
    const void* d2s, const void* twc, const void* tws, void* outr, void* outi, int batch,
    int n_frames, int n_taps, int n1, int n2, int stop, void* stream) {
  const int n_spectra = n_frames - n_taps + 1;
  if (n1 < 2 || (n1 & (n1 - 1)) || n2 < 4 || (n2 & (n2 - 1)) || n_taps < 1 ||
      n_spectra < 1 || batch < 1 || batch > 65535 || stop < DIT_DMA || stop > DIT_STAGEB) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int kc = n1 < KC ? n1 : KC;
  while (kc > 2 && smem_bytes(n2, kc) > MAX_SMEM) kc /= 2;
  const size_t bytes = stop >= DIT_STAGEA ? smem_bytes(n2, kc) : 0;
  if (bytes > MAX_SMEM) return -1;
  Params p{static_cast<const int8_t*>(x), static_cast<const float*>(win),
           static_cast<const float*>(d1c), static_cast<const float*>(d1s),
           static_cast<const float*>(d2c), static_cast<const float*>(d2s),
           static_cast<const float*>(twc), static_cast<const float*>(tws),
           nullptr, nullptr, nullptr, nullptr,
           static_cast<int8_t*>(outr), static_cast<int8_t*>(outi),
           n_frames, n_spectra, n_taps, n1, n2, kc};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (stop) {
    case DIT_DMA: err = launch<true, DIT_DMA>(p, batch, bytes, st); break;
    case DIT_CONV: err = launch<true, DIT_CONV>(p, batch, bytes, st); break;
    case DIT_FIR: err = launch<true, DIT_FIR>(p, batch, bytes, st); break;
    case DIT_DEINT: err = launch<true, DIT_DEINT>(p, batch, bytes, st); break;
    case DIT_STAGEA: err = launch<true, DIT_STAGEA>(p, batch, bytes, st); break;
    default: err = launch<true, DIT_STAGEB>(p, batch, bytes, st); break;
  }
  return static_cast<int>(err);
}

extern "C" int fengine_dit_launch(
    const void* x, const void* win, const void* d1c, const void* d1s, const void* d2c,
    const void* d2s, const void* twc, const void* tws, const void* untc, const void* unts,
    const void* rotc, const void* rots, void* outr, void* outi, int batch, int n_frames,
    int n_taps, int n1, int n2, int bf16, void* stream) {
  const int n_spectra = n_frames - n_taps + 1;
  // Shapes the tiling assumes (powers of two, the wrapper's _deint_mode).
  if (n1 < 2 || (n1 & (n1 - 1)) || n2 < 4 || (n2 & (n2 - 1)) || n_taps < 1 ||
      n_spectra < 1 || batch < 1 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int kc = n1 < KC ? n1 : KC;
  while (kc > 2 && smem_bytes(n2, kc) > MAX_SMEM) kc /= 2;
  const size_t bytes = smem_bytes(n2, kc);
  if (bytes > MAX_SMEM) return -1;  // no plan: even a 2-row chunk does not fit
  Params p{static_cast<const int8_t*>(x), static_cast<const float*>(win),
           static_cast<const float*>(d1c), static_cast<const float*>(d1s),
           static_cast<const float*>(d2c), static_cast<const float*>(d2s),
           static_cast<const float*>(twc), static_cast<const float*>(tws),
           static_cast<const float*>(untc), static_cast<const float*>(unts),
           static_cast<const float*>(rotc), static_cast<const float*>(rots),
           static_cast<int8_t*>(outr), static_cast<int8_t*>(outi),
           n_frames, n_spectra, n_taps, n1, n2, kc};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch<true>(p, batch, bytes, st) : launch<false>(p, batch, bytes, st);
  return static_cast<int>(err);
}
