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
// 4·N1²·N2 + 8·N2²·N1 multiply-adds (67 M at fft 65536: 256·128, the same
// count as K1's CT rDFT of the whole frame), so 8 of the flagship's 160
// streams at S = 256 are 275 GFLOP: 0.28 ms at the bf16 tensor rate, 4.1
// ms at the f32 SIMT rate; its bytes (0.28 GB) take 0.08 ms.
//
// Three bodies, picked by the wrapper (ops/fengine_fused.py:_dit_body):
//
// A. bf16 DFT operands with N1 >= 16, where a shared-memory plan exists
//    (every split from 16·64 to 1024·1024): two passes over groups of
//    streams whose bf16 planes fit K1's scratch.
//    1. K1's FIR pass (k1_fir_kernel, csrc/fengine_ct.cu, unchanged) on the
//       frames viewed [B, n_frames·fft] with every start at 0: it writes the
//       f32 tap-order FIR rounded to bf16, which is K7's rounded FIR, into a
//       [B, S, fft] plane.
//    2. dit_dft_kernel below: both DFT stages on the tensor cores. The even
//       stream's element (n1, n2) is plane sample 2·(n1·N2 + n2) and the
//       odd stream's the next, so the plane viewed [N1, 2·N2] holds both
//       streams' row n1, interleaved: stage A (every column times the same
//       [N1, N1] matrix) is one product of D1 against that natural view,
//       no deinterleave. An m16n8k16 accumulator fragment gives a thread
//       columns 2·n2 and 2·n2 + 1, one n2 of both streams, so the epilogue
//       applies one f32 twiddle to the pair and writes the even and odd T
//       planes apart into shared memory, rounded to bf16. Stage B then runs
//       per stream against the bf16 [N2, N2] cos and -sin matrices, eight
//       sums a (k2, k1) (four a stream), followed by the DIT combine, the
//       rotation and the requant at the reference's rounding points.
//    The design is K1's k1_dft_kernel: persistent blocks of 16 warps walk
//    (stream, spectrum, chunk of KC k1 rows) units, chunks of one spectrum
//    neighbours so the plane leaves HBM once; one cp.async ring streams
//    every unit's tile sequence (stage-A plane and D1 tiles, then stage-B
//    D2 tiles) so the copies of the next unit overlap this one's epilogue;
//    KC follows N2 (64 rows up to N2 = 256, 32 at 512, 16 at 1024) so the
//    four T planes and 3-4 ring stages fit.
//    Against the three costs K1's DFT pass is blamed for (PERF.md §7):
//    - The four f32 adds per stage-A MMA (mma16816_rn). Up to N1 = 256 the
//      stage-A MMAs chain through the tensor core's accumulator (CHAIN_N1).
//      In development runs at ~50 codes rms the chained sums flipped a few
//      1e-4 of the int8 codes up to N1 = 256, about 2.5 times as many as
//      the added ones, more at N1 = 512 and past the 1e-3 gate at
//      1024·1024; so from N1 = 512 on each MMA's sum is added in f32
//      round-to-nearest, as K1 does. Chained, the pass ran a few percent
//      faster at 256·128.
//    - The f32 twiddles each unit loads while every warp waits: a thread
//      loads a row's four twiddles together in the stage-A epilogue (one n2
//      serves both streams), as K1 loads its 16-row groups. Kept.
//    - The plane re-read once per chunk: at 256·128 a spectrum's plane is
//      read N1/KC = 4 times, from L2 (the chunks of one spectrum run on
//      neighbouring blocks at once). Kept: development runs that skipped
//      the twiddle loads or the plane copies (timing only) each saved
//      under a tenth of the pass, so a block that keeps its spectrum's
//      128 KB plane resident was not built; the MMA and ldmatrix issue is
//      the suspect (wgmma is the next step).
//    Registers: 512 threads leave 128 a thread. The 64-accumulator warp
//    tiles fit only with the unit cursor kept as two ints (unit, tile) and
//    the fragments loaded a stream or a matrix at a time; the 16-row chunk
//    spilled until its stage-B warps took 8 k1 columns and its K loops ran
//    one compile-time step. Halving stage A's warp width (16 columns) or
//    every stage-B warp's (8 columns) spilled or ran slower, and 4 stages
//    of 32-deep K tiles ran slower at 256·128 than 3 stages of 64.
// A'. f32 DFT operands with N1 >= 16 and 64 <= N2 <= 512: two passes as
//    well, K1's FIR pass into an f32 plane (the exact f32 sums, K7's f32
//    FIR), then dit_dft_f32_kernel: K1's f32 FFMA DFT pass on this form's
//    operand (its design is at the kernel).
// B. N1 = 8 (fft 512 and 1024 "auto", fft 2048 "bitcast") and any split
//    without a plan: fengine_dit_kernel, SIMT FMA on register micro tiles,
//    described next. P2's stops cut this body.
//
// SIMT design. One block per (spectrum s, stream b), as K1's SIMT body. The
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

#include <type_traits>

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

// ---------------------------------------------------------------------------
// The two-pass body's DFT pass on the tensor cores (see the head of the file)
// ---------------------------------------------------------------------------
constexpr int DFT_THREADS = 512;  // 16 warps: one block an SM
constexpr int DFT_WARPS = DFT_THREADS / 32;
constexpr int PAD = 8;            // row padding (elements): conflict-free ldmatrix
constexpr int NO_PLAN = -1;
// The DFT pass's stage stops (dit_dft_stop_launch): stage A and its twiddle
// into the T planes alone (no stage-B tiles, nothing written), or stages A
// and B with each stream's re written truncated (no combine, rotation or
// requant). The production instantiation (DFT_FULL) is unchanged by them.
constexpr int DFT_FULL = 0, DFT_STAGEA = 1, DFT_STAGEB = 2;

using bf16 = __nv_bfloat16;

struct DftParams {
  const bf16* plane;  // [G, S, N1, 2·N2]: row n1 holds both streams' row n1, interleaved
  const bf16* d1c;    // [N1, N1] cos
  const bf16* d1s;    // [N1, N1] -sin
  const bf16* d2c;    // [N2, N2] cos
  const bf16* d2s;    // [N2, N2] -sin
  const float* twc;   // [N1, N2]
  const float* tws;
  const float* untc;  // [N2, N1]
  const float* unts;
  const float* rotc;  // [G, N]
  const float* rots;
  int8_t* outr;       // [G, S, N]
  int8_t* outi;
  int n_spectra, n1, n2;
  int kt;                        // K-tile depth of both stages
  int n_ca, n_kta, n_rb, n_ktb;  // column tiles x K tiles, row tiles x K tiles
  int n_chunks;
  int n_units;                   // G * S * n_chunks
  int slot;                      // bf16 elements per ring slot
  int stages;                    // ring depth: 3 or 4
};

// The tile shapes of a KC-row chunk. Stage A: warps MW x NW, each WM k1 rows
// (cos and -sin) x WN plane columns (WN / 2 n2 of both streams): NA columns
// a tile. Stage B: warps (16 / NWB) x NWB, each 16 k2 rows x WNB k1 columns
// (16; 8 in the 16-row chunk, whose 16 k1 columns leave the 16 warps no
// other split, and where 16 spilled), eight sums (four a stream): MB rows a
// tile. Both keep at most 64 f32 accumulators a thread.
template <int KC>
struct DitShape {
  static constexpr int WM = KC < 32 ? KC : 32;
  static constexpr int MI = WM / 16;
  static constexpr int MW = KC / WM;
  static constexpr int NW = DFT_WARPS / MW;
  static constexpr int WN = 32;  // plane columns a warp
  static constexpr int NJ = WN / 8;
  static constexpr int NA = WN * NW;
  static constexpr int WNB = KC == 16 ? 8 : 16;  // k1 columns a warp in stage B
  static constexpr int NJB = WNB / 8;
  static constexpr int NWB = KC / WNB;
  static constexpr int MB = 16 * (DFT_WARPS / NWB);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until the oldest of the ring's stages - 1 groups in flight has landed.
__device__ __forceinline__ void cp_async_wait_ring(int stages) {
  if (stages == 4) {
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma16816(float* d, const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b, the MMA summing its 16 products alone and the sum added to d in
// f32 round-to-nearest (K1's stage-A form, csrc/fengine_ct.cu).
__device__ __forceinline__ void mma16816_rn(float* d, const uint32_t a[4], uint32_t b0,
                                            uint32_t b1) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma16816(t, a, b0, b1);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] = __fadd_rn(d[e], t[e]);
}

// Stage A's product: chained through the MMA's accumulator (CHAIN), or each
// MMA's sum added in f32 round-to-nearest.
template <bool CHAIN>
__device__ __forceinline__ void mma_stage_a(float* d, const uint32_t a[4], uint32_t b0,
                                            uint32_t b1) {
  if constexpr (CHAIN) {
    mma16816(d, a, b0, b1);
  } else {
    mma16816_rn(d, a, b0, b1);
  }
}

// The longest stage-A sum (N1) that chains its MMAs; longer sums add each
// MMA's sum in f32 round-to-nearest (see the head of the file).
constexpr int CHAIN_N1 = 256;

// log2 of a power of two.
__device__ __forceinline__ int lg(int v) { return __ffs(v) - 1; }

// A walk through this block's tile sequence: unit u (blockIdx.x, then every
// gridDim.x-th), tile `local` of the unit. A unit is (stream b, spectrum s,
// chunk), the chunk fastest: its spectrum's plane row is u / n_chunks =
// b * S + s, its first k1 row (u % n_chunks) * KC. Only (u, local) are kept
// live; the rest is decoded where it is used.
struct Cursor {
  int u, local;
};

__device__ __forceinline__ void advance(Cursor& c, int tpu) {
  if (++c.local == tpu) {
    c.local = 0;
    c.u += gridDim.x;
  }
}

// The unit's plane row b * S + s, and its first k1 row.
__device__ __forceinline__ int unit_row(const DftParams& p, int u) { return u >> lg(p.n_chunks); }

template <int KC>
__device__ __forceinline__ int unit_k0(const DftParams& p, int u) {
  return (u & (p.n_chunks - 1)) * KC;
}

// Tile `local` of a unit: stage A (column tile, K tile) for local < nA,
// then stage B (row tile, K tile).
struct Tile {
  bool stage_a;
  int outer, kidx;
};

__device__ __forceinline__ Tile place(const DftParams& p, int local, int nA) {
  Tile w;
  w.stage_a = local < nA;
  if (w.stage_a) {
    w.outer = local >> lg(p.n_kta);
    w.kidx = local & (p.n_kta - 1);
  } else {
    const int l = local - nA;
    w.outer = l >> lg(p.n_ktb);
    w.kidx = l & (p.n_ktb - 1);
  }
  return w;
}

// Issue the cp.async copies of one tile into a ring slot (every thread, 16
// bytes a copy; rows land padded).
template <int KC>
__device__ __forceinline__ void load_tile(const DftParams& p, const Cursor& c, int nA,
                                          bf16* slot) {
  using S = DitShape<KC>;
  const int tid = threadIdx.x;
  const int n1 = p.n1, n2 = p.n2, w2 = 2 * n2;
  const int kt = p.kt, ktp = kt + PAD, ld = lg(kt / 8);
  const Tile t = place(p, c.local, nA);
  if (t.stage_a) {
    // [kt x cols] of the plane's [N1, 2·N2] view, then the chunk's [KC x kt]
    // cos and -sin rows of the N1-point matrix.
    const int lx = lg(min(S::NA, w2) / 8);
    const int nx = kt << lx, nd = KC << ld;
    const bf16* xsrc = p.plane +
                       (static_cast<long long>(unit_row(p, c.u)) * n1 + t.kidx * kt) * w2 +
                       t.outer * S::NA;
    const int k0 = unit_k0<KC>(p, c.u);
    bf16* sd = slot + kt * (S::NA + PAD);
    for (int i = tid; i < nx + 2 * nd; i += DFT_THREADS) {
      if (i < nx) {
        const int r = i >> lx, q = i & ((1 << lx) - 1);
        cp_async16(slot + r * (S::NA + PAD) + q * 8, xsrc + static_cast<long long>(r) * w2 + q * 8);
      } else {
        const int j = i - nx, m = j >= nd, jj = j - m * nd;
        const int r = jj >> ld, q = jj & ((1 << ld) - 1);
        const bf16* src = (m ? p.d1s : p.d1c) + (k0 + r) * n1 + t.kidx * kt + q * 8;
        cp_async16(sd + (m * KC + r) * ktp + q * 8, src);
      }
    }
  } else {
    // [rows x kt] of the N2-point matrix's cos rows, then of its -sin rows.
    const int nd = min(S::MB, n2) << ld;
    const int r0 = t.outer * S::MB;
    for (int i = tid; i < 2 * nd; i += DFT_THREADS) {
      const int m = i >= nd, j = i - m * nd;
      const int r = j >> ld, q = j & ((1 << ld) - 1);
      const bf16* src = (m ? p.d2s : p.d2c) + static_cast<long long>(r0 + r) * n2 + t.kidx * kt + q * 8;
      cp_async16(slot + (m * S::MB + r) * ktp + q * 8, src);
    }
  }
}

template <int KC, bool CHAIN, int STOP = DFT_FULL>
__global__ void __launch_bounds__(DFT_THREADS, 1) dit_dft_kernel(DftParams p) {
  using S = DitShape<KC>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int n1 = p.n1, n2 = p.n2, n = n1 * n2, w2 = 2 * n2;
  const int tld = n2 + PAD, tplane = KC * tld;
  const int stages = p.stages;
  bf16* sT = smem;  // [4][KC][N2 + PAD]: even re, even im, odd re, odd im
  bf16* ring = sT + 4 * tplane;

  const int nA = p.n_ca * p.n_kta, tpu = nA + p.n_rb * p.n_ktb;
  const int my_units = (p.n_units - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1;
  const int n_tiles = my_units * tpu;

  // Warp placement. Stage A: k1 rows a_r0.., plane columns a_c0.. of the tile.
  const int a_r0 = (warp / S::NW) * S::WM, a_c0 = (warp % S::NW) * S::WN;
  // Stage B: k2 rows b_r0.. of the row tile, k1 columns b_c0.. of the chunk.
  const int b_r0 = (warp / S::NWB) * 16, b_c0 = (warp % S::NWB) * S::WNB;

  // One register array for both stages' accumulators (at most 64 f32 a
  // thread). Stage A: [cos/sin][MI][NJ n8][4]; stage B: [8 sums][NJB n8][4],
  // sums cos.tr, -sin.ti, cos.ti, -sin.tr of the even stream, then the odd.
  float acc[64];

  Cursor ld{static_cast<int>(blockIdx.x), 0};  // the next tile to load
  Cursor cc = ld;  // the tile to compute
  for (int t = 0; t < stages - 1; ++t) {
    if (t < n_tiles) {
      load_tile<KC>(p, ld, nA, ring + t * p.slot);
      advance(ld, tpu);
    }
    cp_async_commit();
  }

  int slot_i = 0;  // tile t's slot, t % stages
  for (int t = 0; t < n_tiles; ++t, advance(cc, tpu)) {
    cp_async_wait_ring(stages);
    __syncthreads();  // tile t landed for every thread; tile t-1's slot is free
    if (t + stages - 1 < n_tiles) {
      const int s_load = slot_i == 0 ? stages - 1 : slot_i - 1;  // (t + stages - 1) % stages
      load_tile<KC>(p, ld, nA, ring + s_load * p.slot);
      advance(ld, tpu);
    }
    cp_async_commit();
    const Tile w = place(p, cc.local, nA);
    const bf16* slot = ring + slot_i * p.slot;
    slot_i = slot_i + 1 == stages ? 0 : slot_i + 1;
    const int k0 = unit_k0<KC>(p, cc.u);
    const int kt = p.kt, ktp = kt + PAD;
    if (w.stage_a) {
      const int col = w.outer * S::NA + a_c0;  // first plane column of the warp
      if (col >= w2) continue;
      if (w.kidx == 0) {
#pragma unroll
        for (int i = 0; i < 8 * S::MI * S::NJ; ++i) acc[i] = 0.f;
      }
      const int xld = S::NA + PAD;
      const bf16* sX = slot;
      const bf16* sAc = slot + kt * xld;
      const bf16* sAs = sAc + KC * ktp;
      for (int kk = 0; kk < (KC == 16 ? 16 : kt); kk += 16) {
        uint32_t fb[S::NJ / 2][4];
#pragma unroll
        for (int jj = 0; jj < S::NJ / 2; ++jj) {
          const int r = kk + lane % 8 + ((lane / 8) % 2) * 8;
          ldsm_x4_t(fb[jj], sX + r * xld + a_c0 + jj * 16 + (lane / 16) * 8);
        }
#pragma unroll
        for (int m = 0; m < 2; ++m) {  // cos rows, then -sin rows
          uint32_t fa[S::MI][4];
#pragma unroll
          for (int i = 0; i < S::MI; ++i) {
            const int r = a_r0 + i * 16 + lane % 16, c = kk + (lane / 16) * 8;
            ldsm_x4(fa[i], (m ? sAs : sAc) + r * ktp + c);
          }
#pragma unroll
          for (int i = 0; i < S::MI; ++i) {
#pragma unroll
            for (int j = 0; j < S::NJ; ++j) {
              mma_stage_a<CHAIN>(acc + ((m * S::MI + i) * S::NJ + j) * 4, fa[i],
                          fb[j / 2][(j % 2) * 2], fb[j / 2][(j % 2) * 2 + 1]);
            }
          }
        }
      }
      if (w.kidx == p.n_kta - 1) {
        // The f32 twiddle of n2 = (column) / 2 on both streams' columns,
        // bf16 rounding, into the T planes. A row's four twiddles are loaded
        // together first: the L2 round trips overlap.
#pragma unroll
        for (int i = 0; i < S::MI; ++i) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = a_r0 + i * 16 + g + hh * 8;
            float wc[S::NJ], ws[S::NJ];
#pragma unroll
            for (int j = 0; j < S::NJ; ++j) {
              const int o = (k0 + r) * n2 + (col + j * 8) / 2 + tig;
              wc[j] = __ldg(p.twc + o);
              ws[j] = __ldg(p.tws + o);
            }
#pragma unroll
            for (int j = 0; j < S::NJ; ++j) {
              const int m2 = (col + j * 8) / 2 + tig;
              const float* cr = acc + ((0 * S::MI + i) * S::NJ + j) * 4 + hh * 2;
              const float* ci = acc + ((1 * S::MI + i) * S::NJ + j) * 4 + hh * 2;
#pragma unroll
              for (int q = 0; q < 2; ++q) {  // column 2·m2 + q: stream q
                const float tr = __fsub_rn(__fmul_rn(cr[q], wc[j]), __fmul_rn(ci[q], ws[j]));
                const float ti = __fadd_rn(__fmul_rn(cr[q], ws[j]), __fmul_rn(ci[q], wc[j]));
                sT[(2 * q) * tplane + r * tld + m2] = __float2bfloat16_rn(tr);
                sT[(2 * q + 1) * tplane + r * tld + m2] = __float2bfloat16_rn(ti);
              }
            }
          }
        }
      }
    } else {
      const int row = w.outer * S::MB + b_r0;  // first k2 row of the warp
      if (row >= n2) continue;
      if (w.kidx == 0) {
#pragma unroll
        for (int i = 0; i < 32 * S::NJB; ++i) acc[i] = 0.f;
      }
      const bf16* sC = slot;
      const bf16* sS = slot + S::MB * ktp;
      for (int kk = 0; kk < (KC == 16 ? 16 : kt); kk += 16) {
        uint32_t fc[4], fs[4];
        {
          const int r = b_r0 + lane % 16, c = kk + (lane / 16) * 8;
          ldsm_x4(fc, sC + r * ktp + c);
          ldsm_x4(fs, sS + r * ktp + c);
        }
        const int tc0 = w.kidx * kt + kk + ((lane / 8) % 2) * 8;
        constexpr int SS = 4 * S::NJB;  // accumulator stride of the sums
#pragma unroll
        for (int q = 0; q < 2; ++q) {  // the even stream, then the odd
          // b0, b1 of each n8 tile: T re in ftr, T im in fti.
          uint32_t ftr[2 * S::NJB], fti[2 * S::NJB];
          if constexpr (S::NJB == 2) {
            const int tr0 = b_c0 + lane % 8 + (lane / 16) * 8;
            ldsm_x4(ftr, sT + (2 * q) * tplane + tr0 * tld + tc0);
            ldsm_x4(fti, sT + (2 * q + 1) * tplane + tr0 * tld + tc0);
          } else {
            uint32_t f4[4];  // re, then im, of one n8 tile
            ldsm_x4(f4, sT + (2 * q + lane / 16) * tplane + (b_c0 + lane % 8) * tld + tc0);
            ftr[0] = f4[0];
            ftr[1] = f4[1];
            fti[0] = f4[2];
            fti[1] = f4[3];
          }
#pragma unroll
          for (int j = 0; j < S::NJB; ++j) {
            float* a0 = acc + (q * 4 * S::NJB + j) * 4;  // sum s of stream q at a0 + s * SS
            mma16816(a0 + 0 * SS, fc, ftr[2 * j], ftr[2 * j + 1]);
            mma16816(a0 + 1 * SS, fs, fti[2 * j], fti[2 * j + 1]);
            mma16816(a0 + 2 * SS, fc, fti[2 * j], fti[2 * j + 1]);
            mma16816(a0 + 3 * SS, fs, ftr[2 * j], ftr[2 * j + 1]);
          }
        }
      }
      if (w.kidx == p.n_ktb - 1) {
        // Each stream's re = cos.tr - (-sin.ti), im = cos.ti + (-sin.tr);
        // X = E + exp(-iπk/N)·O; rotate; requant; store. A row's combine and
        // rotation values are loaded together first.
        const int prow = unit_row(p, cc.u);  // b * S + s
        const long long obase = static_cast<long long>(prow) * n;
        const long long rbase = static_cast<long long>(prow / p.n_spectra) * n;
        constexpr int SS = 4 * S::NJB;  // accumulator stride of the sums
#pragma unroll
        for (int j = 0; j < S::NJB; ++j) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int ch = (row + g + hh * 8) * n1 + k0 + b_c0 + j * 8 + tig * 2;
            float2 uc, us, rc, rs;
            if constexpr (STOP == DFT_FULL) {
              uc = __ldg(reinterpret_cast<const float2*>(p.untc + ch));
              us = __ldg(reinterpret_cast<const float2*>(p.unts + ch));
              rc = __ldg(reinterpret_cast<const float2*>(p.rotc + rbase + ch));
              rs = __ldg(reinterpret_cast<const float2*>(p.rots + rbase + ch));
            }
            int8_t v[2][2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float* a = acc + j * 4 + hh * 2 + e;  // sum s at a[s * SS]
              const float er = __fsub_rn(a[0 * SS], a[1 * SS]);
              const float ei = __fadd_rn(a[2 * SS], a[3 * SS]);
              const float orr = __fsub_rn(a[4 * SS], a[5 * SS]);
              const float oi = __fadd_rn(a[6 * SS], a[7 * SS]);
              if constexpr (STOP == DFT_STAGEB) {
                // Each stream's re, truncated; the im sums, times zero, keep
                // all of stage B computed.
                v[0][e] = trunc_s8(__fadd_rn(er, __fmul_rn(0.f, ei)));
                v[1][e] = trunc_s8(__fadd_rn(orr, __fmul_rn(0.f, oi)));
              } else {
                const float u_c = e ? uc.y : uc.x, u_s = e ? us.y : us.x;
                const float r_c = e ? rc.y : rc.x, r_s = e ? rs.y : rs.x;
                const float xr = __fsub_rn(__fadd_rn(er, __fmul_rn(u_c, orr)), __fmul_rn(u_s, oi));
                const float xi = __fadd_rn(__fadd_rn(ei, __fmul_rn(u_c, oi)), __fmul_rn(u_s, orr));
                v[0][e] = requant(__fsub_rn(__fmul_rn(xr, r_c), __fmul_rn(xi, r_s)));
                v[1][e] = requant(__fadd_rn(__fmul_rn(xr, r_s), __fmul_rn(xi, r_c)));
              }
            }
            *reinterpret_cast<char2*>(p.outr + obase + ch) = make_char2(v[0][0], v[0][1]);
            *reinterpret_cast<char2*>(p.outi + obase + ch) = make_char2(v[1][0], v[1][1]);
          }
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The tile depth, ring depth and bytes of a chunk of KC rows, 0 if it cannot
// fit: the deepest K tiles (64, 32, 16) with 4 stages, else 3, that fit.
// (ops/fengine_fused.py:_dit_body asks dit_dft_attributes whether one does.)
template <int KC>
size_t dit_plan(DftParams& p) {
  using S = DitShape<KC>;
  if (KC > p.n1) return 0;
  const size_t t_bytes = sizeof(bf16) * 4 * static_cast<size_t>(KC) * (p.n2 + PAD);
  // The 16-row chunk takes 16-deep K tiles only, so its K loops run one
  // step each (unrolled at compile time: a loop of run-time length spilled).
  for (int kt = KC == 16 ? 16 : 64; kt >= 16; kt /= 2) {
    if (kt > p.n1 || kt > p.n2) continue;
    const int a_slot = kt * (S::NA + PAD) + 2 * KC * (kt + PAD);
    const int b_slot = 2 * S::MB * (kt + PAD);
    for (int stages = 4; stages >= 3; --stages) {
      const size_t bytes = t_bytes + sizeof(bf16) * static_cast<size_t>(stages) *
                                         static_cast<size_t>(max(a_slot, b_slot));
      if (bytes > MAX_SMEM) continue;
      p.kt = kt;
      p.slot = max(a_slot, b_slot);
      p.stages = stages;
      p.n_ca = (2 * p.n2 + S::NA - 1) / S::NA;
      p.n_kta = p.n1 / kt;
      p.n_rb = (p.n2 + S::MB - 1) / S::MB;
      p.n_ktb = p.n2 / kt;
      p.n_chunks = p.n1 / KC;
      return bytes;
    }
  }
  return 0;
}

template <int KC, bool CHAIN, int STOP = DFT_FULL>
cudaError_t launch_dft(DftParams p, int batch, size_t bytes, cudaStream_t stream) {
  auto kern = dit_dft_kernel<KC, CHAIN, STOP>;
  if (STOP == DFT_STAGEA) p.n_rb = 0;  // no stage-B tiles
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
    return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, DFT_THREADS, bytes);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long units = static_cast<long long>(batch) * p.n_spectra * p.n_chunks;
  const long long resident = static_cast<long long>(sms) * per_sm;
  const int grid = static_cast<int>(units < resident ? units : resident);
  // Unit indices and a block's tile count must fit an int.
  const long long tpu = p.n_ca * p.n_kta + p.n_rb * p.n_ktb;
  if (units > 0x7fffffffLL - grid || ((units + grid - 1) / grid) * tpu > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  p.n_units = static_cast<int>(units);
  kern<<<grid, DFT_THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

// Calls fn(std::integral_constant<int, KC>, params, bytes) with the largest
// chunk whose T planes and ring fit, or returns NO_PLAN.
template <typename Fn>
int with_plan(const DftParams& p, Fn fn) {
  DftParams q = p;
  size_t bytes;
  if ((bytes = dit_plan<64>(q))) return fn(std::integral_constant<int, 64>{}, q, bytes);
  q = p;
  if ((bytes = dit_plan<32>(q))) return fn(std::integral_constant<int, 32>{}, q, bytes);
  q = p;
  if ((bytes = dit_plan<16>(q))) return fn(std::integral_constant<int, 16>{}, q, bytes);
  return NO_PLAN;
}

// ---------------------------------------------------------------------------
// The f32 two-pass body's DFT pass: register-blocked FFMA (exact f32
// products and sums; no tensor core, no TF32)
// ---------------------------------------------------------------------------
// K1's f32 DFT pass (k1_dft_f32_kernel, csrc/fengine_ct.cu) on the DIT
// form's operand. A unit is (stream, block of SB spectra, chunk of KC k1
// rows); persistent blocks of 256 threads (one an SM) walk the units chunk
// fastest, so the chunks of one block of spectra run side by side and its
// plane rows stay in L2. A cp.async ring of 4 slots streams one tile
// sequence through every unit, kept 3 tiles ahead of the compute:
//   stage A tiles: [KTA x SB·2N2] of the plane viewed [N1, 2·N2] (row n1
//     holds both streams' row n1, interleaved: column 2·n2 + q is stream
//     q's element (n1, n2)) and [KTA x 2KC] of the N1-point matrix (cos,
//     -sin; symmetric, read as [n1][k1]). A thread owns 4 k1 rows x 8
//     columns (64 FFMA for 4 shared loads a step), so one real-input
//     product covers both streams with no deinterleave. After the last K
//     tile one f32 twiddle exp(-2πi k1 n2 / N) serves both streams'
//     columns of an n2, and the four T planes (even re, even im, odd re,
//     odd im) [SB·KC][N2] land in shared memory;
//   stage B tiles, in two halves of the k2 range (all N2 values of k2, not
//     K1's half): [KTB x N2] of the half's N2-point matrix, transposed
//     ([n2][cos of the half's k2, then -sin]). A thread owns 4 k2 x 2 T
//     rows x both streams x the four sums cos.tr, -sin.ti, cos.ti, -sin.tr
//     (64 accumulators; 4 shared loads feed 64 FFMA, as in K1); then the
//     plain version's epilogue: each stream's re and im, X = E +
//     (untc + i·unts)·O in f32, the rotation, rint, clip, int8.
// Against K1's f32 pass a T row holds 4·N2 floats, not 2·N2, so with the
// same 64 KB of T planes and the same stage-A tile (KC · SB · 2N2 = 8192)
// SB halves: KC = 16 with SB = 256 / N2 up to N2 = 256 (two spectra a unit
// at the flagship's 256·128), KC = 8 at N2 = 512. N2 = 1024 (fft 2^21) and
// N1 = 8 have no plan: they stay on the SIMT body (dit_dft_f32_attributes
// decides). T rows are XOR-swizzled by 16-byte groups ((row / 2) % 8), so
// stage A's row-wise float2 stores and stage B's reads of two rows at a
// time are both free of bank conflicts.
// What bounds it: the f32 FFMA rate, the same operation count as K1's f32
// pass at the same fft (4.10 ms on 8 flagship streams).
constexpr int F32_THREADS = 256;
constexpr int F32_OUT = 32 * F32_THREADS;  // KC * SB * 2·N2: stage-A outputs / 2
constexpr int F32_SLOT = 8192;             // most floats a stage-B tile takes
constexpr int F32_STAGES = 4;              // ring slots
constexpr int F32_TP = F32_OUT / 2;        // floats a T plane: SB·KC rows of N2

// Floats a ring slot of a KC-row chunk: a stage-A tile ([KTA x NCOL] of the
// plane and [KTA x 2KC] of the N1-point matrix, KTA = KC) or a stage-B tile.
template <int KC>
__host__ __device__ constexpr int f32_slot() {
  return KC * (F32_OUT / KC) + KC * 2 * KC > F32_SLOT ? KC * (F32_OUT / KC) + KC * 2 * KC
                                                      : F32_SLOT;
}

// Shared-memory bytes of a KC-row chunk: the four T planes and the ring.
template <int KC>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * (4 * static_cast<size_t>(F32_TP) +
                          static_cast<size_t>(F32_STAGES) * f32_slot<KC>());
}
static_assert(f32_smem_bytes<16>() <= MAX_SMEM && f32_smem_bytes<8>() <= MAX_SMEM,
              "the f32 DFT pass's 4-slot ring must fit beside its T planes");

struct F32Params {
  const float* plane;  // [G, S, N1, 2·N2] f32
  const float* d1c;    // [N1, N1] cos (symmetric)
  const float* d1s;    // [N1, N1] -sin (symmetric)
  const float* d2h;    // [2][N2][N2]: half h, row n2: cos(2π k2 n2 / N2) for
                       // k2 = h·N2/2 + j (j < N2/2), then -sin
  const float* twc;    // [N1, N2]
  const float* tws;
  const float* untc;   // [N2, N1]
  const float* unts;
  const float* rotc;   // [G, N]
  const float* rots;
  int8_t* outr;        // [G, S, N]
  int8_t* outi;
  int n_spectra, n1, n2;
  int sb, ktb;             // spectra a unit; stage-B K-tile depth
  int n_kta, n_ktb;        // K tiles: stage A; each half of stage B
  int n_chunks, n_sblk;    // k1 chunks; blocks of SB spectra a stream
  int n_units;             // G * n_sblk * n_chunks
};

// The swizzled float index of T row `row`, even column `col` (a float2 or a
// 4-aligned float4 stays whole).
__device__ __forceinline__ int t_at(int row, int col, int n2) {
  return row * n2 + (col ^ (((row >> 1) & 7) << 2));
}

// A block's walk: unit i of the block (unit blockIdx.x + i * gridDim.x),
// tile `local` of the unit.
struct F32Cursor {
  int i, local;
  int b, s0, k0;  // stream, first spectrum, first k1 row
};

template <int KC>
__device__ __forceinline__ void f32_set_unit(const F32Params& p, F32Cursor& c) {
  const int u = blockIdx.x + c.i * gridDim.x;
  c.k0 = (u & (p.n_chunks - 1)) * KC;
  const int rest = u >> lg(p.n_chunks);
  c.s0 = (rest % p.n_sblk) * p.sb;
  c.b = rest / p.n_sblk;
}

template <int KC>
__device__ __forceinline__ void f32_advance(const F32Params& p, F32Cursor& c, int tpu) {
  if (++c.local == tpu) {
    c.local = 0;
    ++c.i;
    f32_set_unit<KC>(p, c);
  }
}

// Issue the cp.async copies of one tile into a ring slot (16 bytes a copy).
template <int KC>
__device__ __forceinline__ void f32_load_tile(const F32Params& p, const F32Cursor& c,
                                              float* slot) {
  constexpr int KTA = KC, NCOL = F32_OUT / KC, NT = F32_THREADS;
  const int tid = threadIdx.x;
  const int n1 = p.n1, w2 = 2 * p.n2;
  if (c.local < p.n_kta) {
    // [KTA x NCOL] of the plane: row r is n1 = kt0 + r of each spectrum;
    // column s * 2N2 + 2·n2 + q. Spectra past the stream's last are not
    // loaded (their columns are computed and never stored).
    const int kt0 = c.local * KTA, lw = lg(w2);
    constexpr int PX = KTA * NCOL / 4, PD = KTA * 2 * KC / 4;
#pragma unroll 4
    for (int i = tid; i < PX; i += NT) {
      const int r = i / (NCOL / 4), col = (i % (NCOL / 4)) * 4;
      const int s = c.s0 + (col >> lw);
      if (s < p.n_spectra) {
        const float* src = p.plane +
                           ((static_cast<long long>(c.b) * p.n_spectra + s) * n1 + kt0 + r) * w2 +
                           (col & (w2 - 1));
        cp_async16(slot + r * NCOL + col, src);
      }
    }
    // [KTA x 2KC]: cos of k1 rows k0.. at columns 0..KC-1, -sin at KC..
    float* sd = slot + KTA * NCOL;
    for (int i = tid; i < PD; i += NT) {
      const int r = i / (2 * KC / 4), q = (i % (2 * KC / 4)) * 4;
      const float* src = (q < KC ? p.d1c : p.d1s) + (kt0 + r) * n1 + c.k0 + (q & (KC - 1));
      cp_async16(sd + r * 2 * KC + q, src);
    }
  } else {
    // [KTB x N2] of the half's transposed N2-point matrix: one contiguous run.
    const int l = c.local - p.n_kta, half = l >= p.n_ktb, kidx = l - half * p.n_ktb;
    const float* src = p.d2h + (static_cast<long long>(half) * p.n2 + kidx * p.ktb) * p.n2;
    const int nf = p.ktb * p.n2;
    for (int i = tid * 4; i < nf; i += NT * 4) cp_async16(slot + i, src + i);
  }
}

// Stage B's accumulator of stream q, sum m (cos.tr, -sin.ti, cos.ti,
// -sin.tr), k2 a, T row c.
__host__ __device__ constexpr int b_acc(int q, int m, int a, int c) {
  return ((q * 4 + m) * 4 + a) * 2 + c;
}

template <int KC>
__global__ void __launch_bounds__(F32_THREADS, 1) dit_dft_f32_kernel(F32Params p) {
  constexpr int KTA = KC, NCOL = F32_OUT / KC;
  constexpr int GA = F32_THREADS * 4 / KC;  // stage-A column groups
  constexpr int SLOT = f32_slot<KC>();
  extern __shared__ __align__(128) float fsmem[];
  const int tid = threadIdx.x;
  const int n1 = p.n1, n2 = p.n2, h = n2 / 2, n = n1 * n2, w2 = 2 * n2;
  float* sT = fsmem;  // [4][SB*KC][N2]: even re, even im, odd re, odd im (t_at)
  float* ring = sT + 4 * F32_TP;

  const int nA = p.n_kta, tpu = nA + 2 * p.n_ktb;
  const int my_units = (p.n_units - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1;
  const int n_tiles = my_units * tpu;

  // Stage A: k1 rows 4*rg.. of the chunk; columns 4*j.. and NCOL/2 + 4*j..
  const int rg = tid / GA, ja = (tid % GA) * 4;
  // Stage B: T rows 2*qb, 2*qb + 1 of (spectrum, k1); k2 = half*h + 4*rb..
  // Q = SB*KC/2 pairs of T rows.
  const int lq = lg(p.sb * KC / 2);
  const int qb = tid & ((1 << lq) - 1), rb = tid >> lq;

  // Stage A: [cos/-sin][4 k1][8 columns]; stage B: b_acc(q, m, a, c).
  float acc[64];

  F32Cursor ld{0, 0, 0, 0, 0};  // the next tile to load
  f32_set_unit<KC>(p, ld);
  F32Cursor cc = ld;  // the tile to compute
  for (int t = 0; t < F32_STAGES - 1; ++t) {
    if (t < n_tiles) {
      f32_load_tile<KC>(p, ld, ring + t * SLOT);
      f32_advance<KC>(p, ld, tpu);
    }
    cp_async_commit();
  }

  int slot_i = 0;  // tile t's slot, t % F32_STAGES
  for (int t = 0; t < n_tiles; ++t, f32_advance<KC>(p, cc, tpu)) {
    // Tile t is the oldest of the F32_STAGES - 1 groups in flight.
    asm volatile("cp.async.wait_group %0;\n" ::"n"(F32_STAGES - 2) : "memory");
    __syncthreads();  // tile t landed for every thread; tile t-1's slot is free
    if (t + F32_STAGES - 1 < n_tiles) {
      const int s_load = (slot_i + F32_STAGES - 1) % F32_STAGES;  // (t + 3) % 4
      f32_load_tile<KC>(p, ld, ring + s_load * SLOT);
      f32_advance<KC>(p, ld, tpu);
    }
    cp_async_commit();
    const float* slot = ring + slot_i * SLOT;
    slot_i = (slot_i + 1) % F32_STAGES;
    const int k0 = cc.k0;
    if (cc.local < nA) {
      if (cc.local == 0) {
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      }
      const float* sX = slot;
      const float* sD = slot + KTA * NCOL;
#pragma unroll
      for (int kk = 0; kk < KTA; ++kk) {
        const float4 x0 = *reinterpret_cast<const float4*>(sX + kk * NCOL + ja);
        const float4 x1 = *reinterpret_cast<const float4*>(sX + kk * NCOL + NCOL / 2 + ja);
        const float4 dc = *reinterpret_cast<const float4*>(sD + kk * 2 * KC + 4 * rg);
        const float4 ds = *reinterpret_cast<const float4*>(sD + kk * 2 * KC + KC + 4 * rg);
        const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
        const float cv[4] = {dc.x, dc.y, dc.z, dc.w}, sv[4] = {ds.x, ds.y, ds.z, ds.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            acc[i * 8 + e] = fmaf(cv[i], xv[e], acc[i * 8 + e]);
            acc[32 + i * 8 + e] = fmaf(sv[i], xv[e], acc[32 + i * 8 + e]);
          }
        }
      }
      if (cc.local == nA - 1) {
        // The f32 twiddle into the T planes: tr = ar*wc - ai*ws, ti = ar*ws +
        // ai*wc, each product rounded. Columns col.. are E(m), O(m), E(m+1),
        // O(m+1) of spectrum s: one twiddle pair serves both streams.
        const int lw = lg(w2);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int col = half * (NCOL / 2) + ja;
          const int s = col >> lw, m = (col & (w2 - 1)) >> 1;
          float2 wc[4], ws[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const long long o = static_cast<long long>(k0 + 4 * rg + i) * n2 + m;
            wc[i] = __ldg(reinterpret_cast<const float2*>(p.twc + o));
            ws[i] = __ldg(reinterpret_cast<const float2*>(p.tws + o));
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float* ar = acc + i * 8 + half * 4;
            const float* ai = acc + 32 + i * 8 + half * 4;
            float tr[4], ti[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float c = e < 2 ? wc[i].x : wc[i].y, sn = e < 2 ? ws[i].x : ws[i].y;
              tr[e] = __fsub_rn(__fmul_rn(ar[e], c), __fmul_rn(ai[e], sn));
              ti[e] = __fadd_rn(__fmul_rn(ar[e], sn), __fmul_rn(ai[e], c));
            }
            const int o = t_at(s * KC + 4 * rg + i, m, n2);
            *reinterpret_cast<float2*>(sT + 0 * F32_TP + o) = make_float2(tr[0], tr[2]);
            *reinterpret_cast<float2*>(sT + 1 * F32_TP + o) = make_float2(ti[0], ti[2]);
            *reinterpret_cast<float2*>(sT + 2 * F32_TP + o) = make_float2(tr[1], tr[3]);
            *reinterpret_cast<float2*>(sT + 3 * F32_TP + o) = make_float2(ti[1], ti[3]);
          }
        }
      }
    } else {
      const int l = cc.local - nA, half = l >= p.n_ktb, kidx = l - half * p.n_ktb;
      if (kidx == 0) {
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      }
      const int ktb = p.ktb;
      for (int k4 = 0; k4 < ktb; k4 += 4) {
        // Two T rows x four n2 of each plane, then four n2 steps.
        const int nn = kidx * ktb + k4;
        float4 t4[4][2];  // [plane][row]
#pragma unroll
        for (int pl = 0; pl < 4; ++pl) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            t4[pl][c] = *reinterpret_cast<const float4*>(sT + pl * F32_TP +
                                                         t_at(2 * qb + c, nn, n2));
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float* row = slot + (k4 + u) * n2;
          const float4 dc = *reinterpret_cast<const float4*>(row + 4 * rb);
          const float4 ds = *reinterpret_cast<const float4*>(row + h + 4 * rb);
          const float cv[4] = {dc.x, dc.y, dc.z, dc.w}, sv[4] = {ds.x, ds.y, ds.z, ds.w};
          float tv[4][2];  // [plane][row] at n2 = nn + u
#pragma unroll
          for (int pl = 0; pl < 4; ++pl) {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const float4 v = t4[pl][c];
              tv[pl][c] = u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
            }
          }
#pragma unroll
          for (int q = 0; q < 2; ++q) {
#pragma unroll
            for (int a = 0; a < 4; ++a) {
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                const float tr = tv[2 * q][c], ti = tv[2 * q + 1][c];
                acc[b_acc(q, 0, a, c)] = fmaf(cv[a], tr, acc[b_acc(q, 0, a, c)]);
                acc[b_acc(q, 1, a, c)] = fmaf(sv[a], ti, acc[b_acc(q, 1, a, c)]);
                acc[b_acc(q, 2, a, c)] = fmaf(cv[a], ti, acc[b_acc(q, 2, a, c)]);
                acc[b_acc(q, 3, a, c)] = fmaf(sv[a], tr, acc[b_acc(q, 3, a, c)]);
              }
            }
          }
        }
      }
      if (kidx == p.n_ktb - 1) {
        // Each stream's re = cos.tr - (-sin.ti), im = cos.ti + (-sin.tr); X =
        // E + exp(-iπk/N)·O; rotate; requant; two consecutive channels
        // k2*N1 + k1.. of spectrum s.
        const int row = 2 * qb, s = cc.s0 + row / KC, k1 = k0 + (row & (KC - 1));
        if (s < p.n_spectra) {
          const long long obase = (static_cast<long long>(cc.b) * p.n_spectra + s) * n;
          const float* rc_b = p.rotc + static_cast<long long>(cc.b) * n;
          const float* rs_b = p.rots + static_cast<long long>(cc.b) * n;
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const int ch = (half * h + 4 * rb + a) * n1 + k1;
            const float2 uc = __ldg(reinterpret_cast<const float2*>(p.untc + ch));
            const float2 us = __ldg(reinterpret_cast<const float2*>(p.unts + ch));
            const float2 rc = __ldg(reinterpret_cast<const float2*>(rc_b + ch));
            const float2 rs = __ldg(reinterpret_cast<const float2*>(rs_b + ch));
            int8_t v[2][2];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const float er = __fsub_rn(acc[b_acc(0, 0, a, c)], acc[b_acc(0, 1, a, c)]);
              const float ei = __fadd_rn(acc[b_acc(0, 2, a, c)], acc[b_acc(0, 3, a, c)]);
              const float orr = __fsub_rn(acc[b_acc(1, 0, a, c)], acc[b_acc(1, 1, a, c)]);
              const float oi = __fadd_rn(acc[b_acc(1, 2, a, c)], acc[b_acc(1, 3, a, c)]);
              const float u_c = c ? uc.y : uc.x, u_s = c ? us.y : us.x;
              const float r_c = c ? rc.y : rc.x, r_s = c ? rs.y : rs.x;
              const float xr = __fsub_rn(__fadd_rn(er, __fmul_rn(u_c, orr)), __fmul_rn(u_s, oi));
              const float xi = __fadd_rn(__fadd_rn(ei, __fmul_rn(u_c, oi)), __fmul_rn(u_s, orr));
              v[0][c] = requant(__fsub_rn(__fmul_rn(xr, r_c), __fmul_rn(xi, r_s)));
              v[1][c] = requant(__fadd_rn(__fmul_rn(xr, r_s), __fmul_rn(xi, r_c)));
            }
            *reinterpret_cast<char2*>(p.outr + obase + ch) = make_char2(v[0][0], v[0][1]);
            *reinterpret_cast<char2*>(p.outi + obase + ch) = make_char2(v[1][0], v[1][1]);
          }
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The plan of a chunk of KC rows, 0 if it has none: SB = NCOL / 2N2 spectra
// a unit, stage-B tiles of at most one slot's 8192 floats, the 4-slot ring
// beside the T planes.
template <int KC>
size_t f32_plan(F32Params& p) {
  constexpr int NCOL = F32_OUT / KC;
  if (p.n1 < 16 || KC > p.n1 || 2 * p.n2 > NCOL || p.n2 < 64) return 0;
  p.sb = NCOL / (2 * p.n2);
  p.ktb = min(p.n2, F32_SLOT / p.n2);
  p.n_kta = p.n1 / KC;
  p.n_ktb = p.n2 / p.ktb;
  p.n_chunks = p.n1 / KC;
  p.n_sblk = (p.n_spectra + p.sb - 1) / p.sb;
  return f32_smem_bytes<KC>();
}

template <int KC>
cudaError_t launch_dft_f32(F32Params p, int batch, size_t bytes, cudaStream_t stream) {
  auto kern = dit_dft_f32_kernel<KC>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
    return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, F32_THREADS, bytes);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long units = static_cast<long long>(batch) * p.n_sblk * p.n_chunks;
  const long long resident = static_cast<long long>(sms) * per_sm;
  const int grid = static_cast<int>(units < resident ? units : resident);
  const long long tpu = p.n_kta + 2LL * p.n_ktb;
  if (units > 0x7fffffffLL - grid || ((units + grid - 1) / grid) * tpu > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  p.n_units = static_cast<int>(units);
  kern<<<grid, F32_THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

// Run f(kc, plan, bytes) with the chunk the f32 pass takes for this split
// (16 rows up to N2 = 256, 8 at N2 = 512), or return NO_PLAN.
template <typename F>
int with_f32_plan(const F32Params& p, F&& f) {
  F32Params q = p;
  size_t bytes;
  if ((bytes = f32_plan<16>(q))) return f(std::integral_constant<int, 16>{}, q, bytes);
  q = p;
  if ((bytes = f32_plan<8>(q))) return f(std::integral_constant<int, 8>{}, q, bytes);
  return NO_PLAN;
}

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

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

// The two-pass body's DFT pass: plane [batch, n_spectra, fft] bf16 (K1's FIR
// pass output, fft = 2·N1·N2) -> outputs [batch, n_spectra, N] int8. d1c,
// d1s, d2c, d2s are the bf16 DFT matrices, twc/tws the f32 twiddles
// [N1, N2], untc/unts the f32 combine factors [N2, N1], rotc/rots [batch, N].
// Returns -1 where no chunk's plan fits shared memory.
extern "C" int dit_dft_launch(const void* plane, const void* d1c, const void* d1s,
                              const void* d2c, const void* d2s, const void* twc, const void* tws,
                              const void* untc, const void* unts, const void* rotc,
                              const void* rots, void* outr, void* outi, int batch,
                              int n_spectra, int n1, int n2, void* stream) {
  if (n1 < 16 || !pow2(n1) || n2 < 16 || !pow2(n2) || batch < 1 || n_spectra < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DftParams p{};
  p.plane = static_cast<const bf16*>(plane);
  p.d1c = static_cast<const bf16*>(d1c);
  p.d1s = static_cast<const bf16*>(d1s);
  p.d2c = static_cast<const bf16*>(d2c);
  p.d2s = static_cast<const bf16*>(d2s);
  p.twc = static_cast<const float*>(twc);
  p.tws = static_cast<const float*>(tws);
  p.untc = static_cast<const float*>(untc);
  p.unts = static_cast<const float*>(unts);
  p.rotc = static_cast<const float*>(rotc);
  p.rots = static_cast<const float*>(rots);
  p.outr = static_cast<int8_t*>(outr);
  p.outi = static_cast<int8_t*>(outi);
  p.n_spectra = n_spectra;
  p.n1 = n1;
  p.n2 = n2;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_plan(p, [&](auto kc, const DftParams& q, size_t bytes) {
    constexpr int K = decltype(kc)::value;
    const cudaError_t err = n1 <= CHAIN_N1 ? launch_dft<K, true>(q, batch, bytes, st)
                                           : launch_dft<K, false>(q, batch, bytes, st);
    return static_cast<int>(err);
  });
}

// What the DFT pass's body at N1 x N2 is: out[0] registers a thread, out[1]
// local (spill) bytes a thread, out[2] KC, out[3] the K-tile depth, out[4]
// ring stages, out[5] dynamic shared-memory bytes. Returns -1 where no plan
// fits.
extern "C" int dit_dft_attributes(int n1, int n2, void* out) {
  if (n1 < 16 || !pow2(n1) || n2 < 16 || !pow2(n2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DftParams p{};
  p.n1 = n1;
  p.n2 = n2;
  int* o = static_cast<int*>(out);
  return with_plan(p, [&](auto kc, const DftParams& q, size_t bytes) {
    cudaFuncAttributes a{};
    constexpr int K = decltype(kc)::value;
    const cudaError_t err = n1 <= CHAIN_N1 ? cudaFuncGetAttributes(&a, dit_dft_kernel<K, true>)
                                           : cudaFuncGetAttributes(&a, dit_dft_kernel<K, false>);
    if (err != cudaSuccess) return static_cast<int>(err);
    o[0] = a.numRegs;
    o[1] = static_cast<int>(a.localSizeBytes);
    o[2] = decltype(kc)::value;
    o[3] = q.kt;
    o[4] = q.stages;
    o[5] = static_cast<int>(bytes);
    return 0;
  });
}

// The DFT pass cut at a stage (stop 1 stagea, 2 stageb; see DFT_STAGEA): the
// arguments of dit_dft_launch without the combine factors and rotation
// planes, int8 outputs [batch, n_spectra, N]. The stops take the 64-row
// chunk plan with chained stage-A sums only (64 <= N1 <= 256, N2 <= 256);
// -1 elsewhere.
extern "C" int dit_dft_stop_launch(const void* plane, const void* d1c, const void* d1s,
                                   const void* d2c, const void* d2s, const void* twc,
                                   const void* tws, void* outr, void* outi, int batch,
                                   int n_spectra, int n1, int n2, int stop, void* stream) {
  if (n1 < 16 || !pow2(n1) || n2 < 16 || !pow2(n2) || batch < 1 || n_spectra < 1 ||
      (stop != DFT_STAGEA && stop != DFT_STAGEB)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DftParams p{};
  p.plane = static_cast<const bf16*>(plane);
  p.d1c = static_cast<const bf16*>(d1c);
  p.d1s = static_cast<const bf16*>(d1s);
  p.d2c = static_cast<const bf16*>(d2c);
  p.d2s = static_cast<const bf16*>(d2s);
  p.twc = static_cast<const float*>(twc);
  p.tws = static_cast<const float*>(tws);
  p.outr = static_cast<int8_t*>(outr);
  p.outi = static_cast<int8_t*>(outi);
  p.n_spectra = n_spectra;
  p.n1 = n1;
  p.n2 = n2;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_plan(p, [&](auto kc, const DftParams& q, size_t bytes) {
    if constexpr (decltype(kc)::value != 64) {
      return NO_PLAN;
    } else {
      if (n1 > CHAIN_N1) return NO_PLAN;
      const cudaError_t err = stop == DFT_STAGEA
                                  ? launch_dft<64, true, DFT_STAGEA>(q, batch, bytes, st)
                                  : launch_dft<64, true, DFT_STAGEB>(q, batch, bytes, st);
      return static_cast<int>(err);
    }
  });
}

// The f32 two-pass body's DFT pass: plane [batch, n_spectra, fft] f32 (K1's
// f32 FIR pass output, fft = 2·N1·N2; 16-byte aligned) -> outputs [batch,
// n_spectra, N] int8. d1c, d1s are the f32 N1-point matrices, d2h the f32
// N2-point matrix in two halves of k2, each transposed ([2][n2][cos, then
// -sin]), twc/tws the f32 twiddles [N1, N2], untc/unts the f32 combine
// factors [N2, N1], rotc/rots [batch, N] (8-byte aligned). Returns -1 where
// the pass has no plan (N1 < 16, N2 < 64 or N2 > 512): those shapes take
// fengine_dit_launch.
extern "C" int dit_dft_f32_launch(const void* plane, const void* d1c, const void* d1s,
                                  const void* d2h, const void* twc, const void* tws,
                                  const void* untc, const void* unts, const void* rotc,
                                  const void* rots, void* outr, void* outi, int batch,
                                  int n_spectra, int n1, int n2, void* stream) {
  if (n1 < 2 || !pow2(n1) || n2 < 4 || !pow2(n2) || batch < 1 || n_spectra < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  F32Params p{};
  p.plane = static_cast<const float*>(plane);
  p.d1c = static_cast<const float*>(d1c);
  p.d1s = static_cast<const float*>(d1s);
  p.d2h = static_cast<const float*>(d2h);
  p.twc = static_cast<const float*>(twc);
  p.tws = static_cast<const float*>(tws);
  p.untc = static_cast<const float*>(untc);
  p.unts = static_cast<const float*>(unts);
  p.rotc = static_cast<const float*>(rotc);
  p.rots = static_cast<const float*>(rots);
  p.outr = static_cast<int8_t*>(outr);
  p.outi = static_cast<int8_t*>(outi);
  p.n_spectra = n_spectra;
  p.n1 = n1;
  p.n2 = n2;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_f32_plan(p, [&](auto kc, const F32Params& q, size_t bytes) {
    return static_cast<int>(launch_dft_f32<decltype(kc)::value>(q, batch, bytes, st));
  });
}

// The f32 DFT pass's plan and body at N1 x N2, -1 where it has none (the
// shape then takes the SIMT body): out int[8] = registers a thread, local
// (spill) bytes a thread, KC, SB, stage-B K-tile depth, ring stages,
// shared-memory bytes, threads a block.
extern "C" int dit_dft_f32_attributes(int n1, int n2, void* out) {
  if (n1 < 2 || !pow2(n1) || n2 < 4 || !pow2(n2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  F32Params p{};
  p.n_spectra = 1;
  p.n1 = n1;
  p.n2 = n2;
  int* o = static_cast<int*>(out);
  return with_f32_plan(p, [&](auto kc, const F32Params& q, size_t bytes) {
    constexpr int K = decltype(kc)::value;
    cudaFuncAttributes a{};
    const cudaError_t err = cudaFuncGetAttributes(&a, dit_dft_f32_kernel<K>);
    if (err != cudaSuccess) return static_cast<int>(err);
    o[0] = a.numRegs;
    o[1] = static_cast<int>(a.localSizeBytes);
    o[2] = K;
    o[3] = q.sb;
    o[4] = q.ktb;
    o[5] = F32_STAGES;
    o[6] = static_cast<int>(bytes);
    o[7] = F32_THREADS;
    return 0;
  });
}
