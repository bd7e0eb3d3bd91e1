// K1: fused F-engine for Hopper (sm_90a) — FIR + two-stage Cooley–Tukey real
// DFT + fine-delay rotation + int8 requant, int8 in / int8 out (or, without
// the requant, f32 out: the QUANT=false epilogue of every body).
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
// What is NOT carried over: the scalar-prefetch DMA and the u32-bitcast
// _align_tile rotate are Mosaic mechanics. Here the coarse delay is a
// per-batch pointer offset (starts[b], clamped by the wrapper so every read
// stays inside the stream). What IS carried over is what the TPU kernel kept
// out of HBM and L2: the window read once per run of spectra and each input
// frame once (its rolling FIR ring), and the DFT matrices amortised over
// many spectra (its batch_a stage A).
//
// Design: bf16 DFT operands with N1 >= 16 (every engine launch) run as two
// passes, launched by the wrapper over groups of batches whose bf16 FIR
// planes fit its scratch (about 1 GB: 32 flagship streams).
//
// 1. k1_fir_kernel — the FIR, K6's register ring (csrc/pfb_fir.cu) on K1's
//    inputs: a block owns 512 lanes of the frame and a run of RUN spectra of
//    one stream; each thread keeps its 4 lanes' taps of the window in
//    registers and a ring of the last MAXT frame rows, so each window value
//    is read once per run and each input byte about once. The stream starts
//    at starts[b], which may be unaligned (byte loads then). It writes the
//    FIR rounded to bf16 straight into the [B, S, N1, N2] plane (the in-frame
//    index is the plane index), bit for bit __float2bfloat16_rn of the f32
//    tap-order sum. Bound by bytes: 2.84 GB in, 5.37 GB out at the flagship.
// 2. k1_dft_kernel — both DFT stages on the tensor cores (mma.sync
//    m16n8k16 bf16, f32 accumulate) fed from shared memory by a cp.async
//    ring of 4 stages (3 where 4 do not fit). A unit of work is (batch,
//    spectrum, chunk of KC k1 rows); persistent blocks (one per SM: 16
//    warps) walk units in order, and the ring streams one tile sequence
//    through every unit:
//      stage A tiles: [KT x NA] of the plane with the [KC x KT] cos and -sin
//        rows of the N1-point matrix; the accumulators [KC x NA] x {cos, sin}
//        get the f32 twiddle and land in shared memory as bf16 T planes
//        [KC x N2] (re, im);
//      stage B tiles: [MB x KT] of the N2-point matrix's cos and -sin rows;
//        four products (cos.tr, -sin.ti, cos.ti, -sin.tr) over n2, then
//        re = cos.tr - (-sin.ti), im = cos.ti + (-sin.tr), the rotation and
//        the requant straight to the outputs.
//    The T planes are the only per-unit state, so KC follows N2 (64 rows up
//    to N2 = 256, 32 at 512 and 1024, 16 beyond): no plan needs a whole plane
//    in shared memory, which lifts the old cap at fft 65536. Both stages keep
//    64 f32 accumulators a thread (one register array, reused), so the
//    block's tile is KC x 256..512 in stage A and 128..512 x KC in stage B.
//    KT is the deepest of 64, 32, 16 that fits: fewer barriers a unit.
//    Stage A adds each MMA's 16-product sum to its accumulator in f32
//    round-to-nearest (mma16816_rn) rather than chaining the MMAs: chained,
//    the tensor core's rounding of the running sum drifts with N1 and flips
//    enough bf16 roundings of T at fft 2^20 (N1 = 1024) to miss the gate of
//    1 code on 1e-3 of the samples; added, the kernel flips about as many
//    codes as two plain f32 orders do against each other. It costs a few
//    percent of the pass. Stage B stays chained: its sums end in int8
//    codes, and adding them the same way moved no share.
//
// What bounds it on the card. The split's floor is 8.0 ms at the flagship:
// the FIR pass's bytes (2.84 GB in, 5.37 GB out: 2.45 ms) and the DFT's 5.5
// TFLOP of bf16 (5.56 ms). The FIR pass runs at about a fifth of its floor,
// as K6 does; what holds it back is open (PERF.md). The DFT pass runs at
// about a sixth of its floor, far from the HBM rate and the bf16 peak
// alike. By its design's count each unit pulls ~0.5 MB through L2 (the
// plane's rows once per chunk, so 4 times a spectrum at the flagship; the
// chunk's DFT rows; the whole N2-point matrix; the chunk's f32 twiddles and
// rotation values, which the epilogues read with every warp waiting), 84 GB
// a flagship step, and its 16 warps each load their own mma.sync
// fragments, so shared-memory reads compete with the MMAs. wgmma, which
// reads its operands from shared memory once a warpgroup, TMA tiles, and a
// cluster that multicasts the plane and the N2-point matrix to the chunks
// of one spectrum are the next steps.
//
// f32 DFT operands, and N1 = 8 where a 16-row MMA tile does not fit, take
// fengine_ct_kernel: one block per (spectrum, batch), SIMT FMA on register
// micro-tiles, k1 walked in chunks of kc rows (kc shrinks with N2 so the
// T planes fit); in f32 mode each stage-A K tile recomputes its [KTA, NTA]
// slice of the FIR from global memory.
//
// Stage stops (the probes P5 and P4: benchmarks/ct_ablate.py and
// benchmarks/dma_bisect.py of the JAX package, the trimmed copies of
// _fengine_kernel_ct reached through pl.pallas_call at ct_ablate.py:147 and
// dma_bisect.py:113). A compile-time STOP cuts the two passes after a stage,
// so the production instantiations (STOP_NONE) are the code above unchanged:
//   STOP_DMA    — the FIR pass's loads only, each input byte once; the
//                 probe (frame s - s % 16's first fft/2 samples) to both
//                 outputs;
//   STOP_FIR    — the FIR pass, its bf16 plane written as always, and the
//                 f32 sums' first and second fft/2 samples to outr, outi;
//   STOP_STAGEA — the DFT pass up to the twiddle, no stage B: T re / im of
//                 rows k1 < N1/2 to outr / outi at k1*N2 + n2;
//   STOP_STAGEB — the DFT pass up to stage B, no rotation: re / im.
// Every stop writes int8 by truncation with saturation (trunc_s8), as
// XLA's f32 -> int8 conversion does in the probe. Their entry points are in
// csrc/fengine_ct_stops.cu, which compiles in its own nvcc process.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr size_t MAX_SMEM = 232448;  // what one block may use on sm_90
constexpr int NO_PLAN = -1;          // returned when no shared-memory plan fits

__device__ __forceinline__ int8_t requant(float v) {
  v = fminf(fmaxf(rintf(v), -127.f), 127.f);
  return static_cast<int8_t>(v);
}

// The stage stops (see the head of the file); the launch functions take them
// as these numbers.
constexpr int STOP_NONE = 0, STOP_DMA = 1, STOP_FIR = 2, STOP_STAGEA = 3, STOP_STAGEB = 4;
// Spectra a DMA-stop probe serves: P5's s_blk.
constexpr int ABLATE_S_BLK = 16;

// int8 by truncation toward zero, saturated: the value cvt.rzi.sat.s8.f32
// gives.
__device__ __forceinline__ int8_t trunc_s8(float v) {
  return static_cast<int8_t>(max(-128, min(127, __float2int_rz(v))));
}

// ---------------------------------------------------------------------------
// SIMT body (f32 DFT operands, or bf16 with N1 = 8)
// ---------------------------------------------------------------------------
constexpr int THREADS = 256;
constexpr int KC = 32;   // most k1 rows per chunk (capped at N1; shrinks with N2)
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
  int n_spectra, n_taps, n1, n2, kc;
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

// The epilogue of one output: the fine-delay rotation, then the int8 requant
// (QUANT) or the rotated f32 values.
template <bool QUANT>
__device__ __forceinline__ void store_rotated(void* outr, void* outi, long long o, float re,
                                              float im, float rc, float rs) {
  const float vr = __fsub_rn(__fmul_rn(re, rc), __fmul_rn(im, rs));
  const float vi = __fadd_rn(__fmul_rn(re, rs), __fmul_rn(im, rc));
  if constexpr (QUANT) {
    static_cast<int8_t*>(outr)[o] = requant(vr);
    static_cast<int8_t*>(outi)[o] = requant(vi);
  } else {
    static_cast<float*>(outr)[o] = vr;
    static_cast<float*>(outi)[o] = vi;
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
  const int kc = p.kc;
  const int kta = min(KTA, n1);
  const int ts = n2 + 1;  // odd row stride of sT: conflict-free column reads

  const int8_t* xs = p.x + static_cast<long long>(b) * p.batch_stride +
                     p.starts[b] + static_cast<long long>(s) * fft;

  float* sAc = reinterpret_cast<float*>(smem);  // [kc][KTA]
  float* sAs = sAc + kc * KTA;                  // [kc][KTA]
  float* sBc = sAs + kc * KTA;                  // [MTB][KTB]
  float* sBs = sBc + MTB * KTB;                 // [MTB][KTB]
  float* sXt = sBs + MTB * KTB;                 // f32 mode: [KTA][NTA]
  OpT* sTr = reinterpret_cast<OpT*>(sXt + (BF16 ? 0 : KTA * NTA));  // [kc][ts]
  OpT* sTi = sTr + kc * ts;
  // bf16 mode: the whole FIR plane [N1][N2], 16-byte aligned after sT.
  const size_t t_bytes = 2 * kc * ts * sizeof(OpT);
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
            store_rotated<QUANT>(p.outr, p.outi, obase + ch, re, im, rc, rs);
          }
        }
      }
    }
    __syncthreads();  // the next chunk overwrites sT
  }
}

size_t smem_bytes(bool bf16, int n1, int n2, int kc) {
  const size_t ts = n2 + 1;
  size_t bytes = sizeof(float) * (2 * kc * KTA + 2 * MTB * KTB);
  if (bf16) {
    bytes += (2 * kc * ts * sizeof(__nv_bfloat16) + 15) & ~size_t(15);
    bytes += static_cast<size_t>(n1) * n2 * sizeof(__nv_bfloat16);
  } else {
    bytes += sizeof(float) * KTA * NTA;
    bytes += 2 * kc * ts * sizeof(float);
  }
  return bytes;
}

template <bool BF16, bool QUANT>
cudaError_t launch(const Params& p, int batch, size_t bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fengine_ct_kernel<BF16, QUANT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  dim3 grid(p.n_spectra, batch);
  fengine_ct_kernel<BF16, QUANT><<<grid, THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Pass 1: the FIR into the bf16 plane
// ---------------------------------------------------------------------------
constexpr int FIR_THREADS = 128;  // 4 lanes each: 512 lanes per block
constexpr int RUN = 128;          // spectra per block

struct FirParams {
  const int8_t* x;  // [G, batch_stride]; stream b starts at starts[b]
  long long batch_stride;
  const long long* starts;
  const float* win;       // [taps, fft]
  __nv_bfloat16* plane;   // [G, S, fft]
  int n_spectra, fft, n_taps, lane_blocks, runs;
  int8_t* outr;  // the stops' outputs [G, S, fft/2] (unused by K1 itself)
  int8_t* outi;
};

template <bool VEC>
__device__ __forceinline__ float4 load4(const int8_t* p) {
  if constexpr (VEC) {
    const char4 v = __ldg(reinterpret_cast<const char4*>(p));
    return make_float4(v.x, v.y, v.z, v.w);
  } else {
    return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
  }
}

__device__ __forceinline__ float4 mul4(float4 x, float4 w) {
  return make_float4(__fmul_rn(x.x, w.x), __fmul_rn(x.y, w.y), __fmul_rn(x.z, w.z),
                     __fmul_rn(x.w, w.w));
}

// acc + x*w, the product rounded before the sum.
__device__ __forceinline__ float4 mac4(float4 acc, float4 x, float4 w) {
  const float4 q = mul4(x, w);
  return make_float4(__fadd_rn(acc.x, q.x), __fadd_rn(acc.y, q.y), __fadd_rn(acc.z, q.z),
                     __fadd_rn(acc.w, q.w));
}

__device__ __forceinline__ void store_bf16x4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// The FIR stop's int8 of 4 f32 sums, by truncation (4-byte aligned).
__device__ __forceinline__ void store_trunc4(int8_t* p, float4 v) {
  *reinterpret_cast<char4*>(p) = make_char4(trunc_s8(v.x), trunc_s8(v.y), trunc_s8(v.z),
                                            trunc_s8(v.w));
}

// One thread's 4 lanes over spectra [s0, s1). MAXT > 0: the register ring
// of the last MAXT rows (rows past the stream's last read as zero, unused);
// MAXT = 0: every tap row from global memory (taps > 16). STOP_FIR also
// writes the truncated sums to oq (the lanes' place in outr or outi).
template <int MAXT, bool VEC, int STOP>
__device__ __forceinline__ void fir_run(const FirParams& a, const int8_t* xb,
                                        __nv_bfloat16* ob, int8_t* oq, int lane, int s0,
                                        int s1) {
  const long long fft = a.fft;
  const int rows = a.n_spectra + a.n_taps - 1;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  if constexpr (MAXT == 0) {
    for (int s = s0; s < s1; ++s) {
      float4 acc = mul4(load4<VEC>(xb + s * fft),
                        __ldg(reinterpret_cast<const float4*>(a.win + lane)));
      for (int t = 1; t < a.n_taps; ++t) {
        acc = mac4(acc, load4<VEC>(xb + (s + t) * fft),
                   __ldg(reinterpret_cast<const float4*>(a.win + t * fft + lane)));
      }
      store_bf16x4(ob + s * fft, acc);
      if constexpr (STOP == STOP_FIR) store_trunc4(oq + s * (fft / 2), acc);
    }
  } else {
    float4 w[MAXT];
#pragma unroll
    for (int t = 0; t < MAXT; ++t) {
      w[t] = t < a.n_taps ? __ldg(reinterpret_cast<const float4*>(a.win + t * fft + lane))
                          : zero;
    }
    // Row s0 + j lives in slot j % MAXT; at output s the ring holds rows
    // s .. s + MAXT - 1.
    float4 ring[MAXT];
#pragma unroll
    for (int j = 0; j < MAXT - 1; ++j) {
      const int r = s0 + j;
      ring[j] = r < rows ? load4<VEC>(xb + r * fft) : zero;
    }
    for (int s = s0; s < s1; s += MAXT) {
#pragma unroll
      for (int j = 0; j < MAXT; ++j) {
        if (s + j < s1) {
          const int r = s + j + MAXT - 1;
          ring[(j + MAXT - 1) % MAXT] = r < rows ? load4<VEC>(xb + r * fft) : zero;
          float4 acc = mul4(ring[j], w[0]);
#pragma unroll
          for (int t = 1; t < MAXT; ++t) {
            if (t < a.n_taps) acc = mac4(acc, ring[(j + t) % MAXT], w[t]);
          }
          store_bf16x4(ob + (s + j) * fft, acc);
          if constexpr (STOP == STOP_FIR) store_trunc4(oq + (s + j) * (fft / 2), acc);
        }
      }
    }
  }
}

// 4 raw input bytes as one word.
template <bool VEC>
__device__ __forceinline__ uint32_t load_word(const int8_t* p) {
  if constexpr (VEC) {
    return __ldg(reinterpret_cast<const unsigned int*>(p));
  } else {
    return static_cast<uint32_t>(static_cast<uint8_t>(__ldg(p))) |
           static_cast<uint32_t>(static_cast<uint8_t>(__ldg(p + 1))) << 8 |
           static_cast<uint32_t>(static_cast<uint8_t>(__ldg(p + 2))) << 16 |
           static_cast<uint32_t>(static_cast<uint8_t>(__ldg(p + 3))) << 24;
  }
}

// The DMA stop over spectra [s0, s1): each row the ring would load, loaded
// once, and at every 16th frame the probe: that frame's bytes in the first
// fft/2 lanes go to both outputs of its 16 spectra (oq_r, oq_i: the lanes'
// place, null past fft/2). The loads' XOR is stored under a condition that
// never holds but that the compiler cannot see through (n_spectra < 0), so
// no load is dropped.
template <bool VEC>
__device__ __forceinline__ void dma_run(const FirParams& a, const int8_t* xb, int8_t* oq_r,
                                        int8_t* oq_i, int s0, int s1) {
  const long long fft = a.fft, half = fft / 2;
  const int last = min(a.n_spectra + a.n_taps - 1, s1 + a.n_taps - 1);
  uint32_t seen = 0;
  for (int r = s0; r < last; ++r) {
    const uint32_t v = load_word<VEC>(xb + r * fft);
    seen ^= v;
    if (oq_r != nullptr && r < s1 && r % ABLATE_S_BLK == 0) {
      for (int s = r; s < min(s1, r + ABLATE_S_BLK); ++s) {
        *reinterpret_cast<uint32_t*>(oq_r + s * half) = v;
        *reinterpret_cast<uint32_t*>(oq_i + s * half) = v;
      }
    }
  }
  if (a.n_spectra < 0) *reinterpret_cast<uint32_t*>(a.outr) = seen;
}

template <int MAXT, int STOP = STOP_NONE>
__global__ void __launch_bounds__(FIR_THREADS) k1_fir_kernel(FirParams a) {
  long long bid = blockIdx.x;
  const int lb = static_cast<int>(bid % a.lane_blocks);
  bid /= a.lane_blocks;
  const int run = static_cast<int>(bid % a.runs);
  const long long b = bid / a.runs;
  const int lane = (lb * FIR_THREADS + static_cast<int>(threadIdx.x)) * 4;
  if (lane >= a.fft) return;
  const int s0 = run * RUN, s1 = min(a.n_spectra, s0 + RUN);
  const int8_t* xb = a.x + b * a.batch_stride + a.starts[b] + lane;
  __nv_bfloat16* ob = a.plane + b * a.n_spectra * static_cast<long long>(a.fft) + lane;
  // lane % 4 == 0, so the stream's start decides alignment for the whole block.
  const bool vec = (reinterpret_cast<uintptr_t>(xb) & 3) == 0;
  int8_t* oq = nullptr;
  if constexpr (STOP != STOP_NONE) {
    const int half = a.fft / 2;
    const long long o = b * a.n_spectra * static_cast<long long>(half);
    oq = lane < half ? a.outr + o + lane : a.outi + o + lane - half;
    if constexpr (STOP == STOP_DMA) {
      int8_t* oi = lane < half ? a.outi + o + lane : nullptr;
      if (lane >= half) oq = nullptr;
      if (vec) {
        dma_run<true>(a, xb, oq, oi, s0, s1);
      } else {
        dma_run<false>(a, xb, oq, oi, s0, s1);
      }
      return;
    }
  }
  if (vec) {
    fir_run<MAXT, true, STOP>(a, xb, ob, oq, lane, s0, s1);
  } else {
    fir_run<MAXT, false, STOP>(a, xb, ob, oq, lane, s0, s1);
  }
}

// ---------------------------------------------------------------------------
// Pass 2: the DFT on the tensor cores
// ---------------------------------------------------------------------------
constexpr int DFT_THREADS = 512;  // 16 warps: one block an SM
constexpr int DFT_WARPS = DFT_THREADS / 32;
constexpr int PAD = 8;            // row padding (elements): conflict-free smem reads

using bf16 = __nv_bfloat16;

struct DftParams {
  const bf16* plane;  // [G, S, N1, N2]
  const bf16* d1c;    // [N1, N1] cos
  const bf16* d1s;    // [N1, N1] -sin
  const bf16* d2;     // [N2, N2]: cos rows k2 < N2/2, then -sin rows
  const float* twc;   // [N1, N2]
  const float* tws;
  const float* rotc;  // [G, C]
  const float* rots;
  void* outr;         // [G, S, C] int8, or f32 without the requant
  void* outi;
  int n_spectra, n1, n2;
  int kt, ktb;                  // stage-A / stage-B K-tile depths
  int n_ca, n_kta, n_rb, n_ktb;  // column tiles x K tiles, row tiles x K tiles
  int n_chunks;
  int n_units;                  // G * S * n_chunks
  int slot;                     // bf16 elements per ring slot
  int stages;                   // ring depth: 3 or 4
};

// The tile shapes of a KC-row chunk. Stage A: warps MW x NW, each WM k1 rows
// (cos and -sin) x 32 n2 columns: NA columns a tile. Stage B: warps
// (16 / NWB) x NWB, each 32 k2 rows x 16 k1 columns: MB rows a tile.
template <int KC>
struct Shape {
  static constexpr int WM = KC < 32 ? KC : 32;
  static constexpr int MI = WM / 16;
  static constexpr int MW = KC / WM;
  static constexpr int NW = DFT_WARPS / MW;
  static constexpr int NA = 32 * NW;
  static constexpr int NWB = KC / 16;
  static constexpr int MB = 32 * (DFT_WARPS / NWB);
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

// d += a * b, the MMA summing its 16 products alone and the sum added to d
// in f32 round-to-nearest. Chained through the MMA's own accumulator, the
// running sum is rounded by the tensor core's alignment at every step; over
// the N1 products of a stage-A sum that drifts far enough from an f32 sum to
// flip bf16 roundings of T (stage B's sums end in int8 codes, which they do
// not move).
__device__ __forceinline__ void mma16816_rn(float* d, const uint32_t a[4], uint32_t b0,
                                            uint32_t b1) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma16816(t, a, b0, b1);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] = __fadd_rn(d[e], t[e]);
}

// log2 of a power of two.
__device__ __forceinline__ int lg(int v) { return __ffs(v) - 1; }

// A walk through this block's tile sequence: unit i of the block (unit
// blockIdx.x + i * gridDim.x), tile `local` of the unit; the unit's
// (batch, spectrum, chunk) only changes every tpu tiles.
struct Cursor {
  int i, local;
  int b, s, k0;  // k0: the chunk's first k1 row
};

template <int KC>
__device__ __forceinline__ void set_unit(const DftParams& p, Cursor& c) {
  const int u = blockIdx.x + c.i * gridDim.x;
  c.k0 = (u & (p.n_chunks - 1)) * KC;
  const int rest = u >> lg(p.n_chunks);
  c.s = rest % p.n_spectra;
  c.b = rest / p.n_spectra;
}

template <int KC>
__device__ __forceinline__ void advance(const DftParams& p, Cursor& c, int tpu) {
  if (++c.local == tpu) {
    c.local = 0;
    ++c.i;
    set_unit<KC>(p, c);
  }
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

// Issue the cp.async copies of one tile into a ring slot (every thread,
// 16 bytes a copy; rows land padded: conflict-free ldmatrix).
template <int KC>
__device__ __forceinline__ void load_tile(const DftParams& p, const Cursor& c, int nA,
                                          bf16* slot) {
  using S = Shape<KC>;
  const int tid = threadIdx.x;
  const int n1 = p.n1, n2 = p.n2;
  const Tile w = place(p, c.local, nA);
  if (w.stage_a) {
    // [kt x cols] of the plane (cols/8 pieces a row), then the chunk's
    // [KC x kt] cos and -sin rows of the N1-point matrix.
    const int kt = p.kt, ktp = kt + PAD;
    const int lx = lg(min(S::NA, n2) / 8), ld = lg(kt / 8);
    const int nx = kt << lx, nd = KC << ld;
    const bf16* xsrc = p.plane +
                       ((static_cast<long long>(c.b) * p.n_spectra + c.s) * n1 + w.kidx * kt) * n2 +
                       w.outer * S::NA;
    bf16* sd = slot + kt * (S::NA + PAD);
    for (int i = tid; i < nx + 2 * nd; i += DFT_THREADS) {
      if (i < nx) {
        const int r = i >> lx, q = i & ((1 << lx) - 1);
        cp_async16(slot + r * (S::NA + PAD) + q * 8, xsrc + static_cast<long long>(r) * n2 + q * 8);
      } else {
        const int j = i - nx, m = j >= nd, jj = j - m * nd;
        const int r = jj >> ld, q = jj & ((1 << ld) - 1);
        const bf16* src = (m ? p.d1s : p.d1c) + (c.k0 + r) * n1 + w.kidx * kt + q * 8;
        cp_async16(sd + (m * KC + r) * ktp + q * 8, src);
      }
    }
  } else {
    // [rows x ktb] of the N2-point matrix's cos rows, then its -sin rows.
    const int ktb = p.ktb, ktp = ktb + PAD, h = n2 / 2;
    const int ld = lg(ktb / 8), nd = min(S::MB, h) << ld;
    const int r0 = w.outer * S::MB;
    for (int i = tid; i < 2 * nd; i += DFT_THREADS) {
      const int m = i >= nd, j = i - m * nd;
      const int r = j >> ld, q = j & ((1 << ld) - 1);
      const bf16* src = p.d2 + static_cast<long long>(m * h + r0 + r) * n2 + w.kidx * ktb + q * 8;
      cp_async16(slot + (m * S::MB + r) * ktp + q * 8, src);
    }
  }
}

template <int KC, bool QUANT, int STOP = STOP_NONE>
__global__ void __launch_bounds__(DFT_THREADS, 1) k1_dft_kernel(DftParams p) {
  using S = Shape<KC>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int n1 = p.n1, n2 = p.n2, h = n2 / 2, C = n1 * n2 / 2;
  const int tld = n2 + PAD;
  const int stages = p.stages;
  bf16* sTr = smem;  // [KC][N2 + PAD]
  bf16* sTi = sTr + KC * tld;
  bf16* ring = sTi + KC * tld;

  const int nA = p.n_ca * p.n_kta, tpu = nA + p.n_rb * p.n_ktb;
  const int my_units = (p.n_units - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1;
  const int n_tiles = my_units * tpu;

  // Warp placement. Stage A: k1 rows a_r0.., n2 columns a_c0.. of the tile.
  const int a_r0 = (warp / S::NW) * S::WM, a_c0 = (warp % S::NW) * 32;
  // Stage B: k2 rows b_r0.. of the row tile, k1 columns b_c0.. of the chunk.
  const int b_r0 = (warp / S::NWB) * 32, b_c0 = (warp % S::NWB) * 16;

  // One register array for both stages' accumulators (64 f32 a thread).
  // Stage A: [cos/sin][MI][4 n8][4]; stage B: [4 sums][2 m16][2 n8][4],
  // sums cos.tr, -sin.ti, cos.ti, -sin.tr.
  float acc[64];

  Cursor ld{0, 0, 0, 0, 0};  // the next tile to load
  set_unit<KC>(p, ld);
  Cursor cc = ld;  // the tile to compute
  for (int t = 0; t < stages - 1; ++t) {
    if (t < n_tiles) {
      load_tile<KC>(p, ld, nA, ring + t * p.slot);
      advance<KC>(p, ld, tpu);
    }
    cp_async_commit();
  }

  int slot_i = 0;  // tile t's slot, t % stages
  for (int t = 0; t < n_tiles; ++t, advance<KC>(p, cc, tpu)) {
    cp_async_wait_ring(stages);
    __syncthreads();  // tile t landed for every thread; tile t-1's slot is free
    if (t + stages - 1 < n_tiles) {
      const int s_load = slot_i == 0 ? stages - 1 : slot_i - 1;  // (t + stages - 1) % stages
      load_tile<KC>(p, ld, nA, ring + s_load * p.slot);
      advance<KC>(p, ld, tpu);
    }
    cp_async_commit();
    const Tile w = place(p, cc.local, nA);
    const bf16* slot = ring + slot_i * p.slot;
    slot_i = slot_i + 1 == stages ? 0 : slot_i + 1;
    const int k0 = cc.k0;
    if (w.stage_a) {
      const int col = w.outer * S::NA + a_c0;  // first n2 column of the warp
      if (col >= n2) continue;
      if (w.kidx == 0) {
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      }
      const int kt = p.kt, ktp = kt + PAD, xld = S::NA + PAD;
      const bf16* sX = slot;
      const bf16* sAc = slot + kt * xld;
      const bf16* sAs = sAc + KC * ktp;
      for (int kk = 0; kk < kt; kk += 16) {
        uint32_t fa[2][S::MI][4], fb[2][4];
#pragma unroll
        for (int i = 0; i < S::MI; ++i) {
          const int r = a_r0 + i * 16 + lane % 16, c = kk + (lane / 16) * 8;
          ldsm_x4(fa[0][i], sAc + r * ktp + c);
          ldsm_x4(fa[1][i], sAs + r * ktp + c);
        }
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int r = kk + lane % 8 + ((lane / 8) % 2) * 8;
          ldsm_x4_t(fb[jj], sX + r * xld + a_c0 + jj * 16 + (lane / 16) * 8);
        }
#pragma unroll
        for (int m = 0; m < 2; ++m) {
#pragma unroll
          for (int i = 0; i < S::MI; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              mma16816_rn(acc + ((m * S::MI + i) * 4 + j) * 4, fa[m][i],
                          fb[j / 2][(j % 2) * 2], fb[j / 2][(j % 2) * 2 + 1]);
            }
          }
        }
      }
      if (w.kidx == p.n_kta - 1) {
        // f32 twiddle, bf16 rounding, into the T planes. Each 16-row group's
        // twiddles are loaded together first: the L2 round trips overlap.
        // (The STAGEA stop writes P5's rows k1 < N1/2 instead: whole chunks,
        // since its plan's KC = 64 divides N1/2, from one base pointer.)
        int8_t* stop_r = nullptr;
        int8_t* stop_i = nullptr;
        if constexpr (STOP == STOP_STAGEA) {
          if (k0 >= n1 / 2) continue;
          const long long o = (static_cast<long long>(cc.b) * p.n_spectra + cc.s) * C +
                              static_cast<long long>(k0) * n2;
          stop_r = static_cast<int8_t*>(p.outr) + o;
          stop_i = static_cast<int8_t*>(p.outi) + o;
        }
#pragma unroll
        for (int i = 0; i < S::MI; ++i) {
          float2 wc[4][2], ws[4][2];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const long long o = static_cast<long long>(k0 + a_r0 + i * 16 + g + hh * 8) * n2 +
                                  col + j * 8 + tig * 2;
              wc[j][hh] = __ldg(reinterpret_cast<const float2*>(p.twc + o));
              ws[j][hh] = __ldg(reinterpret_cast<const float2*>(p.tws + o));
            }
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int r = a_r0 + i * 16 + g + hh * 8;
              const int n = col + j * 8 + tig * 2;
              const float* cr = acc + ((0 * S::MI + i) * 4 + j) * 4 + hh * 2;
              const float* ci = acc + ((1 * S::MI + i) * 4 + j) * 4 + hh * 2;
              const float2 c = wc[j][hh], sn = ws[j][hh];
              const float tr0 = __fsub_rn(__fmul_rn(cr[0], c.x), __fmul_rn(ci[0], sn.x));
              const float tr1 = __fsub_rn(__fmul_rn(cr[1], c.y), __fmul_rn(ci[1], sn.y));
              const float ti0 = __fadd_rn(__fmul_rn(cr[0], sn.x), __fmul_rn(ci[0], c.x));
              const float ti1 = __fadd_rn(__fmul_rn(cr[1], sn.y), __fmul_rn(ci[1], c.y));
              if constexpr (STOP == STOP_STAGEA) {
                // P5's slice of T: rows k1 < N1/2, at k1*N2 + n2.
                *reinterpret_cast<char2*>(stop_r + r * n2 + n) =
                    make_char2(trunc_s8(tr0), trunc_s8(tr1));
                *reinterpret_cast<char2*>(stop_i + r * n2 + n) =
                    make_char2(trunc_s8(ti0), trunc_s8(ti1));
              } else {
                *reinterpret_cast<__nv_bfloat162*>(sTr + r * tld + n) =
                    __floats2bfloat162_rn(tr0, tr1);
                *reinterpret_cast<__nv_bfloat162*>(sTi + r * tld + n) =
                    __floats2bfloat162_rn(ti0, ti1);
              }
            }
          }
        }
      }
    } else {
      const int row = w.outer * S::MB + b_r0;  // first k2 row of the warp
      if (row >= h) continue;
      if (w.kidx == 0) {
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      }
      const int ktb = p.ktb, ktp = ktb + PAD;
      const bf16* sC = slot;
      const bf16* sS = slot + S::MB * ktp;
      for (int kk = 0; kk < ktb; kk += 16) {
        uint32_t fc[2][4], fs[2][4], ftr[4], fti[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = b_r0 + i * 16 + lane % 16, c = kk + (lane / 16) * 8;
          ldsm_x4(fc[i], sC + r * ktp + c);
          ldsm_x4(fs[i], sS + r * ktp + c);
        }
        {
          const int r = b_c0 + lane % 8 + (lane / 16) * 8;
          const int c = w.kidx * ktb + kk + ((lane / 8) % 2) * 8;
          ldsm_x4(ftr, sTr + r * tld + c);
          ldsm_x4(fti, sTi + r * tld + c);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float* a0 = acc + (i * 2 + j) * 4;
            mma16816(a0 + 0 * 16, fc[i], ftr[2 * j], ftr[2 * j + 1]);
            mma16816(a0 + 1 * 16, fs[i], fti[2 * j], fti[2 * j + 1]);
            mma16816(a0 + 2 * 16, fc[i], fti[2 * j], fti[2 * j + 1]);
            mma16816(a0 + 3 * 16, fs[i], ftr[2 * j], ftr[2 * j + 1]);
          }
        }
      }
      if (STOP == STOP_STAGEB && w.kidx == p.n_ktb - 1) {
        // re, im without the rotation, truncated.
        const long long obase = (static_cast<long long>(cc.b) * p.n_spectra + cc.s) * C;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const float* a0 = acc + (i * 2 + j) * 4 + hh * 2;
              const int ch = (row + i * 16 + g + hh * 8) * n1 + k0 + b_c0 + j * 8 + tig * 2;
              *reinterpret_cast<char2*>(static_cast<int8_t*>(p.outr) + obase + ch) =
                  make_char2(trunc_s8(__fsub_rn(a0[0], a0[16])),
                             trunc_s8(__fsub_rn(a0[1], a0[17])));
              *reinterpret_cast<char2*>(static_cast<int8_t*>(p.outi) + obase + ch) =
                  make_char2(trunc_s8(__fadd_rn(a0[32], a0[48])),
                             trunc_s8(__fadd_rn(a0[33], a0[49])));
            }
          }
        }
      } else if (w.kidx == p.n_ktb - 1) {
        // re = cos.tr - (-sin.ti), im = cos.ti + (-sin.tr); rotate; store.
        // The rotation planes' values are loaded together first.
        const long long obase = (static_cast<long long>(cc.b) * p.n_spectra + cc.s) * C;
        const float* rc_b = p.rotc + static_cast<long long>(cc.b) * C;
        const float* rs_b = p.rots + static_cast<long long>(cc.b) * C;
        float2 rc[2][2][2], rs[2][2][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int ch = (row + i * 16 + g + hh * 8) * n1 + k0 + b_c0 + j * 8 + tig * 2;
              rc[i][j][hh] = __ldg(reinterpret_cast<const float2*>(rc_b + ch));
              rs[i][j][hh] = __ldg(reinterpret_cast<const float2*>(rs_b + ch));
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const float* a0 = acc + (i * 2 + j) * 4 + hh * 2;
              const int ch = (row + i * 16 + g + hh * 8) * n1 + k0 + b_c0 + j * 8 + tig * 2;
              float v[2][2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float re = __fsub_rn(a0[e], a0[16 + e]);
                const float im = __fadd_rn(a0[32 + e], a0[48 + e]);
                const float c = e ? rc[i][j][hh].y : rc[i][j][hh].x;
                const float sn = e ? rs[i][j][hh].y : rs[i][j][hh].x;
                v[0][e] = __fsub_rn(__fmul_rn(re, c), __fmul_rn(im, sn));
                v[1][e] = __fadd_rn(__fmul_rn(re, sn), __fmul_rn(im, c));
              }
              if constexpr (QUANT) {
                *reinterpret_cast<char2*>(static_cast<int8_t*>(p.outr) + obase + ch) =
                    make_char2(requant(v[0][0]), requant(v[0][1]));
                *reinterpret_cast<char2*>(static_cast<int8_t*>(p.outi) + obase + ch) =
                    make_char2(requant(v[1][0]), requant(v[1][1]));
              } else {
                *reinterpret_cast<float2*>(static_cast<float*>(p.outr) + obase + ch) =
                    make_float2(v[0][0], v[0][1]);
                *reinterpret_cast<float2*>(static_cast<float*>(p.outi) + obase + ch) =
                    make_float2(v[1][0], v[1][1]);
              }
            }
          }
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The tile depth, ring depth and bytes of a chunk of KC rows, 0 if it cannot
// fit: the deepest K tiles (64, 32, 16) with 4 stages, else 3, that fit.
// Deeper tiles mean fewer barriers a unit.
template <int KC>
size_t dft_plan(DftParams& p) {
  using S = Shape<KC>;
  if (KC > p.n1) return 0;
  const size_t t_bytes = sizeof(bf16) * 2 * static_cast<size_t>(KC) * (p.n2 + PAD);
  for (int kt = 64; kt >= 16; kt /= 2) {
    if (kt > p.n1) continue;
    const int a_slot = kt * (S::NA + PAD) + 2 * KC * (kt + PAD);
    const int b_slot = 2 * S::MB * (kt + PAD);
    for (int stages = 4; stages >= 3; --stages) {
      const size_t bytes = t_bytes + sizeof(bf16) * static_cast<size_t>(stages) *
                                         static_cast<size_t>(max(a_slot, b_slot));
      if (bytes > MAX_SMEM) continue;
      p.kt = p.ktb = kt;
      p.slot = max(a_slot, b_slot);
      p.stages = stages;
      p.n_ca = (p.n2 + S::NA - 1) / S::NA;
      p.n_kta = p.n1 / kt;
      p.n_rb = (p.n2 / 2 + S::MB - 1) / S::MB;
      p.n_ktb = p.n2 / kt;
      p.n_chunks = p.n1 / KC;
      return bytes;
    }
  }
  return 0;
}

template <int KC, bool QUANT, int STOP = STOP_NONE>
cudaError_t launch_dft(DftParams p, int batch, size_t bytes, cudaStream_t stream) {
  auto kern = k1_dft_kernel<KC, QUANT, STOP>;
  if (STOP == STOP_STAGEA) p.n_rb = 0;  // no stage-B tiles
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

template <bool QUANT, int STOP = STOP_NONE>
int dft_dispatch(DftParams p, int batch, cudaStream_t st) {
  // The largest chunk whose T planes and ring fit (64 rows up to N2 = 256).
  DftParams q = p;
  size_t bytes;
  if ((bytes = dft_plan<64>(q))) {
    return static_cast<int>(launch_dft<64, QUANT, STOP>(q, batch, bytes, st));
  }
  q = p;
  if ((bytes = dft_plan<32>(q))) {
    return static_cast<int>(launch_dft<32, QUANT, STOP>(q, batch, bytes, st));
  }
  q = p;
  if ((bytes = dft_plan<16>(q))) {
    return static_cast<int>(launch_dft<16, QUANT, STOP>(q, batch, bytes, st));
  }
  return NO_PLAN;
}

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

}  // namespace

// K1's own entry points; csrc/fengine_ct_stops.cu includes this file for the
// kernels above and defines K1_STAGE_STOPS, so it compiles the stops alone.
#ifndef K1_STAGE_STOPS

extern "C" const char* dcsand_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The single-pass SIMT body: f32 DFT operands, or bf16 with N1 = 8 (bf16
// with N1 >= 16 is the two-pass form's). quantise = 0 writes f32 outputs
// instead of int8. Returns -1 where no chunk's plan fits shared memory.
extern "C" int fengine_ct_launch(
    const void* x, long long batch_stride, const void* starts,
    const void* win, const void* d1c, const void* d1s, const void* d2,
    const void* twc, const void* tws, const void* rotc, const void* rots,
    void* outr, void* outi, int batch, int n_spectra, int n_taps, int n1,
    int n2, int bf16_ops, int quantise, void* stream) {
  if (n1 < 8 || !pow2(n1) || n2 < 128 || !pow2(n2) || n_spectra < 1 || batch < 1 ||
      batch > 65535 || n_taps < 1 || (bf16_ops && n1 >= 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int kc = n1 < KC ? n1 : KC;
  while (kc > 2 && smem_bytes(bf16_ops, n1, n2, kc) > MAX_SMEM) kc /= 2;
  const size_t bytes = smem_bytes(bf16_ops, n1, n2, kc);
  if (bytes > MAX_SMEM) return NO_PLAN;
  Params p{static_cast<const int8_t*>(x), batch_stride,
           static_cast<const long long*>(starts),
           static_cast<const float*>(win), static_cast<const float*>(d1c),
           static_cast<const float*>(d1s), static_cast<const float*>(d2),
           static_cast<const float*>(twc), static_cast<const float*>(tws),
           static_cast<const float*>(rotc), static_cast<const float*>(rots),
           outr, outi, n_spectra, n_taps, n1, n2, kc};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16_ops) {
    err = quantise ? launch<true, true>(p, batch, bytes, st) : launch<true, false>(p, batch, bytes, st);
  } else {
    err = quantise ? launch<false, true>(p, batch, bytes, st)
                   : launch<false, false>(p, batch, bytes, st);
  }
  return static_cast<int>(err);
}

// Pass 1: x [batch, batch_stride] int8 streams (stream b's window starts at
// starts[b]), win [n_taps, fft] f32 (16-byte aligned) -> plane
// [batch, n_spectra, fft] bf16.
extern "C" int k1_fir_launch(const void* x, long long batch_stride, const void* starts,
                             const void* win, void* plane, int batch, int n_spectra,
                             int n_taps, int fft, void* stream) {
  if (batch < 1 || n_spectra < 1 || n_taps < 1 || fft < 4 || fft % 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FirParams a{static_cast<const int8_t*>(x), batch_stride,
              static_cast<const long long*>(starts), static_cast<const float*>(win),
              static_cast<bf16*>(plane), n_spectra, fft, n_taps,
              (fft + 4 * FIR_THREADS - 1) / (4 * FIR_THREADS), (n_spectra + RUN - 1) / RUN};
  const long long blocks = static_cast<long long>(a.lane_blocks) * a.runs * batch;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (n_taps <= 4) {
    k1_fir_kernel<4><<<grid, FIR_THREADS, 0, st>>>(a);
  } else if (n_taps <= 8) {
    k1_fir_kernel<8><<<grid, FIR_THREADS, 0, st>>>(a);
  } else if (n_taps <= 16) {
    k1_fir_kernel<16><<<grid, FIR_THREADS, 0, st>>>(a);
  } else {
    k1_fir_kernel<0><<<grid, FIR_THREADS, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// Pass 2: plane [batch, n_spectra, N1, N2] bf16 -> outputs [batch,
// n_spectra, C] (int8, or f32 without quantise); d1c/d1s/d2 are the bf16
// DFT matrices, twc/tws the f32 twiddles, rotc/rots [batch, C]. Returns -1
// where no chunk's plan fits shared memory.
extern "C" int k1_dft_launch(const void* plane, const void* d1c, const void* d1s,
                             const void* d2, const void* twc, const void* tws,
                             const void* rotc, const void* rots, void* outr, void* outi,
                             int batch, int n_spectra, int n1, int n2, int quantise,
                             void* stream) {
  if (n1 < 16 || !pow2(n1) || n2 < 128 || !pow2(n2) || batch < 1 || n_spectra < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DftParams p{};
  p.plane = static_cast<const bf16*>(plane);
  p.d1c = static_cast<const bf16*>(d1c);
  p.d1s = static_cast<const bf16*>(d1s);
  p.d2 = static_cast<const bf16*>(d2);
  p.twc = static_cast<const float*>(twc);
  p.tws = static_cast<const float*>(tws);
  p.rotc = static_cast<const float*>(rotc);
  p.rots = static_cast<const float*>(rots);
  p.outr = outr;
  p.outi = outi;
  p.n_spectra = n_spectra;
  p.n1 = n1;
  p.n2 = n2;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return quantise ? dft_dispatch<true>(p, batch, st) : dft_dispatch<false>(p, batch, st);
}

#endif  // K1_STAGE_STOPS
