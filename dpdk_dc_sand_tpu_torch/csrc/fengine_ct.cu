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
// 1. k1_fir_kernel — the FIR, on K1's inputs, with the register ring of
//    K6's first body (its rows loaded straight from global memory; K6 now
//    feeds that ring from a shared-memory ring, csrc/pfb_fir.cu): a block
//    owns 512 lanes of the frame and a run of RUN spectra of one stream;
//    each thread keeps its 4 lanes' taps of the window in
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
// f32 DFT operands (the engines' fengine="fused_f32", "exact f32 MACs")
// with N1 >= 16 and N2 <= 1024 run as two passes as well: k1_fir_kernel
// writes the exact f32 sums into an f32 plane (16 flagship streams a group
// of the same scratch), then k1_dft_f32_kernel computes both stages in f32
// FFMA, register-blocked, with the N1-point matrix's tiles shared by the
// spectra of a unit (its design is at the kernel). f32 FFMA is this card's
// slowest arithmetic: 67 TFLOP/s, so the 5.5 TFLOP of a flagship step bound
// the pass at 82.1 ms (4.10 ms on 8 streams).
//
// N1 = 8, where a 16-row tile does not fit, and the splits the DFT passes
// have no plan for (f32: N2 > 1024; bf16: N2 >= 2048, fft >= 2^22) take
// fengine_ct_kernel: one block per (spectrum, batch), SIMT FMA on register
// micro-tiles, k1 walked in chunks of kc rows (kc shrinks with N2 so the T
// planes fit); in f32 mode, and in bf16 where the whole bf16 FIR plane does
// not fit in shared memory, each stage-A K tile recomputes its [KTA, NTA]
// slice of the FIR from global memory. The wrapper (_k1_body) asks
// k1_dft_attributes / k1_dft_f32_attributes for a plan before any launch.
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
// SIMT body (f32 DFT operands, or bf16 where the two passes have no plan)
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

// WHOLE: the bf16 FIR plane is computed once into shared memory (the N1 = 8
// splits); otherwise each stage-A K tile recomputes its [KTA, NTA] slice of
// the FIR from global memory, rounded to the operand type (f32 mode, and
// bf16 at fft >= 2^22, where neither the plane nor a two-pass plan fits).
template <bool BF16, bool QUANT, bool WHOLE = BF16>
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
  float* sXt = sBs + MTB * KTB;                 // !WHOLE: [KTA][NTA]
  OpT* sTr = reinterpret_cast<OpT*>(sXt + (WHOLE ? 0 : KTA * NTA));  // [kc][ts]
  OpT* sTi = sTr + kc * ts;
  // WHOLE: the whole bf16 FIR plane [N1][N2], 16-byte aligned after sT.
  const size_t t_bytes = 2 * kc * ts * sizeof(OpT);
  __nv_bfloat16* sX = reinterpret_cast<__nv_bfloat16*>(
      reinterpret_cast<unsigned char*>(sTr) + ((t_bytes + 15) & ~size_t(15)));

  if constexpr (WHOLE) {
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
        if constexpr (!WHOLE) {
          for (int i = tid; i < kta * NTA; i += THREADS) {
            const int r = i / NTA, c = i % NTA;
            sXt[r * NTA + c] =
                op_round<BF16>(fir_at(xs, p.win, fft, p.n_taps, (kt + r) * n2 + c0 + c));
          }
        }
        __syncthreads();
        if (a_on) {
          for (int kk = 0; kk < kta; ++kk) {
            float xv[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if constexpr (WHOLE) {
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

size_t smem_bytes(bool bf16, bool whole, int n1, int n2, int kc) {
  const size_t ts = n2 + 1;
  size_t bytes = sizeof(float) * (2 * kc * KTA + 2 * MTB * KTB);
  const size_t op = bf16 ? sizeof(__nv_bfloat16) : sizeof(float);
  if (whole) {
    bytes += (2 * kc * ts * op + 15) & ~size_t(15);
    bytes += static_cast<size_t>(n1) * n2 * sizeof(__nv_bfloat16);
  } else {
    bytes += sizeof(float) * KTA * NTA;
    bytes += 2 * kc * ts * op;
  }
  return bytes;
}

template <bool BF16, bool QUANT, bool WHOLE = BF16>
cudaError_t launch(const Params& p, int batch, size_t bytes, cudaStream_t stream) {
  auto kern = fengine_ct_kernel<BF16, QUANT, WHOLE>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  dim3 grid(p.n_spectra, batch);
  kern<<<grid, THREADS, bytes, stream>>>(p);
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
  const float* win;  // [taps, fft]
  void* plane;       // [G, S, fft]: bf16, or f32 for f32 DFT operands
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

// 4 FIR sums into the plane: rounded to bf16, or the f32 sums themselves.
__device__ __forceinline__ void store_plane4(__nv_bfloat16* p, float4 v) { store_bf16x4(p, v); }
__device__ __forceinline__ void store_plane4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
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
template <int MAXT, bool VEC, int STOP, typename PT>
__device__ __forceinline__ void fir_run(const FirParams& a, const int8_t* xb, PT* ob,
                                        int8_t* oq, int lane, int s0, int s1) {
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
      store_plane4(ob + s * fft, acc);
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
          store_plane4(ob + (s + j) * fft, acc);
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

// PT: the plane's element, bf16 (STOP_NONE or a stop) or float (f32 DFT
// operands: the exact f32 sums, STOP_NONE only).
template <int MAXT, int STOP = STOP_NONE, typename PT = __nv_bfloat16>
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
  PT* ob = static_cast<PT*>(a.plane) + b * a.n_spectra * static_cast<long long>(a.fft) + lane;
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

// Calls fn(std::integral_constant<int, KC>, plan, bytes) with the largest
// chunk whose T planes and ring fit (64 rows up to N2 = 256), or returns
// NO_PLAN (N2 >= 2048).
template <typename Fn>
int with_dft_plan(const DftParams& p, Fn fn) {
  DftParams q = p;
  size_t bytes;
  if ((bytes = dft_plan<64>(q))) return fn(std::integral_constant<int, 64>{}, q, bytes);
  q = p;
  if ((bytes = dft_plan<32>(q))) return fn(std::integral_constant<int, 32>{}, q, bytes);
  q = p;
  if ((bytes = dft_plan<16>(q))) return fn(std::integral_constant<int, 16>{}, q, bytes);
  return NO_PLAN;
}

template <bool QUANT>
int dft_dispatch(const DftParams& p, int batch, cudaStream_t st) {
  return with_dft_plan(p, [&](auto kc, const DftParams& q, size_t bytes) {
    return static_cast<int>(launch_dft<decltype(kc)::value, QUANT>(q, batch, bytes, st));
  });
}

// ---------------------------------------------------------------------------
// Pass 2, f32 DFT operands: register-blocked FFMA (exact f32 products and
// sums; no tensor core, no TF32)
// ---------------------------------------------------------------------------
// A unit is (batch, block of SB spectra, chunk of KC k1 rows); persistent
// blocks of 256 threads (one an SM) walk the units chunk fastest, so the
// chunks of one block of spectra run side by side and its plane rows stay in
// L2. A cp.async ring of 4 slots streams one tile sequence through every
// unit, kept 3 tiles ahead of the compute across units:
//   stage A tiles: [KTA x SB*N2] of the plane (KTA n1 rows of each spectrum)
//     and [KTA x 2KC] of the N1-point matrix (its cos and -sin, symmetric,
//     read as [n1][k1]). Each D1 tile is read once a unit and meets every
//     spectrum of the unit. A thread owns 4 k1 rows (cos and -sin) x 8
//     columns: 64 FFMA for 4 shared loads a step. After the last K tile the
//     f32 twiddle (the reference's rounding point) lands in shared memory as
//     the unit's T planes [SB*KC][N2] (re, im);
//   stage B tiles: [KTB x N2] of the N2-point matrix transposed ([n2][k2],
//     cos columns then -sin). A thread owns 4 k2 x (cos, -sin) against 4
//     (spectrum, k1) x (T re, T im): the four products cos.tr, -sin.ti,
//     cos.ti, -sin.tr; then k1_dft_kernel's epilogue (re, im, rotation,
//     requant or the f32 store).
// Both stages hold 64 f32 accumulators a thread (one register array), so a
// unit covers KC * SB * N2 = 32 * 256 outputs a stage: KC = 16 and SB =
// 512 / N2 up to N2 = 512 (two spectra a unit at the flagship), KC = 8 at
// N2 = 1024. T planes take 64 KB; a ring slot 32 KB. N2 > 1024 and N1 = 8
// have no plan: they stay on the SIMT body (k1_dft_f32_attributes decides).
// Each T row is XOR-swizzled by 16-byte groups ((row / 4) % 8), so stage A's
// row-wise stores and stage B's reads of four rows at a time are both free of
// bank conflicts.
// What bounds it: the f32 FFMA rate (4.10 ms on 8 flagship streams); its
// time on the card is in PERF.md. Beside the FFMA loops it copies the plane
// from L2 once a chunk (N1 / KC = 16 times a spectrum at the flagship, 6 MB
// a spectrum with the N2-point matrix). In trial builds (not kept), cutting
// each stage's FFMA loop in turn left much of the time outside both loops,
// and chunks of 32 rows with one spectrum a unit, which read the plane half
// as often, ran faster; 512 threads for two spectra of 32 rows spilled at
// their 128 registers.
constexpr int F32_THREADS = 256;
constexpr int F32_OUT = 32 * F32_THREADS;  // KC * SB * N2: outputs a stage / 2
constexpr int F32_SLOT = 8192;             // floats a stage-B tile takes
constexpr int F32_STAGES = 4;              // ring slots

// Floats a ring slot of a KC-row chunk: a stage-A tile ([KTA x NCOL] of the
// plane and [KTA x 2KC] of the N1-point matrix, KTA = KC) or a stage-B tile.
template <int KC>
__host__ __device__ constexpr int f32_slot() {
  return KC * (F32_OUT / KC) + KC * 2 * KC > F32_SLOT ? KC * (F32_OUT / KC) + KC * 2 * KC
                                                      : F32_SLOT;
}

// Shared-memory bytes of a KC-row chunk: the T planes and the ring.
template <int KC>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * (2 * static_cast<size_t>(F32_OUT) +
                          static_cast<size_t>(F32_STAGES) * f32_slot<KC>());
}
static_assert(f32_smem_bytes<16>() <= MAX_SMEM && f32_smem_bytes<8>() <= MAX_SMEM,
              "the f32 DFT pass's 4-slot ring must fit beside its T planes");

struct F32Params {
  const float* plane;  // [G, S, N1, N2] f32
  const float* d1c;    // [N1, N1] cos (symmetric)
  const float* d1s;    // [N1, N1] -sin (symmetric)
  const float* d2t;    // [N2, N2]: [n2][k2], cos columns k2 < N2/2, then -sin
  const float* twc;    // [N1, N2]
  const float* tws;
  const float* rotc;   // [G, C]
  const float* rots;
  void* outr;          // [G, S, C] int8, or f32 without the requant
  void* outi;
  int n_spectra, n1, n2;
  int sb, ktb;             // spectra a unit; stage-B K-tile depth
  int n_kta, n_ktb;        // K tiles a unit: stage A, stage B
  int n_chunks, n_sblk;    // k1 chunks; blocks of SB spectra a batch
  int n_units;             // G * n_sblk * n_chunks
};

// The swizzled float index of T row `row`, 4-aligned column `col`.
__device__ __forceinline__ int t_at(int row, int col, int n2) {
  return row * n2 + (col ^ (((row >> 2) & 7) << 2));
}

// A block's walk: unit i of the block (unit blockIdx.x + i * gridDim.x),
// tile `local` of the unit.
struct F32Cursor {
  int i, local;
  int b, s0, k0;  // batch, first spectrum, first k1 row
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
  const int n1 = p.n1, n2 = p.n2;
  if (c.local < p.n_kta) {
    // [KTA x NCOL] of the plane: row r is n1 = kt0 + r of each spectrum;
    // column s * N2 + n2. Spectra past the stream's last are not loaded
    // (their columns are computed and never stored).
    const int kt0 = c.local * KTA, ln2 = lg(n2);
    constexpr int PX = KTA * NCOL / 4, PD = KTA * 2 * KC / 4;
#pragma unroll 4
    for (int i = tid; i < PX; i += NT) {
      const int r = i / (NCOL / 4), col = (i % (NCOL / 4)) * 4;
      const int s = c.s0 + (col >> ln2);
      if (s < p.n_spectra) {
        const float* src = p.plane +
                           ((static_cast<long long>(c.b) * p.n_spectra + s) * n1 + kt0 + r) * n2 +
                           (col & (n2 - 1));
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
    // [KTB x N2] of the transposed N2-point matrix: one contiguous run.
    const float* src = p.d2t + static_cast<long long>(c.local - p.n_kta) * p.ktb * n2;
    for (int i = tid * 4; i < F32_SLOT; i += NT * 4) cp_async16(slot + i, src + i);
  }
}

template <int KC, bool QUANT>
__global__ void __launch_bounds__(F32_THREADS, 1) k1_dft_f32_kernel(F32Params p) {
  constexpr int KTA = KC, NCOL = F32_OUT / KC;
  constexpr int GA = F32_THREADS * 4 / KC;  // stage-A column groups
  constexpr int SLOT = f32_slot<KC>();
  extern __shared__ __align__(128) float fsmem[];
  const int tid = threadIdx.x;
  const int n1 = p.n1, n2 = p.n2, h = n2 / 2, C = n1 * n2 / 2;
  float* sTr = fsmem;              // [SB*KC][N2], swizzled (t_at)
  float* sTi = sTr + F32_OUT;
  float* ring = sTi + F32_OUT;

  const int nA = p.n_kta, tpu = nA + p.n_ktb;
  const int my_units = (p.n_units - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1;
  const int n_tiles = my_units * tpu;

  // Stage A: k1 rows 4*rg.. of the chunk; columns 4*j.. and NCOL/2 + 4*j..
  const int rg = tid / GA, ja = (tid % GA) * 4;
  // Stage B: k2 rows 4*rb.. (cos) and h + 4*rb.. (-sin); T rows 4*qb.. of
  // (spectrum, k1). Q = SB*KC/4 groups of T rows.
  const int lq = lg(p.sb * KC / 4);
  const int qb = tid & ((1 << lq) - 1), rb = tid >> lq;

  // Stage A: [cos/-sin][4 k1][8 columns]; stage B: [4 sums][4 k2][4 T rows],
  // sums cos.tr, -sin.ti, cos.ti, -sin.tr.
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
        // ai*wc, each product rounded. Row (spectrum s, k1) of T, column n2.
        const int ln2 = lg(n2);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int col = half * (NCOL / 2) + ja;
          const int s = col >> ln2, n = col & (n2 - 1);
          float4 wc[4], ws[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const long long o = static_cast<long long>(k0 + 4 * rg + i) * n2 + n;
            wc[i] = __ldg(reinterpret_cast<const float4*>(p.twc + o));
            ws[i] = __ldg(reinterpret_cast<const float4*>(p.tws + o));
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float* ar = acc + i * 8 + half * 4;
            const float* ai = acc + 32 + i * 8 + half * 4;
            const float c[4] = {wc[i].x, wc[i].y, wc[i].z, wc[i].w};
            const float sn[4] = {ws[i].x, ws[i].y, ws[i].z, ws[i].w};
            float tr[4], ti[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              tr[e] = __fsub_rn(__fmul_rn(ar[e], c[e]), __fmul_rn(ai[e], sn[e]));
              ti[e] = __fadd_rn(__fmul_rn(ar[e], sn[e]), __fmul_rn(ai[e], c[e]));
            }
            const int o = t_at(s * KC + 4 * rg + i, n, n2);
            *reinterpret_cast<float4*>(sTr + o) = make_float4(tr[0], tr[1], tr[2], tr[3]);
            *reinterpret_cast<float4*>(sTi + o) = make_float4(ti[0], ti[1], ti[2], ti[3]);
          }
        }
      }
    } else {
      const int kidx = cc.local - nA;
      if (kidx == 0) {
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      }
      const int ktb = p.ktb;
      for (int k4 = 0; k4 < ktb; k4 += 4) {
        // Four T rows x four n2 of each plane, then four n2 steps.
        const int n = kidx * ktb + k4;
        float4 tr4[4], ti4[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int o = t_at(4 * qb + c, n, n2);
          tr4[c] = *reinterpret_cast<const float4*>(sTr + o);
          ti4[c] = *reinterpret_cast<const float4*>(sTi + o);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float* row = slot + (k4 + u) * n2;
          const float4 dc = *reinterpret_cast<const float4*>(row + 4 * rb);
          const float4 ds = *reinterpret_cast<const float4*>(row + h + 4 * rb);
          const float cv[4] = {dc.x, dc.y, dc.z, dc.w}, sv[4] = {ds.x, ds.y, ds.z, ds.w};
          float trv[4], tiv[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            trv[c] = u == 0 ? tr4[c].x : u == 1 ? tr4[c].y : u == 2 ? tr4[c].z : tr4[c].w;
            tiv[c] = u == 0 ? ti4[c].x : u == 1 ? ti4[c].y : u == 2 ? ti4[c].z : ti4[c].w;
          }
#pragma unroll
          for (int a = 0; a < 4; ++a) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              acc[0 * 16 + a * 4 + c] = fmaf(cv[a], trv[c], acc[0 * 16 + a * 4 + c]);
              acc[1 * 16 + a * 4 + c] = fmaf(sv[a], tiv[c], acc[1 * 16 + a * 4 + c]);
              acc[2 * 16 + a * 4 + c] = fmaf(cv[a], tiv[c], acc[2 * 16 + a * 4 + c]);
              acc[3 * 16 + a * 4 + c] = fmaf(sv[a], trv[c], acc[3 * 16 + a * 4 + c]);
            }
          }
        }
      }
      if (kidx == p.n_ktb - 1) {
        // re = cos.tr - (-sin.ti), im = cos.ti + (-sin.tr); rotate; store
        // four consecutive channels k2*N1 + k1.. of spectrum s.
        const int row = 4 * qb, s = cc.s0 + row / KC, k1 = k0 + (row & (KC - 1));
        if (s < p.n_spectra) {
          const long long obase =
              (static_cast<long long>(cc.b) * p.n_spectra + s) * C;
          const float* rc_b = p.rotc + static_cast<long long>(cc.b) * C;
          const float* rs_b = p.rots + static_cast<long long>(cc.b) * C;
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const int ch = (4 * rb + a) * n1 + k1;
            const float4 rc4 = __ldg(reinterpret_cast<const float4*>(rc_b + ch));
            const float4 rs4 = __ldg(reinterpret_cast<const float4*>(rs_b + ch));
            const float rc[4] = {rc4.x, rc4.y, rc4.z, rc4.w};
            const float rs[4] = {rs4.x, rs4.y, rs4.z, rs4.w};
            float v[2][4];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float re = __fsub_rn(acc[a * 4 + c], acc[16 + a * 4 + c]);
              const float im = __fadd_rn(acc[32 + a * 4 + c], acc[48 + a * 4 + c]);
              v[0][c] = __fsub_rn(__fmul_rn(re, rc[c]), __fmul_rn(im, rs[c]));
              v[1][c] = __fadd_rn(__fmul_rn(re, rs[c]), __fmul_rn(im, rc[c]));
            }
            if constexpr (QUANT) {
              *reinterpret_cast<char4*>(static_cast<int8_t*>(p.outr) + obase + ch) =
                  make_char4(requant(v[0][0]), requant(v[0][1]), requant(v[0][2]),
                             requant(v[0][3]));
              *reinterpret_cast<char4*>(static_cast<int8_t*>(p.outi) + obase + ch) =
                  make_char4(requant(v[1][0]), requant(v[1][1]), requant(v[1][2]),
                             requant(v[1][3]));
            } else {
              *reinterpret_cast<float4*>(static_cast<float*>(p.outr) + obase + ch) =
                  make_float4(v[0][0], v[0][1], v[0][2], v[0][3]);
              *reinterpret_cast<float4*>(static_cast<float*>(p.outi) + obase + ch) =
                  make_float4(v[1][0], v[1][1], v[1][2], v[1][3]);
            }
          }
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The plan of a chunk of KC rows, 0 if it has none: SB = NCOL / N2 spectra a
// unit, stage-B tiles of one slot's 8192 floats, the 4-slot ring beside the
// T planes.
template <int KC>
size_t f32_plan(F32Params& p) {
  constexpr int KTA = KC, NCOL = F32_OUT / KC;
  if (p.n1 < 16 || KC > p.n1 || p.n2 > NCOL || p.n2 < 128) return 0;
  p.sb = NCOL / p.n2;
  p.ktb = F32_SLOT / p.n2;
  p.n_kta = p.n1 / KTA;
  p.n_ktb = p.n2 / p.ktb;
  p.n_chunks = p.n1 / KC;
  p.n_sblk = (p.n_spectra + p.sb - 1) / p.sb;
  return f32_smem_bytes<KC>();
}

template <int KC, bool QUANT>
cudaError_t launch_dft_f32(F32Params p, int batch, size_t bytes, cudaStream_t stream) {
  auto kern = k1_dft_f32_kernel<KC, QUANT>;
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
  const long long tpu = p.n_kta + p.n_ktb;
  if (units > 0x7fffffffLL - grid || ((units + grid - 1) / grid) * tpu > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  p.n_units = static_cast<int>(units);
  kern<<<grid, F32_THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

// Run f(kc, plan, bytes) with the chunk the f32 pass takes for this split
// (16 rows up to N2 = 512, 8 at N2 = 1024), or return NO_PLAN.
template <typename F>
int with_f32_plan(F32Params p, F&& f) {
  F32Params q = p;
  size_t bytes;
  if ((bytes = f32_plan<16>(q))) return f(std::integral_constant<int, 16>{}, q, bytes);
  q = p;
  if ((bytes = f32_plan<8>(q))) return f(std::integral_constant<int, 8>{}, q, bytes);
  return NO_PLAN;
}

// K1's FIR pass into a plane of PT (bf16, or float for f32 DFT operands).
template <typename PT>
int fir_pass(const void* x, long long batch_stride, const void* starts, const void* win,
             void* plane, int batch, int n_spectra, int n_taps, int fft, void* stream) {
  if (batch < 1 || n_spectra < 1 || n_taps < 1 || fft < 4 || fft % 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FirParams a{static_cast<const int8_t*>(x), batch_stride,
              static_cast<const long long*>(starts), static_cast<const float*>(win),
              plane, n_spectra, fft, n_taps,
              (fft + 4 * FIR_THREADS - 1) / (4 * FIR_THREADS), (n_spectra + RUN - 1) / RUN};
  const long long blocks = static_cast<long long>(a.lane_blocks) * a.runs * batch;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (n_taps <= 4) {
    k1_fir_kernel<4, STOP_NONE, PT><<<grid, FIR_THREADS, 0, st>>>(a);
  } else if (n_taps <= 8) {
    k1_fir_kernel<8, STOP_NONE, PT><<<grid, FIR_THREADS, 0, st>>>(a);
  } else if (n_taps <= 16) {
    k1_fir_kernel<16, STOP_NONE, PT><<<grid, FIR_THREADS, 0, st>>>(a);
  } else {
    k1_fir_kernel<0, STOP_NONE, PT><<<grid, FIR_THREADS, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

}  // namespace

// K1's own entry points; csrc/fengine_ct_stops.cu includes this file for the
// kernels above and defines K1_STAGE_STOPS, so it compiles the stops alone.
#ifndef K1_STAGE_STOPS

extern "C" const char* dcsand_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The two-pass bf16 DFT pass's plan (-1: none).
static int dft_plan_kc(int n1, int n2) {
  DftParams p{};
  p.n1 = n1;
  p.n2 = n2;
  return with_dft_plan(p, [](auto kc, const DftParams&, size_t) { return decltype(kc)::value; });
}

// The single-pass SIMT body: f32 DFT operands, or bf16 where the two-pass
// form's DFT pass has no plan (N1 = 8, or N2 >= 2048: fft >= 2^22).
// quantise = 0 writes f32 outputs instead of int8. Returns -1 where no
// chunk's plan fits shared memory.
extern "C" int fengine_ct_launch(
    const void* x, long long batch_stride, const void* starts,
    const void* win, const void* d1c, const void* d1s, const void* d2,
    const void* twc, const void* tws, const void* rotc, const void* rots,
    void* outr, void* outi, int batch, int n_spectra, int n_taps, int n1,
    int n2, int bf16_ops, int quantise, void* stream) {
  if (n1 < 8 || !pow2(n1) || n2 < 128 || !pow2(n2) || n_spectra < 1 || batch < 1 ||
      batch > 65535 || n_taps < 1 || (bf16_ops && n1 >= 16 && dft_plan_kc(n1, n2) != NO_PLAN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // bf16 keeps its whole FIR plane in shared memory where that fits at 2-row
  // chunks (N1 = 8); otherwise it recomputes FIR tiles, as f32 does.
  const bool whole = bf16_ops && smem_bytes(true, true, n1, n2, 2) <= MAX_SMEM;
  int kc = n1 < KC ? n1 : KC;
  while (kc > 2 && smem_bytes(bf16_ops, whole, n1, n2, kc) > MAX_SMEM) kc /= 2;
  const size_t bytes = smem_bytes(bf16_ops, whole, n1, n2, kc);
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
  if (bf16_ops && whole) {
    err = quantise ? launch<true, true>(p, batch, bytes, st) : launch<true, false>(p, batch, bytes, st);
  } else if (bf16_ops) {
    err = quantise ? launch<true, true, false>(p, batch, bytes, st)
                   : launch<true, false, false>(p, batch, bytes, st);
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
  return fir_pass<bf16>(x, batch_stride, starts, win, plane, batch, n_spectra, n_taps, fft,
                        stream);
}

// Pass 1 for f32 DFT operands: the same, into an f32 plane (16-byte
// aligned) of the exact f32 tap-order sums.
extern "C" int k1_fir_f32_launch(const void* x, long long batch_stride, const void* starts,
                                 const void* win, void* plane, int batch, int n_spectra,
                                 int n_taps, int fft, void* stream) {
  return fir_pass<float>(x, batch_stride, starts, win, plane, batch, n_spectra, n_taps, fft,
                         stream);
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

// The bf16 DFT pass's plan and body at N1 x N2, -1 where it has none (the
// shape then takes the SIMT body): out int[6] = registers a thread, local
// (spill) bytes a thread, KC, K-tile depth, ring stages, shared-memory bytes.
extern "C" int k1_dft_attributes(int n1, int n2, void* out) {
  if (n1 < 16 || !pow2(n1) || n2 < 128 || !pow2(n2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DftParams p{};
  p.n1 = n1;
  p.n2 = n2;
  int* o = static_cast<int*>(out);
  return with_dft_plan(p, [&](auto kc, const DftParams& q, size_t bytes) {
    constexpr int K = decltype(kc)::value;
    cudaFuncAttributes a{};
    const cudaError_t err = cudaFuncGetAttributes(&a, k1_dft_kernel<K, true>);
    if (err != cudaSuccess) return static_cast<int>(err);
    o[0] = a.numRegs;
    o[1] = static_cast<int>(a.localSizeBytes);
    o[2] = K;
    o[3] = q.kt;
    o[4] = q.stages;
    o[5] = static_cast<int>(bytes);
    return 0;
  });
}

// Pass 2 with f32 DFT operands: plane [batch, n_spectra, N1, N2] f32 (16-byte
// aligned) -> outputs [batch, n_spectra, C] (int8, or f32 without
// quantise); d1c/d1s the f32 N1-point matrices, d2t the f32 N2-point matrix
// transposed ([n2][k2]: cos columns, then -sin), twc/tws the f32 twiddles,
// rotc/rots [batch, C]. Returns -1 where the pass has no plan (N1 < 16, N2 >
// 1024): those shapes take fengine_ct_launch.
extern "C" int k1_dft_f32_launch(const void* plane, const void* d1c, const void* d1s,
                                 const void* d2t, const void* twc, const void* tws,
                                 const void* rotc, const void* rots, void* outr, void* outi,
                                 int batch, int n_spectra, int n1, int n2, int quantise,
                                 void* stream) {
  if (n1 < 8 || !pow2(n1) || n2 < 128 || !pow2(n2) || batch < 1 || n_spectra < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  F32Params p{};
  p.plane = static_cast<const float*>(plane);
  p.d1c = static_cast<const float*>(d1c);
  p.d1s = static_cast<const float*>(d1s);
  p.d2t = static_cast<const float*>(d2t);
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
  return with_f32_plan(p, [&](auto kc, const F32Params& q, size_t bytes) {
    constexpr int K = decltype(kc)::value;
    return static_cast<int>(quantise ? launch_dft_f32<K, true>(q, batch, bytes, st)
                                     : launch_dft_f32<K, false>(q, batch, bytes, st));
  });
}

// The f32 DFT pass's plan and body at N1 x N2, -1 where it has none (the
// shape then takes the SIMT body): out int[8] = registers a thread, local
// (spill) bytes a thread, KC, SB, stage-B K-tile depth, ring stages,
// shared-memory bytes, threads a block.
extern "C" int k1_dft_f32_attributes(int n1, int n2, void* out) {
  if (n1 < 8 || !pow2(n1) || n2 < 128 || !pow2(n2)) {
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
    const cudaError_t err = cudaFuncGetAttributes(&a, k1_dft_f32_kernel<K, true>);
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

#endif  // K1_STAGE_STOPS
