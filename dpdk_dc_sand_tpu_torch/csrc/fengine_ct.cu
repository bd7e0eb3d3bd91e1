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
// Design. Every split K1 takes runs as passes launched by the wrapper over
// groups of batches whose scratch fits (about 1 GB): the FIR pass into a
// plane of the DFT operand type, then the DFT as one pass where its T planes
// fit shared memory beside a tile ring (the two-pass route, N2 <= 1024), or
// as two GEMM-shaped passes through T in device memory where they do not
// (the three-pass route, N2 >= 2048: fft >= 2^22). The wrapper (_k1_body)
// asks the plan queries (k1_dft_attributes, k1_dft_f32_attributes, then
// k1_stage_*_attributes) before any launch; a split none of them takes is
// refused. Nothing falls back.
//
// 1. k1_fir_kernel — the FIR, on K1's inputs, on K6's design (csrc/pfb_fir.cu):
//    a block owns 512 lanes of the frame (128 threads, 4 lanes each) and a
//    run of up to 256 spectra of one stream, or where S is smaller the same
//    run of several streams one after another (the wrapper's plan,
//    ops/fengine_fused.py:_fir_plan), so each window value is read once a
//    block: at fft 2^22 and S = 4 the window (268 MB) would otherwise come
//    from device memory once a stream. Frame rows reach the block through a
//    shared-memory ring of 16 stages of 4 rows (64 KB) that cp.async keeps
//    15 stages ahead; each thread copies and reads only its own 8 bytes of a
//    row, so the ring needs no barrier. A stream may start at any byte (the
//    coarse delay, starts[b]): each thread copies the aligned 4-byte word
//    under its 4 samples and, where the start is off 4 bytes, the word after
//    it (one more 4-byte copy a row, no byte loads; neighbouring threads
//    share the DRAM sectors), and joins them on read with a funnel shift by
//    8·(start % 4). Each row goes from the ring into a register ring of the
//    last MAXT rows (4, 8 or 16) once, converted to f32 once; a chunk of
//    MAXT outputs of a MAXT-tap pass (its tail too) runs with no row or tap
//    guard. Runs of at most 4 spectra (fft >= 2^22 at the flagship's sample
//    count) take the short-run body instead: each row, once read, adds its
//    product to every output of the run it feeds, so a stream's rows need
//    no priming; its ring has 6 stages (24 KB), which hold a stream's rows
//    (at most 19) and leave room for four blocks an SM. It writes the FIR
//    rounded to bf16 straight into the [B, S, N1, N2] plane (the in-frame
//    index is the plane index) by streaming stores, bit for bit
//    __float2bfloat16_rn of the f32 tap-order sum, or the f32 sums
//    themselves for f32 operands. More than 16 taps take the long body
//    (every tap's row and window from global memory, the same sums). Bound
//    at the flagship by its f32 operations (an FMUL for an output's first
//    tap, an FMUL and an FADD for each later one, each an FP32 issue slot:
//    2.48 ms), its bytes close behind (2.84 GB in, 5.37 GB out: 2.45 ms);
//    the f32 plane by its bytes (10.74 GB out: 4.06 ms). The 16-row ring
//    body issues about 151 instructions an output and thread, 124 of them
//    the FMULs and FADDs, so its arithmetic alone runs near the issue rate;
//    its time is in PERF.md.
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
//    to N2 = 256, 32 at 512 and 1024): no plan needs a whole plane in
//    shared memory. Both stages keep 64 f32 accumulators a thread (one
//    register array, reused), so the block's tile is KC x 256..512 in stage
//    A and 128..512 x KC in stage B. KT is the deepest of 64, 32, 16 that
//    fits: fewer barriers a unit.
//    N1 = 8 (fft 1024), where a chunk of one spectrum is 8 rows, makes a
//    unit of 16 spectra instead (KC_N8 = 128 T rows, (spectrum, k1)): stage
//    A is one 8-deep K tile, the unit's 16 planes whole ([128 x N2], 8 rows
//    of each spectrum), each warp's 4 spectra against the [cos; -sin]
//    [16 x 8] matrix held in registers, one mma.sync m16n8k8 per spectrum
//    and 8 columns (one MMA a sum, so nothing chains); stage B is the
//    16-row design's, 16 spectra's k1 columns side by side.
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
// the FIR pass's operations (2.48 ms) and the DFT's 5.5 TFLOP of bf16
// (5.56 ms). The FIR pass's time is in PERF.md. The DFT pass runs at
// about a sixth of its floor, far from the HBM rate and the bf16 peak
// alike. By its design's count each unit pulls ~0.5 MB through L2 (the
// plane's rows once per chunk, so 4 times a spectrum at the flagship; the
// chunk's DFT rows; the whole N2-point matrix; the chunk's f32 twiddles and
// rotation values, which the epilogues read with every warp waiting), 84 GB
// a flagship step, and its 16 warps each load their own mma.sync
// fragments, so shared-memory reads compete with the MMAs. wgmma, which
// reads its operands from shared memory once a warpgroup, TMA tiles, and a
// cluster that multicasts the plane and the N2-point matrix to the chunks
// of one spectrum are the next steps. At N1 = 8 the work is 0.5 MFLOP a
// spectrum against 3 KB in and out, so the FIR pass's bytes bound it.
//
// f32 DFT operands (the engines' fengine="fused_f32", "exact f32 MACs")
// with N2 <= 1024 run as two passes as well: k1_fir_kernel writes the exact
// f32 sums into an f32 plane (16 flagship streams a group of the same
// scratch), then k1_dft_f32_kernel computes both stages in f32 FFMA,
// register-blocked, with the N1-point matrix's tiles shared by the spectra
// of a unit (its design is at the kernel; N1 = 8 is its KC = 8 plan with 8
// spectra a unit). f32 FFMA is this card's slowest arithmetic: 67 TFLOP/s,
// so the 5.5 TFLOP of a flagship step bound the pass at 82.1 ms (4.10 ms on
// 8 streams).
//
// 3. The three-pass route (N2 >= 2048, both operand types). At N2 = 2048 a
//    chunk's T planes ([KC, N2] complex) do not fit beside the tile ring,
//    and shrinking the chunk would read each plane row from L2 N1 / KC times
//    a spectrum. So T goes to device memory between two GEMM-shaped passes,
//    one block a tile, each tile's K loop through a cp.async ring:
//      k1_stage_a_kernel (bf16: mma.sync m16n8k16 from the ring, each MMA's
//        sum added in f32 round-to-nearest, as the DFT pass's stage A: at K
//        = N1 = 2048 chained sums would flip more bf16 roundings of T than
//        at 1024) and k1_stage_a_f32_kernel (FFMA, 4 k1 x (cos, -sin) x 8
//        columns a thread): [2·N1 x N1] (the cos and -sin rows paired, so one
//        thread holds both sums of a (k1, n2)) x the plane [N1 x N2] of each
//        spectrum, the f32 twiddle in the epilogue, T re and im stored
//        rounded to the operand type, K1's rounding point (f32 T
//        transposed, [n2][k1], so f32 stage B reads 4 k1 as one float4);
//      k1_stage_b_kernel (bf16, its MMAs chained as the DFT pass's stage B)
//        and k1_stage_b_f32_kernel (FFMA, 4 k2 x (cos, -sin) x 4 k1 x (T re,
//        T im) a thread): the row-stacked N2-point matrix x T^T, the four
//        products combined as the DFT pass's stage B does, then the
//        rotation and the requant (or the f32 store), bin k2·N1 + k1.
//    These passes replace nothing in the TPU kernel: they are K1's work
//    split where an SM's 227 KB cannot hold what the TPU's VMEM held. The
//    bf16 or f32 operations bound each pass (68.7 GFLOP a spectrum at fft
//    2^22, both passes together: 69 us of bf16, 1.03 ms of f32), far above
//    T's bytes (16.8 MB a spectrum in bf16, 33.6 in f32, each written once
//    and read once: 10 and 20 us at the HBM rate).
//
// Stage stops: K1 cut after a stage at compile time, so the production
// instantiations (STOP_NONE) are the code above unchanged. They serve the
// reference's fengine_fused(_ablate=...) (fengine_pallas.py:645-652,
// 794-798, 905-914, 936-945) and the probes P5 and P4 (benchmarks/
// ct_ablate.py and benchmarks/dma_bisect.py of the JAX package, the trimmed
// copies of _fengine_kernel_ct reached through pl.pallas_call at
// ct_ablate.py:147 and dma_bisect.py:113). A stopped call runs the passes
// its route's whole call runs, up to the stop:
//   STOP_DMA        — the FIR pass's ring copies only, each input byte once
//                     into the ring and read from it once; the probe to both
//                     outputs: for spectrum s of the block from frame f0 =
//                     s - s % 16, output r*N1 + l is row r < N2/2, lane l <
//                     N1 of the [rows, N2] view of the stream from frame f0
//                     (the first fft/2 samples of frame f0 where N1 == N2;
//                     N2 / (2 N1) frames where N1 < N2), the stream read
//                     from the reference's DMA base, which the wrapper
//                     passes as the start (the coarse delay's row rounded
//                     down to a multiple of 8 rows);
//   STOP_FIR_RND    — the FIR pass, its plane (bf16 or f32) written as
//                     always, and the FIR rounded to the plane's type, its
//                     first fft/2 samples, to both outputs (N1 == N2);
//   STOP_STAGEA_RND — the DFT pass (bf16 or f32) up to the twiddle, no stage
//                     B: T re / im rounded to the operand type, rows k1 <
//                     N1/2, to outr / outi at k1*N2 + n2; on the three-pass
//                     route stage A into T, then k1_t_slice_kernel gathers
//                     those rows;
//   STOP_STAGEB     — the DFT pass (or the three-pass route's stage B) up to
//                     stage B, no rotation: re / im.
// Each writes int8 by truncation with saturation (trunc_s8), as XLA's f32
// -> int8 conversion does, or, where the call asks for no requant, the f32
// values as they are. P5's own kernel writes two stops differently, and it keeps them:
//   STOP_FIR        — the bf16 plane, and the f32 sums' first and second
//                     fft/2 samples to outr, outi;
//   STOP_STAGEA     — T re / im before the rounding (bf16 operands, int8).
// Their entry points are in csrc/fengine_ct_stops.cu (the FIR pass's) and
// csrc/fengine_ct_stops_dft.cu (the DFT passes' and the three-pass route's),
// which compile in nvcc processes of their own.
// The FIR pass also carries the probe P2's first four stops, for K7's route
// (csrc/fengine_dit.cu: K7's first pass is this FIR pass on its frames with
// every start at 0), each into outputs [B, S, fft/2] and no plane:
//   STOP_DIT_DMA   — the copies of STOP_DMA; outr 0, outi the first sample
//                    of frame f0 = s - s % 16 (P2's s_blk);
//   STOP_DIT_CONV  — the same copies converted to f32 and summed; outi the
//                    first samples of frames f0 and f0 + 1, added;
//   STOP_DIT_FIR   — STOP_FIR's outputs without the plane;
//   STOP_DIT_DEINT — the FIR rounded to bf16, split: sample 2m to outr[m],
//                    2m + 1 to outi[m].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
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
constexpr int STOP_DIT_DMA = 5, STOP_DIT_CONV = 6, STOP_DIT_FIR = 7, STOP_DIT_DEINT = 8;
constexpr int STOP_FIR_RND = 9, STOP_STAGEA_RND = 10;
// Spectra a DMA-stop probe serves: P5's s_blk.
constexpr int ABLATE_S_BLK = 16;

// int8 by truncation toward zero, saturated: the value cvt.rzi.sat.s8.f32
// gives.
__device__ __forceinline__ int8_t trunc_s8(float v) {
  return static_cast<int8_t>(max(-128, min(127, __float2int_rz(v))));
}

// A stop's outputs: two or four values at element i of out, int8 by
// truncation (QUANT) or f32.
template <bool QUANT>
__device__ __forceinline__ void stop_store2(void* out, long long i, float a, float b) {
  if constexpr (QUANT) {
    *reinterpret_cast<char2*>(static_cast<int8_t*>(out) + i) = make_char2(trunc_s8(a), trunc_s8(b));
  } else {
    *reinterpret_cast<float2*>(static_cast<float*>(out) + i) = make_float2(a, b);
  }
}

template <bool QUANT>
__device__ __forceinline__ void stop_store4(void* out, long long i, float4 v) {
  if constexpr (QUANT) {
    *reinterpret_cast<char4*>(static_cast<int8_t*>(out) + i) =
        make_char4(trunc_s8(v.x), trunc_s8(v.y), trunc_s8(v.z), trunc_s8(v.w));
  } else {
    *reinterpret_cast<float4*>(static_cast<float*>(out) + i) = v;
  }
}

// The same with the output type chosen at run time (the FIR pass's stops).
__device__ __forceinline__ void stop_store4(void* out, long long i, float4 v, bool f32) {
  if (f32) {
    stop_store4<false>(out, i, v);
  } else {
    stop_store4<true>(out, i, v);
  }
}

// v rounded to bf16 (round-to-nearest-even), as f32.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ---------------------------------------------------------------------------
// Pass 1: the FIR into the plane
// ---------------------------------------------------------------------------
constexpr int FIR_THREADS = 128;                       // 4 lanes each
constexpr int FIR_TILE = 4 * FIR_THREADS;              // lanes a block
constexpr int FIR_ROWS = 4;                            // frame rows a stage of the ring
constexpr int FIR_STAGES = 16;                         // stages of the ring (64 KB)
constexpr int FIR_SHORT_STAGES = 6;                    // the short-run body's (24 KB)
constexpr int FIR_SLOT = 8 * FIR_THREADS;              // bytes a row: two words a thread
constexpr int FIR_MAX_STREAMS = 256;                   // streams a block, at most
constexpr int FIR_SHORT = 4;                           // the short-run body's most spectra a run
// Blocks an SM: the 16-row register ring and the window take about 200
// registers a thread, so two; the smaller ring bodies fit three (64 KB
// each), the short-run bodies four or five (24 KB each).
constexpr int FIR_BLOCKS = 2;

// A FIR launch: the shape and the wrapper's plan (ops/fengine_fused.py:
// _fir_plan): a block takes FIR_TILE lanes of `run` spectra of each of
// `streams` streams.
struct FirShape {
  long long batch_stride;  // samples between streams
  int batch, n_spectra, fft, n_taps;
  int run, streams;
  int lane_blocks, runs;
  int probe_n2;  // the stops': N2, the row length of the frame view (STOP_DMA's probe)
  bool f32_out;  // STOP_FIR_RND's outputs f32, else int8 (STOP_DMA's: its PT)
};

// The stops that run the body's copies and nothing of its arithmetic.
__host__ __device__ constexpr bool fir_copies_only(int stop) {
  return stop == STOP_DMA || stop == STOP_DIT_DMA || stop == STOP_DIT_CONV;
}

// The ring's stages for a body: the short-run body reads at most FIR_SHORT
// + 15 rows a stream, so a ring of 6 stages copies a stream's rows ahead
// and leaves room for more blocks an SM (faster at fft 2^22 and 2^23 than
// 9, 12 or 16 stages on the card).
__host__ __device__ constexpr int fir_stages(bool short_run) {
  return short_run ? FIR_SHORT_STAGES : FIR_STAGES;
}

// Dynamic shared memory of a body: the ring, or none for the long body.
__host__ __device__ constexpr int fir_smem_bytes(int maxt, int stop, bool short_run) {
  return maxt > 0 || fir_copies_only(stop) ? fir_stages(short_run) * FIR_ROWS * FIR_SLOT : 0;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 4 int8 samples of a word, as f32.
__device__ __forceinline__ float4 bytes4(uint32_t v) {
  return make_float4(static_cast<float>(static_cast<int8_t>(v)),
                     static_cast<float>(static_cast<int8_t>(v >> 8)),
                     static_cast<float>(static_cast<int8_t>(v >> 16)),
                     static_cast<float>(static_cast<int8_t>(v >> 24)));
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

// 4 FIR sums into the plane by a streaming store: rounded to bf16 (8
// bytes), or the f32 sums themselves (16 bytes).
__device__ __forceinline__ void store_plane4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  __stcs(reinterpret_cast<uint2*>(p), make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                                 *reinterpret_cast<const uint32_t*>(&hi)));
}
__device__ __forceinline__ void store_plane4(float* p, float4 v) {
  __stcs(reinterpret_cast<float4*>(p), v);
}

// The FIR stop's int8 of 4 f32 sums, by truncation (4-byte aligned).
__device__ __forceinline__ void store_trunc4(int8_t* p, float4 v) {
  *reinterpret_cast<char4*>(p) = make_char4(trunc_s8(v.x), trunc_s8(v.y), trunc_s8(v.z),
                                            trunc_s8(v.w));
}

// P2's deint stop: 4 f32 sums of samples 2m .. 2m + 3 rounded to bf16 and
// truncated, the even ones to e[0..1], the odd ones to o[0..1].
__device__ __forceinline__ void store_deint4(int8_t* e, int8_t* o, float4 v) {
  auto r = [](float x) { return trunc_s8(__bfloat162float(__float2bfloat16_rn(x))); };
  *reinterpret_cast<char2*>(e) = make_char2(r(v.x), r(v.z));
  *reinterpret_cast<char2*>(o) = make_char2(r(v.y), r(v.w));
}

// Where one stream's output goes: its plane rows at this thread's lanes, and
// for a stop its place in outr and outi.
template <int STOP, typename PT>
struct FirOut {
  PT* ob;       // spectrum s at ob + s * fft
  int8_t* oq;   // the stops': spectrum s at oq + s * (fft / 2) (bytes: int8 outputs)
  int8_t* oq2;
  void* vr;     // STOP_FIR_RND's: spectrum s at element vo + s * (fft / 2) of vr, vi
  void* vi;
  long long vo;
  bool f32;

  __device__ __forceinline__ FirOut(PT* plane, int8_t* outr, int8_t* outi, const FirShape& sh,
                                    long long b, int lane)
      : ob(plane + b * sh.n_spectra * static_cast<long long>(sh.fft) + lane),
        oq(nullptr), oq2(nullptr), vr(nullptr), vi(nullptr), vo(0), f32(sh.f32_out) {
    const int half = sh.fft / 2;
    const long long o = b * sh.n_spectra * static_cast<long long>(half);
    if constexpr (STOP == STOP_FIR || STOP == STOP_DIT_FIR) {
      oq = lane < half ? outr + o + lane : outi + o + lane - half;
    }
    if constexpr (STOP == STOP_DIT_DEINT) {
      oq = outr + o + lane / 2;
      oq2 = outi + o + lane / 2;
    }
    if constexpr (STOP == STOP_FIR_RND) {
      if (lane < half) {
        vr = outr;
        vi = outi;
        vo = o + lane;
      }
    }
  }

  // What the pass stores for spectrum s at its STOP: the plane (K1, the
  // fir stops), the f32 sums' halves (P5's and P2's fir), the sums rounded
  // to the plane's type (the reference's fir), P2's even / odd split.
  __device__ __forceinline__ void store(long long s, long long fft, float4 acc) const {
    if constexpr (STOP == STOP_NONE || STOP == STOP_FIR || STOP == STOP_FIR_RND) {
      store_plane4(ob + s * fft, acc);
    }
    if constexpr (STOP == STOP_FIR || STOP == STOP_DIT_FIR) store_trunc4(oq + s * (fft / 2), acc);
    if constexpr (STOP == STOP_FIR_RND) {
      if (vr) {
        float4 v = acc;
        if constexpr (std::is_same<PT, __nv_bfloat16>::value) {
          v = make_float4(round_bf16(acc.x), round_bf16(acc.y), round_bf16(acc.z),
                          round_bf16(acc.w));
        }
        stop_store4(vr, vo + s * (fft / 2), v, f32);
        stop_store4(vi, vo + s * (fft / 2), v, f32);
      }
    }
    if constexpr (STOP == STOP_DIT_DEINT) {
      store_deint4(oq + s * (fft / 2), oq2 + s * (fft / 2), acc);
    }
  }
};

// A thread's 4 samples of a row from its aligned words: w0 alone where the
// stream is aligned, else the word after it joined on (the funnel shift).
__device__ __forceinline__ uint32_t join(uint32_t w0, uint32_t w1, int shift) {
  return __funnelshift_r(w0, w1, 8 * shift);
}

// The block's frame rows in shared memory. For each of its streams in turn
// the block reads rows s0 .. s0 + R - 1; stream j's row s0 + q is virtual
// row v = j·RV + q (RV: R rounded up to whole stages, so no stage spans two
// streams), and lives in slot v % (STAGES·FIR_ROWS) while it is in the
// ring. Stage k holds virtual rows k·FIR_ROWS ..; it is copied STAGES - 1 stages
// before it is read, by a cursor that walks the streams' rows in order.
// Each thread copies its own 8 bytes of a slot with cp.async (the aligned
// word under its 4 samples, and the word after it where the stream's start
// is not 4-byte aligned: one more 4-byte copy a row, and no byte loads) and
// reads only what it copied, so the ring needs no barrier.
template <int STAGES>
struct FirRing {
  const int8_t* x;
  const long long* first;  // shared: stream j's first sample at x + first[j]
  int fft, lane, s0, r, rv, stages;
  unsigned char* slot0;  // this thread's 8 bytes of slot 0
  // The copy cursor: stream cj's row s0 + cq is the next to copy, from
  // crow + cq·fft (its aligned word), two words a row where ctwo.
  int cj, cq;
  const int8_t* crow;
  bool ctwo;
  int rshift;  // the reader's stream: its start % 4

  // Stream j's first sample at this thread's lanes: the aligned word at or
  // below it, and its byte offset in that word (0 .. 3).
  __device__ __forceinline__ int shift_of(int j) const {
    return static_cast<int>(reinterpret_cast<uintptr_t>(x + first[j] + lane) & 3);
  }

  __device__ __forceinline__ void seek(int j) {
    cj = j;
    cq = 0;
    const int sh = shift_of(j);
    crow = x + first[j] + lane - sh + static_cast<long long>(s0) * fft;
    ctwo = sh != 0;
  }

  __device__ __forceinline__ void issue(int k) {
    if (k < stages) {
      if (cq == rv) seek(cj + 1);
      const uint32_t dst = smem_u32(slot0 + (k % STAGES) * FIR_ROWS * FIR_SLOT);
#pragma unroll
      for (int i = 0; i < FIR_ROWS; ++i) {
        if (cq + i < r) {
          const int8_t* src = crow + static_cast<long long>(cq + i) * fft;
          cp_async4(dst + i * FIR_SLOT, src);
          if (ctwo) cp_async4(dst + i * FIR_SLOT + 4, src + 4);
        }
      }
      cq += FIR_ROWS;
    }
    cp_async_commit();  // one group a stage, even an empty one
  }

  __device__ __forceinline__ void prologue() {
    seek(0);
    for (int k = 0; k < STAGES - 1; ++k) issue(k);
  }

  // The reader turns to stream j.
  __device__ __forceinline__ void begin(int j) { rshift = shift_of(j); }

  // Virtual row v's 4 samples (v read in order, each once). At a stage's
  // first row (`first_row`, v % FIR_ROWS == 0): copy the stage STAGES - 1
  // ahead into the slots of the stage before (read), then wait for this one.
  __device__ __forceinline__ uint32_t word(int v, bool first_row) {
    if (first_row) {
      issue(v / FIR_ROWS + STAGES - 1);
      cp_async_wait<STAGES - 1>();
    }
    const uint2 u =
        *reinterpret_cast<const uint2*>(slot0 + (v % (STAGES * FIR_ROWS)) * FIR_SLOT);
    return join(u.x, u.y, rshift);
  }
};

// The ring body: MAXT = 4, 8 or 16 rows of register ring, the block's
// streams one after another. Each row goes from the ring into the register
// ring once, converted to f32 once; at output s the register ring holds rows
// s .. s + MAXT - 1 (row s0 + q in register slot q % MAXT). A whole chunk of
// MAXT outputs of a MAXT-tap pass runs with no row, tap or output guard, its
// ragged tail with the output guard alone; fewer taps take the guarded step.
template <int MAXT, int STOP, typename PT, typename Ring>
__device__ __forceinline__ void fir_ring_body(Ring& ring, const float* __restrict__ win,
                                              PT* __restrict__ plane, int8_t* __restrict__ outr,
                                              int8_t* __restrict__ outi, const FirShape& sh,
                                              int b0, int s1, int nb) {
  const long long fft = sh.fft;
  const int lane = ring.lane, s0 = ring.s0, r = ring.r;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 wr[MAXT];
#pragma unroll
  for (int t = 0; t < MAXT; ++t) {
    wr[t] = t < sh.n_taps ? __ldg(reinterpret_cast<const float4*>(win + t * fft + lane)) : zero;
  }
  ring.prologue();
  const bool full_taps = sh.n_taps == MAXT;
  for (int j = 0; j < nb; ++j) {
    const int vb = j * ring.rv;
    ring.begin(j);
    const FirOut<STOP, PT> out(plane, outr, outi, sh, b0 + j, lane);
    float4 xr[MAXT];
#pragma unroll
    for (int q = 0; q < MAXT - 1; ++q) {
      xr[q] = q < r ? bytes4(ring.word(vb + q, q % FIR_ROWS == 0)) : zero;
    }
    // Output s + i: row s + i + MAXT - 1 into the register ring, then the
    // taps in order. s - s0 is a multiple of MAXT, so the row's place in its
    // stage is a constant.
    auto step = [&](int s, int i, auto full) {
      constexpr bool FULL = decltype(full)::value;
      const int q = s - s0 + i + MAXT - 1;
      const bool first = (i + MAXT - 1) % FIR_ROWS == 0;
      xr[(i + MAXT - 1) % MAXT] = FULL || q < r ? bytes4(ring.word(vb + q, first)) : zero;
      float4 acc = mul4(xr[i], wr[0]);
#pragma unroll
      for (int t = 1; t < MAXT; ++t) {
        if (FULL || t < sh.n_taps) acc = mac4(acc, xr[(i + t) % MAXT], wr[t]);
      }
      out.store(s + i, fft, acc);
    };
    for (int s = s0; s < s1; s += MAXT) {
      if (full_taps && s + MAXT <= s1) {
#pragma unroll
        for (int i = 0; i < MAXT; ++i) step(s, i, std::true_type{});
      } else if (full_taps) {  // the tail of a MAXT-tap pass: every row it reads exists
#pragma unroll
        for (int i = 0; i < MAXT; ++i) {
          if (s + i < s1) step(s, i, std::true_type{});
        }
      } else {
#pragma unroll
        for (int i = 0; i < MAXT; ++i) {
          if (s + i < s1) step(s, i, std::false_type{});
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block
}

// The short-run body (runs of at most FIR_SHORT spectra: fft 2^22 and up at
// the flagship's sample count, S = 2 to 4), the block's streams one after
// another. Each row, once read and converted, adds its product to each
// output of the run it feeds (output o takes row q as tap q - o, so each
// sum's taps still come in order), so a stream's rows need no register
// ring and no priming, and the run's outputs give independent sums.
template <int MAXT, int STOP, typename PT, typename Ring>
__device__ __forceinline__ void fir_short_body(Ring& ring, const float* __restrict__ win,
                                               PT* __restrict__ plane,
                                               int8_t* __restrict__ outr,
                                               int8_t* __restrict__ outi, const FirShape& sh,
                                               int b0, int s1, int nb) {
  const long long fft = sh.fft;
  const int lane = ring.lane, s0 = ring.s0, r = ring.r, run = s1 - s0;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 wr[MAXT];
#pragma unroll
  for (int t = 0; t < MAXT; ++t) {
    wr[t] = t < sh.n_taps ? __ldg(reinterpret_cast<const float4*>(win + t * fft + lane)) : zero;
  }
  ring.prologue();
  // One stream's run; FULL: MAXT taps, so no tap guard.
  auto stream = [&](int j, auto full) {
    constexpr bool FULL = decltype(full)::value;
    const int vb = j * ring.rv;
    ring.begin(j);
    float4 acc[FIR_SHORT];
#pragma unroll
    for (int q = 0; q < FIR_SHORT + MAXT - 1; ++q) {
      if (q < r) {
        const float4 xq = bytes4(ring.word(vb + q, q % FIR_ROWS == 0));
#pragma unroll
        for (int o = 0; o < FIR_SHORT; ++o) {
          const int t = q - o;
          if (t >= 0 && t < MAXT && o < run && (FULL || t < sh.n_taps)) {
            acc[o] = t == 0 ? mul4(xq, wr[0]) : mac4(acc[o], xq, wr[t]);
          }
        }
      }
    }
    const FirOut<STOP, PT> out(plane, outr, outi, sh, b0 + j, lane);
#pragma unroll
    for (int o = 0; o < FIR_SHORT; ++o) {
      if (o < run) out.store(s0 + o, fft, acc[o]);
    }
  };
  if (sh.n_taps == MAXT) {
    for (int j = 0; j < nb; ++j) stream(j, std::true_type{});
  } else {
    for (int j = 0; j < nb; ++j) stream(j, std::false_type{});
  }
  cp_async_wait<0>();  // no copy outlives the block
}

// The long body (more than 16 taps): every tap's row from global memory
// through the same aligned words, the window from global memory; the same
// sums in the same order. Not on any timed path.
template <int STOP, typename PT>
__device__ __forceinline__ void fir_long_body(const int8_t* __restrict__ x,
                                              const long long* first,
                                              const float* __restrict__ win,
                                              PT* __restrict__ plane, int8_t* __restrict__ outr,
                                              int8_t* __restrict__ outi, const FirShape& sh,
                                              int lane, int b0, int s0, int s1, int nb) {
  const long long fft = sh.fft, words = sh.fft / 4;
  for (int j = 0; j < nb; ++j) {
    const int8_t* p = x + first[j] + lane;
    const int shift = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 3);
    const uint32_t* w0 = reinterpret_cast<const uint32_t*>(p - shift);
    const FirOut<STOP, PT> out(plane, outr, outi, sh, b0 + j, lane);
    auto row = [&](long long q) {
      const uint32_t* w = w0 + q * words;
      return bytes4(shift ? join(__ldg(w), __ldg(w + 1), shift) : __ldg(w));
    };
    for (int s = s0; s < s1; ++s) {
      float4 acc = mul4(row(s), __ldg(reinterpret_cast<const float4*>(win + lane)));
      for (int t = 1; t < sh.n_taps; ++t) {
        acc = mac4(acc, row(s + t), __ldg(reinterpret_cast<const float4*>(win + t * fft + lane)));
      }
      out.store(s, fft, acc);
    }
  }
}

// The frames a STOP_DMA probe spans from its block's first: its [N2/2, N1]
// corner of the [rows, N2] view reads rows < N2/2 (N2 / (2 N1) frames where
// N1 < N2, else one).
__host__ __device__ constexpr int dma_frames(int fft, int n2) {
  return static_cast<int>((static_cast<long long>(n2 / 2) * n2 + fft - 1) / fft);
}

// The copies-only stops over the block's streams: each row the ring body
// reads, copied into the ring and read from it once. STOP_DMA (the
// reference's dma, P5, P4) stores each word that lies in a block's probe
// (the head of the file) to both outputs of the block's 16 spectra, int8 as
// it is or as f32; STOP_DIT_DMA (P2) XORs the words,
// STOP_DIT_CONV converts them to f32 and sums, then both store for each
// spectrum s outr 0 and outi the first sample of frame f0 = s - s % 16
// (CONV: plus frame f0 + 1's, truncated). The words' XOR or sum is stored
// under a condition that never holds but that the compiler cannot see
// through (n_spectra < 0), so no copy is dropped. F32_STORES: STOP_DMA's
// outputs f32 (its instantiation with PT = float), else int8; a body of its
// own each, so that the int8 body carries no f32 stores.
template <int STOP, bool F32_STORES, typename Ring>
__device__ __forceinline__ void fir_copies(Ring& ring, int8_t* __restrict__ outr,
                                           int8_t* __restrict__ outi, const FirShape& sh,
                                           int b0, int s1, int nb) {
  const long long fft = sh.fft, half = sh.fft / 2;
  const int lane = ring.lane, s0 = ring.s0;
  // STOP_DMA's probe: rows of N2 = 2^pl samples, of which the first N1 lanes
  // (pn1), over the first `probe` samples from the block's first frame. A
  // lane's word of 4 samples lies wholly inside the probe's lanes or wholly
  // outside them; at frame d of the block it is output d * N1 * N1 + lo.
  const int pl = STOP == STOP_DMA ? __ffs(sh.probe_n2) - 1 : 0, pmask = (1 << pl) - 1;
  const int pn1 = sh.fft >> pl, probe = (sh.probe_n2 / 2) << pl;
  const bool in_lane = (lane & pmask) < pn1;
  const int lo = (lane >> pl) * pn1 + (lane & pmask);
  uint32_t seen = 0;
  float sum = 0.f;
  ring.prologue();
  for (int j = 0; j < nb; ++j) {
    const long long b = b0 + j;
    const int vb = j * ring.rv;
    ring.begin(j);
    const long long o = b * sh.n_spectra * half;
    for (int q = 0; q < ring.r; ++q) {
      const uint32_t v = ring.word(vb + q, q % FIR_ROWS == 0);
      if constexpr (STOP == STOP_DIT_CONV) {
#pragma unroll
        for (int k = 0; k < 4; ++k) sum += static_cast<float>(static_cast<int8_t>(v >> (8 * k)));
      } else {
        seen ^= v;
      }
      if constexpr (STOP == STOP_DMA) {
        // Frame row = s0 + q is frame d of block f0's probe.
        const int row = s0 + q, d = row & (ABLATE_S_BLK - 1), f0 = row - d;
        if (in_lane && f0 < s1 && d * sh.fft + lane < probe) {
          const long long oi = o + d * pn1 * pn1 + lo;
          // The block's 16 spectra, unrolled: a loop to min(s1, f0 + 16)
          // stayed rolled, one store pair in flight at a time.
#pragma unroll
          for (int k = 0; k < ABLATE_S_BLK; ++k) {
            const long long s = f0 + k;
            if (s < s1) {
              if constexpr (F32_STORES) {
                stop_store4<false>(outr, oi + s * half, bytes4(v));
                stop_store4<false>(outi, oi + s * half, bytes4(v));
              } else {
                *reinterpret_cast<uint32_t*>(outr + oi + s * half) = v;
                *reinterpret_cast<uint32_t*>(outi + oi + s * half) = v;
              }
            }
          }
        }
      }
    }
    if constexpr (STOP != STOP_DMA) {
      if (lane < half) {
        const int8_t* xs = ring.x + ring.first[j];
        for (long long s = s0; s < s1; ++s) {
          const long long f0 = s - s % ABLATE_S_BLK;
          int8_t probe_v = __ldg(xs + f0 * fft);
          if constexpr (STOP == STOP_DIT_CONV) {
            probe_v = trunc_s8(static_cast<float>(probe_v) +
                               static_cast<float>(__ldg(xs + (f0 + 1) * fft)));
          }
          *reinterpret_cast<uint32_t*>(outr + o + lane + s * half) = 0u;
          *reinterpret_cast<uint32_t*>(outi + o + lane + s * half) =
              static_cast<uint8_t>(probe_v) * 0x01010101u;
        }
      }
    }
  }
  if (sh.n_spectra < 0) *reinterpret_cast<uint32_t*>(outr) = seen ^ __float_as_uint(sum);
  cp_async_wait<0>();
}

// K1's FIR pass (and K7's first pass): a block takes FIR_TILE lanes of a
// run of spectra of each of its streams. MAXT: the register ring's rows (4,
// 8, 16), or 0 for the long body; SHORT: the short-run body for the same
// taps. PT: the plane's element, bf16 (STOP_NONE or a stop) or float (f32
// DFT operands: the exact f32 sums, STOP_NONE only). The stops write outr,
// outi; K1 itself passes them null.
template <int MAXT, int STOP = STOP_NONE, typename PT = __nv_bfloat16, bool SHORT = false>
__global__ void __launch_bounds__(FIR_THREADS, FIR_BLOCKS)
    k1_fir_kernel(const int8_t* __restrict__ x, const long long* __restrict__ starts,
                  const float* __restrict__ win, PT* __restrict__ plane,
                  int8_t* __restrict__ outr, int8_t* __restrict__ outi, FirShape sh) {
  extern __shared__ __align__(16) unsigned char fir_smem[];
  __shared__ long long first[FIR_MAX_STREAMS];  // stream j's first sample at x + first[j]
  long long bid = blockIdx.x;
  const int lb = static_cast<int>(bid % sh.lane_blocks);
  bid /= sh.lane_blocks;
  const int run = static_cast<int>(bid % sh.runs);
  const int b0 = static_cast<int>(bid / sh.runs) * sh.streams;
  const int nb = min(sh.streams, sh.batch - b0);
  for (int j = threadIdx.x; j < nb; j += FIR_THREADS) {
    first[j] = (b0 + j) * sh.batch_stride + __ldg(starts + b0 + j);
  }
  __syncthreads();
  const int lane = lb * FIR_TILE + 4 * static_cast<int>(threadIdx.x);
  if (lane >= sh.fft) return;  // no barrier waits for this thread from here on
  const int s0 = run * sh.run, s1 = min(sh.n_spectra, s0 + sh.run);
  if constexpr (MAXT == 0 && !fir_copies_only(STOP)) {
    fir_long_body<STOP>(x, first, win, plane, outr, outi, sh, lane, b0, s0, s1, nb);
  } else {
    int r = s1 - s0 + sh.n_taps - 1;  // rows a stream's run reads
    if constexpr (STOP == STOP_DMA) {  // and the last block's probe (the wrapper checks it exists)
      r = max(r, (s1 - 1) / ABLATE_S_BLK * ABLATE_S_BLK - s0 + dma_frames(sh.fft, sh.probe_n2));
    }
    const int rv = (r + FIR_ROWS - 1) / FIR_ROWS * FIR_ROWS;
    FirRing<fir_stages(SHORT)> ring{x, first, sh.fft, lane, s0, r, rv, nb * rv / FIR_ROWS,
                 fir_smem + 8 * threadIdx.x, 0, 0, nullptr, false, 0};
    if constexpr (fir_copies_only(STOP)) {
      fir_copies<STOP, std::is_same<PT, float>::value>(ring, outr, outi, sh, b0, s1, nb);
    } else if constexpr (SHORT) {
      fir_short_body<MAXT, STOP>(ring, win, plane, outr, outi, sh, b0, s1, nb);
    } else {
      fir_ring_body<MAXT, STOP>(ring, win, plane, outr, outi, sh, b0, s1, nb);
    }
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
  int sb, n_sblk;               // spectra a unit (1, or 16 at N1 = 8); blocks of them a batch
  int n_units;                  // G * n_sblk * n_chunks
  int slot;                     // bf16 elements per ring slot
  int stages;                   // ring depth: 3 or 4
};

// T rows of a unit at N1 = 8: 16 spectra of 8 k1 rows, side by side.
constexpr int KC_N8 = 128;

// The tile shapes of a KC-row chunk. Stage A: warps MW x NW, each WM k1 rows
// (cos and -sin) x 32 n2 columns: NA columns a tile (at N1 = 8: WM rows are
// 4 spectra's 8 k1 rows). Stage B: warps (16 / NWB) x NWB, each 32 k2 rows
// x 16 k1 columns: MB rows a tile.
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
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

// d = a (16x8, row) * b (8x8, col), bf16 in, f32 out: the MMA's 8-product
// sums alone (N1 = 8's stage A: one MMA a sum).
__device__ __forceinline__ void mma1688(float* d, uint32_t a0, uint32_t a1, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %7, %7, %7};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(b), "f"(0.f));
}

// log2 of a power of two.
__device__ __forceinline__ int lg(int v) { return __ffs(v) - 1; }

// A walk through this block's tile sequence: unit i of the block (unit
// blockIdx.x + i * gridDim.x), tile `local` of the unit; the unit's
// (batch, spectra, chunk) only changes every tpu tiles.
struct Cursor {
  int i, local;
  int b, s, k0;  // s: the unit's first spectrum; k0: the chunk's first k1 row
};

template <int KC>
__device__ __forceinline__ void set_unit(const DftParams& p, Cursor& c) {
  const int u = blockIdx.x + c.i * gridDim.x;
  c.k0 = (u & (p.n_chunks - 1)) * KC;
  const int rest = u >> lg(p.n_chunks);
  c.s = (rest % p.n_sblk) * p.sb;
  c.b = rest / p.n_sblk;
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
  if (KC == KC_N8 && w.stage_a) {
    // [KC x cols] of the plane: the unit's spectra, 8 rows each (their
    // N1-point matrix is in registers). Spectra past the stream's last are
    // not loaded (their T columns are never stored).
    const int lx = lg(min(S::NA, n2) / 8), nx = KC << lx;
    const int rows = min(KC, (p.n_spectra - c.s) * 8);
    const bf16* xsrc = p.plane + (static_cast<long long>(c.b) * p.n_spectra + c.s) * 8 * n2 +
                       w.outer * S::NA;
    for (int i = tid; i < nx; i += DFT_THREADS) {
      const int r = i >> lx, q = i & ((1 << lx) - 1);
      if (r < rows) {
        cp_async16(slot + r * (S::NA + PAD) + q * 8, xsrc + static_cast<long long>(r) * n2 + q * 8);
      }
    }
  } else if (w.stage_a) {
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
  constexpr bool N8 = KC == KC_N8;  // N1 = 8: T rows are (spectrum, k1)
  static_assert(!N8 || STOP == STOP_NONE, "the stops take the N1 = N2 plans only");
  static_assert(STOP != STOP_STAGEA || QUANT, "P5's stagea writes int8");
  constexpr bool STAGEA_STOP = STOP == STOP_STAGEA || STOP == STOP_STAGEA_RND;
  // The stop bodies load each twiddle pair where they use it (see below).
  constexpr bool LATE_TW = STOP != STOP_NONE;
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
  // Stage A: [cos/sin][MI][4 n8][4] (N1 = 8: [4 spectra][4 n8][4], the
  // m16n8k8 tile's rows g the cos sums and g + 8 the -sin sums of k1 = g);
  // stage B: [4 sums][2 m16][2 n8][4], sums cos.tr, -sin.ti, cos.ti, -sin.tr.
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
      if constexpr (N8) {
        // The [cos; -sin] [16 x 8] A fragment of m16n8k8 (row g of each,
        // from L1), against the warp's 4 spectra, 8 rows each, x 4 column
        // tiles of 8.
        const uint32_t a0 = __ldg(reinterpret_cast<const unsigned int*>(p.d1c + g * 8 + tig * 2));
        const uint32_t a1 = __ldg(reinterpret_cast<const unsigned int*>(p.d1s + g * 8 + tig * 2));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t fb[4];
          ldsm_x4_t(fb, sX + (a_r0 + j * 8 + lane % 8) * xld + a_c0 + (lane / 8) * 8);
#pragma unroll
          for (int m = 0; m < 4; ++m) mma1688(acc + (j * 4 + m) * 4, a0, a1, fb[m]);
        }
      }
      for (int kk = 0; !N8 && kk < kt; kk += 16) {
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
        // (The stagea stops write T's rows k1 < N1/2 instead: whole chunks,
        // since every plan's KC (64, 32, 16) divides N1/2 at N1 = N2, from
        // one base: element (b, s, k0 + r, n) at o + r * N2 + n.)
        if constexpr (N8) {
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int n = col + m * 8 + tig * 2;
            const float2 c = __ldg(reinterpret_cast<const float2*>(p.twc + g * n2 + n));
            const float2 sn = __ldg(reinterpret_cast<const float2*>(p.tws + g * n2 + n));
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float* a = acc + (j * 4 + m) * 4;  // ar, ar, ai, ai of k1 = g
              const int r = a_r0 + j * 8 + g;
              *reinterpret_cast<__nv_bfloat162*>(sTr + r * tld + n) = __floats2bfloat162_rn(
                  __fsub_rn(__fmul_rn(a[0], c.x), __fmul_rn(a[2], sn.x)),
                  __fsub_rn(__fmul_rn(a[1], c.y), __fmul_rn(a[3], sn.y)));
              *reinterpret_cast<__nv_bfloat162*>(sTi + r * tld + n) = __floats2bfloat162_rn(
                  __fadd_rn(__fmul_rn(a[0], sn.x), __fmul_rn(a[2], c.x)),
                  __fadd_rn(__fmul_rn(a[1], sn.y), __fmul_rn(a[3], c.y)));
            }
          }
          continue;
        }
        long long stop_o = 0;
        if constexpr (STAGEA_STOP) {
          if (k0 >= n1 / 2) continue;
          stop_o = (static_cast<long long>(cc.b) * p.n_spectra + cc.s) * C +
                   static_cast<long long>(k0) * n2;
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
              if constexpr (!LATE_TW) {
                wc[j][hh] = __ldg(reinterpret_cast<const float2*>(p.twc + o));
                ws[j][hh] = __ldg(reinterpret_cast<const float2*>(p.tws + o));
              }
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
              float2 c = wc[j][hh], sn = ws[j][hh];
              if constexpr (LATE_TW) {
                // The stop bodies load each twiddle pair where they use it
                // (wc, ws stay unset): loaded together, as above, the stagea
                // bodies spilled 24 bytes, and the stageb bodies more than
                // with these loads. The values are the same; only the loads'
                // order differs.
                const long long o2 = static_cast<long long>(k0 + a_r0 + i * 16 + g + hh * 8) * n2 +
                                     col + j * 8 + tig * 2;
                c = __ldg(reinterpret_cast<const float2*>(p.twc + o2));
                sn = __ldg(reinterpret_cast<const float2*>(p.tws + o2));
              }
              const float tr0 = __fsub_rn(__fmul_rn(cr[0], c.x), __fmul_rn(ci[0], sn.x));
              const float tr1 = __fsub_rn(__fmul_rn(cr[1], c.y), __fmul_rn(ci[1], sn.y));
              const float ti0 = __fadd_rn(__fmul_rn(cr[0], sn.x), __fmul_rn(ci[0], c.x));
              const float ti1 = __fadd_rn(__fmul_rn(cr[1], sn.y), __fmul_rn(ci[1], c.y));
              if constexpr (STOP == STOP_STAGEA) {
                // P5's slice of T, before the rounding: rows k1 < N1/2.
                stop_store2<true>(p.outr, stop_o + r * n2 + n, tr0, tr1);
                stop_store2<true>(p.outi, stop_o + r * n2 + n, ti0, ti1);
              } else if constexpr (STOP == STOP_STAGEA_RND) {
                // The reference's slice: the rounded T, rows k1 < N1/2.
                stop_store2<QUANT>(p.outr, stop_o + r * n2 + n, round_bf16(tr0), round_bf16(tr1));
                stop_store2<QUANT>(p.outi, stop_o + r * n2 + n, round_bf16(ti0), round_bf16(ti1));
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
    } else if constexpr (!STAGEA_STOP) {  // (a stagea stop has no stage-B tiles)
      const int row = w.outer * S::MB + b_r0;  // first k2 row of the warp
      if (row >= h) continue;
      if (w.kidx == 0) {
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      }
      const int ktb = p.ktb, ktp = ktb + PAD;
      const bf16* sC = slot;
      const bf16* sS = slot + S::MB * ktp;
      if constexpr (STOP == STOP_STAGEB) {
        // The stageb stop bodies run stage B's steps through this lambda,
        // two an iteration: written as the pass's loop below, rolled or
        // not, they spilled. This form spills nothing, and runs stage B a
        // little slower than that loop (PERF.md §6).
        auto step = [&](int kk) {
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
        };
#pragma unroll 2
        for (int kk = 0; kk < ktb; kk += 16) step(kk);
      } else {
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
      }
      if constexpr (STOP == STOP_STAGEB) {
        if (w.kidx != p.n_ktb - 1) continue;
        // re, im without the rotation, truncated or f32.
        const long long obase = (static_cast<long long>(cc.b) * p.n_spectra + cc.s) * C;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const float* a0 = acc + (i * 2 + j) * 4 + hh * 2;
              const int ch = (row + i * 16 + g + hh * 8) * n1 + k0 + b_c0 + j * 8 + tig * 2;
              stop_store2<QUANT>(p.outr, obase + ch, __fsub_rn(a0[0], a0[16]),
                                 __fsub_rn(a0[1], a0[17]));
              stop_store2<QUANT>(p.outi, obase + ch, __fadd_rn(a0[32], a0[48]),
                                 __fadd_rn(a0[33], a0[49]));
            }
          }
        }
      } else if (w.kidx == p.n_ktb - 1) {
        // re = cos.tr - (-sin.ti), im = cos.ti + (-sin.tr); rotate; store.
        // The rotation planes' values are loaded together first. T column
        // b_c0 + j * 8 + e is k1 row k0 + that of spectrum cc.s, or (N1 = 8)
        // k1 = tig * 2 + e of spectrum cc.s + b_c0 / 8 + j.
        const long long obase = (static_cast<long long>(cc.b) * p.n_spectra + cc.s) * C;
        int kcol[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) kcol[j] = N8 ? tig * 2 : k0 + b_c0 + j * 8 + tig * 2;
        const float* rc_b = p.rotc + static_cast<long long>(cc.b) * C;
        const float* rs_b = p.rots + static_cast<long long>(cc.b) * C;
        float2 rc[2][2][2], rs[2][2][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int ch = (row + i * 16 + g + hh * 8) * n1 + kcol[j];
              rc[i][j][hh] = __ldg(reinterpret_cast<const float2*>(rc_b + ch));
              rs[i][j][hh] = __ldg(reinterpret_cast<const float2*>(rs_b + ch));
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int sp = N8 ? b_c0 / 8 + j : 0;  // the column's spectrum in the unit
            if (N8 && cc.s + sp >= p.n_spectra) continue;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const float* a0 = acc + (i * 2 + j) * 4 + hh * 2;
              const long long o = obase + static_cast<long long>(sp) * C +
                                  (row + i * 16 + g + hh * 8) * n1 + kcol[j];
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
                *reinterpret_cast<char2*>(static_cast<int8_t*>(p.outr) + o) =
                    make_char2(requant(v[0][0]), requant(v[0][1]));
                *reinterpret_cast<char2*>(static_cast<int8_t*>(p.outi) + o) =
                    make_char2(requant(v[1][0]), requant(v[1][1]));
              } else {
                *reinterpret_cast<float2*>(static_cast<float*>(p.outr) + o) =
                    make_float2(v[0][0], v[0][1]);
                *reinterpret_cast<float2*>(static_cast<float*>(p.outi) + o) =
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
// Deeper tiles mean fewer barriers a unit. KC_N8 is N1 = 8's plan: 16
// spectra a unit, stage A one 8-deep tile of their whole planes.
template <int KC>
size_t dft_plan(DftParams& p) {
  using S = Shape<KC>;
  constexpr bool N8 = KC == KC_N8;
  if (N8 ? p.n1 != 8 : KC > p.n1) return 0;
  const size_t t_bytes = sizeof(bf16) * 2 * static_cast<size_t>(KC) * (p.n2 + PAD);
  for (int kt = 64; kt >= 16; kt /= 2) {
    if (kt > (N8 ? p.n2 : p.n1)) continue;
    const int kta = N8 ? 8 : kt;
    const int a_slot = N8 ? KC * (S::NA + PAD) : kt * (S::NA + PAD) + 2 * KC * (kt + PAD);
    const int b_slot = 2 * S::MB * (kt + PAD);
    for (int stages = 4; stages >= 3; --stages) {
      const size_t bytes = t_bytes + sizeof(bf16) * static_cast<size_t>(stages) *
                                         static_cast<size_t>(max(a_slot, b_slot));
      if (bytes > MAX_SMEM) continue;
      p.kt = kta;
      p.ktb = kt;
      p.slot = max(a_slot, b_slot);
      p.stages = stages;
      p.n_ca = (p.n2 + S::NA - 1) / S::NA;
      p.n_kta = p.n1 / kta;
      p.n_rb = (p.n2 / 2 + S::MB - 1) / S::MB;
      p.n_ktb = p.n2 / kt;
      p.n_chunks = N8 ? 1 : p.n1 / KC;
      p.sb = N8 ? KC / 8 : 1;
      p.n_sblk = (p.n_spectra + p.sb - 1) / p.sb;
      return bytes;
    }
  }
  return 0;
}

template <int KC, bool QUANT, int STOP = STOP_NONE>
cudaError_t launch_dft(DftParams p, int batch, size_t bytes, cudaStream_t stream) {
  auto kern = k1_dft_kernel<KC, QUANT, STOP>;
  if (STOP == STOP_STAGEA || STOP == STOP_STAGEA_RND) p.n_rb = 0;  // no stage-B tiles
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
  const long long units = static_cast<long long>(batch) * p.n_sblk * p.n_chunks;
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
// chunk whose T planes and ring fit (64 rows up to N2 = 256; KC_N8 at N1 =
// 8), or returns NO_PLAN (N2 >= 2048: the three-pass route's splits).
template <typename Fn>
int with_dft_plan(const DftParams& p, Fn fn) {
  DftParams q = p;
  size_t bytes;
  if (p.n1 == 8) {
    if ((bytes = dft_plan<KC_N8>(q))) return fn(std::integral_constant<int, KC_N8>{}, q, bytes);
    return NO_PLAN;
  }
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
// N2 = 1024 and at N1 = 8 (KTA = 8, the whole of a spectrum's stage A; SB =
// 8 at fft 1024). T planes take 64 KB; a ring slot 32 KB. N2 > 1024 has no
// plan: the three-pass route takes it (k1_dft_f32_attributes decides).
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

template <int KC, bool QUANT, int STOP = STOP_NONE>
__global__ void __launch_bounds__(F32_THREADS, 1) k1_dft_f32_kernel(F32Params p) {
  static_assert(STOP == STOP_NONE || STOP == STOP_STAGEA_RND || STOP == STOP_STAGEB,
                "the f32 pass's stops: stagea (f32 T needs no rounding), stageb");
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
            if constexpr (STOP == STOP_STAGEA_RND) {
              // T's rows k1 < N1/2 of the unit's spectra, at k1*N2 + n2 (KC
              // divides N1/2 at N1 = N2, so a chunk is wholly in or out).
              const int k1 = k0 + 4 * rg + i;
              if (k0 < n1 / 2 && cc.s0 + s < p.n_spectra) {
                const long long so =
                    (static_cast<long long>(cc.b) * p.n_spectra + cc.s0 + s) * C +
                    static_cast<long long>(k1) * n2 + n;
                stop_store4<QUANT>(p.outr, so, make_float4(tr[0], tr[1], tr[2], tr[3]));
                stop_store4<QUANT>(p.outi, so, make_float4(ti[0], ti[1], ti[2], ti[3]));
              }
            } else {
              const int o = t_at(s * KC + 4 * rg + i, n, n2);
              *reinterpret_cast<float4*>(sTr + o) = make_float4(tr[0], tr[1], tr[2], tr[3]);
              *reinterpret_cast<float4*>(sTi + o) = make_float4(ti[0], ti[1], ti[2], ti[3]);
            }
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
            if constexpr (STOP == STOP_STAGEB) {  // re, im without the rotation
              float4 re, im;
              re.x = __fsub_rn(acc[a * 4 + 0], acc[16 + a * 4 + 0]);
              re.y = __fsub_rn(acc[a * 4 + 1], acc[16 + a * 4 + 1]);
              re.z = __fsub_rn(acc[a * 4 + 2], acc[16 + a * 4 + 2]);
              re.w = __fsub_rn(acc[a * 4 + 3], acc[16 + a * 4 + 3]);
              im.x = __fadd_rn(acc[32 + a * 4 + 0], acc[48 + a * 4 + 0]);
              im.y = __fadd_rn(acc[32 + a * 4 + 1], acc[48 + a * 4 + 1]);
              im.z = __fadd_rn(acc[32 + a * 4 + 2], acc[48 + a * 4 + 2]);
              im.w = __fadd_rn(acc[32 + a * 4 + 3], acc[48 + a * 4 + 3]);
              stop_store4<QUANT>(p.outr, obase + ch, re);
              stop_store4<QUANT>(p.outi, obase + ch, im);
              continue;
            }
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
  if (KC > p.n1 || p.n2 > NCOL || p.n2 < 128) return 0;
  p.sb = NCOL / p.n2;
  p.ktb = F32_SLOT / p.n2;
  p.n_kta = p.n1 / KTA;
  p.n_ktb = p.n2 / p.ktb;
  p.n_chunks = p.n1 / KC;
  p.n_sblk = (p.n_spectra + p.sb - 1) / p.sb;
  return f32_smem_bytes<KC>();
}

template <int KC, bool QUANT, int STOP = STOP_NONE>
cudaError_t launch_dft_f32(F32Params p, int batch, size_t bytes, cudaStream_t stream) {
  auto kern = k1_dft_f32_kernel<KC, QUANT, STOP>;
  if (STOP == STOP_STAGEA_RND) p.n_ktb = 0;  // no stage-B tiles
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
// (16 rows up to N2 = 512, 8 at N2 = 1024 or N1 = 8), or return NO_PLAN.
template <typename F>
int with_f32_plan(F32Params p, F&& f) {
  F32Params q = p;
  size_t bytes;
  if ((bytes = f32_plan<16>(q))) return f(std::integral_constant<int, 16>{}, q, bytes);
  q = p;
  if ((bytes = f32_plan<8>(q))) return f(std::integral_constant<int, 8>{}, q, bytes);
  return NO_PLAN;
}

// ---------------------------------------------------------------------------
// The three-pass route (N2 >= 2048): stage A, then stage B, through T in
// device memory (see the head of the file). One block a tile, each tile's K
// loop through a cp.async ring. Each body spills nothing: the bf16 ones and
// f32 stage B fit 128 registers (two blocks an SM) with their tile copies
// in rolled loops (unrolled, their hoisted addresses spilled); f32 stage A
// takes 150 registers, one block an SM (at two it spilled 8 bytes).
// ---------------------------------------------------------------------------
constexpr int TP_THREADS = 256;  // 8 warps
// bf16 stage A: 64 k1 rows (their cos and -sin rows) x 128 n2 columns of one
// spectrum a tile, K tiles of 64 n1; warps 2 x 4, each 32 k1 rows x 32
// columns. bf16 stage B: 64 k2 rows (their cos and -sin rows) x 64 k1
// columns, K tiles of 64 n2; warps 2 x 4, each 32 k2 rows x 16 k1 columns.
constexpr int SA_M = 64, SA_N = 128, SA_K = 64;
constexpr int SB_M = 64, SB_N = 64, SB_K = 64;
constexpr int TP_STAGES = 3;
constexpr int SA_SLOT = SA_K * (SA_N + PAD) + 2 * SA_M * (SA_K + PAD);  // bf16 elements
constexpr int SB_SLOT = (2 * SB_M + 2 * SB_N) * (SB_K + PAD);
constexpr size_t SA_SMEM = sizeof(bf16) * TP_STAGES * SA_SLOT;
constexpr size_t SB_SMEM = sizeof(bf16) * TP_STAGES * SB_SLOT;
// f32 stage A: 64 k1 rows x 128 n2 columns, K tiles of 16 n1, 4 k1 rows x
// (cos, -sin) x 8 columns a thread. f32 stage B: 64 k2 rows x 64 k1
// columns, K tiles of 16 n2, 4 k2 x (cos, -sin) x 4 k1 x (T re, T im) a
// thread. 64 accumulators a thread, 4 shared loads per 64 FFMA, as K1's f32
// DFT pass.
constexpr int FA_M = 64, FA_N = 128, FA_K = 16;
constexpr int FB_M = 64, FB_N = 64, FB_K = 16;
constexpr int F3_STAGES = 4;
constexpr int FA_SLOT = FA_K * (FA_N + 2 * FA_M);  // floats
constexpr int FB_SLOT = FB_K * 2 * FB_M + 2 * FB_K * FB_N;
constexpr size_t FA_SMEM = sizeof(float) * F3_STAGES * FA_SLOT;
constexpr size_t FB_SMEM = sizeof(float) * F3_STAGES * FB_SLOT;
static_assert(2 * (SA_SMEM + 1024) <= 233472 && 2 * (SB_SMEM + 1024) <= 233472,
              "two bf16 stage blocks must share an SM's 228 KB");

struct StageParams {
  const void* plane;  // stage A: [M, N1, N2], M = batch * n_spectra (bf16 or f32)
  const void* d1c;    // stage A: [N1, N1] cos (symmetric)
  const void* d1s;    // stage A: [N1, N1] -sin (symmetric)
  const void* d2;     // stage B: bf16 [N2, N2] cos rows then -sin rows; f32 transposed [n2][k2]
  const float* twc;   // stage A: [N1, N2]
  const float* tws;
  void* tr;           // [M, N1, N2] T re, im (the operand type): stage A writes, B reads
  void* ti;
  const float* rotc;  // stage B: [batch, C]
  const float* rots;
  void* outr;         // stage B: [M, C] int8, or f32 without the requant
  void* outi;
  int n_spectra, n1, n2;
  int n_ct, n_rt;  // a spectrum's column tiles and row tiles
};

// The tile of this block: spectrum m, first row r0, first column c0
// (columns fastest, then rows, then spectra).
struct StageTile {
  long long m;
  int r0, c0;
};

__device__ __forceinline__ StageTile stage_tile(const StageParams& p, int rows, int cols) {
  long long t = blockIdx.x;
  StageTile w;
  w.c0 = static_cast<int>(t % p.n_ct) * cols;
  t /= p.n_ct;
  w.r0 = static_cast<int>(t % p.n_rt) * rows;
  w.m = t / p.n_rt;
  return w;
}

// A tile's K loop over n_k tiles through a ring of STAGES slots of `slot`
// elements: load(kt, slot) issues tile kt's cp.async copies, compute(slot)
// consumes a landed tile. Tile kt + STAGES - 1 loads while kt computes.
template <int STAGES, typename T, typename Load, typename Compute>
__device__ __forceinline__ void ring_loop(T* ring, int slot, int n_k, Load load,
                                          Compute compute) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_k) load(s, ring + s * slot);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
    __syncthreads();  // tile kt landed for every thread; tile kt-1's slot is free
    if (kt + STAGES - 1 < n_k) load(kt + STAGES - 1, ring + ((kt + STAGES - 1) % STAGES) * slot);
    cp_async_commit();
    compute(ring + (kt % STAGES) * slot);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The epilogue of stage B for two (or four) adjacent k1 of one k2: re =
// cos.tr - (-sin.ti), im = cos.ti + (-sin.tr) from the four sums s[0..3][e],
// then the rotation and the requant (or the f32 values) at out + o; at
// STOP_STAGEB re and im themselves, truncated (or f32).
template <bool QUANT, int E, int STOP = STOP_NONE>
__device__ __forceinline__ void stage_b_store(const StageParams& p, long long o,
                                              const float (&s)[4][E], const float* rc,
                                              const float* rs) {
  float v[2][E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const float re = __fsub_rn(s[0][e], s[1][e]);
    const float im = __fadd_rn(s[2][e], s[3][e]);
    if constexpr (STOP == STOP_STAGEB) {
      v[0][e] = re;
      v[1][e] = im;
    } else {
      v[0][e] = __fsub_rn(__fmul_rn(re, rc[e]), __fmul_rn(im, rs[e]));
      v[1][e] = __fadd_rn(__fmul_rn(re, rs[e]), __fmul_rn(im, rc[e]));
    }
  }
  if constexpr (STOP == STOP_STAGEB && E == 2) {
    stop_store2<QUANT>(p.outr, o, v[0][0], v[0][1]);
    stop_store2<QUANT>(p.outi, o, v[1][0], v[1][1]);
  } else if constexpr (STOP == STOP_STAGEB) {
    stop_store4<QUANT>(p.outr, o, make_float4(v[0][0], v[0][1], v[0][2], v[0][3]));
    stop_store4<QUANT>(p.outi, o, make_float4(v[1][0], v[1][1], v[1][2], v[1][3]));
  } else if constexpr (E == 2) {
    if constexpr (QUANT) {
      *reinterpret_cast<char2*>(static_cast<int8_t*>(p.outr) + o) =
          make_char2(requant(v[0][0]), requant(v[0][1]));
      *reinterpret_cast<char2*>(static_cast<int8_t*>(p.outi) + o) =
          make_char2(requant(v[1][0]), requant(v[1][1]));
    } else {
      *reinterpret_cast<float2*>(static_cast<float*>(p.outr) + o) = make_float2(v[0][0], v[0][1]);
      *reinterpret_cast<float2*>(static_cast<float*>(p.outi) + o) = make_float2(v[1][0], v[1][1]);
    }
  } else {
    static_assert(E == 4, "two or four outputs a store");
    if constexpr (QUANT) {
      *reinterpret_cast<char4*>(static_cast<int8_t*>(p.outr) + o) =
          make_char4(requant(v[0][0]), requant(v[0][1]), requant(v[0][2]), requant(v[0][3]));
      *reinterpret_cast<char4*>(static_cast<int8_t*>(p.outi) + o) =
          make_char4(requant(v[1][0]), requant(v[1][1]), requant(v[1][2]), requant(v[1][3]));
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(p.outr) + o) =
          make_float4(v[0][0], v[0][1], v[0][2], v[0][3]);
      *reinterpret_cast<float4*>(static_cast<float*>(p.outi) + o) =
          make_float4(v[1][0], v[1][1], v[1][2], v[1][3]);
    }
  }
}

// (The two stage-A kernels are not templates, so the stops' builds, which
// run them through the library's own entry points, leave them out.)
#ifndef K1_STAGE_STOPS
// Stage A, bf16: T = twiddle(D1 @ plane) of a [64 x 128] tile, rounded to bf16.
__global__ void __launch_bounds__(TP_THREADS, 2) k1_stage_a_kernel(StageParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  constexpr int XLD = SA_N + PAD, DLD = SA_K + PAD;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int n1 = p.n1, n2 = p.n2;
  const StageTile w = stage_tile(p, SA_M, SA_N);
  const long long mat = w.m * n1 * static_cast<long long>(n2);
  const bf16* xsrc = static_cast<const bf16*>(p.plane) + mat + w.c0;
  const bf16* d1c = static_cast<const bf16*>(p.d1c) + static_cast<long long>(w.r0) * n1;
  const bf16* d1s = static_cast<const bf16*>(p.d1s) + static_cast<long long>(w.r0) * n1;
  const int wr = (warp / 4) * 32, wc = (warp % 4) * 32;  // the warp's k1 rows, columns
  float acc[64];  // [cos/-sin][2 m16][4 n8][4]
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  auto load = [&](int kt, bf16* slot) {
    // [SA_K x SA_N] of the plane, then the tile's [SA_M x SA_K] cos and -sin.
#pragma unroll 1
    for (int i = threadIdx.x; i < SA_K * SA_N / 8; i += TP_THREADS) {
      const int r = i / (SA_N / 8), q = i % (SA_N / 8);
      cp_async16(slot + r * XLD + q * 8, xsrc + ((kt * SA_K + r) * n2 + q * 8));
    }
    bf16* sd = slot + SA_K * XLD;
#pragma unroll 1
    for (int i = threadIdx.x; i < 2 * SA_M * SA_K / 8; i += TP_THREADS) {
      const int mm = i / (SA_M * SA_K / 8), j = i % (SA_M * SA_K / 8);
      const int r = j / (SA_K / 8), q = j % (SA_K / 8);
      cp_async16(sd + (mm * SA_M + r) * DLD + q * 8, (mm ? d1s : d1c) + (r * n1 + kt * SA_K + q * 8));
    }
  };
  auto compute = [&](const bf16* slot) {
    const bf16* sX = slot;
    const bf16* sAc = slot + SA_K * XLD;
    const bf16* sAs = sAc + SA_M * DLD;
#pragma unroll
    for (int kk = 0; kk < SA_K; kk += 16) {
      uint32_t fa[2][2][4], fb[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wr + i * 16 + lane % 16, c = kk + (lane / 16) * 8;
        ldsm_x4(fa[0][i], sAc + r * DLD + c);
        ldsm_x4(fa[1][i], sAs + r * DLD + c);
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int r = kk + lane % 8 + ((lane / 8) % 2) * 8;
        ldsm_x4_t(fb[jj], sX + r * XLD + wc + jj * 16 + (lane / 16) * 8);
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            mma16816_rn(acc + ((m * 2 + i) * 4 + j) * 4, fa[m][i], fb[j / 2][(j % 2) * 2],
                        fb[j / 2][(j % 2) * 2 + 1]);
          }
        }
      }
    }
  };
  ring_loop<TP_STAGES>(ring, SA_SLOT, n1 / SA_K, load, compute);

  // The f32 twiddle, rounded to bf16, into T.
  bf16* tr = static_cast<bf16*>(p.tr) + mat;
  bf16* ti = static_cast<bf16*>(p.ti) + mat;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const long long o = static_cast<long long>(w.r0 + wr + i * 16 + g + hh * 8) * n2 + w.c0 +
                            wc + j * 8 + tig * 2;
        const float2 c = __ldg(reinterpret_cast<const float2*>(p.twc + o));
        const float2 sn = __ldg(reinterpret_cast<const float2*>(p.tws + o));
        const float* cr = acc + ((0 * 2 + i) * 4 + j) * 4 + hh * 2;
        const float* ci = acc + ((1 * 2 + i) * 4 + j) * 4 + hh * 2;
        *reinterpret_cast<__nv_bfloat162*>(tr + o) = __floats2bfloat162_rn(
            __fsub_rn(__fmul_rn(cr[0], c.x), __fmul_rn(ci[0], sn.x)),
            __fsub_rn(__fmul_rn(cr[1], c.y), __fmul_rn(ci[1], sn.y)));
        *reinterpret_cast<__nv_bfloat162*>(ti + o) = __floats2bfloat162_rn(
            __fadd_rn(__fmul_rn(cr[0], sn.x), __fmul_rn(ci[0], c.x)),
            __fadd_rn(__fmul_rn(cr[1], sn.y), __fmul_rn(ci[1], c.y)));
      }
    }
  }
}

#endif  // K1_STAGE_STOPS

// Stage B, bf16: the four products of a [64 k2 x 64 k1] tile over n2, then
// the epilogue (STOP_STAGEB: re and im, no rotation). The MMAs chain through
// their accumulators: at fft 2^22 on the card that flipped 6.5e-5 of the
// int8 codes against the plain version on the same T (1.4e-5 with each
// MMA's sum added in f32), far inside the gate of 1e-3.
template <bool QUANT, int STOP = STOP_NONE>
__global__ void __launch_bounds__(TP_THREADS, 2) k1_stage_b_kernel(StageParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  constexpr int LD = SB_K + PAD;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int n1 = p.n1, n2 = p.n2, h = n2 / 2, C = n1 * (n2 / 2);
  const StageTile w = stage_tile(p, SB_M, SB_N);  // rows: k2; columns: k1
  const long long mat = w.m * n1 * static_cast<long long>(n2);
  const bf16* d2 = static_cast<const bf16*>(p.d2);
  const bf16* tr = static_cast<const bf16*>(p.tr) + mat + static_cast<long long>(w.c0) * n2;
  const bf16* ti = static_cast<const bf16*>(p.ti) + mat + static_cast<long long>(w.c0) * n2;
  const int wr = (warp / 4) * 32, wc = (warp % 4) * 16;  // the warp's k2 rows, k1 columns
  float acc[64];  // [4 sums][2 m16][2 n8][4]: cos.tr, -sin.ti, cos.ti, -sin.tr
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  auto load = [&](int kt, bf16* slot) {
    // Rows of [cos k2 | -sin k2 | T re | T im], SB_K n2 each.
#pragma unroll 1
    for (int i = threadIdx.x; i < 4 * 64 * (SB_K / 8); i += TP_THREADS) {
      const int mm = i / (64 * (SB_K / 8)), j = i % (64 * (SB_K / 8));
      const int r = j / (SB_K / 8), q = j % (SB_K / 8);
      const bf16* src = mm < 2 ? d2 + (mm * h + w.r0 + r) * n2 : (mm == 2 ? tr : ti) + r * n2;
      cp_async16(slot + (mm * 64 + r) * LD + q * 8, src + (kt * SB_K + q * 8));
    }
  };
  auto compute = [&](const bf16* slot) {
    const bf16* sC = slot;
    const bf16* sS = slot + SB_M * LD;
    const bf16* sTr = sS + SB_M * LD;
    const bf16* sTi = sTr + SB_N * LD;
#pragma unroll
    for (int kk = 0; kk < SB_K; kk += 16) {
      uint32_t fc[2][4], fs[2][4], ftr[4], fti[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wr + i * 16 + lane % 16, c = kk + (lane / 16) * 8;
        ldsm_x4(fc[i], sC + r * LD + c);
        ldsm_x4(fs[i], sS + r * LD + c);
      }
      {
        const int r = wc + lane % 8 + (lane / 16) * 8, c = kk + ((lane / 8) % 2) * 8;
        ldsm_x4(ftr, sTr + r * LD + c);
        ldsm_x4(fti, sTi + r * LD + c);
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
  };
  ring_loop<TP_STAGES>(ring, SB_SLOT, n2 / SB_K, load, compute);

  const float* rc_b = p.rotc + (w.m / p.n_spectra) * C;
  const float* rs_b = p.rots + (w.m / p.n_spectra) * C;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float* a0 = acc + (i * 2 + j) * 4 + hh * 2;
        const int ch = (w.r0 + wr + i * 16 + g + hh * 8) * n1 + w.c0 + wc + j * 8 + tig * 2;
        const float s[4][2] = {{a0[0], a0[1]}, {a0[16], a0[17]}, {a0[32], a0[33]},
                               {a0[48], a0[49]}};
        float c2[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
        if constexpr (STOP == STOP_NONE) {
          const float2 rc = __ldg(reinterpret_cast<const float2*>(rc_b + ch));
          const float2 rs = __ldg(reinterpret_cast<const float2*>(rs_b + ch));
          c2[0] = rc.x;
          c2[1] = rc.y;
          s2[0] = rs.x;
          s2[1] = rs.y;
        }
        stage_b_store<QUANT, 2, STOP>(p, w.m * C + ch, s, c2, s2);
      }
    }
  }
}

#ifndef K1_STAGE_STOPS
// Stage A, f32 (exact f32 products and sums, FFMA): T = twiddle(D1 @ plane)
// of a [64 x 128] tile. D1 is symmetric, so its tile is read as [n1][k1].
__global__ void __launch_bounds__(TP_THREADS, 1) k1_stage_a_f32_kernel(StageParams p) {
  extern __shared__ __align__(128) float f3_smem[];
  const int tid = threadIdx.x;
  const int n1 = p.n1, n2 = p.n2;
  const StageTile w = stage_tile(p, FA_M, FA_N);
  const long long mat = w.m * n1 * static_cast<long long>(n2);
  const float* xsrc = static_cast<const float*>(p.plane) + mat + w.c0;
  const float* d1c = static_cast<const float*>(p.d1c) + w.r0;
  const float* d1s = static_cast<const float*>(p.d1s) + w.r0;
  // k1 rows 4*rg.. of the tile; columns cg.. and FA_N/2 + cg..
  const int rg = tid / 16, cg = (tid % 16) * 4;
  float acc[64];  // [cos/-sin][4 k1][8 columns]
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  auto load = [&](int kt, float* slot) {
    // [FA_K x FA_N] of the plane, then [FA_K x 2*FA_M]: cos of the tile's k1
    // at columns 0.., -sin at FA_M.. of row n1.
#pragma unroll 1
    for (int i = threadIdx.x; i < FA_K * FA_N / 4; i += TP_THREADS) {
      const int r = i / (FA_N / 4), q = (i % (FA_N / 4)) * 4;
      cp_async16(slot + r * FA_N + q, xsrc + ((kt * FA_K + r) * n2 + q));
    }
    float* sd = slot + FA_K * FA_N;
#pragma unroll 1
    for (int i = threadIdx.x; i < FA_K * 2 * FA_M / 4; i += TP_THREADS) {
      const int r = i / (2 * FA_M / 4), q = (i % (2 * FA_M / 4)) * 4;
      cp_async16(sd + r * 2 * FA_M + q,
                 (q < FA_M ? d1c : d1s) + ((kt * FA_K + r) * n1 + (q & (FA_M - 1))));
    }
  };
  auto compute = [&](const float* slot) {
    const float* sX = slot;
    const float* sD = slot + FA_K * FA_N;
#pragma unroll
    for (int kk = 0; kk < FA_K; ++kk) {
      const float4 x0 = *reinterpret_cast<const float4*>(sX + kk * FA_N + cg);
      const float4 x1 = *reinterpret_cast<const float4*>(sX + kk * FA_N + FA_N / 2 + cg);
      const float4 dc = *reinterpret_cast<const float4*>(sD + kk * 2 * FA_M + 4 * rg);
      const float4 ds = *reinterpret_cast<const float4*>(sD + kk * 2 * FA_M + FA_M + 4 * rg);
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
  };
  ring_loop<F3_STAGES>(f3_smem, FA_SLOT, n1 / FA_K, load, compute);

  // The f32 twiddle (tr = ar*wc - ai*ws, ti = ar*ws + ai*wc) into T
  // transposed, [n2][k1]: the thread's 4 k1 of a column are one float4.
  float* tr = static_cast<float*>(p.tr) + mat;
  float* ti = static_cast<float*>(p.ti) + mat;
  const int k1 = w.r0 + 4 * rg;
#pragma unroll
  for (int col = 0; col < 8; ++col) {  // a column's 4 k1 at a time
    const int n = w.c0 + (col / 4) * (FA_N / 2) + cg + col % 4;
    float vr[4], vi[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float c = __ldg(p.twc + (k1 + i) * n2 + n), sn = __ldg(p.tws + (k1 + i) * n2 + n);
      const float ar = acc[i * 8 + col], ai = acc[32 + i * 8 + col];
      vr[i] = __fsub_rn(__fmul_rn(ar, c), __fmul_rn(ai, sn));
      vi[i] = __fadd_rn(__fmul_rn(ar, sn), __fmul_rn(ai, c));
    }
    const int o = n * n1 + k1;
    *reinterpret_cast<float4*>(tr + o) = make_float4(vr[0], vr[1], vr[2], vr[3]);
    *reinterpret_cast<float4*>(ti + o) = make_float4(vi[0], vi[1], vi[2], vi[3]);
  }
}

#endif  // K1_STAGE_STOPS

// Stage B, f32 (FFMA): the four products of a [64 k2 x 64 k1] tile over
// n2, the transposed N2-point matrix against T transposed ([n2][k1], as
// stage A f32 writes it), then the epilogue (STOP_STAGEB: re and im). A
// quarter warp shares its 4 k1 (a broadcast) and reads 8 runs of 4 k2.
template <bool QUANT, int STOP = STOP_NONE>
__global__ void __launch_bounds__(TP_THREADS, 1) k1_stage_b_f32_kernel(StageParams p) {
  extern __shared__ __align__(128) float f3_smem[];
  const int tid = threadIdx.x;
  const int n1 = p.n1, n2 = p.n2, h = n2 / 2, C = n1 * (n2 / 2);
  const StageTile w = stage_tile(p, FB_M, FB_N);  // rows: k2; columns: k1
  const long long mat = w.m * n1 * static_cast<long long>(n2);
  const float* d2t = static_cast<const float*>(p.d2);
  const float* tr = static_cast<const float*>(p.tr) + mat + w.c0;  // [N2][N1]
  const float* ti = static_cast<const float*>(p.ti) + mat + w.c0;
  const int rb = (tid % 16) * 4, qb = (tid / 16) * 4;  // k2 rows rb.., k1 columns qb..
  float acc[64];  // [4 sums][4 k2][4 k1]: cos.tr, -sin.ti, cos.ti, -sin.tr
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  auto load = [&](int kt, float* slot) {
    // [FB_K x 2*FB_M] of the transposed matrix (cos of the tile's k2, then
    // their -sin), then T re and im transposed, [FB_K x FB_N] each.
#pragma unroll 1
    for (int i = threadIdx.x; i < FB_K * 2 * FB_M / 4; i += TP_THREADS) {
      const int r = i / (2 * FB_M / 4), q = (i % (2 * FB_M / 4)) * 4;
      cp_async16(slot + r * 2 * FB_M + q,
                 d2t + ((kt * FB_K + r) * n2 + (q < FB_M ? w.r0 + q : h + w.r0 + q - FB_M)));
    }
    float* st = slot + FB_K * 2 * FB_M;
#pragma unroll 1
    for (int i = threadIdx.x; i < 2 * FB_K * FB_N / 4; i += TP_THREADS) {
      const int mm = i / (FB_K * FB_N / 4), j = i % (FB_K * FB_N / 4);
      const int r = j / (FB_N / 4), q = (j % (FB_N / 4)) * 4;
      cp_async16(st + mm * FB_K * FB_N + r * FB_N + q, (mm ? ti : tr) + ((kt * FB_K + r) * n1 + q));
    }
  };
  auto compute = [&](const float* slot) {
    const float* sD = slot;
    const float* sTr = slot + FB_K * 2 * FB_M;
    const float* sTi = sTr + FB_K * FB_N;
#pragma unroll
    for (int kk = 0; kk < FB_K; ++kk) {
      const float4 dc = *reinterpret_cast<const float4*>(sD + kk * 2 * FB_M + rb);
      const float4 ds = *reinterpret_cast<const float4*>(sD + kk * 2 * FB_M + FB_M + rb);
      const float4 t_r = *reinterpret_cast<const float4*>(sTr + kk * FB_N + qb);
      const float4 t_i = *reinterpret_cast<const float4*>(sTi + kk * FB_N + qb);
      const float cv[4] = {dc.x, dc.y, dc.z, dc.w}, sv[4] = {ds.x, ds.y, ds.z, ds.w};
      const float trv[4] = {t_r.x, t_r.y, t_r.z, t_r.w}, tiv[4] = {t_i.x, t_i.y, t_i.z, t_i.w};
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
  };
  ring_loop<F3_STAGES>(f3_smem, FB_SLOT, n2 / FB_K, load, compute);

  // Four consecutive channels k2*N1 + k1.. of each of the thread's k2.
  const float* rc_b = p.rotc + (w.m / p.n_spectra) * C;
  const float* rs_b = p.rots + (w.m / p.n_spectra) * C;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int ch = (w.r0 + rb + a) * n1 + w.c0 + qb;
    float rc[4] = {0.f, 0.f, 0.f, 0.f}, rs[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (STOP == STOP_NONE) {
      const float4 rc4 = __ldg(reinterpret_cast<const float4*>(rc_b + ch));
      const float4 rs4 = __ldg(reinterpret_cast<const float4*>(rs_b + ch));
      rc[0] = rc4.x, rc[1] = rc4.y, rc[2] = rc4.z, rc[3] = rc4.w;
      rs[0] = rs4.x, rs[1] = rs4.y, rs[2] = rs4.z, rs[3] = rs4.w;
    }
    float s[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[k][c] = acc[k * 16 + a * 4 + c];
    }
    stage_b_store<QUANT, 4, STOP>(p, w.m * C + ch, s, rc, rs);
  }
}

// Whether the three-pass route's tiles cover N1 x N2: powers of two, N1 and
// N2 / 2 multiples of 64, N2 of 128, and a spectrum's planes and the DFT
// matrices indexed in 32 bits (N1, N2 <= 2^15).
bool three_pass_split(int n1, int n2) {
  return n1 >= 64 && n1 <= (1 << 15) && (n1 & (n1 - 1)) == 0 && n2 >= 128 && n2 <= (1 << 15) &&
         (n2 & (n2 - 1)) == 0;
}

// Launches a stage kernel, one block a tile.
template <typename K>
cudaError_t launch_stage(K kern, const StageParams& p, long long tiles, size_t smem,
                         cudaStream_t stream) {
  if (tiles < 1 || tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<static_cast<unsigned>(tiles), TP_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// A stage kernel's body: out int[9] = registers a thread, local (spill)
// bytes a thread, threads a block, shared-memory bytes, tile rows, tile
// columns, K-tile depth, ring stages, blocks an SM.
template <typename K>
int stage_attributes(K kern, size_t smem, int rows, int cols, int depth, int stages, void* out) {
  cudaFuncAttributes a{};
  cudaError_t err = cudaFuncGetAttributes(&a, kern);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, TP_THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int* o = static_cast<int*>(out);
  o[0] = a.numRegs;
  o[1] = static_cast<int>(a.localSizeBytes);
  o[2] = TP_THREADS;
  o[3] = static_cast<int>(smem);
  o[4] = rows;
  o[5] = cols;
  o[6] = depth;
  o[7] = stages;
  o[8] = per_sm;
  return 0;
}

// T's rows k1 < N1/2 of each of m spectra, gathered to outr / outi at
// k1*N2 + n2 (the three-pass route's stagea stop): T as stage A wrote it,
// bf16 [m][N1][N2] (those rows are a spectrum's first C values) or f32
// transposed [m][N2][N1]; int8 by truncation (QUANT) or f32. A thread takes
// 4 consecutive n2 of one k1.
template <typename T, bool QUANT>
__global__ void __launch_bounds__(256) k1_t_slice_kernel(const T* __restrict__ tr,
                                                          const T* __restrict__ ti,
                                                          void* outr, void* outi, long long m,
                                                          int n1, int n2) {
  const long long c = static_cast<long long>(n1 / 2) * n2;
  const long long i = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (i >= m * c) return;
  const long long sp = i / c;
  const int k1 = static_cast<int>((i % c) / n2), n = static_cast<int>(i % n2);
  const long long mat = sp * n1 * static_cast<long long>(n2);
  float vr[4], vi[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const long long t = std::is_same<T, float>::value
                            ? mat + static_cast<long long>(n + e) * n1 + k1
                            : mat + static_cast<long long>(k1) * n2 + n + e;
    vr[e] = static_cast<float>(tr[t]);
    vi[e] = static_cast<float>(ti[t]);
  }
  stop_store4<QUANT>(outr, i, make_float4(vr[0], vr[1], vr[2], vr[3]));
  stop_store4<QUANT>(outi, i, make_float4(vi[0], vi[1], vi[2], vi[3]));
}

// The shape of a FIR launch with the plan (depth, run, streams, short_run)
// that ops/fengine_fused.py:_fir_plan picks; false where a body could not
// run it: a register ring of depth 4, 8 or 16 rows that does not hold the
// taps (depth 0, the long body, takes any), an empty run, a short run past
// FIR_SHORT spectra or off the ring's depths, more than FIR_MAX_STREAMS
// streams a block, or counts past int.
bool fir_shape(FirShape& sh, long long batch_stride, int batch, int n_spectra, int n_taps,
               int fft, int depth, int run, int streams, int short_run) {
  const bool ring = (depth == 4 || depth == 8 || depth == 16) && n_taps <= depth;
  if ((short_run && !(ring && run <= FIR_SHORT)) || short_run < 0 || short_run > 1 ||
      batch < 1 || n_spectra < 1 || n_taps < 1 || fft < 4 || fft % 4 || run < 1 ||
      streams < 1 || streams > FIR_MAX_STREAMS || !(ring || depth == 0) ||
      static_cast<long long>(streams) * (std::min(run, n_spectra) + n_taps + FIR_ROWS) >
          0x7fffffffLL) {
    return false;
  }
  sh = FirShape{batch_stride, batch, n_spectra, fft, n_taps, run, streams,
                (fft + FIR_TILE - 1) / FIR_TILE, (n_spectra + run - 1) / run};
  return static_cast<long long>(sh.lane_blocks) * sh.runs * ((batch + streams - 1) / streams) <=
         0x7fffffffLL;
}

bool aligned_to(const void* p, uintptr_t to) { return reinterpret_cast<uintptr_t>(p) % to == 0; }

template <int MAXT, int STOP, typename PT, bool SHORT = false>
int fir_launch(const void* x, const void* starts, const void* win, void* plane, void* outr,
               void* outi, const FirShape& sh, cudaStream_t st) {
  const auto kern = k1_fir_kernel<MAXT, STOP, PT, SHORT>;
  constexpr int smem = fir_smem_bytes(MAXT, STOP, SHORT);
  if (smem > 0) {  // above 48 KB with the static starts: the ring's size, asked for
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long blocks = static_cast<long long>(sh.lane_blocks) * sh.runs *
                           ((sh.batch + sh.streams - 1) / sh.streams);
  k1_fir_kernel<MAXT, STOP, PT, SHORT><<<static_cast<unsigned>(blocks), FIR_THREADS, smem, st>>>(
      static_cast<const int8_t*>(x), static_cast<const long long*>(starts),
      static_cast<const float*>(win), static_cast<PT*>(plane), static_cast<int8_t*>(outr),
      static_cast<int8_t*>(outi), sh);
  return static_cast<int>(cudaGetLastError());
}

// The body for the plan's depth and run (fir_shape has checked them).
template <int STOP, typename PT>
int fir_dispatch(int depth, int short_run, const void* x, const void* starts, const void* win,
                 void* plane, void* outr, void* outi, const FirShape& sh, cudaStream_t st) {
  if (short_run) {
    switch (depth) {
      case 4: return fir_launch<4, STOP, PT, true>(x, starts, win, plane, outr, outi, sh, st);
      case 8: return fir_launch<8, STOP, PT, true>(x, starts, win, plane, outr, outi, sh, st);
      default: return fir_launch<16, STOP, PT, true>(x, starts, win, plane, outr, outi, sh, st);
    }
  }
  switch (depth) {
    case 4: return fir_launch<4, STOP, PT>(x, starts, win, plane, outr, outi, sh, st);
    case 8: return fir_launch<8, STOP, PT>(x, starts, win, plane, outr, outi, sh, st);
    case 16: return fir_launch<16, STOP, PT>(x, starts, win, plane, outr, outi, sh, st);
    default: return fir_launch<0, STOP, PT>(x, starts, win, plane, outr, outi, sh, st);
  }
}

// out int[5]: registers a thread, local (spill) bytes a thread, shared
// bytes a block (static and the launch's dynamic), the most threads a
// block, blocks an SM at FIR_THREADS threads and that shared memory.
template <int MAXT, int STOP, typename PT, bool SHORT = false>
int fir_attributes_of(void* out) {
  const auto kern = k1_fir_kernel<MAXT, STOP, PT, SHORT>;
  constexpr int smem = fir_smem_bytes(MAXT, STOP, SHORT);
  cudaFuncAttributes a{};
  cudaError_t err = cudaFuncGetAttributes(&a, kern);
  if (err == cudaSuccess && smem > 0) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  int per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, FIR_THREADS, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  int* o = static_cast<int*>(out);
  o[0] = a.numRegs;
  o[1] = static_cast<int>(a.localSizeBytes);
  o[2] = static_cast<int>(a.sharedSizeBytes) + smem;
  o[3] = a.maxThreadsPerBlock;
  o[4] = per_sm;
  return 0;
}

template <int STOP, typename PT>
int fir_attributes(int depth, int short_run, void* out) {
  if (short_run) {
    switch (depth) {
      case 4: return fir_attributes_of<4, STOP, PT, true>(out);
      case 8: return fir_attributes_of<8, STOP, PT, true>(out);
      case 16: return fir_attributes_of<16, STOP, PT, true>(out);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (depth) {
    case 4: return fir_attributes_of<4, STOP, PT>(out);
    case 8: return fir_attributes_of<8, STOP, PT>(out);
    case 16: return fir_attributes_of<16, STOP, PT>(out);
    case 0: return fir_attributes_of<0, STOP, PT>(out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K1's FIR pass into a plane of PT (bf16, or float for f32 DFT operands).
template <typename PT>
int fir_pass(const void* x, long long batch_stride, const void* starts, const void* win,
             void* plane, int batch, int n_spectra, int n_taps, int fft, int depth, int run,
             int streams, int short_run, void* stream) {
  FirShape sh;
  if (!fir_shape(sh, batch_stride, batch, n_spectra, n_taps, fft, depth, run, streams,
                 short_run) ||
      !aligned_to(win, 16) || !aligned_to(plane, 4 * sizeof(PT))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return fir_dispatch<STOP_NONE, PT>(depth, short_run, x, starts, win, plane, nullptr, nullptr,
                                     sh, static_cast<cudaStream_t>(stream));
}

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

}  // namespace

// K1's own entry points; csrc/fengine_ct_stops.cu includes this file for the
// kernels above and defines K1_STAGE_STOPS, so it compiles the stops alone.
#ifndef K1_STAGE_STOPS

extern "C" const char* dcsand_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Pass 1: x [batch, batch_stride] int8 streams (stream b's window starts at
// starts[b], at any byte), win [n_taps, fft] f32 (16-byte aligned) -> plane
// [batch, n_spectra, fft] bf16 (8-byte aligned), with the plan (depth, run,
// streams, short_run) of ops/fengine_fused.py:_fir_plan. A plan or pointer
// that does not fit is refused with cudaErrorInvalidValue, before any launch.
extern "C" int k1_fir_launch(const void* x, long long batch_stride, const void* starts,
                             const void* win, void* plane, int batch, int n_spectra,
                             int n_taps, int fft, int depth, int run, int streams,
                             int short_run, void* stream) {
  return fir_pass<bf16>(x, batch_stride, starts, win, plane, batch, n_spectra, n_taps, fft,
                        depth, run, streams, short_run, stream);
}

// Pass 1 for f32 DFT operands: the same, into an f32 plane (16-byte
// aligned) of the exact f32 tap-order sums.
extern "C" int k1_fir_f32_launch(const void* x, long long batch_stride, const void* starts,
                                 const void* win, void* plane, int batch, int n_spectra,
                                 int n_taps, int fft, int depth, int run, int streams,
                                 int short_run, void* stream) {
  return fir_pass<float>(x, batch_stride, starts, win, plane, batch, n_spectra, n_taps, fft,
                         depth, run, streams, short_run, stream);
}

// The FIR pass's body for a register ring of `depth` rows (4, 8, 16; 0: the
// long body), the short-run body for that depth (short_run = 1), into a
// bf16 (plane_f32 = 0) or f32 plane: out int[5] as fir_attributes_of gives it.
extern "C" int k1_fir_attributes(int depth, int short_run, int plane_f32, void* out) {
  return plane_f32 ? fir_attributes<STOP_NONE, float>(depth, short_run, out)
                   : fir_attributes<STOP_NONE, bf16>(depth, short_run, out);
}

// Pass 2: plane [batch, n_spectra, N1, N2] bf16 -> outputs [batch,
// n_spectra, C] (int8, or f32 without quantise); d1c/d1s/d2 are the bf16
// DFT matrices, twc/tws the f32 twiddles, rotc/rots [batch, C]. Returns -1
// where no chunk's plan fits shared memory (N2 >= 2048: the three-pass
// route's splits).
extern "C" int k1_dft_launch(const void* plane, const void* d1c, const void* d1s,
                             const void* d2, const void* twc, const void* tws,
                             const void* rotc, const void* rots, void* outr, void* outi,
                             int batch, int n_spectra, int n1, int n2, int quantise,
                             void* stream) {
  if (n1 < 8 || !pow2(n1) || n2 < 128 || !pow2(n2) || batch < 1 || n_spectra < 1) {
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
// split then takes the three-pass route): out int[6] = registers a thread,
// local (spill) bytes a thread, KC (KC_N8 at N1 = 8), stage-B K-tile depth,
// ring stages, shared-memory bytes.
extern "C" int k1_dft_attributes(int n1, int n2, void* out) {
  if (n1 < 8 || !pow2(n1) || n2 < 128 || !pow2(n2)) {
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
    o[3] = q.ktb;
    o[4] = q.stages;
    o[5] = static_cast<int>(bytes);
    return 0;
  });
}

// Pass 2 with f32 DFT operands: plane [batch, n_spectra, N1, N2] f32 (16-byte
// aligned) -> outputs [batch, n_spectra, C] (int8, or f32 without
// quantise); d1c/d1s the f32 N1-point matrices, d2t the f32 N2-point matrix
// transposed ([n2][k2]: cos columns, then -sin), twc/tws the f32 twiddles,
// rotc/rots [batch, C]. Returns -1 where the pass has no plan (N2 > 1024):
// those splits take the three-pass route.
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
// split then takes the three-pass route): out int[8] = registers a thread, local
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

// The three-pass route's stage A: plane [m, N1, N2] (m = batch * n_spectra
// spectra; bf16, 16-byte aligned) -> T re, im [m, N1, N2] bf16; d1c/d1s the
// bf16 N1-point matrices, twc/tws the f32 twiddles. Returns -1 where the
// route's tiles do not cover the split.
extern "C" int k1_stage_a_launch(const void* plane, const void* d1c, const void* d1s,
                                 const void* twc, const void* tws, void* tr, void* ti, int m,
                                 int n1, int n2, void* stream) {
  if (m < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (!three_pass_split(n1, n2)) return NO_PLAN;
  StageParams p{plane, d1c, d1s, nullptr, static_cast<const float*>(twc),
                static_cast<const float*>(tws), tr, ti, nullptr, nullptr, nullptr, nullptr,
                1, n1, n2, n2 / SA_N, n1 / SA_M};
  return static_cast<int>(launch_stage(k1_stage_a_kernel, p,
                                       static_cast<long long>(m) * p.n_ct * p.n_rt, SA_SMEM,
                                       static_cast<cudaStream_t>(stream)));
}

// Stage A with f32 operands: the same, all f32 (the plane 16-byte aligned),
// T re and im written transposed, [m, N2, N1].
extern "C" int k1_stage_a_f32_launch(const void* plane, const void* d1c, const void* d1s,
                                     const void* twc, const void* tws, void* tr, void* ti, int m,
                                     int n1, int n2, void* stream) {
  if (m < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (!three_pass_split(n1, n2)) return NO_PLAN;
  StageParams p{plane, d1c, d1s, nullptr, static_cast<const float*>(twc),
                static_cast<const float*>(tws), tr, ti, nullptr, nullptr, nullptr, nullptr,
                1, n1, n2, n2 / FA_N, n1 / FA_M};
  return static_cast<int>(launch_stage(k1_stage_a_f32_kernel, p,
                                       static_cast<long long>(m) * p.n_ct * p.n_rt, FA_SMEM,
                                       static_cast<cudaStream_t>(stream)));
}

// The three-pass route's stage B: T re, im [batch, n_spectra, N1, N2] bf16
// -> outputs [batch, n_spectra, C] (int8, or f32 without quantise); d2 the
// bf16 row-stacked N2-point matrix, rotc/rots [batch, C]. Returns -1 where
// the route's tiles do not cover the split.
extern "C" int k1_stage_b_launch(const void* tr, const void* ti, const void* d2,
                                 const void* rotc, const void* rots, void* outr, void* outi,
                                 int batch, int n_spectra, int n1, int n2, int quantise,
                                 void* stream) {
  if (batch < 1 || n_spectra < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (!three_pass_split(n1, n2)) return NO_PLAN;
  StageParams p{nullptr, nullptr, nullptr, d2, nullptr, nullptr,
                const_cast<void*>(tr), const_cast<void*>(ti),
                static_cast<const float*>(rotc), static_cast<const float*>(rots), outr, outi,
                n_spectra, n1, n2, n1 / SB_N, n2 / 2 / SB_M};
  const long long tiles = static_cast<long long>(batch) * n_spectra * p.n_ct * p.n_rt;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(quantise ? launch_stage(k1_stage_b_kernel<true>, p, tiles, SB_SMEM, st)
                                   : launch_stage(k1_stage_b_kernel<false>, p, tiles, SB_SMEM, st));
}

// Stage B with f32 operands: T re, im f32 transposed [batch, n_spectra, N2,
// N1] (as stage A f32 writes them), d2t the f32 N2-point matrix transposed
// ([n2][k2]: cos columns, then -sin), rotc/rots 16-byte aligned.
extern "C" int k1_stage_b_f32_launch(const void* tr, const void* ti, const void* d2t,
                                     const void* rotc, const void* rots, void* outr, void* outi,
                                     int batch, int n_spectra, int n1, int n2, int quantise,
                                     void* stream) {
  if (batch < 1 || n_spectra < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (!three_pass_split(n1, n2)) return NO_PLAN;
  StageParams p{nullptr, nullptr, nullptr, d2t, nullptr, nullptr,
                const_cast<void*>(tr), const_cast<void*>(ti),
                static_cast<const float*>(rotc), static_cast<const float*>(rots), outr, outi,
                n_spectra, n1, n2, n1 / FB_N, n2 / 2 / FB_M};
  const long long tiles = static_cast<long long>(batch) * n_spectra * p.n_ct * p.n_rt;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      quantise ? launch_stage(k1_stage_b_f32_kernel<true>, p, tiles, FB_SMEM, st)
               : launch_stage(k1_stage_b_f32_kernel<false>, p, tiles, FB_SMEM, st));
}

// Each three-pass stage's body at N1 x N2, -1 where the route's tiles do not
// cover the split: out int[9] as stage_attributes gives it.
extern "C" int k1_stage_a_attributes(int n1, int n2, void* out) {
  if (!three_pass_split(n1, n2)) return NO_PLAN;
  return stage_attributes(k1_stage_a_kernel, SA_SMEM, SA_M, SA_N, SA_K, TP_STAGES, out);
}

extern "C" int k1_stage_b_attributes(int n1, int n2, void* out) {
  if (!three_pass_split(n1, n2)) return NO_PLAN;
  return stage_attributes(k1_stage_b_kernel<true>, SB_SMEM, SB_M, SB_N, SB_K, TP_STAGES, out);
}

extern "C" int k1_stage_a_f32_attributes(int n1, int n2, void* out) {
  if (!three_pass_split(n1, n2)) return NO_PLAN;
  return stage_attributes(k1_stage_a_f32_kernel, FA_SMEM, FA_M, FA_N, FA_K, F3_STAGES, out);
}

extern "C" int k1_stage_b_f32_attributes(int n1, int n2, void* out) {
  if (!three_pass_split(n1, n2)) return NO_PLAN;
  return stage_attributes(k1_stage_b_f32_kernel<true>, FB_SMEM, FB_M, FB_N, FB_K, F3_STAGES,
                          out);
}

#endif  // K1_STAGE_STOPS
