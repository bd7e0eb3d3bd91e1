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
// 2. The DFT pass, bf16 operands: both DFT stages on the tensor cores, the
//    T planes of a chunk of KC k1 rows in shared memory between them. Two
//    bodies, one a split:
//    k1_dft_wg_kernel (N1 >= 16: fft 2^11 to 2^21) — wgmma (bf16 in, f32
//    sums) from shared memory that TMA fills through an mbarrier ring, warp-
//    specialised, one persistent block of 384 threads an SM. A unit of work
//    is (spectrum, chunk): KC = 64 (N1 where smaller; 32 at N2 = 1024, where
//    64 rows' T planes and a ring of three slots would not fit); blocks walk
//    units chunk fastest, so a spectrum's chunks run side by side and its
//    plane rows stay in L2.
//      Producer (warpgroup 0, setmaxnreg down to 40 registers): one thread
//      walks the units' slots in the consumers' order and issues each
//      slot's TMA boxes (2-D tensor maps, 128-byte swizzle; boxes past an
//      edge read zeros) once both consumers have released it: a slot's
//      full mbarrier counts the producer's arrival and the box bytes, its
//      empty mbarrier one arrival a consumer warpgroup, given once the
//      wgmmas that read the slot have completed (or, for a slot the other
//      consumer's epilogue reads, once it has landed). 3 or 4 slots of 32
//      KB; no __syncthreads after the start. A pass's K slots are followed
//      by a slot of each consumer's f32 twiddles ([KC x 64] of twc and
//      tws), an item pair's by a slot of each consumer's rotation values
//      ([64 k2 x NB k1] of rotc and rots, the planes viewed [G·N2/2, N1]):
//      the epilogues' f32 operands land while the MMAs before them run.
//      Consumers (warpgroups 1 and 2, setmaxnreg up to 232):
//      stage A, transposed so that one wgmma gives both sums of a (k1, n2):
//        [n2 x (cos k1 | -sin k1)] = plane^T [n2 x n1] x [D1c; D1s]^T. A
//        slot holds two 64-column tiles of the plane, [KD n1 rows x 64 n2]
//        (KD = 64, N1 where smaller), N-contiguous: wgmma's M-major A
//        operand (imm-trans-a), and the chunk's [cos; -sin] rows [2 KC x 64
//        n1] of the N1-point matrix, the K-major B operand. Each consumer
//        takes one tile, m64n(2 KC)k16 over n1; a pass is 128 columns, N2
//        / 128 passes a unit.
//        The sums in two levels: the wgmmas of a group of WG_GROUP k-steps
//        (64 products) sum into a fragment from zero (scale-d 0 on the
//        group's first), which joins the master sums by __fadd_rn: one
//        FADD a sum every 64 products where the old mma.sync body spent
//        one every 16 (each MMA's sum added in f32), and an
//        f32 sum of the tensor core's 64-product sums in place of one
//        chained sum over N1, whose drift flipped more than 1e-3 of codes
//        at fft 2^20. The card's flipped share at depths of 16, 32 and 64
//        products at the flagship, 2^20 and 2^21 is in PERF.md; 64 was
//        the deepest, and flipped no more than 16.
//        The epilogue: a quad shuffle gives each thread two neighbouring n2
//        of one k1; the f32 twiddle (its pairs from the staged slot), then T
//        rounded to bf16 once and stored as bf16 pairs straight into the
//        K-major, 128-byte-swizzled layout stage B's descriptors read ([T
//        re NB rows; T im NB rows] a column group of NB k1, 64-column
//        blocks): no re-layout pass.
//      stage B, a plain product: [the cos rows; the -sin rows of a 64-row
//        k2 tile] (TMA boxes of the row-stacked N2-point matrix, K-major A)
//        x [T re | T im] of a column group (K-major B from the T planes):
//        m64n(2 NB)k16 chained over n2, cos.tr and cos.ti in one fragment,
//        -sin.tr and -sin.ti in the other, one group left in flight while
//        the next slot's run; then re = cos.tr - (-sin.ti), im = cos.ti +
//        (-sin.tr), the f32 rotation (from the staged slot), the requant
//        (or the f32 store), bin k2·N1 + k1. NB = KC (half a
//        chunk at N2 = 128, which has one k2 tile), an item a consumer.
//      The consumers meet at a named barrier twice a unit: T whole before
//      stage B, the last unit's stage B done before T is written again.
//      Registers: 168 a thread at launch, 232 a consumer thread after
//      setmaxnreg (a 64-float fragment and 64 master sums at the most); 0
//      spill bytes in every body, the stops' too. (The twiddles and
//      rotation values prefetched into registers instead spilled 300 bytes
//      and ran slower.)
//    k1_dft_kernel (N1 = 8, fft 1024) — mma.sync: a unit is 16 spectra
//    (KC_N8 = 128 T rows, (spectrum, k1)), persistent blocks (one an SM, 16
//    warps) fed by a cp.async ring of 3 or 4 stages; stage A is one 8-deep
//    K tile, the unit's 16 planes whole ([128 x N2], 8 rows of each
//    spectrum), each warp's 4 spectra against the [cos; -sin] [16 x 8]
//    matrix held in registers, one mma.sync m16n8k8 per spectrum and 8
//    columns (one MMA a sum, so nothing chains); stage B 32 k2 rows x 16 T
//    columns (two spectra) a warp, m16n8k16 chained.
//
// What bounds it on the card. The split's floor is 8.0 ms at the flagship:
// the FIR pass's operations (2.48 ms) and the DFT's 5.5 TFLOP of bf16
// (5.56 ms). The pass's time, its stops' and its bound are in PERF.md. A
// flagship unit of the wgmma body reads through L2 the plane once (128 KB),
// the chunk's N1-point rows once a pass (2 x 64 KB), the N2-point matrix
// once (128 KB), the chunk's f32 twiddles (128 KB) and rotation values (64
// KB), and writes 16 KB: 592 KB a unit, 97 GB a flagship step (163,840
// units), by the count that gave the mma.sync body 84 GB (512 KB a unit:
// the N1-point rows once). The second read of the N1-point rows is the
// price of a consumer's 64-column tile: its fragment and master sums take
// 128 of its registers, so a pass covers 128 columns. The two consumers
// share each slot, so their epilogues fall together rather than one
// running beside the other's MMAs (a one-time skew of one consumer by two
// slots, tried, did not hold); the staged twiddles and rotation values
// shorten them instead. A cluster that multicasts the plane and the
// N2-point matrix to the chunks of a spectrum, and consumers that ping-pong
// on slots of their own, are left open (PERF.md §7). At N1 = 8 the work is
// 0.5 MFLOP a spectrum against 3 KB in and out, so the FIR pass's bytes
// bound it.
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
//    a spectrum. So T goes to device memory between two GEMM-shaped passes:
//    stage A, [2·N1 x N1] (the cos and -sin rows paired, so one thread
//    holds both sums of a (k1, n2)) x the plane [N1 x N2] of each spectrum,
//    the f32 twiddle, T re and im stored rounded to the operand type (K1's
//    rounding point); stage B, the row-stacked N2-point matrix x T^T, the
//    four products cos.tr, -sin.ti, cos.ti, -sin.tr combined as the DFT
//    pass's stage B does, then the rotation and the requant (or the f32
//    store), bin k2·N1 + k1. T keeps K1's layout, bf16 [m, N1, N2] (the
//    stagea stop's gather reads it so; K7's stage A, on the [N1, 2·N2]
//    view, stores each stream's [N1, N2] plane, which K7's stage B reads,
//    csrc/fengine_dit.cu).
//    bf16: k1_stage_a_wg_kernel and k1_stage_b_wg_kernel, the DFT pass's
//    machinery on GEMM-shaped tiles: wgmma (bf16 in, f32 sums) from shared
//    memory in two consumer warpgroups (setmaxnreg up to 232), fed by one
//    producer thread (its warpgroup down to 40) that issues TMA boxes (2-D
//    tensor maps, 128-byte swizzle) into a ring of 4 slots of 48 KB; a
//    slot's full mbarrier counts the producer's arrival and the box bytes,
//    its empty mbarrier one arrival a consumer warpgroup once the wgmmas
//    that read it have completed. No block-wide barrier after the start.
//    This machinery (the ring, its mbarriers, the TMA and wgmma wrappers,
//    the tile walk) is csrc/wg_ring.cuh, which K7's bf16 stage B
//    (dit_stage_b_kernel, csrc/fengine_dit.cu) runs on too; K7's stage A is
//    k1_stage_a_wg_kernel<P, true>, which stores T as each stream's plane.
//    One persistent block an SM walks the tiles, columns fastest (stage A:
//    a chunk's n2 tiles; stage B: a k1 tile's k2 tiles), so the tiles
//    running side by side share one spectrum's plane (or T) and one chunk's
//    matrix rows in L2; the producer runs on into the next tile's slots
//    while the consumers finish a tile.
//      Stage A, transposed as the DFT pass's: a tile is 128 n2 x 128 k1 (64
//        k1 at N1 = 64) of one spectrum. A K slot holds the two consumers'
//        plane tiles [64 n1 x 64 n2] (wgmma's M-major A operand, imm-trans-
//        a) and the chunk's [cos 64; -sin 64] box pairs of the N1-point
//        rows (the K-major B operand), two pieces of 64 k1. Each consumer
//        takes one 64-column tile and both pieces, m64n128k16: its sums in
//        two levels, the wgmmas of a group of SA_GROUP k-steps (64
//        products) summed into a fragment from zero, which joins the
//        piece's f32 master sums by __fadd_rn (one FADD a sum every 64
//        products where the mma.sync body spent one every 16). The flipped
//        share at depths of 16, 32 and 64 products at fft 2^22, 2^23 and on
//        K7's view at 2^23 is in PERF.md: 64 flipped the fewest codes, 16
//        as many as the mma.sync body (its sums, to the digit). Registers:
//        two pieces' master sums (128) and one fragment (64). The two
//        consumers take turns at issuing a group (two named barriers), so
//        that one's wgmmas run on the tensor cores while the other waits
//        for its own group and adds it to its master sums.
//        Epilogue: each piece's f32 twiddles come as a slot of the ring
//        each consumer ([64 k1 x 64 n2] of twc and tws), issued behind the
//        tile's K slots, so they land while its last MMAs run; a quad
//        shuffle gives each thread two neighbouring n2 of one k1, T re and
//        T im rounded to bf16 once and stored as bf16 pairs.
//      Stage B: a tile is 128 k2 x 64 k1 (64 k2 x 128 k1 at N2 = 128, and
//        64 x 64 at N1 = 64 beside it, which both consumers sum and the
//        first stores). A K
//        slot holds the [cos 64; -sin 64] box pairs of the N2-point rows
//        (the K-major A operand) and the [T re 64; T im 64] box pairs of T
//        (the K-major B operand, straight from device memory); each
//        consumer takes its 64 k2 x 64 k1, m64n128k16 twice a k-step,
//        cos.tr and cos.ti in one fragment, -sin.tr and -sin.ti in the
//        other, chained over n2 (at fft 2^22 the chained stage B flipped
//        6.5e-5 of the codes against plain on the same T, 1.4e-5 with
//        each MMA's sum added in f32, on the mma.sync body), one group left
//        in flight while the next slot's run. Epilogue: the consumer's
//        rotation values ([64 k2 x 64 k1] of rotc and rots, the planes
//        viewed [batch·N2/2, N1]) come as a slot of the ring behind its K
//        slots; then re, im, the rotation, the requant (or the f32 store).
//      Bytes through L2 at fft 2^22 over 160 x S = 4 (640 spectra, 163,840
//      tiles a stage): a stage-A tile reads 32 K slots of 48 KB (1.5 MB:
//      2 x 128 x 256 x 2048 FLOP, 85 a byte), 128 KB of twiddles and writes
//      64 KB of T: 257.7 GB of operands, 21.5 GB of twiddles, 10.7 GB of T
//      a stage-A call; a stage-B tile the same 1.5 MB of operands, 64 KB of
//      rotation values, 16 KB of codes: 257.7 GB, 10.7 GB, 2.7 GB. The
//      mma.sync bodies read 343.6 GB of operands a stage (64 FLOP a byte:
//      one block a 64 x 128 or 64 x 64 tile). The tile is what the two
//      consumers' registers hold: stage A's two-level sums take a fragment
//      beside the master sums, so 128 x 256 sums a block. Clusters of two
//      blocks multicasting the shared operand (stage A: the chunk's
//      N1-point rows; stage B: the k2 rows), which cut a block's operand
//      boxes from six a slot to four, took 1.9 (stage A) and 1.7 (stage B)
//      times as long on the card (PERF.md §6), and were not kept.
//      Registers: 168 a thread at launch, 232 a consumer thread after
//      setmaxnreg; 0 spill bytes in both bodies and in the stageb stop's.
//    f32: k1_stage_a_f32_kernel (FFMA, 4 k1 x (cos, -sin) x 8 columns a
//    thread; T stored transposed, [n2][k1], so f32 stage B reads 4 k1 as
//    one float4) and k1_stage_b_f32_kernel (FFMA, 4 k2 x (cos, -sin) x 4 k1
//    x (T re, T im) a thread), one block a tile, each tile's K loop through
//    a cp.async ring.
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

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "wg_ring.cuh"

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
// Pass 2, N1 = 8: the DFT on mma.sync
// ---------------------------------------------------------------------------
constexpr int DFT_THREADS = 512;  // 16 warps: one block an SM
constexpr int PAD = 8;            // row padding (elements): conflict-free smem reads

using bf16 = __nv_bfloat16;

// A unit at N1 = 8: 16 spectra of 8 k1 rows, side by side as KC_N8 T rows
// (spectrum, k1).
constexpr int KC_N8 = 128;
constexpr int SB_N8 = KC_N8 / 8;
// Stage A: warps 4 x 4, each 4 spectra's 8 k1 rows (32 T rows) x 32 n2
// columns, N8_NA columns a tile. Stage B: warps 2 x 8, each 32 k2 rows x 16
// T columns (two spectra), N8_MB rows a tile.
constexpr int N8_NA = 128;
constexpr int N8_MB = 64;

struct DftParams {
  const bf16* plane;  // [G, S, 8, N2]
  const bf16* d1c;    // [8, 8] cos
  const bf16* d1s;    // [8, 8] -sin
  const bf16* d2;     // [N2, N2]: cos rows k2 < N2/2, then -sin rows
  const float* twc;   // [8, N2]
  const float* tws;
  const float* rotc;  // [G, C]
  const float* rots;
  void* outr;         // [G, S, C] int8, or f32 without the requant
  void* outi;
  int n_spectra, n2;
  int ktb;                // stage-B K-tile depth
  int n_ca, n_rb, n_ktb;  // stage-A column tiles; stage-B row tiles x K tiles
  int n_sblk;             // blocks of 16 spectra a batch
  int n_units;            // G * n_sblk
  int slot;               // bf16 elements per ring slot
  int stages;             // ring depth: 3 or 4
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
// blockIdx.x + i * gridDim.x), tile `local` of the unit: stage A's column
// tiles, then stage B's (row tile, K tile); the unit's (batch, spectra) only
// changes every tpu tiles.
struct Cursor {
  int i, local;
  int b, s;  // s: the unit's first spectrum
};

__device__ __forceinline__ void set_unit(const DftParams& p, Cursor& c) {
  const int u = blockIdx.x + c.i * gridDim.x;
  c.s = (u % p.n_sblk) * SB_N8;
  c.b = u / p.n_sblk;
}

__device__ __forceinline__ void advance(const DftParams& p, Cursor& c, int tpu) {
  if (++c.local == tpu) {
    c.local = 0;
    ++c.i;
    set_unit(p, c);
  }
}

// Issue the cp.async copies of one tile into a ring slot (every thread,
// 16 bytes a copy; rows land padded: conflict-free ldmatrix).
__device__ __forceinline__ void load_tile(const DftParams& p, const Cursor& c, bf16* slot) {
  const int tid = threadIdx.x, n2 = p.n2;
  if (c.local < p.n_ca) {
    // [KC_N8 x cols] of the plane: the unit's spectra, 8 rows each (their
    // N1-point matrix is in registers). Spectra past the stream's last are
    // not loaded (their T columns are never stored).
    const int lx = lg(min(N8_NA, n2) / 8), nx = KC_N8 << lx;
    const int rows = min(KC_N8, (p.n_spectra - c.s) * 8);
    const bf16* xsrc = p.plane + (static_cast<long long>(c.b) * p.n_spectra + c.s) * 8 * n2 +
                       c.local * N8_NA;
    for (int i = tid; i < nx; i += DFT_THREADS) {
      const int r = i >> lx, q = i & ((1 << lx) - 1);
      if (r < rows) {
        cp_async16(slot + r * (N8_NA + PAD) + q * 8, xsrc + static_cast<long long>(r) * n2 + q * 8);
      }
    }
  } else {
    // [rows x ktb] of the N2-point matrix's cos rows, then its -sin rows.
    const int l = c.local - p.n_ca, outer = l >> lg(p.n_ktb), kidx = l & (p.n_ktb - 1);
    const int ktb = p.ktb, ktp = ktb + PAD, h = n2 / 2;
    const int ld = lg(ktb / 8), nd = min(N8_MB, h) << ld;
    const int r0 = outer * N8_MB;
    for (int i = tid; i < 2 * nd; i += DFT_THREADS) {
      const int m = i >= nd, j = i - m * nd;
      const int r = j >> ld, q = j & ((1 << ld) - 1);
      const bf16* src = p.d2 + static_cast<long long>(m * h + r0 + r) * n2 + kidx * ktb + q * 8;
      cp_async16(slot + (m * N8_MB + r) * ktp + q * 8, src);
    }
  }
}

template <bool QUANT>
__global__ void __launch_bounds__(DFT_THREADS, 1) k1_dft_kernel(DftParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int n2 = p.n2, h = n2 / 2, C = 4 * n2;
  const int tld = n2 + PAD;
  const int stages = p.stages;
  bf16* sTr = smem;  // [KC_N8][N2 + PAD]
  bf16* sTi = sTr + KC_N8 * tld;
  bf16* ring = sTi + KC_N8 * tld;

  const int tpu = p.n_ca + p.n_rb * p.n_ktb;
  const int my_units = (p.n_units - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1;
  const int n_tiles = my_units * tpu;

  // Warp placement. Stage A: T rows a_r0.. (4 spectra), n2 columns a_c0.. of
  // the tile. Stage B: k2 rows b_r0.. of the row tile, T columns b_c0.. (two
  // spectra).
  const int a_r0 = (warp / 4) * 32, a_c0 = (warp % 4) * 32;
  const int b_r0 = (warp / 8) * 32, b_c0 = (warp % 8) * 16;

  // One register array for both stages' accumulators (64 f32 a thread).
  // Stage A: [4 spectra][4 n8][4], the m16n8k8 tile's rows g the cos sums and
  // g + 8 the -sin sums of k1 = g; stage B: [4 sums][2 m16][2 n8][4], sums
  // cos.tr, -sin.ti, cos.ti, -sin.tr.
  float acc[64];

  Cursor ld{0, 0, 0, 0};  // the next tile to load
  set_unit(p, ld);
  Cursor cc = ld;  // the tile to compute
  for (int t = 0; t < stages - 1; ++t) {
    if (t < n_tiles) {
      load_tile(p, ld, ring + t * p.slot);
      advance(p, ld, tpu);
    }
    cp_async_commit();
  }

  int slot_i = 0;  // tile t's slot, t % stages
  for (int t = 0; t < n_tiles; ++t, advance(p, cc, tpu)) {
    cp_async_wait_ring(stages);
    __syncthreads();  // tile t landed for every thread; tile t-1's slot is free
    if (t + stages - 1 < n_tiles) {
      const int s_load = slot_i == 0 ? stages - 1 : slot_i - 1;  // (t + stages - 1) % stages
      load_tile(p, ld, ring + s_load * p.slot);
      advance(p, ld, tpu);
    }
    cp_async_commit();
    const bf16* slot = ring + slot_i * p.slot;
    slot_i = slot_i + 1 == stages ? 0 : slot_i + 1;
    if (cc.local < p.n_ca) {
      const int col = cc.local * N8_NA + a_c0;  // first n2 column of the warp
      if (col >= n2) continue;
      const int xld = N8_NA + PAD;
      // The [cos; -sin] [16 x 8] A fragment of m16n8k8 (row g of each, from
      // L1), against the warp's 4 spectra, 8 rows each, x 4 column tiles of 8.
      const uint32_t a0 = __ldg(reinterpret_cast<const unsigned int*>(p.d1c + g * 8 + tig * 2));
      const uint32_t a1 = __ldg(reinterpret_cast<const unsigned int*>(p.d1s + g * 8 + tig * 2));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t fb[4];
        ldsm_x4_t(fb, slot + (a_r0 + j * 8 + lane % 8) * xld + a_c0 + (lane / 8) * 8);
#pragma unroll
        for (int m = 0; m < 4; ++m) mma1688(acc + (j * 4 + m) * 4, a0, a1, fb[m]);
      }
      // f32 twiddle, bf16 rounding, into the T planes.
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
    const int l = cc.local - p.n_ca, outer = l >> lg(p.n_ktb), kidx = l & (p.n_ktb - 1);
    const int row = outer * N8_MB + b_r0;  // first k2 row of the warp
    if (row >= h) continue;
    if (kidx == 0) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    }
    const int ktb = p.ktb, ktp = ktb + PAD;
    const bf16* sC = slot;
    const bf16* sS = slot + N8_MB * ktp;
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
        const int c = kidx * ktb + kk + ((lane / 8) % 2) * 8;
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
    if (kidx != p.n_ktb - 1) continue;
    // re = cos.tr - (-sin.ti), im = cos.ti + (-sin.tr); rotate; store. The
    // rotation planes' values are loaded together first. T column b_c0 + j *
    // 8 + e is k1 = tig * 2 + e of spectrum cc.s + b_c0 / 8 + j.
    const long long obase = (static_cast<long long>(cc.b) * p.n_spectra + cc.s) * C;
    const float* rc_b = p.rotc + static_cast<long long>(cc.b) * C;
    const float* rs_b = p.rots + static_cast<long long>(cc.b) * C;
    float2 rc[2][2], rs[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int ch = (row + i * 16 + g + hh * 8) * 8 + tig * 2;
        rc[i][hh] = __ldg(reinterpret_cast<const float2*>(rc_b + ch));
        rs[i][hh] = __ldg(reinterpret_cast<const float2*>(rs_b + ch));
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int sp = b_c0 / 8 + j;  // the column's spectrum in the unit
        if (cc.s + sp >= p.n_spectra) continue;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float* a0 = acc + (i * 2 + j) * 4 + hh * 2;
          const long long o =
              obase + static_cast<long long>(sp) * C + (row + i * 16 + g + hh * 8) * 8 + tig * 2;
          float v[2][2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float re = __fsub_rn(a0[e], a0[16 + e]);
            const float im = __fadd_rn(a0[32 + e], a0[48 + e]);
            const float c = e ? rc[i][hh].y : rc[i][hh].x;
            const float sn = e ? rs[i][hh].y : rs[i][hh].x;
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
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// N1 = 8's plan: the deepest stage-B K tiles (64, 32, 16) with 4 ring
// stages, else 3, that fit beside the unit's T planes (fewer barriers a
// unit); 0 where none does.
size_t dft_plan(DftParams& p) {
  const size_t t_bytes = sizeof(bf16) * 2 * static_cast<size_t>(KC_N8) * (p.n2 + PAD);
  for (int kt = 64; kt >= 16; kt /= 2) {
    if (kt > p.n2) continue;
    const int a_slot = KC_N8 * (N8_NA + PAD), b_slot = 2 * N8_MB * (kt + PAD);
    for (int stages = 4; stages >= 3; --stages) {
      const size_t bytes = t_bytes + sizeof(bf16) * static_cast<size_t>(stages) *
                                         static_cast<size_t>(max(a_slot, b_slot));
      if (bytes > MAX_SMEM) continue;
      p.ktb = kt;
      p.slot = max(a_slot, b_slot);
      p.stages = stages;
      p.n_ca = (p.n2 + N8_NA - 1) / N8_NA;
      p.n_rb = (p.n2 / 2 + N8_MB - 1) / N8_MB;
      p.n_ktb = p.n2 / kt;
      p.n_sblk = (p.n_spectra + SB_N8 - 1) / SB_N8;
      return bytes;
    }
  }
  return 0;
}

template <bool QUANT>
cudaError_t launch_dft(DftParams p, int batch, size_t bytes, cudaStream_t stream) {
  auto kern = k1_dft_kernel<QUANT>;
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
  const long long units = static_cast<long long>(batch) * p.n_sblk;
  const long long resident = static_cast<long long>(sms) * per_sm;
  const int grid = static_cast<int>(units < resident ? units : resident);
  // Unit indices and a block's tile count must fit an int.
  const long long tpu = p.n_ca + p.n_rb * p.n_ktb;
  if (units > 0x7fffffffLL - grid || ((units + grid - 1) / grid) * tpu > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  p.n_units = static_cast<int>(units);
  kern<<<grid, DFT_THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <bool QUANT>
int n8_dispatch(DftParams p, int batch, cudaStream_t st) {
  const size_t bytes = dft_plan(p);
  if (!bytes) return NO_PLAN;
  return static_cast<int>(launch_dft<QUANT>(p, batch, bytes, st));
}

// ---------------------------------------------------------------------------
// Pass 2, N1 >= 16: the DFT on wgmma, fed by TMA through an mbarrier ring
// ---------------------------------------------------------------------------
// (The design is at the head of the file, item 2.)
constexpr int WG_SLOT = 32768;       // bytes a ring slot
constexpr int WG_MAX_STAGES = 4;     // ring slots, at most
// Stage A's group depth in k-steps of 16 products: each group of wgmmas sums
// into a fragment from zero, which is then added to the master sums in f32
// round-to-nearest (PERF.md gives the flipped share at each depth).
constexpr int WG_GROUP = 4;

struct WgParams {
  const float* twc;  // [N1, N2]
  const float* tws;
  const float* rotc;  // [G, C]
  const float* rots;
  void* outr;  // [G, S, C] int8, or f32 without the requant
  void* outi;
  int n_spectra, n1, n2;
  int n_pass;    // stage-A passes a unit: N2 / 128 (a 64-column tile each consumer)
  int n_ka;      // stage-A K slots a pass: N1 / KD
  int n_pairs;   // stage-B steps a unit: pairs of (k2 tile, T column group) items
  int n_kb;      // stage-B K slots a step: N2 / 64
  int n_chunks;  // N1 / KC
  int n_units;   // G * S * n_chunks
  int stages;    // ring slots
};

// The unit's operands as 2-D tensor maps, 128-byte swizzle: bf16, the plane
// viewed [G * S * N1, N2] (boxes KD rows x 64 columns), the N1-point matrices
// [N1, N1] (boxes KC rows x 64 columns, columns past N1 read as zeros) and the
// row-stacked N2-point matrix [N2, N2] (boxes 64 x 64); f32, the twiddles
// [N1, N2] (boxes KC rows x 32 columns) and the rotation planes viewed [G *
// N2/2, N1] (row b N2/2 + k2, column k1; boxes 64 rows x 32 columns).
struct WgMaps {
  CUtensorMap plane, d1c, d1s, d2, twc, tws, rotc, rots;
};

// Boxes of 32 f32 columns a rotation slot takes for each plane: an item's NB
// columns, or one box where NB < 32 (its other columns unread).
__host__ __device__ constexpr int wg_rot_boxes(int nb) { return nb < 32 ? 1 : nb / 32; }

// Shared-memory bytes of the T planes of a KC-row chunk.
__host__ __device__ constexpr int wg_t_bytes(int kc, int n2) { return 2 * kc * n2 * 2; }

// The unit u's spectrum (flat over the group's streams) and first k1 row.
struct WgUnit {
  int spec, k0;
};

__device__ __forceinline__ WgUnit wg_unit(const WgParams& p, int u, int kc) {
  return WgUnit{u / p.n_chunks, (u % p.n_chunks) * kc};
}

// Stage B's item i of a unit: k2 tile m (64 cos rows and the matching -sin
// rows) x T column group c (NB k1 of T re, NB of T im). Where N2 = 128 has
// one k2 tile, a chunk has two column groups; else one, and a tile an item.
template <int KC, int NB>
struct WgItem {
  int m, c;
  __device__ __forceinline__ WgItem(int i) : m(i / (KC / NB)), c(i % (KC / NB)) {}
};

template <int KC, int NB, int KD, bool QUANT, int STOP = STOP_NONE>
__global__ void __launch_bounds__(WG_THREADS, 1)
    k1_dft_wg_kernel(const WgParams p, const __grid_constant__ WgMaps maps) {
  static_assert(STOP == STOP_NONE || STOP == STOP_STAGEA || STOP == STOP_STAGEA_RND ||
                    STOP == STOP_STAGEB,
                "the DFT pass's stops");
  static_assert(STOP != STOP_STAGEA || QUANT, "P5's stagea writes int8");
  constexpr bool STAGEA_STOP = STOP == STOP_STAGEA || STOP == STOP_STAGEA_RND;
  constexpr int NKS = KD / 16;                // k-steps a stage-A slot
  constexpr int GS = WG_GROUP < NKS ? WG_GROUP : NKS;  // k-steps a stage-A group
  constexpr int A_BYTES = 2 * KD * WG_ROW + 2 * KC * WG_ROW;  // a stage-A slot's TMA bytes
  static_assert(NKS % GS == 0 && A_BYTES <= WG_SLOT, "stage-A slot");
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t base = (smem_u32(wg_smem) + WG_ALIGN - 1) & ~static_cast<uint32_t>(WG_ALIGN - 1);
  const int n1 = p.n1, n2 = p.n2, h = n2 / 2, C = n1 * h;
  const uint32_t t_base = base;                                 // T planes
  const uint32_t ring = base + wg_t_bytes(KC, n2);              // p.stages slots
  const uint32_t full = ring + p.stages * WG_SLOT;              // an mbarrier a slot
  const uint32_t empty = full + 8 * WG_MAX_STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      wg_mbar_init(full + 8 * s, 1);   // the producer's arrival and the slot's bytes
      wg_mbar_init(empty + 8 * s, 2);  // one arrival a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  const int my_units = (p.n_units - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1;

  if (wg == 0) {
    // The producer: one thread walks the units' slots in the consumers'
    // order, each slot's boxes issued once both consumers released it.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(WG_PRODUCER_REGS));
    if (threadIdx.x != 0) return;
    WgRing r;
    for (int i = 0; i < my_units; ++i) {
      const WgUnit u = wg_unit(p, blockIdx.x + i * gridDim.x, KC);
      const int prow = u.spec * n1;  // the spectrum's first row of the plane view
      for (int pa = 0; pa < p.n_pass; ++pa) {
        for (int ka = 0; ka < p.n_ka; ++ka, r.next(p.stages)) {
          wg_mbar_wait(empty + 8 * r.slot, r.phase ^ 1);
          const uint32_t s = ring + r.slot * WG_SLOT, bar = full + 8 * r.slot;
          wg_mbar_expect(bar, A_BYTES);
          wg_tma(s, &maps.plane, 128 * pa, prow + ka * KD, bar);
          wg_tma(s + KD * WG_ROW, &maps.plane, 128 * pa + 64, prow + ka * KD, bar);
          wg_tma(s + 2 * KD * WG_ROW, &maps.d1c, ka * 64, u.k0, bar);
          wg_tma(s + 2 * KD * WG_ROW + KC * WG_ROW, &maps.d1s, ka * 64, u.k0, bar);
        }
        // Each consumer's twiddles for the pass, a slot each: [KC x 64] of
        // twc, then of tws, as two boxes of 32 columns.
        for (int w = 0; w < 2; ++w, r.next(p.stages)) {
          wg_mbar_wait(empty + 8 * r.slot, r.phase ^ 1);
          const uint32_t s = ring + r.slot * WG_SLOT, bar = full + 8 * r.slot;
          wg_mbar_expect(bar, 4 * KC * WG_ROW);
          const int c0 = 64 * (2 * pa + w);
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            wg_tma(s + x * KC * WG_ROW, x < 2 ? &maps.twc : &maps.tws, c0 + 32 * (x & 1), u.k0,
                   bar);
          }
        }
      }
      if constexpr (!STAGEA_STOP) {
        for (int q = 0; q < p.n_pairs; ++q) {
          for (int kb = 0; kb < p.n_kb; ++kb, r.next(p.stages)) {
            wg_mbar_wait(empty + 8 * r.slot, r.phase ^ 1);
            const uint32_t s = ring + r.slot * WG_SLOT, bar = full + 8 * r.slot;
            wg_mbar_expect(bar, WG_SLOT);
#pragma unroll
            for (int w = 0; w < 2; ++w) {
              const WgItem<KC, NB> it(2 * q + w);
              wg_tma(s + w * 16384, &maps.d2, kb * 64, 64 * it.m, bar);
              wg_tma(s + w * 16384 + 8192, &maps.d2, kb * 64, h + 64 * it.m, bar);
            }
          }
          if constexpr (STOP == STOP_NONE) {
            // Each consumer's rotation values for its item, a slot each:
            // [64 k2 x NB k1] of rotc, then of rots.
            constexpr int RB = wg_rot_boxes(NB);
            for (int w = 0; w < 2; ++w, r.next(p.stages)) {
              wg_mbar_wait(empty + 8 * r.slot, r.phase ^ 1);
              const uint32_t s = ring + r.slot * WG_SLOT, bar = full + 8 * r.slot;
              wg_mbar_expect(bar, 2 * RB * 64 * WG_ROW);
              const WgItem<KC, NB> it(2 * q + w);
              const int row = (u.spec / p.n_spectra) * h + 64 * it.m, col = u.k0 + it.c * NB;
#pragma unroll
              for (int x = 0; x < 2 * RB; ++x) {
                wg_tma(s + x * 64 * WG_ROW, x < RB ? &maps.rotc : &maps.rots, col + 32 * (x % RB),
                       row, bar);
              }
            }
          }
        }
      }
    }
    return;
  }

  // A consumer warpgroup (cw 0 or 1): stage A's 64-column tiles 2 pa + cw,
  // stage B's items 2 q + cw.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(WG_CONSUMER_REGS));
  const int cw = wg - 1, wt = threadIdx.x - 128 * wg;
  const int wq = wt / 32, lane = wt % 32, g = lane / 4, t = lane % 4;
  const bool odd = g & 1;
  WgRing r;
  for (int i = 0; i < my_units; ++i) {
    const WgUnit u = wg_unit(p, blockIdx.x + i * gridDim.x, KC);
    for (int pa = 0; pa < p.n_pass; ++pa) {
      const int nt = 2 * pa + cw;  // this warpgroup's 64-column tile of n2
      // The tile's sums, [n2 rows 64] x [cos KC | -sin KC] (the fragment of
      // m64n(2 KC)): a group's, and the master sums.
      float part[KC], sums[KC];
#pragma unroll
      for (int k = 0; k < KC; ++k) part[k] = sums[k] = 0.f;
      for (int ka = 0; ka < p.n_ka; ++ka, r.next(p.stages)) {
        wg_mbar_wait(full + 8 * r.slot, r.phase);
        const uint32_t s = ring + r.slot * WG_SLOT;
        const uint32_t xa = s + cw * KD * WG_ROW, db = s + 2 * KD * WG_ROW;
#pragma unroll
        for (int k = 0; k < NKS; k += GS) {
          wg_hold(part);
          wg_fence();
#pragma unroll
          for (int j = 0; j < GS; ++j) {
            Wgmma<2 * KC>::template run<1>(part, wg_desc_mn(xa + (k + j) * 16 * WG_ROW),
                                           wg_desc_k(db + (k + j) * 32), j);
          }
          wg_commit();
          wg_wait<0>();
          wg_hold(part);
#pragma unroll
          for (int e = 0; e < KC; ++e) sums[e] = __fadd_rn(sums[e], part[e]);
        }
        if (wt == 0) wg_mbar_arrive(empty + 8 * r.slot);
      }
      // The f32 twiddle, then T rounded to bf16 into the swizzled K-major
      // layout stage B reads ([T re NB; T im NB] rows a column group, 64-
      // column blocks), or a stagea stop's rows k1 < N1/2. Fragment element
      // (row 16 wq + g + 8 hh, column 8 j + 2 t + e): a quad shuffle gives
      // this thread k1 = 8 j + 2 t + odd at two neighbouring n2.
      // The twiddle slots: this warpgroup's kept for the epilogue, the
      // other's released once it has landed (so that the arrival counts
      // toward this use of the slot).
      uint32_t tw = 0, tw_slot = 0;
      for (int w = 0; w < 2; ++w, r.next(p.stages)) {
        wg_mbar_wait(full + 8 * r.slot, r.phase);
        if (w == cw) {
          tw = ring + r.slot * WG_SLOT;
          tw_slot = r.slot;
        } else if (wt == 0) {
          wg_mbar_arrive(empty + 8 * r.slot);
        }
      }
      if constexpr (!STAGEA_STOP) {
        if (pa == 0) wg_consumers_sync();  // both warpgroups are done with the last unit's T
      }
      const int col = 64 * nt + 16 * wq + (g & ~1);
      long long stop_o = -1;
      if constexpr (STAGEA_STOP) {
        if (u.k0 < n1 / 2) stop_o = static_cast<long long>(u.spec) * C + static_cast<long long>(u.k0) * n2;
      }
#pragma unroll
      for (int j = 0; j < KC / 8; ++j) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float* c = sums + 4 * j + 2 * hh;
          const float* sn = c + KC / 2;
          const float rr = __shfl_xor_sync(~0u, odd ? c[0] : c[1], 4);
          const float ri = __shfl_xor_sync(~0u, odd ? sn[0] : sn[1], 4);
          const float ar0 = odd ? rr : c[0], ar1 = odd ? c[1] : rr;
          const float ai0 = odd ? ri : sn[0], ai1 = odd ? sn[1] : ri;
          const int k1 = 8 * j + 2 * t + odd, n = col + 8 * hh, nb = n % 64;
          const uint32_t tb = tw + (nb / 32) * KC * WG_ROW;
          const float2 c2 = wg_ld_f2(wg_f32_at(tb, k1, nb % 32));
          const float2 s2 = wg_ld_f2(wg_f32_at(tb + 2 * KC * WG_ROW, k1, nb % 32));
          const float tr0 = __fsub_rn(__fmul_rn(ar0, c2.x), __fmul_rn(ai0, s2.x));
          const float tr1 = __fsub_rn(__fmul_rn(ar1, c2.y), __fmul_rn(ai1, s2.y));
          const float ti0 = __fadd_rn(__fmul_rn(ar0, s2.x), __fmul_rn(ai0, c2.x));
          const float ti1 = __fadd_rn(__fmul_rn(ar1, s2.y), __fmul_rn(ai1, c2.y));
          if constexpr (STOP == STOP_STAGEA) {
            // P5's slice of T, before the rounding: rows k1 < N1/2.
            if (stop_o >= 0) {
              stop_store2<true>(p.outr, stop_o + static_cast<long long>(k1) * n2 + n, tr0, tr1);
              stop_store2<true>(p.outi, stop_o + static_cast<long long>(k1) * n2 + n, ti0, ti1);
            }
          } else if constexpr (STOP == STOP_STAGEA_RND) {
            // The reference's slice: the rounded T, rows k1 < N1/2.
            if (stop_o >= 0) {
              const long long so = stop_o + static_cast<long long>(k1) * n2 + n;
              stop_store2<QUANT>(p.outr, so, round_bf16(tr0), round_bf16(tr1));
              stop_store2<QUANT>(p.outi, so, round_bf16(ti0), round_bf16(ti1));
            }
          } else {
            const int row = (k1 / NB) * 2 * NB + k1 % NB;  // T re's row; T im's NB on
            const uint32_t blk = t_base + nt * (2 * KC * WG_ROW);
            const uint32_t a_re = blk + (row / 8) * 1024 + (row % 8) * WG_ROW +
                                  (((nb / 8) ^ (row % 8)) << 4) + (nb % 8) * 2;
            const uint32_t a_im = a_re + (NB / 8) * 1024;
            const __nv_bfloat162 vr = __floats2bfloat162_rn(tr0, tr1);
            const __nv_bfloat162 vi = __floats2bfloat162_rn(ti0, ti1);
            asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a_re),
                         "r"(*reinterpret_cast<const uint32_t*>(&vr))
                         : "memory");
            asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a_im),
                         "r"(*reinterpret_cast<const uint32_t*>(&vi))
                         : "memory");
          }
        }
      }
      wg_warpgroup_sync(cw);  // every thread's twiddles are read
      if (wt == 0) wg_mbar_arrive(empty + 8 * tw_slot);
    }
    if constexpr (STAGEA_STOP) continue;
    wg_proxy_fence();
    wg_consumers_sync();  // T is whole

    // Stage B: [cos rows; -sin rows of the item's k2 tile] x [T re | T im] of
    // its column group: cos.tr, cos.ti in one fragment, -sin.tr, -sin.ti in
    // the other, the wgmmas chained over n2.
    for (int q = 0; q < p.n_pairs; ++q) {
      const WgItem<KC, NB> it(2 * q + cw);
      float fc[NB], fs[NB];
#pragma unroll
      for (int k = 0; k < NB; ++k) fc[k] = fs[k] = 0.f;
      const uint32_t tb = t_base + (it.c * 2 * NB / 8) * 1024;
      // A slot is released once the next slot's wgmmas are issued and its
      // own have completed: one group stays in flight.
      int held = 0;
      wg_hold(fc);
      wg_hold(fs);
      const long long obase = static_cast<long long>(u.spec) * C;
      const int ch0 = (64 * it.m + 16 * wq + g) * n1 + u.k0 + it.c * NB + 2 * t;
      for (int kb = 0; kb < p.n_kb; ++kb, r.next(p.stages)) {
        wg_mbar_wait(full + 8 * r.slot, r.phase);
        const uint32_t dc = ring + r.slot * WG_SLOT + cw * 16384, ds = dc + 8192;
        const uint32_t tk = tb + kb * (2 * KC * WG_ROW);
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const int acc = kb > 0 || ks > 0;
          Wgmma<2 * NB>::template run<0>(fc, wg_desc_k(dc + ks * 32), wg_desc_k(tk + ks * 32), acc);
          Wgmma<2 * NB>::template run<0>(fs, wg_desc_k(ds + ks * 32), wg_desc_k(tk + ks * 32), acc);
        }
        wg_commit();
        wg_wait<1>();
        if (kb > 0 && wt == 0) wg_mbar_arrive(empty + 8 * held);
        held = r.slot;
      }
      wg_wait<0>();
      wg_hold(fc);
      wg_hold(fs);
      if (wt == 0) wg_mbar_arrive(empty + 8 * held);
      // The rotation slots, as stage A's twiddle slots.
      uint32_t rot = 0, rot_slot = 0;
      if constexpr (STOP == STOP_NONE) {
        for (int w = 0; w < 2; ++w, r.next(p.stages)) {
          wg_mbar_wait(full + 8 * r.slot, r.phase);
          if (w == cw) {
            rot = ring + r.slot * WG_SLOT;
            rot_slot = r.slot;
          } else if (wt == 0) {
            wg_mbar_arrive(empty + 8 * r.slot);
          }
        }
      }
      // re = cos.tr - (-sin.ti), im = cos.ti + (-sin.tr); rotate; store.
      // Fragment element (row 16 wq + g + 8 hh, column 8 j + 2 t + e): T re's
      // columns j < NB / 8, T im's NB / 8 on.
#pragma unroll
      for (int j = 0; j < NB / 8; ++j) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int ch = ch0 + 8 * hh * n1 + 8 * j;
          const float* cr = fc + 4 * j + 2 * hh;
          const float* sr = fs + 4 * j + 2 * hh;
          float re[2], im[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            re[e] = __fsub_rn(cr[e], sr[NB / 2 + e]);
            im[e] = __fadd_rn(cr[NB / 2 + e], sr[e]);
          }
          if constexpr (STOP == STOP_STAGEB) {
            // re, im without the rotation, truncated or f32.
            stop_store2<QUANT>(p.outr, obase + ch, re[0], re[1]);
            stop_store2<QUANT>(p.outi, obase + ch, im[0], im[1]);
          } else {
            // Rotation element (k2 row 16 wq + g + 8 hh, k1 column 8 j + 2 t)
            // of the item's staged [64 x NB] planes.
            constexpr int RB = wg_rot_boxes(NB);
            const int x = 8 * j + 2 * t, rr = 16 * wq + g + 8 * hh;
            const uint32_t rb = rot + (x / 32) * 64 * WG_ROW;
            const float2 rc = wg_ld_f2(wg_f32_at(rb, rr, x % 32));
            const float2 rs = wg_ld_f2(wg_f32_at(rb + RB * 64 * WG_ROW, rr, x % 32));
            float v[2][2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float c = e ? rc.y : rc.x, sn = e ? rs.y : rs.x;
              v[0][e] = __fsub_rn(__fmul_rn(re[e], c), __fmul_rn(im[e], sn));
              v[1][e] = __fadd_rn(__fmul_rn(re[e], sn), __fmul_rn(im[e], c));
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
      if constexpr (STOP == STOP_NONE) {
        wg_warpgroup_sync(cw);  // every thread's rotation values are read
        if (wt == 0) wg_mbar_arrive(empty + 8 * rot_slot);
      }
    }
  }
}

// The wgmma body's plan at N1 x N2: the chunk (KC k1 rows; 32 at N2 = 1024,
// where 64 rows' T planes would not fit), stage B's column group (NB k1
// columns: half a chunk at N2 = 128, which has one k2 tile, so that both
// consumers have an item), the plane's K rows a slot (KD) and the ring
// slots that fit beside the T planes. False where the body has none: N1 <
// 16, N2 outside 128..1024, or N1 < 64 beside N2 > 128 (no split of
// _split_ct's).
struct WgPlan {
  int kc, nb, kd, stages;
  size_t smem;
};

bool wg_plan(int n1, int n2, WgPlan& w) {
  if (n1 < 16 || n2 < 128 || n2 > 1024 || (n1 & (n1 - 1)) || (n2 & (n2 - 1))) return false;
  if (n1 < 64 && n2 != 128) return false;
  w.kc = n2 == 1024 ? 32 : min(n1, 64);
  w.nb = n2 == 128 ? w.kc / 2 : w.kc;
  w.kd = min(n1, 64);
  const size_t fixed = wg_t_bytes(w.kc, n2) + 2 * 8 * WG_MAX_STAGES + WG_ALIGN;
  if (fixed + 2 * static_cast<size_t>(WG_SLOT) > MAX_SMEM) return false;
  w.stages = static_cast<int>(std::min<size_t>(WG_MAX_STAGES, (MAX_SMEM - fixed) / WG_SLOT));
  w.smem = fixed + static_cast<size_t>(w.stages) * WG_SLOT;
  return true;
}

template <int KC, int NB, int KD>
struct WgShape {
  static constexpr int kc = KC, nb = NB, kd = KD;
};

// Calls fn(WgShape<KC, NB, KD>, plan) at the plan for N1 x N2, or returns
// NO_PLAN.
template <typename Fn>
int with_wg_plan(int n1, int n2, Fn fn) {
  WgPlan w;
  if (!wg_plan(n1, n2, w)) return NO_PLAN;
  if (w.kc == 64) return w.nb == 64 ? fn(WgShape<64, 64, 64>{}, w) : fn(WgShape<64, 32, 64>{}, w);
  if (w.kc == 32) return w.kd == 64 ? fn(WgShape<32, 32, 64>{}, w) : fn(WgShape<32, 16, 32>{}, w);
  return fn(WgShape<16, 8, 16>{}, w);
}

// A DFT-pass call on the wgmma body: the operands, the shape, the plan.
struct WgCall {
  const void *plane, *d1c, *d1s, *d2;
  WgParams p;
  int batch;
  WgPlan w;
};

template <int KC, int NB, int KD, bool QUANT, int STOP = STOP_NONE>
cudaError_t launch_wg(const WgCall& call, cudaStream_t stream) {
  auto kern = k1_dft_wg_kernel<KC, NB, KD, QUANT, STOP>;
  WgParams p = call.p;
  const int n1 = p.n1, n2 = p.n2;
  if (!aligned_to(call.plane, 16) || !aligned_to(call.d1c, 16) || !aligned_to(call.d1s, 16) ||
      !aligned_to(call.d2, 16) || !aligned_to(p.twc, 16) || !aligned_to(p.tws, 16) ||
      !aligned_to(p.rotc, 16) || !aligned_to(p.rots, 16)) {
    return cudaErrorInvalidValue;
  }
  WgMaps maps{};
  const unsigned long long rows = static_cast<unsigned long long>(call.batch) * p.n_spectra * n1;
  if (!wg_map(maps.plane, call.plane, n2, rows, KD) || !wg_map(maps.d1c, call.d1c, n1, n1, KC) ||
      !wg_map(maps.d1s, call.d1s, n1, n1, KC) || !wg_map(maps.d2, call.d2, n2, n2, 64) ||
      !wg_map(maps.twc, p.twc, n2, n1, KC, true) || !wg_map(maps.tws, p.tws, n2, n1, KC, true)) {
    return cudaErrorNotSupported;
  }
  const unsigned long long rot_rows = static_cast<unsigned long long>(call.batch) * (n2 / 2);
  if (STOP == STOP_NONE && (!wg_map(maps.rotc, p.rotc, n1, rot_rows, 64, true) ||
                            !wg_map(maps.rots, p.rots, n1, rot_rows, 64, true))) {
    return cudaErrorNotSupported;
  }
  p.n_pass = n2 / 128;
  p.n_ka = n1 / KD;
  p.n_pairs = (n2 / 128) * (KC / NB) / 2;
  p.n_kb = n2 / 64;
  p.n_chunks = n1 / KC;
  p.stages = call.w.stages;
  const long long units = static_cast<long long>(call.batch) * p.n_spectra * p.n_chunks;
  if (units < 1 || units > 0x7fffffffLL || rows > 0x7fffffffULL) return cudaErrorInvalidValue;
  p.n_units = static_cast<int>(units);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(call.w.smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
    return err;
  }
  const int grid = static_cast<int>(units < sms ? units : sms);
  kern<<<grid, WG_THREADS, call.w.smem, stream>>>(p, maps);
  return cudaGetLastError();
}

// The production body's registers and local (spill) bytes.
template <int KC, int NB, int KD, bool QUANT, int STOP = STOP_NONE>
cudaError_t wg_attributes(cudaFuncAttributes& a) {
  return cudaFuncGetAttributes(&a, k1_dft_wg_kernel<KC, NB, KD, QUANT, STOP>);
}

WgCall wg_call(const void* plane, const void* d1c, const void* d1s, const void* d2,
               const void* twc, const void* tws, const void* rotc, const void* rots, void* outr,
               void* outi, int batch, int n_spectra, int n1, int n2) {
  WgCall c{};
  c.plane = plane;
  c.d1c = d1c;
  c.d1s = d1s;
  c.d2 = d2;
  c.p.twc = static_cast<const float*>(twc);
  c.p.tws = static_cast<const float*>(tws);
  c.p.rotc = static_cast<const float*>(rotc);
  c.p.rots = static_cast<const float*>(rots);
  c.p.outr = outr;
  c.p.outi = outi;
  c.p.n_spectra = n_spectra;
  c.p.n1 = n1;
  c.p.n2 = n2;
  c.batch = batch;
  return c;
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
// device memory (see the head of the file, item 3). bf16: the two wgmma
// bodies below (k1_stage_a_wg_kernel, k1_stage_b_wg_kernel). f32: one block
// a tile, each tile's K loop through a cp.async ring; f32 stage B fits 128
// registers with its tile copies in rolled loops (unrolled, their hoisted
// addresses spilled); f32 stage A takes 150 registers, one block an SM (at
// two it spilled 8 bytes). No body spills.
// ---------------------------------------------------------------------------
constexpr int TP_THREADS = 256;  // the f32 bodies: 8 warps
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

// The f32 stage B's epilogue for four adjacent k1 of one k2: re = cos.tr -
// (-sin.ti), im = cos.ti + (-sin.tr) from the four sums s[0..3][e], then the
// rotation and the requant (or the f32 values) at out + o; at STOP_STAGEB re
// and im themselves, truncated (or f32).
template <bool QUANT, int STOP = STOP_NONE>
__device__ __forceinline__ void stage_b_store(const StageParams& p, long long o,
                                              const float (&s)[4][4], const float* rc,
                                              const float* rs) {
  float v[2][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
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
  if constexpr (STOP == STOP_STAGEB) {
    stop_store4<QUANT>(p.outr, o, make_float4(v[0][0], v[0][1], v[0][2], v[0][3]));
    stop_store4<QUANT>(p.outi, o, make_float4(v[1][0], v[1][1], v[1][2], v[1][3]));
  } else if constexpr (QUANT) {
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

// ---------------------------------------------------------------------------
// The three-pass route's bf16 stages on wgmma (the design is at the head of
// the file, item 3). Both bodies: one persistent block of WG_THREADS an SM
// (the producer warpgroup, then two consumer warpgroups, registers
// rebalanced by setmaxnreg as the DFT pass's), a ring of TP_STAGES slots of
// TP_SLOT bytes, each a K step of 64: six boxes of 64 rows x 128 bytes
// (128-byte swizzle) of the two operands, or four of a consumer's f32
// epilogue operand.
// ---------------------------------------------------------------------------
static_assert(TP_SMEM <= MAX_SMEM, "the three-pass ring");
// Stage A's group depth in k-steps of 16 products: each group of wgmmas sums
// into a fragment from zero, which is then added to the master sums in f32
// round-to-nearest (PERF.md gives the flipped share at each depth). A slot's
// 4 k-steps hold a whole number of groups.
constexpr int SA_GROUP = 4;

// The consumers' turns at issuing wgmma groups (named barriers 4 and 5,
// both consumer warpgroups): a consumer waits for its turn, issues a group,
// then gives the other its turn, so that one's group runs on the tensor
// cores while the other waits for its own and joins it to its master sums.
__device__ __forceinline__ void tp_turn_wait(int cw) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(4 + cw) : "memory");
}

__device__ __forceinline__ void tp_turn_give(int cw) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(5 - cw) : "memory");
}

// Stage A: T = twiddle(D1 @ plane) of each spectrum, rounded to bf16.
struct SaParams {
  bf16* tr;  // [m, N1, N2]
  bf16* ti;
  int n1, n2;
  int n_ct;     // a spectrum's column tiles: N2 / 128
  int n_rt;     // its chunks of 64 P k1
  int n_ka;     // K slots a tile: N1 / 64
  int n_tiles;  // m * n_rt * n_ct
};

// 2-D tensor maps, 128-byte swizzle, boxes of 64 rows: the plane viewed [m *
// N1, N2] (64 columns a box), the N1-point matrices [N1, N1] (64 columns),
// the f32 twiddles [N1, N2] (32 columns).
struct SaMaps {
  CUtensorMap plane, d1c, d1s, twc, tws;
};

#ifndef K1_STAGE_STOPS
// lo and hi rounded to bf16 as one 32-bit word, lo in the low half.
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A tile is 128 n2 columns (a 64-column tile each consumer) x a chunk of 64 P
// k1 (P pieces of 64, each a [cos 64; -sin 64] box pair of the N1-point
// rows). A K slot: the two plane tiles [64 n1 x 64 n2] (wgmma's M-major A
// operand, imm-trans-a), then the chunk's P box pairs (the K-major B
// operand); then each piece's twiddles, a slot each consumer.
//
// STREAMS: K7's stage A on the plane's [N1, 2·N2] view (p.n2 = 2·N2; view
// column 2·n2 + q is stream q's n2, csrc/fengine_dit.cu), T re and im stored
// as each stream's [N1, N2] plane, [m, 2, N1, N2], the K-major operand of
// K7's stage B: the four lanes of a k1 swap their values so that each stores
// one 16-byte run (8 n2 of one stream's T re or T im). The values are those
// of K1's layout, bit for bit.
template <int P, bool STREAMS = false>
__global__ void __launch_bounds__(WG_THREADS, 1)
    k1_stage_a_wg_kernel(const SaParams p, const __grid_constant__ SaMaps maps) {
  constexpr int NKS = 4;  // k-steps of 16 a slot
  constexpr int GS = SA_GROUP;
  static_assert(NKS % GS == 0 && (2 + 2 * P) * TP_BOX <= TP_SLOT, "stage-A slot");
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  uint32_t full, empty;
  const uint32_t ring = tp_ring_init(wg_smem, full, empty);
  const int wg = threadIdx.x / 128;
  const int my_tiles = (p.n_tiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1;

  if (wg == 0) {
    // The producer: one thread walks the tiles' slots in the consumers'
    // order, each slot's boxes issued once both consumers released it.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(WG_PRODUCER_REGS));
    if (threadIdx.x != 0) return;
    WgRing r;
    for (int i = 0; i < my_tiles; ++i) {
      const TpTile u = tp_tile(blockIdx.x + i * gridDim.x, p.n_ct, p.n_rt);
      const int prow = u.spec * p.n1, col = 128 * u.c, k0 = 64 * P * u.r;
      for (int ka = 0; ka < p.n_ka; ++ka, r.next(TP_STAGES)) {
        wg_mbar_wait(empty + 8 * r.slot, r.phase ^ 1);
        const uint32_t s = ring + r.slot * TP_SLOT, bar = full + 8 * r.slot;
        wg_mbar_expect(bar, (2 + 2 * P) * TP_BOX);
        wg_tma(s, &maps.plane, col, prow + 64 * ka, bar);
        wg_tma(s + TP_BOX, &maps.plane, col + 64, prow + 64 * ka, bar);
#pragma unroll
        for (int pc = 0; pc < P; ++pc) {
          wg_tma(s + (2 + 2 * pc) * TP_BOX, &maps.d1c, 64 * ka, k0 + 64 * pc, bar);
          wg_tma(s + (3 + 2 * pc) * TP_BOX, &maps.d1s, 64 * ka, k0 + 64 * pc, bar);
        }
      }
      // Each piece's twiddles, a slot each consumer: [64 k1 x 64 n2] of twc,
      // then of tws, as two boxes of 32 columns each.
      for (int pc = 0; pc < P; ++pc) {
        for (int w = 0; w < 2; ++w, r.next(TP_STAGES)) {
          wg_mbar_wait(empty + 8 * r.slot, r.phase ^ 1);
          const uint32_t s = ring + r.slot * TP_SLOT, bar = full + 8 * r.slot;
          wg_mbar_expect(bar, 4 * TP_BOX);
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            wg_tma(s + x * TP_BOX, x < 2 ? &maps.twc : &maps.tws, col + 64 * w + 32 * (x & 1),
                   k0 + 64 * pc, bar);
          }
        }
      }
    }
    return;
  }

  // A consumer warpgroup (cw 0 or 1): the tile's n2 columns 64 cw.., every
  // piece of its chunk.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(WG_CONSUMER_REGS));
  const int cw = wg - 1, wt = threadIdx.x - 128 * wg;
  const int wq = wt / 32, lane = wt % 32, g = lane / 4, t = lane % 4;
  const bool odd = g & 1;
  float part[64];  // a group's sums: [n2 rows 64] x [cos 64 | -sin 64] (m64n128)
#pragma unroll
  for (int k = 0; k < 64; ++k) part[k] = 0.f;
  // Groups left to issue: the second consumer's last gives no turn.
  int groups = my_tiles * p.n_ka * P * (NKS / GS);
  if (cw == 1) tp_turn_give(cw);  // the first consumer's first turn
  WgRing r;
  for (int i = 0; i < my_tiles; ++i) {
    const TpTile u = tp_tile(blockIdx.x + i * gridDim.x, p.n_ct, p.n_rt);
    float sums[P][64];  // each piece's master sums
#pragma unroll
    for (int pc = 0; pc < P; ++pc) {
#pragma unroll
      for (int k = 0; k < 64; ++k) sums[pc][k] = 0.f;
    }
    for (int ka = 0; ka < p.n_ka; ++ka, r.next(TP_STAGES)) {
      wg_mbar_wait(full + 8 * r.slot, r.phase);
      const uint32_t s = ring + r.slot * TP_SLOT, xa = s + cw * TP_BOX;
#pragma unroll
      for (int pc = 0; pc < P; ++pc) {
        const uint32_t db = s + (2 + 2 * pc) * TP_BOX;
#pragma unroll
        for (int k = 0; k < NKS; k += GS) {
          // A group: in this consumer's turn, GS wgmmas summed from zero, then
          // joined to the piece's master sums while the other's group runs.
          tp_turn_wait(cw);
          wg_hold(part);
          wg_fence();
#pragma unroll
          for (int j = 0; j < GS; ++j) {
            Wgmma<128>::template run<1>(part, wg_desc_mn(xa + (k + j) * 16 * WG_ROW),
                                        wg_desc_k(db + (k + j) * 32), j);
          }
          wg_commit();
          if (cw == 0 || --groups > 0) tp_turn_give(cw);
          wg_wait<0>();
          wg_hold(part);
#pragma unroll
          for (int e = 0; e < 64; ++e) sums[pc][e] = __fadd_rn(sums[pc][e], part[e]);
        }
      }
      if (wt == 0) wg_mbar_arrive(empty + 8 * r.slot);
    }
    // Each piece: the f32 twiddle (its pairs from this warpgroup's staged
    // slot), then T rounded to bf16 and stored. Fragment element (row 16 wq +
    // g + 8 hh, column 8 j + 2 t + e): a quad shuffle gives this thread k1 =
    // 8 j + 2 t + odd at two neighbouring n2, one bf16 pair of T re and of T
    // im.
    const long long tbase = static_cast<long long>(u.spec) * p.n1 * p.n2;
    const int n2a = 128 * u.c + 64 * cw;
#pragma unroll
    for (int pc = 0; pc < P; ++pc) {
      int tw_slot = 0;
      const uint32_t tw = tp_own_slot(r, ring, full, empty, cw, wt, tw_slot);
      const int k1a = 64 * (P * u.r + pc);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float kept[4];  // STREAMS: hh 0's T re and T im of both streams
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float* c = sums[pc] + 4 * j + 2 * hh;
          const float* sn = c + 32;
          const float rr = __shfl_xor_sync(~0u, odd ? c[0] : c[1], 4);
          const float ri = __shfl_xor_sync(~0u, odd ? sn[0] : sn[1], 4);
          const float ar0 = odd ? rr : c[0], ar1 = odd ? c[1] : rr;
          const float ai0 = odd ? ri : sn[0], ai1 = odd ? sn[1] : ri;
          const int k1 = 8 * j + 2 * t + odd, nb = 16 * wq + (g & ~1) + 8 * hh;
          const uint32_t tb = tw + (nb / 32) * TP_BOX;
          const float2 c2 = wg_ld_f2(wg_f32_at(tb, k1, nb % 32));
          const float2 s2 = wg_ld_f2(wg_f32_at(tb + 2 * TP_BOX, k1, nb % 32));
          const float tr0 = __fsub_rn(__fmul_rn(ar0, c2.x), __fmul_rn(ai0, s2.x));
          const float tr1 = __fsub_rn(__fmul_rn(ar1, c2.y), __fmul_rn(ai1, s2.y));
          const float ti0 = __fadd_rn(__fmul_rn(ar0, s2.x), __fmul_rn(ai0, c2.x));
          const float ti1 = __fadd_rn(__fmul_rn(ar1, s2.y), __fmul_rn(ai1, c2.y));
          if constexpr (STREAMS) {
            // Columns nb, nb + 1 are n2 m = (n2a + nb) / 2 of both streams. The
            // four lanes of a k1 (G = g / 2, lanes 8 apart) hold m = base + G +
            // 4 hh of the warp's 8 n2; they swap so that lane G stores run G
            // (stream G / 2, T re or im by G % 2): the 8 n2 as 16 bytes.
            if (hh == 0) {
              kept[0] = tr0, kept[1] = tr1, kept[2] = ti0, kept[3] = ti1;
            } else {
              const int G = g >> 1, h = p.n2 / 2;
              uint32_t w[4];  // run c = 2 q + P: this lane's (hh 0, hh 1) pair
              w[0] = bf16_pair(kept[0], tr0);
              w[1] = bf16_pair(kept[2], ti0);
              w[2] = bf16_pair(kept[1], tr1);
              w[3] = bf16_pair(kept[3], ti1);
              // A butterfly over G's two bits: after the first swap (lanes 8
              // apart) a lane holds its own and its neighbour's pairs of the
              // runs whose bit 0 is G's; after the second (16 apart), all four
              // lanes' pairs of run G.
              const bool b0 = G & 1, b1 = G & 2;
              const uint32_t a0 = b0 ? w[1] : w[0], a1 = b0 ? w[3] : w[2];  // kept
              const uint32_t r0 = __shfl_xor_sync(~0u, b0 ? w[0] : w[1], 8);
              const uint32_t r1 = __shfl_xor_sync(~0u, b0 ? w[2] : w[3], 8);
              // Run G's pairs from G and G ^ 1 (kept), run G ^ 2's given away.
              const uint32_t own = b1 ? a1 : a0, nbr = b1 ? r1 : r0;
              const uint32_t far0 = __shfl_xor_sync(~0u, b1 ? a0 : a1, 16);  // from G ^ 2
              const uint32_t far1 = __shfl_xor_sync(~0u, b1 ? r0 : r1, 16);  // from G ^ 3
              // Sources 0, 1 and 2, 3: (own, nbr) and (far0, far1) by bit 1,
              // each pair reversed where bit 0 is set.
              const uint32_t p0 = b1 ? far0 : own, p1 = b1 ? far1 : nbr;
              const uint32_t q0 = b1 ? own : far0, q1 = b1 ? nbr : far1;
              const uint32_t lo = b0 ? 0x1054u : 0x5410u, hi = b0 ? 0x3276u : 0x7632u;
              const uint4 v = make_uint4(__byte_perm(p0, p1, lo), __byte_perm(q0, q1, lo),
                                         __byte_perm(p0, p1, hi), __byte_perm(q0, q1, hi));
              const long long o = tbase + static_cast<long long>((G >> 1) * p.n1 + k1a + k1) * h +
                                  n2a / 2 + 8 * wq;
              *reinterpret_cast<uint4*>((G & 1 ? p.ti : p.tr) + o) = v;
            }
          } else {
            const long long o = tbase + static_cast<long long>(k1a + k1) * p.n2 + n2a + nb;
            *reinterpret_cast<__nv_bfloat162*>(p.tr + o) = __floats2bfloat162_rn(tr0, tr1);
            *reinterpret_cast<__nv_bfloat162*>(p.ti + o) = __floats2bfloat162_rn(ti0, ti1);
          }
        }
      }
      wg_warpgroup_sync(cw);  // every thread's twiddles are read
      if (wt == 0) wg_mbar_arrive(empty + 8 * tw_slot);
    }
  }
}
#endif  // K1_STAGE_STOPS

// Stage B: the four products over n2, the combine, the rotation and the
// requant (STOP_STAGEB: re and im, no rotation).
struct SbParams {
  void* outr;  // [m, C] int8, or f32 without the requant
  void* outi;
  int n_spectra, n1, n2;
  int ma;          // k2 blocks of 64 a tile: 2 (one a consumer, T's columns shared) or 1
                   // (shared; each consumer its own 64 k1)
  int na;          // k1 blocks of 64 a tile: 2 / ma, or 1 at N1 = 64 beside N2 = 128,
                   // where both consumers sum the tile's one block and the first stores it
  int n_k2, n_k1;  // a spectrum's k2 tiles and k1 tiles
  int n_kb;        // K slots a tile: N2 / 64
  int n_tiles;     // m * n_k1 * n_k2
};

// 2-D tensor maps, 128-byte swizzle, boxes of 64 rows: the row-stacked
// N2-point matrix [N2, N2] and T re, im viewed [m * N1, N2] (64 columns a
// box), the rotation planes viewed [batch * N2/2, N1] (row b N2/2 + k2,
// column k1; 32 columns a box).
struct SbMaps {
  CUtensorMap d2, tr, ti, rotc, rots;
};

// A tile is 64 ma k2 x 64 na k1, a consumer's 64 k2 x 64 k1 of it. A K
// slot: ma [cos 64; -sin 64] box pairs of the k2 rows (the K-major A
// operand), then na [T re 64; T im 64] box pairs (the K-major B operand);
// then each consumer's rotation values, a slot each.
template <bool QUANT, int STOP = STOP_NONE>
__global__ void __launch_bounds__(WG_THREADS, 1)
    k1_stage_b_wg_kernel(const SbParams p, const __grid_constant__ SbMaps maps) {
  static_assert(STOP == STOP_NONE || STOP == STOP_STAGEB, "stage B's stop");
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  uint32_t full, empty;
  const uint32_t ring = tp_ring_init(wg_smem, full, empty);
  const int n1 = p.n1, h = p.n2 / 2, C = n1 * h, na = p.na;
  const int wg = threadIdx.x / 128;
  const int my_tiles = (p.n_tiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1;

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(WG_PRODUCER_REGS));
    if (threadIdx.x != 0) return;
    WgRing r;
    for (int i = 0; i < my_tiles; ++i) {
      const TpTile u = tp_tile(blockIdx.x + i * gridDim.x, p.n_k2, p.n_k1);
      const int k2b = 64 * p.ma * u.c, k1b = 64 * na * u.r, trow = u.spec * n1 + k1b;
      for (int kb = 0; kb < p.n_kb; ++kb, r.next(TP_STAGES)) {
        wg_mbar_wait(empty + 8 * r.slot, r.phase ^ 1);
        const uint32_t s = ring + r.slot * TP_SLOT, bar = full + 8 * r.slot;
        wg_mbar_expect(bar, 2 * (p.ma + na) * TP_BOX);
        for (int a = 0; a < p.ma; ++a) {
          wg_tma(s + 2 * a * TP_BOX, &maps.d2, 64 * kb, k2b + 64 * a, bar);
          wg_tma(s + (2 * a + 1) * TP_BOX, &maps.d2, 64 * kb, h + k2b + 64 * a, bar);
        }
        for (int b = 0; b < na; ++b) {
          wg_tma(s + 2 * (p.ma + b) * TP_BOX, &maps.tr, 64 * kb, trow + 64 * b, bar);
          wg_tma(s + (2 * (p.ma + b) + 1) * TP_BOX, &maps.ti, 64 * kb, trow + 64 * b, bar);
        }
      }
      if constexpr (STOP == STOP_NONE) {
        // Each consumer's rotation values, a slot each: [64 k2 x 64 k1] of
        // rotc, then of rots, as two boxes of 32 columns each.
        for (int w = 0; w < 2; ++w, r.next(TP_STAGES)) {
          wg_mbar_wait(empty + 8 * r.slot, r.phase ^ 1);
          const uint32_t s = ring + r.slot * TP_SLOT, bar = full + 8 * r.slot;
          wg_mbar_expect(bar, 4 * TP_BOX);
          const int row = (u.spec / p.n_spectra) * h + k2b + (p.ma == 2 ? 64 * w : 0);
          const int col = k1b + (na == 2 ? 64 * w : 0);
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            wg_tma(s + x * TP_BOX, x < 2 ? &maps.rotc : &maps.rots, col + 32 * (x & 1), row, bar);
          }
        }
      }
    }
    return;
  }

  // A consumer warpgroup (cw 0 or 1): [cos rows; -sin rows of its 64 k2] x
  // [T re | T im of its 64 k1]: cos.tr, cos.ti in one fragment, -sin.tr,
  // -sin.ti in the other, the wgmmas chained over n2.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(WG_CONSUMER_REGS));
  const int cw = wg - 1, wt = threadIdx.x - 128 * wg;
  const int wq = wt / 32, lane = wt % 32, g = lane / 4, t = lane % 4;
  const int a_c = p.ma == 2 ? cw : 0, b_c = na == 2 ? cw : 0;
  const bool stores = p.ma * na == 2 || cw == 0;  // one block: the first consumer's
  WgRing r;
  for (int i = 0; i < my_tiles; ++i) {
    const TpTile u = tp_tile(blockIdx.x + i * gridDim.x, p.n_k2, p.n_k1);
    float fc[64], fs[64];
#pragma unroll
    for (int k = 0; k < 64; ++k) fc[k] = fs[k] = 0.f;
    // A slot is released once the next slot's wgmmas are issued and its own
    // have completed: one group stays in flight.
    int held = 0;
    wg_hold(fc);
    wg_hold(fs);
    for (int kb = 0; kb < p.n_kb; ++kb, r.next(TP_STAGES)) {
      wg_mbar_wait(full + 8 * r.slot, r.phase);
      const uint32_t s = ring + r.slot * TP_SLOT;
      const uint32_t dc = s + 2 * a_c * TP_BOX, ds = dc + TP_BOX;
      const uint32_t tk = s + 2 * (p.ma + b_c) * TP_BOX;
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int acc = kb > 0 || ks > 0;
        Wgmma<128>::template run<0>(fc, wg_desc_k(dc + ks * 32), wg_desc_k(tk + ks * 32), acc);
        Wgmma<128>::template run<0>(fs, wg_desc_k(ds + ks * 32), wg_desc_k(tk + ks * 32), acc);
      }
      wg_commit();
      wg_wait<1>();
      if (kb > 0 && wt == 0) wg_mbar_arrive(empty + 8 * held);
      held = r.slot;
    }
    wg_wait<0>();
    wg_hold(fc);
    wg_hold(fs);
    if (wt == 0) wg_mbar_arrive(empty + 8 * held);
    uint32_t rot = 0;
    int rot_slot = 0;
    if constexpr (STOP == STOP_NONE) rot = tp_own_slot(r, ring, full, empty, cw, wt, rot_slot);
    // re = cos.tr - (-sin.ti), im = cos.ti + (-sin.tr); rotate; store.
    // Fragment element (row 16 wq + g + 8 hh, column 8 j + 2 t + e): T re's
    // columns j < 8, T im's 8 on.
    const long long obase = static_cast<long long>(u.spec) * C;
    const int k2 = 64 * (p.ma * u.c + a_c) + 16 * wq + g;
    const int ch0 = k2 * n1 + 64 * (na * u.r + b_c) + 2 * t;
    if (stores) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int ch = ch0 + 8 * hh * n1 + 8 * j;
          const float* cr = fc + 4 * j + 2 * hh;
          const float* sr = fs + 4 * j + 2 * hh;
          float re[2], im[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            re[e] = __fsub_rn(cr[e], sr[32 + e]);
            im[e] = __fadd_rn(cr[32 + e], sr[e]);
          }
          if constexpr (STOP == STOP_STAGEB) {
            // re, im without the rotation, truncated or f32.
            stop_store2<QUANT>(p.outr, obase + ch, re[0], re[1]);
            stop_store2<QUANT>(p.outi, obase + ch, im[0], im[1]);
          } else {
            // Rotation element (k2 row 16 wq + g + 8 hh, k1 column 8 j + 2 t)
            // of the consumer's staged [64 x 64] planes.
            const int x = 8 * j + 2 * t, rr = 16 * wq + g + 8 * hh;
            const uint32_t rb = rot + (x / 32) * TP_BOX;
            const float2 rc = wg_ld_f2(wg_f32_at(rb, rr, x % 32));
            const float2 rs = wg_ld_f2(wg_f32_at(rb + 2 * TP_BOX, rr, x % 32));
            float v[2][2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float c = e ? rc.y : rc.x, sn = e ? rs.y : rs.x;
              v[0][e] = __fsub_rn(__fmul_rn(re[e], c), __fmul_rn(im[e], sn));
              v[1][e] = __fadd_rn(__fmul_rn(re[e], sn), __fmul_rn(im[e], c));
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
    if constexpr (STOP == STOP_NONE) {
      wg_warpgroup_sync(cw);  // every thread's rotation values are read
      if (wt == 0) wg_mbar_arrive(empty + 8 * rot_slot);
    }
  }
}

// Whether the three-pass route's tiles cover N1 x N2: powers of two, N1 and
// N2 / 2 multiples of 64, N2 of 128, and a spectrum's planes and the DFT
// matrices indexed in 32 bits (N1, N2 <= 2^15).
bool three_pass_split(int n1, int n2) {
  return n1 >= 64 && n1 <= (1 << 15) && (n1 & (n1 - 1)) == 0 && n2 >= 128 && n2 <= (1 << 15) &&
         (n2 & (n2 - 1)) == 0;
}

// A bf16 stage-B call on the wgmma body: T re, im [batch, n_spectra, N1, N2]
// (16-byte aligned), the row-stacked N2-point matrix, the rotation planes
// [batch, C] (16-byte aligned; null at STOP_STAGEB), the outputs. Returns
// cudaSuccess with the call's parameters and maps, or the error to return.
struct SbCall {
  SbParams p;
  SbMaps maps;
};

// The bf16 stage-B body's tile at N1 x N2: blocks of 64 k2 (ma) and of 64 k1
// (na).
int stage_b_wg_ma(int n2) { return n2 >= 256 ? 2 : 1; }
int stage_b_wg_na(int n1, int n2) { return stage_b_wg_ma(n2) == 2 || n1 == 64 ? 1 : 2; }

int stage_b_wg_call(SbCall& c, const void* tr, const void* ti, const void* d2,
                    const void* rotc, const void* rots, void* outr, void* outi, int batch,
                    int n_spectra, int n1, int n2) {
  if (batch < 1 || n_spectra < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (!three_pass_split(n1, n2)) return NO_PLAN;
  const bool rot = rotc != nullptr;
  if (!aligned_to(tr, 16) || !aligned_to(ti, 16) || !aligned_to(d2, 16) ||
      (rot && (!aligned_to(rotc, 16) || !aligned_to(rots, 16)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned long long rows = static_cast<unsigned long long>(batch) * n_spectra * n1;
  const unsigned long long rot_rows = static_cast<unsigned long long>(batch) * (n2 / 2);
  c = SbCall{};
  if (!wg_map(c.maps.d2, d2, n2, n2, 64) || !wg_map(c.maps.tr, tr, n2, rows, 64) ||
      !wg_map(c.maps.ti, ti, n2, rows, 64) ||
      (rot && (!wg_map(c.maps.rotc, rotc, n1, rot_rows, 64, true) ||
               !wg_map(c.maps.rots, rots, n1, rot_rows, 64, true)))) {
    return static_cast<int>(cudaErrorNotSupported);
  }
  SbParams& p = c.p;
  p.outr = outr;
  p.outi = outi;
  p.n_spectra = n_spectra;
  p.n1 = n1;
  p.n2 = n2;
  p.ma = stage_b_wg_ma(n2);
  p.na = stage_b_wg_na(n1, n2);
  p.n_k2 = n2 / 2 / (64 * p.ma);
  p.n_k1 = n1 / (64 * p.na);
  p.n_kb = n2 / 64;
  const long long tiles = static_cast<long long>(batch) * n_spectra * p.n_k1 * p.n_k2;
  if (rows > 0x7fffffffULL || tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  p.n_tiles = static_cast<int>(tiles);
  return 0;
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
    stage_b_store<QUANT, STOP>(p, w.m * C + ch, s, rc, rs);
  }
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

#ifndef K1_STAGE_STOPS
// A bf16 stage-A launch on the wgmma body (k1_stage_a_launch's arguments),
// T in K1's layout or, STREAMS, in K7's stream planes.
template <bool STREAMS>
int stage_a_wg_launch(const void* plane, const void* d1c, const void* d1s, const void* twc,
                      const void* tws, void* tr, void* ti, int m, int n1, int n2, void* stream) {
  if (m < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (!three_pass_split(n1, n2)) return NO_PLAN;
  if (!aligned_to(plane, 16) || !aligned_to(d1c, 16) || !aligned_to(d1s, 16) ||
      !aligned_to(twc, 16) || !aligned_to(tws, 16) || !aligned_to(tr, 4) || !aligned_to(ti, 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned long long rows = static_cast<unsigned long long>(m) * n1;
  const int pieces = n1 >= 128 ? 2 : 1;
  const long long tiles = static_cast<long long>(m) * (n2 / 128) * (n1 / (64 * pieces));
  if (rows > 0x7fffffffULL || tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  SaMaps maps{};
  if (!wg_map(maps.plane, plane, n2, rows, 64) || !wg_map(maps.d1c, d1c, n1, n1, 64) ||
      !wg_map(maps.d1s, d1s, n1, n1, 64) || !wg_map(maps.twc, twc, n2, n1, 64, true) ||
      !wg_map(maps.tws, tws, n2, n1, 64, true)) {
    return static_cast<int>(cudaErrorNotSupported);
  }
  const SaParams p{static_cast<bf16*>(tr), static_cast<bf16*>(ti), n1, n2, n2 / 128,
                   n1 / (64 * pieces), n1 / 64, static_cast<int>(tiles)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pieces == 2) {
    return static_cast<int>(launch_tp_wg(k1_stage_a_wg_kernel<2, STREAMS>, p, maps, st));
  }
  return static_cast<int>(launch_tp_wg(k1_stage_a_wg_kernel<1, STREAMS>, p, maps, st));
}

#endif  // K1_STAGE_STOPS

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
// DFT matrices, twc/tws the f32 twiddles, rotc/rots [batch, C]. N1 = 8 runs
// the mma.sync body, N1 >= 16 the wgmma body (the plane and the matrices
// 16-byte aligned, the f32 operands 8-byte). Returns -1 where neither has a
// plan (N2 >= 2048: the three-pass route's splits).
extern "C" int k1_dft_launch(const void* plane, const void* d1c, const void* d1s,
                             const void* d2, const void* twc, const void* tws,
                             const void* rotc, const void* rots, void* outr, void* outi,
                             int batch, int n_spectra, int n1, int n2, int quantise,
                             void* stream) {
  if (n1 < 8 || !pow2(n1) || n2 < 128 || !pow2(n2) || batch < 1 || n_spectra < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n1 == 8) {
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
    p.n2 = n2;
    return quantise ? n8_dispatch<true>(p, batch, st) : n8_dispatch<false>(p, batch, st);
  }
  WgCall c = wg_call(plane, d1c, d1s, d2, twc, tws, rotc, rots, outr, outi, batch, n_spectra, n1,
                     n2);
  return with_wg_plan(n1, n2, [&](auto sh, const WgPlan& w) {
    using S = decltype(sh);
    c.w = w;
    return static_cast<int>(
        quantise ? launch_wg<S::kc, S::nb, S::kd, true>(c, st)
                 : launch_wg<S::kc, S::nb, S::kd, false>(c, st));
  });
}

// The bf16 DFT pass's plan and body at N1 x N2, -1 where it has none (the
// split then takes the three-pass route): out int[8] = registers a thread,
// local (spill) bytes a thread, KC (KC_N8 at N1 = 8), K-tile depth (stage
// B's at N1 = 8; a ring slot's, KD, on the wgmma body), ring stages,
// shared-memory bytes, blocks a cluster, products a stage-A sum adds up
// before it joins the f32 master sum (8 at N1 = 8: one m16n8k8 a sum).
extern "C" int k1_dft_attributes(int n1, int n2, void* out) {
  if (n1 < 8 || !pow2(n1) || n2 < 128 || !pow2(n2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int* o = static_cast<int*>(out);
  cudaFuncAttributes a{};
  if (n1 == 8) {
    DftParams p{};
    p.n_spectra = 1;
    p.n2 = n2;
    const size_t bytes = dft_plan(p);
    if (!bytes) return NO_PLAN;
    const cudaError_t err = cudaFuncGetAttributes(&a, k1_dft_kernel<true>);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int v[8] = {a.numRegs, static_cast<int>(a.localSizeBytes), KC_N8, p.ktb, p.stages,
                      static_cast<int>(bytes), 1, 8};
    std::copy(v, v + 8, o);
    return 0;
  }
  return with_wg_plan(n1, n2, [&](auto sh, const WgPlan& w) {
    using S = decltype(sh);
    const cudaError_t err = wg_attributes<S::kc, S::nb, S::kd, true>(a);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int group = 16 * (WG_GROUP < S::kd / 16 ? WG_GROUP : S::kd / 16);
    const int v[8] = {a.numRegs, static_cast<int>(a.localSizeBytes), S::kc, S::kd, w.stages,
                      static_cast<int>(w.smem), 1, group};
    std::copy(v, v + 8, o);
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
// bf16 N1-point matrices, twc/tws the f32 twiddles (16-byte aligned). Returns
// -1 where the route's tiles do not cover the split.
extern "C" int k1_stage_a_launch(const void* plane, const void* d1c, const void* d1s,
                                 const void* twc, const void* tws, void* tr, void* ti, int m,
                                 int n1, int n2, void* stream) {
  return stage_a_wg_launch<false>(plane, d1c, d1s, twc, tws, tr, ti, m, n1, n2, stream);
}

// K7's three-pass stage A (bf16): the arguments of k1_stage_a_launch on the
// plane's [N1, 2·N2] view (n2 = 2·N2, the column-doubled twiddles [N1,
// 2·N2]), T re and im [m, 2, N1, N2], each stream's plane.
extern "C" int dit_stage_a_launch(const void* plane, const void* d1c, const void* d1s,
                                  const void* twc, const void* tws, void* tr, void* ti, int m,
                                  int n1, int n2, void* stream) {
  return stage_a_wg_launch<true>(plane, d1c, d1s, twc, tws, tr, ti, m, n1, n2, stream);
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
// bf16 row-stacked N2-point matrix, rotc/rots [batch, C] (T, d2 and the
// rotation planes 16-byte aligned). Returns -1 where the route's tiles do not
// cover the split.
extern "C" int k1_stage_b_launch(const void* tr, const void* ti, const void* d2,
                                 const void* rotc, const void* rots, void* outr, void* outi,
                                 int batch, int n_spectra, int n1, int n2, int quantise,
                                 void* stream) {
  if (!rotc || !rots) return static_cast<int>(cudaErrorInvalidValue);
  SbCall c;
  const int err =
      stage_b_wg_call(c, tr, ti, d2, rotc, rots, outr, outi, batch, n_spectra, n1, n2);
  if (err) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(quantise ? launch_tp_wg(k1_stage_b_wg_kernel<true>, c.p, c.maps, st)
                                   : launch_tp_wg(k1_stage_b_wg_kernel<false>, c.p, c.maps, st));
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
// cover the split: bf16, out int[11] as wg_stage_attributes gives it; f32,
// out int[9] as stage_attributes gives it.
extern "C" int k1_stage_a_attributes(int n1, int n2, void* out) {
  if (!three_pass_split(n1, n2)) return NO_PLAN;
  if (n1 >= 128) return wg_stage_attributes(k1_stage_a_wg_kernel<2>, 128, 128, 16 * SA_GROUP, out);
  return wg_stage_attributes(k1_stage_a_wg_kernel<1>, 64, 128, 16 * SA_GROUP, out);
}

// K7's stage-A body (the stream planes' store) at N1 x n2 (n2 = 2·N2), as
// k1_stage_a_attributes gives K1's.
extern "C" int dit_stage_a_attributes(int n1, int n2, void* out) {
  if (!three_pass_split(n1, n2)) return NO_PLAN;
  if (n1 >= 128) {
    return wg_stage_attributes(k1_stage_a_wg_kernel<2, true>, 128, 128, 16 * SA_GROUP, out);
  }
  return wg_stage_attributes(k1_stage_a_wg_kernel<1, true>, 64, 128, 16 * SA_GROUP, out);
}

extern "C" int k1_stage_b_attributes(int n1, int n2, void* out) {
  if (!three_pass_split(n1, n2)) return NO_PLAN;
  return wg_stage_attributes(k1_stage_b_wg_kernel<true>, 64 * stage_b_wg_ma(n2),
                             64 * stage_b_wg_na(n1, n2), n2, out);
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
