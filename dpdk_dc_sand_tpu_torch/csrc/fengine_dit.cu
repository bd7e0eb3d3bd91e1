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
// ms at the f32 FFMA rate; its bytes (0.28 GB) take 0.08 ms.
//
// Every split runs as passes over groups of streams whose scratch fits K1's
// (about 1 GB), on the route ops/fengine_fused.py:_dit_body asks the plan
// queries for before any launch; a split no route takes is refused. The
// first pass is always K1's FIR pass (k1_fir_kernel, csrc/fengine_ct.cu,
// unchanged) on the frames viewed [B, n_frames·fft] with every start at 0:
// it writes the f32 tap-order FIR, rounded to bf16 or kept in f32, which is
// K7's rounded FIR, into a [B, S, fft] plane. The even stream's element
// (n1, n2) is plane sample 2·(n1·N2 + n2) and the odd stream's the next, so
// the plane viewed [N1, 2·N2] holds both streams' row n1, interleaved: stage
// A (every column times the same [N1, N1] matrix) is one product of D1
// against that natural view, no deinterleave, and one twiddle serves the
// two columns of an n2.
//
// A. bf16 operands where T fits shared memory (N2 <= 1024): two passes,
//    the FIR pass and dit_dft_kernel below, both DFT stages on the tensor
//    cores. An m16n8k16 accumulator fragment gives a thread columns 2·n2
//    and 2·n2 + 1, one n2 of both streams, so the epilogue applies one f32
//    twiddle to the pair and writes the even and odd T planes apart into
//    shared memory, rounded to bf16. Stage B then runs per stream against
//    the bf16 [N2, N2] cos and -sin matrices, eight sums a (k2, k1) (four a
//    stream), followed by the DIT combine, the rotation and the requant at
//    the reference's rounding points.
//    The design is K1's mma.sync DFT body (K1 keeps it for N1 = 8 only,
//    k1_dft_kernel; its N1 >= 16 splits run a wgmma body, k1_dft_wg_kernel):
//    persistent blocks of 16 warps walk
//    (stream, spectrum, chunk of KC k1 rows) units, chunks of one spectrum
//    neighbours so the plane leaves HBM once; one cp.async ring streams
//    every unit's tile sequence (stage-A plane and D1 tiles, then stage-B
//    D2 tiles) so the copies of the next unit overlap this one's epilogue;
//    KC follows N2 (64 rows up to N2 = 256, 32 at 512, 16 at 1024) so the
//    four T planes and 3-4 ring stages fit.
//    N1 = 8 (fft 64 to 1024 under "matmul", 2048 under "bitcast"; N2 from
//    4 to 128) takes K1's N1 = 8 plan: a unit is SB spectra (a run of the
//    group's [G·S] spectra, which may span two streams) whose (spectrum, k1)
//    rows form T (KC_N8 = 128 rows, 16 spectra; 64
//    rows, 8 spectra, at N2 = 128, where 128 rows of four T planes do not
//    fit beside the ring). Stage A is one 8-deep tile of the unit's planes
//    whole, each warp's 4 spectra against the [cos; -sin] [16 x 8] matrix
//    held in registers, one mma.sync m16n8k8 a spectrum and 8 plane
//    columns (one MMA a sum: nothing chains); stage B is the design's
//    above, the unit's spectra side by side as T's columns. Below N2 = 16
//    (an MMA's depth) the N2-point matrices come zero-padded to 16 and the
//    T planes' extra columns stay zero, which add exactly in f32.
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
// A'. f32 operands where T fits (N2 <= 512): two passes as well, K1's FIR
//    pass into an f32 plane (the exact f32 sums, K7's f32 FIR), then
//    dit_dft_f32_kernel: K1's f32 FFMA DFT pass on this form's operand (its
//    design is at the kernel), N1 = 8 on its KC = 8 plan.
// B. Where T does not fit (bf16 N2 >= 2048: fft >= 2^23; f32 N2 >= 1024:
//    fft >= 2^21): three passes through T in device memory, as K1's route
//    for N2 >= 2048 (csrc/fengine_ct.cu): the FIR pass; K1's stage-A body
//    (k1_stage_a_wg_kernel, k1_stage_a_f32_kernel) on the [N1, 2·N2] view
//    with a twiddle table whose columns 2·n2 and 2·n2 + 1 both hold
//    exp(-2πi k1 n2 / N): the product, the twiddle and the rounding are
//    _dit_stage_a's for both streams; then stage B: per stream, all N2
//    values of k2 against the full [N2, N2] cos and -sin matrices, the four
//    sums a stream, the combine, the rotation and the requant.
//    bf16: stage A is k1_stage_a_wg_kernel<P, true>, K1's body unchanged but
//    for its store: T re and im go out as each stream's [N1, N2] plane,
//    [m, 2, N1, N2] (the four lanes of a k1 swap their values so that each
//    stores 8 n2 of one stream as 16 bytes), so that stage B can take T as
//    wgmma's K-major shared-memory operand, which cannot take every other
//    element of an interleaved row. Stage B, dit_stage_b_kernel, is K1's
//    stage-B body (csrc/wg_ring.cuh: one persistent 384-thread block an SM,
//    one producer thread issuing TMA boxes (2-D tensor maps, 128-byte
//    swizzle) into a ring of 4 slots of 48 KB, a full and an empty mbarrier
//    a slot, two consumer warpgroups under setmaxnreg (40 / 232); the tiles
//    walked k2 fastest, so the blocks running side by side share one k1
//    tile of T in L2) with K7's operands and combine. A tile is 128 k2 x 32 k1 of one
//    spectrum, a consumer's 64 k2 of it. A K slot holds [cos 64; -sin 64]
//    of each consumer's k2 rows (its K-major A operand) and the [32 k1 x
//    64 n2] boxes tr_e, ti_e, tr_o, ti_o (both consumers' K-major B
//    operand, 128 rows): m64n128k16 twice a k-step, cos.T in one fragment
//    and -sin.T in the other, chained over n2 (as the mma.sync body did),
//    one group left in flight while the next slot's run, so each thread
//    holds all eight sums of its (k2, k1) points (128 f32). Epilogue: the
//    consumer's combine factors and rotation values ([64 k2 x 32 k1] of
//    untc, unts, rotc, rots) come as a slot of the ring behind the tile's K
//    slots; the combine, the rotation and the requant, the codes stored as
//    pairs along k1. Registers: 168 a thread at launch, 232 a consumer after
//    setmaxnreg; 0 spill bytes. Bytes through L2 at fft 2^23 over 160 x S =
//    2 (320 spectra, 327,680 tiles): a tile reads 32 K slots of 48 KB (1.5
//    MB for 128 x 32 x 2048 x 8 products: 85 FLOP a byte, as K1's stage B)
//    and 64 KB of epilogue operands, and writes 8 KB of codes: 515.4 GB,
//    21.5 GB and 2.7 GB a call, where the mma.sync body it replaced (64 k2
//    x 32 k1 a block, cp.async) read 687.2 GB of operands (64 FLOP a byte).
//    T kept interleaved, as wgmma's register A operand split by __byte_perm,
//    ran slower (PERF.md §6).
//    f32: stage A k1_stage_a_f32_kernel unchanged, T re and im stored
//    transposed, [2·N2][N1] (row 2·n2 + q); dit_stage_b_f32_kernel, FFMA, 4
//    k2 x 2 k1 x both streams x 4 sums a thread against the N2-point matrix
//    in halves of k2 (_dit_d2h), one block a tile of 64 k2 x 32 k1, each
//    tile's K loop (n2) through a cp.async ring. These passes replace
//    nothing in the TPU kernel: they are its work split where an SM's 227
//    KB cannot hold what the TPU's VMEM held. The bf16 or f32 operations
//    bound them (at 2048 x 2048 about 206 GFLOP a spectrum, stage B two
//    thirds of it).
//
// Stage stops. The probe P2 (benchmarks/fused_ablate.py of the JAX package,
// the trimmed copy of _fengine_kernel reached through pl.pallas_call at
// fused_ablate.py:198) cuts the route K7 runs at its geometry (fft 65536,
// 256 x 128: route A): its dma, conv, fir and deint stops are cuts of K1's
// FIR pass (csrc/fengine_ct.cu), its stagea and stageb stops the FIR pass
// and then dit_dft_kernel cut at a compile-time STOP, so the production
// instantiation (DFT_FULL) is the code above unchanged:
//   DFT_STAGEA   — stage A and its twiddle into the T planes alone (no
//                  stage-B tiles, nothing written);
//   DFT_STAGEA_T — the same, each stream's rounded T re written truncated
//                  at k1·N2 + n2 instead (P2's stagea);
//   DFT_STAGEB   — stages A and B, each stream's re written truncated at
//                  k2·N1 + k1 (no combine, rotation or requant; the im sums
//                  are added times zero, so the compiler keeps all of stage
//                  B).
// The stops take the 64-row chunk plan with chained stage-A sums only.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "wg_ring.cuh"

namespace {

constexpr size_t MAX_SMEM = 232448;  // what one block may use on sm_90

__device__ __forceinline__ int8_t requant(float v) {
  v = fminf(fmaxf(rintf(v), -127.f), 127.f);
  return static_cast<int8_t>(v);
}

// int8 by truncation toward zero, saturated: the value cvt.rzi.sat.s8.f32
// gives (the probe's stops, as XLA's f32 -> int8 conversion).
__device__ __forceinline__ int8_t trunc_s8(float v) {
  return static_cast<int8_t>(max(-128, min(127, __float2int_rz(v))));
}

// ---------------------------------------------------------------------------
// The two-pass body's DFT pass on the tensor cores (see the head of the file)
// ---------------------------------------------------------------------------
constexpr int DFT_THREADS = 512;  // 16 warps: one block an SM
constexpr int DFT_WARPS = DFT_THREADS / 32;
constexpr int PAD = 8;            // row padding (elements): conflict-free ldmatrix
constexpr int NO_PLAN = -1;
// The DFT pass's stage stops (dit_dft_stop_launch; see the head of the
// file). The production instantiation (DFT_FULL) is unchanged by them.
constexpr int DFT_FULL = 0, DFT_STAGEA = 1, DFT_STAGEB = 2, DFT_STAGEA_T = 3;
// T rows of an N1 = 8 unit: 16 spectra of 8 k1 rows, or 8 where 16 do not
// fit (N2 = 128).
constexpr int KC_N8 = 128, KC_N8_HALF = 64;
// The least N2 stage B takes: an MMA's K depth (smaller N2 come padded).
constexpr int MIN_N2P = 16;

using bf16 = __nv_bfloat16;

struct DftParams {
  const bf16* plane;  // [G, S, N1, 2·N2]: row n1 holds both streams' row n1, interleaved
  const bf16* d1c;    // [N1, N1] cos
  const bf16* d1s;    // [N1, N1] -sin
  const bf16* d2c;    // [N2P, N2P] cos (zero-padded past N2)
  const bf16* d2s;    // [N2P, N2P] -sin
  const float* twc;   // [N1, N2]
  const float* tws;
  const float* untc;  // [N2, N1]
  const float* unts;
  const float* rotc;  // [G, N]
  const float* rots;
  int8_t* outr;       // [G, S, N]
  int8_t* outi;
  int n_spectra, n1, n2;
  int kt;                        // K-tile depth of both stages (8 at N1 = 8: stage A's)
  int n_ca, n_kta, n_rb, n_ktb;  // column tiles x K tiles, row tiles x K tiles
  int n_chunks;
  int sb;                        // spectra a unit (1; KC / 8 at N1 = 8)
  int n_rows;                    // G * S: the group's spectra
  int n_units;                   // G * S * n_chunks; at N1 = 8 n_rows / SB, rounded up
  int slot;                      // bf16 elements per ring slot
  int stages;                    // ring depth: 3 or 4
  // At N1 = 8: N2, or MIN_N2P below it (stage B's depth, T's columns), and
  // stage B's K-tile depth. (Every body here sits at the 128-register edge:
  // in development builds the order of these fields moved a few spilled
  // bytes between the N1 = 8 bodies and the others; in this order none
  // spills.)
  int n2p, ktb;
};

// The tile shapes of a KC-row chunk. Stage A: warps MW x NW, each WM k1 rows
// (cos and -sin) x WN plane columns (WN / 2 n2 of both streams): NA columns
// a tile (at N1 = 8: WM rows are 4 spectra's 8 k1 rows). Stage B: warps (16 / NWB) x NWB, each 16 k2 rows x WNB k1 columns
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

// d = a (16x8, row) * b (8x8, col), bf16 in, f32 out: the MMA's 8-product
// sums alone (N1 = 8's stage A: one MMA a sum; as csrc/fengine_ct.cu).
__device__ __forceinline__ void mma1688(float* d, uint32_t a0, uint32_t a1, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %7, %7, %7};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(b), "f"(0.f));
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
// b * S + s, its first k1 row (u % n_chunks) * KC; at N1 = 8 it is the SB
// spectra from plane row u * SB of the group's G * S, one chunk. Only (u,
// local) are kept live; the rest is decoded where it is used.
struct Cursor {
  int u, local;
};

__device__ __forceinline__ void advance(Cursor& c, int tpu) {
  if (++c.local == tpu) {
    c.local = 0;
    c.u += gridDim.x;
  }
}

// The unit's (first) plane row b * S + s, and its first k1 row.
template <bool N8>
__device__ __forceinline__ int unit_row(const DftParams& p, int u) {
  return N8 ? u * p.sb : u >> lg(p.n_chunks);
}

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
template <int KC, bool N8>
__device__ __forceinline__ void load_tile(const DftParams& p, const Cursor& c, int nA,
                                          bf16* slot) {
  using S = DitShape<KC>;
  const int tid = threadIdx.x;
  const int n1 = p.n1, n2 = p.n2, w2 = 2 * n2;
  const int kt = N8 ? 0 : p.kt, ktp = kt + PAD, ld = lg(kt / 8);  // (N1 = 8: ktb, in stage B)
  const Tile t = place(p, c.local, nA);
  if (N8 && t.stage_a) {
    // [KC x cols] of the plane: the unit's spectra, 8 rows each, whole (their
    // N1-point matrix is in registers). Spectra past the group's last are
    // not loaded (their T columns are never stored).
    const int lx = lg(min(S::NA, w2) / 8), nx = KC << lx;
    const int row = unit_row<true>(p, c.u);
    const int rows = min(KC, (p.n_rows - row) * 8);
    const bf16* xsrc = p.plane + static_cast<long long>(row) * 8 * w2 + t.outer * S::NA;
    for (int i = tid; i < nx; i += DFT_THREADS) {
      const int r = i >> lx, q = i & ((1 << lx) - 1);
      if (r < rows) {
        cp_async16(slot + r * (S::NA + PAD) + q * 8, xsrc + static_cast<long long>(r) * w2 + q * 8);
      }
    }
  } else if (t.stage_a) {
    // [kt x cols] of the plane's [N1, 2·N2] view, then the chunk's [KC x kt]
    // cos and -sin rows of the N1-point matrix.
    const int lx = lg(min(S::NA, w2) / 8);
    const int nx = kt << lx, nd = KC << ld;
    const bf16* xsrc = p.plane +
                       (static_cast<long long>(unit_row<false>(p, c.u)) * n1 + t.kidx * kt) * w2 +
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
    const int n2p = N8 ? p.n2p : n2;
    const int ktb = N8 ? p.ktb : kt, ktpb = ktb + PAD, ldb = lg(ktb / 8);
    const int nd = min(S::MB, n2p) << ldb;
    const int r0 = t.outer * S::MB;
    for (int i = tid; i < 2 * nd; i += DFT_THREADS) {
      const int m = i >= nd, j = i - m * nd;
      const int r = j >> ldb, q = j & ((1 << ldb) - 1);
      const bf16* src = (m ? p.d2s : p.d2c) + static_cast<long long>(r0 + r) * n2p + t.kidx * ktb + q * 8;
      cp_async16(slot + (m * S::MB + r) * ktpb + q * 8, src);
    }
  }
}

template <int KC, bool CHAIN, int STOP = DFT_FULL, bool N8 = false>
__global__ void __launch_bounds__(DFT_THREADS, 1) dit_dft_kernel(DftParams p) {
  using S = DitShape<KC>;
  static_assert(!N8 || STOP == DFT_FULL, "the stops take the 64-row chunk plan only");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int n1 = p.n1, n2 = p.n2, n = n1 * n2, w2 = 2 * n2;
  const int tld = (N8 ? p.n2p : n2) + PAD, tplane = KC * tld;
  const int stages = p.stages;
  bf16* sT = smem;  // [4][KC][N2P + PAD]: even re, even im, odd re, odd im
  bf16* ring = sT + 4 * tplane;
  if constexpr (N8) {
    // T's columns N2 .. N2P - 1 stay zero: stage B's K tiles read them
    // against the zero-padded N2-point matrix. (The loop's first barrier
    // orders these stores before any read.)
    for (int i = tid * 8; i < 4 * tplane; i += DFT_THREADS * 8) {
      *reinterpret_cast<uint4*>(sT + i) = make_uint4(0u, 0u, 0u, 0u);
    }
  }

  const int nA = p.n_ca * p.n_kta, tpu = nA + p.n_rb * p.n_ktb;
  const int my_units = (p.n_units - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1;
  const int n_tiles = my_units * tpu;

  // Warp placement. Stage A: k1 rows a_r0.., plane columns a_c0.. of the tile.
  const int a_r0 = (warp / S::NW) * S::WM, a_c0 = (warp % S::NW) * S::WN;
  // Stage B: k2 rows b_r0.. of the row tile, k1 columns b_c0.. of the chunk.
  const int b_r0 = (warp / S::NWB) * 16, b_c0 = (warp % S::NWB) * S::WNB;

  // One register array for both stages' accumulators (at most 64 f32 a
  // thread). Stage A: [cos/sin][MI][NJ n8][4] (N1 = 8: [4 spectra][4 n8][4],
  // the m16n8k8 tile's d0, d1 the cos sums and d2, d3 the -sin sums of k1 =
  // g, columns 2·n2 and 2·n2 + 1); stage B: [8 sums][NJB n8][4], sums cos.tr,
  // -sin.ti, cos.ti, -sin.tr of the even stream, then the odd.
  float acc[64];

  Cursor ld{static_cast<int>(blockIdx.x), 0};  // the next tile to load
  Cursor cc = ld;  // the tile to compute
  for (int t = 0; t < stages - 1; ++t) {
    if (t < n_tiles) {
      load_tile<KC, N8>(p, ld, nA, ring + t * p.slot);
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
      load_tile<KC, N8>(p, ld, nA, ring + s_load * p.slot);
      advance(ld, tpu);
    }
    cp_async_commit();
    const Tile w = place(p, cc.local, nA);
    const bf16* slot = ring + slot_i * p.slot;
    slot_i = slot_i + 1 == stages ? 0 : slot_i + 1;
    const int k0 = N8 ? 0 : unit_k0<KC>(p, cc.u);
    const int kt = N8 ? 0 : p.kt, ktp = kt + PAD;  // (N1 = 8: ktb, in stage B)
    if (w.stage_a) {
      const int col = w.outer * S::NA + a_c0;  // first plane column of the warp
      if (col >= w2) continue;
      if constexpr (N8) {
        // The [cos; -sin] [16 x 8] A fragment of m16n8k8 (row g of each, from
        // L1) against the warp's 4 spectra, 8 rows each, x 4 column tiles of
        // 8; then the f32 twiddle of n2 = column / 2 on both streams'
        // columns, bf16 rounding, into the T planes (row: spectrum, k1 = g).
        const uint32_t a0 = __ldg(reinterpret_cast<const unsigned int*>(p.d1c + g * 8 + tig * 2));
        const uint32_t a1 = __ldg(reinterpret_cast<const unsigned int*>(p.d1s + g * 8 + tig * 2));
#pragma unroll
        for (int j = 0; j < S::WM / 8; ++j) {
          uint32_t fb[4];
          ldsm_x4_t(fb, slot + (a_r0 + j * 8 + lane % 8) * (S::NA + PAD) + a_c0 + (lane / 8) * 8);
#pragma unroll
          for (int m = 0; m < 4; ++m) mma1688(acc + (j * 4 + m) * 4, a0, a1, fb[m]);
        }
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          if (col + m * 8 >= w2) break;  // (w2 is a multiple of 8)
          const int m2 = (col + m * 8) / 2 + tig;
          const float wc = __ldg(p.twc + g * n2 + m2), ws = __ldg(p.tws + g * n2 + m2);
#pragma unroll
          for (int j = 0; j < S::WM / 8; ++j) {
            const float* a = acc + (j * 4 + m) * 4;
            const int r = a_r0 + j * 8 + g;
#pragma unroll
            for (int q = 0; q < 2; ++q) {  // column 2·m2 + q: stream q
              const float tr = __fsub_rn(__fmul_rn(a[q], wc), __fmul_rn(a[2 + q], ws));
              const float ti = __fadd_rn(__fmul_rn(a[q], ws), __fmul_rn(a[2 + q], wc));
              sT[(2 * q) * tplane + r * tld + m2] = __float2bfloat16_rn(tr);
              sT[(2 * q + 1) * tplane + r * tld + m2] = __float2bfloat16_rn(ti);
            }
          }
        }
        continue;
      }
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
        // bf16 rounding, into the T planes (DFT_STAGEA_T: each stream's T
        // re, truncated, to its output instead). A row's four twiddles are
        // loaded together first: the L2 round trips overlap.
        long long tbase = 0;
        if constexpr (STOP == DFT_STAGEA_T) {
          tbase = static_cast<long long>(unit_row<false>(p, cc.u)) * n + static_cast<long long>(k0) * n2;
        }
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
                if constexpr (STOP == DFT_STAGEA_T) {
                  (q ? p.outi : p.outr)[tbase + r * n2 + m2] =
                      trunc_s8(__bfloat162float(__float2bfloat16_rn(tr)));
                } else {
                  sT[(2 * q) * tplane + r * tld + m2] = __float2bfloat16_rn(tr);
                  sT[(2 * q + 1) * tplane + r * tld + m2] = __float2bfloat16_rn(ti);
                }
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
      const int ktb = N8 ? p.ktb : kt, ktpb = ktb + PAD;
      const bf16* sC = slot;
      const bf16* sS = slot + S::MB * ktpb;
      for (int kk = 0; kk < (KC == 16 && !N8 ? 16 : ktb); kk += 16) {
        uint32_t fc[4], fs[4];
        {
          const int r = b_r0 + lane % 16, c = kk + (lane / 16) * 8;
          ldsm_x4(fc, sC + r * ktpb + c);
          ldsm_x4(fs, sS + r * ktpb + c);
        }
        const int tc0 = w.kidx * ktb + kk + ((lane / 8) % 2) * 8;
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
        // rotation values are loaded together first. T column b_c0 + j * 8 +
        // e is k1 row k0 + that of the unit's spectrum, or (N1 = 8) k1 = tig
        // * 2 + e of plane row unit_row + (b_c0 + j * 8) / 8.
        long long obase = 0, rbase = 0;
        if constexpr (!N8) {
          const int prow = unit_row<false>(p, cc.u);  // b * S + s
          obase = static_cast<long long>(prow) * n;
          rbase = static_cast<long long>(prow / p.n_spectra) * n;
        }
        constexpr int SS = 4 * S::NJB;  // accumulator stride of the sums
#pragma unroll
        for (int j = 0; j < S::NJB; ++j) {
          if constexpr (N8) {
            // This n8 tile's spectrum (decoded here: a row kept live across
            // the loop spilled).
            const int prow = unit_row<true>(p, cc.u) + (b_c0 + j * 8) / 8;
            if (prow >= p.n_rows) continue;
            obase = static_cast<long long>(prow) * n;
            rbase = static_cast<long long>(prow / p.n_spectra) * n;
          }
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int k2 = row + g + hh * 8;
            if (N8 && k2 >= n2) continue;  // (N2 < 16: the padded rows)
            const int ch = k2 * n1 + (N8 ? tig * 2 : k0 + b_c0 + j * 8 + tig * 2);
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

// The tile depths, ring depth and bytes of a chunk of KC rows, 0 if it
// cannot fit: the deepest K tiles (64, 32, 16) with 4 stages, else 3, that
// fit. (ops/fengine_fused.py:_dit_body asks dit_dft_attributes whether one
// does.) N8: N1 = 8's plan, KC / 8 spectra a unit, stage A one 8-deep tile
// of their whole planes, N2 padded to MIN_N2P for stage B.
template <int KC, bool N8>
size_t dit_plan(DftParams& p) {
  using S = DitShape<KC>;
  if (N8 ? (p.n1 != 8 || p.n2 < 4) : (p.n1 < 16 || KC > p.n1 || p.n2 < MIN_N2P)) return 0;
  p.n2p = max(p.n2, MIN_N2P);
  const size_t t_bytes = sizeof(bf16) * 4 * static_cast<size_t>(KC) * (p.n2p + PAD);
  // The 16-row chunk takes 16-deep K tiles only, so its K loops run one
  // step each (unrolled at compile time: a loop of run-time length spilled).
  for (int kt = KC == 16 && !N8 ? 16 : 64; kt >= 16; kt /= 2) {
    if ((!N8 && kt > p.n1) || kt > p.n2p) continue;
    const int a_slot = N8 ? KC * (S::NA + PAD) : kt * (S::NA + PAD) + 2 * KC * (kt + PAD);
    const int b_slot = 2 * S::MB * (kt + PAD);
    for (int stages = 4; stages >= 3; --stages) {
      const size_t bytes = t_bytes + sizeof(bf16) * static_cast<size_t>(stages) *
                                         static_cast<size_t>(max(a_slot, b_slot));
      if (bytes > MAX_SMEM) continue;
      p.kt = N8 ? 8 : kt;
      p.ktb = kt;
      p.slot = max(a_slot, b_slot);
      p.stages = stages;
      p.n_ca = (2 * p.n2 + S::NA - 1) / S::NA;
      p.n_kta = p.n1 / p.kt;
      p.n_rb = (p.n2 + S::MB - 1) / S::MB;
      p.n_ktb = p.n2p / kt;
      p.n_chunks = N8 ? 1 : p.n1 / KC;
      p.sb = N8 ? KC / 8 : 1;
      return bytes;
    }
  }
  return 0;
}

template <int KC, bool CHAIN, int STOP = DFT_FULL, bool N8 = false>
cudaError_t launch_dft(DftParams p, int batch, size_t bytes, cudaStream_t stream) {
  auto kern = dit_dft_kernel<KC, CHAIN, STOP, N8>;
  if (STOP == DFT_STAGEA || STOP == DFT_STAGEA_T) p.n_rb = 0;  // no stage-B tiles
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
  const long long rows = static_cast<long long>(batch) * p.n_spectra;
  const long long units = N8 ? (rows + p.sb - 1) / p.sb : rows * p.n_chunks;
  const long long resident = static_cast<long long>(sms) * per_sm;
  const int grid = static_cast<int>(units < resident ? units : resident);
  // Unit indices, plane rows and a block's tile count must fit an int.
  const long long tpu = p.n_ca * p.n_kta + p.n_rb * p.n_ktb;
  if (rows > 0x7fffffffLL - KC) return cudaErrorInvalidValue;
  p.n_rows = static_cast<int>(rows);
  if (units > 0x7fffffffLL - grid || ((units + grid - 1) / grid) * tpu > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  p.n_units = static_cast<int>(units);
  kern<<<grid, DFT_THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

// Calls fn(std::integral_constant<int, KC>, std::bool_constant<N8>, params,
// bytes) with the largest chunk whose T planes and ring fit (N1 = 8: 16
// spectra a unit, else 8), or returns NO_PLAN.
template <typename Fn>
int with_plan(const DftParams& p, Fn fn) {
  DftParams q = p;
  size_t bytes;
  if (p.n1 == 8) {
    if ((bytes = dit_plan<KC_N8, true>(q))) {
      return fn(std::integral_constant<int, KC_N8>{}, std::true_type{}, q, bytes);
    }
    q = p;
    if ((bytes = dit_plan<KC_N8_HALF, true>(q))) {
      return fn(std::integral_constant<int, KC_N8_HALF>{}, std::true_type{}, q, bytes);
    }
    return NO_PLAN;
  }
  if ((bytes = dit_plan<64, false>(q))) {
    return fn(std::integral_constant<int, 64>{}, std::false_type{}, q, bytes);
  }
  q = p;
  if ((bytes = dit_plan<32, false>(q))) {
    return fn(std::integral_constant<int, 32>{}, std::false_type{}, q, bytes);
  }
  q = p;
  if ((bytes = dit_plan<16, false>(q))) {
    return fn(std::integral_constant<int, 16>{}, std::false_type{}, q, bytes);
  }
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
//   stage B tiles, in NH = 2 halves of the k2 range (all N2 values of k2,
//     not K1's half; one at N2 = 4): [KTB x 2·H] of the half's N2-point
//     matrix, transposed ([n2][cos of the half's H = N2 / NH k2, then
//     -sin]). A thread owns 4 k2 x 2 T rows x both streams x the four sums
//     cos.tr, -sin.ti, cos.ti, -sin.tr (64 accumulators; 4 shared loads
//     feed 64 FFMA, as in K1); then the plain version's epilogue: each
//     stream's re and im, X = E + (untc + i·unts)·O in f32, the rotation,
//     rint, clip, int8.
// Against K1's f32 pass a T row holds 4·N2 floats, not 2·N2, so with the
// same 64 KB of T planes and the same stage-A tile (KC · SB · 2N2 = 8192)
// SB halves: KC = 16 with SB = 256 / N2 up to N2 = 256 (two spectra a unit
// at the flagship's 256·128), KC = 8 at N2 = 512. N1 = 8 takes KC = 8 with
// SB = 2048 / (8·H) spectra a unit (the 256 threads' stage-B rows: 512 / N2
// from N2 = 8, 64 at N2 = 4, where the unit fills half the stage-A tile).
// N2 >= 1024 (fft >= 2^21) has no plan: the three-pass route takes it
// (dit_dft_f32_attributes decides). T rows are XOR-swizzled by 16-byte
// groups ((row / 2) % 8, fewer groups in rows under 32 floats), so stage A's
// row-wise float2 stores and stage B's reads of two rows at a time are both
// free of bank conflicts.
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
  int nh;                  // halves of k2 in stage B: 2, or 1 at N2 = 4
  int sb, ktb;             // spectra a unit; stage-B K-tile depth
  int n_kta, n_ktb;        // K tiles: stage A; each half of stage B
  int n_chunks, n_sblk;    // k1 chunks; blocks of SB spectra a stream
  int n_units;             // G * n_sblk * n_chunks
};

// The swizzled float index of T row `row`, even column `col` (a float2 or a
// 4-aligned float4 stays whole); sw = the 16-byte groups a row's swizzle
// spans, less one (7, or N2 / 4 - 1 in rows under 32 floats).
__device__ __forceinline__ int t_at(int row, int col, int n2, int sw) {
  return row * n2 + (col ^ (((row >> 1) & sw) << 2));
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
      if ((col >> lw) < p.sb && s < p.n_spectra) {
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
    // [KTB x 2H] of the half's transposed N2-point matrix: one contiguous run.
    const int l = c.local - p.n_kta, half = l >= p.n_ktb, kidx = l - half * p.n_ktb;
    const int w = 2 * p.n2 / p.nh;  // 2H floats a row
    const float* src = p.d2h + (static_cast<long long>(half) * p.n2 + kidx * p.ktb) * w;
    const int nf = p.ktb * w;
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
  const int n1 = p.n1, n2 = p.n2, h = n2 / p.nh, n = n1 * n2, w2 = 2 * n2;
  const int sw = min(7, n2 / 4 - 1);  // T's swizzle (t_at)
  float* sT = fsmem;  // [4][SB*KC][N2]: even re, even im, odd re, odd im (t_at)
  float* ring = sT + 4 * F32_TP;

  const int nA = p.n_kta, tpu = nA + p.nh * p.n_ktb;
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
          if (s >= p.sb) continue;  // (N2 = 4: the unit fills half the tile)
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
            const int o = t_at(s * KC + 4 * rg + i, m, n2, sw);
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
                                                         t_at(2 * qb + c, nn, n2, sw));
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float* row = slot + (k4 + u) * 2 * h;
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

// The plan of a chunk of KC rows, 0 if it has none: SB = 2048 / (KC·H)
// spectra a unit (NCOL / 2N2 where NH = 2), so that the 256 threads' 4 k2 x
// 2 T rows cover H x SB·KC; stage-B tiles of at most one slot's 8192
// floats, the 4-slot ring beside the T planes. N1 = 8 takes KC = 8 at N2
// from 4 to 128; N1 >= 16 takes N2 from 64 to NCOL / 2.
template <int KC>
size_t f32_plan(F32Params& p) {
  constexpr int NCOL = F32_OUT / KC;
  if (KC > p.n1) return 0;
  if (p.n1 == 8 ? (KC != 8 || p.n2 < 4 || p.n2 > 128) : (p.n1 < 16 || 2 * p.n2 > NCOL || p.n2 < 64)) {
    return 0;
  }
  p.nh = p.n2 < 8 ? 1 : 2;
  const int h = p.n2 / p.nh;
  p.sb = 2048 / (KC * h);
  p.ktb = min(p.n2, F32_SLOT / (2 * h));
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
  const long long tpu = p.n_kta + static_cast<long long>(p.nh) * p.n_ktb;
  if (units > 0x7fffffffLL - grid || ((units + grid - 1) / grid) * tpu > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  p.n_units = static_cast<int>(units);
  kern<<<grid, F32_THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

// Run f(kc, plan, bytes) with the chunk the f32 pass takes for this split
// (16 rows up to N2 = 256, 8 at N2 = 512 and at N1 = 8), or return NO_PLAN.
template <typename F>
int with_f32_plan(const F32Params& p, F&& f) {
  F32Params q = p;
  size_t bytes;
  if ((bytes = f32_plan<16>(q))) return f(std::integral_constant<int, 16>{}, q, bytes);
  q = p;
  if ((bytes = f32_plan<8>(q))) return f(std::integral_constant<int, 8>{}, q, bytes);
  return NO_PLAN;
}

// ---------------------------------------------------------------------------
// The three-pass route's stage B (see the head of the file): T re, im in
// device memory, as K7's stage A writes them, to the outputs. f32: one block
// a tile of FB_M k2 x FB_N k1 of one spectrum, its K loop over n2 through a
// cp.async ring. bf16: the wgmma body below, on K1's three-pass ring
// (csrc/wg_ring.cuh).
// ---------------------------------------------------------------------------
constexpr int TP_THREADS = 256;  // the f32 body: 8 warps
// f32: 64 k2 x 32 k1 a tile, K tiles of 16 n2; a thread 4 k2 x 2 k1 x both
// streams x the four sums (64 accumulators; 6 shared loads per 64 FFMA).
constexpr int FB_M = 64, FB_N = 32, FB_K = 16, FB_STAGES = 4;
constexpr int FB_SLOT = FB_K * 2 * FB_M + 2 * (2 * FB_K) * FB_N;  // floats
constexpr size_t FB_SMEM = sizeof(float) * FB_STAGES * FB_SLOT;
// bf16: a tile is 128 k2 x 32 k1 of one spectrum, both streams, a
// consumer's 64 k2 of it. A K slot (64 n2, TP_SLOT bytes): [cos 64; -sin 64]
// of each consumer's k2 rows (its K-major A operand), then the [32 k1 x 64
// n2] boxes of T re and T im of each stream, in the order tr_e, ti_e, tr_o,
// ti_o (both consumers' K-major B operand, 128 rows). An epilogue slot a
// consumer: [64 k2 x 32 k1] of untc, unts, rotc, rots.
constexpr int DB_T = 4 * TP_BOX;      // a K slot's T boxes, after the k2 rows
constexpr int DB_TBOX = 32 * WG_ROW;  // a T box: 32 rows x 128 bytes
static_assert(DB_T + 4 * DB_TBOX == TP_SLOT, "stage B's K slot");

// The f32 body's parameters.
struct StageBParams {
  const void* tr;     // T re, im: f32 transposed [M, 2·N2, N1] (row 2·n2 + q: stream
  const void* ti;     //   q's n2), M = batch * n_spectra
  const void* d2c;    // _dit_d2h [2][N2][N2] (each half of k2 transposed: cos, then -sin)
  const float* untc;  // [N2, N1] cos(π k / N), k = k2·N1 + k1
  const float* unts;  // -sin
  const float* rotc;  // [batch, N]
  const float* rots;
  int8_t* outr;       // [M, N]
  int8_t* outi;
  int n_spectra, n1, n2;
  int n_ct, n_rt;     // a spectrum's k1 tiles and k2 tiles
};

// This block's tile: spectrum m, first k2 row r0, first k1 column c0 (k1
// tiles fastest, then k2 tiles, then spectra).
struct StageTile {
  long long m;
  int r0, c0;
};

__device__ __forceinline__ StageTile stage_tile(const StageBParams& p, int rows, int cols) {
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

// One (k2, k1)'s epilogue: each stream's re = cos.tr - (-sin.ti), im =
// cos.ti + (-sin.tr) from its four sums s[q][0..3]; X = E + exp(-iπk/N)·O
// (u_c, u_s); the rotation (r_c, r_s); the requant: the (re, im) codes.
__device__ __forceinline__ char2 dit_point(const float (&s)[2][4], float u_c, float u_s,
                                           float r_c, float r_s) {
  const float er = __fsub_rn(s[0][0], s[0][1]);
  const float ei = __fadd_rn(s[0][2], s[0][3]);
  const float orr = __fsub_rn(s[1][0], s[1][1]);
  const float oi = __fadd_rn(s[1][2], s[1][3]);
  const float xr = __fsub_rn(__fadd_rn(er, __fmul_rn(u_c, orr)), __fmul_rn(u_s, oi));
  const float xi = __fadd_rn(__fadd_rn(ei, __fmul_rn(u_c, oi)), __fmul_rn(u_s, orr));
  return make_char2(requant(__fsub_rn(__fmul_rn(xr, r_c), __fmul_rn(xi, r_s))),
                    requant(__fadd_rn(__fmul_rn(xr, r_s), __fmul_rn(xi, r_c))));
}

// The epilogue of two adjacent k1 of one k2 (ch, ch + 1), the sums s[e] of
// k1 ch + e: the int8 pair at o.
__device__ __forceinline__ void stage_b_store(const StageBParams& p, long long o, int ch,
                                              long long rbase, const float (&s)[2][2][4]) {
  const float2 uc = __ldg(reinterpret_cast<const float2*>(p.untc + ch));
  const float2 us = __ldg(reinterpret_cast<const float2*>(p.unts + ch));
  const float2 rc = __ldg(reinterpret_cast<const float2*>(p.rotc + rbase + ch));
  const float2 rs = __ldg(reinterpret_cast<const float2*>(p.rots + rbase + ch));
  const char2 v0 = dit_point(s[0], uc.x, us.x, rc.x, rs.x);
  const char2 v1 = dit_point(s[1], uc.y, us.y, rc.y, rs.y);
  *reinterpret_cast<char2*>(p.outr + o) = make_char2(v0.x, v1.x);
  *reinterpret_cast<char2*>(p.outi + o) = make_char2(v0.y, v1.y);
}

// Stage B, bf16, on wgmma: the output tiles' walk and each call's maps.
struct DbParams {
  int8_t* outr;  // [m, N]
  int8_t* outi;
  int n_spectra, n1, n2;
  int n_k2, n_k1;  // a spectrum's 128-row k2 tiles and 32-column k1 tiles
  int n_kb;        // K slots a tile: N2 / 64
  int n_tiles;     // m * n_k1 * n_k2
};

// 2-D tensor maps, 128-byte swizzle: T re, im viewed [m * 2 * N1, N2] (row
// (spectrum, stream, k1); boxes 32 rows x 64 columns), the N2-point cos and
// -sin [N2, N2] (64 x 64), the f32 combine factors [N2, N1] and the rotation
// planes viewed [batch * N2, N1] (row b N2 + k2, column k1; 64 rows x 32
// columns).
struct DbMaps {
  CUtensorMap tr, ti, d2c, d2s, untc, unts, rotc, rots;
};

// A tile is 128 k2 x 32 k1 of one spectrum. The producer walks each tile's
// K slots, then the two consumers' epilogue slots. A consumer warpgroup (cw
// 0 or 1) takes its 64 k2: [cos rows] x [tr_e | ti_e | tr_o | ti_o] in one
// fragment and [-sin rows] x the same in the other (m64n128k16 from shared
// memory, twice a k-step), chained over n2, one group left in flight while
// the next slot's run. A thread then holds all eight sums of its (k2, k1)
// points: fragment element (row k2 16 wq + g + 8 hh, column 8 j + 2 t + e),
// T block j / 4 (tr_e, ti_e, tr_o, ti_o), k1 8 (j % 4) + 2 t + e.
__global__ void __launch_bounds__(WG_THREADS, 1)
    dit_stage_b_kernel(const DbParams p, const __grid_constant__ DbMaps maps) {
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  uint32_t full, empty;
  const uint32_t ring = tp_ring_init(wg_smem, full, empty);
  const int n1 = p.n1, n2 = p.n2;
  const int wg = threadIdx.x / 128;
  const int my_tiles = (p.n_tiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1;

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(WG_PRODUCER_REGS));
    if (threadIdx.x != 0) return;
    WgRing r;
    for (int i = 0; i < my_tiles; ++i) {
      const TpTile u = tp_tile(blockIdx.x + i * gridDim.x, p.n_k2, p.n_k1);
      const int k2b = 128 * u.c, k1b = 32 * u.r;
      for (int kb = 0; kb < p.n_kb; ++kb, r.next(TP_STAGES)) {
        wg_mbar_wait(empty + 8 * r.slot, r.phase ^ 1);
        const uint32_t s = ring + r.slot * TP_SLOT, bar = full + 8 * r.slot;
        wg_mbar_expect(bar, TP_SLOT);
        for (int a = 0; a < 2; ++a) {
          wg_tma(s + 2 * a * TP_BOX, &maps.d2c, 64 * kb, k2b + 64 * a, bar);
          wg_tma(s + (2 * a + 1) * TP_BOX, &maps.d2s, 64 * kb, k2b + 64 * a, bar);
        }
        for (int x = 0; x < 4; ++x) {
          wg_tma(s + DB_T + x * DB_TBOX, x % 2 ? &maps.ti : &maps.tr, 64 * kb,
                 (2 * u.spec + x / 2) * n1 + k1b, bar);
        }
      }
      // Each consumer's epilogue operands, a slot each.
      for (int w = 0; w < 2; ++w, r.next(TP_STAGES)) {
        wg_mbar_wait(empty + 8 * r.slot, r.phase ^ 1);
        const uint32_t s = ring + r.slot * TP_SLOT, bar = full + 8 * r.slot;
        wg_mbar_expect(bar, 4 * TP_BOX);
        const int k2 = k2b + 64 * w, rrow = (u.spec / p.n_spectra) * n2 + k2;
        wg_tma(s, &maps.untc, k1b, k2, bar);
        wg_tma(s + TP_BOX, &maps.unts, k1b, k2, bar);
        wg_tma(s + 2 * TP_BOX, &maps.rotc, k1b, rrow, bar);
        wg_tma(s + 3 * TP_BOX, &maps.rots, k1b, rrow, bar);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(WG_CONSUMER_REGS));
  const int cw = wg - 1, wt = threadIdx.x - 128 * wg;
  const int wq = wt / 32, lane = wt % 32, g = lane / 4, t = lane % 4;
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
      const uint32_t dc = s + 2 * cw * TP_BOX, ds = dc + TP_BOX, tk = s + DB_T;
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
    int ep_slot = 0;
    const uint32_t ep = tp_own_slot(r, ring, full, empty, cw, wt, ep_slot);
    // Each stream's sums [cos.tr, -sin.ti, cos.ti, -sin.tr] of k1 8 jj + 2 t
    // + e, its combine factors and rotation values from the staged slot (the
    // pair e = 0, 1 at once), then the codes, as a pair along k1.
    const long long obase = static_cast<long long>(u.spec) * n1 * n2 + 32 * u.r;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int k2 = 16 * wq + g + 8 * hh, k1 = 8 * jj + 2 * t;
        const float2 uc = wg_ld_f2(wg_f32_at(ep, k2, k1));
        const float2 us = wg_ld_f2(wg_f32_at(ep + TP_BOX, k2, k1));
        const float2 rc = wg_ld_f2(wg_f32_at(ep + 2 * TP_BOX, k2, k1));
        const float2 rs = wg_ld_f2(wg_f32_at(ep + 3 * TP_BOX, k2, k1));
        char2 v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float sm[2][4];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int fr = 4 * (jj + 8 * q) + 2 * hh + e, fi = fr + 16;  // T re, T im
            sm[q][0] = fc[fr];
            sm[q][1] = fs[fi];
            sm[q][2] = fc[fi];
            sm[q][3] = fs[fr];
          }
          v[e] = dit_point(sm, e ? uc.y : uc.x, e ? us.y : us.x, e ? rc.y : rc.x,
                           e ? rs.y : rs.x);
        }
        const long long o = obase + static_cast<long long>(128 * u.c + 64 * cw + k2) * n1 + k1;
        *reinterpret_cast<char2*>(p.outr + o) = make_char2(v[0].x, v[1].x);
        *reinterpret_cast<char2*>(p.outi + o) = make_char2(v[0].y, v[1].y);
      }
    }
    wg_warpgroup_sync(cw);  // every thread's epilogue operands are read
    if (wt == 0) wg_mbar_arrive(empty + 8 * ep_slot);
  }
}

// Stage B, f32 (exact f32 FFMA): per stream the four products of a [64 k2 x
// 32 k1] tile over n2, the half of the N2-point matrix that holds the tile's
// k2 ([n2][cos, then -sin]) against T transposed ([2·n2 + q][k1], as K1's f32
// stage A writes it on the [N1, 2·N2] view), then the epilogue. A half-warp
// reads 16 runs of 4 k2; the two k1 pairs of a warp are broadcasts.
__global__ void __launch_bounds__(TP_THREADS, 1) dit_stage_b_f32_kernel(StageBParams p) {
  extern __shared__ __align__(128) float f3_smem[];
  const int tid = threadIdx.x;
  const int n1 = p.n1, n2 = p.n2, h = n2 / 2, n = n1 * n2;
  const StageTile w = stage_tile(p, FB_M, FB_N);  // rows: k2; columns: k1
  const long long mat = w.m * 2 * n2 * static_cast<long long>(n1);
  const int half = w.r0 / h;
  const float* d2 = static_cast<const float*>(p.d2c) + static_cast<long long>(half) * n2 * n2 +
                    (w.r0 - half * h);
  const float* tr = static_cast<const float*>(p.tr) + mat + w.c0;  // [2·N2][N1]
  const float* ti = static_cast<const float*>(p.ti) + mat + w.c0;
  const int rb = (tid % 16) * 4, qb = (tid / 16) * 2;  // k2 rows rb.., k1 columns qb..
  float acc[64];  // [stream q][sum s][k2 a][k1 c] at ((q * 4 + s) * 4 + a) * 2 + c
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  auto load = [&](int kt, float* slot) {
    // [FB_K x 2·FB_M]: row n2, the tile's k2 cos at 0.., -sin at FB_M..;
    // then T re and T im, [2·FB_K rows (n2, q) x FB_N k1] each.
#pragma unroll 1
    for (int i = threadIdx.x; i < FB_K * 2 * FB_M / 4; i += TP_THREADS) {
      const int r = i / (2 * FB_M / 4), q = (i % (2 * FB_M / 4)) * 4;
      cp_async16(slot + r * 2 * FB_M + q,
                 d2 + (static_cast<long long>(kt * FB_K + r) * n2 + (q < FB_M ? q : h + q - FB_M)));
    }
    float* st = slot + FB_K * 2 * FB_M;
#pragma unroll 1
    for (int i = threadIdx.x; i < 2 * 2 * FB_K * FB_N / 4; i += TP_THREADS) {
      const int mm = i / (2 * FB_K * FB_N / 4), j = i % (2 * FB_K * FB_N / 4);
      const int r = j / (FB_N / 4), q = (j % (FB_N / 4)) * 4;
      cp_async16(st + (mm * 2 * FB_K + r) * FB_N + q,
                 (mm ? ti : tr) + (static_cast<long long>(2 * kt * FB_K + r) * n1 + q));
    }
  };
  auto compute = [&](const float* slot) {
    const float* sD = slot;
    const float* sTr = slot + FB_K * 2 * FB_M;
    const float* sTi = sTr + 2 * FB_K * FB_N;
#pragma unroll
    for (int kk = 0; kk < FB_K; ++kk) {
      const float4 dc = *reinterpret_cast<const float4*>(sD + kk * 2 * FB_M + rb);
      const float4 ds = *reinterpret_cast<const float4*>(sD + kk * 2 * FB_M + FB_M + rb);
      const float cv[4] = {dc.x, dc.y, dc.z, dc.w}, sv[4] = {ds.x, ds.y, ds.z, ds.w};
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float2 t_r = *reinterpret_cast<const float2*>(sTr + (2 * kk + q) * FB_N + qb);
        const float2 t_i = *reinterpret_cast<const float2*>(sTi + (2 * kk + q) * FB_N + qb);
        const float trv[2] = {t_r.x, t_r.y}, tiv[2] = {t_i.x, t_i.y};
#pragma unroll
        for (int a = 0; a < 4; ++a) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float* s = acc + (q * 16 + a) * 2 + c;  // sum k at s[k * 8]
            s[0] = fmaf(cv[a], trv[c], s[0]);
            s[8] = fmaf(sv[a], tiv[c], s[8]);
            s[16] = fmaf(cv[a], tiv[c], s[16]);
            s[24] = fmaf(sv[a], trv[c], s[24]);
          }
        }
      }
    }
  };
  ring_loop<FB_STAGES>(f3_smem, FB_SLOT, n2 / FB_K, load, compute);

  const long long rbase = (w.m / p.n_spectra) * n;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int ch = (w.r0 + rb + a) * n1 + w.c0 + qb;
    float s[2][2][4];  // [k1 c][stream q][sum]
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
#pragma unroll
        for (int k = 0; k < 4; ++k) s[c][q][k] = acc[((q * 4 + k) * 4 + a) * 2 + c];
      }
    }
    stage_b_store(p, w.m * n + ch, ch, rbase, s);
  }
}

// Whether the three-pass tiles cover N1 x N2 (both stage Bs; K1's stage A
// checks its own at N1 x 2·N2): powers of two, N1 a multiple of the bf16
// body's 64-k1 tiles (and of the f32 body's 32) and at least K1's 64-row
// stage-A tile, N2 / 2 a multiple of the 64-k2 tiles (the bf16 body's, and
// the f32 body's within a half of k2), and the indices in 32 bits (N1 <=
// 2^15, 2·N2 <= 2^15).
bool three_pass_split(int n1, int n2) {
  return n1 >= 64 && n1 <= (1 << 15) && (n1 & (n1 - 1)) == 0 && n2 >= 128 && n2 <= (1 << 14) &&
         (n2 & (n2 - 1)) == 0;
}

// Launches the f32 stage-B kernel, one block a tile.
template <typename K>
cudaError_t launch_stage_b(K kern, const StageBParams& p, long long tiles, size_t smem,
                           cudaStream_t stream) {
  if (tiles < 1 || tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<static_cast<unsigned>(tiles), TP_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// A stage-B kernel's body: out int[9] = registers a thread, local (spill)
// bytes a thread, threads a block, shared-memory bytes, tile rows (k2), tile
// columns (k1), K-tile depth, ring stages, blocks an SM (as K1's
// k1_stage_*_attributes give theirs).
template <typename K>
int stage_b_attributes(K kern, size_t smem, int rows, int cols, int depth, int stages,
                       void* out) {
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

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

// The DFT pass's parameters with the operands every entry passes.
DftParams dft_params(const void* plane, const void* d1c, const void* d1s, const void* d2c,
                     const void* d2s, const void* twc, const void* tws, void* outr, void* outi,
                     int n_spectra, int n1, int n2) {
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
  return p;
}

}  // namespace

// The two-pass route's DFT pass: plane [batch, n_spectra, fft] bf16 (K1's FIR
// pass output, fft = 2·N1·N2) -> outputs [batch, n_spectra, N] int8. d1c,
// d1s are the bf16 N1-point matrices, d2c, d2s the bf16 N2-point matrices
// [N2P, N2P] (N2P = max(N2, 16), zero-padded), twc/tws the f32 twiddles
// [N1, N2], untc/unts the f32 combine factors [N2, N1], rotc/rots [batch,
// N]. Returns -1 where no chunk's plan fits shared memory (N2 >= 2048: the
// three-pass route's splits).
extern "C" int dit_dft_launch(const void* plane, const void* d1c, const void* d1s,
                              const void* d2c, const void* d2s, const void* twc, const void* tws,
                              const void* untc, const void* unts, const void* rotc,
                              const void* rots, void* outr, void* outi, int batch,
                              int n_spectra, int n1, int n2, void* stream) {
  if (!pow2(n1) || !pow2(n2) || batch < 1 || n_spectra < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DftParams p = dft_params(plane, d1c, d1s, d2c, d2s, twc, tws, outr, outi, n_spectra, n1, n2);
  p.untc = static_cast<const float*>(untc);
  p.unts = static_cast<const float*>(unts);
  p.rotc = static_cast<const float*>(rotc);
  p.rots = static_cast<const float*>(rots);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_plan(p, [&](auto kc, auto n8, const DftParams& q, size_t bytes) {
    constexpr int K = decltype(kc)::value;
    cudaError_t err;
    if constexpr (decltype(n8)::value) {
      err = launch_dft<K, true, DFT_FULL, true>(q, batch, bytes, st);
    } else {
      err = n1 <= CHAIN_N1 ? launch_dft<K, true>(q, batch, bytes, st)
                           : launch_dft<K, false>(q, batch, bytes, st);
    }
    return static_cast<int>(err);
  });
}

// What the DFT pass's body at N1 x N2 is: out[0] registers a thread, out[1]
// local (spill) bytes a thread, out[2] KC (T rows a unit: 128 or 64 at N1 =
// 8), out[3] the stage-B K-tile depth, out[4] ring stages, out[5] dynamic
// shared-memory bytes, out[6] spectra a unit. Returns -1 where no plan fits
// (the split then takes the three-pass route, or none).
extern "C" int dit_dft_attributes(int n1, int n2, void* out) {
  if (!pow2(n1) || !pow2(n2)) return static_cast<int>(cudaErrorInvalidValue);
  DftParams p{};
  p.n_spectra = 1;
  p.n1 = n1;
  p.n2 = n2;
  int* o = static_cast<int*>(out);
  return with_plan(p, [&](auto kc, auto n8, const DftParams& q, size_t bytes) {
    cudaFuncAttributes a{};
    constexpr int K = decltype(kc)::value;
    cudaError_t err;
    if constexpr (decltype(n8)::value) {
      err = cudaFuncGetAttributes(&a, dit_dft_kernel<K, true, DFT_FULL, true>);
    } else {
      err = n1 <= CHAIN_N1 ? cudaFuncGetAttributes(&a, dit_dft_kernel<K, true>)
                           : cudaFuncGetAttributes(&a, dit_dft_kernel<K, false>);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    o[0] = a.numRegs;
    o[1] = static_cast<int>(a.localSizeBytes);
    o[2] = K;
    o[3] = q.ktb;
    o[4] = q.stages;
    o[5] = static_cast<int>(bytes);
    o[6] = q.sb;
    return 0;
  });
}

// The DFT pass cut at a stage (stop 1 stagea, 2 stageb, 3 stagea writing T
// re; see the head of the file): the arguments of dit_dft_launch without the
// combine factors and rotation planes, int8 outputs [batch, n_spectra, N].
// The stops take the 64-row chunk plan with chained stage-A sums only (64 <=
// N1 <= 256, N2 <= 256); -1 elsewhere.
extern "C" int dit_dft_stop_launch(const void* plane, const void* d1c, const void* d1s,
                                   const void* d2c, const void* d2s, const void* twc,
                                   const void* tws, void* outr, void* outi, int batch,
                                   int n_spectra, int n1, int n2, int stop, void* stream) {
  if (!pow2(n1) || !pow2(n2) || batch < 1 || n_spectra < 1 ||
      (stop != DFT_STAGEA && stop != DFT_STAGEB && stop != DFT_STAGEA_T)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DftParams p =
      dft_params(plane, d1c, d1s, d2c, d2s, twc, tws, outr, outi, n_spectra, n1, n2);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_plan(p, [&](auto kc, auto n8, const DftParams& q, size_t bytes) {
    if constexpr (decltype(kc)::value != 64 || decltype(n8)::value) {
      return NO_PLAN;
    } else {
      if (n1 > CHAIN_N1) return NO_PLAN;
      cudaError_t err;
      switch (stop) {
        case DFT_STAGEA: err = launch_dft<64, true, DFT_STAGEA>(q, batch, bytes, st); break;
        case DFT_STAGEA_T: err = launch_dft<64, true, DFT_STAGEA_T>(q, batch, bytes, st); break;
        default: err = launch_dft<64, true, DFT_STAGEB>(q, batch, bytes, st); break;
      }
      return static_cast<int>(err);
    }
  });
}

// The f32 two-pass route's DFT pass: plane [batch, n_spectra, fft] f32
// (K1's f32 FIR pass output, fft = 2·N1·N2; 16-byte aligned) -> outputs
// [batch, n_spectra, N] int8. d1c, d1s are the f32 N1-point matrices, d2h
// the f32 N2-point matrix in NH halves of k2 (2; 1 at N2 = 4), each
// transposed ([NH][n2][cos, then -sin]), twc/tws the f32 twiddles [N1, N2],
// untc/unts the f32 combine factors [N2, N1], rotc/rots [batch, N] (8-byte
// aligned). Returns -1 where the pass has no plan (N2 >= 1024: the
// three-pass route's splits).
extern "C" int dit_dft_f32_launch(const void* plane, const void* d1c, const void* d1s,
                                  const void* d2h, const void* twc, const void* tws,
                                  const void* untc, const void* unts, const void* rotc,
                                  const void* rots, void* outr, void* outi, int batch,
                                  int n_spectra, int n1, int n2, void* stream) {
  if (!pow2(n1) || !pow2(n2) || batch < 1 || n_spectra < 1) {
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
// split then takes the three-pass route, or none): out int[8] = registers a
// thread, local (spill) bytes a thread, KC, SB, stage-B K-tile depth, ring
// stages, shared-memory bytes, threads a block.
extern "C" int dit_dft_f32_attributes(int n1, int n2, void* out) {
  if (!pow2(n1) || !pow2(n2)) return static_cast<int>(cudaErrorInvalidValue);
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

// The three-pass route's stage B: T re, im as K7's stage A writes them (bf16
// [batch, n_spectra, 2, N1, N2], each stream's plane) -> outputs [batch,
// n_spectra, N] int8; d2c/d2s the bf16 [N2, N2] cos and -sin, untc/unts the
// f32 combine factors [N2, N1], rotc/rots [batch, N] (T, the matrices, the
// factors and the rotation planes 16-byte aligned). Returns -1 where the
// route's tiles do not cover the split.
extern "C" int dit_stage_b_launch(const void* tr, const void* ti, const void* d2c,
                                  const void* d2s, const void* untc, const void* unts,
                                  const void* rotc, const void* rots, void* outr, void* outi,
                                  int batch, int n_spectra, int n1, int n2, void* stream) {
  if (batch < 1 || n_spectra < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (!three_pass_split(n1, n2)) return NO_PLAN;
  for (const void* ptr : {tr, ti, d2c, d2s, untc, unts, rotc, rots}) {
    if (!aligned_to(ptr, 16)) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!aligned_to(outr, 2) || !aligned_to(outi, 2)) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned long long rows = 2ULL * batch * n_spectra * n1;
  const unsigned long long rot_rows = static_cast<unsigned long long>(batch) * n2;
  const long long tiles = static_cast<long long>(batch) * n_spectra * (n1 / 32) * (n2 / 128);
  if (rows > 0x7fffffffULL || rot_rows > 0x7fffffffULL || tiles > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DbMaps maps{};
  if (!wg_map(maps.tr, tr, n2, rows, 32) || !wg_map(maps.ti, ti, n2, rows, 32) ||
      !wg_map(maps.d2c, d2c, n2, n2, 64) || !wg_map(maps.d2s, d2s, n2, n2, 64) ||
      !wg_map(maps.untc, untc, n1, n2, 64, true) || !wg_map(maps.unts, unts, n1, n2, 64, true) ||
      !wg_map(maps.rotc, rotc, n1, rot_rows, 64, true) ||
      !wg_map(maps.rots, rots, n1, rot_rows, 64, true)) {
    return static_cast<int>(cudaErrorNotSupported);
  }
  const DbParams p{static_cast<int8_t*>(outr), static_cast<int8_t*>(outi), n_spectra, n1, n2,
                   n2 / 128, n1 / 32, n2 / 64, static_cast<int>(tiles)};
  return static_cast<int>(
      launch_tp_wg(dit_stage_b_kernel, p, maps, static_cast<cudaStream_t>(stream)));
}

// Stage B with f32 operands: T re, im transposed as K1's f32 stage A writes
// them ([batch, n_spectra, 2·N2, N1] f32, 16-byte aligned), d2h the f32
// N2-point matrix in two halves of k2, each transposed ([2][n2][cos, then
// -sin], as dit_dft_f32_launch takes it); the rest as dit_stage_b_launch.
extern "C" int dit_stage_b_f32_launch(const void* tr, const void* ti, const void* d2h,
                                      const void* untc, const void* unts, const void* rotc,
                                      const void* rots, void* outr, void* outi, int batch,
                                      int n_spectra, int n1, int n2, void* stream) {
  if (batch < 1 || n_spectra < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (!three_pass_split(n1, n2)) return NO_PLAN;
  const StageBParams p{tr, ti, d2h,
                       static_cast<const float*>(untc), static_cast<const float*>(unts),
                       static_cast<const float*>(rotc), static_cast<const float*>(rots),
                       static_cast<int8_t*>(outr), static_cast<int8_t*>(outi),
                       n_spectra, n1, n2, n1 / FB_N, n2 / FB_M};
  const long long tiles = static_cast<long long>(batch) * n_spectra * p.n_ct * p.n_rt;
  return static_cast<int>(launch_stage_b(dit_stage_b_f32_kernel, p, tiles, FB_SMEM,
                                         static_cast<cudaStream_t>(stream)));
}

// Each stage-B body at N1 x N2, -1 where the route's tiles do not cover the
// split: bf16, out int[11] as K1's k1_stage_b_attributes gives it (tile rows
// k2, columns k1; the sums chained over all N2 products); f32, out int[9] as
// k1_stage_b_f32_attributes.
extern "C" int dit_stage_b_attributes(int n1, int n2, void* out) {
  if (!three_pass_split(n1, n2)) return NO_PLAN;
  return wg_stage_attributes(dit_stage_b_kernel, 128, 32, n2, out);
}

extern "C" int dit_stage_b_f32_attributes(int n1, int n2, void* out) {
  if (!three_pass_split(n1, n2)) return NO_PLAN;
  return stage_b_attributes(dit_stage_b_f32_kernel, FB_SMEM, FB_M, FB_N, FB_K, FB_STAGES, out);
}
