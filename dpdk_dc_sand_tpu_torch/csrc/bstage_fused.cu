// K2: fused B-stage for Hopper (sm_90a) — corner turn + multi-beam dot.
//
// Replaces the TPU kernel dpdk_dc_sand_tpu/ops/bstage_pallas.py:_kernel
// (reached from beamform_turned_fused through pl.pallas_call). It computes
//   out[c/pack, p*S+s, (c%pack)*2B + n] =
//       sum_a qr[a,p,s,c]*W[c,a,n] + qi[a,p,s,c]*W[c,A+a,n]
// with int8 samples converted exactly, W in bf16 or f32, and f32 sums. The
// packed [C/pack, P*S, pack*2B] output (pack = 128/2B) is the egress layout
// and is kept; the TPU's block-diagonal fold only filled MXU lanes and is
// not ported.
//
// One body, bstage_ring_kernel, for both weight types and every 2B in {2,
// 4, 8, 16, 32, 64, 128} (the reference's gate), and every channel count
// with C % pack == 0: each channel's [m x 2A] @ [2A x 2B] product runs on
// the tensor cores (mma.sync m16n8k16 bf16, f32 sums).
//
// f32 weights on bf16 tensor cores, exactly. An int8 sample is exact in
// bf16. Each f32 weight w splits into three bf16 terms: h = bf16(w), m =
// bf16(w - h), l = bf16(w - h - m). Each subtraction is exact in f32 (the
// residue of rounding to fewer bits), and h + m + l carries all 24 bits of
// w's significand, so x*h + x*m + x*l, each product exact, is x*w. Two terms
// keep 17 bits: about 127 * 2^-17 a term, which a cancelling sum over 2A =
// 160 terms carries past K2's atol of 1e-3. The A fragments are turned once
// a K step and meet three B fragments: three MMAs chained from zero (the
// small terms first), their sum added to the accumulator in f32
// round-to-nearest, once a K step, as the plain f32 product adds. The split
// happens in the kernel: f32 weight rows are staged in shared memory as
// they arrive (ldmatrix reads 16-bit elements only, so each lane loads its
// four f32 values of a fragment and splits them in registers). A pre-pass
// kernel writing three bf16 planes would move 1.5 times the f32 weight
// bytes through the SMs again for every m tile, and add its own write and
// read of them in device memory.
//
// What bounds K2 on this card: bytes. At the flagship (A = 80, P*S = 512,
// C = 32768, 2B = 32) it must read 2.684 GB of int8 planes and 0.336 GB of
// bf16 weights (0.671 GB f32) and write 2.147 GB of f32 beams: 1.543 ms
// (1.642 f32) at 3.35 TB/s. Its 0.172 TFLOP of bf16 products (0.515 with
// the f32 form's three terms) would take 0.17 ms (0.52) at the tensor
// cores' peak, so feeding the MMAs, not the MMAs, sets its pace.
//
// Geometry. A work item is (channel block of 16 channels, m tile of MT rows,
// column half); each K step stages 16 contraction rows (one mma depth) in
// a ring of D = 3 stages. The item computes NBI columns: 2B, but 8 for 2B <
// 8 (the weight rows padded to 8 zero columns in shared memory, only the
// real ones stored) and 64 for 2B = 128 (two items a channel block, one
// for each half of the columns, which read the same plane rows). The
// accumulators bound the item at 16 * MT * NBI <= 32K f32 sums, 128 a thread
// of 256: MT = 64 for NBI <= 32, 32 for NBI = 64.
// Weights are held whole in shared memory when an item has at least D K
// steps and they fit beside the ring: bf16 at the flagship 160 KB (16
// channels x 160 rows x 32 beams x 2 bytes) + 48 KB of ring = 208 KB a
// block, one block on each SM; otherwise (f32 at the flagship: 320 KB; 2B
// >= 64 at A = 80; or 2A <= 32) each stage also carries its K step's weight
// rows. From L2 to the SMs that is, at the flagship: the plane rows as
// 16-byte runs, each half a 32-byte sector (5.369 GB of sectors for 2.684
// GB of samples), and the bf16 weights once (0.336 GB): 5.704 GB; the f32
// form's staged weights once an m tile (0.671 GB x 8): 10.737 GB. Against 32
// channels a block: the runs would be whole sectors (2.684 GB), but the
// accumulators would cut MT to 32 and a block's weights would be staged
// for each of 16 m tiles. 16 channels it is; a warp's 4 channels then fill
// whole packed rows (512 bytes at 2B = 32).
//
// Design.
//   Persistent blocks: one 256-thread block on each SM. With resident
//   weights a block walks column units (channel block, column half)
//   blockIdx.x, + gridDim.x, ..., each with its m tiles in order, and copies
//   a unit's weights with its first m tile; staged, it walks the (unit, m
//   tile) items m tiles fastest. Either way the blocks in flight together
//   hold neighbouring channel blocks, so each plane sector comes from HBM
//   once and serves its two halves from L2.
//   A ring of rows: each K step's plane rows (16-byte runs of
//   [k, m, c0:c0+16] of qr and qi, 16 x MT of them) reach the block by
//   16-byte cp.async.cg with an L2 prefetch of the 128-byte line (its
//   other runs belong to the blocks of neighbouring channels), and staged
//   weight rows ([c][k0:k0+16][NBI]) through the same stages. Where C % 16
//   != 0 or a plane base is not 16-byte aligned, the runs lose their
//   alignment: each thread then loads its runs' channels below C byte by
//   byte and stores the run (zeros past C) into its slot; the ring and its
//   barriers are the same. The last channel block of such a C is masked:
//   zero samples and weights in, no stores past C. The ring runs D - 1 = 2
//   K steps ahead across the end of a work item, so the next item's first
//   copies are in flight during this item's last MMAs and its stores. The
//   planes stay int8 in shared memory, a run a 16-byte slot (conflict-free
//   copies). bf16 weight rows' 16-byte chunks sit at j ^ ((row / (8 / NT)) %
//   NT), so that ldmatrix reads 8 rows from 8 distinct bank groups; f32
//   rows' at j ^ 2 ((row / 2) % 4) (fewer for rows under 128 bytes), so
//   that a lane group's four rows of a fragment load meet distinct banks.
//   The turn in registers: warp (word cw, m half) owns channels 4cw .. 4cw+3
//   of the block and MT/2 rows of m. Eight words of a 16 x 16 A tile give
//   its A fragments for all 4 channels: for each channel a byte permute and
//   two LOP3s build 128 + (x & 127) and 128 or 256 as bf16 pairs, and one
//   bf16x2 FMA subtracts them: x exactly. All 32 lanes read the same word
//   of their runs, so those loads meet 4-way bank conflicts (8 banks hold
//   that word of any run); a conflict-free placement needs 4-byte copies
//   (below). bf16 B fragments come from the weight rows by ldmatrix.trans
//   (.x2 where an item has one 8-wide n tile); the bf16 form chains the K
//   steps' MMAs in the accumulators.
//   Whole row segments out: two shuffles in each quad give a lane 4
//   consecutive beams of one channel, so one float4 store a lane writes
//   8 rows x 64 bytes of packed rows a warp instruction (whole sectors);
//   with one n tile a lane stores its two beams as a float2.
//
// What sets its pace (stage stops, phase 6 of chip_smoke.py, and
// development calls on an H100, 700 W; the bf16 form): the copies alone
// take about 1.4 ms and the stores alone about as long as a fill of the
// output (0.69 ms); a stop with both but no MMAs takes about their sum, and
// the MMAs hide behind them. So the copies and the stores do not overlap
// each other: what they share, L2 and its path to the SMs, is the limit,
// and the half sectors of the plane runs are the largest avoidable share
// of its bytes. The f32 form at the flagship (a development call, H100,
// 700 W): 4.46 ms whole; copies alone 4.27, MMAs alone 2.27, stores alone
// 0.68, copies with MMAs 3.67. Its copies set its pace: 10.74 GB from L2
// (the staged f32 weights once an m tile beside the plane sectors), twice
// the bf16 form's. Sharing each weight stage between the blocks of a
// channel block's m tiles (a cluster, TMA multicast) is what would cut it.
//
// Tried and gone (development calls on an H100, 700 W; full bf16 body at
// the flagship): 4-byte cp.async.ca of the runs with a word-level XOR
// swizzle, conflict-free fragment loads: 4.5 ms with the resident weights
// (208-224 KB of shared memory leaves L1 28 KB, and .ca copies allocate
// there), 3.1-3.2 ms with staged weights; 16-byte copies with staged
// weights, 3.1 to 3.6 ms; 32-row K steps in 2 stages, 2.84 ms, against
// 16-row steps in 3 or 4 stages, 2.70 (3 kept), and 2 stages of 16 rows,
// 2.98; the stage's copies split between its MMA slices, no change;
// streaming (.cs) stores, no change. The L2 prefetch took 2.70 to 2.53 ms.
// Reading conflict-free (wrong) positions in place of the conflicted words
// ran 2.47 ms: the conflicts cost about 0.06 ms of the whole. The f32
// form with a 4-stage ring (192 KB a block) tied the 3 stages: 4.435 and
// 4.425 ms against 4.442 and 4.370.
//
// The old tensor-core body (WMMA, one block per 32 channels x 32 rows of m,
// 147 KB of shared memory, a serial load -> turn -> MMA K loop with no copy
// in flight, every plane byte turned by a scalar bf16 store, weights read
// again for every m tile, 64-byte tile stores) ran 7.428 ms at the
// flagship on an H100 and is gone. So is the SIMT body that took f32
// weights and 2B = 8 (one block per 32 channels x 64 rows of m, a byte load
// a contraction row, an FFMA register tile); its f32 time at the flagship
// is in PERF.md.
//
// csrc/bstage_fused_stops.cu includes this file with K2_STAGE_STOPS
// defined and instantiates only the stage stops, in an nvcc process of its
// own.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int RCT = 16;     // channels a work item: one 16-byte run of each plane row
constexpr int KS = 16;      // contraction rows a K step: one mma depth
constexpr int D = 3;        // stages (K steps) in the ring
constexpr int SMEM_MAX = 232448;

// The columns a work item computes for 2B = nb2 (see the note at the head).
constexpr int item_cols(int nb2) { return nb2 <= 8 ? 8 : (nb2 < 64 ? nb2 : 64); }

// The compile-time geometry for NBI item columns and weights of type WT.
template <int NBI, typename WT>
struct Tile {
  static constexpr bool F32 = sizeof(WT) == 4;
  static constexpr int NT = NBI / 8;                 // 8-wide n tiles
  static constexpr int MT = NBI == 64 ? 32 : 64;     // m rows a work item
  static constexpr int MTW = MT / 32;                // 16-row m tiles a warp
  static constexpr int ROW = NBI * static_cast<int>(sizeof(WT));  // bytes of a weight row
  static constexpr int CPR = ROW / 16;               // 16-byte chunks a weight row
  static constexpr int P_STAGE = KS * MT * RCT;      // plane bytes a K step
  static constexpr int W_CH = KS * ROW;              // weight bytes of a channel a K step
  static constexpr int W_STAGE = RCT * W_CH;
  static constexpr int P_ROUNDS = KS * MT / THREADS;       // 16-byte plane runs a thread a K step
  static constexpr int W_PER_CH = KS * CPR;                // 16-byte chunks of a channel a K step
  static constexpr int W_ROUNDS = W_STAGE / 16 / THREADS;  // 16-byte weight chunks a thread a K step
  static_assert(P_ROUNDS >= 1 && W_ROUNDS >= 1 && THREADS % W_PER_CH == 0, "tiles");
  static_assert(RCT * MT * NBI / THREADS <= 128, "at most 128 sums a thread");
};

// The mask of an f32 row's chunk swizzle for CPR chunks a row: 3 from 128
// bytes up, fewer below.
template <int CPR>
__host__ __device__ constexpr int f32_swizzle() {
  return CPR >= 8 ? 3 : CPR / 2 - 1;
}

// Where chunk j of weight row kk sits in its row (see the note at the head).
template <int NBI, typename WT>
__device__ __forceinline__ int chunk_at(int kk, int j) {
  using T = Tile<NBI, WT>;
  if constexpr (T::F32) {
    return j ^ (2 * ((kk >> 1) & f32_swizzle<T::CPR>()));
  } else {
    return j ^ ((kk / (8 / T::NT)) % T::NT);
  }
}

struct Geo {
  int n_ants, k_all, ps, n_ch, nb2, pack;
  int n_ks, n_mt, n_nh, n_cu;  // K steps an item, m tiles, column halves, units (channel block, half)
  int resident;  // weights held whole in shared memory (a slot a K step), else staged a stage
  int wide;      // plane runs by 16-byte cp.async, else by byte loads
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// An N-byte cp.async of which the first src_bytes come from src, the rest zeros.
template <int N>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int src_bytes) {
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src), "n"(N),
                 "r"(src_bytes)
                 : "memory");
  }
}

// Work item j of this block: resident weights walk column units
// blockIdx.x, + gridDim.x, ..., each with all its m tiles in order; staged
// weights walk items blockIdx.x, + gridDim.x, ... of the (unit, m tile)
// list, m tiles fastest. Either way the blocks in flight together hold
// neighbouring channel blocks, which share their plane rows' sectors.
__device__ __forceinline__ void item_of(int j, const Geo& g, int& cu, int& mt) {
  if (g.resident) {
    cu = blockIdx.x + gridDim.x * (j / g.n_mt);
    mt = j % g.n_mt;
  } else {
    const int i = blockIdx.x + j * gridDim.x;
    cu = i / g.n_mt;
    mt = i % g.n_mt;
  }
}

// The plane rows of a K step, [KS][MT] runs of 16 channel bytes: thread t
// copies runs t, t + THREADS, ... (row kk = run / MT, m = run % MT) into
// slot `run` of the stage, by one 16-byte cp.async.cg (wide) or by byte
// loads of the channels below C and one shared store; rows past 2A and
// channels past C are zeros.
template <int NBI, typename WT>
__device__ __forceinline__ void copy_planes(uint32_t stage, const int8_t* __restrict__ qr,
                                            const int8_t* __restrict__ qi, const Geo& g, int cb,
                                            int mt, int k0) {
  using T = Tile<NBI, WT>;
  const long long psc = static_cast<long long>(g.ps) * g.n_ch;
  const int c0 = cb * RCT;
#pragma unroll
  for (int j = 0; j < T::P_ROUNDS; ++j) {
    const int run = threadIdx.x + j * THREADS, kk = run / T::MT, m = run % T::MT, k = k0 + kk;
    const bool ok = k < g.k_all;
    const long long off = static_cast<long long>(mt * T::MT + m) * g.n_ch + c0;
    const int8_t* src = k < g.n_ants ? qr + k * psc + off : qi + (k - g.n_ants) * psc + off;
    if (g.wide) {
      asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(stage + 16 * run),
                   "l"(ok ? src : qr), "r"(ok ? 16 : 0)
                   : "memory");
    } else {
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      if (ok) {
#pragma unroll
        for (int i = 0; i < RCT; ++i) {
          if (c0 + i < g.n_ch) {
            v[i / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(src + i))) << (8 * (i % 4));
          }
        }
      }
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(stage + 16 * run), "r"(v[0]),
                   "r"(v[1]), "r"(v[2]), "r"(v[3])
                   : "memory");
    }
  }
}

// The weight rows of a K step, [16 channels][KS][NBI] of column half nh:
// thread t copies 16-byte chunk j of row kk of channels t / W_PER_CH +
// (THREADS / W_PER_CH) r, placed at chunk_at(kk, j) of its row; rows past
// 2A and channels past C are zero-filled. Where 2B < 8 a row holds 2B real
// columns (4 to 16 bytes, one copy) and zero padding that no copy touches.
template <int NBI, typename WT>
__device__ __forceinline__ void copy_weights(uint32_t slot, const WT* __restrict__ w,
                                             const Geo& g, int cb, int nh, int k0) {
  using T = Tile<NBI, WT>;
  constexpr int WB = sizeof(WT), EPC = 16 / WB;
  const int t = threadIdx.x, q = t % T::W_PER_CH, kk = q / T::CPR, j = q % T::CPR;
  const int k = k0 + kk;
  const int real = NBI > 8 ? 16 : min(16, max(0, g.nb2 * WB - 16 * j));
  const uint32_t dst0 = slot + kk * T::ROW + 16 * chunk_at<NBI, WT>(kk, j);
#pragma unroll
  for (int r = 0; r < T::W_ROUNDS; ++r) {
    const int c = r * (THREADS / T::W_PER_CH) + t / T::W_PER_CH, ch = cb * RCT + c;
    const bool ok = k < g.k_all && ch < g.n_ch;
    const WT* src = w + (static_cast<long long>(ch) * g.k_all + k) * g.nb2 + nh * NBI + EPC * j;
    const void* s = ok ? static_cast<const void*>(src) : static_cast<const void*>(w);
    const uint32_t dst = dst0 + c * T::W_CH;
    if (real == 16) {
      cp_async<16>(dst, s, ok ? 16 : 0);
    } else if (real == 8) {
      cp_async<8>(dst, s, ok ? 8 : 0);
    } else if (real == 4) {
      cp_async<4>(dst, s, ok ? 4 : 0);
    }
  }
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values as a bf16 pair, each rounded to nearest (lo in the low half).
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// The three-term split of two f32 weights (see the note at the head): bf16
// pairs h, m, l with lo + 0 = h.lo + m.lo + l.lo exactly, and so for hi.
__device__ __forceinline__ void split3(float lo, float hi, uint32_t& h, uint32_t& m, uint32_t& l) {
  h = bf16x2(lo, hi);
  const float rlo = lo - __uint_as_float(h << 16), rhi = hi - __uint_as_float(h & 0xffff0000u);
  m = bf16x2(rlo, rhi);
  const float slo = rlo - __uint_as_float(m << 16), shi = rhi - __uint_as_float(m & 0xffff0000u);
  l = bf16x2(slo, shi);
}

// Byte C of `lo_k` and of `hi_k` (int8 samples of two consecutive k) as a
// bf16 pair, exactly: with p holding the two bytes, (p & 0x7f) | 0x4300 is
// 128 + (x & 127) and (p & 0x80) | 0x4300 is 128 or 256 (bit 7 set), and
// their difference is x.
template <int C>
__device__ __forceinline__ uint32_t pair_bf16(uint32_t lo_k, uint32_t hi_k) {
  const uint32_t p = __byte_perm(lo_k, hi_k, C | ((4 + C) << 8));
  const uint32_t mag = (p & 0x007f007fu) | 0x43004300u;
  const uint32_t off = (p & 0x00800080u) | 0x43004300u;
  uint32_t d;  // mag - off = off * -1 + mag, exact
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(off), "r"(0xbf80bf80u), "r"(mag));
  return d;
}

// The A fragment of channel C (byte C of the words) from the eight words of
// a 16 x 16 tile (index 2 ki + mi: k = 2 tig + {0, 1, 8, 9}, m = gid + 8 mi).
template <int C>
__device__ __forceinline__ void a_frag(const uint32_t (&wv)[8], uint32_t (&a)[4]) {
  a[0] = pair_bf16<C>(wv[0], wv[2]);
  a[1] = pair_bf16<C>(wv[1], wv[3]);
  a[2] = pair_bf16<C>(wv[4], wv[6]);
  a[3] = pair_bf16<C>(wv[5], wv[7]);
}

template <int NBI, typename WT>
using Acc = float[Tile<NBI, WT>::MTW][4][Tile<NBI, WT>::NT][4];

// Channel 4cw + C of a warp's K step, bf16 weights: its B fragments by
// ldmatrix.trans from the weight rows, its A fragments turned from the
// words, the MMAs chained in the accumulators.
template <int NBI, int C>
__device__ __forceinline__ void mma_channel(const uint32_t (&wv)[Tile<NBI, __nv_bfloat16>::MTW][8],
                                            uint32_t brow, int lq, int sw, int cw,
                                            Acc<NBI, __nv_bfloat16>& acc) {
  using T = Tile<NBI, __nv_bfloat16>;
  uint32_t b[T::NT][2];
  if constexpr (T::NT == 1) {
    ldsm_x2_trans(brow + (4 * cw + C) * T::W_CH, b[0][0], b[0][1]);
  } else {
#pragma unroll
    for (int u = 0; u < T::NT / 2; ++u) {
      ldsm_x4_trans(brow + (4 * cw + C) * T::W_CH + 16 * ((2 * u + lq) ^ sw), b[2 * u][0],
                    b[2 * u][1], b[2 * u + 1][0], b[2 * u + 1][1]);
    }
  }
#pragma unroll
  for (int t = 0; t < T::MTW; ++t) {
    uint32_t a[4];
    a_frag<C>(wv[t], a);
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt) mma_bf16(acc[t][C][nt], a, b[nt][0], b[nt][1]);
  }
}

// Channel 4cw + C of a warp's K step, f32 weights: its A fragments turned
// once, then for each n tile the lane's four f32 weights (rows 2 tig + {0,
// 1, 8, 9}, column gid) split into three bf16 B fragments, three MMAs
// chained from zero (l, m, then h) and their sum added to the accumulator.
template <int NBI, int C>
__device__ __forceinline__ void mma_channel_f32(const uint32_t (&wv)[Tile<NBI, float>::MTW][8],
                                                const float* wch, int gid, int tig,
                                                Acc<NBI, float>& acc) {
  using T = Tile<NBI, float>;
  uint32_t a[T::MTW][4];
#pragma unroll
  for (int t = 0; t < T::MTW; ++t) a_frag<C>(wv[t], a[t]);
  const int swt = 2 * (tig & f32_swizzle<T::CPR>());
  const float* r0 = wch + 2 * tig * NBI;
#pragma unroll
  for (int nt = 0; nt < T::NT; ++nt) {
    const int col = 4 * ((2 * nt + (gid >> 2)) ^ swt) + (gid & 3);
    uint32_t h0, m0, l0, h1, m1, l1;
    split3(r0[col], r0[NBI + col], h0, m0, l0);
    split3(r0[8 * NBI + col], r0[9 * NBI + col], h1, m1, l1);
#pragma unroll
    for (int t = 0; t < T::MTW; ++t) {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(d, a[t], l0, l1);
      mma_bf16(d, a[t], m0, m1);
      mma_bf16(d, a[t], h0, h1);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][C][nt][e] += d[e];
    }
  }
}

// One K step for a warp: its MTW m tiles of channels 4cw .. 4cw+3 against
// their weights. `words` is the stage's plane runs as words (run r, word w
// at 4 r + w); `wslot` the weights' shared address, `wgen` the same bytes
// as a generic pointer.
template <int NBI, typename WT>
__device__ __forceinline__ void mma_step(const uint32_t* words, uint32_t wslot, const uint32_t* wgen,
                                         int lane, int cw, int mh, Acc<NBI, WT>& acc) {
  using T = Tile<NBI, WT>;
  const int gid = lane / 4, tig = lane % 4;
  // Word cw of runs (k = 2 tig + {0, 1, 8, 9}, m = gid + 8 mi) of each m tile.
  uint32_t wv[T::MTW][8];
  const uint32_t* base = words + (2 * tig * T::MT + 16 * T::MTW * mh + gid) * 4 + cw;
#pragma unroll
  for (int t = 0; t < T::MTW; ++t) {
#pragma unroll
    for (int ki = 0; ki < 4; ++ki) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        wv[t][2 * ki + mi] = base[((ki & 1) + 8 * (ki >> 1)) * T::MT * 4 + (16 * t + 8 * mi) * 4];
      }
    }
  }
  if constexpr (T::F32) {
    const float* wch = reinterpret_cast<const float*>(wgen) + 4 * cw * (T::W_CH / 4);
    mma_channel_f32<NBI, 0>(wv, wch, gid, tig, acc);
    mma_channel_f32<NBI, 1>(wv, wch + T::W_CH / 4, gid, tig, acc);
    mma_channel_f32<NBI, 2>(wv, wch + 2 * (T::W_CH / 4), gid, tig, acc);
    mma_channel_f32<NBI, 3>(wv, wch + 3 * (T::W_CH / 4), gid, tig, acc);
  } else {
    // ldmatrix rows: lane supplies row lrow of n-tile chunk 2u + lq.
    const int q = lane / 8, lrow = 8 * (q & 1) + lane % 8, lq = q >> 1;
    const int sw = (lrow / (8 / T::NT)) % T::NT;
    const uint32_t brow = wslot + lrow * T::ROW;
    mma_channel<NBI, 0>(wv, brow, lq, sw, cw, acc);
    mma_channel<NBI, 1>(wv, brow, lq, sw, cw, acc);
    mma_channel<NBI, 2>(wv, brow, lq, sw, cw, acc);
    mma_channel<NBI, 3>(wv, brow, lq, sw, cw, acc);
  }
}

// The item's beams from the fragments, each row segment whole. A lane
// holds, per m tile, channel and row half hf, beams nt * 8 + 2 tig + e of
// row gid + 8 hf. Two shuffles in each quad give lane tig beams 4 tig ..
// 4 tig + 3 of each pair of n tiles, so one float4 store a lane writes 8
// rows x 64 bytes a warp instruction; with one n tile each lane stores its
// two beams (those below 2B) as a float2. Channels past C store nothing.
template <int NBI, typename WT>
__device__ __forceinline__ void store_item(float* __restrict__ out, const Geo& g, int cb, int nh,
                                           int mt, int lane, int cw, int mh,
                                           const Acc<NBI, WT>& acc) {
  using T = Tile<NBI, WT>;
  const int gid = lane / 4, tig = lane % 4;
  const int s1 = 4 * gid + ((tig >> 1) | ((tig & 1) << 1));
  const bool odd = tig & 1, lo = tig < 2;
#pragma unroll
  for (int t = 0; t < T::MTW; ++t) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int ch = cb * RCT + 4 * cw + c;
      if (ch >= g.n_ch) continue;  // the same for the whole warp
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int m = mt * T::MT + 16 * (T::MTW * mh + t) + gid + 8 * hf;
        float* row = out + (static_cast<long long>(ch / g.pack) * g.ps + m) * 128 +
                     (ch % g.pack) * g.nb2 + nh * NBI;
        if constexpr (T::NT == 1) {
          if (2 * tig < g.nb2) {
            *reinterpret_cast<float2*>(row + 2 * tig) =
                make_float2(acc[t][c][0][2 * hf], acc[t][c][0][2 * hf + 1]);
          }
        } else {
#pragma unroll
          for (int u = 0; u < T::NT / 2; ++u) {
            const float* v0 = acc[t][c][2 * u] + 2 * hf;
            const float* v1 = acc[t][c][2 * u + 1] + 2 * hf;
            const float a0 = odd ? v1[0] : v0[0], a1 = odd ? v1[1] : v0[1];
            const float b0 = odd ? v0[0] : v1[0], b1 = odd ? v0[1] : v1[1];
            const float r10 = __shfl_sync(~0u, a0, s1), r11 = __shfl_sync(~0u, a1, s1);
            const float r20 = __shfl_sync(~0u, b0, s1 ^ 1), r21 = __shfl_sync(~0u, b1, s1 ^ 1);
            const float4 v =
                lo ? make_float4(r10, r11, r20, r21) : make_float4(r20, r21, r10, r11);
            *reinterpret_cast<float4*>(row + 4 * tig + 16 * u) = v;
          }
        }
      }
    }
  }
}

// K2's stage stops: a compile-time mask of the ring body's three stages.
// K2 is K2_ALL, the code below unchanged; each stop keeps only some stages,
// and phase 6 of chip_smoke.py times each against K2 at the flagship to
// split its time. Without K2_COPY the MMAs read a zeroed ring (the K loop
// keeps its waits and barriers); without K2_MMA the stores write the zero
// sums; without K2_STORE the sums reach one store under a bit pattern no
// MMA writes (the all-ones NaN), so the MMAs stay and nothing is written.
constexpr int K2_COPY = 1, K2_MMA = 2, K2_STORE = 4, K2_ALL = 7;

template <int NBI, typename WT, int STAGES>
__global__ void __launch_bounds__(THREADS, 1)
    bstage_ring_kernel(const int8_t* __restrict__ qr, const int8_t* __restrict__ qi,
                       const WT* __restrict__ w, float* __restrict__ out, Geo g) {
  using T = Tile<NBI, WT>;
  extern __shared__ __align__(128) uint32_t ring[];  // [D][P_STAGE], then the weights
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cw = warp % 4, mh = warp / 4;
  const int mine = g.resident ? (g.n_cu - static_cast<int>(blockIdx.x) + gridDim.x - 1) /
                                    gridDim.x * g.n_mt
                              : (g.n_cu * g.n_mt - static_cast<int>(blockIdx.x) + gridDim.x - 1) /
                                    gridDim.x;
  const uint32_t ring0 = smem_u32(ring), wts0 = ring0 + D * T::P_STAGE;
  const uint32_t* wts = ring + D * T::P_STAGE / 4;
  const int w_slots = g.resident ? g.n_ks : D;
  if constexpr (!(STAGES & K2_COPY)) {  // the first K step's barrier orders it
    const int n = (D * T::P_STAGE + w_slots * T::W_STAGE) / 4;
    for (int i = threadIdx.x; i < n; i += THREADS) ring[i] = 0;
  } else if constexpr (NBI == 8) {  // zero padding columns where 2B < 8, before any copy
    if (g.nb2 < 8) {
      for (int i = threadIdx.x; i < w_slots * T::W_STAGE / 4; i += THREADS) {
        ring[D * T::P_STAGE / 4 + i] = 0;
      }
    }
    __syncthreads();
  }

  // The copy cursor runs D - 1 K steps ahead of the MMAs, across items: K
  // step x of this block goes to stage x % D, one commit group a K step
  // (empty past the end). Resident weights are copied with the first m tile
  // of their unit, into slot ks.
  int cp_j = 0, cp_ks = 0, cp_x = 0;
  auto issue = [&]() {
    if ((STAGES & K2_COPY) && cp_j < mine) {
      int cu, mt;
      item_of(cp_j, g, cu, mt);
      const int cb = cu / g.n_nh, nh = cu % g.n_nh, k0 = cp_ks * KS;
      copy_planes<NBI, WT>(ring0 + (cp_x % D) * T::P_STAGE, qr, qi, g, cb, mt, k0);
      if (!g.resident) {
        copy_weights<NBI, WT>(wts0 + (cp_x % D) * T::W_STAGE, w, g, cb, nh, k0);
      } else if (mt == 0) {
        copy_weights<NBI, WT>(wts0 + cp_ks * T::W_STAGE, w, g, cb, nh, k0);
      }
      if (++cp_ks == g.n_ks) {
        cp_ks = 0;
        ++cp_j;
      }
    }
    cp_async_commit();
    ++cp_x;
  };
  for (int k = 0; k < D - 1; ++k) issue();
  int x = 0;
  for (int j = 0; j < mine; ++j) {
    int cu, mt;
    item_of(j, g, cu, mt);
    Acc<NBI, WT> acc = {};
    for (int ks = 0; ks < g.n_ks; ++ks, ++x) {
      cp_async_wait<D - 2>();  // this thread's copies of this K step have landed
      __syncthreads();         // everyone's; and the stage of K step x - 1 is free
      issue();
      if constexpr (STAGES & K2_MMA) {
        const int slot = g.resident ? ks : x % D;
        mma_step<NBI, WT>(ring + (x % D) * (T::P_STAGE / 4), wts0 + slot * T::W_STAGE,
                          wts + slot * (T::W_STAGE / 4), lane, cw, mh, acc);
      }
    }
    if constexpr (STAGES & K2_STORE) {
      store_item<NBI, WT>(out, g, cu / g.n_nh, cu % g.n_nh, mt, lane, cw, mh, acc);
    } else if constexpr (STAGES & K2_MMA) {
      bool hit = false;
#pragma unroll
      for (int t = 0; t < T::MTW; ++t)
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
            for (int f = 0; f < 4; ++f) hit |= __float_as_uint(acc[t][c][nt][f]) == ~0u;
      if (hit) out[0] = 0.0f;
    }
  }
  cp_async_wait<0>();  // no copy outlives the block (those past the end are empty)
}

bool aligned(const void* p, uintptr_t to) { return reinterpret_cast<uintptr_t>(p) % to == 0; }

// The geometry of a ring launch, or false for a shape it does not take:
// 2B dividing 128 (its item columns NBI), P*S % MT == 0, C % pack == 0.
// Planes at 16-byte aligned bases with C % 16 == 0 take the wide copies
// (null bases count as aligned: the attributes' query).
template <int NBI, typename WT>
bool ring_geometry(int n_ants, int ps, int n_ch, int nb2, const void* qr, const void* qi, Geo& g) {
  using T = Tile<NBI, WT>;
  if (n_ants <= 0 || ps <= 0 || n_ch <= 0 || nb2 <= 0 || 128 % nb2 || item_cols(nb2) != NBI ||
      ps % T::MT || n_ch % (128 / nb2)) {
    return false;
  }
  const int k_all = 2 * n_ants, n_ks = (k_all + KS - 1) / KS;
  const int n_nh = nb2 > NBI ? nb2 / NBI : 1, n_cb = (n_ch + RCT - 1) / RCT;
  const long long n_items = static_cast<long long>(ps / T::MT) * n_cb * n_nh;
  if (n_items > (1LL << 30)) return false;
  // Resident weights need D K steps an item (the next unit's first D - 1
  // slots are refilled while this one's last are read) and must fit.
  const bool resident =
      n_ks >= D && D * T::P_STAGE + static_cast<long long>(n_ks) * T::W_STAGE <= SMEM_MAX;
  const bool wide = n_ch % RCT == 0 && aligned(qr, 16) && aligned(qi, 16);
  g = Geo{n_ants, k_all, ps, n_ch, nb2, 128 / nb2, n_ks, ps / T::MT, n_nh, n_cb * n_nh,
          resident ? 1 : 0, wide ? 1 : 0};
  return true;
}

template <int NBI, typename WT>
int ring_smem(const Geo& g) {
  using T = Tile<NBI, WT>;
  return D * T::P_STAGE + (g.resident ? g.n_ks : D) * T::W_STAGE;
}

template <int NBI, typename WT, int STAGES>
cudaError_t ring_grid(const Geo& g, int& grid) {
  const int smem = ring_smem<NBI, WT>(g);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(bstage_ring_kernel<NBI, WT, STAGES>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bstage_ring_kernel<NBI, WT, STAGES>, THREADS, smem);
  }
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int work = g.resident ? g.n_cu : g.n_cu * g.n_mt;
  grid = work < sms * per_sm ? work : sms * per_sm;
  return cudaSuccess;
}

// The ring body (STAGES = K2_ALL) or one of its stops: refuses a shape or
// a weight or output base it does not take with cudaErrorInvalidValue,
// before any launch.
template <int NBI, typename WT, int STAGES>
int ring_launch(const void* qr, const void* qi, const void* w, void* out, int n_ants, int ps,
                int n_ch, int nb2, cudaStream_t stream) {
  Geo g;
  if (!ring_geometry<NBI, WT>(n_ants, ps, n_ch, nb2, qr, qi, g) || !aligned(w, 16) ||
      !aligned(out, 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int grid = 0;
  cudaError_t err = ring_grid<NBI, WT, STAGES>(g, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  bstage_ring_kernel<NBI, WT, STAGES><<<grid, THREADS, ring_smem<NBI, WT>(g), stream>>>(
      static_cast<const int8_t*>(qr), static_cast<const int8_t*>(qi), static_cast<const WT*>(w),
      static_cast<float*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

template <typename WT, int STAGES>
int ring_dispatch(int nb2, const void* qr, const void* qi, const void* w, void* out, int n_ants,
                  int ps, int n_ch, cudaStream_t st) {
  switch (item_cols(nb2)) {
    case 8: return ring_launch<8, WT, STAGES>(qr, qi, w, out, n_ants, ps, n_ch, nb2, st);
    case 16: return ring_launch<16, WT, STAGES>(qr, qi, w, out, n_ants, ps, n_ch, nb2, st);
    case 32: return ring_launch<32, WT, STAGES>(qr, qi, w, out, n_ants, ps, n_ch, nb2, st);
    case 64: return ring_launch<64, WT, STAGES>(qr, qi, w, out, n_ants, ps, n_ch, nb2, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int STAGES>
int dispatch(int w_bf16, int nb2, const void* qr, const void* qi, const void* w, void* out,
             int n_ants, int ps, int n_ch, cudaStream_t st) {
  return w_bf16 ? ring_dispatch<__nv_bfloat16, STAGES>(nb2, qr, qi, w, out, n_ants, ps, n_ch, st)
                : ring_dispatch<float, STAGES>(nb2, qr, qi, w, out, n_ants, ps, n_ch, st);
}

#ifndef K2_STAGE_STOPS
template <int NBI, typename WT>
int ring_attributes(int n_ants, int ps, int n_ch, int nb2, int* info) {
  Geo g;
  if (!ring_geometry<NBI, WT>(n_ants, ps, n_ch, nb2, nullptr, nullptr, g)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaFuncAttributes at{};
  cudaError_t err = cudaFuncGetAttributes(&at, bstage_ring_kernel<NBI, WT, K2_ALL>);
  int grid = 0;
  if (err == cudaSuccess) err = ring_grid<NBI, WT, K2_ALL>(g, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = at.numRegs;
  info[1] = static_cast<int>(at.localSizeBytes);
  info[2] = grid;
  info[3] = RCT;
  info[4] = Tile<NBI, WT>::MT;
  info[5] = KS;
  info[6] = g.resident;
  info[7] = ring_smem<NBI, WT>(g);
  info[8] = NBI;
  info[9] = g.wide;
  return 0;
}

template <typename WT>
int attributes_of(int n_ants, int ps, int n_ch, int nb2, int* info) {
  switch (item_cols(nb2)) {
    case 8: return ring_attributes<8, WT>(n_ants, ps, n_ch, nb2, info);
    case 16: return ring_attributes<16, WT>(n_ants, ps, n_ch, nb2, info);
    case 32: return ring_attributes<32, WT>(n_ants, ps, n_ch, nb2, info);
    case 64: return ring_attributes<64, WT>(n_ants, ps, n_ch, nb2, info);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
#endif

}  // namespace

#ifndef K2_STAGE_STOPS
// K2: planes qr, qi [A, P*S, C] int8, weights w [C, 2A, 2B] (bf16 if w_bf16,
// else f32) -> out [C/pack, P*S, 128] f32, on the ring body for every 2B in
// {2, 4, 8, 16, 32, 64, 128}: P*S % 64 == 0 (32 where 2B >= 64), C % pack
// == 0, weights and output 16-byte aligned; planes at any base.
extern "C" int bstage_fused_launch(const void* qr, const void* qi, const void* w,
                                   int w_bf16, void* out, int n_ants, int ps,
                                   int n_ch, int nb2, void* stream) {
  return dispatch<K2_ALL>(w_bf16, nb2, qr, qi, w, out, n_ants, ps, n_ch,
                          static_cast<cudaStream_t>(stream));
}

// The ring body for a shape and weight type: info[0..9] = registers, local
// (spill) bytes, blocks of its persistent grid, channels and m rows a work
// item, K-step rows, weights resident (1) or staged (0), dynamic shared
// memory bytes, columns a work item, wide plane copies (1, for aligned
// bases) or byte loads (0).
extern "C" int bstage_fused_attributes(int n_ants, int ps, int n_ch, int nb2, int w_bf16,
                                       int* info) {
  return w_bf16 ? attributes_of<__nv_bfloat16>(n_ants, ps, n_ch, nb2, info)
                : attributes_of<float>(n_ants, ps, n_ch, nb2, info);
}
#else
// One of K2's stage stops, `stages` a mask of K2_COPY (1), K2_MMA (2) and
// K2_STORE (4) other than K2_ALL: as bstage_fused_launch, into out as the
// stop leaves it (see K2_ALL).
extern "C" int bstage_fused_stop_launch(const void* qr, const void* qi, const void* w, int w_bf16,
                                        void* out, int n_ants, int ps, int n_ch, int nb2,
                                        int stages, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (stages) {
    case K2_COPY:
      return dispatch<K2_COPY>(w_bf16, nb2, qr, qi, w, out, n_ants, ps, n_ch, st);
    case K2_MMA:
      return dispatch<K2_MMA>(w_bf16, nb2, qr, qi, w, out, n_ants, ps, n_ch, st);
    case K2_STORE:
      return dispatch<K2_STORE>(w_bf16, nb2, qr, qi, w, out, n_ants, ps, n_ch, st);
    case K2_COPY | K2_MMA:
      return dispatch<K2_COPY | K2_MMA>(w_bf16, nb2, qr, qi, w, out, n_ants, ps, n_ch, st);
    case K2_MMA | K2_STORE:
      return dispatch<K2_MMA | K2_STORE>(w_bf16, nb2, qr, qi, w, out, n_ants, ps, n_ch, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
#endif
