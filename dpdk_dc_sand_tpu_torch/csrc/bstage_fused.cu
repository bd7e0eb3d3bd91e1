// K2: fused B-stage for Hopper (sm_90a) — corner turn + multi-beam dot.
//
// Replaces the TPU kernel dpdk_dc_sand_tpu/ops/bstage_pallas.py:_kernel
// (reached from beamform_turned_fused through pl.pallas_call). It computes
//   out[c/pack, p*S+s, (c%pack)*2B + n] =
//       sum_a qr[a,p,s,c]*W[c,a,n] + qi[a,p,s,c]*W[c,A+a,n]
// with int8 samples converted exactly (to bf16 or f32), W in bf16 or f32,
// and f32 accumulation (a product of an int8 and a bf16 value is exact in
// f32). The packed [C/pack, P*S, pack*2B] output (pack = 128/2B) is the
// egress layout and is kept; the TPU's block-diagonal 4-channel fold only
// filled MXU lanes and is not ported.
//
// Two bodies. bstage_ring_kernel (bf16 weights, 2B in {16, 32, 64}: every
// engine launch) runs each channel's [m x 2A] @ [2A x 2B] product on the
// tensor cores; bstage_kernel (f32 weights, or 2B = 8) is SIMT (below).
//
// What bounds K2 on this card: bytes. At the flagship (A = 80, P*S = 512,
// C = 32768, 2B = 32) it must read 2.684 GB of int8 planes and 0.336 GB of
// bf16 weights and write 2.147 GB of f32 beams: 1.543 ms at 3.35 TB/s. Its
// 0.172 TFLOP of bf16 products would take 0.17 ms at the tensor cores' peak,
// so feeding the MMAs, not the MMAs, sets its pace.
//
// Geometry of the ring body. A work item is (channel block of 16 channels,
// m tile of MT rows); each K step stages 16 contraction rows (one mma
// depth) in a ring of D = 3 stages. Accumulators bound the item at
// 16 * MT * 2B <= 32K f32 sums, 128 a thread of 256:
//   2B = 16: MT 64     2B = 32: MT 64     2B = 64: MT 32
// Weights are held whole in shared memory when an item has at least D K
// steps and they fit beside the ring: at the flagship 160 KB (16 channels x
// 160 rows x 32 beams x 2 bytes) + 48 KB of ring = 208 KB a block, one
// block on each SM; otherwise (2B = 64 at A = 80, or 2A <= 32) each stage
// also carries its K step's weight rows. From L2 to the SMs that is, at the
// flagship: the plane rows as 16-byte runs, each half a 32-byte sector
// (5.369 GB of sectors for 2.684 GB of samples), and the weights once
// (0.336 GB): 5.704 GB. Against 32 channels a block: the runs would be
// whole sectors (2.684 GB), but the accumulators would cut MT to 32 and the
// 320 KB of a block's weights would not fit, so they would be staged for
// each of 16 m tiles (5.369 GB): 8.05 GB. 16 channels it is; a warp's 4
// channels then fill whole packed rows (512 bytes at 2B = 32).
//
// Design.
//   Persistent blocks: one 256-thread block on each SM. With resident
//   weights a block walks channel blocks blockIdx.x, + gridDim.x, ..., each
//   with its m tiles in order, and copies a channel block's weights with its
//   first m tile; staged, it walks the (channel block, m tile) items m tiles
//   fastest. Either way the blocks in flight together hold neighbouring
//   channel blocks, so each plane sector comes from HBM once and serves its
//   two halves from L2.
//   A ring of rows: each K step's plane rows (16-byte runs of
//   [k, m, c0:c0+16] of qr and qi, 16 x MT of them) reach the block by
//   16-byte cp.async.cg with an L2 prefetch of the 128-byte line (its
//   other runs belong to the blocks of neighbouring channels), and staged
//   weight rows ([c][k0:k0+16][2B] bf16) through the same stages. The ring
//   runs D - 1 = 2 K steps ahead across the end of a work item, so the next
//   item's first copies are in flight during this item's last MMAs and its
//   stores. The planes stay int8 in shared memory, a run a 16-byte slot
//   (conflict-free copies); the weight rows' 16-byte chunks sit at
//   j ^ ((row / (8 / NT)) % NT), so that ldmatrix reads 8 rows from 8
//   distinct bank groups and the copies stay conflict-free.
//   The turn in registers: warp (word cw, m half) owns channels 4cw .. 4cw+3
//   of the block and MT/2 rows of m. Eight words of a 16 x 16 A tile give
//   its A fragments for all 4 channels: for each channel a byte permute and
//   two LOP3s build 128 + (x & 127) and 128 or 256 as bf16 pairs, and one
//   bf16x2 FMA subtracts them: x exactly. All 32 lanes read the same word
//   of their runs, so those loads meet 4-way bank conflicts (8 banks hold
//   that word of any run); a conflict-free placement needs 4-byte copies
//   (below). B fragments come from the weight rows by ldmatrix.trans;
//   mma.sync m16n8k16 bf16 with f32 sums chains the K steps as the old
//   body's WMMA did.
//   Whole row segments out: two shuffles in each quad give a lane 4
//   consecutive beams of one channel, so one float4 store a lane writes
//   8 rows x 64 bytes of packed rows a warp instruction (whole sectors).
//
// What sets its pace (stage stops, phase 6 of chip_smoke.py, and
// development calls on an H100, 700 W): the copies alone take about 1.4 ms
// and the stores alone about as long as a fill of the output (0.69 ms); a
// stop with both but no MMAs takes about their sum, and the MMAs hide
// behind them. So the copies and the stores do not overlap each other:
// what they share, L2 and its path to the SMs, is the limit, and the half
// sectors of the plane runs are the largest avoidable share of its bytes.
//
// Tried and gone (development calls on an H100, 700 W; full body at the
// flagship): 4-byte cp.async.ca of the runs with a word-level XOR swizzle,
// conflict-free fragment loads: 4.5 ms with the resident weights (208-224
// KB of shared memory leaves L1 28 KB, and .ca copies allocate there),
// 3.1-3.2 ms with staged weights; 16-byte copies with staged weights, 3.1
// to 3.6 ms; 32-row K steps in 2 stages, 2.84 ms, against 16-row steps in 3
// or 4 stages, 2.70 (3 kept), and 2 stages of 16 rows, 2.98; the stage's
// copies split between its MMA slices, no change; streaming (.cs) stores,
// no change. The L2 prefetch took 2.70 to 2.53 ms. Reading conflict-free
// (wrong) positions in place of the conflicted words ran 2.47 ms: the
// conflicts cost about 0.06 ms of the whole.
//
// The old tensor-core body (WMMA, one block per 32 channels x 32 rows of m,
// 147 KB of shared memory, a serial load -> turn -> MMA K loop with no copy
// in flight, every plane byte turned by a scalar bf16 store, weights read
// again for every m tile, 64-byte tile stores) ran 7.428 ms at the
// flagship on an H100 and is gone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CT = 32;  // channels per block (one per lane)
constexpr int KT = 16;  // contraction rows (2A axis) per K step
constexpr int MG = THREADS / CT;  // m groups per block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// ---- SIMT body (f32 weights, or 2B = 8) ----
// One block per (32-channel tile, MT-row tile of m = p*S+s). The corner
// turn happens in shared memory: each K step stages a [KT][MT][32] int8
// slab of the (re, im) planes — 32 contiguous channel bytes per (antenna,
// m) row — and the matching [32][KT][2B] weight slab as f32. Thread
// (channel c, m group) keeps an MPT x 2B register tile (MPT = 64/2B) and
// walks the 2A contraction.
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

// ---- ring body (bf16 weights, 2B in {16, 32, 64}) ----

constexpr int RCT = 16;     // channels a work item: one 16-byte run of each plane row
constexpr int KS = 16;      // contraction rows a K step: one mma depth
constexpr int D = 3;        // stages (K steps) in the ring
constexpr int SMEM_MAX = 232448;

// The compile-time geometry for 2B = NB2 (see the note at the head).
template <int NB2>
struct Tile {
  static constexpr int NT = NB2 / 8;                 // 8-wide n tiles = 16-byte chunks of a weight row
  static constexpr int MT = NB2 == 64 ? 32 : 64;     // m rows a work item
  static constexpr int MTW = MT / 32;                // 16-row m tiles a warp
  static constexpr int RPL = 8 / NT;                 // weight rows a 128-byte line
  static constexpr int P_STAGE = KS * MT * RCT;      // plane bytes a K step
  static constexpr int W_CH = KS * NB2 * 2;          // weight bytes of a channel a K step
  static constexpr int W_STAGE = RCT * W_CH;
  static constexpr int PACK = 128 / NB2;
  static constexpr int P_ROUNDS = KS * MT / THREADS;       // 16-byte plane runs a thread a K step
  static constexpr int W_PER_CH = KS * NT;                 // 16-byte chunks of a channel a K step
  static constexpr int W_ROUNDS = W_STAGE / 16 / THREADS;  // 16-byte weight chunks a thread a K step
  static_assert(NT % 2 == 0 && P_ROUNDS >= 1 && THREADS % W_PER_CH == 0, "tiles");
  static_assert(RCT * MT * NB2 / THREADS <= 128, "at most 128 sums a thread");
};

struct Geo {
  int n_ants, k_all, ps, n_ch;
  int n_ks, n_mt, n_cb;
  int resident;  // weights held whole in shared memory (a slot a K step), else staged a stage
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

// Work item j of this block: resident weights walk channel blocks
// blockIdx.x, + gridDim.x, ..., each with all its m tiles in order; staged
// weights walk items blockIdx.x, + gridDim.x, ... of the (channel block,
// m tile) list, m tiles fastest. Either way the blocks in flight together
// hold neighbouring channel blocks, which share their plane rows' sectors.
__device__ __forceinline__ void item_of(int j, const Geo& g, int& cb, int& mt) {
  if (g.resident) {
    cb = blockIdx.x + gridDim.x * (j / g.n_mt);
    mt = j % g.n_mt;
  } else {
    const int i = blockIdx.x + j * gridDim.x;
    cb = i / g.n_mt;
    mt = i % g.n_mt;
  }
}

// The plane rows of a K step, [KS][MT] runs of 16 channel bytes: thread t
// copies runs t, t + THREADS, ... (row kk = run / MT, m = run % MT), each
// by one 16-byte cp.async.cg into slot `run` of the stage; rows past 2A
// are zero-filled.
template <int NB2>
__device__ __forceinline__ void copy_planes(uint32_t stage, const int8_t* __restrict__ qr,
                                            const int8_t* __restrict__ qi, const Geo& g, int cb,
                                            int mt, int k0) {
  using T = Tile<NB2>;
  const long long psc = static_cast<long long>(g.ps) * g.n_ch;
#pragma unroll
  for (int j = 0; j < T::P_ROUNDS; ++j) {
    const int run = threadIdx.x + j * THREADS, kk = run / T::MT, m = run % T::MT, k = k0 + kk;
    const bool ok = k < g.k_all;
    const long long off = static_cast<long long>(mt * T::MT + m) * g.n_ch + cb * RCT;
    const int8_t* src = k < g.n_ants ? qr + k * psc + off : qi + (k - g.n_ants) * psc + off;
    asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(stage + 16 * run),
                 "l"(ok ? src : qr), "r"(ok ? 16 : 0)
                 : "memory");
  }
}

// The weight rows of a K step, [16 channels][KS][2B] bf16: thread t copies
// 16-byte chunk j of row kk of channels t / W_PER_CH + (THREADS / W_PER_CH) r,
// placed at chunk j ^ ((kk / RPL) % NT) of its row; rows past 2A are
// zero-filled.
template <int NB2>
__device__ __forceinline__ void copy_weights(uint32_t slot, const __nv_bfloat16* __restrict__ w,
                                             const Geo& g, int cb, int k0) {
  using T = Tile<NB2>;
  const int t = threadIdx.x, q = t % T::W_PER_CH, kk = q / T::NT, j = q % T::NT;
  const int k = k0 + kk;
  const bool ok = k < g.k_all;
  const uint32_t dst0 = slot + kk * (NB2 * 2) + 16 * (j ^ ((kk / T::RPL) % T::NT));
#pragma unroll
  for (int r = 0; r < T::W_ROUNDS; ++r) {
    const int c = r * (THREADS / T::W_PER_CH) + t / T::W_PER_CH;
    const __nv_bfloat16* src =
        w + (static_cast<long long>(cb * RCT + c) * g.k_all + k) * NB2 + 8 * j;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst0 + c * T::W_CH),
                 "l"(ok ? src : w), "r"(ok ? 16 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// Channel 4cw + C of a warp's K step: its B fragments by ldmatrix.trans
// from the weight rows, its A fragments turned from the words, the MMAs.
template <int NB2, int C>
__device__ __forceinline__ void mma_channel(const uint32_t (&wv)[Tile<NB2>::MTW][8], uint32_t brow,
                                            int lq, int sw, int cw,
                                            float (&acc)[Tile<NB2>::MTW][4][Tile<NB2>::NT][4]) {
  using T = Tile<NB2>;
  uint32_t b[T::NT][2];
#pragma unroll
  for (int u = 0; u < T::NT / 2; ++u) {
    ldsm_x4_trans(brow + (4 * cw + C) * T::W_CH + 16 * ((2 * u + lq) ^ sw), b[2 * u][0],
                  b[2 * u][1], b[2 * u + 1][0], b[2 * u + 1][1]);
  }
#pragma unroll
  for (int t = 0; t < T::MTW; ++t) {
    uint32_t a[4];
    a_frag<C>(wv[t], a);
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt) mma_bf16(acc[t][C][nt], a, b[nt][0], b[nt][1]);
  }
}

// One K step for a warp: its MTW m tiles of channels 4cw .. 4cw+3 against
// their weights. `words` is the stage's plane runs as words (run r, word w
// at 4 r + w), `wslot` the weights' shared address.
template <int NB2>
__device__ __forceinline__ void mma_step(const uint32_t* words, uint32_t wslot, int lane, int cw,
                                         int mh, float (&acc)[Tile<NB2>::MTW][4][Tile<NB2>::NT][4]) {
  using T = Tile<NB2>;
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
  // ldmatrix rows: lane supplies row lrow of n-tile chunk 2u + lq.
  const int q = lane / 8, lrow = 8 * (q & 1) + lane % 8, lq = q >> 1;
  const int sw = (lrow / T::RPL) % T::NT;
  const uint32_t brow = wslot + lrow * (NB2 * 2);
  mma_channel<NB2, 0>(wv, brow, lq, sw, cw, acc);
  mma_channel<NB2, 1>(wv, brow, lq, sw, cw, acc);
  mma_channel<NB2, 2>(wv, brow, lq, sw, cw, acc);
  mma_channel<NB2, 3>(wv, brow, lq, sw, cw, acc);
}

// The item's beams from the fragments, each row segment whole. A lane
// holds, per m tile, channel and row half hf, beams nt * 8 + 2 tig + e of
// row gid + 8 hf. Two shuffles in each quad give lane tig beams 4 tig ..
// 4 tig + 3 of each pair of n tiles, so one float4 store a lane writes 8
// rows x 64 bytes a warp instruction.
template <int NB2>
__device__ __forceinline__ void store_item(float* __restrict__ out, const Geo& g, int cb, int mt,
                                           int lane, int cw, int mh,
                                           const float (&acc)[Tile<NB2>::MTW][4][Tile<NB2>::NT][4]) {
  using T = Tile<NB2>;
  const int gid = lane / 4, tig = lane % 4;
  const int s1 = 4 * gid + ((tig >> 1) | ((tig & 1) << 1));
  const bool odd = tig & 1, lo = tig < 2;
#pragma unroll
  for (int t = 0; t < T::MTW; ++t) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int ch = cb * RCT + 4 * cw + c;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int m = mt * T::MT + 16 * (T::MTW * mh + t) + gid + 8 * hf;
        float* row = out + (static_cast<long long>(ch / T::PACK) * g.ps + m) * 128 +
                     (ch % T::PACK) * NB2 + 4 * tig;
#pragma unroll
        for (int u = 0; u < T::NT / 2; ++u) {
          const float* v0 = acc[t][c][2 * u] + 2 * hf;
          const float* v1 = acc[t][c][2 * u + 1] + 2 * hf;
          const float a0 = odd ? v1[0] : v0[0], a1 = odd ? v1[1] : v0[1];
          const float b0 = odd ? v0[0] : v1[0], b1 = odd ? v0[1] : v1[1];
          const float r10 = __shfl_sync(~0u, a0, s1), r11 = __shfl_sync(~0u, a1, s1);
          const float r20 = __shfl_sync(~0u, b0, s1 ^ 1), r21 = __shfl_sync(~0u, b1, s1 ^ 1);
          const float4 v = lo ? make_float4(r10, r11, r20, r21) : make_float4(r20, r21, r10, r11);
          *reinterpret_cast<float4*>(row + 16 * u) = v;
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

template <int NB2, int STAGES>
__global__ void __launch_bounds__(THREADS, 1)
    bstage_ring_kernel(const int8_t* __restrict__ qr, const int8_t* __restrict__ qi,
                       const __nv_bfloat16* __restrict__ w, float* __restrict__ out, Geo g) {
  using T = Tile<NB2>;
  extern __shared__ __align__(128) uint32_t ring[];  // [D][P_STAGE], then the weights
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cw = warp % 4, mh = warp / 4;
  const int mine = g.resident ? (g.n_cb - static_cast<int>(blockIdx.x) + gridDim.x - 1) /
                                    gridDim.x * g.n_mt
                              : (g.n_cb * g.n_mt - static_cast<int>(blockIdx.x) + gridDim.x - 1) /
                                    gridDim.x;
  const uint32_t ring0 = smem_u32(ring), wts0 = ring0 + D * T::P_STAGE;
  if constexpr (!(STAGES & K2_COPY)) {  // the first K step's barrier orders it
    const int n = (D * T::P_STAGE + (g.resident ? g.n_ks : D) * T::W_STAGE) / 4;
    for (int i = threadIdx.x; i < n; i += THREADS) ring[i] = 0;
  }

  // The copy cursor runs D - 1 K steps ahead of the MMAs, across items: K
  // step x of this block goes to stage x % D, one commit group a K step
  // (empty past the end). Resident weights are copied with the first m tile
  // of their channel block, into slot ks.
  int cp_j = 0, cp_ks = 0, cp_x = 0;
  auto issue = [&]() {
    if ((STAGES & K2_COPY) && cp_j < mine) {
      int cb, mt;
      item_of(cp_j, g, cb, mt);
      const int k0 = cp_ks * KS;
      copy_planes<NB2>(ring0 + (cp_x % D) * T::P_STAGE, qr, qi, g, cb, mt, k0);
      if (!g.resident) {
        copy_weights<NB2>(wts0 + (cp_x % D) * T::W_STAGE, w, g, cb, k0);
      } else if (mt == 0) {
        copy_weights<NB2>(wts0 + cp_ks * T::W_STAGE, w, g, cb, k0);
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
    int cb, mt;
    item_of(j, g, cb, mt);
    float acc[T::MTW][4][T::NT][4] = {};
    for (int ks = 0; ks < g.n_ks; ++ks, ++x) {
      cp_async_wait<D - 2>();  // this thread's copies of this K step have landed
      __syncthreads();         // everyone's; and the stage of K step x - 1 is free
      issue();
      if constexpr (STAGES & K2_MMA) {
        mma_step<NB2>(ring + (x % D) * (T::P_STAGE / 4),
                      wts0 + (g.resident ? ks : x % D) * T::W_STAGE, lane, cw, mh, acc);
      }
    }
    if constexpr (STAGES & K2_STORE) {
      store_item<NB2>(out, g, cb, mt, lane, cw, mh, acc);
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

// The geometry of a ring launch, or false for a shape it does not take.
template <int NB2>
bool ring_geometry(int n_ants, int ps, int n_ch, Geo& g) {
  using T = Tile<NB2>;
  if (n_ants <= 0 || ps <= 0 || n_ch <= 0 || ps % T::MT || n_ch % RCT) return false;
  const int k_all = 2 * n_ants, n_ks = (k_all + KS - 1) / KS;
  const long long n_items = static_cast<long long>(ps / T::MT) * (n_ch / RCT);
  if (n_items > (1LL << 30)) return false;
  // Resident weights need D K steps an item (the next channel block's first
  // D - 1 slots are refilled while this one's last are read) and must fit.
  const bool resident =
      n_ks >= D && D * T::P_STAGE + static_cast<long long>(n_ks) * T::W_STAGE <= SMEM_MAX;
  g = Geo{n_ants, k_all, ps, n_ch, n_ks, ps / T::MT, n_ch / RCT, resident ? 1 : 0};
  return true;
}

template <int NB2>
int ring_smem(const Geo& g) {
  using T = Tile<NB2>;
  return D * T::P_STAGE + (g.resident ? g.n_ks : D) * T::W_STAGE;
}

template <int NB2, int STAGES>
cudaError_t ring_grid(const Geo& g, int& grid) {
  const int smem = ring_smem<NB2>(g);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(bstage_ring_kernel<NB2, STAGES>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bstage_ring_kernel<NB2, STAGES>,
                                                        THREADS, smem);
  }
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int work = g.resident ? g.n_cb : g.n_cb * g.n_mt;
  grid = work < sms * per_sm ? work : sms * per_sm;
  return cudaSuccess;
}

// The ring body (STAGES = K2_ALL) or one of its stops: refuses a shape or
// base it does not take with cudaErrorInvalidValue, before any launch.
template <int NB2, int STAGES>
int ring_launch(const void* qr, const void* qi, const void* w, void* out, int n_ants, int ps,
                int n_ch, cudaStream_t stream) {
  Geo g;
  if (!ring_geometry<NB2>(n_ants, ps, n_ch, g) || !aligned(qr, 4) || !aligned(qi, 4) ||
      !aligned(w, 16) || !aligned(out, 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int grid = 0;
  cudaError_t err = ring_grid<NB2, STAGES>(g, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  bstage_ring_kernel<NB2, STAGES><<<grid, THREADS, ring_smem<NB2>(g), stream>>>(
      static_cast<const int8_t*>(qr), static_cast<const int8_t*>(qi),
      static_cast<const __nv_bfloat16*>(w), static_cast<float*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

template <int STAGES>
int ring_dispatch(int nb2, const void* qr, const void* qi, const void* w, void* out, int n_ants,
                  int ps, int n_ch, cudaStream_t st) {
  switch (nb2) {
    case 16: return ring_launch<16, STAGES>(qr, qi, w, out, n_ants, ps, n_ch, st);
    case 32: return ring_launch<32, STAGES>(qr, qi, w, out, n_ants, ps, n_ch, st);
    case 64: return ring_launch<64, STAGES>(qr, qi, w, out, n_ants, ps, n_ch, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int NB2>
int ring_attributes(int n_ants, int ps, int n_ch, int* info) {
  Geo g;
  if (!ring_geometry<NB2>(n_ants, ps, n_ch, g)) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes at{};
  cudaError_t err = cudaFuncGetAttributes(&at, bstage_ring_kernel<NB2, K2_ALL>);
  int grid = 0;
  if (err == cudaSuccess) err = ring_grid<NB2, K2_ALL>(g, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = at.numRegs;
  info[1] = static_cast<int>(at.localSizeBytes);
  info[2] = grid;
  info[3] = RCT;
  info[4] = Tile<NB2>::MT;
  info[5] = KS;
  info[6] = g.resident;
  info[7] = ring_smem<NB2>(g);
  return 0;
}

}  // namespace

// K2: planes qr, qi [A, P*S, C] int8, weights w [C, 2A, 2B] (bf16 if w_bf16,
// else f32) -> out [C/pack, P*S, 128] f32. bf16 weights with 2B in {16, 32,
// 64} take the ring body (P*S % 64 == 0, C % 16 == 0, planes 4-byte and
// weights and output 16-byte aligned); the rest the SIMT body.
extern "C" int bstage_fused_launch(const void* qr, const void* qi, const void* w,
                                   int w_bf16, void* out, int n_ants, int ps,
                                   int n_ch, int nb2, void* stream) {
  const auto* r = static_cast<const int8_t*>(qr);
  const auto* i = static_cast<const int8_t*>(qi);
  auto* o = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_bf16 && nb2 != 8) {
    return ring_dispatch<K2_ALL>(nb2, qr, qi, w, out, n_ants, ps, n_ch, st);
  }
  const cudaError_t err = w_bf16 ? dispatch<__nv_bfloat16>(nb2, r, i, w, o, n_ants, ps, n_ch, st)
                                 : dispatch<float>(nb2, r, i, w, o, n_ants, ps, n_ch, st);
  return static_cast<int>(err);
}

// One of K2's stage stops on the ring body (bf16 weights), `stages` a mask
// of K2_COPY (1), K2_MMA (2) and K2_STORE (4) other than K2_ALL: as
// bstage_fused_launch, into out as the stop leaves it (see K2_ALL).
extern "C" int bstage_fused_stop_launch(const void* qr, const void* qi, const void* w, void* out,
                                        int n_ants, int ps, int n_ch, int nb2, int stages,
                                        void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (stages) {
    case K2_COPY:
      return ring_dispatch<K2_COPY>(nb2, qr, qi, w, out, n_ants, ps, n_ch, st);
    case K2_MMA:
      return ring_dispatch<K2_MMA>(nb2, qr, qi, w, out, n_ants, ps, n_ch, st);
    case K2_STORE:
      return ring_dispatch<K2_STORE>(nb2, qr, qi, w, out, n_ants, ps, n_ch, st);
    case K2_COPY | K2_MMA:
      return ring_dispatch<K2_COPY | K2_MMA>(nb2, qr, qi, w, out, n_ants, ps, n_ch, st);
    case K2_MMA | K2_STORE:
      return ring_dispatch<K2_MMA | K2_STORE>(nb2, qr, qi, w, out, n_ants, ps, n_ch, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The ring body for a shape: info[0..7] = registers, local (spill) bytes,
// blocks of its persistent grid, channels and m rows a work item, K-step
// rows, weights resident (1) or staged (0), dynamic shared memory bytes.
extern "C" int bstage_fused_attributes(int n_ants, int ps, int n_ch, int nb2, int* info) {
  switch (nb2) {
    case 16: return ring_attributes<16>(n_ants, ps, n_ch, info);
    case 32: return ring_attributes<32>(n_ants, ps, n_ch, info);
    case 64: return ring_attributes<64>(n_ants, ps, n_ch, info);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
