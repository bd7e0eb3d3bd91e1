// K3 and K5b: visibility grams for Hopper (sm_90a), int8 tensor cores.
//
// Both compute, per channel c, with Y = [re rows; im rows] of the I = A*P
// inputs (ordered a*P + p) over S samples and G = Y*Y^T:
//   V_re = G11 + G22,   V_im = G21 - G12,   each [C, I, I] f32.
//
// Exactness. Products are s8*s8 on the tensor cores (mma.sync m16n8k32 in
// K3, wgmma m64n80k32 in K5b) with s32 accumulation, so every gram block is
// the exact integer sum. V_re is accumulated as one s32 sum (G11 + G22,
// exact) and V_im as the s32 difference of two exact sums, G21 and G12 kept
// apart (negating an int8 operand to merge them would overflow at -128); each
// is converted to f32 once. IEEE conversion and addition are correctly
// rounded, so this equals the plain version's f32 G11 + G22 (each term an
// exact integer below 2^24 for S <= 1024) bit for bit. Nothing here depends
// on the summation order. K3 owns 16 x 16 tiles (ti, tj) of the I x I output
// with ti <= tj: V_re is symmetric and V_im antisymmetric, so an
// off-diagonal tile also writes its mirror (V_im mirrored as the s32
// difference the other way round, so a zero stays +0). K5b computes every
// tile directly.
//
// K3 replaces the TPU kernel dpdk_dc_sand_tpu/ops/xcorr_pallas.py:
// _kernel_fused (behind correlate_planes_fused). It reads the F planes
// [A, P, S, C] int8 as they are and turns them on chip, as the TPU kernel
// turns a channel block in VMEM and reads it back channel by channel: no
// turned intermediate reaches device memory.
//
// What bounds K3 on this card. At the flagship (I = 160, S = 256,
// C = 32768) it must read 2.68 GB of planes and write 6.71 GB of f32
// visibilities: 2.8 ms at 3.35 TB/s, 71% of it writes. Its int8 MMA work,
// the upper triangle only, is about 0.44 ms. It stages each tile's 64 rows
// (re and im of the i tile and of the j tile) from L2, so the planes pass
// through L2 once for each of the tiles that read them: 29.5 GB, in
// 32-byte runs of a channel block, each in its own L2 line. What sets the pace on the card is
// an SM's rate of those runs, which does not move with the copy width, and
// the rate of the scattered 64-byte row segments it stores.
//
// What held the first body back (15.6 ms at the flagship on an H100): one
// 512-thread block a work item and one block on each SM (128 registers a
// thread); a serial K loop in which each thread issued its 32 word loads,
// and the block waited on that round trip, then turned the words through a
// padded shared buffer behind a second barrier and multiplied, with no copy
// in flight; and stores straight from the MMA fragments, a float a lane,
// each store instruction of the direct tile half-filling eight 32-byte
// sectors.
//
// Design.
//   Persistent blocks: one 256-thread block on each SM walks the work items
//   (tile, channel block of CB = 32 channels) in the first grid's order,
//   tiles fastest, so the tiles of one channel block run together and its
//   rows stay in L2 while they read them.
//   A ring of rows: each K step (32 samples) of an item's 64 rows x 32
//   channels is copied into a shared-memory ring of D = 2 stages of 64 KB
//   by 4-byte cp.async (one word of 4 channels a copy), placed by the
//   swizzle below so that both the copies and the fragment loads are free
//   of bank conflicts. The ring runs a K step ahead across the end of a
//   work item, so the next item's first copies are in flight during this
//   item's last MMAs and its stores; the copies wait at one barrier a K
//   step.
//   No turned buffer: each of the 8 warps owns one word (4 channels) of the
//   runs and turns its own fragments in registers (a 4 x 4 byte transpose
//   gives one fragment register for each of its 4 channels), then runs 16
//   mma a channel, keeping the s32 accumulators of its 4 channels (V_re,
//   G21, G12: 96 registers a thread).
//   Stores from the fragments, whole row segments: two shuffles in each
//   quad give a lane 4 consecutive columns of a row, so one float4 store a
//   lane writes 8 rows x 64 bytes a warp instruction; the mirror's rows
//   leave as 8 rows x 32 bytes by one shuffle and a float2 a lane.
// Each choice was measured on an H100 against those not taken: 16-byte
// copies (4-way bank conflicts on the fragment loads), three stages, a ring
// of 16-sample stages feeding a turned shared buffer, the tiles staged
// through shared memory (80 KB that the L1 then lacks), producer warps
// (with setmaxnreg) feeding the MMA warps through mbarriers, and a cluster
// of two blocks on adjacent channel blocks, each copying 64-byte runs of
// half the rows and reading the other half from its partner's shared
// memory, were each slower or tied. The stage stops (K3_COPY, K3_MMA,
// K3_STORE below; phase 8 of chip_smoke.py times each) split its time: the
// copies take the most, the stores next (well above a fill of the same
// outputs) and the MMA least, and the copies barely overlap the rest.
//
// K5b replaces dpdk_dc_sand_tpu/ops/xcorr_pallas.py: _kernel (behind
// correlate_turned_fused). It reads the turned [C, 2I, S] int8 layout that
// the corner turn (K5a) writes, in which channel c's operand Y_c = [re rows;
// im rows] is one contiguous block of 2I x S bytes, each row K-contiguous:
// the K-major layout that wgmma wants for both operands.
//
// What bounds K5b on this card. At phase 8's shape (I = 160, S = 256,
// C = 32768) it must read 2.68 GB and write 6.71 GB: 2.805 ms at 3.35
// TB/s. The full square of products is 1.72 int8 TOP, 0.87 ms at 1979 TOP/s.
// The first body (37.7 ms) staged each 16 x 16 tile's 64 rows for 32
// channels, so every row passed through L2 once for each of the n_t + 1
// tiles that named it (29.5 GB), with no copy in flight and stores a float a
// lane.
//
// Design.
//   A channel is the work item of one persistent 256-thread block an SM
//   (two warpgroups). Its rows are read from device memory once, into a
//   shared-memory slot, in wgmma's K-major layout with the 128-byte swizzle;
//   with two slots the next channel's rows land while this channel's tiles
//   are computed and stored.
//   The copies: TMA boxes of 128 samples x I rows (a tensor map over xt
//   viewed [C * 2I, S]; samples past S read as zeros), one thread issuing a
//   channel's boxes against the slot's mbarrier, where rows start 16-byte
//   aligned and I <= 256; else cp.async of 16, 8 or 4 bytes by every thread,
//   each row's chunks on consecutive lanes, samples past S zero-filled.
//   A unit is a 64 x 80 tile of V[c], the full square (the lower tiles are
//   computed again rather than mirrored): one warpgroup runs wgmma
//   m64n80k32 s8 from shared memory, V_re as one s32 accumulator (re.re +
//   im.im) and V_im in a second (G21, negated in registers, plus G12,
//   negated back).
//   The tiles leave straight from the accumulators as row segments (two
//   quad shuffles give a lane 4 consecutive columns: one float4, 8 rows x
//   64 bytes a warp instruction), V_re while the G12 products run.
//   Plans (k5b_plan, on the C side): two slots where two channels fit (at
//   I = 160: S <= 256), one slot where one does (S <= 512), else streaming
//   stages of 256 samples through two slots, with an item of (channel,
//   64-row tile, pair of 80-column tiles): the tile's 64 re and im rows and
//   the pair's 160, so a row is read ceil(n_nt / 2) times as an A row and
//   n_mt times as a B row (at I = 160: once and three times).
// Phase 8 of chip_smoke.py times this body at its shape beside its stage
// stops (K5B_COPY, K5B_MMA, K5B_STORE below): the copies hide behind the
// MMAs, and the MMAs behind the stores, which take about what a fill of the
// same outputs takes. Forms tried in development runs on an H100 and gone,
// each slower at phase 8's shape: mma.sync m16n8k32 fed by ldmatrix from
// rows padded by 16 bytes (its MMAs alone took most of the body's time, with
// the tiles staged in shared memory and sent by cp.async.bulk or by float4
// thread stores); wgmma on unswizzled core matrices (its copies write 8 rows
// x 16 bytes a quarter warp); the swizzled layout fed by cp.async (its copies
// did not overlap the MMAs); the next stage's copies spread over a channel's
// rounds, or issued behind its first products. A branch around a
// warpgroup's wgmma (a unit past the end) made ptxas serialize every wgmma
// of the kernel (C7520): a warpgroup without a unit repeats the last one.

#include <climits>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CB = 32;              // channels a block: one 32-byte run of each row
constexpr int T = 16;               // output tile edge
constexpr int ROWS = 4 * T;         // staged rows: re_i, im_i, re_j, im_j
constexpr int SK = 32;              // samples per K step (the mma depth)

__device__ __forceinline__ void transpose4x4(const uint32_t in[4], uint32_t out[4]) {
  const uint32_t t0 = __byte_perm(in[0], in[1], 0x5140);
  const uint32_t t1 = __byte_perm(in[2], in[3], 0x5140);
  const uint32_t t2 = __byte_perm(in[0], in[1], 0x7362);
  const uint32_t t3 = __byte_perm(in[2], in[3], 0x7362);
  out[0] = __byte_perm(t0, t1, 0x5410);
  out[1] = __byte_perm(t0, t1, 0x7632);
  out[2] = __byte_perm(t2, t3, 0x5410);
  out[3] = __byte_perm(t2, t3, 0x7632);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Tile index p of the upper triangle (row-major, ti <= tj) -> (ti, tj).
__host__ __device__ __forceinline__ void tile_of(int p, int n_t, int& ti, int& tj) {
  ti = 0;
  while (p >= n_t - ti) {
    p -= n_t - ti;
    ++ti;
  }
  tj = ti + p;
}

// ---------------------------------------------------------------- K3 ----

constexpr int K3_THREADS = 256;
constexpr int K3_WARPS = K3_THREADS / 32;
constexpr int K3_CPW = CB / K3_WARPS;         // channels a warp: one word of each run
constexpr int ROW_WORDS = SK * CB / 4;        // words of a staged row: 256
constexpr int STAGE_BYTES = ROWS * ROW_WORDS * 4;
constexpr int D = 2;                          // stages (K steps) in the ring
constexpr int K3_SMEM = D * STAGE_BYTES;
static_assert(K3_CPW == 4, "a warp owns the 4 channels of one word");
static_assert(ROW_WORDS == K3_THREADS, "a thread copies one word of each staged row");
static_assert(D >= 2 && K3_SMEM <= 232448, "shared memory a block may have");

struct Geo {
  int n_in, n_s, n_ch;
  int n_t, n_tiles, n_items;
  int vec2, vec4;  // I % 2 (% 4) == 0 and 8 (16)-byte aligned outputs: float2 (float4) stores
};

struct Item {
  int i0, j0, c0;
};

__device__ __forceinline__ Item item_of(int item, const Geo& g) {
  int ti, tj;
  tile_of(item % g.n_tiles, g.n_t, ti, tj);
  return Item{ti * T, tj * T, (item / g.n_tiles) * CB};
}

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

// Ring layout: word (row, sample s, channel word cw) of a stage sits at
//   row * 256 + (s / 4) * 32 + ((8 * (s % 4) + cw) ^ (4 * (row % 8) + (s / 4) % 4)),
// so a warp's fragment loads (rows gid, samples 4 tig + q, one cw) and its
// copies (one row, samples 4 apart, every cw) each hit 32 distinct banks.
//
// The copy: thread t copies word cw = t % 8 of sample t / 8 of each of the
// K step's 64 rows, one 4-byte cp.async each; off_i / off_j are the element
// offsets of its word in rows i0 / j0 of the plane, vi / vj the rows of the
// i and j tiles that exist (the rest are zero-filled).
struct Copier {
  long long off_i, off_j;
  int vi, vj;
  __device__ __forceinline__ void start(const Item& it, const Geo& g) {
    const int t = threadIdx.x;
    const long long word = static_cast<long long>(t / 8) * g.n_ch + it.c0 + 4 * (t % 8);
    const long long row = static_cast<long long>(g.n_s) * g.n_ch;
    off_i = it.i0 * row + word;
    off_j = it.j0 * row + word;
    vi = min(T, g.n_in - it.i0);
    vj = min(T, g.n_in - it.j0);
  }
  // Group PART (re_i, im_i, re_j, im_j): rows 16 * PART .. 16 * PART + 15.
  template <int PART>
  __device__ __forceinline__ void issue(uint32_t stage, const int8_t* __restrict__ qr,
                                        const int8_t* __restrict__ qi, const Geo& g) const {
    const int t = threadIdx.x, s = t / 8;
    const uint32_t y = (8 * (s % 4) + t % 8) ^ ((s / 4) % 4);
    const uint32_t base = stage + 4 * (PART * T * ROW_WORDS + (s / 4) * 32);
    const long long step = static_cast<long long>(g.n_s) * g.n_ch;
    const int8_t* src = (PART & 1 ? qi : qr) + (PART < 2 ? off_i : off_j);
    const int valid = PART < 2 ? vi : vj;
    const int8_t* first = src;
#pragma unroll
    for (int m = 0; m < T; ++m, src += step) {
      const uint32_t dst = base + 4 * (m * ROW_WORDS + (y ^ (4 * (m % 8))));
      const bool ok = m < valid;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                   "l"(ok ? src : first), "r"(ok ? 4 : 0)
                   : "memory");
    }
  }
  __device__ __forceinline__ void next_step(const Geo& g) {
    off_i += static_cast<long long>(SK) * g.n_ch;
    off_j += static_cast<long long>(SK) * g.n_ch;
  }
};

// One K step for a warp: its channel word cw of the 64 staged rows, turned
// in registers (a 4 x 4 byte transpose gives one fragment register for each
// of the 4 channels), then 16 mma a channel.
__device__ __forceinline__ void k3_mma(const uint32_t* stage, int gid, int tig, int cw,
                                       int (&acc_re)[K3_CPW][2][4],
                                       int (&acc_ir)[K3_CPW][2][4],
                                       int (&acc_ri)[K3_CPW][2][4]) {
  // Word q of 4 samples of `row` (a multiple of 8 above gid) in sample group
  // tig (hi = 0) or tig + 4 (hi = 1).
  const uint32_t z = cw ^ (4 * gid + tig);
  const uint32_t* base = stage + gid * ROW_WORDS + tig * 32;
  auto frag = [&](int row, int hi, uint32_t (&out)[K3_CPW]) {
    uint32_t in[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) in[q] = base[row * ROW_WORDS + hi * 128 + (z ^ (8 * q))];
    transpose4x4(in, out);
  };
  uint32_t a[2][4][K3_CPW];  // re_i, im_i: [fragment register][channel]
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    frag(g * T, 0, a[g][0]);
    frag(g * T + 8, 0, a[g][1]);
    frag(g * T, 1, a[g][2]);
    frag(g * T + 8, 1, a[g][3]);
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    uint32_t br[2][K3_CPW], bi[2][K3_CPW];  // re_j, im_j
    frag(2 * T + nt * 8, 0, br[0]);
    frag(2 * T + nt * 8, 1, br[1]);
    frag(3 * T + nt * 8, 0, bi[0]);
    frag(3 * T + nt * 8, 1, bi[1]);
#pragma unroll
    for (int c = 0; c < K3_CPW; ++c) {
      const uint32_t ar[4] = {a[0][0][c], a[0][1][c], a[0][2][c], a[0][3][c]};
      const uint32_t ai[4] = {a[1][0][c], a[1][1][c], a[1][2][c], a[1][3][c]};
      mma_s8(acc_re[c][nt], ar, br[0][c], br[1][c]);
      mma_s8(acc_re[c][nt], ai, bi[0][c], bi[1][c]);
      mma_s8(acc_ir[c][nt], ai, br[0][c], br[1][c]);
      mma_s8(acc_ri[c][nt], ar, bi[0][c], bi[1][c]);
    }
  }
}

// Up to N floats from p (N = 2 or 4): one vector store where the row has
// them all and `vec` holds (aligned rows), else the ones inside the row.
template <int N>
__device__ __forceinline__ void store_run(float* p, const float (&v)[N], int left, bool vec) {
  if (vec && left >= N) {
    if constexpr (N == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
    }
  } else {
#pragma unroll
    for (int t = 0; t < N; ++t) {
      if (t < left) p[t] = v[t];
    }
  }
}

// The item's tiles straight from the fragments, each row segment whole. A
// lane holds, per channel, array and half hf of the tile, rows gid + 8 hf at
// columns nt * 8 + 2 tig + e (nt, e = 0, 1). Two shuffles in each quad give
// lane tig the columns 4 tig .. 4 tig + 3 of its row, so one float4 store a
// lane writes 8 rows x 64 bytes a warp instruction. The mirror's row j holds
// the column of lanes gid: one shuffle between lanes gid and gid ^ 1 gives
// each lane two consecutive columns of one mirror row, so one float2 store
// writes 8 rows x 32 bytes. V_im's mirror is the negated s32 difference.
__device__ __forceinline__ void k3_store(float* __restrict__ vre, float* __restrict__ vim,
                                         const Item& it, const Geo& g, int gid, int tig, int cw,
                                         const int (&acc_re)[K3_CPW][2][4],
                                         const int (&acc_ir)[K3_CPW][2][4],
                                         const int (&acc_ri)[K3_CPW][2][4]) {
  const int n = g.n_in;
  const long long nn = static_cast<long long>(n) * n;
  const bool mirror = it.i0 != it.j0, odd = tig & 1;
  // Direct rows: round 1 reads lane s1 of the quad, round 2 lane s1 ^ 1; a
  // lane sends its n tile tig & 1 in round 1 and the other in round 2.
  const int s1 = 4 * gid + ((tig >> 1) | ((tig & 1) << 1));
#pragma unroll
  for (int c = 0; c < K3_CPW; ++c) {
    const long long base = (it.c0 + 4 * cw + c) * nn;
#pragma unroll
    for (int arr = 0; arr < 2; ++arr) {
      float* out = (arr ? vim : vre) + base;
      int v[2][4];  // [n tile][fragment]: this array's s32 values
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          v[nt][f] = arr ? acc_ir[c][nt][f] - acc_ri[c][nt][f] : acc_re[c][nt][f];
        }
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int f = 2 * hf;
        const int a0 = odd ? v[1][f] : v[0][f], a1 = odd ? v[1][f + 1] : v[0][f + 1];
        const int b0 = odd ? v[0][f] : v[1][f], b1 = odd ? v[0][f + 1] : v[1][f + 1];
        const int r10 = __shfl_sync(~0u, a0, s1), r11 = __shfl_sync(~0u, a1, s1);
        const int r20 = __shfl_sync(~0u, b0, s1 ^ 1), r21 = __shfl_sync(~0u, b1, s1 ^ 1);
        const bool lo = tig < 2;
        const float x[4] = {static_cast<float>(lo ? r10 : r20), static_cast<float>(lo ? r11 : r21),
                            static_cast<float>(lo ? r20 : r10), static_cast<float>(lo ? r21 : r11)};
        const int row = it.i0 + gid + 8 * hf, col = it.j0 + 4 * tig;
        if (row < n && col < n) {
          store_run<4>(out + static_cast<long long>(row) * n + col, x, n - col, g.vec4);
        }
      }
      if (!mirror) continue;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          // Mirror rows j = nt * 8 + 2 tig + e, columns gid + 8 hf.
          const int x0 = arr ? -v[nt][2 * hf] : v[nt][2 * hf];
          const int x1 = arr ? -v[nt][2 * hf + 1] : v[nt][2 * hf + 1];
          const bool godd = gid & 1;
          const int r = __shfl_xor_sync(~0u, godd ? x0 : x1, 4);
          const float x[2] = {static_cast<float>(godd ? r : x0), static_cast<float>(godd ? x1 : r)};
          const int row = it.j0 + nt * 8 + 2 * tig + (godd ? 1 : 0);
          const int col = it.i0 + 8 * hf + (gid & ~1);
          if (row < n && col < n) {
            store_run<2>(out + static_cast<long long>(row) * n + col, x, n - col, g.vec2);
          }
        }
      }
    }
  }
}

// K3's stage stops: a compile-time mask of the body's three stages. K3 is
// K3_ALL, the code below unchanged; each stop keeps only some stages, and
// phase 8 of chip_smoke.py times each against K3 at the flagship to split
// its time. Without K3_COPY the MMAs read a zeroed ring (the K loop keeps
// its waits and barriers); without K3_MMA the stores write the zero sums;
// without K3_STORE the sums reach one store that no exact sum triggers
// (|sum| <= 2^25 < 2^31), so the MMAs stay and nothing is written.
constexpr int K3_COPY = 1, K3_MMA = 2, K3_STORE = 4, K3_ALL = 7;

template <int STAGES>
__global__ void __launch_bounds__(K3_THREADS, 1)
    xcorr_fused_kernel(const int8_t* __restrict__ qr, const int8_t* __restrict__ qi,
                       float* __restrict__ vre, float* __restrict__ vim, Geo g) {
  extern __shared__ __align__(128) uint32_t ring[];  // [D][ROWS][ROW_WORDS]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int n_ks = g.n_s / SK;  // K steps an item
  const int mine = (g.n_items - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const uint32_t ring0 = smem_u32(ring);
  if constexpr (!(STAGES & K3_COPY)) {  // the first K step's barrier orders it
    for (int w = threadIdx.x; w < K3_SMEM / 4; w += K3_THREADS) ring[w] = 0;
  }

  // The copy cursor runs D - 1 K steps ahead of the mma, across items: K
  // step x of this block goes to slot x % D, one commit group a K step
  // (empty past the end).
  Copier cp;
  int cp_m = 0, cp_k = 0;
  cp.start(item_of(blockIdx.x, g), g);
  auto issue = [&](int slot) {
    if ((STAGES & K3_COPY) && cp_m < mine) {
      const uint32_t stage = ring0 + slot * STAGE_BYTES;
      cp.issue<0>(stage, qr, qi, g);
      cp.issue<1>(stage, qr, qi, g);
      cp.issue<2>(stage, qr, qi, g);
      cp.issue<3>(stage, qr, qi, g);
      cp.next_step(g);
      if (++cp_k == n_ks) {
        cp_k = 0;
        if (++cp_m < mine) cp.start(item_of(blockIdx.x + cp_m * gridDim.x, g), g);
      }
    }
    cp_async_commit();
  };
  for (int k = 0; k < D - 1; ++k) issue(k);
  int slot = 0;
  for (int m = 0; m < mine; ++m) {
    const Item it = item_of(blockIdx.x + m * gridDim.x, g);
    // [channel][n tile][fragment]: V_re (G11 + G22), G21, G12.
    int acc_re[K3_CPW][2][4] = {}, acc_ir[K3_CPW][2][4] = {}, acc_ri[K3_CPW][2][4] = {};
    for (int ks = 0; ks < n_ks; ++ks) {
      cp_async_wait<D - 2>();  // this thread's copies of this K step have landed
      __syncthreads();         // everyone's; and the slot of the last K step is free
      issue(slot == 0 ? D - 1 : slot - 1);
      if constexpr (STAGES & K3_MMA) {
        k3_mma(ring + slot * (STAGE_BYTES / 4), gid, tig, warp, acc_re, acc_ir, acc_ri);
      }
      slot = slot == D - 1 ? 0 : slot + 1;
    }
    if constexpr (STAGES & K3_STORE) {
      k3_store(vre, vim, it, g, gid, tig, warp, acc_re, acc_ir, acc_ri);
    } else if constexpr (STAGES & K3_MMA) {
      bool hit = false;
#pragma unroll
      for (int c = 0; c < K3_CPW; ++c) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            hit |= acc_re[c][nt][f] == INT_MIN || acc_ir[c][nt][f] == INT_MIN ||
                   acc_ri[c][nt][f] == INT_MIN;
          }
        }
      }
      if (hit) vre[it.c0] = 0.0f;
    }
  }
  cp_async_wait<0>();  // no copy outlives the block (those past the end are empty)
}

bool aligned(const void* p, uintptr_t to) { return reinterpret_cast<uintptr_t>(p) % to == 0; }

// The geometry of a K3 launch, or false for a shape it does not take.
bool k3_geometry(int n_in, int n_s, int n_ch, Geo& g) {
  if (n_in <= 0 || n_s <= 0 || n_ch <= 0 || n_s % SK || n_ch % CB) return false;
  const int n_t = (n_in + T - 1) / T;
  const long long n_tiles = static_cast<long long>(n_t) * (n_t + 1) / 2;
  const long long n_items = n_tiles * (n_ch / CB);
  if (n_items > (1LL << 30)) return false;
  g = Geo{n_in, n_s, n_ch, n_t, static_cast<int>(n_tiles), static_cast<int>(n_items), 0, 0};
  return true;
}

template <int STAGES>
cudaError_t k3_grid(int n_items, int& grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(xcorr_fused_kernel<STAGES>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, K3_SMEM);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, xcorr_fused_kernel<STAGES>,
                                                        K3_THREADS, K3_SMEM);
  }
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  grid = n_items < sms * per_sm ? n_items : sms * per_sm;
  return cudaSuccess;
}

// K3 (STAGES = K3_ALL) or one of its stops: refuses a shape or base it does
// not take with cudaErrorInvalidValue, before any launch.
template <int STAGES>
int k3_launch(const void* qr, const void* qi, void* vre, void* vim, int n_inputs,
              int n_spectra, int n_ch, void* stream) {
  Geo g;
  if (!k3_geometry(n_inputs, n_spectra, n_ch, g) || !aligned(qr, 4) || !aligned(qi, 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  g.vec2 = n_inputs % 2 == 0 && aligned(vre, 8) && aligned(vim, 8);
  g.vec4 = n_inputs % 4 == 0 && aligned(vre, 16) && aligned(vim, 16);
  int grid = 0;
  cudaError_t err = k3_grid<STAGES>(g.n_items, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  xcorr_fused_kernel<STAGES><<<grid, K3_THREADS, K3_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qr), static_cast<const int8_t*>(qi), static_cast<float*>(vre),
      static_cast<float*>(vim), g);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- K5b ---

constexpr int K5B_THREADS = 256;  // two warpgroups
constexpr int WG_M = 64, WG_N = 80;  // a unit: a 64 x 80 tile of V[c], one warpgroup's wgmma
constexpr int ATOM = 128;            // bytes of K in a swizzle atom's row
constexpr int K5B_TWO_SLOTS = 1, K5B_ONE_SLOT = 2, K5B_STREAM = 3;  // the plans

// K5b's stage stops, as K3's: without K5B_COPY the MMAs read zeroed slots
// (the waits and barriers stay); without K5B_MMA the stores write the zero
// sums; without K5B_STORE the sums reach one store that no exact sum
// triggers, so the MMAs stay and nothing is written.
constexpr int K5B_COPY = 1, K5B_MMA = 2, K5B_STORE = 4, K5B_ALL = 7;

struct K5bPlan {
  int n_in, n_s, n_ch;
  int kind, slots;         // the plan; stages held at once (1 or 2)
  int kc, n_kc, last_ks;   // samples a stage (a multiple of ATOM), stages an item, K steps
                           // of its last stage
  int rows;                // staged rows a stage (a multiple of 8)
  int r_im;                // resident: first staged row of the im rows
  int n_mt, n_nt, units;   // 64-row and 80-column tiles of V[c]; units a channel
  int items_per_ch, n_items;
  int stage_bytes, smem;
  int tma, tma_bytes;      // copies by TMA (resident, aligned rows); bytes a stage
  int w;                   // copy width of the cp.async copies: 16, 8 or 4 bytes
  int vec4;                // output stores as float4
};

// W bytes from src to shared dst, or W zero bytes where !ok.
template <int W>
__device__ __forceinline__ void cp_async_zfill(uint32_t dst, const void* src, bool ok) {
  if constexpr (W == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(ok ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src), "n"(W),
                 "r"(ok ? W : 0)
                 : "memory");
  }
}

// Staged layout: wgmma's K-major layout with the 128-byte swizzle. A stage
// holds `rows` rows of kc bytes as kc / ATOM blocks of rows x 128 bytes;
// row r's 16-byte chunk j of a block sits at (r / 8) * 1024 + (r % 8) * 128
// + (j ^ (r % 8)) * 16, so the 8 rows of a core matrix, and each copy's
// quarter warp, fill all 32 banks.
__device__ __forceinline__ uint32_t staged(uint32_t stage, int rows, int r, int b) {
  return stage + (b / ATOM) * rows * ATOM + (r / 8) * 1024 + (r % 8) * ATOM +
         ((((b % ATOM) >> 4) ^ (r % 8)) << 4) + (b & 15);
}

// A wgmma operand: 8-row groups of a block 1024 bytes apart, 128-byte swizzle.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// The address of K step ks of a block whose first staged row is r0.
__device__ __forceinline__ uint32_t k_step(uint32_t stage, int rows, int r0, int ks) {
  return stage + (ks / 4) * rows * ATOM + (r0 / 8) * 1024 + (ks % 4) * 32;
}

// Shared-memory writes of this thread (st.shared, cp.async), seen by the
// async proxy that wgmma reads through.
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of d across a wgmma.
__device__ __forceinline__ void wg_hold(int (&d)[40]) {
#pragma unroll
  for (int i = 0; i < 40; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d = A (64 x 32 int8) * B (80 x 32 int8)^T (+ d where add), both K-major in
// shared memory.
__device__ __forceinline__ void wg_mma(int (&d)[40], uint32_t a, uint32_t b, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "%40, %41, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39])
      : "l"(wg_desc(a)), "l"(wg_desc(b)), "r"(add));
}

__device__ __forceinline__ void negate(int (&d)[40]) {
#pragma unroll
  for (int i = 0; i < 40; ++i) d[i] = -d[i];
}

// An item: a channel (the resident plans), or a channel's (64-row tile mt,
// pair of 80-column tiles np) (streaming).
struct K5bItem {
  int c, mt, np;
};

__device__ __forceinline__ K5bItem k5b_item(int item, const K5bPlan& p) {
  const int q = item % p.items_per_ch, np = (p.n_nt + 1) / 2;
  return K5bItem{item / p.items_per_ch, q / np, q % np};
}

// One stage's copies: samples [kc * p.kc, ...) of the item's rows up to S
// rounded to 32 (those past S zero-filled), W bytes a cp.async, each row's
// chunks on consecutive lanes. Resident: the re rows to staged rows
// [0, I), the im rows to [r_im, r_im + I). Streaming: the 64 re and im rows
// of tile mt to [0, 64) and [64, 128), the 160 re and im rows of tile pair
// np to [128, 288) and [288, 448).
template <int W>
__device__ __forceinline__ void k5b_copy(uint32_t stage, const int8_t* __restrict__ xt,
                                         const K5bItem& it, int kc, const K5bPlan& p) {
  constexpr int SUB = 16 / W;
  const int n = p.n_in;
  int src0 = 0, n0 = n, d1 = p.r_im, src2 = 0, n2 = 0;
  if (p.kind == K5B_STREAM) {
    src0 = WG_M * it.mt;
    n0 = min(WG_M, n - src0);
    d1 = WG_M;
    src2 = 2 * WG_N * it.np;
    n2 = min(2 * WG_N, n - src2);
  }
  const int s0 = kc * p.kc;
  const int cpr = min(p.kc, (p.n_s - s0 + SK - 1) / SK * SK) / 16;  // 16-byte chunks a row
  const int total = (2 * n0 + 2 * n2) * cpr * SUB;
  const int8_t* chan = xt + static_cast<long long>(it.c) * 2 * n * p.n_s;
  for (int q = threadIdx.x; q < total; q += K5B_THREADS) {
    const int t = q / SUB, ch = t % cpr;
    int row = t / cpr, src, dst;
    if (row < n0) {
      src = src0 + row;
      dst = row;
    } else if ((row -= n0) < n0) {
      src = n + src0 + row;
      dst = d1 + row;
    } else if ((row -= n0) < n2) {
      src = src2 + row;
      dst = 2 * WG_M + row;
    } else {
      row -= n2;
      src = n + src2 + row;
      dst = 2 * WG_M + 2 * WG_N + row;
    }
    const int b = 16 * ch + W * (q % SUB);
    const bool ok = s0 + b < p.n_s;
    const int8_t* g = chan + static_cast<long long>(src) * p.n_s + s0 + b;
    cp_async_zfill<W>(staged(stage, p.rows, dst, b), ok ? g : xt, ok);
  }
}

// A warp's 16 rows of a 64 x 80 tile, straight from the accumulator: per 16
// columns, two shuffles in each quad give lane tig the columns 4 tig ..
// 4 tig + 3 of its row (K3's store), one float4 a lane where vec4.
__device__ __forceinline__ void wg_store(float* __restrict__ out, const int (&d)[40], int row0,
                                         int col0, int n, bool vec4, int gid, int tig) {
  const int s1 = 4 * gid + ((tig >> 1) | ((tig & 1) << 1));
  const bool odd = tig & 1, lo = tig < 2;
#pragma unroll
  for (int pr = 0; pr < WG_N / 16; ++pr) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int f = 8 * pr + 2 * hf;  // n8 tile 2 pr: columns 2 tig, 2 tig + 1; then tile 2 pr + 1
      const int a0 = odd ? d[f + 4] : d[f], a1 = odd ? d[f + 5] : d[f + 1];
      const int b0 = odd ? d[f] : d[f + 4], b1 = odd ? d[f + 1] : d[f + 5];
      const int r10 = __shfl_sync(~0u, a0, s1), r11 = __shfl_sync(~0u, a1, s1);
      const int r20 = __shfl_sync(~0u, b0, s1 ^ 1), r21 = __shfl_sync(~0u, b1, s1 ^ 1);
      const float x[4] = {static_cast<float>(lo ? r10 : r20), static_cast<float>(lo ? r11 : r21),
                          static_cast<float>(lo ? r20 : r10), static_cast<float>(lo ? r21 : r11)};
      const int row = row0 + gid + 8 * hf, col = col0 + 16 * pr + 4 * tig;
      if (row < n && col < n) {
        store_run<4>(out + static_cast<long long>(row) * n + col, x, n - col, vec4);
      }
    }
  }
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// A box of the tensor map (128 bytes x I rows at sample x, row y of xt
// viewed [C * 2I, S]) into shared dst, swizzled as the staged layout.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int x, int y,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

template <int STAGES>
__global__ void __launch_bounds__(K5B_THREADS, 1)
    xcorr_turned_kernel(const int8_t* __restrict__ xt, float* __restrict__ vre,
                        float* __restrict__ vim, K5bPlan p,
                        const __grid_constant__ CUtensorMap tmap) {
  extern __shared__ __align__(1024) uint8_t k5b_smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int group = warp / 4, wg = warp % 4, gid = lane / 4, tig = lane % 4;
  const uint32_t slots = smem_u32(k5b_smem);
  const uint32_t bars = slots + p.slots * p.stage_bytes;  // an mbarrier a slot (TMA)
  // Rows past I and samples past S stay zero; without K5B_COPY every slot
  // stays zero.
  for (int q = threadIdx.x; q < p.slots * p.stage_bytes / 16; q += K5B_THREADS) {
    reinterpret_cast<uint4*>(k5b_smem)[q] = make_uint4(0u, 0u, 0u, 0u);
  }
  if (p.tma && threadIdx.x == 0) {
    mbar_init(bars);
    mbar_init(bars + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  proxy_fence();
  __syncthreads();

  const int mine = (p.n_items - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  // The copy cursor: this block's stages in order, (item, stage of the item).
  int cp_m = 0, cp_k = 0;
  auto issue = [&](int slot) {
    if ((STAGES & K5B_COPY) && cp_m < mine) {
      const K5bItem it = k5b_item(blockIdx.x + cp_m * gridDim.x, p);
      const uint32_t stage = slots + slot * p.stage_bytes;
      if (p.tma) {  // resident: the re and im rows, a box for each 128 samples
        if (threadIdx.x == 0) {
          const uint32_t bar = bars + 8 * slot;
          mbar_expect(bar, p.tma_bytes);
          for (int a = 0; a * ATOM < p.n_s; ++a) {
            const uint32_t blk = stage + a * p.rows * ATOM;
            tma_load(blk, &tmap, a * ATOM, 2 * p.n_in * it.c, bar);
            tma_load(blk + p.r_im * ATOM, &tmap, a * ATOM, 2 * p.n_in * it.c + p.n_in, bar);
          }
        }
      } else if (p.w == 16) {
        k5b_copy<16>(stage, xt, it, cp_k, p);
      } else if (p.w == 8) {
        k5b_copy<8>(stage, xt, it, cp_k, p);
      } else {
        k5b_copy<4>(stage, xt, it, cp_k, p);
      }
      if (++cp_k == p.n_kc) {
        cp_k = 0;
        ++cp_m;
      }
    }
    cp_async_commit();
  };
  if (p.slots == 2) issue(0);

  const long long nn = static_cast<long long>(p.n_in) * p.n_in;
  const int rounds = p.kind == K5B_STREAM ? 1 : (p.units + 1) / 2;
  int k = 0;  // stages begun
  uint32_t cur = slots;
  for (int m = 0; m < mine; ++m) {
    const K5bItem it = k5b_item(blockIdx.x + m * gridDim.x, p);
    for (int r = 0; r < rounds; ++r) {
      // This warpgroup's unit (tile mt, nt) and its blocks' first staged
      // rows. Where the units run out, a warpgroup repeats the last unit and
      // writes the same values again: no branch divides a warpgroup's wgmma
      // path (ptxas serializes every wgmma of a kernel that has one).
      int mt, nt, a_re, a_im, b_re, b_im;
      if (p.kind == K5B_STREAM) {
        mt = it.mt;
        nt = min(2 * it.np + group, p.n_nt - 1);
        a_re = 0;
        a_im = WG_M;
        b_re = 2 * WG_M + WG_N * (nt - 2 * it.np);
        b_im = b_re + 2 * WG_N;
      } else {
        const int u = min(2 * r + group, p.units - 1);
        mt = u / p.n_nt;
        nt = u - mt * p.n_nt;
        a_re = WG_M * mt;
        a_im = p.r_im + a_re;
        b_re = WG_N * nt;
        b_im = p.r_im + b_re;
      }
      const int row0 = WG_M * mt + 16 * wg, col0 = WG_N * nt;
      int acc_re[40], acc_im[40];  // V_re; V_im = G21 - G12
#pragma unroll
      for (int i = 0; i < 40; ++i) acc_re[i] = acc_im[i] = 0;
      for (int kc = 0; kc < p.n_kc; ++kc) {
        if (r == 0) {  // a new stage
          // The stage has landed: TMA's bytes at the slot's mbarrier (by
          // the parity of its use), or this thread's cp.async copies, seen
          // by wgmma after the fence and everyone's after the barrier.
          const int slot = p.slots == 2 ? (k & 1) : 0;
          const uint32_t parity = (p.slots == 2 ? k >> 1 : k) & 1;
          if (p.slots == 2) {
            if (!p.tma) cp_async_wait<0>();
            if (p.tma && (STAGES & K5B_COPY)) mbar_wait(bars + 8 * slot, parity);
            proxy_fence();
            __syncthreads();  // and the other slot's stage is done
            issue((k + 1) & 1);
            cur = slots + slot * p.stage_bytes;
          } else {
            __syncthreads();  // the last stage is done
            issue(0);
            if (!p.tma) cp_async_wait<0>();
            if (p.tma && (STAGES & K5B_COPY)) mbar_wait(bars, parity);
            proxy_fence();
            __syncthreads();
          }
          ++k;
        }
        if (!(STAGES & K5B_MMA)) continue;
        const int n_ks = kc == p.n_kc - 1 ? p.last_ks : p.kc / SK;
        // V_re += re.re + im.im and V_im += G21; then -V_im += G12, negated
        // back: exact s32 sums, so a zero stays +0.
        wg_hold(acc_re);
        wg_hold(acc_im);
        wg_fence();
        for (int ks = 0; ks < n_ks; ++ks) {
          const int add = kc > 0 || ks > 0;  // the first product of a unit overwrites
          wg_mma(acc_re, k_step(cur, p.rows, a_re, ks), k_step(cur, p.rows, b_re, ks), add);
          wg_mma(acc_re, k_step(cur, p.rows, a_im, ks), k_step(cur, p.rows, b_im, ks), 1);
          wg_mma(acc_im, k_step(cur, p.rows, a_im, ks), k_step(cur, p.rows, b_re, ks), add);
        }
        wg_commit();
        wg_wait();
        wg_hold(acc_im);
        negate(acc_im);
        wg_hold(acc_im);
        wg_fence();
        for (int ks = 0; ks < n_ks; ++ks) {
          wg_mma(acc_im, k_step(cur, p.rows, a_re, ks), k_step(cur, p.rows, b_im, ks), 1);
        }
        wg_commit();
        if ((STAGES & K5B_STORE) && kc == p.n_kc - 1) {  // V_re leaves while G12 runs
          wg_hold(acc_re);
          wg_store(vre + it.c * nn, acc_re, row0, col0, p.n_in, p.vec4, gid, tig);
        }
        wg_wait();
        wg_hold(acc_im);
        negate(acc_im);
      }
      if constexpr (STAGES & K5B_STORE) {
        if (!(STAGES & K5B_MMA)) {
          wg_store(vre + it.c * nn, acc_re, row0, col0, p.n_in, p.vec4, gid, tig);
        }
        wg_store(vim + it.c * nn, acc_im, row0, col0, p.n_in, p.vec4, gid, tig);
      } else {
        bool hit = false;
#pragma unroll
        for (int i = 0; i < 40; ++i) hit |= acc_re[i] == INT_MIN || acc_im[i] == INT_MIN;
        if (hit) vre[it.c * nn] = 0.0f;
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block (those past the end are empty)
}

int smem_optin() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) {
    return 0;
  }
  return v;
}

int round_up(int x, int to) { return (x + to - 1) / to * to; }

// K5b's plan for a shape, or false for a shape outside the gate (I >= 1,
// S % 8 == 0, S <= 1024, C % 8 == 0). Resident where a channel's rows fit
// (two slots where two do), else streaming stages of kc samples.
bool k5b_plan(int n_in, int n_s, int n_ch, int smem_max, K5bPlan& p) {
  if (n_in <= 0 || n_s <= 0 || n_s % 8 || n_s > 1024 || n_ch <= 0 || n_ch % 8) return false;
  p = K5bPlan{};
  p.n_in = n_in;
  p.n_s = n_s;
  p.n_ch = n_ch;
  p.n_mt = (n_in + WG_M - 1) / WG_M;
  p.n_nt = (n_in + WG_N - 1) / WG_N;
  const int k32 = round_up(n_s, SK);
  // Resident: the re rows, then the im rows from the next multiple of 8,
  // then the rows past 2R that the last tiles read.
  const int r8 = round_up(n_in, 8);
  const int rows = r8 + max(r8, max(WG_M * p.n_mt, WG_N * p.n_nt));
  const long long stage = static_cast<long long>(rows) * round_up(n_s, ATOM);
  if (stage + 16 <= smem_max) {
    p.slots = 2 * stage + 16 <= smem_max ? 2 : 1;
    p.kind = p.slots == 2 ? K5B_TWO_SLOTS : K5B_ONE_SLOT;
    p.kc = round_up(n_s, ATOM);
    p.rows = rows;
    p.r_im = r8;
    p.units = p.n_mt * p.n_nt;
    p.items_per_ch = 1;
  } else {
    p.kind = K5B_STREAM;
    p.slots = 2;
    p.rows = 2 * WG_M + 4 * WG_N;
    for (int kc = 512; kc >= ATOM; kc /= 2) {
      if (kc <= round_up(k32, ATOM) && 2LL * p.rows * kc + 16 <= smem_max) {
        p.kc = kc;
        break;
      }
    }
    if (!p.kc) return false;
    p.units = 2;
    p.items_per_ch = p.n_mt * ((p.n_nt + 1) / 2);
  }
  p.n_kc = (k32 + p.kc - 1) / p.kc;
  p.last_ks = (k32 - (p.n_kc - 1) * p.kc) / SK;
  p.stage_bytes = p.rows * p.kc;
  p.smem = p.slots * p.stage_bytes + 16;  // and an mbarrier a slot
  const long long items = static_cast<long long>(n_ch) * p.items_per_ch;
  if (items > (1LL << 30)) return false;
  p.n_items = static_cast<int>(items);
  return true;
}

template <int STAGES>
cudaError_t k5b_grid(const K5bPlan& p, int& grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(xcorr_turned_kernel<STAGES>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, xcorr_turned_kernel<STAGES>,
                                                        K5B_THREADS, p.smem);
  }
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  grid = p.n_items < sms * per_sm ? p.n_items : sms * per_sm;
  return cudaSuccess;
}

// K5b (STAGES = K5B_ALL) or one of its stops: refuses a shape or base it
// does not take with cudaErrorInvalidValue, before any launch.
// cuTensorMapEncodeTiled, reached through the runtime (no link to libcuda).
PFN_cuTensorMapEncodeTiled tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled fn = nullptr;
  if (!fn) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled>(f);
    }
  }
  return fn;
}

// The resident plans copy by TMA where rows start 16-byte aligned (S % 16 ==
// 0, a 16-byte aligned base) and a box of I rows fits (I <= 256).
bool k5b_tma_fits(const K5bPlan& p) {
  return p.kind != K5B_STREAM && p.n_s % 16 == 0 && p.n_in <= 256;
}

// xt viewed [C * 2I rows, S bytes]; boxes of 128 bytes x I rows, 128-byte
// swizzle; samples past S read as zeros.
bool k5b_tensor_map(const void* xt, const K5bPlan& p, CUtensorMap& map) {
  const PFN_cuTensorMapEncodeTiled encode = tensor_map_encoder();
  if (!encode) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(p.n_s),
                              static_cast<cuuint64_t>(p.n_ch) * 2 * p.n_in};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(p.n_s)};
  const cuuint32_t box[2] = {ATOM, static_cast<cuuint32_t>(p.n_in)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(xt), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int STAGES>
int k5b_launch(const void* xt, void* vre, void* vim, int n_inputs, int n_spectra, int n_ch,
               void* stream) {
  K5bPlan p;
  if (!k5b_plan(n_inputs, n_spectra, n_ch, smem_optin(), p) || !aligned(xt, 4) ||
      !aligned(vre, 4) || !aligned(vim, 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.w = aligned(xt, 16) && n_spectra % 16 == 0 ? 16 : aligned(xt, 8) ? 8 : 4;
  p.vec4 = n_inputs % 4 == 0 && aligned(vre, 16) && aligned(vim, 16);
  CUtensorMap map{};
  p.tma = k5b_tma_fits(p) && aligned(xt, 16);
  if (p.tma && !k5b_tensor_map(xt, p, map)) return static_cast<int>(cudaErrorNotSupported);
  p.tma_bytes = 2 * ((n_spectra + ATOM - 1) / ATOM) * ATOM * n_inputs;
  int grid = 0;
  cudaError_t err = k5b_grid<STAGES>(p, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  xcorr_turned_kernel<STAGES><<<grid, K5B_THREADS, p.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xt), static_cast<float*>(vre), static_cast<float*>(vim), p, map);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K3: planes qr, qi [A, P, S, C] int8 (4-byte aligned) -> vre, vim [C, I, I]
// f32. Takes S % 32 == 0 and C % 32 == 0, any I >= 1; refuses any other
// shape with cudaErrorInvalidValue, before any launch.
extern "C" int xcorr_fused_launch(const void* qr, const void* qi, void* vre, void* vim,
                                  int n_inputs, int n_spectra, int n_ch, void* stream) {
  return k3_launch<K3_ALL>(qr, qi, vre, vim, n_inputs, n_spectra, n_ch, stream);
}

// One of K3's stage stops, `stages` a mask of K3_COPY (1), K3_MMA (2) and
// K3_STORE (4) other than K3_ALL: as xcorr_fused_launch, into vre, vim as
// the stop leaves them (see K3_ALL).
extern "C" int xcorr_fused_stop_launch(const void* qr, const void* qi, void* vre, void* vim,
                                       int n_inputs, int n_spectra, int n_ch, int stages,
                                       void* stream) {
  switch (stages) {
    case K3_COPY:
      return k3_launch<K3_COPY>(qr, qi, vre, vim, n_inputs, n_spectra, n_ch, stream);
    case K3_MMA:
      return k3_launch<K3_MMA>(qr, qi, vre, vim, n_inputs, n_spectra, n_ch, stream);
    case K3_STORE:
      return k3_launch<K3_STORE>(qr, qi, vre, vim, n_inputs, n_spectra, n_ch, stream);
    case K3_COPY | K3_MMA:
      return k3_launch<K3_COPY | K3_MMA>(qr, qi, vre, vim, n_inputs, n_spectra, n_ch, stream);
    case K3_MMA | K3_STORE:
      return k3_launch<K3_MMA | K3_STORE>(qr, qi, vre, vim, n_inputs, n_spectra, n_ch, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K3's body: registers and local (spill) bytes, and the blocks of its
// persistent grid for a shape.
extern "C" int xcorr_fused_attributes(int n_inputs, int n_spectra, int n_ch, int* regs,
                                      int* local_bytes, int* blocks) {
  Geo g;
  if (!k3_geometry(n_inputs, n_spectra, n_ch, g)) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes at{};
  cudaError_t err = cudaFuncGetAttributes(&at, xcorr_fused_kernel<K3_ALL>);
  if (err == cudaSuccess) err = k3_grid<K3_ALL>(g.n_items, *blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = at.numRegs;
  *local_bytes = static_cast<int>(at.localSizeBytes);
  return 0;
}

// K5b: turned xt [C, 2I, S] int8 (4-byte aligned) -> vre, vim [C, I, I]
// f32. Takes any I >= 1, S % 8 == 0 with S <= 1024, and C % 8 == 0; refuses
// any other shape with cudaErrorInvalidValue, before any launch.
extern "C" int xcorr_turned_launch(const void* xt, void* vre, void* vim, int n_inputs,
                                   int n_spectra, int n_ch, void* stream) {
  return k5b_launch<K5B_ALL>(xt, vre, vim, n_inputs, n_spectra, n_ch, stream);
}

// One of K5b's stage stops, `stages` a mask of K5B_COPY (1), K5B_MMA (2)
// and K5B_STORE (4) other than K5B_ALL: as xcorr_turned_launch, into vre,
// vim as the stop leaves them (see K5B_ALL).
extern "C" int xcorr_turned_stop_launch(const void* xt, void* vre, void* vim, int n_inputs,
                                        int n_spectra, int n_ch, int stages, void* stream) {
  switch (stages) {
    case K5B_COPY:
      return k5b_launch<K5B_COPY>(xt, vre, vim, n_inputs, n_spectra, n_ch, stream);
    case K5B_MMA:
      return k5b_launch<K5B_MMA>(xt, vre, vim, n_inputs, n_spectra, n_ch, stream);
    case K5B_STORE:
      return k5b_launch<K5B_STORE>(xt, vre, vim, n_inputs, n_spectra, n_ch, stream);
    case K5B_COPY | K5B_MMA:
      return k5b_launch<K5B_COPY | K5B_MMA>(xt, vre, vim, n_inputs, n_spectra, n_ch, stream);
    case K5B_MMA | K5B_STORE:
      return k5b_launch<K5B_MMA | K5B_STORE>(xt, vre, vim, n_inputs, n_spectra, n_ch, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K5b's body and the plan a shape takes: out[0..7] = registers, local
// (spill) bytes, blocks of the persistent grid, plan (1 two slots, 2 one
// slot, 3 streaming), samples a stage, items a channel, shared-memory bytes,
// and 1 where a channel's rows arrive by TMA (from a 16-byte aligned base).
extern "C" int xcorr_turned_attributes(int n_inputs, int n_spectra, int n_ch, int* out) {
  K5bPlan p;
  if (!k5b_plan(n_inputs, n_spectra, n_ch, smem_optin(), p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaFuncAttributes at{};
  int blocks = 0;
  cudaError_t err = cudaFuncGetAttributes(&at, xcorr_turned_kernel<K5B_ALL>);
  if (err == cudaSuccess) err = k5b_grid<K5B_ALL>(p, blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int v[8] = {at.numRegs, static_cast<int>(at.localSizeBytes), blocks, p.kind, p.kc,
                    p.items_per_ch, p.smem, k5b_tma_fits(p)};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}
