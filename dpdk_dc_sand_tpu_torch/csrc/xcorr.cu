// K3 and K5b: visibility grams for Hopper (sm_90a), int8 tensor cores.
//
// Both compute, per channel c, with Y = [re rows; im rows] of the I = A*P
// inputs (ordered a*P + p) over S samples and G = Y*Y^T:
//   V_re = G11 + G22,   V_im = G21 - G12,   each [C, I, I] f32.
//
// Exactness. Products are s8*s8 on the tensor cores (mma.sync m16n8k32) with
// s32 accumulation, so every gram block is the exact integer sum. V_re is
// accumulated as one s32 sum (G11 + G22, exact) and V_im as the s32
// difference of two exact sums, G21 and G12 kept apart (negating an int8
// operand to merge them would overflow at -128); each is converted to f32
// once. IEEE conversion and addition are correctly rounded, so this equals
// the plain version's f32 G11 + G22 (each term an exact integer below 2^24
// for S <= 1024) bit for bit. Nothing here depends on the summation order.
// Both kernels own 16 x 16 tiles (ti, tj) of the I x I output with ti <= tj:
// V_re is symmetric and V_im antisymmetric, so an off-diagonal tile also
// writes its mirror (V_im mirrored as the s32 difference the other way
// round, so a zero stays +0).
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
// the corner turn (K5a) writes. A block owns 32 consecutive channels and one
// 16 x 16 tile; per 32-sample K step it stages, for each of its channels,
// the 64 rows it needs as [row][32 samples] int8 in shared memory, the
// row-major A operand and the column-major B operand of the mma, loading
// each row word directly. Each thread issues all 32 of its word loads of a K
// step at once, so a K step waits on one L2 round trip rather than eight.
// (Holding the next step's words in registers across the mma spilled at the
// 128-register cap and made K5b 2.6x slower on the card.) Each of the 16
// warps keeps the s32 accumulators of two channels.

#include <climits>
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

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int CPW = CB / WARPS;     // channels per warp
constexpr int RW = SK / 4 + 4;      // words per staged row (padded: 12)
constexpr int CS = ROWS * RW + 1;   // words per staged channel (odd)

// Staged row slot -> (which plane: 0 re / 1 im, input index).
__device__ __forceinline__ void slot_row(int slot, int i0, int j0, int& reim, int& inp) {
  const int g = slot / T, rr = slot % T;
  reim = g & 1;
  inp = (g < 2 ? i0 : j0) + rr;
}

constexpr int WORDS = CB * ROWS * (SK / 4) / THREADS;  // staged words a thread: 32
constexpr size_t K5B_SMEM = sizeof(uint32_t) * CB * CS;

// K5b staging: turned [C][2I][S], rows contiguous in samples; one word a unit.
struct TurnedUnit {
  int sg, slot, ch;
  __device__ __forceinline__ explicit TurnedUnit(int u)
      : sg(u % (SK / 4)), slot((u / (SK / 4)) % ROWS), ch(u / (SK / 4 * ROWS)) {}
};

__device__ __forceinline__ void load_turned(uint32_t (&buf)[WORDS], const int8_t* xt, int n_in,
                                            int n_s, int n_ch, int c0, int s0, int i0,
                                            int j0) {
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {
    const TurnedUnit u(threadIdx.x + k * THREADS);
    int reim, inp;
    slot_row(u.slot, i0, j0, reim, inp);
    const int c = c0 + u.ch, s = s0 + 4 * u.sg;
    uint32_t v = 0u;
    if (c < n_ch && inp < n_in && s < n_s) {
      const long long row = static_cast<long long>(c) * 2 * n_in + reim * n_in + inp;
      v = __ldg(reinterpret_cast<const uint32_t*>(xt + row * n_s + s));
    }
    buf[k] = v;
  }
}

__device__ __forceinline__ void store_turned(uint32_t* sm, const uint32_t (&buf)[WORDS]) {
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {
    const TurnedUnit u(threadIdx.x + k * THREADS);
    sm[u.ch * CS + u.slot * RW + u.sg] = buf[k];
  }
}

// The K step's mma for one warp: its CPW channels of the turned buffer.
__device__ __forceinline__ void mma_step(const uint32_t* sm, int warp, int gid, int tig,
                                         int (&acc_re)[CPW][2][4], int (&acc_ir)[CPW][2][4],
                                         int (&acc_ri)[CPW][2][4]) {
#pragma unroll
  for (int k = 0; k < CPW; ++k) {
    const uint32_t* ch = sm + (warp * CPW + k) * CS;
    uint32_t a[2][4];  // re_i, im_i
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const uint32_t* r = ch + (g * T + gid) * RW + tig;
      a[g][0] = r[0];
      a[g][1] = r[8 * RW];
      a[g][2] = r[4];
      a[g][3] = r[8 * RW + 4];
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const uint32_t* rj = ch + (2 * T + nt * 8 + gid) * RW + tig;  // re_j
      const uint32_t* ij = rj + T * RW;                             // im_j
      const uint32_t br0 = rj[0], br1 = rj[4], bi0 = ij[0], bi1 = ij[4];
      mma_s8(acc_re[k][nt], a[0], br0, br1);
      mma_s8(acc_re[k][nt], a[1], bi0, bi1);
      mma_s8(acc_ir[k][nt], a[1], br0, br1);
      mma_s8(acc_ri[k][nt], a[0], bi0, bi1);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    xcorr_turned_kernel(const int8_t* __restrict__ xt, float* __restrict__ vre,
                        float* __restrict__ vim, int n_in, int n_s, int n_ch) {
  extern __shared__ __align__(16) uint32_t sm[];
  const int n_t = (n_in + T - 1) / T;
  int ti, tj;
  tile_of(blockIdx.x, n_t, ti, tj);
  const int i0 = ti * T, j0 = tj * T;
  const int c0 = blockIdx.y * CB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;

  // [channel][n tile][fragment]: V_re (G11 + G22), G21, G12.
  int acc_re[CPW][2][4] = {}, acc_ir[CPW][2][4] = {}, acc_ri[CPW][2][4] = {};

  for (int s0 = 0; s0 < n_s; s0 += SK) {
    // Issued before the barrier: they overlap the slower warps' mma.
    uint32_t buf[WORDS];
    load_turned(buf, xt, n_in, n_s, n_ch, c0, s0, i0, j0);
    __syncthreads();  // the previous step's mma reads are done
    store_turned(sm, buf);
    __syncthreads();
    mma_step(sm, warp, gid, tig, acc_re, acc_ir, acc_ri);
  }

  const bool mirror = ti != tj;
#pragma unroll
  for (int k = 0; k < CPW; ++k) {
    const int c = c0 + warp * CPW + k;
    if (c >= n_ch) continue;
    const long long base = static_cast<long long>(c) * n_in * n_in;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + gid + (e >= 2 ? 8 : 0);
        const int j = j0 + nt * 8 + 2 * tig + (e & 1);
        if (i >= n_in || j >= n_in) continue;
        const int re = acc_re[k][nt][e], ir = acc_ir[k][nt][e], ri = acc_ri[k][nt][e];
        vre[base + static_cast<long long>(i) * n_in + j] = static_cast<float>(re);
        vim[base + static_cast<long long>(i) * n_in + j] = static_cast<float>(ir - ri);
        if (mirror) {
          vre[base + static_cast<long long>(j) * n_in + i] = static_cast<float>(re);
          vim[base + static_cast<long long>(j) * n_in + i] = static_cast<float>(ri - ir);
        }
      }
    }
  }
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

// K5b: turned xt [C, 2I, S] int8 (S % 4 == 0) -> vre, vim [C, I, I] f32.
extern "C" int xcorr_turned_launch(const void* xt, void* vre, void* vim, int n_inputs,
                                   int n_spectra, int n_ch, void* stream) {
  if (n_spectra % 4) return static_cast<int>(cudaErrorInvalidValue);
  if (n_inputs <= 0 || n_spectra <= 0 || n_ch <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(xcorr_turned_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(K5B_SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_t = (n_inputs + T - 1) / T;
  dim3 grid(n_t * (n_t + 1) / 2, (n_ch + CB - 1) / CB);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  xcorr_turned_kernel<<<grid, THREADS, K5B_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xt), static_cast<float*>(vre), static_cast<float*>(vim),
      n_inputs, n_spectra, n_ch);
  return static_cast<int>(cudaGetLastError());
}
