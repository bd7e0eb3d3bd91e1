// K3 and K5b: visibility grams for Hopper (sm_90a), int8 tensor cores.
//
// Replaces the TPU kernels dpdk_dc_sand_tpu/ops/xcorr_pallas.py:
//   _kernel_fused (behind correlate_planes_fused, K3): reads the F planes
//     [A, P, S, C] int8 as they are and turns them on chip;
//   _kernel (behind correlate_turned_fused, K5b): reads the turned
//     [C, 2I, S] int8 layout that the corner turn (K5a) writes.
// Both compute, per channel c, with Y = [re rows; im rows] of the I = A*P
// inputs (ordered a*P + p) over S samples and G = Y*Y^T:
//   V_re = G11 + G22,   V_im = G21 - G12,   each [C, I, I] f32.
//
// Exactness. Products are s8*s8 on the tensor cores (mma.sync m16n8k32) with
// s32 accumulation, so every gram block is the exact integer sum. V_re is
// accumulated as one s32 sum (G11 + G22, exact) and V_im as the s32
// difference of two exact sums; each is converted to f32 once. IEEE
// conversion and addition are correctly rounded, so this equals the plain
// version's f32 G11 + G22 (each term an exact integer below 2^24 for
// S <= 1024) bit for bit. Nothing here depends on the summation order.
//
// Design. A block owns 32 consecutive channels and one 16 x 16 tile (ti, tj)
// of the I x I output, ti <= tj: V_re is symmetric and V_im antisymmetric,
// so an off-diagonal tile also writes its mirror (V_im mirrored as the s32
// difference the other way round, so a zero stays +0). Per 32-sample K step
// the block stages, for each of its channels, the 64 rows it needs
// (re and im of the i tile and of the j tile) as [row][32 samples] int8 in
// shared memory; that one tile is the row-major A operand and the
// column-major B operand of the mma. K3 loads 32-byte channel runs of the
// planes and turns each 4-sample x 4-channel byte block in registers; K5b
// loads the turned rows directly. Each thread issues all 32 of its word
// loads of a K step at once, so a K step waits on one L2 round trip rather
// than eight. (Holding the next step's words in registers across the mma
// spilled at the 128-register cap and made K5b 2.6x slower on the card.)
// Each of the 16 warps keeps the s32 accumulators of two channels (V_re,
// G21, G12: 48 registers a thread).
//
// What bounds it on the card. At the flagship (I = 160, S = 256,
// C = 32768) it writes 6.7 GB of visibilities and reads 2.7 GB of planes
// (~2.8 ms at 3.35 TB/s) for 0.47 T MACs after the symmetry (~0.5 ms of
// tensor-core time). Each block reloads its 64 rows for every output tile,
// so the input passes through L2 about 11 times (~29 GB). On an H100 SXM
// K3 takes ~16 ms there, and its time grows with S: the bound is the K loop,
// where one 512-thread block per SM (128 registers a thread) waits on an L2
// round trip every step. A cp.async double buffer is the next step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int CB = 32;              // channels per block
constexpr int CPW = CB / WARPS;     // channels per warp
constexpr int T = 16;               // output tile edge
constexpr int ROWS = 4 * T;         // staged rows: re_i, im_i, re_j, im_j
constexpr int SK = 32;              // samples per K step (the mma depth)
constexpr int RW = SK / 4 + 4;      // words per staged row (padded: 12)
constexpr int CS = ROWS * RW + 1;   // words per staged channel (odd)
constexpr size_t SMEM_BYTES = sizeof(uint32_t) * CB * CS;
constexpr int WORDS = CB * ROWS * (SK / 4) / THREADS;  // staged words a thread: 32

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

// Staged row slot -> (which plane: 0 re / 1 im, input index).
__device__ __forceinline__ void slot_row(int slot, int i0, int j0, int& reim, int& inp) {
  const int g = slot / T, rr = slot % T;
  reim = g & 1;
  inp = (g < 2 ? i0 : j0) + rr;
}

// K3 staging: planes [I][S][C] (input i = a*P + p), 32-byte channel runs.
// Unit u of a thread: 4 samples x 4 channels of one staged row.
struct PlaneUnit {
  int cg, sg, slot;
  __device__ __forceinline__ explicit PlaneUnit(int u)
      : cg(u % (CB / 4)), sg((u / (CB / 4)) % (SK / 4)), slot(u / (CB / 4 * SK / 4)) {}
};

__device__ __forceinline__ void load_planes(uint32_t (&buf)[WORDS], const int8_t* qr,
                                            const int8_t* qi, int n_in, int n_s, int n_ch,
                                            int c0, int s0, int i0, int j0) {
#pragma unroll
  for (int k = 0; k < WORDS / 4; ++k) {
    const PlaneUnit u(threadIdx.x + k * THREADS);
    int reim, inp;
    slot_row(u.slot, i0, j0, reim, inp);
    const int c = c0 + 4 * u.cg;
    const bool row_ok = inp < n_in && c < n_ch;
    const int8_t* plane = reim ? qi : qr;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int s = s0 + 4 * u.sg + q;
      buf[4 * k + q] = (row_ok && s < n_s)
                           ? __ldg(reinterpret_cast<const uint32_t*>(
                                 plane + (static_cast<long long>(inp) * n_s + s) * n_ch + c))
                           : 0u;
    }
  }
}

__device__ __forceinline__ void store_planes(uint32_t* sm, const uint32_t (&buf)[WORDS]) {
#pragma unroll
  for (int k = 0; k < WORDS / 4; ++k) {
    const PlaneUnit u(threadIdx.x + k * THREADS);
    uint32_t t[4];
    transpose4x4(&buf[4 * k], t);
#pragma unroll
    for (int j = 0; j < 4; ++j) sm[(4 * u.cg + j) * CS + u.slot * RW + u.sg] = t[j];
  }
}

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

template <bool kTurned>
__global__ void __launch_bounds__(THREADS)
    xcorr_kernel(const int8_t* __restrict__ qr, const int8_t* __restrict__ qi,
                 float* __restrict__ vre, float* __restrict__ vim, int n_in, int n_s,
                 int n_ch) {
  extern __shared__ __align__(16) uint32_t sm[];
  const int n_t = (n_in + T - 1) / T;
  int ti = 0, p = blockIdx.x;
  while (p >= n_t - ti) {
    p -= n_t - ti;
    ++ti;
  }
  const int tj = ti + p;
  const int i0 = ti * T, j0 = tj * T;
  const int c0 = blockIdx.y * CB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;

  // [channel][n tile][fragment]: V_re (G11 + G22), G21, G12.
  int acc_re[CPW][2][4] = {}, acc_ir[CPW][2][4] = {}, acc_ri[CPW][2][4] = {};

  for (int s0 = 0; s0 < n_s; s0 += SK) {
    // Issued before the barrier: they overlap the slower warps' mma.
    uint32_t buf[WORDS];
    if (kTurned) {
      load_turned(buf, qr, n_in, n_s, n_ch, c0, s0, i0, j0);
    } else {
      load_planes(buf, qr, qi, n_in, n_s, n_ch, c0, s0, i0, j0);
    }
    __syncthreads();  // the previous step's mma reads are done
    if (kTurned) {
      store_turned(sm, buf);
    } else {
      store_planes(sm, buf);
    }
    __syncthreads();
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

template <bool kTurned>
cudaError_t launch(const int8_t* a, const int8_t* b, float* vre, float* vim, int n_in,
                   int n_s, int n_ch, cudaStream_t stream) {
  if (n_in <= 0 || n_s <= 0 || n_ch <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      xcorr_kernel<kTurned>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return err;
  const int n_t = (n_in + T - 1) / T;
  dim3 grid(n_t * (n_t + 1) / 2, (n_ch + CB - 1) / CB);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  xcorr_kernel<kTurned><<<grid, THREADS, SMEM_BYTES, stream>>>(a, b, vre, vim, n_in, n_s,
                                                              n_ch);
  return cudaGetLastError();
}

}  // namespace

// K3: planes qr, qi [A, P, S, C] int8 (C % 4 == 0) -> vre, vim [C, I, I] f32.
extern "C" int xcorr_fused_launch(const void* qr, const void* qi, void* vre, void* vim,
                                  int n_inputs, int n_spectra, int n_ch, void* stream) {
  if (n_ch % 4) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch<false>(
      static_cast<const int8_t*>(qr), static_cast<const int8_t*>(qi),
      static_cast<float*>(vre), static_cast<float*>(vim), n_inputs, n_spectra, n_ch,
      static_cast<cudaStream_t>(stream)));
}

// K5b: turned xt [C, 2I, S] int8 (S % 4 == 0) -> vre, vim [C, I, I] f32.
extern "C" int xcorr_turned_launch(const void* xt, void* vre, void* vim, int n_inputs,
                                   int n_spectra, int n_ch, void* stream) {
  if (n_spectra % 4) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch<true>(
      static_cast<const int8_t*>(xt), nullptr, static_cast<float*>(vre),
      static_cast<float*>(vim), n_inputs, n_spectra, n_ch, static_cast<cudaStream_t>(stream)));
}
