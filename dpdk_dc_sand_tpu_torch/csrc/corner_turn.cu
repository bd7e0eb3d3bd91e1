// K4 = K5a and K8: int8 corner turn for Hopper (sm_90a).
//
// One tile transpose of R = A*P*S rows x C channels per plane, for one or
// two planes (the launch's `planes`, the grid's z extent):
//   out[c, z*R + r] = plane_z[r, c],   r = (a*P + p)*S + s,
// with output rows of planes*R bytes.
//
// Two planes (re, im) replace the TPU kernels
// dpdk_dc_sand_tpu/ops/corner_turn.py:_kernel_split and _kernel_full (behind
// corner_turn_planes, K4) and _kernel_x (behind corner_turn_planes_x, K5a).
// Both write the same bytes: [C, 2A, P*S] (rows reim*A + a, lanes p*S + s)
// for the B stage and [C, 2*A*P, S] (rows reim*A*P + a*P + p) for the X
// stage; the wrapper views the output either way.
//
// One plane replaces _kernel_plane_native (behind corner_turn_plane_native,
// K8): the F kernel's native plane [A, P, S, rows, lanes] (channel
// k = row*lanes + lane, row-major) is the same bytes as its [A, P, S, C]
// output, so the native turn [C, A, P*S] is this transpose of one plane.
//
// Design. Each block turns a 64-row x 64-channel tile of one plane. A thread
// loads a 4-row x 4-channel byte block as four 4-byte words (neighbouring
// threads on neighbouring channel words: 32-byte row segments), transposes it
// in registers with __byte_perm, and writes four words (4 rows of one channel)
// into a channel-major shared tile; the store phase then writes 64 contiguous
// row bytes per channel as 4-byte words. Ragged edges (C or R not a multiple
// of 4 or of the tile) take byte loads and stores with masks.
//
// What bounds it on the card: bytes. It reads and writes each plane byte once
// (5.4 GB for both flagship planes, ~1.6 ms at 3.35 TB/s; 2.7 GB, ~0.8 ms,
// for one) and does no arithmetic.
//
// P1, ct_probe_kernel below: the corner-turn probe (replaces
// benchmarks/ct_kernel_probe.py:make_ct -> kernel of the JAX package,
// reached through pl.pallas_call at ct_kernel_probe.py:108). Two planes
// [A, P, S, C] in, tiled as the probe tiles them: block (cb, p, sb) owns
// c_blk channels x s_chunk spectra of one polarisation for every antenna
// (the TPU block's A rows), walking them a tile at a time through shared
// memory, since the TPU's whole A x s_chunk x c_blk block does not fit. The
// mode says how a tile is turned:
//   copy — no turn: out [2, A, P, S, C], the same tiles stored as loaded
//          (the tiling's own cost);
//   i8   — out [C, 2A, P*S] through a byte-wise shared tile (byte stores,
//          byte reads packed into words);
//   i32  — the same output through K4's word transpose (4x4 __byte_perm
//          blocks into a channel-major shared tile);
//   i8m  — the minor-antenna output [C, P*S, 2A], byte-wise: sub-tiles of
//          ss spectra x 2A antennas x c_blk channels in the output's order;
//   i8m2 — the same output word-wise: 4 antennas' words turned by
//          __byte_perm (A % 4 == 0).
// Bound by bytes, as K4: each plane byte read once and written once (2.68
// GB at A = 80, P = 2, S = 128, C = 32768: 0.80 ms at 3.35 TB/s).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;                // rows and channels per block
constexpr int THREADS = 256;            // one 4x4 byte block per thread
constexpr int SW = TILE / 4 + 1;        // words per shared channel row, padded

// Byte-transpose of a 4x4 block: in[q] byte j -> out[j] byte q.
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

__global__ void __launch_bounds__(THREADS)
    corner_turn_kernel(const int8_t* __restrict__ qr, const int8_t* __restrict__ qi,
                       int8_t* __restrict__ out, long long rows, int n_ch, int planes) {
  __shared__ uint32_t tile[TILE * SW];  // [channel][row word]
  const int8_t* plane = blockIdx.z ? qi : qr;
  const long long r0 = static_cast<long long>(blockIdx.y) * TILE;
  const int c0 = blockIdx.x * TILE;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // A warp covers 8 channel words x 4 row groups: four 32-byte segments
  // per load, and conflict-free shared stores (bank 4*cg + rg).
  const int cg = lane % 8 + 8 * (warp % 2);
  const int rg = lane / 8 + 4 * (warp / 2);
  const int c = c0 + 4 * cg;
  const bool word_cols = (n_ch % 4 == 0) && (c + 3 < n_ch);

  uint32_t in[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const long long r = r0 + 4 * rg + q;
    const int8_t* src = plane + r * n_ch + c;
    if (r < rows && word_cols) {
      in[q] = __ldg(reinterpret_cast<const uint32_t*>(src));
    } else {
      uint32_t v = 0;
      for (int j = 0; j < 4; ++j) {
        if (r < rows && c + j < n_ch) {
          v |= static_cast<uint32_t>(static_cast<uint8_t>(src[j])) << (8 * j);
        }
      }
      in[q] = v;
    }
  }
  uint32_t t[4];
  transpose4x4(in, t);
#pragma unroll
  for (int j = 0; j < 4; ++j) tile[(4 * cg + j) * SW + rg] = t[j];
  __syncthreads();

  // Store: channel row ch of the tile -> 64 row bytes of out[c0 + ch].
  const long long out_stride = planes * rows;
  const bool word_rows = rows % 4 == 0;
  for (int i = tid; i < TILE * (TILE / 4); i += THREADS) {
    const int w = i % (TILE / 4), ch = i / (TILE / 4);
    const long long r = r0 + 4 * w;
    if (c0 + ch >= n_ch || r >= rows) continue;
    const uint32_t v = tile[ch * SW + w];
    int8_t* dst = out + static_cast<long long>(c0 + ch) * out_stride + blockIdx.z * rows + r;
    if (word_rows) {
      *reinterpret_cast<uint32_t*>(dst) = v;
    } else {
      for (int j = 0; j < 4 && r + j < rows; ++j) dst[j] = static_cast<int8_t>(v >> (8 * j));
    }
  }
}

// ---------------------------------------------------------------------------
// P1: the corner-turn probe
// ---------------------------------------------------------------------------
constexpr int P_COPY = 0, P_I8 = 1, P_I32 = 2, P_I8M = 3, P_I8M2 = 4;
constexpr size_t MAX_SMEM = 232448;  // what one block may use on sm_90
constexpr size_t SUB_SMEM = 98304;   // the minor-antenna modes' sub-tile budget

struct ProbeParams {
  const int8_t* qr;  // [A, P, S, C]
  const int8_t* qi;
  int8_t* out;
  int n_ants, n_pols, n_spectra, n_ch, c_blk, s_chunk;
  int ss;   // spectra a sub-tile of the minor-antenna modes
  int rsw;  // their shared row of one channel, in words (odd)
};

__device__ __forceinline__ uint32_t ldw(const int8_t* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ void stw(int8_t* p, uint32_t v) {
  *reinterpret_cast<uint32_t*>(p) = v;
}

template <int MODE>
__global__ void __launch_bounds__(THREADS) ct_probe_kernel(ProbeParams p) {
  extern __shared__ __align__(16) unsigned char sm[];
  uint32_t* smw = reinterpret_cast<uint32_t*>(sm);
  const int pp = blockIdx.y;
  const int c0 = blockIdx.x * p.c_blk, s0 = blockIdx.z * p.s_chunk;
  const int tid = threadIdx.x, A = p.n_ants, k2 = 2 * A;
  const int cw = p.c_blk / 4, sw = p.s_chunk / 4;  // channel / spectrum words of a tile
  const long long C = p.n_ch, ps = static_cast<long long>(p.n_pols) * p.n_spectra;
  // Plane z's row (a, pp, s) from channel c0.
  auto row = [&](int z, int a, int s) {
    return (z ? p.qi : p.qr) + ((static_cast<long long>(a) * p.n_pols + pp) * p.n_spectra + s) * C +
           c0;
  };
  if constexpr (MODE == P_COPY || MODE == P_I8 || MODE == P_I32) {
    for (int za = 0; za < k2; ++za) {
      const int z = za / A, a = za % A;
      const int8_t* src = row(z, a, s0);
      if constexpr (MODE == P_COPY) {
        for (int i = tid; i < p.s_chunk * cw; i += THREADS) {
          smw[i] = ldw(src + (i / cw) * C + 4 * (i % cw));
        }
        __syncthreads();
        int8_t* dst = p.out + (static_cast<long long>(z) * A * ps +
                               (static_cast<long long>(a) * p.n_pols + pp) * p.n_spectra + s0) *
                                  C + c0;
        for (int i = tid; i < p.s_chunk * cw; i += THREADS) {
          stw(dst + (i / cw) * C + 4 * (i % cw), smw[i]);
        }
      } else {
        // out[c, za, pp*S + s0 + s] for the tile's channels c.
        int8_t* dst = p.out + (static_cast<long long>(c0) * k2 + za) * ps +
                      static_cast<long long>(pp) * p.n_spectra + s0;
        const long long ostride = k2 * ps;  // one output channel
        if constexpr (MODE == P_I8) {
          const int rs = p.c_blk + 1;  // odd byte stride: a warp's column reads hit 32 banks
          for (int i = tid; i < p.s_chunk * cw; i += THREADS) {
            const int s = i / cw, w = i % cw;
            const uint32_t v = ldw(src + s * C + 4 * w);
#pragma unroll
            for (int j = 0; j < 4; ++j) sm[s * rs + 4 * w + j] = static_cast<uint8_t>(v >> (8 * j));
          }
          __syncthreads();
          for (int i = tid; i < p.c_blk * sw; i += THREADS) {
            const int c = i / sw, g = i % sw;
            uint32_t v = 0;
#pragma unroll
            for (int q = 0; q < 4; ++q) v |= static_cast<uint32_t>(sm[(4 * g + q) * rs + c]) << (8 * q);
            stw(dst + c * ostride + 4 * g, v);
          }
        } else {
          // K4's turn: a warp covers 8 channel words x 4 row groups, so its
          // loads are 32-byte row segments and its shared stores conflict-free.
          const int sw1 = sw + 1;
          for (int i = tid; i < sw * cw; i += THREADS) {
            const int lane = i % 32, wi = i / 32;
            const int cg = lane % 8 + 8 * (wi % (cw / 8));
            const int rg = lane / 8 + 4 * (wi / (cw / 8));
            uint32_t in[4], t[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) in[q] = ldw(src + (4 * rg + q) * C + 4 * cg);
            transpose4x4(in, t);
#pragma unroll
            for (int j = 0; j < 4; ++j) smw[(4 * cg + j) * sw1 + rg] = t[j];
          }
          __syncthreads();
          for (int i = tid; i < p.c_blk * sw; i += THREADS) {
            const int c = i / sw, g = i % sw;
            stw(dst + c * ostride + 4 * g, smw[c * sw1 + g]);
          }
        }
      }
      __syncthreads();  // the next tile overwrites the shared tile
    }
  } else {
    // out[c, pp*S + s, za]: sub-tiles of ss spectra, shared [c_blk][ss*2A]
    // in the output's order (rows of rsw words), stored row by row.
    const int rsb = 4 * p.rsw, rowb = p.ss * k2;
    for (int s1 = 0; s1 < p.s_chunk; s1 += p.ss) {
      if constexpr (MODE == P_I8M) {
        for (int i = tid; i < k2 * p.ss * cw; i += THREADS) {
          const int w = i % cw, s = (i / cw) % p.ss, za = i / cw / p.ss;
          const uint32_t v = ldw(row(za / A, za % A, s0 + s1 + s) + 4 * w);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            sm[(4 * w + j) * rsb + s * k2 + za] = static_cast<uint8_t>(v >> (8 * j));
          }
        }
      } else {
        for (int i = tid; i < (k2 / 4) * p.ss * cw; i += THREADS) {
          const int w = i % cw, s = (i / cw) % p.ss, za = 4 * (i / cw / p.ss);
          uint32_t in[4], t[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            in[q] = ldw(row((za + q) / A, (za + q) % A, s0 + s1 + s) + 4 * w);
          }
          transpose4x4(in, t);
#pragma unroll
          for (int j = 0; j < 4; ++j) smw[(4 * w + j) * p.rsw + (s * k2 + za) / 4] = t[j];
        }
      }
      __syncthreads();
      int8_t* dst = p.out + (static_cast<long long>(c0) * ps + static_cast<long long>(pp) *
                                                                  p.n_spectra + s0 + s1) * k2;
      const long long ostride = ps * k2;
      if (k2 % 4 == 0) {
        const int rw = rowb / 4;
        for (int i = tid; i < p.c_blk * rw; i += THREADS) {
          const int c = i / rw, w = i % rw;
          stw(dst + c * ostride + 4 * w, smw[c * p.rsw + w]);
        }
      } else {
        for (int i = tid; i < p.c_blk * rowb; i += THREADS) {
          const int c = i / rowb, e = i % rowb;
          dst[c * ostride + e] = static_cast<int8_t>(sm[c * rsb + e]);
        }
      }
      __syncthreads();
    }
  }
}

template <int MODE>
cudaError_t launch_probe(const ProbeParams& p, size_t bytes, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(ct_probe_kernel<MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  dim3 grid(p.n_ch / p.c_blk, p.n_pols, p.n_spectra / p.s_chunk);
  ct_probe_kernel<MODE><<<grid, THREADS, bytes, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// planes = 2 turns (qr, qi) into out [C, 2R]; planes = 1 turns qr alone
// into out [C, R] (qi is not read).
extern "C" int corner_turn_launch(const void* qr, const void* qi, void* out,
                                  long long rows, int n_ch, int planes, void* stream) {
  if (rows <= 0 || n_ch <= 0 || (rows + TILE - 1) / TILE > 65535 ||
      (planes != 1 && planes != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid((n_ch + TILE - 1) / TILE, static_cast<unsigned>((rows + TILE - 1) / TILE), planes);
  corner_turn_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qr), static_cast<const int8_t*>(qi),
      static_cast<int8_t*>(out), rows, n_ch, planes);
  return static_cast<int>(cudaGetLastError());
}

// P1: qr, qi [A, P, S, C] int8 (4-byte aligned) -> out by mode (0 copy
// [2, A, P, S, C]; 1 i8, 2 i32 [C, 2A, P*S]; 3 i8m, 4 i8m2 [C, P*S, 2A]),
// tiles of c_blk channels x s_chunk spectra: C % c_blk == 0, S % s_chunk ==
// 0, c_blk % 32 == 0, s_chunk % 16 == 0, and A % 4 == 0 for i8m2.
extern "C" int ct_probe_launch(const void* qr, const void* qi, void* out, int n_ants,
                               int n_pols, int n_spectra, int n_ch, int mode, int c_blk,
                               int s_chunk, void* stream) {
  if (n_ants < 1 || n_pols < 1 || n_pols > 65535 || c_blk < 32 || c_blk % 32 ||
      s_chunk < 16 || s_chunk % 16 || n_ch % c_blk || n_spectra % s_chunk ||
      n_spectra / s_chunk > 65535 || mode < P_COPY || mode > P_I8M2 ||
      (mode == P_I8M2 && n_ants % 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ProbeParams p{static_cast<const int8_t*>(qr), static_cast<const int8_t*>(qi),
                static_cast<int8_t*>(out), n_ants, n_pols, n_spectra, n_ch, c_blk, s_chunk,
                s_chunk, 0};
  size_t bytes;
  if (mode == P_COPY) {
    bytes = static_cast<size_t>(s_chunk) * c_blk;
  } else if (mode == P_I8) {
    bytes = static_cast<size_t>(s_chunk) * (c_blk + 1);
  } else if (mode == P_I32) {
    bytes = 4 * static_cast<size_t>(c_blk) * (s_chunk / 4 + 1);
  } else {
    // The most spectra (s_chunk halved while even) whose sub-tile fits.
    for (;;) {
      p.rsw = ((p.ss * 2 * n_ants + 3) / 4) | 1;
      bytes = 4 * static_cast<size_t>(c_blk) * p.rsw;
      if (bytes <= SUB_SMEM || p.ss % 2) break;
      p.ss /= 2;
    }
  }
  if (bytes > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (mode) {
    case P_COPY: err = launch_probe<P_COPY>(p, bytes, st); break;
    case P_I8: err = launch_probe<P_I8>(p, bytes, st); break;
    case P_I32: err = launch_probe<P_I32>(p, bytes, st); break;
    case P_I8M: err = launch_probe<P_I8M>(p, bytes, st); break;
    default: err = launch_probe<P_I8M2>(p, bytes, st); break;
  }
  return static_cast<int>(err);
}
