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
