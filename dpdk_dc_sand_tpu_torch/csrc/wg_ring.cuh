// The Hopper (sm_90a) machinery of the port's wgmma bodies, shared by K1's
// (csrc/fengine_ct.cu: the DFT pass's k1_dft_wg_kernel, the three-pass
// route's k1_stage_a_wg_kernel and k1_stage_b_wg_kernel) and K7's
// (csrc/fengine_dit.cu: dit_stage_b_kernel): mbarriers, TMA boxes of 2-D
// tensor maps (128-byte swizzle), wgmma descriptors and wrappers (both
// operands from shared memory), the warp-specialised ring of the
// three-pass bodies (one producer thread, two consumer warpgroups, TP_STAGES
// slots of TP_SLOT bytes, a full and an empty mbarrier a slot) and the
// persistent tile walk. Every name is local to the including source.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

constexpr int WG_THREADS = 384;      // the producer warpgroup, then two consumer warpgroups
constexpr int WG_ALIGN = 1024;       // a 128-byte-swizzle atom: 8 rows x 128 bytes
constexpr int WG_ROW = 128;          // bytes a staged row: 64 bf16
constexpr int WG_PRODUCER_REGS = 40, WG_CONSUMER_REGS = 232;

// The address of f32 element (row, col) of a staged box of 32 columns (128-
// byte rows, 16-byte chunks swizzled by row % 8).
__device__ __forceinline__ uint32_t wg_f32_at(uint32_t box, int row, int col) {
  return box + row * WG_ROW + ((((col >> 2) ^ row) & 7) << 4) + (col & 3) * 4;
}

__device__ __forceinline__ float2 wg_ld_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}

__device__ __forceinline__ void wg_mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void wg_mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void wg_mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void wg_mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nWG_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra WG_DONE;\nbra WG_WAIT;\nWG_DONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// A box of a 2-D tensor map (column x, row y) into shared dst, its bytes
// counted on bar.
__device__ __forceinline__ void wg_tma(uint32_t dst, const CUtensorMap* map, int x, int y,
                                       uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

// wgmma operand descriptors, 128-byte swizzle. K-major (rows of 64 K values,
// 8-row atoms 1024 bytes apart); MN-major (rows of 64 M values, one a K step
// of 1, 8-row atoms 1024 bytes apart along K; a 64-row M tile is one atom
// wide, so the other stride field is never used and is given the same 1024).
__device__ __forceinline__ uint64_t wg_desc_k(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint64_t wg_desc_mn(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N of this warpgroup's wgmma groups are in flight.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of d across a wgmma.
template <int R>
__device__ __forceinline__ void wg_hold(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The two consumer warpgroups' named barrier (id 1; 0 is __syncthreads).
__device__ __forceinline__ void wg_consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// One consumer warpgroup's named barrier (ids 2 and 3).
__device__ __forceinline__ void wg_warpgroup_sync(int cw) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + cw) : "memory");
}

// Generic-proxy shared-memory writes of this thread, seen by wgmma.
__device__ __forceinline__ void wg_proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64 x N f32, the warpgroup's fragment) = A * B (+ d where acc), bf16 from
// shared memory: A 64 x 16, K-major (TA = 0) or M-major (TA = 1); B N x 16,
// K-major.
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  template <int TA>
  static __device__ __forceinline__ void run(float (&d)[8], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1, %11, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(acc), "n"(TA));
  }
};

template <>
struct Wgmma<32> {
  template <int TA>
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, %19, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(acc), "n"(TA));
  }
};

template <>
struct Wgmma<64> {
  template <int TA>
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, %35, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(acc), "n"(TA));
  }
};

template <>
struct Wgmma<128> {
  template <int TA>
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, %67, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(acc), "n"(TA));
  }
};


// The ring's slot and phase, shared by the producer's and each consumer's walk.
struct WgRing {
  int slot = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next(int stages) {
    if (++slot == stages) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// The three-pass bodies' ring: TP_STAGES slots of TP_SLOT bytes, each six
// boxes of 64 rows x 128 bytes (128-byte swizzle), then a full and an empty
// mbarrier a slot.
constexpr int TP_BOX = 64 * WG_ROW;  // a box: 64 rows x 128 bytes
constexpr int TP_SLOT = 6 * TP_BOX;  // bytes a ring slot
constexpr int TP_STAGES = 4;         // ring slots (192 KB)
constexpr size_t TP_SMEM = static_cast<size_t>(TP_STAGES) * TP_SLOT + 2 * 8 * TP_STAGES + WG_ALIGN;

// A stage's tile t of the persistent walk: spectrum, row tile r, column tile
// c, columns fastest (stage A: n2 tiles of one k1 chunk; stage B: k2 tiles of
// one k1 tile), so the tiles running side by side share a spectrum's plane
// (or T) and one chunk's matrix rows in L2.
struct TpTile {
  int spec, r, c;
};

__device__ __forceinline__ TpTile tp_tile(int t, int n_c, int n_r) {
  TpTile w;
  w.c = t % n_c;
  t /= n_c;
  w.r = t % n_r;
  w.spec = t / n_r;
  return w;
}

// The ring's mbarriers, initialised by thread 0 before the block's first
// barrier: a slot's full mbarrier counts the producer's arrival and the
// box bytes, its empty one an arrival a consumer warpgroup.
__device__ __forceinline__ uint32_t tp_ring_init(unsigned char* smem, uint32_t& full,
                                                 uint32_t& empty) {
  const uint32_t ring = (smem_u32(smem) + WG_ALIGN - 1) & ~static_cast<uint32_t>(WG_ALIGN - 1);
  full = ring + TP_STAGES * TP_SLOT;
  empty = full + 8 * TP_STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < TP_STAGES; ++s) {
      wg_mbar_init(full + 8 * s, 1);
      wg_mbar_init(empty + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return ring;
}

// A consumer warpgroup's slots of an epilogue operand, one a warpgroup:
// waits for both, keeps its own (returned, its index in slot) and releases
// the other's once it has landed, so that the arrival counts toward this
// use of the slot.
__device__ __forceinline__ uint32_t tp_own_slot(WgRing& r, uint32_t ring, uint32_t full,
                                                uint32_t empty, int cw, int wt, int& slot) {
  uint32_t own = 0;
  for (int w = 0; w < 2; ++w, r.next(TP_STAGES)) {
    wg_mbar_wait(full + 8 * r.slot, r.phase);
    if (w == cw) {
      own = ring + r.slot * TP_SLOT;
      slot = r.slot;
    } else if (wt == 0) {
      wg_mbar_arrive(empty + 8 * r.slot);
    }
  }
  return own;
}

// cuTensorMapEncodeTiled, reached through the runtime (no link to libcuda).
PFN_cuTensorMapEncodeTiled wg_tensor_map_encoder() {
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

// A row-major [rows, cols] tensor of bf16 (or f32) as a 2-D map of boxes
// box_rows x 128 bytes (64 bf16, 32 f32), 128-byte swizzle; boxes past the
// edges read as zeros.
bool wg_map(CUtensorMap& m, const void* ptr, unsigned long long cols, unsigned long long rows,
            int box_rows, bool f32 = false) {
  const PFN_cuTensorMapEncodeTiled encode = wg_tensor_map_encoder();
  if (!encode) return false;
  const size_t item = f32 ? sizeof(float) : sizeof(__nv_bfloat16);
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * item};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(WG_ROW / item),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(&m, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned_to(const void* p, uintptr_t to) { return reinterpret_cast<uintptr_t>(p) % to == 0; }

// Launches a wgmma stage body, one persistent block an SM (at most one a
// tile), with smem bytes of dynamic shared memory (the ring's, or more).
template <typename K, typename Params, typename Maps>
cudaError_t launch_tp_wg(K kern, const Params& p, const Maps& maps, cudaStream_t stream,
                         size_t smem = TP_SMEM) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
    return err;
  }
  kern<<<std::min(p.n_tiles, sms), WG_THREADS, smem, stream>>>(p, maps);
  return cudaGetLastError();
}

// A wgmma stage body's view: out int[11] = registers a thread, local (spill)
// bytes a thread, threads a block, shared-memory bytes, tile rows, tile
// columns, K depth a slot, ring slots, blocks an SM, products a sum adds up
// before it joins its f32 master sum (the whole sum where the wgmmas chain),
// bytes a ring slot.
template <typename K>
int wg_stage_attributes(K kern, int rows, int cols, int group, void* out,
                        size_t smem = TP_SMEM) {
  cudaFuncAttributes a{};
  cudaError_t err = cudaFuncGetAttributes(&a, kern);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, WG_THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int v[11] = {a.numRegs, static_cast<int>(a.localSizeBytes), WG_THREADS,
                     static_cast<int>(smem), rows, cols, 64, TP_STAGES, per_sm, group,
                     TP_SLOT};
  std::copy(v, v + 11, static_cast<int*>(out));
  return 0;
}

}  // namespace
