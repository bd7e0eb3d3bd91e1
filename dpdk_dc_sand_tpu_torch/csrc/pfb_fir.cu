// K6: polyphase FIR for Hopper (sm_90a) — int8 or f32 frames in, f32 out.
//
// Replaces the TPU kernel dpdk_dc_sand_tpu/ops/pfb_pallas.py: _fir_kernel
// (reached from fir_pallas through pl.pallas_call). It computes
//   out[b, s, f] = sum_t x[b, s + t, f] * w[t, f],  s < n_frames - taps + 1,
// in f32 in tap order with every product and sum rounded on its own
// (__fmul_rn / __fadd_rn: no FMA contraction), as the plain version
// pfb_fir_reference does, so the two agree bit for bit.
//
// What bounds it on the card: bytes. At the flagship (160 streams x 271
// frames x 65536, 16 taps, int8) it must read 2.84 GB and write 10.74 GB of
// f32: 4.05 ms at 3.35 TB/s. The separate rounding costs two f32
// instructions a tap (no FMA), about 3 ms of issue over the card's 132 SMs,
// so the kernel has to keep loads, arithmetic and stores going at once, and
// every instruction that is neither counts.
//
// What held the first body back (a third of the byte floor). It
// kept each thread's 4 lanes of window and a ring of the last 16 frame rows
// in registers (float4 w[16] and ring[16]; about 155 registers, about 12
// warps an SM) and loaded one char4 a row straight from global memory,
// consumed in the same iteration; its pointers were not restrict, so no
// later row's load could pass the store of the row before: 1.5 KB in flight
// an SM, against the ~32 KB an SM needs at 3.35 TB/s and ~1 us of latency.
// And it guarded every tap and every output at run time.
//
// Design. A block owns a tile of 512 lanes (128 threads, 4 adjacent lanes
// each) and a run of RUN spectra of one stream. Its frame rows reach it
// through a ring in shared memory of stages() stages of ROWS rows, kept
// stages() - 1 stages ahead of the compute (32 KB a block, 30 KB of int8 or
// 24 KB of f32 in flight, three blocks an SM). Each thread fills its own
// lanes' slots and reads only what it filled, so the ring needs no block
// barrier. How it is filled is the wrapper's plan (ops/pfb_fir.py:
// _fir_plan), checked here:
//   async  — fft % 4 == 0 and a base aligned to 4 elements: each thread
//            copies its 4 lanes of a row with one cp.async (4 bytes of
//            int8, 16 bytes of f32 by cp.async.cg), one group a stage;
//   scalar — anything else (fft % 4 != 0, an unaligned base): each thread
//            loads its own lanes element by element into its ring slots.
// A TMA bulk copy of each row segment (one thread, an mbarrier a stage, a
// block barrier before each refill) was tried on the card and went: it
// tied with cp.async on f32 rows and lost on int8 rows, whose 512-byte
// segments need a barrier every 4 rows.
// The compute reads each row once from the ring (one conflict-free char4
// or float4 a thread), converts it to f32 once, and keeps the last MAXT
// rows (MAXT = 4, 8 or 16, the plan's register-ring depth) and its lanes'
// window in registers (no spill: chip_smoke.py phase 11 logs each body's
// registers and local bytes), so each product is one FMUL and one FADD and
// no row is converted twice. The spectrum loop is unrolled by MAXT so every
// register-ring index is a constant, and a whole chunk of MAXT outputs of a
// MAXT-tap pass runs with no row, tap or output guard: the guards of the
// unrolled loop cost about as many integer, compare and branch instructions
// as the f32 work.
// Stores are coalesced 16-byte streaming stores (st.global.cs) through
// restrict pointers. A launch runs one pass of at most MAXT taps; the
// plan splits more taps into passes, each adding its taps, in order, to the
// sum the pass before stored: the same sums in the same order, so every tap
// count is taken by the one body.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

namespace {

constexpr int THREADS = 128;       // 4 lanes each
constexpr int TILE = 4 * THREADS;  // lanes a block
constexpr int RUN = 256;           // spectra a block
constexpr int ROWS = 4;            // frame rows a stage
enum Copy { ASYNC = 0, SCALAR = 1 };

// Stages of the ring: 32 KB of int8 rows, 32 KB of f32 rows a block.
template <typename In>
__host__ __device__ constexpr int stages() {
  return sizeof(In) == 1 ? 16 : 4;
}

template <typename In>
__host__ __device__ constexpr int smem_bytes() {
  return stages<In>() * ROWS * TILE * static_cast<int>(sizeof(In));
}

struct Shape {
  long long x_batch;  // elements between streams: n_frames * fft
  int n_rows;         // frames this pass may read (n_frames - its first tap)
  int fft, n_taps, n_spectra, lane_blocks, runs, accumulate;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread's 4 lanes of a frame row into its ring slot: 4 bytes of int8
// (cp.async.ca), 16 bytes of f32 (cp.async.cg, which bypasses L1).
template <typename In>
__device__ __forceinline__ void cp_async_lanes(uint32_t dst, const In* src) {
  if constexpr (sizeof(In) == 1) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <bool VEC>
__device__ __forceinline__ float4 load_f32(const float* __restrict__ p, int left) {
  if constexpr (VEC) {
    return __ldg(reinterpret_cast<const float4*>(p));
  } else {
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = k < left ? __ldg(p + k) : 0.f;
    return make_float4(v[0], v[1], v[2], v[3]);
  }
}

template <bool VEC>
__device__ __forceinline__ void store4(float* __restrict__ p, float4 v, int left) {
  if constexpr (VEC) {
    __stcs(reinterpret_cast<float4*>(p), v);
  } else {
    const float a[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k < left) __stcs(p + k, a[k]);
    }
  }
}

template <bool VEC>
__device__ __forceinline__ float4 load_sum(const float* __restrict__ p, int left) {
  if constexpr (VEC) {
    return __ldcs(reinterpret_cast<const float4*>(p));
  } else {
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = k < left ? __ldcs(p + k) : 0.f;
    return make_float4(v[0], v[1], v[2], v[3]);
  }
}

__device__ __forceinline__ float4 mul4(float4 x, float4 w) {
  return make_float4(__fmul_rn(x.x, w.x), __fmul_rn(x.y, w.y), __fmul_rn(x.z, w.z),
                     __fmul_rn(x.w, w.w));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

// One thread's 4 lanes of a ring row, as f32.
template <typename In>
__device__ __forceinline__ float4 ring_read(const In* p) {
  if constexpr (std::is_same_v<In, int8_t>) {
    const char4 v = *reinterpret_cast<const char4*>(p);
    return make_float4(v.x, v.y, v.z, v.w);
  } else {
    return *reinterpret_cast<const float4*>(p);
  }
}

// One thread's 4 lanes of a frame row into its ring slot, element by element.
template <typename In>
__device__ __forceinline__ void ring_fill_scalar(In* dst, const In* __restrict__ src, int left) {
  In v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = k < left ? src[k] : In(0);
  if constexpr (std::is_same_v<In, int8_t>) {
    *reinterpret_cast<char4*>(dst) = make_char4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

template <int MAXT, typename In, int COPY>
__global__ void __launch_bounds__(THREADS, 3)
    fir_ring_kernel(const In* __restrict__ x, const float* __restrict__ w,
                    float* __restrict__ out, Shape sh) {
  constexpr int D = stages<In>();
  constexpr int NSLOT = D * ROWS;
  constexpr bool VEC = COPY != SCALAR;
  extern __shared__ __align__(128) unsigned char smem[];
  In* ring = reinterpret_cast<In*>(smem);  // [NSLOT][TILE]

  long long bid = blockIdx.x;
  const int lb = static_cast<int>(bid % sh.lane_blocks);
  bid /= sh.lane_blocks;
  const int run = static_cast<int>(bid % sh.runs);
  const long long b = bid / sh.runs;
  const int tid = static_cast<int>(threadIdx.x);
  const int lane0 = lb * TILE;
  const int lane = lane0 + 4 * tid;
  const int left = sh.fft - lane;  // this thread's lanes inside F (<= 0: none)
  const long long fft = sh.fft;
  const int s0 = run * RUN;
  const int s1 = min(sh.n_spectra, s0 + RUN);
  const int r_end = min(sh.n_rows, s1 + sh.n_taps - 1);  // rows s0 .. r_end - 1 are read
  const In* xb = x + b * sh.x_batch + lane0;                // row r of the tile: xb + r * fft
  float* ob = out + b * sh.n_spectra * fft + lane;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  // Stage k holds rows s0 + k*ROWS .. + ROWS - 1 in slots (k % D) * ROWS ...
  auto issue = [&](int k) {
    const int r0 = s0 + k * ROWS;
    const int n = min(ROWS, r_end - r0);  // rows of the stage that are read
    In* slot = ring + (k % D) * ROWS * TILE;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      if (i < n && left > 0) {
        if constexpr (COPY == ASYNC) {
          cp_async_lanes<In>(smem_u32(slot + i * TILE + 4 * tid), xb + (r0 + i) * fft + 4 * tid);
        } else {
          ring_fill_scalar<In>(slot + i * TILE + 4 * tid, xb + (r0 + i) * fft + 4 * tid, left);
        }
      }
    }
    if constexpr (COPY == ASYNC) cp_async_commit();  // one group a stage, even empty
  };
  // Before the first row of stage k: refill the slot of stage k - 1 (this
  // thread's lanes, which only it reads) with stage k + D - 1, then wait for
  // stage k.
  auto start = [&](int k) {
    issue(k + D - 1);
    if constexpr (COPY == ASYNC) cp_async_wait<D - 1>();
  };
  // Row s0 + q of this thread's lanes (zero past the rows that are read).
  auto fetch = [&](int q) {
    return s0 + q < r_end ? ring_read<In>(ring + (q % NSLOT) * TILE + 4 * tid) : zero;
  };

  float4 wr[MAXT];
#pragma unroll
  for (int t = 0; t < MAXT; ++t) {
    wr[t] = t < sh.n_taps && left > 0 ? load_f32<VEC>(w + t * fft + lane, left) : zero;
  }
  for (int k = 0; k < D - 1; ++k) issue(k);
  // Row s0 + q lives in register slot q % MAXT; at output s the ring holds
  // rows s .. s + MAXT - 1.
  float4 xr[MAXT];
#pragma unroll
  for (int q = 0; q < MAXT - 1; ++q) {
    if (q % ROWS == 0) start(q / ROWS);
    xr[q] = fetch(q);
  }
  // Output s + j: fetch row s + j + MAXT - 1, then the taps in order. FULL
  // (a whole chunk of MAXT outputs, MAXT taps, no earlier pass): no row,
  // tap or output guard, as every row it reads exists.
  auto step = [&](int s, int j, auto full) {
    constexpr bool FULL = decltype(full)::value;
    const int q = s - s0 + j + MAXT - 1;  // q % ROWS == (j + MAXT - 1) % ROWS
    if ((j + MAXT - 1) % ROWS == 0) start(q / ROWS);
    xr[(j + MAXT - 1) % MAXT] =
        FULL ? ring_read<In>(ring + (q % NSLOT) * TILE + 4 * tid) : fetch(q);
    float* o = ob + (s + j) * fft;
    float4 acc = mul4(xr[j], wr[0]);
    if (!FULL && sh.accumulate && left > 0) acc = add4(load_sum<VEC>(o, left), acc);
#pragma unroll
    for (int t = 1; t < MAXT; ++t) {
      if (FULL || t < sh.n_taps) acc = add4(acc, mul4(xr[(j + t) % MAXT], wr[t]));
    }
    if (left > 0) store4<VEC>(o, acc, left);
  };
  const bool full_taps = sh.n_taps == MAXT && !sh.accumulate;
  for (int s = s0; s < s1; s += MAXT) {
    if (full_taps && s + MAXT <= s1) {
#pragma unroll
      for (int j = 0; j < MAXT; ++j) step(s, j, std::true_type{});
    } else {
#pragma unroll
      for (int j = 0; j < MAXT; ++j) {
        if (s + j < s1) step(s, j, std::false_type{});
      }
    }
  }
  if constexpr (COPY == ASYNC) cp_async_wait<0>();  // no copy outlives the block
}

template <int MAXT, typename In, int COPY>
void* kernel_of() {
  return reinterpret_cast<void*>(&fir_ring_kernel<MAXT, In, COPY>);
}

template <typename In, int COPY>
void* pick_copy(int maxt) {
  if (maxt == 4) return kernel_of<4, In, COPY>();
  if (maxt == 8) return kernel_of<8, In, COPY>();
  if (maxt == 16) return kernel_of<16, In, COPY>();
  return nullptr;
}

// The body for a register ring of `maxt` rows (4, 8 or 16), f32 or int8
// frames and a copy mode, or nullptr.
void* pick(int maxt, bool in_f32, int copy) {
  if (copy == ASYNC) return in_f32 ? pick_copy<float, ASYNC>(maxt) : pick_copy<int8_t, ASYNC>(maxt);
  if (copy == SCALAR) {
    return in_f32 ? pick_copy<float, SCALAR>(maxt) : pick_copy<int8_t, SCALAR>(maxt);
  }
  return nullptr;
}

bool aligned(const void* p, uintptr_t to) { return reinterpret_cast<uintptr_t>(p) % to == 0; }

}  // namespace

// One pass of the plan (ops/pfb_fir.py:_fir_plan): taps tap0 .. tap0 +
// taps - 1 through the body with a register ring of `depth` rows and the
// copy mode `copy` (0 async, 1 scalar). x [batch, n_frames, fft] int8
// (in_f32 = 0) or f32; w [n_taps, fft] f32; out [batch, n_spectra, fft] f32,
// written by the pass with tap0 = 0 and added to by the later ones. A pass
// that does not fit the pointers and shape is refused with
// cudaErrorInvalidValue, before any launch.
extern "C" int pfb_fir_launch(const void* x, const void* w, void* out, int batch,
                              int n_frames, int fft, int n_spectra, int tap0, int taps,
                              int depth, int in_f32, int copy, void* stream) {
  const void* fn = pick(depth, in_f32 != 0, copy);
  if (fn == nullptr || batch < 1 || fft < 1 || n_spectra < 1 || tap0 < 0 || taps < 1 ||
      taps > depth || static_cast<long long>(tap0) + taps + n_spectra - 1 > n_frames) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int elem = in_f32 ? 4 : 1;
  if (copy == ASYNC && !(fft % 4 == 0 && aligned(x, 4 * elem) && aligned(w, 16) &&
                         aligned(out, 16))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int lane_blocks = (fft + TILE - 1) / TILE;
  const int runs = (n_spectra + RUN - 1) / RUN;
  const long long blocks = static_cast<long long>(lane_blocks) * runs * batch;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = in_f32 ? smem_bytes<float>() : smem_bytes<int8_t>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  Shape sh{static_cast<long long>(n_frames) * fft, n_frames - tap0, fft, taps, n_spectra,
           lane_blocks, runs, tap0 > 0};
  const long long off = static_cast<long long>(tap0) * fft;
  const void* xp = static_cast<const char*>(x) + off * elem;
  const float* wp = static_cast<const float*>(w) + off;
  float* op = static_cast<float*>(out);
  void* args[] = {&xp, &wp, &op, &sh};
  const cudaError_t err = cudaLaunchKernel(fn, dim3(static_cast<unsigned>(blocks)), dim3(THREADS),
                                           args, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Registers, local (spill) bytes and the most threads a block of the body
// for a register ring of `maxt` rows (4, 8 or 16), f32 or int8 frames and
// a copy mode.
extern "C" int pfb_fir_attributes(int maxt, int in_f32, int copy, int* regs, int* local_bytes,
                                  int* max_threads) {
  const void* fn = pick(maxt, in_f32 != 0, copy);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes at{};
  const cudaError_t err = cudaFuncGetAttributes(&at, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = at.numRegs;
  *local_bytes = static_cast<int>(at.localSizeBytes);
  *max_threads = at.maxThreadsPerBlock;
  return 0;
}
