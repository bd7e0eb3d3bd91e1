// The stops of K1's DFT passes and of its three-pass route (csrc/
// fengine_ct.cu's head describes them), built in an nvcc process of their
// own, with and without the requant: the bf16 DFT pass (k1_dft_kernel at
// STOP_STAGEA_RND, STOP_STAGEB and P5's STOP_STAGEA) at every plan it takes
// at N1 = N2 (KC 64 to N1 = 512, 32 at 1024); the f32 DFT pass
// (k1_dft_f32_kernel at STOP_STAGEA_RND, STOP_STAGEB) at both of its plans
// there (KC 16 to N1 = 512, 8 at 1024); the three-pass route (N2 >= 2048)'s
// stage B cut before the rotation (k1_stage_b_kernel, k1_stage_b_f32_kernel
// at STOP_STAGEB) and k1_t_slice_kernel, which gathers stage A's T rows k1 <
// N1/2 for the stagea stop (stage A itself runs through the library's
// k1_stage_a[_f32]_launch).

#define K1_STAGE_STOPS
#include "fengine_ct.cu"

namespace {

// fn(std::integral_constant<int, KC>, plan, bytes) at the plan the DFT pass
// takes for this split, where a stop body exists for it: the plans of the
// N1 = N2 splits, KC 64 and 32 (N1 = 8's KC_N8 plan and KC 16 serve none),
// and P5's stagea only on KC = 64 (fft 16384 and 65536, where the probe
// runs). NO_PLAN elsewhere.
template <int STOP, typename Fn>
int with_stop_plan(const DftParams& p, Fn fn) {
  return with_dft_plan(p, [&](auto kc, const DftParams& q, size_t bytes) {
    constexpr int K = decltype(kc)::value;
    if constexpr (K == KC_N8 || K == 16 || (STOP == STOP_STAGEA && K != 64)) {
      return NO_PLAN;
    } else {
      return fn(std::integral_constant<int, K>{}, q, bytes);
    }
  });
}

template <int STOP, bool QUANT>
int dft_stop(const DftParams& p, int batch, cudaStream_t st) {
  return with_stop_plan<STOP>(p, [&](auto kc, const DftParams& q, size_t bytes) {
    return static_cast<int>(launch_dft<decltype(kc)::value, QUANT, STOP>(q, batch, bytes, st));
  });
}

template <int STOP, bool QUANT>
int dft_stop_attributes(const DftParams& p, int* o) {
  return with_stop_plan<STOP>(p, [&](auto kc, const DftParams&, size_t) {
    constexpr int K = decltype(kc)::value;
    cudaFuncAttributes a{};
    const cudaError_t err = cudaFuncGetAttributes(&a, k1_dft_kernel<K, QUANT, STOP>);
    if (err != cudaSuccess) return static_cast<int>(err);
    o[0] = a.numRegs;
    o[1] = static_cast<int>(a.localSizeBytes);
    o[2] = K;
    return 0;
  });
}

bool dft_stop_args(int n1, int n2, int stop, int quantise) {
  return n1 == n2 && n1 >= 16 && pow2(n1) && n2 >= 128 &&
         (stop == STOP_STAGEA_RND || stop == STOP_STAGEB || (stop == STOP_STAGEA && quantise));
}

}  // namespace

// Stop 10 (stagea: T rounded to bf16, rows k1 < N1/2), 4 (stageb: re, im
// before the rotation) or P5's 3 (stagea: T before the rounding, int8; KC =
// 64 only) of the DFT pass: plane [batch, n_spectra, N1, N2] bf16 (N1 ==
// N2) -> outr, outi [batch, n_spectra, C], int8 by truncation (quantise =
// 1) or f32 (no rotation planes: no stop reaches the rotation). -1 where no
// stop body takes the split.
extern "C" int k1_dft_stop_launch(const void* plane, const void* d1c, const void* d1s,
                                  const void* d2, const void* twc, const void* tws, void* outr,
                                  void* outi, int batch, int n_spectra, int n1, int n2,
                                  int stop, int quantise, void* stream) {
  if (!dft_stop_args(n1, n2, stop, quantise) || batch < 1 || n_spectra < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DftParams p{};
  p.plane = static_cast<const bf16*>(plane);
  p.d1c = static_cast<const bf16*>(d1c);
  p.d1s = static_cast<const bf16*>(d1s);
  p.d2 = static_cast<const bf16*>(d2);
  p.twc = static_cast<const float*>(twc);
  p.tws = static_cast<const float*>(tws);
  p.outr = outr;
  p.outi = outi;
  p.n_spectra = n_spectra;
  p.n1 = n1;
  p.n2 = n2;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (stop) {
    case STOP_STAGEA: return dft_stop<STOP_STAGEA, true>(p, batch, st);
    case STOP_STAGEA_RND:
      return quantise ? dft_stop<STOP_STAGEA_RND, true>(p, batch, st)
                      : dft_stop<STOP_STAGEA_RND, false>(p, batch, st);
    default:
      return quantise ? dft_stop<STOP_STAGEB, true>(p, batch, st)
                      : dft_stop<STOP_STAGEB, false>(p, batch, st);
  }
}

// The stop body k1_dft_stop_launch runs at N1 x N2: out int[3] = registers
// a thread, local (spill) bytes a thread, KC; -1 where none takes it.
extern "C" int k1_dft_stop_attributes(int n1, int n2, int stop, int quantise, void* out) {
  if (!dft_stop_args(n1, n2, stop, quantise)) return static_cast<int>(cudaErrorInvalidValue);
  DftParams p{};
  p.n_spectra = 1;
  p.n1 = n1;
  p.n2 = n2;
  int* o = static_cast<int*>(out);
  switch (stop) {
    case STOP_STAGEA: return dft_stop_attributes<STOP_STAGEA, true>(p, o);
    case STOP_STAGEA_RND:
      return quantise ? dft_stop_attributes<STOP_STAGEA_RND, true>(p, o)
                      : dft_stop_attributes<STOP_STAGEA_RND, false>(p, o);
    default:
      return quantise ? dft_stop_attributes<STOP_STAGEB, true>(p, o)
                      : dft_stop_attributes<STOP_STAGEB, false>(p, o);
  }
}

// ---------------------------------------------------------------------------
// The f32 DFT pass's stops
// ---------------------------------------------------------------------------

namespace {

template <int STOP, bool QUANT>
int dft_f32_stop(const F32Params& p, int batch, cudaStream_t st) {
  return with_f32_plan(p, [&](auto kc, const F32Params& q, size_t bytes) {
    return static_cast<int>(
        launch_dft_f32<decltype(kc)::value, QUANT, STOP>(q, batch, bytes, st));
  });
}

template <int STOP, bool QUANT>
int dft_f32_stop_attributes(const F32Params& p, int* o) {
  return with_f32_plan(p, [&](auto kc, const F32Params&, size_t) {
    constexpr int K = decltype(kc)::value;
    cudaFuncAttributes a{};
    const cudaError_t err = cudaFuncGetAttributes(&a, k1_dft_f32_kernel<K, QUANT, STOP>);
    if (err != cudaSuccess) return static_cast<int>(err);
    o[0] = a.numRegs;
    o[1] = static_cast<int>(a.localSizeBytes);
    o[2] = K;
    return 0;
  });
}

bool f32_stop_args(int n1, int n2, int stop) {
  return n1 == n2 && pow2(n1) && n2 >= 128 && (stop == STOP_STAGEA_RND || stop == STOP_STAGEB);
}

}  // namespace

// Stop 10 (stagea: T, f32, rows k1 < N1/2) or 4 (stageb: re, im before the
// rotation) of the f32 DFT pass: plane [batch, n_spectra, N1, N2] f32
// (16-byte aligned, N1 == N2) -> outr, outi [batch, n_spectra, C], int8 by
// truncation (quantise = 1) or f32; d2t the N2-point matrix transposed. -1
// where the pass has no plan (N2 > 1024).
extern "C" int k1_dft_f32_stop_launch(const void* plane, const void* d1c, const void* d1s,
                                      const void* d2t, const void* twc, const void* tws,
                                      void* outr, void* outi, int batch, int n_spectra, int n1,
                                      int n2, int stop, int quantise, void* stream) {
  if (!f32_stop_args(n1, n2, stop) || batch < 1 || n_spectra < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  F32Params p{};
  p.plane = static_cast<const float*>(plane);
  p.d1c = static_cast<const float*>(d1c);
  p.d1s = static_cast<const float*>(d1s);
  p.d2t = static_cast<const float*>(d2t);
  p.twc = static_cast<const float*>(twc);
  p.tws = static_cast<const float*>(tws);
  p.outr = outr;
  p.outi = outi;
  p.n_spectra = n_spectra;
  p.n1 = n1;
  p.n2 = n2;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stop == STOP_STAGEA_RND) {
    return quantise ? dft_f32_stop<STOP_STAGEA_RND, true>(p, batch, st)
                    : dft_f32_stop<STOP_STAGEA_RND, false>(p, batch, st);
  }
  return quantise ? dft_f32_stop<STOP_STAGEB, true>(p, batch, st)
                  : dft_f32_stop<STOP_STAGEB, false>(p, batch, st);
}

// The stop body k1_dft_f32_stop_launch runs at N1 x N2: out int[3] =
// registers a thread, local (spill) bytes a thread, KC; -1 where none.
extern "C" int k1_dft_f32_stop_attributes(int n1, int n2, int stop, int quantise, void* out) {
  if (!f32_stop_args(n1, n2, stop)) return static_cast<int>(cudaErrorInvalidValue);
  F32Params p{};
  p.n_spectra = 1;
  p.n1 = n1;
  p.n2 = n2;
  int* o = static_cast<int*>(out);
  if (stop == STOP_STAGEA_RND) {
    return quantise ? dft_f32_stop_attributes<STOP_STAGEA_RND, true>(p, o)
                    : dft_f32_stop_attributes<STOP_STAGEA_RND, false>(p, o);
  }
  return quantise ? dft_f32_stop_attributes<STOP_STAGEB, true>(p, o)
                  : dft_f32_stop_attributes<STOP_STAGEB, false>(p, o);
}

// ---------------------------------------------------------------------------
// The three-pass route's stops
// ---------------------------------------------------------------------------

namespace {

template <bool QUANT>
int stage_b_stop(const StageParams& p, long long tiles, bool f32, cudaStream_t st) {
  return static_cast<int>(
      f32 ? launch_stage(k1_stage_b_f32_kernel<QUANT, STOP_STAGEB>, p, tiles, FB_SMEM, st)
          : launch_stage(k1_stage_b_kernel<QUANT, STOP_STAGEB>, p, tiles, SB_SMEM, st));
}

template <typename T, bool QUANT>
int t_slice(const void* tr, const void* ti, void* outr, void* outi, long long m, int n1,
            int n2, cudaStream_t st) {
  const long long quads = m * (n1 / 2) * static_cast<long long>(n2) / 4;
  const long long blocks = (quads + 255) / 256;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  k1_t_slice_kernel<T, QUANT><<<static_cast<unsigned>(blocks), 256, 0, st>>>(
      static_cast<const T*>(tr), static_cast<const T*>(ti), outr, outi, m, n1, n2);
  return static_cast<int>(cudaGetLastError());
}

template <typename K>
int regs_of(K kern, int* o) {
  cudaFuncAttributes a{};
  const cudaError_t err = cudaFuncGetAttributes(&a, kern);
  if (err != cudaSuccess) return static_cast<int>(err);
  o[0] = a.numRegs;
  o[1] = static_cast<int>(a.localSizeBytes);
  return 0;
}

}  // namespace

// The stageb stop of the three-pass route: T re, im as stage A wrote them
// (bf16 [batch, n_spectra, N1, N2], or f32 transposed [.., N2, N1]), d2 the
// bf16 row-stacked N2-point matrix (or f32 transposed) -> outr, outi [batch,
// n_spectra, C]: re, im before the rotation, int8 by truncation (quantise =
// 1) or f32. -1 where the route's tiles do not cover the split.
extern "C" int k1_stage_b_stop_launch(const void* tr, const void* ti, const void* d2,
                                      void* outr, void* outi, int batch, int n_spectra, int n1,
                                      int n2, int f32, int quantise, void* stream) {
  if (batch < 1 || n_spectra < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (!three_pass_split(n1, n2)) return NO_PLAN;
  const int cols = f32 ? FB_N : SB_N, rows = f32 ? FB_M : SB_M;
  StageParams p{nullptr, nullptr, nullptr, d2, nullptr, nullptr,
                const_cast<void*>(tr), const_cast<void*>(ti), nullptr, nullptr, outr, outi,
                n_spectra, n1, n2, n1 / cols, n2 / 2 / rows};
  const long long tiles = static_cast<long long>(batch) * n_spectra * p.n_ct * p.n_rt;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return quantise ? stage_b_stop<true>(p, tiles, f32, st) : stage_b_stop<false>(p, tiles, f32, st);
}

// The stagea stop's gather: T re, im of m spectra as stage A wrote them ->
// outr, outi [m, C] (16-byte aligned): rows k1 < N1/2 at k1*N2 + n2, int8 by
// truncation (quantise = 1) or f32.
extern "C" int k1_t_slice_launch(const void* tr, const void* ti, void* outr, void* outi, int m,
                                 int n1, int n2, int f32, int quantise, void* stream) {
  if (m < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (!three_pass_split(n1, n2)) return NO_PLAN;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f32) {
    return quantise ? t_slice<float, true>(tr, ti, outr, outi, m, n1, n2, st)
                    : t_slice<float, false>(tr, ti, outr, outi, m, n1, n2, st);
  }
  return quantise ? t_slice<bf16, true>(tr, ti, outr, outi, m, n1, n2, st)
                  : t_slice<bf16, false>(tr, ti, outr, outi, m, n1, n2, st);
}

// The three-pass route's stop bodies in an operand type: out int[4] =
// stage B stop's registers and local (spill) bytes a thread, then the
// gather's.
extern "C" int k1_stage_stop_attributes(int f32, int quantise, void* out) {
  int* o = static_cast<int*>(out);
  int err;
  if (f32) {
    err = quantise ? regs_of(k1_stage_b_f32_kernel<true, STOP_STAGEB>, o)
                   : regs_of(k1_stage_b_f32_kernel<false, STOP_STAGEB>, o);
    if (err) return err;
    return quantise ? regs_of(k1_t_slice_kernel<float, true>, o + 2)
                    : regs_of(k1_t_slice_kernel<float, false>, o + 2);
  }
  err = quantise ? regs_of(k1_stage_b_kernel<true, STOP_STAGEB>, o)
                 : regs_of(k1_stage_b_kernel<false, STOP_STAGEB>, o);
  if (err) return err;
  return quantise ? regs_of(k1_t_slice_kernel<bf16, true>, o + 2)
                  : regs_of(k1_t_slice_kernel<bf16, false>, o + 2);
}
