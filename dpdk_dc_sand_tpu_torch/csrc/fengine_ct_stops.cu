// K1's stage stops (the probes P5 and P4), built in an nvcc process of their
// own: this file takes K1's kernels from csrc/fengine_ct.cu (whose head
// describes the stops) and instantiates only their STOP variants, so the
// library's build time stays that of its slowest source.

#define K1_STAGE_STOPS
#include "fengine_ct.cu"

// The stage stops of the two passes: stop 1 (dma) or 2 (fir) runs the FIR pass's stop, writing
// outr, outi [batch, n_spectra, fft/2] int8 (and, for fir, the plane as
// k1_fir_launch does; dma does not touch it); fft % 8 == 0.
extern "C" int k1_fir_stop_launch(const void* x, long long batch_stride, const void* starts,
                                  const void* win, void* plane, void* outr, void* outi,
                                  int batch, int n_spectra, int n_taps, int fft, int stop,
                                  void* stream) {
  if (batch < 1 || n_spectra < 1 || n_taps < 1 || fft < 8 || fft % 8 ||
      (stop != STOP_DMA && stop != STOP_FIR)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FirParams a{static_cast<const int8_t*>(x), batch_stride,
              static_cast<const long long*>(starts), static_cast<const float*>(win),
              static_cast<bf16*>(plane), n_spectra, fft, n_taps,
              (fft + 4 * FIR_THREADS - 1) / (4 * FIR_THREADS), (n_spectra + RUN - 1) / RUN,
              static_cast<int8_t*>(outr), static_cast<int8_t*>(outi)};
  const long long blocks = static_cast<long long>(a.lane_blocks) * a.runs * batch;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (stop == STOP_DMA) {
    k1_fir_kernel<0, STOP_DMA><<<grid, FIR_THREADS, 0, st>>>(a);
  } else if (n_taps <= 4) {
    k1_fir_kernel<4, STOP_FIR><<<grid, FIR_THREADS, 0, st>>>(a);
  } else if (n_taps <= 8) {
    k1_fir_kernel<8, STOP_FIR><<<grid, FIR_THREADS, 0, st>>>(a);
  } else if (n_taps <= 16) {
    k1_fir_kernel<16, STOP_FIR><<<grid, FIR_THREADS, 0, st>>>(a);
  } else {
    k1_fir_kernel<0, STOP_FIR><<<grid, FIR_THREADS, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// Stop 3 (stagea) or 4 (stageb) of the DFT pass: plane [batch, n_spectra,
// N1, N2] bf16 -> outr, outi [batch, n_spectra, C] int8 (no rotation
// planes: neither stop reaches the rotation). The stops take the 64-row
// chunk plan only (every N1 = N2 <= 256: fft 16384 and 65536, where the
// probes run), which keeps this file's build short; elsewhere they return
// -1, as where no plan fits shared memory.
extern "C" int k1_dft_stop_launch(const void* plane, const void* d1c, const void* d1s,
                                  const void* d2, const void* twc, const void* tws, void* outr,
                                  void* outi, int batch, int n_spectra, int n1, int n2,
                                  int stop, void* stream) {
  if (n1 < 16 || !pow2(n1) || n2 < 128 || !pow2(n2) || batch < 1 || n_spectra < 1 ||
      (stop != STOP_STAGEA && stop != STOP_STAGEB)) {
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
  const size_t bytes = dft_plan<64>(p);
  if (!bytes) return NO_PLAN;
  const cudaError_t err = stop == STOP_STAGEA ? launch_dft<64, true, STOP_STAGEA>(p, batch, bytes, st)
                                              : launch_dft<64, true, STOP_STAGEB>(p, batch, bytes, st);
  return static_cast<int>(err);
}
