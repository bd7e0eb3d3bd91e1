// K1's stage stops (the probes P5 and P4) and the FIR pass's cuts of the
// probe P2 (K7's first pass), built in an nvcc process of their own: this
// file takes K1's kernels from csrc/fengine_ct.cu (whose head describes the
// stops) and instantiates only their STOP variants, so the library's build
// time stays that of its slowest source.

#define K1_STAGE_STOPS
#include "fengine_ct.cu"

// The stage stops of the FIR pass, writing outr, outi [batch, n_spectra,
// fft/2] int8: stop 1 (dma) or 2 (fir), P5's (fir also writes the plane as
// k1_fir_launch does; dma does not touch it), or 5 (dma), 6 (conv), 7 (fir)
// or 8 (deint), P2's (no plane: pass null); fft % 8 == 0. The plan (depth,
// run, streams, short_run) is k1_fir_launch's; the copies-only stops (1, 5,
// 6) run the ring's copies alone, whatever the body.
extern "C" int k1_fir_stop_launch(const void* x, long long batch_stride, const void* starts,
                                  const void* win, void* plane, void* outr, void* outi,
                                  int batch, int n_spectra, int n_taps, int fft, int depth,
                                  int run, int streams, int short_run, int stop,
                                  void* stream) {
  FirShape sh;
  if (!fir_shape(sh, batch_stride, batch, n_spectra, n_taps, fft, depth, run, streams,
                 short_run) ||
      fft % 8 || !aligned_to(win, 16) || (stop == STOP_FIR && !aligned_to(plane, 8)) ||
      (stop != STOP_DMA && stop != STOP_FIR && (stop < STOP_DIT_DMA || stop > STOP_DIT_DEINT))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (stop) {
    case STOP_DMA:
      return fir_launch<0, STOP_DMA, bf16>(x, starts, win, plane, outr, outi, sh, st);
    case STOP_DIT_DMA:
      return fir_launch<0, STOP_DIT_DMA, bf16>(x, starts, win, plane, outr, outi, sh, st);
    case STOP_DIT_CONV:
      return fir_launch<0, STOP_DIT_CONV, bf16>(x, starts, win, plane, outr, outi, sh, st);
    case STOP_FIR:
      return fir_dispatch<STOP_FIR, bf16>(depth, short_run, x, starts, win, plane, outr, outi,
                                          sh, st);
    case STOP_DIT_FIR:
      return fir_dispatch<STOP_DIT_FIR, bf16>(depth, short_run, x, starts, win, plane, outr,
                                              outi, sh, st);
    default:
      return fir_dispatch<STOP_DIT_DEINT, bf16>(depth, short_run, x, starts, win, plane, outr,
                                                outi, sh, st);
  }
}

// The FIR pass's body at a stop (numbered as k1_fir_stop_launch takes them)
// for a register ring of `depth` rows (4, 8, 16; 0: the long body), or the
// short-run body for that depth (short_run = 1; the copies-only stops have
// one body, whatever the depth): out int[5] as k1_fir_attributes gives it.
extern "C" int k1_fir_stop_attributes(int depth, int short_run, int stop, void* out) {
  switch (stop) {
    case STOP_DMA: return fir_attributes_of<0, STOP_DMA, bf16>(out);
    case STOP_DIT_DMA: return fir_attributes_of<0, STOP_DIT_DMA, bf16>(out);
    case STOP_DIT_CONV: return fir_attributes_of<0, STOP_DIT_CONV, bf16>(out);
    case STOP_FIR: return fir_attributes<STOP_FIR, bf16>(depth, short_run, out);
    case STOP_DIT_FIR: return fir_attributes<STOP_DIT_FIR, bf16>(depth, short_run, out);
    case STOP_DIT_DEINT: return fir_attributes<STOP_DIT_DEINT, bf16>(depth, short_run, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
