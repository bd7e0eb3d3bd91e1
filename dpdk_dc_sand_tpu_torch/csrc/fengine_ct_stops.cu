// K1's FIR-pass stops (the reference's dma and fir, the probes P5's and
// P4's) and the FIR pass's cuts of the probe P2 (K7's first pass), built in
// an nvcc process of their own: this file takes K1's kernels from
// csrc/fengine_ct.cu (whose head describes the stops) and instantiates only
// their STOP variants, so the library's build time stays that of its
// slowest source. The DFT passes' and the three-pass route's stops are in
// csrc/fengine_ct_stops_dft.cu.

#define K1_STAGE_STOPS
#include "fengine_ct.cu"


// The stage stops of the FIR pass, writing outr, outi [batch, n_spectra,
// fft/2]: stop 1 (dma: the probe of the [rows, n2] frame view, N1 = fft / n2
// <= n2), 2 (P5's fir: the bf16 plane and the f32 sums' halves, int8) or 9
// (the reference's fir: the plane of the operand type, plane_f32, and its
// first fft/2 values to both outputs; N1 == n2), or P2's 5 (dma), 6 (conv),
// 7 (fir) or 8 (deint) (no plane: pass null; int8). Stops 1 and 9 write int8
// by truncation (quantise = 1) or f32; the others int8. fft % 8 == 0. The
// plan (depth, run, streams, short_run) is k1_fir_launch's; the copies-only
// stops (1, 5, 6) run the ring's copies alone, whatever the body; stop 1's
// runs are whole blocks of 16 spectra (run % 16 == 0, or one run).
extern "C" int k1_fir_stop_launch(const void* x, long long batch_stride, const void* starts,
                                  const void* win, void* plane, void* outr, void* outi,
                                  int batch, int n_spectra, int n_taps, int fft, int depth,
                                  int run, int streams, int short_run, int stop, int n2,
                                  int plane_f32, int quantise, void* stream) {
  FirShape sh;
  const bool plane_stop = stop == STOP_FIR || stop == STOP_FIR_RND;
  const bool f32_ok = stop == STOP_DMA || stop == STOP_FIR_RND;
  if (!fir_shape(sh, batch_stride, batch, n_spectra, n_taps, fft, depth, run, streams,
                 short_run) ||
      fft % 8 || !aligned_to(win, 16) ||
      (plane_stop && !aligned_to(plane, plane_f32 ? 16 : 8)) ||
      (plane_f32 && stop != STOP_FIR_RND) || (!quantise && !f32_ok) ||
      (!quantise && !(aligned_to(outr, 16) && aligned_to(outi, 16))) ||
      (stop == STOP_DMA && (n2 < 8 || fft % n2 || fft / n2 > n2 || (fft / n2) % 4 ||
                            (run % ABLATE_S_BLK && run < n_spectra))) ||
      (stop == STOP_FIR_RND && fft != n2 * n2) ||
      (stop != STOP_DMA && stop != STOP_FIR && stop != STOP_FIR_RND &&
       (stop < STOP_DIT_DMA || stop > STOP_DIT_DEINT))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  sh.probe_n2 = n2;
  sh.f32_out = !quantise;
  int8_t* r = static_cast<int8_t*>(outr);
  int8_t* i = static_cast<int8_t*>(outi);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (stop) {
    case STOP_DMA:
      // PT picks the output type of the copies-only body: float, f32 outputs.
      return quantise ? fir_launch<0, STOP_DMA, bf16>(x, starts, win, plane, r, i, sh, st)
                      : fir_launch<0, STOP_DMA, float>(x, starts, win, plane, r, i, sh, st);
    case STOP_DIT_DMA:
      return fir_launch<0, STOP_DIT_DMA, bf16>(x, starts, win, plane, r, i, sh, st);
    case STOP_DIT_CONV:
      return fir_launch<0, STOP_DIT_CONV, bf16>(x, starts, win, plane, r, i, sh, st);
    case STOP_FIR:
      return fir_dispatch<STOP_FIR, bf16>(depth, short_run, x, starts, win, plane, r, i, sh, st);
    case STOP_FIR_RND:
      return plane_f32 ? fir_dispatch<STOP_FIR_RND, float>(depth, short_run, x, starts, win,
                                                           plane, r, i, sh, st)
                       : fir_dispatch<STOP_FIR_RND, bf16>(depth, short_run, x, starts, win,
                                                          plane, r, i, sh, st);
    case STOP_DIT_FIR:
      return fir_dispatch<STOP_DIT_FIR, bf16>(depth, short_run, x, starts, win, plane, r, i,
                                              sh, st);
    default:
      return fir_dispatch<STOP_DIT_DEINT, bf16>(depth, short_run, x, starts, win, plane, r, i,
                                                sh, st);
  }
}

// The FIR pass's body at a stop (numbered as k1_fir_stop_launch takes them;
// stop 9 into a bf16 or, plane_f32, an f32 plane; stop 1 with int8 or,
// plane_f32, f32 outputs) for a register ring of
// `depth` rows (4, 8, 16; 0: the long body), or the short-run body for that
// depth (short_run = 1; the copies-only stops have one body, whatever the
// depth): out int[5] as k1_fir_attributes gives it.
extern "C" int k1_fir_stop_attributes(int depth, int short_run, int stop, int plane_f32,
                                      void* out) {
  switch (stop) {
    case STOP_DMA:
      return plane_f32 ? fir_attributes_of<0, STOP_DMA, float>(out)
                       : fir_attributes_of<0, STOP_DMA, bf16>(out);
    case STOP_DIT_DMA: return fir_attributes_of<0, STOP_DIT_DMA, bf16>(out);
    case STOP_DIT_CONV: return fir_attributes_of<0, STOP_DIT_CONV, bf16>(out);
    case STOP_FIR: return fir_attributes<STOP_FIR, bf16>(depth, short_run, out);
    case STOP_FIR_RND:
      return plane_f32 ? fir_attributes<STOP_FIR_RND, float>(depth, short_run, out)
                       : fir_attributes<STOP_FIR_RND, bf16>(depth, short_run, out);
    case STOP_DIT_FIR: return fir_attributes<STOP_DIT_FIR, bf16>(depth, short_run, out);
    case STOP_DIT_DEINT: return fir_attributes<STOP_DIT_DEINT, bf16>(depth, short_run, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
