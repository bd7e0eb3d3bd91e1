#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU: build, check, drive the F+B, FXB, F and native F+B flagships, E1, the engine node, the probes, the sharded engine, the characterisation probes, a servlet fronting two engine nodes and a node fed over the native transport.

    python3 chip_smoke.py            # all phases; needs one CUDA card

Phases (each prints one ``PHASE`` line; any failure exits non-zero):

1. device  — require CUDA; print the card's name and power limit
   (``nvidia-smi``) and the ``nvcc`` version;
2. build   — compile ``dpdk_dc_sand_tpu_torch/csrc/*.cu`` for sm_90a (each
   source's nvcc seconds logged), and the host library
   ``dpdk_dc_sand_tpu_torch/native/*.cpp`` with g++ (required);
3. k1      — K1 (fused F kernel) through its wrapper ``fengine_fused`` vs
   its plain PyTorch version at the flagship fft, taps and S on 8 of the
   160 (antenna, pol) batches, with two coarse delays that clamp: bf16 DFT
   on flat streams (K1's two bf16 passes), f32 DFT on the rowed view (its
   f32 FIR pass and FFMA DFT pass), each call's launches counted (no stage
   of the three-pass route); within 1 int8 code on <= 1e-3 of samples;
   K1's FIR passes alone (``k1_fir``, ``k1_fir_f32``) bit-exact against
   ``k1_fir_reference`` on the same streams. Then above the old 65536 cap:
   K1 at fft 2^17, 2^18 and 2^20 (2 batches, 16 taps, S=8), bf16 and f32,
   against plain with the same bound; K1 at fft 2^22 (2048 x 2048, 2
   batches, 4 taps, S=2), both forms, where neither DFT pass has a plan:
   it must launch the form's FIR pass, stage A and stage B once each and
   nothing else, within 1 code on <= 1e-3 (bf16) or 1e-4 (f32) of plain,
   timed. Then K1's stage stops (``fengine_fused(_ablate=...)``: dma, fir,
   stagea, stageb) at fft 2^18 and 2^20 (2 streams x S=8 x 16 taps, the
   two-pass routes) and 2^22 (2 x 2 x 4 taps, the three-pass routes), bf16
   and f32, with the requant and without: each call launches a stopped pass
   and no pass its route's whole call does not, is held to the plain stop on
   its last stream (dma, fir bit for bit; the DFT stops within K1's code
   contract, their f32 values as ``_stop_diff`` says), and timed beside the
   whole call; the stop bodies' registers and spills (a spill fails, but
   for the bf16 DFT pass's stageb bodies, which spill as that pass's own
   body does). Then K1 at full width, 160 streams x 16 taps with coarse delays,
   both forms, at fft 1024 (N1 = 8, S = 16384: the two passes' N1 = 8
   plans) and fft 2^22 (S = 4: the three-pass route): its route's passes
   launched once a group each and nothing else (the counts set to 0 just
   before and read just after), the last 8 streams against plain with the
   form's bound, stage A's T and stage B on it against plain, K1 whole and
   each pass alone over the 160 streams beside its plain version (8
   streams at a time) and its bound, and the scratch. Then ``FBEngine`` /
   ``FXBEngine(fengine="auto")`` at 65536 channels and ``FBEngine`` at 512
   (2 ant x 4 beams x 4 taps, S=128) on the card against the same engine on
   the CPU: beams within 2 + 1e-3 and off by more than 1e-3 on <= 5e-3 of
   them; and ``FBEngine(fengine="auto")`` at 512 channels at the flagship
   array (80 ant x 16 beams x 16 taps, S = 16384; K1's two bf16 passes at
   N1 = 8 must launch and no other K1 pass): 3 steps, a delay update, 2
   steps, the median of steps 2-5;
4. k2      — K2 (fused B kernel) through ``beamform_turned_fused`` vs its
   plain version at the flagship C with A=8, S=256, at every 2B its gate
   takes (2, 4, 8, 16, 32, 64, 128), then at C = 24 (2B = 32) and C = 48
   (2B = 8), bf16 and f32 weights each: rtol 1e-5, atol 1e-3, its launch
   counter rising by one each;
5. engine  — FBEngine vs the plain F + plain B chain at 8 antennas x 32768
   ch x 16 beams x 16 taps, S=256 (the step must launch K2 once): F planes
   within 1 code on <= 1e-3,
   |d| > 1e-3 on <= 5e-3 of beams, and every beam within the sum of |w|
   over its differing F codes (+1e-3);
6. flagship — FBEngine at 80 x 32768 x 16 x 16, S=256, wire-rowed ADC made
   on the card from a seed: set_beam_delays, 3 steps, a delay update, 2
   steps; both kernels' launch counters must rise, the beams must be finite
   and of the packed shape; prints ms/step and Msamples/s. Then the last
   step's beams must equal K2(K1(adc)) through the wrappers, and each
   kernel is held against its plain version at these flagship shapes
   (K1: 1 code on <= 1e-3; K2: rtol 1e-5, atol 1e-3) and timed beside it;
   K2's yardsticks: its tensor-core body's registers, spill bytes and
   geometry (a body that spills fails the phase; on the log line only, the
   bytes its geometry moves from L2), a fill of its output, and its stage
   stops (the copies, the MMAs, the stores, alone and in pairs), each
   checked for what it writes and timed;
   K1's FIR pass over all 160 streams bit-exact against its plain version,
   and each of K1's passes timed alone; the step's peak device memory.
   Then the same flagship with ``fengine="fused_f32"`` (K1's f32 FIR pass
   and FFMA DFT pass, 16 streams a group, then K2): the same steps, the
   median of steps 2-5 beside the bf16 step's and its peak memory; the f32
   passes must launch and no other K1 pass; the last step's beams equal K2
   of K1 f32; K1 f32 over all 160 streams within 1 code on <= 1e-3 of
   plain, its f32 FIR pass bit-exact, its DFT pass alone equal to it; K1
   f32 and each f32 pass (beside its plain version and its f32 bound)
   timed; the DFT pass's registers and spill bytes (a spill fails the
   phase); then the ``fused_f32`` route cut at each stop over all 160
   streams (dma, fir into the f32 plane, stagea, stageb, whole): each
   against its plain stop on the last 8 streams (with and without the
   requant), then timed by the chained 2-vs-6 marginal, its launches
   counted: the split of the f32 DFT pass. Then the flagship at every engine default (``FBEngine(cfg,
   n_spectra=256, quant_scale=QUANT_SCALE, beam_layout="natural")``:
   precision f32, K1 bf16 then K2's f32-weight form): the same steps, the
   median of steps 2-5 beside the bf16 step's and its peak memory; K1 and
   K2 must launch once a step; the last step's beams equal K2 f32 of K1;
   K2 f32 against plain over all 80 antennas (rtol 1e-5, atol 1e-3), timed
   beside its plain version, its bound (bytes; the three bf16 products a
   weight) and its products' f32 FFMA floor; its yardsticks as the bf16
   form's (registers, spill bytes, the bytes from L2, the fill, the stops).
   Then the FIR pass of K1 and K7 on each route that runs it
   (``FIR_ROUTES``: the flagship's coarse delays and every start 0, K7 at
   160 streams, fft 1024 and 2^22, K7 at 2^23), both planes: its last
   streams bit-exact against plain, timed over the route's plane groups
   (``fir_route_ms``, which a tree's ``ops/fengine_fused.py`` can be
   handed) beside its bound, with the share of starts off 4 bytes; every
   FIR body's registers and spill bytes (a spill fails the phase; phases 3
   and 12 log them too); its library yardstick, one cuDNN depthwise
   ``conv1d`` over the flagship streams' frames gathered at their starts.
   The FIR's f32 operations are ``fir_ops``: an FMUL for the first tap of
   an output, an FMUL and an FADD for each later one, two of the 67
   TFLOP/s rate's operations each.
7. corner_turn — K4 through ``corner_turn_planes`` at A=80, P=2, S=256,
   C=32768 vs its plain version, bit-exact; ``corner_turn_planes_x`` (K5a)
   must be the same bytes viewed as ``[C, 2AP, S]``; kernel and plain times;
8. xcorr   — at the same shapes, K3 through ``correlate_planes_fused`` vs its
   plain version, bit-exact; its yardsticks: a fill of its two outputs, its
   body's registers and local (spill) bytes (a body that spills fails the
   phase) and, on the log line only, the bytes its geometry stages from L2;
   its stage stops (the copies, the MMAs, the stores, alone and in pairs),
   each checked for what it writes and timed; then the two-pass X path (K5a,
   then K5b through ``correlate_turned_fused``) driven with its launch
   counts reset, and K5b held bit-exact against its plain version; K5b's
   yardsticks: the same fill, its body's registers, local (spill) bytes
   and the plan its C side takes (a body that spills fails the phase), its
   stage stops, each checked for what it writes and timed, and K5a + K5b
   beside K3 on the log line; then K5b where a channel's rows are streamed
   in stages (I=160, S=1024, C=4096), bit-exact and timed; kernel and plain
   times;
9. fxb_engine — FXBEngine at 8 antennas x 32768 ch x 16 beams x 16 taps,
   S=256, vs the plain chain on the same device tensors: F planes within 1
   code on <= 1e-3, visibilities exactly the plain gram of the step's own F
   planes, beams within phase 5's per-beam flip bound; then FXBEngine at 80
   antennas x 64 ch (fft 128) x 16 beams x 16 taps, S=256, with the
   backends it resolves (the composed F), 3 steps: each must launch K5b
   once and K3 never, and its visibilities must equal the plain gram of
   its own turned F planes;
10. fxb_flagship — FXBEngine at 80 x 32768 x 16 x 16, S=256, bf16, int8
   beams (beam_quant_scale 0.25), the default backends (K1, K4 + the f32
   product, K3): set_beam_delays, 3 steps, a delay update, 2 steps on fresh
   wire-rowed ADC; the launch counts of K1, K4 and K3 must rise and K2's
   stay 0; outputs finite and of the right shapes; the last step's
   visibilities must equal K3(K1(adc)); prints ms/step, Msamples/s, the
   FXB/FB step ratio against phase 6 and the step split by stage.
11. fir    — K6 through ``pfb_fir`` at the flagship shapes (160 streams x 271
   frames x 65536, 16 taps, int8), then f32 frames on 8 streams: bit-exact
   against ``pfb_fir_reference``; kernel and plain ms, the byte floor, two
   streaming yardsticks on K6's byte mix (an int8 -> f32 copy of the frames,
   a fill of its output), and one cuDNN depthwise ``conv1d`` over the same
   frames as the library yardstick. Then the ragged shape (fft 1000, 17
   taps in two passes, S=300, 3 streams; int8 and f32, aligned and ``x[1:]``
   bases: the async and scalar copies) bit-exact, and each K6 body's
   registers and local (spill) bytes by ``cudaFuncGetAttributes``; a body
   that spills fails the phase;
12. fengine_dit — K7 through ``fengine_fused(deint="matmul")`` at fft 65536,
   taps 16, S=256 on 8 of the 160 streams, bf16 (K1's FIR pass, then the
   tensor-core DFT pass) and f32 DFT (K1's f32 FIR pass, then the FFMA DFT
   pass): bf16 within 1 code on <= 1e-3 of samples of
   ``fengine_dit_reference``, f32 within 1 code on <= 1e-4 (the reference's
   f32 contract); ``deint="bitcast"`` must give the same bytes; each type
   must launch its own FIR pass and DFT pass once a group a call and no
   other pass; kernel and plain ms; the DFT passes' registers and spill
   bytes (a spill fails the phase); cuFFT's rfft of the same streams' f32
   FIR as the yardstick; f32: the f32 FIR pass on zero starts equal to
   K7's FIR, the f32 DFT pass alone equal to K7 f32 and timed beside its
   plain version and bound. Then K7 bf16 at all 160 flagship streams: its
   last 8 streams against plain with the same bound, a FIR pass and a DFT
   pass a group of 32, the whole call, each pass and the DFT pass's stops
   (stage A alone: nothing written; with stage B: each stream's re,
   checked on a scaled plane) timed, and its scratch; then K7 f32 on the
   same 160 streams: its last 8 against plain at the f32 contract, a pair
   of f32 passes a group of 16, the whole call, each pass alone and the
   plain version timed, its bound and scratch. Then K7 on its routes off
   the flagship's split at the flagship's 2.7 G samples
   (``K7_ROUTE_CASES``: N1 = 8 at fft 1024 in both forms on two passes;
   f32 fft 2^21 and bf16 and f32 fft 2^23 on three): each route's passes,
   once a group and nothing else; its last streams against plain at its
   form's contract; the call, each pass over all the streams, the plain
   version, the bounds and the scratch; each three-pass stage alone against
   its plain version; K7 at the geometries its parent's SIMT body was
   timed at (``K7_TIMED_CASES``); every route body's registers and spill
   bytes (a spill fails the phase);
13. f_flagship — FEngine at 80 ant x 32768 ch x 16 taps, S=256 on flat int8
   ADC made on the card: 3 steps, a fine-delay change, 2 steps; K6 must
   launch and K1 and K7 must not; the output [80, 2, 256, 32768, 2] int8
   must equal the composed chain with ``pfb_fir_reference`` in K6's place
   bit for bit; prints ms/step, Msamples/s, peak memory and the step split
   (K6, cuFFT, the plain ops) by torch.profiler. Then the qualification's
   CW tone through ``FEngine(quantise_output=False)`` (peak in channel 37,
   leakage <= -62 dB), and ``FBEngine`` / ``FXBEngine(fengine="xla")`` at 8
   antennas x 32768 ch x 16 beams x 16 taps, S=256: F planes equal to the
   plain composed chain, beams within rtol 1e-5 / atol 1e-3 of the plain B
   stage of those planes, visibilities exactly their gram; K6 and the
   engine's B and X kernels each launched, K1 not.
14. bforms — K8 through ``corner_turn_plane_native`` on both flagship
   planes (the 5-d view [80, 2, 256, 128, 256] of K1's output): bit-exact
   against its plain version and equal to K4's halves; kernel, plain and
   ``permute(3, 0, 1, 2).contiguous()`` times. Then ``FBEngine(bstage=
   "turned", fengine_native_handoff=True, beam_layout="natural")`` at the
   flagship, bf16: set_beam_delays, 3 steps, a delay update, 2 steps; K1
   must launch 5 times and K8 10 (twice a step), K4 and K2 never; the last
   step's beams within rtol 1e-4 / atol 1e-3 of the flat turned path on the
   same device inputs; prints the step split by torch.profiler, ms/step and
   Msamples/s, and each B form's stage time on the step's F planes. Then
   ``bstage="planar"`` and ``"folded"`` at 8 antennas x 32768 ch x 16 beams
   x 16 taps, S=256, f32, each within rtol 1e-5 / atol 1e-4 of ``"turned"``;
   and ``FXBEngine`` at S=96 (outside K2's and K4's gates: planar B, plain
   grams), its visibilities exactly the gram of its own F planes and its
   beams the planar B stage of them.
15. qualification — the channelisation qualification's CW tone (channel
   100 of 512, 16 taps, S=8, TPDF dither, seed 2021) through K1's
   unquantised output (``fengine_fused(quantise=False)``), bf16 and f32 DFT:
   the peak in channel 100, worst leakage <= -62 dB, bf16 within 6 dB of
   f32 (fft 1024: N1 = 8, K1's two passes' N1 = 8 plans); the same recipe
   at 1024 channels (tone in channel 200, fft 2048, N1 = 16) through K1's
   f32 two passes and through its plain version, each meeting the spec and
   the two within 1 dB. Then K1's f32 output on 8 of the 160 flagship streams against its
   plain version: f32 DFT within rtol 1e-4 / atol 1e-2; bf16 DFT (a
   different f32 sum order flips a few bf16 roundings in stage A) below 1
   code unit everywhere and within that bound on all but 1e-2 of the
   samples, its max |d| and share over the bound printed; the int8 output
   of the same kernel equal to the requant of its f32 output; kernel and
   plain ms. Then two qualification scenarios
   at the flagship width, their tone's channel scaled with the fft (K = 40 * fft / 256 = 10240, a 32-sample
   period): beam steering through ``FBEngine``'s default path (K1 + K2,
   natural packed beams, bf16) at 80 ant x 32768 ch x 16 beams x 16 taps,
   S=256, the tone with a uniform phase gradient over one full turn, beam 0
   steered at it and beam 1 boresight, the F requant gain 2/fft so that the
   tone's int8 codes stay unsaturated (their peak logged): the steered beam
   at least 0.95 x 80^2 of one antenna's power (the same engine with one-hot
   ``ant_weights``) and boresight at least 20 dB down; delay tracking through
   ``FEngine`` (K6, f32 output) at 2 ant x 32768 ch x 16 taps, S=256, the
   second antenna 3.25 samples late, corrected through ``delay_solution``:
   phase error < 0.02 rad and coherence > 0.999, uncorrected coherence < 0.5.
   K1's, K2's and K6's launch counts must rise.

16. e1    — the example ``dpdk_dc_sand_tpu_torch.examples.vector_add`` under
   ``PipelineTest`` at n = 1 << 22 (its report printed; E1's launch count from
   it), then E1 through ``vector_add`` vs its plain ``x + y`` at 1 << 22 and
   1 << 28, bit-exact; kernel, plain and ``torch.add(out=)`` times at 1 << 28,
   bound 12n bytes over 3.35 TB/s;
17. node  — ``EngineNode`` at the flagship array (80 x 32768 x 16 x 16, S=256,
   int8 beams with ``beam_quant_scale`` 0.25, 3 page-locked ring slots) with
   ADC made on the card from a seed and copied to the host once; the delay
   model and 16 beams' steering sent through ``Client``; 12 chunks committed
   in place through the ring's write side (``acquire_write`` /
   ``commit_write``, each slot filled once), 4 more under torch.profiler, 6
   through ``submit_chunk`` (the producer copies each chunk). Fails unless
   ``chunks-processed`` is 22, ``chunks-lost`` 0, ``device-status`` ok, no
   error ``#log``, K1 and K4 launched once a chunk, every H2D from a pinned
   slot on the feed's own stream, and the beams of chunks 1 and 11 equal
   ``node.fb.step`` on the same chunk bit for bit. Prints the decomposition:
   compute-only step, node Msamples/s both ways, H2D GB/s, the beams' D2H
   and the device idle share;
18. node_udp — the node at benchmarks/NODE_RATE.json's geometry (16 ant x 4096
   ch x 8 beams x 8 taps, S=64) through loopback SPEAD-lite UDP ingest and
   int8 UDP beam egress, 4 chunks, every sender paced to 1 Gbps, with ``?delay-model``, ``?beam-delays``
   with a phase rate (steering re-extrapolated every chunk) and
   ``?sensor-value`` through ``Client``; then again with
   ``emit_visibilities=True`` and ``UdpVisEgress``. Every heap must arrive,
   the sensors agree, the last beam heap equal ``fb.step`` and the last
   visibility dump the sum of its two steps' visibilities.
19. probes — the JAX package's five probe scripts, ported
   (``dpdk_dc_sand_tpu_torch.benchmarks``), each at its own full geometry
   and held against its plain version first: P5 (``ct_ablate``: K1 cut at
   dma, fir, stagea, stageb and K1 itself, 160 streams x S=256, checked on 8
   streams with the window scaled to keep each stop in int8 range, dma and
   fir bit-exact, the rest within 1 code on <= 1e-3; dma and fir bit-exact
   on the timed run's last 8 streams, K1's last group), P4
   (``dma_bisect``: the dma stop from three layouts, S=128, bit-exact), P2
   (``fused_ablate``: K7's route cut at six stops and whole, 8 streams x
   S=64: K1's FIR pass cut at dma, conv, fir and deint, then K7's DFT pass
   cut at stagea and stageb, and K7's two passes; bit-exact up to deint, 1
   code after), P3 (``fir_probe``: both
   loop orders, bit-exact; its device time by torch.profiler, as its kernel
   is shorter than a Python launch; its shared-memory load rate and a cuDNN
   depthwise ``conv1d`` yardstick) and P1 (``ct_kernel_probe``: the script's tilings and turns
   whose spectra chunk divides S=128, and both minor-antenna modes; bit-exact;
   ``permute().contiguous()`` as the yardstick). Every stop or mode is timed
   by the chained 2-vs-6 marginal with its launch counters reset just before;
   a counter left at 0 fails the run.
20. sharded — ``parallel.ShardedFBEngine`` on a one-rank NCCL group in this
   process (a (1, 1) ``DeviceMesh``; the backend logged) at the flagship, 80
   ant x 32768 ch x 16 beams x 16 taps, S=256, bf16, nothing cut: (a)
   ``"auto"`` must resolve fused F and turned B (K1, K4 and the product),
   5 steps on fresh ADC, the last held to ``FBEngine`` with the same
   backends on the tail-prepended stream (zero coarse delays) at rtol 1e-4 /
   atol 1e-3, max |d| logged; (c) ``ici_chunks=2`` on the same ADC equal to
   (a) bit for bit; (d) ``emit_visibilities=True``: its visibilities equal
   to ``correlate_planes_fused`` (K3) of ``FBEngine``'s planes bit for bit;
   (b) ``bstage="fused"`` (K1 then K2), 5 steps, held as (a). The launch
   counts of K1, K4, K2 and K3 are reset before each sharded run and read
   after it; one left at 0 fails the phase. Logs the step medians (steps
   2-5) and Msamples/s beside ``FBEngine``'s, one step of (a) split by
   torch.profiler (NCCL, K1, K4, cuBLAS, copies) and the peak memory.
21. characterize — ``mxu_dynamic_range`` in bf16 and f32 on the tensor
   cores (equal to its plain version, the f32 product of the rounded
   inputs), ``matmul_roofline`` for bf16 at n = 8192 and f32 at n = 4096
   (TFLOP/s), ``TransferRateTest`` h2d, d2h and both (in series) at 100 x 5
   MiB pageable frames (Gbps), and the host RAM ``mem_rate`` for 1-4 threads,
   by the numpy scan and by the host library's ``membw_scan``; a non-finite or
   non-positive rate fails the phase, no rate is gated.
22. instrument — a port ``CorrServlet`` fronting two port ``EngineNode``s on
   the card at the flagship array (80 x 32768 x 16 x 16, S=256; fused F and
   turned B: K1, K4 and the product; int8 split beams, ``beam_quant_scale``
   0.25; two page-locked slots each), one shared ``auth_secret``, an explicit
   ``request_timeout``, the servlet, the nodes and the ``Client`` on one
   asyncio loop: (a) each node takes a chunk; (b) ``?delay-model`` (4 x 80
   values, coarse within the budget) and ``?beam-weights`` (80 values, not
   all 1) through the servlet alone; (c) each node takes the same chunk
   again: its beams must equal ``node.fb.step`` with the node's new state bit
   for bit and differ from (a)'s; (d) a ``?delay-model`` with one coarse value
   past the budget must fail naming both nodes and degrade the servlet's
   ``device-status`` (WARN), and the next chunk's beams on each node still
   equal (c)'s; (e) ``?sensor-value`` on the servlet shows ``node0.*`` and
   ``node1.*`` equal to each node's own sensors. K1's and K4's counts, reset
   before (a) and read after (d), must be 6 each. Logs each node's chunk ms
   (commit to beams) with both nodes sharing the card, the fan-out round
   trips of (b) and the peak device memory.

23. node_native — ``EngineNode`` at the flagship channeliser (32768 ch x 16
   beams x 16 taps, bf16) on 4 antennas x 2 pol, S=64 (fused F, turned B: K1,
   then K4 and the product; int8 split beams, ``beam_quant_scale`` 0.25; 4
   slots), its ring native and page-locked (a slot view ``is_pinned()``), fed
   by the native burst-UDP engine (a ``BurstUdpReceiver`` on the node's ring,
   through ``attach_ingest``) straight into the ring: (a) for each socket engine mode that opens (burst, gso,
   uring; one that does not is logged with its ``OSError``) and each wire
   format (lite, spead64), a fresh node, the delay model and 16 beams'
   steering through ``Client``, 4 chunks of 41,420,800 B each sent once, one
   heap in flight, each heap complete within 10 s: the receiver's stats 4
   heaps, 4 x 10,113 packets, 0 ``ring_drops``, 0 ``evicted``; K1
   and K4 launched 4 times each (counts reset before the chunks); the
   sensors; every H2D from a pinned slot; each chunk's beams equal to
   ``node.fb.step`` on it with the node's state, bit for bit. (b) gso with
   lite frames paced a chunk at a time: 5 trials of 2 s bisecting to the
   highest rate at which every chunk is stepped (no heap lost) and the sender
   kept within 3% of its pace; logs the rate sent (chunks x bits / elapsed),
   and from it node Msamples/s, the realtime multiple (/ 13,696) and the chunk split
   (wire, H2D, step, the pageable D2H of 134.2 MB of beams). (c) each mode
   that opens blasts 4 MiB heaps for 2 s with no node: tx / rx Gbps and the
   loss. (d) AF_XDP over a veth pair (an ``XdpReceiver`` on the node's ring,
   3584-B payloads, each chunk sent once): (a)'s checks; where the
   veth or the XSK cannot be made, the reason is logged and recorded as
   ``"not run: ..."``, and once open any failure fails the phase. Rates are
   logged, not gated.

Every kernel in the ``kernels`` line carries its bound: the larger of the
bytes it must move over 3.35 TB/s and each type of operation over the
card's peak for it (bf16 989, f32 67 TFLOP/s, int8 1979 TOP/s), from this
run's shapes.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PHASES = ("device", "build", "k1", "k2", "engine", "flagship", "corner_turn", "xcorr",
          "fxb_engine", "fxb_flagship", "fir", "fengine_dit", "f_flagship", "bforms",
          "qualification", "e1", "node", "node_udp", "probes", "sharded", "characterize",
          "instrument", "node_native")
SEED = 2021
#: F requant gain for fft 65536 on uniform +-64 noise: 1/16 (the reference
#: default, sized for fft 1024) saturates most codes at +-127; 1/128 keeps
#: the int8 planes at a few tens of codes rms, so the checks see real values.
QUANT_SCALE = 1 / 128
#: The flagship array and its spectra a step (bench.py:171-176).
FLAG = dict(n_ants=80, n_channels=32768, n_beams=16, n_taps=16)
FLAG_S = 256
#: One H100 SXM's published rates (NVIDIA's data sheet, dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}


#: The channelisation qualification's tone (tests/qualification/chan_common.py):
#: C channels, TAPS taps, S spectra, the tone in channel K.
TONE_C, TONE_TAPS, TONE_S, TONE_K = 512, 16, 8, 100
LEAKAGE_SPEC_DB = -62.0


def log(msg: str) -> None:
    print(msg, flush=True)


def qualification_tone(c: int = TONE_C, k: int = TONE_K):
    """The qualification's TPDF-dithered int8 CW tone at the centre of channel
    ``k`` of ``c``, ``[1, 1, frames, fft]`` (the recipe of
    ``tests/qualification/chan_common.py:make_tone``, seed 2021)."""
    import numpy as np

    fft, n_frames = 2 * c, TONE_S + TONE_TAPS - 1
    n = np.arange(n_frames * fft)
    rng = np.random.default_rng(2021)
    dither = rng.uniform(-0.5, 0.5, n.size) + rng.uniform(-0.5, 0.5, n.size)
    tone = np.clip(np.round(120 * np.cos(2 * np.pi * k * n / fft) + dither), -127, 127)
    return tone.astype(np.int8).reshape(1, 1, n_frames, fft)


def cuda_ms(fn, iters: int = 3) -> float:
    """Mean ms per call of ``fn`` on the card (CUDA events, after one warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def bound(nbytes: float, **ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and each operation type's count over its peak rate."""
    times = {"bytes": nbytes / HBM_BYTES_PER_S}
    times.update({kind: n / PEAK_OPS_PER_S[kind] for kind, n in ops.items()})
    worst = max(times, key=times.get)
    return dict(bound_ms=times[worst] * 1e3,
                bound_by="bytes" if worst == "bytes" else "operations")


def fir_ops(outputs: float, taps: int) -> float:
    """The FIR's f32 operations as ``PEAK_OPS_PER_S["f32"]`` counts them:
    an output's first tap is an FMUL, each later tap an FMUL and an FADD
    (the product rounded before the sum, as the plain version rounds it: no
    FMA), and each takes one FP32 issue slot, which the 67 TFLOP/s rate
    counts as two operations (one FFMA). So 2·(2·taps - 1) an output: 2.48
    ms at the flagship's 16 taps, not 1.28."""
    return 2 * (2 * taps - 1) * outputs


def _conv1d_fir(fill, shape, win, ref) -> tuple:
    """The FIR's library yardstick: one cuDNN depthwise ``conv1d`` computes
    its sums over frames laid out ``shape`` = ``[B, fft, n_frames]`` in f32,
    which ``fill(xt)`` writes (untimed), against ``win`` ``[taps, fft]``.
    Held to ``ref``, the plain f32 sums ``[k, S, fft]`` of the first k
    streams, within 1e-3 + 1e-5·max|ref|, then timed. Returns its ms (None
    where it disagrees, or cuDNN has no memory or no algorithm for it) and a
    note."""
    import torch
    import torch.nn.functional as F

    lib_ms, note, xt, wt = None, "", None, None
    try:
        xt = torch.empty(shape, dtype=torch.float32, device=win.device)
        fill(xt)
        wt = win.t().contiguous().unsqueeze(1)  # [F, 1, taps]

        def lib():
            return F.conv1d(xt, wt, groups=shape[1])

        d = float((lib()[: ref.shape[0]].transpose(1, 2) - ref).abs().max())
        note = f"max |d| vs plain on {ref.shape[0]} streams {d:.3e}"
        if d <= 1e-3 + 1e-5 * float(ref.abs().max()):
            lib_ms = cuda_ms(lib, iters=1)
        else:
            note = f"— (conv1d does not compute the FIR here: {note})"
    except RuntimeError as e:  # out of memory, or no cuDNN algorithm for it
        note = f"— (conv1d failed: {str(e).splitlines()[0]})"
    finally:
        xt = wt = None
        torch.cuda.empty_cache()
    return lib_ms, note


def phase_device(st: dict) -> None:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    st["card"] = smi[0].strip()
    log(st["card"])  # name, power limit: exactly as nvidia-smi prints them
    from dpdk_dc_sand_tpu_torch import _build

    nvcc = _build.find_nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True, check=True)
    log(f"nvcc: {ver.stdout.strip().splitlines()[-1]}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")


def phase_build(st: dict) -> None:
    from dpdk_dc_sand_tpu_torch import _build
    from dpdk_dc_sand_tpu_torch.native import load_native

    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc, one process per source, "
        f"into {_build.BUILD_DIR.name}/)")
    # Each source's nvcc seconds, all started together (empty where the
    # library came from the cache).
    log("build: seconds a source " + ", ".join(
        f"{k} {v:.1f}" for k, v in sorted(_build.BUILD_SECONDS.items(), key=lambda kv: kv[1])))
    st["build_seconds"] = dict(_build.BUILD_SECONDS)
    t0 = time.perf_counter()
    host = load_native()
    if host is None:
        raise RuntimeError("no g++ on PATH: the host library (native/*.cpp) cannot be built")
    log(f"build: host library {os.path.basename(host._name)} in {time.perf_counter() - t0:.1f} "
        f"s (g++ {' '.join(_build.GXX_FLAGS)}, {len(_build.HOST_SOURCES)} sources)")


def _k1_plain(x, starts, window, rotc, rots, out, *, chunk, **kw):
    """The plain K1 over ``chunk`` batches at a time into ``out`` (qr, qi)."""
    from dpdk_dc_sand_tpu_torch.ops.fengine_fused import fengine_fused_reference

    for b0 in range(0, x.shape[0], chunk):
        b = slice(b0, b0 + chunk)
        pr, pi = fengine_fused_reference(x[b], starts[b], window, rotc[b], rots[b], **kw)
        out[0][b], out[1][b] = pr, pi


#: K1's launch counters: its bf16 and f32 passes on the two-pass and
#: three-pass routes.
K1_COUNTERS = ("k1_fir", "k1_dft", "k1_fir_f32", "k1_dft_f32", "k1_stage_a", "k1_stage_b",
               "k1_stage_a_f32", "k1_stage_b_f32")


def _k1_counts(ff) -> dict:
    return {k: getattr(ff, k).launches for k in K1_COUNTERS}


def _code_diff(tag, got, ref, max_frac=1e-3, check=True):
    """max |d| in int8 codes over (qr, qi); raise past 1 code or ``max_frac``
    of samples (1e-3: the bf16 contract; 1e-4: the reference's f32 contract,
    ``tests/test_fengine_fused.py:84-99``); ``check=False`` only logs."""
    import torch

    worst = 0
    for name, g, r in zip(("qr", "qi"), got, ref):
        d = (g.to(torch.int16) - r.to(torch.int16)).abs()
        dmax, frac = int(d.max()), float((d != 0).float().mean())
        sat = float((r.abs() == 127).float().mean())
        rms = float(r.float().pow(2).mean().sqrt())
        log(f"{tag} {name}: max|d| {dmax} code, frac(d!=0) {frac:.3e}; plain rms "
            f"{rms:.1f} codes, saturated {sat:.2e}")
        if check and (dmax > 1 or frac > max_frac):
            raise AssertionError(f"{tag} {name} disagrees with plain: {dmax}, {frac}")
        worst = max(worst, dmax)
    return worst


def _beam_diff(tag, got, ref, rtol=1e-5, atol=1e-3):
    """max |d| of f32 beams; raise outside rtol, atol."""
    d = (got - ref).abs()
    bad = int((d > atol + rtol * ref.abs()).sum())
    dmax = float(d.max())
    log(f"{tag}: max|d| {dmax:.3e}, out of tol {bad}, |ref| max {float(ref.abs().max()):.1f}")
    if bad:
        raise AssertionError(f"{tag} disagrees with plain")
    return dmax


def phase_k1(st: dict) -> None:
    import torch

    from dpdk_dc_sand_tpu_torch.ops import fengine_fused as ff
    from dpdk_dc_sand_tpu_torch.ops.delay import clamp_starts
    from dpdk_dc_sand_tpu_torch.ops.pfb import default_window

    dev = torch.device("cuda")
    _fir_bodies(st, "k1")
    fft, taps, s, lead = 65536, 16, 256, (4, 2)  # 8 of the flagship's 160 batches
    nb = lead[0] * lead[1]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n1, n2 = ff._split_ct(fft)
    out_len = (s + taps - 1) * fft
    n_in = out_len + 4096  # a multiple of N2, so the rowed view exists
    x = torch.randint(-64, 64, (*lead, n_in), dtype=torch.int8, device=dev, generator=gen)
    cd = torch.randint(0, 4096, lead, device=dev, generator=gen)
    cd[0, 0], cd[-1, -1] = -100, n_in  # both clamp, as dynamic_slice would
    fd = torch.rand(lead, device=dev, generator=gen) - 0.5
    ph = -3.14159265 * fd / 2
    win = default_window(taps, fft, device=dev)
    starts = clamp_starts(cd.reshape(nb), n_in, out_len)
    rc, rs = (r.reshape(nb, -1) for r in ff.fine_rotation_planes(
        fd, ph, n_channels=fft // 2, quant_scale=QUANT_SCALE))
    worst = 0
    # bf16 through the flat streams (the engine's form), f32 through the rowed view.
    for dt, rowed in (("bfloat16", False), ("float32", True)):
        frames = x.reshape(*lead, -1, n2) if rowed else x

        def kern():
            return ff.fengine_fused(frames, win, fd, ph, n_channels=fft // 2,
                                    quant_scale=QUANT_SCALE, dft_dtype=dt,
                                    coarse_delays=cd, n_spectra=s, rowed=rowed)

        ref = tuple(torch.empty((nb, s, fft // 2), dtype=torch.int8, device=dev)
                    for _ in range(2))

        def plain():
            _k1_plain(x.reshape(nb, -1), starts, win, rc, rs, ref, chunk=nb,
                      n_spectra=s, n1=n1, n2=n2, dft_dtype=dt)

        counts = _k1_counts(ff)
        got = kern()
        plain()
        torch.cuda.synchronize()
        # bf16 runs the two bf16 passes; f32 the f32 FIR pass and the FFMA DFT
        # pass; neither a stage of the three-pass route.
        want_passes = (("k1_fir", "k1_dft") if dt == "bfloat16" else ("k1_fir_f32", "k1_dft_f32"))
        ran = {k: v - counts[k] for k, v in _k1_counts(ff).items()}
        if ran != {k: int(k in want_passes) for k in ran}:
            raise AssertionError(f"k1 {dt}: the call ran {ran}, want one each of {want_passes}")
        worst = max(worst, _code_diff(f"k1 {dt} rowed={rowed}",
                                      [g.reshape(nb, s, -1) for g in got], ref))
        ms, pms = cuda_ms(kern), cuda_ms(plain, iters=1)
        log(f"k1 {dt} [{nb} batches x S={s} x fft {fft}]: kernel {ms:.3f} ms, "
            f"plain {pms:.3f} ms ({st['card']})")
        if dt == "bfloat16":
            st["k1_subset"] = dict(subset_ms=ms, subset_plain_ms=pms)
        else:
            st["k1_f32_subset"] = dict(ms=ms, plain_ms=pms)
    f32 = st["k1_f32_subset"]
    for name, fir, kw in (("k1 FIR pass", ff.k1_fir, {}),
                          ("k1 f32 FIR pass", ff.k1_fir_f32, dict(dft_dtype="float32"))):
        _exact(f"{name} [{nb} batches x S={s} x fft {fft}]",
               (fir(x.reshape(nb, -1), starts, win, n_spectra=s),),
               (ff.k1_fir_reference(x.reshape(nb, -1), starts, win, n_spectra=s, **kw),))
    # Above the old 65536 cap: K1's two passes at N1 x N2 = 512 x 256, 512 x 512
    # and 1024 x 1024, bf16 and f32 operands.
    for big in (1 << 17, 1 << 18, 1 << 20):
        bn1, bn2 = ff._split_ct(big)
        bs, bnb = 8, 2
        bx = torch.randint(-64, 64, (bnb, (bs + taps - 1) * big + 999), dtype=torch.int8,
                           device=dev, generator=gen)
        bcd = clamp_starts(torch.tensor([3, 999], device=dev), bx.shape[1],
                           (bs + taps - 1) * big)  # one start unaligned, one at the end
        bfd = torch.rand(bnb, device=dev, generator=gen) - 0.5
        bscale = QUANT_SCALE * (fft / big) ** 0.5  # the codes' rms as at the flagship
        brc, brs = (r.reshape(bnb, -1) for r in ff.fine_rotation_planes(
            bfd, -1.5 * bfd, n_channels=big // 2, quant_scale=bscale))
        for dt in ("bfloat16", "float32"):
            got = ff.fengine_fused(bx, default_window(taps, big, device=dev), bfd, -1.5 * bfd,
                                   n_channels=big // 2, quant_scale=bscale, coarse_delays=bcd,
                                   n_spectra=bs, dft_dtype=dt)
            ref = ff.fengine_fused_reference(bx, bcd, default_window(taps, big, device=dev),
                                             brc, brs, n_spectra=bs, n1=bn1, n2=bn2,
                                             dft_dtype=dt)
            torch.cuda.synchronize()
            err = _code_diff(f"k1 {dt} fft {big} [{bnb} batches x S={bs}, {bn1}x{bn2}]",
                             got, ref)
            if dt == "bfloat16":
                worst = max(worst, err)
            else:
                f32["max_abs_err"] = max(f32.get("max_abs_err", 0), err)
    st["k1_subset"]["subset_max_abs_err"] = float(worst)
    _k1_three_pass_2_22(st, gen)
    _k1_stops(st, gen)
    for fft_w, s_w in K1_FULL_WIDTH:
        _k1_full_width(st, gen, fft_w, s_w)
    _engines_on_the_card(st, 1 << 16, ("FBEngine", "FXBEngine"))
    _engines_on_the_card(st, FB512_C, ("FBEngine",))
    _fb_512(st)


#: K1's first fft whose DFT pass has no shared-memory plan in either form
#: (2048 x 2048): the three-pass route's.
K1_THREE_PASS_FFT = 1 << 22
#: K1 at full width (160 streams, 16 taps): (fft, S) — fft 1024 (N1 = 8) at
#: 2^24 samples a stream, and fft 2^22 at S = 4 (2^24 samples a stream, as
#: the flagship's step).
K1_FULL_WIDTH = ((1024, 16384), (1 << 22, 4))
#: The FBEngine(fengine="auto") step at 512 channels (fft 1024, N1 = 8):
#: channels and spectra a step (2^24 samples a stream).
FB512_C, FB512_S = 512, 16384


def _k1_case(n1, n2, nb, s, taps, dft_dtype, three):
    """K1's bound at a case (``chip_smoke.py:bound``) and its passes' own:
    each input byte read once (the streams' windows, the window, the
    rotation planes), each output written once; the FIR's f32 operations and
    the DFT's in the operand type. Per pass: the FIR pass writes its plane;
    stage A reads it and writes T re and im; stage B (or the DFT pass) reads
    those and writes the outputs."""
    fft, c = n1 * n2, n1 * n2 // 2
    item = 2 if dft_dtype == "bfloat16" else 4
    kind = "bf16" if dft_dtype == "bfloat16" else "f32"
    x_bytes = nb * (s + taps - 1) * fft + taps * fft * 4
    rot, out = 2 * nb * c * 4, 2 * nb * s * c
    plane = nb * s * fft * item
    f_ops = fir_ops(nb * s * fft, taps)
    a_ops, b_ops = nb * s * 4 * n1 * n1 * n2, nb * s * 4 * n1 * n2 * n2
    ops = {"f32": f_ops}
    ops[kind] = ops.get(kind, 0) + a_ops + b_ops
    k1 = bound(x_bytes + rot + out, **ops)
    passes = {"fir": bound(x_bytes + plane, f32=f_ops)}
    if three:
        passes["stage_a"] = bound(plane + 2 * plane, **{kind: a_ops})
        passes["stage_b"] = bound(2 * plane + rot + out, **{kind: b_ops})
    else:
        passes["dft"] = bound(plane + rot + out, **{kind: a_ops + b_ops})
    return k1, passes


def _k1_three_pass_2_22(st: dict, gen) -> None:
    """K1 at fft 2^22 (2048 x 2048), 2 streams x S=2 x 4 taps, both forms,
    where neither DFT pass has a shared-memory plan: ``fengine_fused`` must
    take the three-pass route (the form's FIR pass, stage A and stage B,
    once each) and nothing else; held to the plain version within the form's
    code contract and timed."""
    import torch

    from dpdk_dc_sand_tpu_torch.ops import fengine_fused as ff
    from dpdk_dc_sand_tpu_torch.ops.pfb import default_window

    dev = torch.device("cuda")
    fft, taps, s, nb = K1_THREE_PASS_FFT, 4, 2, 2
    n1, n2 = ff._split_ct(fft)
    x = torch.randint(-64, 64, (nb, (s + taps - 1) * fft), dtype=torch.int8, device=dev,
                      generator=gen)
    fd = torch.rand(nb, device=dev, generator=gen) - 0.5
    scale = QUANT_SCALE * (65536 / fft) ** 0.5  # the codes' rms as at the flagship
    win = default_window(taps, fft, device=dev)
    starts = torch.zeros(nb, dtype=torch.int64, device=dev)
    rc, rs = (r.reshape(nb, -1) for r in ff.fine_rotation_planes(
        fd, -1.5 * fd, n_channels=fft // 2, quant_scale=scale))
    st["k1_2_22_small"] = {}
    for dt in ("bfloat16", "float32"):
        sfx = "" if dt == "bfloat16" else "_f32"
        want = {f"k1_fir{sfx}", f"k1_stage_a{sfx}", f"k1_stage_b{sfx}"}
        if ff._k1_body(n1, n2, dt) != "three_pass" + sfx:
            raise AssertionError(f"K1 {dt} at {n1}x{n2} did not route to the three-pass route")

        def k1():
            return ff.fengine_fused(x, win, fd, -1.5 * fd, n_channels=fft // 2,
                                    quant_scale=scale, dft_dtype=dt,
                                    coarse_delays=torch.zeros(nb, device=dev), n_spectra=s)

        def plain():
            return ff.fengine_fused_reference(x, starts, win, rc, rs, n_spectra=s, n1=n1,
                                              n2=n2, dft_dtype=dt)

        counts = _k1_counts(ff)
        got = k1()
        torch.cuda.synchronize()
        ran = {k: v - counts[k] for k, v in _k1_counts(ff).items()}
        if ran != {k: int(k in want) for k in ran}:
            raise AssertionError(f"k1 {dt} at fft 2^22 ran {ran}, want one each of {want}")
        err = _code_diff(f"k1 {dt} fft {fft} [{nb} batches x S={s}, {n1}x{n2}, three passes]",
                         got, plain(), max_frac=1e-3 if dt == "bfloat16" else 1e-4)
        del got
        ms, pms = cuda_ms(k1, iters=2), cuda_ms(plain, iters=1)
        k1_bound, _ = _k1_case(n1, n2, nb, s, taps, dt, True)
        log(f"k1 {dt} fft {fft} [{nb} batches x S={s} x {taps} taps]: three passes {ms:.3f} ms "
            f"(bound {k1_bound['bound_ms']:.3f}, {k1_bound['bound_by']}), plain {pms:.3f} ms; "
            f"launches {ran} ({st['card']})")
        st["k1_2_22_small"][dt] = dict(ms=ms, plain_ms=pms, max_abs_err=float(err),
                                       bound_ms=k1_bound["bound_ms"])


#: K1's stage stops (``fengine_fused(_ablate=...)``), in the order they cut
#: its route.
K1_STOPS = ("dma", "fir", "stagea", "stageb")
#: K1's stops off the flagship's split (phase 3): (fft, streams, S, taps):
#: N1 = N2 = 512 and 1024 on the two-pass routes (as phase 3's K1 cases),
#: 2048 on the three-pass routes (its 2 x 2 x 4 case).
K1_STOP_CASES = ((1 << 18, 2, 8, 16), (1 << 20, 2, 8, 16), (1 << 22, 2, 2, 4))
#: The rms, in codes, a stop's values are scaled to for its check (the
#: window times a gain): inside int8, far from saturation. At gain 1 the
#: DFT stops' int8 outputs saturate, where K1's 1-code contract does not
#: hold (each case logs that reading, unchecked).
STOP_RMS = 16.0
#: The share of unquantised bf16-operand samples that may pass rtol 1e-5 /
#: atol 1e-3 (each within one bf16 ulp of the stop's largest value), as
#: tests/test_torch_ablate.py caps it against the JAX reference; the card
#: has read up to 1.2e-4 (stagea) and 5.7e-2 (stageb) against plain.
STOP_BF16_FLIPS = {"stagea": 1e-3, "stageb": 0.1}


def _stop_diff(tag, got, ref, stop, dft_dtype, quantise):
    """A K1 stop against its plain stop: ``dma`` and ``fir`` bit for bit;
    ``stagea`` and ``stageb`` in int8 within 1 code on <= 1e-3 of samples
    (K1's contract), their f32 values (``quantise=False``) with f32 operands
    within rtol 1e-5 / atol 1e-3, with bf16 operands within one bf16 ulp of
    the stop's largest value (2^-8 max|plain|: where the kernel's f32 sums
    flip a bf16 rounding of T, the values it feeds move by about that) on at
    most ``STOP_BF16_FLIPS`` of samples past that bound. Returns max |d|."""
    if stop in ("dma", "fir"):
        return _exact(tag, got, ref)
    if quantise:
        return _code_diff(tag, got, ref)
    worst = 0.0
    for name, g, r in zip(("outr", "outi"), got, ref):
        d = (g - r).abs()
        big, dmax = float(r.abs().max()), float(d.max())
        share = float((d > 1e-3 + 1e-5 * r.abs()).float().mean())
        log(f"{tag} {name}: max|d| {dmax:.3e}, past rtol 1e-5 / atol 1e-3 {share:.2e}, "
            f"max|plain| {big:.1f}")
        if ((dmax > 2.0 ** -8 * big or share > STOP_BF16_FLIPS[stop])
                if dft_dtype == "bfloat16" else share > 0):
            raise AssertionError(f"{tag} {name} disagrees with plain")
        worst = max(worst, dmax)
    return worst


def _route_passes(body: str) -> set:
    """The counters of the passes K1's route ``body`` runs in a whole call."""
    sfx = "_f32" if body.endswith("_f32") else ""
    if body.startswith("three_pass"):
        return {f"k1_fir{sfx}", f"k1_stage_a{sfx}", f"k1_stage_b{sfx}"}
    return {f"k1_fir{sfx}", f"k1_dft{sfx}"}


def _stop_gain(stop, plain_at) -> float:
    """The window gain that puts ``stop``'s values at ``STOP_RMS`` codes rms:
    ``plain_at(stop, 1.0)`` is its unquantised plain output at gain 1 (dma
    copies the input: gain 1)."""
    if stop == "dma":
        return 1.0
    return STOP_RMS / max(float(t.float().pow(2).mean().sqrt()) for t in plain_at(stop, 1.0))


def _k1_device_ms(fn, calls: int = 5) -> float:
    """Device time of one call of ``fn`` in K1's kernels (``k1_*``), by
    torch.profiler over ``calls`` calls: at 2 streams a call is shorter than
    its host side, which CUDA events would time. A trace that caught none of
    the kernels (it happened once in a run) is taken again, up to twice; a
    third miss raises."""
    import torch

    for _ in range(3):
        split, _ = _profile_split(torch, lambda: [fn() for _ in range(calls)],
                                  [("k1", ["k1_"]), ("other", [])])
        if split["k1"] > 0:
            return split["k1"] / calls
    raise AssertionError("three torch.profiler traces caught no k1_* kernel")


def _stop_bodies(ff, n1, n2, dt, tag) -> dict:
    """The stop bodies K1's stagea and stageb stops run at N1 x N2 in the
    operand type ``dt`` (registers, spill bytes); a spill fails."""
    bodies = ff.k1_stop_attributes(n1, n2, dt)
    spills = {k: v["local_bytes"] for k, v in bodies.items() if v["local_bytes"]}
    log(f"{tag} stop bodies: " + ", ".join(f"{k} {v['regs']} registers, {v['local_bytes']} "
                                          f"local bytes" for k, v in bodies.items()))
    if spills:
        raise AssertionError(f"{tag}: a stop body spills: {spills}")
    return bodies


def _k1_stops(st: dict, gen) -> None:
    """K1's stops off the flagship's split (``K1_STOP_CASES``), bf16 and f32,
    with the requant and without: each stop's call must launch its route's
    stopped pass (``fengine_fused.ablate_launches``) and no pass that the
    route's whole call does not; its outputs on the last stream are held to
    the plain stop (``_stop_diff``, the window scaled to ``STOP_RMS``; the
    DFT stops' int8 reading at gain 1 logged beside it, unchecked), and the
    quantised stop and the whole call are timed on the device
    (``_k1_device_ms``). The stop bodies' registers and spills (a spill
    fails)."""
    import torch

    from dpdk_dc_sand_tpu_torch.ops import fengine_fused as ff
    from dpdk_dc_sand_tpu_torch.ops.delay import clamp_starts
    from dpdk_dc_sand_tpu_torch.ops.pfb import default_window

    dev = torch.device("cuda")
    out = {}
    for fft, nb, s, taps in K1_STOP_CASES:
        n1, n2 = ff._split_ct(fft)
        x = torch.randint(-64, 64, (nb, (s + taps - 1) * fft + 999), dtype=torch.int8,
                          device=dev, generator=gen)
        cd = clamp_starts(torch.tensor([3, 999], device=dev), x.shape[1], (s + taps - 1) * fft)
        fd = torch.rand(nb, device=dev, generator=gen) - 0.5
        win = default_window(taps, fft, device=dev)
        rc, rs = (r.reshape(nb, -1) for r in ff.fine_rotation_planes(
            fd, -1.5 * fd, n_channels=fft // 2, quant_scale=QUANT_SCALE))
        last = slice(nb - 1, nb)
        for dt in ("bfloat16", "float32"):
            body = ff._k1_body(n1, n2, dt)
            tag = f"k1 stops {dt} fft {fft} [{nb} streams x S={s} x {taps} taps, {n1}x{n2}, {body}]"

            def call(stop, gain=1.0, q=True):
                return ff.fengine_fused(x, win * gain, fd, -1.5 * fd, n_channels=fft // 2,
                                        quant_scale=QUANT_SCALE, dft_dtype=dt, coarse_delays=cd,
                                        n_spectra=s, quantise=q, _ablate=stop)

            def plain(stop, gain=1.0, q=False):
                return ff.fengine_ablate_reference(stop, x[last], cd[last], win * gain, rc[last],
                                                   rs[last], n_spectra=s, n1=n1, n2=n2,
                                                   dft_dtype=dt, quantise=q)

            rec = dict(body=body, bodies=_stop_bodies(ff, n1, n2, dt, tag))
            for stop in K1_STOPS:
                gain = _stop_gain(stop, plain)
                err = 0.0
                for q in (True, False):
                    counts = dict(_k1_counts(ff), ablate=ff.fengine_fused.ablate_launches)
                    got = call(stop, gain, q)
                    torch.cuda.synchronize()
                    ran = {k: v - counts[k] for k, v in
                           dict(_k1_counts(ff), ablate=ff.fengine_fused.ablate_launches).items()}
                    stray = {k for k, v in ran.items() if v and k != "ablate"} - _route_passes(body)
                    if ran["ablate"] < 1 or stray:
                        raise AssertionError(f"{tag} {stop}: the call ran {ran}")
                    err = max(err, _stop_diff(f"{tag} {stop} q={q}", [g[last] for g in got],
                                              plain(stop, gain, q), stop, dt, q))
                if stop in ("stagea", "stageb"):  # why the check scales the window
                    _code_diff(f"{tag} {stop} q=True at gain 1 (unscaled, unchecked)",
                               [g[last] for g in call(stop)], plain(stop, q=True), check=False)
                rec[stop] = dict(device_ms=_k1_device_ms(lambda: call(stop)), max_abs_err=err,
                                 launches=ran)

            def whole():
                return ff.fengine_fused(x, win, fd, -1.5 * fd, n_channels=fft // 2,
                                        quant_scale=QUANT_SCALE, dft_dtype=dt, coarse_delays=cd,
                                        n_spectra=s)

            rec["full"] = dict(device_ms=_k1_device_ms(whole))
            order = (*K1_STOPS, "full")
            log(f"{tag}: device ms (K1's kernels, torch.profiler) " + ", ".join(
                f"{k} {rec[k]['device_ms']:.4f}" for k in order)
                + f"; each stop against plain on the last stream ({st['card']})")
            out[f"{fft}/{dt}"] = rec
    st["k1_stops"] = out


def _chunked(fn, nb, step=8):
    """``fn(slice)`` over ``nb`` streams, ``step`` at a time (the plain
    versions' f32 temporaries stay small)."""
    def run():
        for b0 in range(0, nb, step):
            fn(slice(b0, b0 + step))
    return run


def _k1_full_width_case(gen, fft: int, s: int) -> dict:
    """The full-width K1 case's inputs, made on the card from ``gen``: 160
    streams (80 ant x 2 pol) of int8 with S spectra of 16 taps and coarse
    delays up to 4096 samples, fine delays, the window, and the gain that
    keeps the codes near 50 rms, as at the flagship."""
    import torch

    from dpdk_dc_sand_tpu_torch.ops.pfb import default_window

    dev = torch.device("cuda")
    taps, lead = FLAG["n_taps"], (FLAG["n_ants"], 2)
    n_in = (s + taps - 1) * fft + 4096
    return dict(
        x=torch.randint(-64, 64, (*lead, n_in), dtype=torch.int8, device=dev, generator=gen),
        cd=torch.randint(0, 4096, lead, device=dev, generator=gen),
        fd=torch.rand(lead, device=dev, generator=gen) - 0.5,
        win=default_window(taps, fft, device=dev),
        scale=QUANT_SCALE * (65536 / fft) ** 0.5)


def _k1_full_width_call(ff, case: dict, s: int, dft_dtype: str):
    """K1 on the full-width case through ``fengine_fused`` of the module
    ``ff`` (it needs nothing newer than that entry point)."""
    c = case["win"].shape[1] // 2
    return ff.fengine_fused(case["x"], case["win"], case["fd"], -1.5 * case["fd"], n_channels=c,
                            quant_scale=case["scale"], dft_dtype=dft_dtype,
                            coarse_delays=case["cd"], n_spectra=s)


def _k1_full_width(st: dict, gen, fft: int, s: int) -> None:
    """K1 at full width, 160 streams (80 ant x 2 pol) x S spectra x 16 taps
    with coarse delays, both forms, through ``fengine_fused``: the route's
    passes, each once a group of its scratch, and nothing else (the counts
    set to 0 just before, read just after); the last 8 streams against plain
    within the form's code contract; K1 whole, each pass alone over all 160
    streams beside its plain version (8 streams at a time) and its bound,
    the scratch, and the DFT bodies' registers and spill bytes (a spill
    fails the phase, but for the bf16 DFT pass's, which is logged)."""
    import torch

    from dpdk_dc_sand_tpu_torch.ops import fengine_fused as ff
    from dpdk_dc_sand_tpu_torch.ops.delay import clamp_starts

    taps = FLAG["n_taps"]
    case = _k1_full_width_case(gen, fft, s)
    x, cd, fd, win = case["x"], case["cd"], case["fd"], case["win"]
    nb, n_in = x.shape[0] * x.shape[1], x.shape[2]
    c = fft // 2
    n1, n2 = ff._split_ct(fft)
    out_len = (s + taps - 1) * fft
    xs = x.view(nb, n_in)
    starts = clamp_starts(cd.reshape(nb), n_in, out_len)
    rc, rs = (r.reshape(nb, c) for r in ff.fine_rotation_planes(
        fd, -1.5 * fd, n_channels=c, quant_scale=case["scale"]))
    tail = slice(nb - 8, nb)
    for dt in ("bfloat16", "float32"):
        f32 = dt == "float32"
        sfx = "_f32" if f32 else ""
        body = ff._k1_body(n1, n2, dt)
        three = body.startswith("three_pass")
        names = [f"fir{sfx}"] + ([f"stage_a{sfx}", f"stage_b{sfx}"] if three else [f"dft{sfx}"])
        item = 4 if f32 else 2
        group = ff._plane_group(nb, s, fft, (3 if three else 1) * item)
        n_groups = -(-nb // group)
        tag = f"k1 {dt} fft {fft} [{nb} streams x S={s} x {taps} taps, {n1}x{n2}, {body}]"

        def k1():
            return _k1_full_width_call(ff, case, s, dt)

        for k in K1_COUNTERS:
            getattr(ff, k).launches = 0
        got = k1()
        torch.cuda.synchronize()
        launches = _k1_counts(ff)
        if launches != {k: n_groups * (k[3:] in names) for k in K1_COUNTERS}:
            raise AssertionError(f"{tag} ran {launches}, want {names} {n_groups} times each")
        ref = ff.fengine_fused_reference(xs[tail], starts[tail], win, rc[tail], rs[tail],
                                         n_spectra=s, n1=n1, n2=n2, dft_dtype=dt)
        err = _code_diff(f"{tag} streams {nb - 8}..{nb - 1}",
                         [g.view(nb, s, c)[tail] for g in got], ref,
                         max_frac=1e-4 if f32 else 1e-3)
        del got, ref
        k1_ms = cuda_ms(k1, iters=1)
        k1_bound, pass_bounds = _k1_case(n1, n2, nb, s, taps, dt, three)
        # Each pass alone over all 160 streams, and its plain version.
        fir = ff.k1_fir_f32 if f32 else ff.k1_fir
        res = {"fir": dict(ms=cuda_ms(lambda: fir(xs, starts, win, n_spectra=s), iters=1),
                           plain_ms=cuda_ms(_chunked(lambda b: ff.k1_fir_reference(
                               xs[b], starts[b], win, n_spectra=s, dft_dtype=dt), nb), iters=1),
                           max_abs_err=0.0)}
        plane = fir(xs, starts, win, n_spectra=s)
        if not torch.equal(plane[tail], ff.k1_fir_reference(xs[tail], starts[tail], win,
                                                            n_spectra=s, dft_dtype=dt)):
            raise AssertionError(f"{tag}: the FIR pass differs from plain")
        if three:
            stage_a = ff.k1_stage_a_f32 if f32 else ff.k1_stage_a
            stage_b = ff.k1_stage_b_f32 if f32 else ff.k1_stage_b
            a_ms = cuda_ms(lambda: stage_a(plane, n1=n1, n2=n2), iters=1)
            a_plain_ms = cuda_ms(_chunked(lambda b: ff.k1_stage_a_reference(
                plane[b], n1=n1, n2=n2, dft_dtype=dt), nb), iters=1)
            tr, ti = stage_a(plane, n1=n1, n2=n2)
            ref_t = ff.k1_stage_a_reference(plane[tail], n1=n1, n2=n2, dft_dtype=dt)
            t_err, t_share = 0.0, 0.0
            for g, r in zip((tr[tail], ti[tail]), ref_t):
                d = (g.float() - r.float()).abs()
                t_err = max(t_err, float(d.max()))
                t_share = max(t_share, float((d > 1e-5 * r.float().abs()).float().mean()))
            log(f"{tag}: stage A's T against plain on streams {nb - 8}..: max|d| {t_err:.3e}, "
                f"share off by more than 1e-5 relative {t_share:.3e}, T rms "
                f"{float(ref_t[0].float().pow(2).mean().sqrt()):.1f}")
            if t_share > (1e-4 if f32 else 1e-3):
                raise AssertionError(f"{tag}: stage A's T disagrees with plain")
            del plane, ref_t
            b_ms = cuda_ms(lambda: stage_b(tr, ti, rc, rs, n1=n1, n2=n2), iters=1)
            b_plain_ms = cuda_ms(_chunked(lambda b: ff.k1_stage_b_reference(
                tr[b], ti[b], rc[b], rs[b], n1=n1, n2=n2, dft_dtype=dt), nb), iters=1)
            b_err = _code_diff(f"{tag}: stage B on its own T, streams {nb - 8}..",
                               stage_b(tr[tail], ti[tail], rc[tail], rs[tail], n1=n1, n2=n2),
                               ff.k1_stage_b_reference(tr[tail], ti[tail], rc[tail], rs[tail],
                                                       n1=n1, n2=n2, dft_dtype=dt),
                               max_frac=1e-4 if f32 else 1e-3)
            del tr, ti
            res["stage_a"] = dict(ms=a_ms, plain_ms=a_plain_ms, max_abs_err=t_err)
            res["stage_b"] = dict(ms=b_ms, plain_ms=b_plain_ms, max_abs_err=float(b_err))
        else:
            dft = ff.k1_dft_f32 if f32 else ff.k1_dft
            res["dft"] = dict(ms=cuda_ms(lambda: dft(plane, rc, rs, n1=n1, n2=n2), iters=1),
                              plain_ms=cuda_ms(_chunked(lambda b: ff.k1_dft_reference(
                                  plane[b], rc[b], rs[b], n1=n1, n2=n2, dft_dtype=dt), nb),
                                  iters=1),
                              max_abs_err=float(err))
            del plane
        torch.cuda.empty_cache()
        if three:
            bodies = ff.k1_stage_attributes(n1, n2, dt)
        else:
            bodies = {"dft": (ff.k1_dft_f32_attributes if f32 else ff.k1_dft_attributes)(n1, n2)}
        # The stage bodies and the f32 DFT pass spill nothing; the bf16 DFT
        # pass's body spills a few bytes at every plan (PERF.md §7), logged.
        if any(at["local_bytes"] for name, at in bodies.items() if f32 or name != "dft"):
            raise AssertionError(f"{tag}: a body spills: {bodies}")
        for name, r in res.items():
            r.update(pass_bounds[name], library_ms=None)
        for stage, at in bodies.items():
            res["dft" if stage == "dft" else f"stage_{stage}"].update(
                regs=at["regs"], local_bytes=at["local_bytes"])
        k1_plain = sum(r["plain_ms"] for r in res.values())
        split = ", ".join(f"{n} {r['ms']:.3f} (bound {r['bound_ms']:.3f}, {r['bound_by']}; "
                          f"plain {r['plain_ms']:.3f})" for n, r in res.items())
        log(f"{tag}: K1 {k1_ms:.3f} ms (bound {k1_bound['bound_ms']:.3f}, "
            f"{k1_bound['bound_by']}, {k1_bound['bound_ms'] / k1_ms:.2%} of it; its passes' "
            f"plain versions {k1_plain:.3f}); alone: {split}; launches {launches}; scratch "
            f"{group} streams a group, {n_groups} groups, "
            f"{group * s * fft * item * (3 if three else 1) / 1e9:.3f} GB; bodies {bodies} "
            f"({st['card']})")
        st.setdefault("k1_full", {})[(fft, dt)] = dict(
            ms=k1_ms, plain_ms=k1_plain, max_abs_err=float(err), launches=launches,
            passes=res, group=group, **k1_bound)
    del x, xs, case
    torch.cuda.empty_cache()


def _fb_512(st: dict) -> None:
    """``FBEngine(fengine="auto")`` at 512 channels (fft 1024, N1 = 8) at the
    flagship array, 80 ant x 16 beams x 16 taps, S = 16384 (natural beams:
    the B stage resolves to the turn and the product there): the steps of
    :func:`_fb_steps`; K1 must run its two bf16 passes, once each a group,
    and no other K1 pass; beams finite; the median of steps 2-5."""
    import numpy as np
    import torch

    from dpdk_dc_sand_tpu_torch.ops import bstage, corner_turn, fengine_fused as ff

    for k in K1_COUNTERS:
        getattr(ff, k).launches = 0
    ff.fengine_fused.launches = bstage.beamform_turned_fused.launches = 0
    corner_turn.corner_turn_planes.launches = 0
    run = _fb_steps(fengine="auto", n_channels=FB512_C, n_spectra=FB512_S, seed=SEED + 5)
    fb, out, times = run["fb"], run["out"], run["times"]
    launches = {"k1": ff.fengine_fused.launches, "k2": bstage.beamform_turned_fused.launches,
                "k4": corner_turn.corner_turn_planes.launches, **_k1_counts(ff)}
    nb = 2 * FLAG["n_ants"]
    tag = (f"FBEngine(fengine='auto') [{FLAG['n_ants']} ant x {FB512_C} ch x "
           f"{FLAG['n_beams']} beams x {FLAG['n_taps']} taps, S={FB512_S}; "
           f"fengine={fb.fengine!r}, bstage={fb.bstage!r}]")
    if fb.fengine != "fused" or launches["k1"] != len(times):
        raise AssertionError(f"{tag} did not run K1 each step: {launches}")
    group = ff._plane_group(nb, FB512_S, 2 * FB512_C)
    want = {k: launches["k1"] * -(-nb // group) * (k in ("k1_fir", "k1_dft"))
            for k in K1_COUNTERS}
    if {k: launches[k] for k in K1_COUNTERS} != want:
        raise AssertionError(f"{tag}: K1 ran {launches}, want its two bf16 passes alone")
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{tag}: non-finite beams")
    ms = float(np.median(times[1:]))
    log(f"{tag}: step ms {['%.3f' % t for t in times]}, median(after first) {ms:.3f} ms, "
        f"{nb * FB512_S * 2 * FB512_C / ms / 1e3:.1f} Msamples/s, beams {tuple(out.shape)}, "
        f"peak memory {run['peak_gb']:.2f} GB; launches {launches} ({st['card']})")
    st["fb512"] = dict(ms=ms, launches=launches, peak_gb=run["peak_gb"])
    del fb, out, run
    torch.cuda.empty_cache()


def _engines_on_the_card(st: dict, n_channels: int, classes) -> None:
    """FBEngine (and FXBEngine) with fengine="auto" at ``n_channels`` on the
    card, K1 launched once, held to the same engine on the CPU (2 ant x 4
    beams x 4 taps, S=128): beams within 2 + 1e-3 and off by more than 1e-3
    on <= 5e-3 of them."""
    import torch

    from dpdk_dc_sand_tpu_torch import ArrayConfig
    from dpdk_dc_sand_tpu_torch import models
    from dpdk_dc_sand_tpu_torch.ops import fengine_fused as ff

    cfg = ArrayConfig(n_ants=2, n_channels=n_channels, n_beams=4, n_taps=4)
    for cls in (getattr(models, name) for name in classes):
        kw = dict(n_spectra=128, precision="bf16", quant_scale=1 / 64)
        gpu = cls(cfg, device=torch.device("cuda"), **kw)
        cpu = cls(cfg, device="cpu", **kw)
        name = f"{cls.__name__}(fengine='auto') [A=2 C={n_channels} B=4 taps=4 S=128]"
        if gpu.fengine != "fused":
            raise AssertionError(f"{name} resolved fengine={gpu.fengine!r}")
        adc, cd, fd, ph, dv = cpu.example_inputs(seed=SEED, margin=1024, rowed=True)
        before = ff.fengine_fused.launches
        got = gpu(adc, cd, fd, ph, dv)
        torch.cuda.synchronize()
        if ff.fengine_fused.launches != before + 1:
            raise AssertionError(f"{name} did not run K1 on the card")
        ref = cpu(adc, cd, fd, ph, dv)
        gb, rb = (got[0], ref[0]) if cls.__name__ == "FXBEngine" else (got, ref)
        d = (gb.cpu().float() - rb.float()).abs()
        dmax, frac = float(d.max()), float((d > 1e-3).float().mean())
        log(f"{name} on the card vs the CPU engine: beams max|d| {dmax:.4f}, "
            f"frac(|d|>1e-3) {frac:.3e}")
        if dmax > 2.0 + 1e-3 or frac > 5e-3:
            raise AssertionError(f"{name} on the card disagrees with the CPU engine")


def _planes(torch, a, p, s, c, gen, dev):
    return tuple(
        torch.randint(-127, 128, (a, p, s, c), dtype=torch.int8, device=dev, generator=gen)
        for _ in range(2)
    )


def _blocks(torch, n_beams, a, c, gen, dev, dtype):
    from dpdk_dc_sand_tpu_torch.ops.coeff_gen import steering_coeff_blockcat, steering_coeffs

    dv = torch.zeros((n_beams, a, 4), device=dev)
    dv[..., 0] = torch.rand((n_beams, a), device=dev, generator=gen) * 5e-9
    dv[..., 2] = (torch.rand((n_beams, a), device=dev, generator=gen) * 2 - 1) * 3.14159265
    cos, sin = steering_coeffs(dv, n_channels=c, n_channels_per_stream=c,
                               sample_period=1 / 1712e6)
    return steering_coeff_blockcat(cos, sin).to(dtype)


#: K2's geometries in phase 4 beside the flagship C: every 2B its gate takes
#: (the reference's), then (C, 2B) off a multiple of 16 channels.
K2_WIDTHS = (2, 4, 8, 16, 32, 64, 128)
K2_NARROW = ((24, 32), (48, 8))


def phase_k2(st: dict) -> None:
    import torch

    from dpdk_dc_sand_tpu_torch.ops import bstage

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    a, p, s, c = 8, 2, 256, 32768
    qr, qi = _planes(torch, a, p, s, c, gen, dev)
    cases = [(c, nb2) for nb2 in K2_WIDTHS] + list(K2_NARROW)
    for cc, nb2 in cases:
        x = (qr, qi) if cc == c else (qr[..., :cc].contiguous(), qi[..., :cc].contiguous())
        for prec, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            w = _blocks(torch, nb2 // 2, a, cc, gen, dev, dtype)
            before = bstage.beamform_turned_fused.launches
            got = bstage.beamform_turned_fused(*x, w, n_pols=p, precision=prec,
                                               layout="packed")
            if bstage.beamform_turned_fused.launches != before + 1:
                raise AssertionError(f"k2 {prec} 2B={nb2} C={cc}: the wrapper did not launch K2")
            ref = bstage.beamform_turned_fused_reference(*x, w, prec)
            torch.cuda.synchronize()
            _beam_diff(f"k2 {prec} [A={a} C={cc} 2B={nb2} S={s}]", got, ref)
            del got, ref


def phase_engine(st: dict) -> None:
    import torch

    from dpdk_dc_sand_tpu_torch import ArrayConfig
    from dpdk_dc_sand_tpu_torch.models import FBEngine
    from dpdk_dc_sand_tpu_torch.ops import bstage, fengine_fused as ff
    from dpdk_dc_sand_tpu_torch.ops.delay import clamp_starts

    dev = torch.device("cuda")
    cfg = ArrayConfig(n_ants=8, n_channels=32768, n_beams=16, n_taps=16)
    a, p, s = cfg.n_ants, cfg.n_pols, 256
    fb = FBEngine(cfg, n_spectra=s, quant_scale=QUANT_SCALE, precision="bf16",
                  beam_layout="natural", device=dev)
    adc, cd, fd, ph, dv = fb.example_inputs(seed=SEED, margin=8192, rowed=True)
    fb.set_beam_delays(dv)
    before = bstage.beamform_turned_fused.launches
    out = fb.step(adc, cd, fd, ph)
    if bstage.beamform_turned_fused.launches != before + 1:
        raise AssertionError("engine: the step did not launch K2")
    # The plain chain on the same device tensors.
    n1, n2 = ff._split_ct(cfg.fft_size)
    flat = torch.as_tensor(adc, device=dev).reshape(a, p, -1)
    cdt = torch.as_tensor(cd, device=dev).reshape(a, 1).expand(a, p)
    starts = clamp_starts(cdt.reshape(-1), flat.shape[-1], fb.samples_in)
    rot = fb._fine_rot(fd, ph)
    rc, rs = (r.reshape(a * p, -1) for r in rot)
    shape = (a, p, s, cfg.n_channels)
    qr, qi = (torch.empty(shape, dtype=torch.int8, device=dev) for _ in range(2))
    _k1_plain(flat.reshape(a * p, -1), starts, fb.window, rc, rs,
              (qr.view(a * p, s, -1), qi.view(a * p, s, -1)), chunk=a * p,
              n_spectra=s, n1=n1, n2=n2, dft_dtype="bfloat16")
    ref = bstage.beamform_turned_fused_reference(qr, qi, fb.coeff_blocks, "bf16")
    # The F planes the step fed to K2 (the same kernel on the same inputs).
    kr, ki = ff.fengine_fused(flat, fb.window, None, None, n_channels=cfg.n_channels,
                              quant_scale=QUANT_SCALE, coarse_delays=cdt, n_spectra=s,
                              rot_planes=rot)
    _code_diff("engine F plane", (kr, ki), (qr, qi))
    # Each beam moves by at most sum |w| over the F codes that differ
    # (by <= 1 each): the exact bound K1's tolerance allows. (The fixed
    # max |d| <= 2 of the small CPU slice does not hold at this size: a
    # beam sums 16 codes, and 537 M beams at a flip rate ~1e-4 expect ~1
    # beam with three flips.)
    dr = (kr.to(torch.int16) - qr.to(torch.int16)).abs().to(torch.int8)
    di = (ki.to(torch.int16) - qi.to(torch.int16)).abs().to(torch.int8)
    bound = bstage.beamform_turned_fused_reference(dr, di, fb.coeff_blocks.float().abs(), "f32")
    torch.cuda.synchronize()
    d = (out - ref).abs()
    dmax, frac = float(d.max()), float((d > 1e-3).float().mean())
    over = int((d > bound + 1e-3 + 1e-5 * ref.abs()).sum())
    log(f"engine [A=8 C=32768 B=16 taps=16 S=256]: max|d| {dmax:.4f} (flip bound "
        f"{float(bound.max()):.4f}), frac(|d|>1e-3) {frac:.3e}, over bound {over}, "
        f"|ref| max {float(ref.abs().max()):.1f}")
    if not bool(torch.isfinite(out).all()) or over or frac > 5e-3:
        raise AssertionError("engine disagrees with the plain chain")


def phase_flagship(st: dict) -> None:
    import numpy as np
    import torch

    from dpdk_dc_sand_tpu_torch import ArrayConfig
    from dpdk_dc_sand_tpu_torch.models import FBEngine
    from dpdk_dc_sand_tpu_torch.ops import bstage, fengine_fused as ff
    from dpdk_dc_sand_tpu_torch.ops.delay import clamp_starts
    from dpdk_dc_sand_tpu_torch.ops.fengine_fused import ingest_alignment

    dev = torch.device("cuda")
    cfg = ArrayConfig(n_ants=80, n_channels=32768, n_beams=16, n_taps=16)
    a, p, s, c = cfg.n_ants, cfg.n_pols, 256, cfg.n_channels
    fb = FBEngine(cfg, n_spectra=s, quant_scale=QUANT_SCALE, precision="bf16",
                  beam_layout="natural", device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    rng = np.random.default_rng(SEED)
    margin = 8192
    cd = rng.integers(0, margin, a).astype(np.int32)
    fd = rng.uniform(-0.5, 0.5, a).astype(np.float32)
    ph = (-np.pi * fd / 2).astype(np.float32)
    dv = np.zeros((cfg.n_beams, a, 4), np.float32)
    dv[..., 0] = rng.uniform(0, 5e-9, dv.shape[:-1])
    dv[..., 2] = rng.uniform(-np.pi, np.pi, dv.shape[:-1])
    n2 = ingest_alignment(cfg.fft_size)
    rows = (fb.samples_in + margin) // n2
    adc = torch.empty((a, p, rows, n2), dtype=torch.int8, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ff.fengine_fused.launches = ff.k1_fir.launches = ff.k1_dft.launches = 0
    bstage.beamform_turned_fused.launches = 0
    times = []
    out = None

    def timed_step():
        nonlocal out
        adc.random_(-64, 64, generator=gen)  # fresh wire-rowed ADC every step
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        out = fb.step(adc, cd, fd, ph)
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))

    fb.set_beam_delays(dv)
    for _ in range(3):
        timed_step()
    dv[..., 2] += 0.25  # delay update: new steering phases and fine delays
    fd = (fd * 0.5).astype(np.float32)
    fb.set_beam_delays(dv, t_s=1e-3)
    for _ in range(2):
        timed_step()
    launches = {"k1": ff.fengine_fused.launches, "k2": bstage.beamform_turned_fused.launches}
    passes = {"k1 FIR pass": ff.k1_fir.launches, "k1 DFT pass": ff.k1_dft.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"flagship launches: {launches}; K1's passes (one each a group of "
        f"{ff._plane_group(a * p, s, cfg.fft_size)} streams): {passes}")
    if min(passes.values()) < launches["k1"]:
        raise AssertionError(f"K1 did not run through its two passes: {passes}")
    if launches["k1"] < 1 or launches["k2"] < 1:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    want = (c // 4, p * s, 128)
    if tuple(out.shape) != want or out.dtype != torch.float32:
        raise AssertionError(f"beams {tuple(out.shape)} {out.dtype}, want {want}")
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("non-finite beams")
    samples = a * p * s * cfg.fft_size
    ms = float(np.median(times[1:]))
    log(f"flagship [80 ant x 32768 ch x 16 beams x 16 taps, S=256]: step ms "
        f"{['%.3f' % t for t in times]}, median(after first) {ms:.3f} ms, "
        f"{samples / ms / 1e3:.1f} Msamples/s, peak memory {peak_gb:.2f} GB ({st['card']})")
    st["launches"] = launches
    st["fb_ms"] = ms

    # The last step again, kernel by kernel through the wrappers (these
    # launches come after the count was read), each held against its plain
    # version at the flagship shapes.
    flat = adc.reshape(a, p, -1)
    cdt = torch.as_tensor(cd, device=dev).reshape(a, 1).expand(a, p)
    rot = (fb.rot_cos, fb.rot_sin)
    w = fb.coeff_blocks

    def k1():
        return ff.fengine_fused(flat, fb.window, None, None, n_channels=c,
                                quant_scale=QUANT_SCALE, coarse_delays=cdt,
                                n_spectra=s, rot_planes=rot)

    qr, qi = k1()

    def k2():
        return bstage.beamform_turned_fused(qr, qi, w, n_pols=p, precision="bf16",
                                            layout="packed")

    beams = k2()
    torch.cuda.synchronize()
    if not torch.equal(beams, out):
        raise AssertionError("the engine's beams are not K2(K1(adc)) of its last step")
    n1, _ = ff._split_ct(cfg.fft_size)
    x = flat.reshape(a * p, -1)
    starts = clamp_starts(cdt.reshape(-1), x.shape[1], fb.samples_in)
    rc, rs = (r.reshape(a * p, -1) for r in rot)
    pq = tuple(torch.empty((a * p, s, c), dtype=torch.int8, device=dev) for _ in range(2))

    def k1_plain():  # 8 batches at a time bounds its f32 temporaries
        _k1_plain(x, starts, fb.window, rc, rs, pq, chunk=8,
                  n_spectra=s, n1=n1, n2=n2, dft_dtype="bfloat16")

    k1_plain()
    torch.cuda.synchronize()
    k1_err = _code_diff("flagship k1", (qr.view(a * p, s, c), qi.view(a * p, s, c)), pq)
    ref = bstage.beamform_turned_fused_reference(qr, qi, w, "bf16")
    k2_err = _beam_diff("flagship k2 [A=80 C=32768 B=16 S=256]", beams, ref)
    del beams, ref
    k1_ms, k1_plain_ms = cuda_ms(k1, iters=2), cuda_ms(k1_plain, iters=1)
    k2_ms = cuda_ms(k2)
    k2_plain_ms = cuda_ms(lambda: bstage.beamform_turned_fused_reference(qr, qi, w, "bf16"),
                          iters=1)
    log(f"flagship kernels: K1 {k1_ms:.3f} ms vs plain {k1_plain_ms:.3f} ms, "
        f"K2 {k2_ms:.3f} ms vs plain {k2_plain_ms:.3f} ms ({st['card']})")
    fft, taps, n2 = cfg.fft_size, cfg.n_taps, cfg.fft_size // n1
    nb = a * p
    # K1 reads each stream's window of (S + taps - 1) frames, the window and
    # the rotation planes, writes two int8 planes; its DFT is bf16 products.
    k1_bound = bound(nb * (s + taps - 1) * fft + taps * fft * 4 + 2 * nb * c * 4 + 2 * nb * s * c,
                     bf16=nb * s * 2 * (2 * n1 * n1 * n2 + 2 * n2 * n2 * n1),
                     f32=fir_ops(nb * s * fft, taps))
    k2_bound = bound(2 * nb * s * c + c * 2 * a * 2 * cfg.n_beams * 2 + c * p * s * 2 * cfg.n_beams * 4,
                     bf16=2 * c * p * s * 2 * a * 2 * cfg.n_beams)
    # K1's two passes alone over all 160 streams: the FIR pass bit-exact
    # against its plain version, then each timed; the split's floor is the
    # FIR pass's bound (its f32 operations, counted as fir_ops counts them;
    # its bytes come close) plus the DFT pass's (its bf16 operations).
    plane = ff.k1_fir(x, starts, fb.window, n_spectra=s)
    for b0 in range(0, nb, 8):
        b = slice(b0, b0 + 8)
        if not torch.equal(plane[b], ff.k1_fir_reference(x[b], starts[b], fb.window,
                                                         n_spectra=s)):
            raise AssertionError(f"K1's FIR pass differs from plain on streams {b0}..")
    log(f"flagship k1 FIR pass [{nb} x S={s} x fft {fft}]: bit-exact against plain")
    fir_ms = cuda_ms(lambda: ff.k1_fir(x, starts, fb.window, n_spectra=s), iters=2)
    dft_ms = cuda_ms(lambda: ff.k1_dft(plane, rc, rs, n1=n1, n2=n2), iters=2)
    del plane
    fir_plain_ms = cuda_ms(_chunked(lambda b: ff.k1_fir_reference(
        x[b], starts[b], fb.window, n_spectra=s), nb), iters=1)
    # The FIR pass's library yardstick (for both planes): one cuDNN depthwise
    # conv1d over the streams' frames gathered at their starts and laid out
    # [B, F, S + taps - 1] in f32 (untimed), as phase 11 times it for K6.
    n_frames = s + taps - 1

    def gather(xt):
        for b, st0 in enumerate(starts.tolist()):
            xt[b].copy_(x[b, st0: st0 + n_frames * fft].view(n_frames, fft).t())

    lib_ms, lib_note = _conv1d_fir(gather, (nb, fft, n_frames), fb.window, ff.k1_fir_reference(
        x[:8], starts[:8], fb.window, n_spectra=s, dft_dtype="float32"))
    st["k1_fir_library"] = dict(library_ms=lib_ms, library_note=lib_note)
    fir_bound = bound(nb * (s + taps - 1) * fft + taps * fft * 4 + nb * s * fft * 2,
                      f32=fir_ops(nb * s * fft, taps))
    dft_bound = bound(nb * s * fft * 2 + 2 * nb * c * 4 + 2 * nb * s * c,
                      bf16=nb * s * 2 * (2 * n1 * n1 * n2 + 2 * n2 * n2 * n1))
    floor_ms = fir_bound["bound_ms"] + dft_bound["bound_ms"]
    # K1's scratch: the peak of one call above what was allocated before it,
    # less its two int8 outputs.
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    outs = k1()
    torch.cuda.synchronize()
    scratch = torch.cuda.max_memory_allocated() - before - sum(
        o.numel() * o.element_size() for o in outs)
    del outs
    log(f"flagship k1 passes: FIR {fir_ms:.3f} ms (bound {fir_bound['bound_ms']:.3f}, "
        f"{fir_bound['bound_by']}; plain {fir_plain_ms:.3f}; library conv1d "
        f"{'' if lib_ms is None else f'{lib_ms:.3f} ms '}({lib_note})), DFT {dft_ms:.3f} ms (bound {dft_bound['bound_ms']:.3f}, "
        f"{dft_bound['bound_by']}); sum {fir_ms + dft_ms:.3f} vs K1 {k1_ms:.3f} ms; the split's "
        f"floor {floor_ms:.3f} ms (the two bounds' sum); K1's scratch {scratch / 1e9:.3f} GB a "
        f"call (peak over its outputs) ({st['card']})")
    st["k1"] = dict(max_abs_err=float(k1_err), ms=k1_ms, plain_ms=k1_plain_ms, **k1_bound,
                    library_ms=None, fir_ms=fir_ms, dft_ms=dft_ms, scratch_bytes=scratch,
                    **st["k1_subset"])
    st["k1_fir"] = dict(max_abs_err=0.0, ms=fir_ms, plain_ms=fir_plain_ms, **fir_bound,
                        **st["k1_fir_library"], launches=passes["k1 FIR pass"],
                        bytes_ms=(nb * (s + taps - 1) * fft + taps * fft * 4
                                  + nb * s * fft * 2) / HBM_BYTES_PER_S * 1e3)
    st["fb_peak_gb"] = peak_gb
    st["k2"] = dict(max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain_ms, **k2_bound,
                    library_ms=None, **_k2_yardsticks(st, qr, qi, w, k2_ms))
    del fb, adc, out, qr, qi, pq, flat, x
    _flagship_f32(st)
    _fir_routes(st)


#: The FIR pass of K1 and K7 on the routes that run it, at full width (160
#: streams, 16 taps): (name, fft, S, coarse delays below (0: every start
#: 0), K7's frames). The flagship's (phase 6's coarse delays, about 3/4 of
#: the starts off 4 bytes) and the same bytes with every start 0; K7's at
#: 160 streams (phase 12); K1's at fft 1024 and 2^22 (phase 3); K7's at
#: fft 2^23 (phase 12).
FIR_ROUTES = (("flagship", 65536, 256, 8192, False), ("flagship_aligned", 65536, 256, 0, False),
              ("k7_160", 65536, 256, 0, True), ("fft_1024", 1024, 16384, 4096, False),
              ("fft_2_22", 1 << 22, 4, 4096, False), ("k7_2_23", 1 << 23, 2, 0, True))


def fir_route_inputs(route):
    """A FIR route's inputs, made on the card from ``SEED``: the 160 streams
    ``[160, n_in]`` int8 (K7's: its frames ``[160, S + 15, fft]`` viewed
    flat), their starts (the flagship's coarse delays, one an antenna, below
    the route's bound; 0 without one) and the window."""
    import numpy as np
    import torch

    from dpdk_dc_sand_tpu_torch.ops.pfb import default_window

    _, fft, s, delay, _ = route
    dev = torch.device("cuda")
    taps, a = FLAG["n_taps"], FLAG["n_ants"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    x = torch.randint(-64, 64, (2 * a, (s + taps - 1) * fft + delay), dtype=torch.int8,
                      device=dev, generator=gen)
    cd = np.random.default_rng(SEED).integers(0, delay, a) if delay else np.zeros(a, np.int64)
    starts = torch.as_tensor(np.repeat(cd, 2), dtype=torch.int64, device=dev)
    return x, starts, default_window(taps, fft, device=dev)


def fir_route_ms(ff, route, dft_dtype: str, inputs=None) -> tuple[float, int]:
    """ms of the FIR pass of the module ``ff`` (a tree's
    ``ops/fengine_fused.py``: it needs ``_fir_pass``, the route queries and
    ``_route_group``, the grouping ``_launch`` and ``_launch_dit`` use) over
    a route's 160 streams, as K1 or K7 runs it: over the route's plane groups
    into one group's plane, the mean of 2 calls after one. Returns the ms and
    the streams a group."""
    import torch

    _, fft, s, _, k7 = route
    x, starts, win = inputs or fir_route_inputs(route)
    nb, f32 = x.shape[0], dft_dtype == "float32"
    if k7:
        _, n1, n2 = ff._deint_mode(fft // 2, "matmul")
        body = ff._dit_body(n1, n2, dft_dtype)
    else:
        n1, n2 = ff._split_ct(fft)
        body = ff._k1_body(n1, n2, dft_dtype)
    group = ff._route_group(body, nb, s, fft)
    plane = torch.empty((group, s, fft), dtype=torch.float32 if f32 else torch.bfloat16,
                        device=x.device)
    spans = [slice(b0, min(nb, b0 + group)) for b0 in range(0, nb, group)]
    ms = cuda_ms(lambda: [ff._fir_pass(x[b], starts[b], win, plane[: b.stop - b.start])
                          for b in spans], iters=2)
    return ms, group


def _fir_bodies(st: dict, tag: str) -> dict:
    """Every body of K1's FIR pass (both planes, each register-ring depth
    and the long body, each stop's): registers, spill bytes, shared bytes
    and blocks an SM, logged; a body that spills fails the phase."""
    from dpdk_dc_sand_tpu_torch.ops import fengine_fused as ff

    bodies = ff.k1_fir_attributes()
    log(f"{tag} k1 FIR bodies (registers, local bytes, shared bytes, blocks an SM): "
        + "; ".join(f"{k} {v['regs']}, {v['local_bytes']}, {v['smem_bytes']}, "
                    f"{v['blocks_per_sm']}" for k, v in bodies.items()) + f" ({st['card']})")
    spills = {k: v["local_bytes"] for k, v in bodies.items() if v["local_bytes"]}
    if spills:
        raise AssertionError(f"{tag}: a K1 FIR body spills: {spills}")
    st["k1_fir_bodies"] = bodies
    return bodies


def _fir_routes(st: dict) -> None:
    """The FIR pass on each of ``FIR_ROUTES`` in both planes: bit for bit
    against its plain version on the route's last streams, then timed by
    ``fir_route_ms`` beside its bound (the streams' bytes once, the window,
    the plane; ``fir_ops``), with the share of streams whose start is off 4
    bytes (two words a row); the bodies' registers and spills."""
    import torch

    from dpdk_dc_sand_tpu_torch.ops import fengine_fused as ff

    _fir_bodies(st, "flagship")
    taps, rec = FLAG["n_taps"], {}
    for route in FIR_ROUTES:
        name, fft, s, _, _ = route
        x, starts, win = inputs = fir_route_inputs(route)
        nb = x.shape[0]
        two = int((ff.fir_copy_words(x, starts) == 2).sum())
        k = 8 if fft <= 65536 else 1  # streams held to plain
        last = slice(nb - k, nb)
        for dt in ("bfloat16", "float32"):
            fir = ff.k1_fir_f32 if dt == "float32" else ff.k1_fir
            if not torch.equal(fir(x[last], starts[last], win, n_spectra=s),
                               ff.k1_fir_reference(x[last], starts[last], win, n_spectra=s,
                                                   dft_dtype=dt)):
                raise AssertionError(f"the FIR pass on route {name} ({dt}) differs from plain")
            ms, group = fir_route_ms(ff, route, dt, inputs)
            item = 4 if dt == "float32" else 2
            b = bound(nb * (s + taps - 1) * fft + taps * fft * 4 + nb * s * fft * item,
                      f32=fir_ops(nb * s * fft, taps))
            rec[f"{name}/{dt}"] = dict(ms=ms, group=group, two_word_streams=two, streams=nb,
                                       fft=fft, s=s, **b)
            torch.cuda.empty_cache()
        log(f"k1 FIR pass, route {name} [{nb} streams x S={s} x fft {fft}; {two} of {nb} "
            f"starts off 4 bytes; last {k} bit-exact against plain]: " + ", ".join(
                f"{dt} {rec[f'{name}/{dt}']['ms']:.3f} ms (groups of "
                f"{rec[f'{name}/{dt}']['group']}; bound {rec[f'{name}/{dt}']['bound_ms']:.3f}, "
                f"{rec[f'{name}/{dt}']['bound_by']})" for dt in ("bfloat16", "float32"))
            + f" ({st['card']})")
        del x, starts, win, inputs
        torch.cuda.empty_cache()
    st["k1_fir_routes"] = rec


def _fb_steps(fengine: str = "fused_f32", n_channels: int = FLAG["n_channels"],
              n_spectra: int = FLAG_S, seed: int = SEED + 3) -> dict:
    """F+B steps at the flagship array (80 ant x 16 beams x 16 taps) with
    ``n_channels`` and ``fengine`` (natural packed beams; the B stage the
    engine resolves), as the bf16 flagship steps: wire-rowed ADC made on the
    card afresh each step, set_beam_delays, 3 steps, a delay update, 2 steps.
    ``fengine=None`` takes every engine default (precision f32), else the
    precision is bf16. Returns the engine, its ADC, coarse delays, last
    beams, step ms and the peak device memory (GB) over the run."""
    import numpy as np
    import torch

    from dpdk_dc_sand_tpu_torch import ArrayConfig
    from dpdk_dc_sand_tpu_torch.models import FBEngine
    from dpdk_dc_sand_tpu_torch.ops.fengine_fused import ingest_alignment

    dev = torch.device("cuda")
    cfg = ArrayConfig(**dict(FLAG, n_channels=n_channels))
    a, p = cfg.n_ants, cfg.n_pols
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kw = {} if fengine is None else dict(
        precision="bf16", fengine=fengine, bstage="fused" if fengine == "fused_f32" else "auto")
    fb = FBEngine(cfg, n_spectra=n_spectra, quant_scale=QUANT_SCALE, beam_layout="natural",
                  device=dev, **kw)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(SEED)
    margin = 8192
    cd = rng.integers(0, margin, a).astype(np.int32)
    fd = rng.uniform(-0.5, 0.5, a).astype(np.float32)
    ph = (-np.pi * fd / 2).astype(np.float32)
    dv = np.zeros((cfg.n_beams, a, 4), np.float32)
    dv[..., 0] = rng.uniform(0, 5e-9, dv.shape[:-1])
    dv[..., 2] = rng.uniform(-np.pi, np.pi, dv.shape[:-1])
    n2 = ingest_alignment(cfg.fft_size)
    adc = torch.empty((a, p, (fb.samples_in + margin) // n2, n2), dtype=torch.int8, device=dev)
    times = []
    out = None

    def timed_step():
        nonlocal out
        adc.random_(-64, 64, generator=gen)  # fresh wire-rowed ADC every step
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        out = fb.step(adc, cd, fd, ph)
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))

    fb.set_beam_delays(dv)
    for _ in range(3):
        timed_step()
    dv[..., 2] += 0.25  # delay update: new steering phases and fine delays
    fd = (fd * 0.5).astype(np.float32)
    fb.set_beam_delays(dv, t_s=1e-3)
    for _ in range(2):
        timed_step()
    return dict(fb=fb, adc=adc, cd=cd, out=out, times=times,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def _flagship_f32(st: dict) -> None:
    """The F+B flagship with ``fengine="fused_f32"``: K1's f32 FIR pass and
    FFMA DFT pass (16 streams a group), then K2. Steps as the bf16 flagship;
    the f32 passes must launch and no other K1 pass. Then the last step's K1
    against plain over all 160 streams, and each f32 pass alone timed beside
    its plain version."""
    import numpy as np
    import torch

    from dpdk_dc_sand_tpu_torch import ArrayConfig
    from dpdk_dc_sand_tpu_torch.ops import bstage, fengine_fused as ff
    from dpdk_dc_sand_tpu_torch.ops.delay import clamp_starts

    dev = torch.device("cuda")
    cfg = ArrayConfig(**FLAG)
    a, p, s, c = cfg.n_ants, cfg.n_pols, FLAG_S, cfg.n_channels
    fft, taps, nb = cfg.fft_size, cfg.n_taps, a * p
    n1, n2 = ff._split_ct(fft)
    for k in K1_COUNTERS:
        getattr(ff, k).launches = 0
    ff.fengine_fused.launches = bstage.beamform_turned_fused.launches = 0
    run = _fb_steps()
    launches = {"k1": ff.fengine_fused.launches, "k2": bstage.beamform_turned_fused.launches,
                **_k1_counts(ff)}
    fb, adc, cd, out, times, peak_gb = (run.pop(k) for k in ("fb", "adc", "cd", "out", "times",
                                                             "peak_gb"))
    group = ff._plane_group(nb, s, fft, 4)
    log(f"flagship fused_f32 launches (K1's f32 passes one each a group of {group} streams): "
        f"{launches}")
    if launches["k1"] < 1 or launches["k2"] < 1:
        raise AssertionError(f"a kernel of the fused_f32 path never launched: {launches}")
    if min(launches["k1_fir_f32"], launches["k1_dft_f32"]) < launches["k1"]:
        raise AssertionError(f"K1 f32 did not run through its two passes: {launches}")
    others = [k for k in K1_COUNTERS if k not in ("k1_fir_f32", "k1_dft_f32") and launches[k]]
    if others:
        raise AssertionError(f"the fused_f32 step ran another K1 pass: {launches}")
    want = (c // 4, p * s, 128)
    if tuple(out.shape) != want or out.dtype != torch.float32:
        raise AssertionError(f"fused_f32 beams {tuple(out.shape)} {out.dtype}, want {want}")
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("non-finite fused_f32 beams")
    ms = float(np.median(times[1:]))
    log(f"flagship fused_f32 [80 ant x 32768 ch x 16 beams x 16 taps, S=256]: step ms "
        f"{['%.3f' % t for t in times]}, median(after first) {ms:.3f} ms, "
        f"{nb * s * fft / ms / 1e3:.1f} Msamples/s, peak memory {peak_gb:.2f} GB; the bf16 "
        f"step {st['fb_ms']:.3f} ms ({ms / st['fb_ms']:.2f}x) ({st['card']})")
    st["f32_launches"] = launches
    st["fb_f32"] = dict(ms=ms, peak_gb=peak_gb)

    # The last step's F planes through the wrapper, K2 on them equal to the
    # step's beams; K1 f32 against plain over all 160 streams (8 at a time),
    # the f32 FIR pass bit for bit.
    flat = adc.reshape(a, p, -1)
    cdt = torch.as_tensor(cd, device=dev).reshape(a, 1).expand(a, p)
    rot = (fb.rot_cos, fb.rot_sin)
    x = flat.reshape(nb, -1)
    starts = clamp_starts(cdt.reshape(-1), x.shape[1], fb.samples_in)
    rc, rs = (r.reshape(nb, -1) for r in rot)

    def k1():
        return ff.fengine_fused(flat, fb.window, None, None, n_channels=c,
                                quant_scale=QUANT_SCALE, dft_dtype="float32",
                                coarse_delays=cdt, n_spectra=s, rot_planes=rot)

    qr, qi = k1()
    beams = bstage.beamform_turned_fused(qr, qi, fb.coeff_blocks, n_pols=p, precision="bf16",
                                         layout="packed")
    torch.cuda.synchronize()
    if not torch.equal(beams, out):
        raise AssertionError("the fused_f32 engine's beams are not K2(K1 f32(adc))")
    del beams, out
    plane = ff.k1_fir_f32(x, starts, fb.window, n_spectra=s)
    pq = tuple(torch.empty((nb, s, c), dtype=torch.int8, device=dev) for _ in range(2))
    for b0 in range(0, nb, 8):
        b = slice(b0, b0 + 8)
        pf = ff.k1_fir_reference(x[b], starts[b], fb.window, n_spectra=s, dft_dtype="float32")
        if not torch.equal(plane[b], pf):
            raise AssertionError(f"K1's f32 FIR pass differs from plain on streams {b0}..")
        pq[0][b], pq[1][b] = ff.k1_dft_reference(pf, rc[b], rs[b], n1=n1, n2=n2,
                                                 dft_dtype="float32")
    del pf
    k1_err = _code_diff("flagship k1 f32", (qr.view(nb, s, c), qi.view(nb, s, c)), pq)
    dr, di = ff.k1_dft_f32(plane, rc, rs, n1=n1, n2=n2)
    if not (torch.equal(dr, qr.view(nb, s, c)) and torch.equal(di, qi.view(nb, s, c))):
        raise AssertionError("K1 f32's DFT pass alone differs from K1 f32 on the same streams")
    del dr, di, pq, qr, qi
    log(f"flagship k1 f32 FIR pass [{nb} x S={s} x fft {fft}]: bit-exact against plain; the "
        f"DFT pass alone equals K1 f32")

    k1_ms = cuda_ms(k1, iters=2)
    fir_ms = cuda_ms(lambda: ff.k1_fir_f32(x, starts, fb.window, n_spectra=s), iters=2)
    dft_ms = cuda_ms(lambda: ff.k1_dft_f32(plane, rc, rs, n1=n1, n2=n2), iters=2)
    fir_plain_ms = cuda_ms(_chunked(lambda b: ff.k1_fir_reference(
        x[b], starts[b], fb.window, n_spectra=s, dft_dtype="float32"), nb), iters=1)
    dft_plain_ms = cuda_ms(_chunked(lambda b: ff.k1_dft_reference(
        plane[b], rc[b], rs[b], n1=n1, n2=n2, dft_dtype="float32"), nb), iters=1)
    del plane
    fir_bound = bound(nb * (s + taps - 1) * fft + taps * fft * 4 + nb * s * fft * 4,
                      f32=fir_ops(nb * s * fft, taps))
    dft_bound = bound(nb * s * fft * 4 + 2 * nb * c * 4 + 2 * nb * s * c,
                      f32=nb * s * 2 * (2 * n1 * n1 * n2 + 2 * n2 * n2 * n1))
    at = ff.k1_dft_f32_attributes(n1, n2)
    if at["local_bytes"]:
        raise AssertionError(f"K1's f32 DFT pass spills: {at}")
    log(f"flagship k1 f32 [{nb} x S={s} x fft {fft}]: K1 {k1_ms:.3f} ms; FIR pass "
        f"{fir_ms:.3f} ms (bound {fir_bound['bound_ms']:.3f}, {fir_bound['bound_by']}; plain {fir_plain_ms:.3f}), DFT "
        f"pass {dft_ms:.3f} ms (bound {dft_bound['bound_ms']:.3f}, {dft_bound['bound_by']}, "
        f"{dft_bound['bound_ms'] / dft_ms:.1%} of it; plain {dft_plain_ms:.3f}); the DFT "
        f"pass's body {at} ({st['card']})")
    st["k1_fir_f32"] = dict(max_abs_err=0.0, ms=fir_ms, plain_ms=fir_plain_ms, **fir_bound,
                            **st["k1_fir_library"])
    st["k1_dft_f32"] = dict(max_abs_err=float(k1_err), ms=dft_ms, plain_ms=dft_plain_ms,
                            **dft_bound, library_ms=None, k1_f32_ms=k1_ms,
                            regs=at["regs"], local_bytes=at["local_bytes"],
                            subset_ms=st["k1_f32_subset"]["ms"],
                            subset_max_abs_err=float(st["k1_f32_subset"]["max_abs_err"]))
    _flagship_f32_stops(st, flat, cdt, fb.window, rot, x, starts, k1_ms, fir_bound, dft_bound)
    del fb, adc, x, flat
    torch.cuda.empty_cache()
    _flagship_default(st)


def _flagship_f32_stops(st, flat, cdt, window, rot, x, starts, k1_ms, fir_bound,
                        dft_bound) -> None:
    """The ``fused_f32`` flagship route cut at each stop over all 160 streams
    (``fengine_fused(..., dft_dtype="float32", _ablate=stop)`` on the step's
    last ADC): the f32 FIR pass's ring copies (dma), the f32 FIR pass (fir),
    then its FFMA DFT pass up to the twiddle (stagea) and up to stage B
    (stageb), and K1 f32 whole: the split of its 168.6 ms DFT pass. Each stop
    first against its plain stop on the last 8 streams, with and without the
    requant (the window scaled to ``STOP_RMS``), then timed by the chained
    2-vs-6 marginal (``benchmarks/_chain.py``) with its launches counted."""
    import torch

    from dpdk_dc_sand_tpu_torch.benchmarks._chain import marginal_ms
    from dpdk_dc_sand_tpu_torch.ops import fengine_fused as ff

    a, p, _ = flat.shape
    nb, c = a * p, rot[0].numel() // (a * p)
    s = FLAG_S
    n1, n2 = ff._split_ct(2 * c)
    tail = slice(a - 4, a)  # the last 8 streams
    rc, rs = (r.reshape(nb, -1) for r in rot)
    last = slice(nb - 8, nb)

    def call(stop, gain=1.0, q=True, ants=slice(None)):
        return ff.fengine_fused(flat[ants], window * gain, None, None, n_channels=c,
                                quant_scale=QUANT_SCALE, dft_dtype="float32",
                                coarse_delays=cdt[ants], n_spectra=s, quantise=q,
                                rot_planes=tuple(r[ants] for r in rot), _ablate=stop)

    def plain(stop, gain=1.0, q=False):
        return ff.fengine_ablate_reference(stop, x[last], starts[last], window * gain, rc[last],
                                           rs[last], n_spectra=s, n1=n1, n2=n2,
                                           dft_dtype="float32", quantise=q)

    tag = f"flagship k1 f32 stops [{nb} x S={s} x fft {2 * c}]"
    bodies = _stop_bodies(ff, n1, n2, "float32", tag)
    err = 0.0
    for stop in K1_STOPS:
        gain = _stop_gain(stop, plain)
        for q in (True, False):
            got = call(stop, gain, q, tail)
            err = max(err, _stop_diff(f"{tag} {stop} q={q} (last 8 streams)",
                                      [g.reshape(8, s, c) for g in got], plain(stop, gain, q),
                                      stop, "float32", q))
            del got
    torch.cuda.empty_cache()
    ms, launches = {}, {}
    for stop in (*K1_STOPS, "full"):
        before = dict(_k1_counts(ff), ablate=ff.fengine_fused.ablate_launches)
        ms[stop], _ = marginal_ms(lambda: call(None if stop == "full" else stop), flat)
        launches[stop] = {k: v - before[k] for k, v in dict(
            _k1_counts(ff), ablate=ff.fengine_fused.ablate_launches).items() if v - before[k]}
        torch.cuda.empty_cache()
    steps = list(ms.items())
    split = ", ".join(f"{b} +{t - ta:.3f}" for (_, ta), (b, t) in zip(steps, steps[1:]))
    plain_ms = cuda_ms(lambda: plain(None, q=True), iters=1)  # K1 f32's plain, 8 streams
    taps, fft = window.shape
    k1_bound = bound(nb * (s + taps - 1) * fft + taps * fft * 4 + 2 * nb * c * 4 + 2 * nb * s * c,
                     f32=fir_ops(nb * s * fft, taps)
                     + nb * s * 2 * (2 * n1 * n1 * n2 + 2 * n2 * n2 * n1))
    log(f"{tag} chained ms: " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
        + f"; steps: {split}; K1 f32 (events, 2 calls) {k1_ms:.3f}; the passes' bounds: FIR "
        f"{fir_bound['bound_ms']:.3f}, DFT {dft_bound['bound_ms']:.3f}; plain (K1 f32, 8 "
        f"streams) {plain_ms:.3f}; launches {launches} ({st['card']})")
    st["k1_f32_stops"] = dict(
        ms=ms["full"], ms_by_stop=ms, plain_ms=plain_ms, plain_streams=8, max_abs_err=err,
        launches=sum(v.get("ablate", 0) for v in launches.values()), launches_by_stop=launches,
        **k1_bound, fir_bound_ms=fir_bound["bound_ms"], dft_bound_ms=dft_bound["bound_ms"],
        library_ms=None, bodies=bodies)


def _flagship_default(st: dict) -> None:
    """The F+B flagship at every engine default: ``FBEngine(cfg, n_spectra=256,
    quant_scale=QUANT_SCALE, beam_layout="natural")``, precision f32, so K1
    (bf16) then K2's f32-weight form. Steps as the bf16 flagship; K2 must
    launch once a step. Then the last step's beams equal K2 f32 of K1, K2 f32
    alone against plain over all 80 antennas, timed beside its plain
    version and its bound, with its yardsticks (registers, spills, stops)."""
    import numpy as np
    import torch

    from dpdk_dc_sand_tpu_torch import ArrayConfig
    from dpdk_dc_sand_tpu_torch.ops import bstage, fengine_fused as ff

    dev = torch.device("cuda")
    cfg = ArrayConfig(**FLAG)
    a, p, s, c, nb2 = cfg.n_ants, cfg.n_pols, FLAG_S, cfg.n_channels, 2 * cfg.n_beams
    nb = a * p
    for k in K1_COUNTERS:
        getattr(ff, k).launches = 0
    ff.fengine_fused.launches = bstage.beamform_turned_fused.launches = 0
    run = _fb_steps(fengine=None, seed=SEED + 4)
    launches = {"k1": ff.fengine_fused.launches, "k2": bstage.beamform_turned_fused.launches,
                **_k1_counts(ff)}
    fb, adc, cd, out, times, peak_gb = (run.pop(k) for k in ("fb", "adc", "cd", "out", "times",
                                                             "peak_gb"))
    log(f"flagship default precision: FBEngine resolved precision {fb.precision}, fengine "
        f"{fb.fengine}, bstage {fb.bstage}; launches {launches}")
    if (fb.precision, fb.fengine, fb.bstage) != ("f32", "fused", "fused"):
        raise AssertionError("the default F+B flagship is not K1 then K2 with f32 weights")
    if launches["k2"] != len(times) or launches["k1"] != len(times):
        raise AssertionError(f"the default-precision step did not launch K1 and K2 a step: "
                             f"{launches}")
    if min(launches["k1_fir"], launches["k1_dft"]) < launches["k1"]:
        raise AssertionError(f"K1 did not run through its two bf16 passes: {launches}")
    want = (c // 4, p * s, 128)
    if tuple(out.shape) != want or out.dtype != torch.float32 or not bool(
            torch.isfinite(out).all()):
        raise AssertionError(f"default-precision beams {tuple(out.shape)} {out.dtype}, want {want}")
    ms = float(np.median(times[1:]))
    log(f"flagship default precision (K1 bf16 + K2 f32) [{a} ant x {c} ch x {cfg.n_beams} "
        f"beams x {cfg.n_taps} taps, S={s}]: step ms {['%.3f' % t for t in times]}, median(after first) {ms:.3f} ms, "
        f"{nb * s * cfg.fft_size / ms / 1e3:.1f} Msamples/s, peak memory {peak_gb:.2f} GB; the "
        f"bf16 step {st['fb_ms']:.3f} ms ({ms / st['fb_ms']:.3f}x) ({st['card']})")
    st["f32w_launches"] = launches
    st["fb_default"] = dict(ms=ms, peak_gb=peak_gb)

    flat = adc.reshape(a, p, -1)
    cdt = torch.as_tensor(cd, device=dev).reshape(a, 1).expand(a, p)
    qr, qi = ff.fengine_fused(flat, fb.window, None, None, n_channels=c,
                              quant_scale=QUANT_SCALE, coarse_delays=cdt, n_spectra=s,
                              rot_planes=(fb.rot_cos, fb.rot_sin))
    w = fb.coeff_blocks
    if w.dtype != torch.float32:
        raise AssertionError(f"the default engine's steering blocks are {w.dtype}, not f32")

    def k2():
        return bstage.beamform_turned_fused(qr, qi, w, n_pols=p, precision="f32",
                                            layout="packed")

    beams = k2()
    torch.cuda.synchronize()
    if not torch.equal(beams, out):
        raise AssertionError("the default engine's beams are not K2 f32(K1(adc))")
    del out, adc, flat
    ref = bstage.beamform_turned_fused_reference(qr, qi, w, "f32")
    k2_err = _beam_diff(f"flagship k2 f32 [A={a} C={c} B={cfg.n_beams} S={s}]", beams, ref)
    del beams, ref
    k2_ms = cuda_ms(k2)
    k2_plain_ms = cuda_ms(lambda: bstage.beamform_turned_fused_reference(qr, qi, w, "f32"),
                          iters=1)
    # Bytes: the planes, the f32 weights and the beams once each; operations:
    # the three bf16 products a weight on the tensor cores (the plain f32
    # products' FFMA floor is logged beside it).
    macs = c * p * s * 2 * a * nb2
    k2_bound = bound(2 * nb * s * c + c * 2 * a * nb2 * 4 + c * p * s * nb2 * 4, bf16=3 * 2 * macs)
    ffma_ms = 2 * macs / PEAK_OPS_PER_S["f32"] * 1e3
    log(f"flagship K2 f32: {k2_ms:.3f} ms vs plain {k2_plain_ms:.3f} ms; bound "
        f"{k2_bound['bound_ms']:.3f} ms ({k2_bound['bound_by']}; the f32 FFMA floor of its "
        f"products {ffma_ms:.3f} ms); the bf16 form {st['k2']['ms']:.3f} ms ({st['card']})")
    st["k2_f32"] = dict(max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain_ms, **k2_bound,
                        library_ms=None, ffma_bound_ms=ffma_ms,
                        **_k2_yardsticks(st, qr, qi, w, k2_ms))
    del fb, qr, qi, w
    torch.cuda.empty_cache()


def _k2_yardsticks(st, qr, qi, w, k2_ms) -> dict:
    """K2's yardsticks at the flagship: its tensor-core body's registers,
    spill bytes and geometry (a body that spills fails the phase), a fill of
    its output, and its stage stops, each checked for what it writes (zeros
    with the stores, nothing without) and timed as K2 is."""
    import torch

    from dpdk_dc_sand_tpu_torch.ops import bstage

    a, p, s, c = qr.shape
    nb2 = w.shape[-1]
    prec = "f32" if w.dtype == torch.float32 else "bf16"
    at = bstage.kernel_attributes(a, p, s, nb2 // 2, c, precision=prec)
    out = torch.empty((c // (128 // nb2), p * s, 128), dtype=torch.float32, device=qr.device)
    fill_ms = cuda_ms(lambda: out.fill_(1.0))
    # The bytes its geometry moves from L2 to the SMs (a count, not a
    # reading): each plane run of `channels` bytes in its own 32-byte
    # sectors (once for each item's share of the columns), and the weights
    # once (resident) or once an m tile (staged).
    runs = 2 * a * p * s * (c // at["channels"]) * (nb2 // min(nb2, at["item_cols"]))
    plane_gb = runs * 32 * -(-at["channels"] // 32) / 1e9
    weight_gb = c * 2 * a * nb2 * w.element_size() * (
        1 if at["resident"] else p * s // at["m_rows"]) / 1e9
    log(f"k2 body {prec} [A={a} P*S={p * s} C={c} 2B={nb2}]: {at['regs']} registers, "
        f"{at['local_bytes']} local bytes, {at['blocks']} blocks; work item {at['channels']} "
        f"channels x {at['m_rows']} rows, K step {at['k_rows']} rows, weights "
        f"{'resident' if at['resident'] else 'staged'}, {at['smem_bytes']} bytes of shared memory; "
        f"from L2 by its geometry {plane_gb:.3f} GB of plane sectors + {weight_gb:.3f} GB of "
        f"weights = {plane_gb + weight_gb:.3f} GB ({(plane_gb + weight_gb) / k2_ms:.2f} TB/s "
        f"over K2's time); fill of its output {fill_ms:.3f} ms "
        f"({out.numel() * 4 / fill_ms / 1e9:.2f} TB/s) ({st['card']})")
    if at["local_bytes"]:
        raise AssertionError(f"k2 body spills: {at}")
    stop_ms = {}
    for stop in bstage.K2_STOPS:
        out.fill_(1.0)
        before = bstage.beamform_turned_fused.launches
        bstage.beamform_turned_fused_stop(qr, qi, w, out, stop)
        want = 0.0 if "store" in stop else 1.0
        if not bool((out == want).all()) or bstage.beamform_turned_fused.launches != before:
            raise AssertionError(f"k2 stop {stop} did not leave its output all {want}")
        stop_ms[stop] = cuda_ms(lambda: bstage.beamform_turned_fused_stop(qr, qi, w, out, stop))
    del out
    split = stop_ms["copy"] + stop_ms["mma_store"]
    log(f"k2 stops {prec} [A={a} C={c} 2B={nb2}] (ms; full {k2_ms:.3f}): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stop_ms.items())
        + f"; copy + mma_store {split:.3f} ({split / k2_ms:.3f} of full) ({st['card']})")
    return dict(fill_ms=fill_ms, ms_by_stop=stop_ms, regs=at["regs"],
                local_bytes=at["local_bytes"])


def _exact(tag, got, ref):
    """max |got - ref| over the pairs; raise unless every pair is equal."""
    import torch

    worst = 0.0
    for g, r in zip(got, ref):
        if g.shape != r.shape or g.dtype != r.dtype:
            raise AssertionError(f"{tag}: {tuple(g.shape)} {g.dtype}, plain "
                                 f"{tuple(r.shape)} {r.dtype}")
        if not g.is_floating_point():  # int8: differences need a wider type
            g, r = g.to(torch.int16), r.to(torch.int16)
        worst = max(worst, float((g - r).abs().max()))
        if not torch.equal(g, r):
            raise AssertionError(f"{tag} is not bit-exact against plain (max |d| {worst})")
    log(f"{tag}: bit-exact against plain (max |d| {worst})")
    return worst


def phase_corner_turn(st: dict) -> None:
    import torch

    from dpdk_dc_sand_tpu_torch.ops import corner_turn as ct

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    a, p, s, c = 80, 2, 256, 32768
    qr, qi = _planes(torch, a, p, s, c, gen, dev)
    got = ct.corner_turn_planes(qr, qi)
    ref = ct.corner_turn_planes_reference(qr, qi)
    torch.cuda.synchronize()
    err = _exact(f"k4 [A={a} P={p} S={s} C={c}]", (got,), (ref,))
    del ref
    xt = ct.corner_turn_planes_x(qr, qi)
    if tuple(xt.shape) != (c, 2 * a * p, s) or xt._base is None:
        raise AssertionError(f"corner_turn_planes_x: {tuple(xt.shape)}, not a view")
    if not torch.equal(xt.view(c, 2 * a, p * s), got):
        raise AssertionError("corner_turn_planes_x is not K4's bytes")
    del got, xt
    ms = cuda_ms(lambda: ct.corner_turn_planes(qr, qi))
    pms = cuda_ms(lambda: ct.corner_turn_planes_reference(qr, qi), iters=1)
    gbytes = 4 * a * p * s * c / 1e9
    log(f"k4 [A={a} P={p} S={s} C={c}]: kernel {ms:.3f} ms ({gbytes / ms:.2f} TB/s of "
        f"{gbytes:.2f} GB read+written), plain {pms:.3f} ms ({st['card']})")
    st["k4"] = dict(max_abs_err=err, ms=ms, plain_ms=pms, **bound(gbytes * 1e9),
                    library_ms=None)
    st["x_planes"] = (qr, qi)


def phase_xcorr(st: dict) -> None:
    import torch

    from dpdk_dc_sand_tpu_torch.ops import corner_turn as ct, xcorr as xc

    qr, qi = st.pop("x_planes")
    a, p, s, c = qr.shape
    i = a * p
    tag = f"[I={i} S={s} C={c}]"
    got = xc.correlate_planes_fused(qr, qi)
    ref = xc.correlate_planes_fused_reference(qr, qi)
    torch.cuda.synchronize()
    k3_err = _exact(f"k3 {tag}", got, ref)
    del got, ref
    k3_ms = cuda_ms(lambda: xc.correlate_planes_fused(qr, qi))
    k3_pms = cuda_ms(lambda: xc.correlate_planes_fused_reference(qr, qi), iters=1)
    # K3's yardsticks: a fill of its outputs (the write rate this card gives,
    # timed as phase 11 times K6's fill), and its body's registers and local
    # (spill) bytes as the runtime reports them.
    vre, vim = (torch.empty((c, i, i), dtype=torch.float32, device=qr.device) for _ in range(2))
    fill_ms = cuda_ms(lambda: (vre.fill_(1.0), vim.fill_(1.0)))
    k3_at = xc.kernel_attributes(i, s, c)
    # The bytes K3 stages from L2, from its geometry (a log figure, not a
    # reading): each 16-input tile's re and im rows are staged by the n_t + 1
    # items of the upper triangle that name that tile, over every sample.
    staged_gb = 2 * (-(-i // 16) + 1) * i * s * c / 1e9
    log(f"k3 yardsticks {tag}: fill of V_re and V_im {fill_ms:.3f} ms "
        f"({8 * c * i * i / fill_ms / 1e9:.2f} TB/s); body {k3_at['regs']} registers, "
        f"{k3_at['local_bytes']} local bytes, {k3_at['blocks']} blocks; stages "
        f"{staged_gb:.2f} GB from L2 by its geometry ({staged_gb / k3_ms:.2f} TB/s) "
        f"({st['card']})")
    if k3_at["local_bytes"]:
        raise AssertionError(f"k3 body spills: {k3_at}")
    # K3's stage stops split its time: each is checked for what it writes
    # (zeros with the stores, nothing without), then timed as K3 is.
    stop_ms = {}
    for stop in xc.K3_STOPS:
        vre.fill_(1.0)
        vim.fill_(1.0)
        xc.correlate_planes_fused_stop(qr, qi, vre, vim, stop)
        want = 0.0 if "store" in stop else 1.0
        if not all(bool((v == want).all()) for v in (vre, vim)):
            raise AssertionError(f"k3 stop {stop} did not leave its outputs all {want}")
        stop_ms[stop] = cuda_ms(lambda: xc.correlate_planes_fused_stop(qr, qi, vre, vim, stop))
    log(f"k3 stops {tag} (ms; full {k3_ms:.3f}): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stop_ms.items()) + f" ({st['card']})")
    # The two-pass X path (K5a, then K5b) at the flagship shape. FXB takes it
    # only where C < 128 (phase 9 steps such an engine); here it is driven
    # directly, with its launch counts reset.
    ct.corner_turn_planes.launches = 0
    xc.correlate_turned_fused.launches = 0
    xt = ct.corner_turn_planes_x(qr, qi)
    got = xc.correlate_turned_fused(xt, i)
    torch.cuda.synchronize()
    two_pass = {"k5a": ct.corner_turn_planes.launches, "k5b": xc.correlate_turned_fused.launches}
    log(f"x two-pass launches: {two_pass}")
    if min(two_pass.values()) < 1:
        raise AssertionError(f"a kernel of the two-pass X path never launched: {two_pass}")
    ref = xc.correlate_turned_fused_reference(xt, i)
    torch.cuda.synchronize()
    k5b_err = _exact(f"k5b {tag}", got, ref)
    del got, ref
    k5b_ms = cuda_ms(lambda: xc.correlate_turned_fused(xt, i))
    k5b_pms = cuda_ms(lambda: xc.correlate_turned_fused_reference(xt, i), iters=1)
    k5a_ms = cuda_ms(lambda: ct.corner_turn_planes_x(qr, qi))
    # K5b's yardsticks: the fill above, and its body's registers, local
    # (spill) bytes and the plan its C side takes for this shape.
    k5b_at = xc.turned_kernel_attributes(i, s, c)
    log(f"k5b yardsticks {tag}: fill of V_re and V_im {fill_ms:.3f} ms; body "
        f"{k5b_at['regs']} registers, {k5b_at['local_bytes']} local bytes, {k5b_at['blocks']} "
        f"blocks; plan {k5b_at['plan']} ({k5b_at['stage_samples']} samples a stage, "
        f"{k5b_at['items_per_channel']} items a channel, {k5b_at['smem_bytes']} bytes of shared "
        f"memory, rows by {'TMA' if k5b_at['tma'] else 'cp.async'}) ({st['card']})")
    if k5b_at["local_bytes"]:
        raise AssertionError(f"k5b body spills: {k5b_at}")
    k5b_stop_ms = {}
    for stop in xc.K5B_STOPS:
        vre.fill_(1.0)
        vim.fill_(1.0)
        xc.correlate_turned_fused_stop(xt, i, vre, vim, stop)
        want = 0.0 if "store" in stop else 1.0
        if not all(bool((v == want).all()) for v in (vre, vim)):
            raise AssertionError(f"k5b stop {stop} did not leave its outputs all {want}")
        k5b_stop_ms[stop] = cuda_ms(
            lambda: xc.correlate_turned_fused_stop(xt, i, vre, vim, stop))
    del vre, vim, xt
    log(f"k5b stops {tag} (ms; full {k5b_ms:.3f}): "
        + ", ".join(f"{k} {v:.3f}" for k, v in k5b_stop_ms.items()) + f" ({st['card']})")
    log(f"x {tag}: K5a {k5a_ms:.3f} + K5b {k5b_ms:.3f} = {k5a_ms + k5b_ms:.3f} ms vs K3 "
        f"{k3_ms:.3f} ms ({st['card']})")
    # K5b where a channel's rows do not stay resident (streamed in stages).
    ws, wc = 1024, 4096
    gen = torch.Generator(device=qr.device).manual_seed(SEED + 5)
    xw = torch.randint(-128, 128, (wc, 2 * i, ws), dtype=torch.int8, device=qr.device,
                       generator=gen)
    wtag = f"[I={i} S={ws} C={wc}]"
    _exact(f"k5b {wtag}", xc.correlate_turned_fused(xw, i),
           xc.correlate_turned_fused_reference(xw, i))
    w_at = xc.turned_kernel_attributes(i, ws, wc)
    w_ms = cuda_ms(lambda: xc.correlate_turned_fused(xw, i))
    log(f"k5b {wtag}: {w_ms:.3f} ms, plan {w_at['plan']} ({w_at['stage_samples']} samples a "
        f"stage, {w_at['items_per_channel']} items a channel), {w_at['regs']} registers, "
        f"{w_at['local_bytes']} local bytes ({st['card']})")
    if w_at["local_bytes"] or w_at["plan"] != "stream":
        raise AssertionError(f"k5b {wtag}: {w_at}")
    del xw
    gbytes = (2 * i * s + 2 * 4 * i * i) * c / 1e9
    log(f"xcorr {tag}: K3 {k3_ms:.3f} ms vs plain {k3_pms:.3f} ms, K5b {k5b_ms:.3f} ms vs "
        f"plain {k5b_pms:.3f} ms (floor: {gbytes:.2f} GB read+written) ({st['card']})")
    # V_re and V_im: 4 int8 products per pair, the upper triangle only.
    x_bound = bound(gbytes * 1e9, int8=2 * 4 * c * s * i * (i + 1) // 2)
    st["k3"] = dict(max_abs_err=k3_err, ms=k3_ms, plain_ms=k3_pms, **x_bound, library_ms=None,
                    fill_ms=fill_ms, ms_by_stop=stop_ms, regs=k3_at["regs"],
                    local_bytes=k3_at["local_bytes"])
    st["k5b"] = dict(max_abs_err=k5b_err, ms=k5b_ms, plain_ms=k5b_pms, **x_bound,
                     library_ms=None, fill_ms=fill_ms, ms_by_stop=k5b_stop_ms,
                     regs=k5b_at["regs"], local_bytes=k5b_at["local_bytes"])


def _stack_beams(torch, pair):
    return torch.stack(list(pair), dim=-1)


def phase_fxb_engine(st: dict) -> None:
    import torch

    from dpdk_dc_sand_tpu_torch import ArrayConfig
    from dpdk_dc_sand_tpu_torch.models import FXBEngine
    from dpdk_dc_sand_tpu_torch.ops import corner_turn as ct, fengine_fused as ff, xcorr as xc
    from dpdk_dc_sand_tpu_torch.ops.beamform import beamform_turned
    from dpdk_dc_sand_tpu_torch.ops.delay import clamp_starts

    dev = torch.device("cuda")
    cfg = ArrayConfig(n_ants=8, n_channels=32768, n_beams=16, n_taps=16)
    a, p, s = cfg.n_ants, cfg.n_pols, 256
    fxb = FXBEngine(cfg, n_spectra=s, quant_scale=QUANT_SCALE, precision="bf16", device=dev)
    if (fxb.fengine, fxb.bstage) != ("fused", "turned"):
        raise AssertionError(f"FXB resolved to {fxb.fengine}, {fxb.bstage}")
    adc, cd, fd, ph, dv = fxb.example_inputs(seed=SEED, margin=8192, rowed=True)
    fxb.set_beam_delays(dv)
    beams, vre, vim = fxb.step(adc, cd, fd, ph)
    # The plain chain on the same device tensors.
    n1, n2 = ff._split_ct(cfg.fft_size)
    flat = torch.as_tensor(adc, device=dev).reshape(a, p, -1)
    cdt = torch.as_tensor(cd, device=dev).reshape(a, 1).expand(a, p)
    starts = clamp_starts(cdt.reshape(-1), flat.shape[-1], fxb.samples_in)
    rot = fxb._fine_rot(fd, ph)
    rc, rs = (r.reshape(a * p, -1) for r in rot)
    shape = (a, p, s, cfg.n_channels)
    qr, qi = (torch.empty(shape, dtype=torch.int8, device=dev) for _ in range(2))
    _k1_plain(flat.reshape(a * p, -1), starts, fxb.window, rc, rs,
              (qr.view(a * p, s, -1), qi.view(a * p, s, -1)), chunk=a * p,
              n_spectra=s, n1=n1, n2=n2, dft_dtype="bfloat16")
    w = fxb.coeff_blocks
    ref = _stack_beams(torch, beamform_turned(ct.corner_turn_planes_reference(qr, qi), w,
                                              n_pols=p, precision="bf16"))
    # The F planes the step correlated (the same kernel on the same inputs).
    kr, ki = ff.fengine_fused(flat, fxb.window, None, None, n_channels=cfg.n_channels,
                              quant_scale=QUANT_SCALE, coarse_delays=cdt, n_spectra=s,
                              rot_planes=rot)
    _code_diff("fxb F plane", (kr, ki), (qr, qi))
    _exact("fxb visibilities vs the plain gram of the step's F planes", (vre, vim),
           xc.correlate_planes_fused_reference(kr, ki))
    dr = (kr.to(torch.int16) - qr.to(torch.int16)).abs().to(torch.int8)
    di = (ki.to(torch.int16) - qi.to(torch.int16)).abs().to(torch.int8)
    bound = _stack_beams(torch, beamform_turned(ct.corner_turn_planes_reference(dr, di),
                                                w.float().abs(), n_pols=p, precision="f32"))
    torch.cuda.synchronize()
    d = (beams - ref).abs()
    dmax, frac = float(d.max()), float((d > 1e-3).float().mean())
    over = int((d > bound + 1e-3 + 1e-5 * ref.abs()).sum())
    log(f"fxb engine [A=8 C=32768 B=16 taps=16 S=256]: beams max|d| {dmax:.4f} (flip bound "
        f"{float(bound.max()):.4f}), frac(|d|>1e-3) {frac:.3e}, over bound {over}")
    finite = all(bool(torch.isfinite(t).all()) for t in (beams, vre, vim))
    if not finite or over or frac > 5e-3:
        raise AssertionError("the FXB engine disagrees with the plain chain")
    _fxb_64ch(st)


#: FXB at 64 channels (fft 128): the reference's dispatch sends its X stage
#: to the corner turn (K5a) and K5b, as at any C < 128.
FXB64 = dict(n_ants=80, n_channels=64, n_beams=16, n_taps=16)
FXB64_STEPS = 3


def _fxb_64ch(st: dict) -> None:
    """FXBEngine at 80 ant x 64 ch x 16 beams x 16 taps, S=256, with the
    backends it resolves: each step launches K5b once and K3 never, and its
    visibilities are exactly the plain gram of its own turned F planes."""
    import torch

    from dpdk_dc_sand_tpu_torch import ArrayConfig
    from dpdk_dc_sand_tpu_torch.models import FXBEngine
    from dpdk_dc_sand_tpu_torch.ops import corner_turn as ct, xcorr as xc

    dev = torch.device("cuda")
    cfg = ArrayConfig(**FXB64)
    a, p, s, c = cfg.n_ants, cfg.n_pols, FLAG_S, cfg.n_channels
    fxb = FXBEngine(cfg, n_spectra=s, precision="bf16", device=dev)
    counters = {"k3": xc.correlate_planes_fused, "k5a": ct.corner_turn_planes,
                "k5b": xc.correlate_turned_fused}
    for fn in counters.values():
        fn.launches = 0
    _, cd, fd, ph, dv = fxb.example_inputs(seed=SEED + 6, margin=1024)
    fxb.set_beam_delays(dv)
    for step in range(FXB64_STEPS):
        adc = fxb.example_inputs(seed=SEED + 10 + step, margin=1024)[0]
        before = {k: fn.launches for k, fn in counters.items()}
        beams, vre, vim = fxb.step(adc, cd, fd, ph)
        torch.cuda.synchronize()
        d = {k: fn.launches - before[k] for k, fn in counters.items()}
        if d["k5b"] != 1 or d["k3"]:
            raise AssertionError(f"fxb 64 ch step {step}: launches {d}, want K5b once, K3 never")
        if not all(bool(torch.isfinite(t).all()) for t in (beams, vre, vim)):
            raise AssertionError(f"fxb 64 ch step {step}: non-finite outputs")
        qr, qi = fxb._f(adc, cd, fd, ph)  # the step's F planes, again
        xt = ct.corner_turn_planes_reference(qr, qi).view(c, 2 * a * p, s)
        _exact(f"fxb 64 ch step {step} visibilities vs the plain gram of its turned planes "
               f"(F codes rms {float(qr.float().pow(2).mean().sqrt()):.1f})", (vre, vim),
               xc.correlate_turned_fused_reference(xt, a * p))
    st["fxb64_launches"] = {k: fn.launches for k, fn in counters.items()}
    log(f"fxb 64 ch [A={a} C={c} B={cfg.n_beams} taps={cfg.n_taps} S={s}] backends "
        f"{fxb.fengine}, {fxb.bstage}: launches over {FXB64_STEPS} steps "
        f"{st['fxb64_launches']}")


def phase_fxb_flagship(st: dict) -> None:
    import numpy as np
    import torch

    from dpdk_dc_sand_tpu_torch import ArrayConfig
    from dpdk_dc_sand_tpu_torch.models import FXBEngine
    from dpdk_dc_sand_tpu_torch.ops import bstage, corner_turn as ct, fengine_fused as ff
    from dpdk_dc_sand_tpu_torch.ops import xcorr as xc
    from dpdk_dc_sand_tpu_torch.ops.beamform import beamform_turned
    from dpdk_dc_sand_tpu_torch.ops.fengine_fused import ingest_alignment
    from dpdk_dc_sand_tpu_torch.ops.requant import requantise

    torch.cuda.empty_cache()  # phase 6's engine and buffers are gone
    dev = torch.device("cuda")
    cfg = ArrayConfig(n_ants=80, n_channels=32768, n_beams=16, n_taps=16)
    a, p, s, c = cfg.n_ants, cfg.n_pols, 256, cfg.n_channels
    i = a * p
    fxb = FXBEngine(cfg, n_spectra=s, quant_scale=QUANT_SCALE, precision="bf16",
                    beam_quant_scale=0.25, device=dev)
    if (fxb.fengine, fxb.bstage, fxb.vis_precision) != ("fused", "turned", "int8"):
        raise AssertionError(f"FXB resolved to {fxb.fengine}, {fxb.bstage}, {fxb.vis_precision}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    rng = np.random.default_rng(SEED + 4)
    margin = 8192
    cd = rng.integers(0, margin, a).astype(np.int32)
    fd = rng.uniform(-0.5, 0.5, a).astype(np.float32)
    ph = (-np.pi * fd / 2).astype(np.float32)
    dv = np.zeros((cfg.n_beams, a, 4), np.float32)
    dv[..., 0] = rng.uniform(0, 5e-9, dv.shape[:-1])
    dv[..., 2] = rng.uniform(-np.pi, np.pi, dv.shape[:-1])
    n2 = ingest_alignment(cfg.fft_size)
    adc = torch.empty((a, p, (fxb.samples_in + margin) // n2, n2), dtype=torch.int8, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    counters = {"k1": ff.fengine_fused, "k2": bstage.beamform_turned_fused,
                "k4": ct.corner_turn_planes, "k3": xc.correlate_planes_fused,
                "k5b": xc.correlate_turned_fused}
    for fn in counters.values():
        fn.launches = 0
    times = []
    out = None

    def timed_step():
        nonlocal out
        adc.random_(-64, 64, generator=gen)  # fresh wire-rowed ADC every step
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        out = fxb.step(adc, cd, fd, ph)
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))

    fxb.set_beam_delays(dv)
    for _ in range(3):
        timed_step()
    dv[..., 2] += 0.25  # delay update: new steering phases and fine delays
    fd = (fd * 0.5).astype(np.float32)
    fxb.set_beam_delays(dv, t_s=1e-3)
    for _ in range(2):
        timed_step()
    launches = {k: fn.launches for k, fn in counters.items()}
    log(f"fxb flagship launches: {launches}")
    if min(launches["k1"], launches["k4"], launches["k3"]) < 1:
        raise AssertionError(f"a kernel of the FXB path never launched: {launches}")
    if launches["k2"] or launches["k5b"]:
        raise AssertionError(f"kernels off the FXB flagship path launched: {launches}")
    beams, vre, vim = out
    if tuple(beams.shape) != (p, c, s, cfg.n_beams, 2) or beams.dtype != torch.int8:
        raise AssertionError(f"beams {tuple(beams.shape)} {beams.dtype}")
    for v in (vre, vim):
        if tuple(v.shape) != (c, i, i) or v.dtype != torch.float32:
            raise AssertionError(f"visibilities {tuple(v.shape)} {v.dtype}")
        if not bool(torch.isfinite(v).all()):
            raise AssertionError("non-finite visibilities")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ms = float(np.median(times[1:]))
    samples = a * p * s * cfg.fft_size
    ratio = ms / st["fb_ms"]
    log(f"fxb flagship [80 ant x 32768 ch x 16 beams x 16 taps, S=256]: step ms "
        f"{['%.3f' % t for t in times]}, median(after first) {ms:.3f} ms, "
        f"{samples / ms / 1e3:.1f} Msamples/s, FXB/FB {ratio:.3f} (FB {st['fb_ms']:.3f} ms), "
        f"peak memory {peak_gb:.2f} GB ({st['card']})")

    # The last step's stages again, each timed alone (these launches come
    # after the count was read); the visibilities must be K3(K1(adc)).
    flat = adc.reshape(a, p, -1)
    cdt = torch.as_tensor(cd, device=dev).reshape(a, 1).expand(a, p)
    rot = (fxb.rot_cos, fxb.rot_sin)

    def k1():
        return ff.fengine_fused(flat, fxb.window, None, None, n_channels=c,
                                quant_scale=QUANT_SCALE, coarse_delays=cdt,
                                n_spectra=s, rot_planes=rot)

    qr, qi = k1()
    del out, beams
    _exact("fxb flagship visibilities vs K3(K1(adc))", xc.correlate_planes_fused(qr, qi),
           (vre, vim))
    del vre, vim
    x_t = ct.corner_turn_planes(qr, qi)

    def b_product():
        re, im = beamform_turned(x_t, fxb.coeff_blocks, n_pols=p, precision="bf16")
        return torch.stack([requantise(re, 0.25), requantise(im, 0.25)], dim=-1)

    stages = {
        "K1 (F)": cuda_ms(k1, iters=2),
        "K4 (turn)": cuda_ms(lambda: ct.corner_turn_planes(qr, qi)),
        "B product + requant (plain)": cuda_ms(b_product, iters=2),
        "K3 (X)": cuda_ms(lambda: xc.correlate_planes_fused(qr, qi), iters=2),
    }
    log("fxb flagship stages (ms): " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
        + f"; sum {sum(stages.values()):.3f} vs step {ms:.3f} ({st['card']})")
    st["fxb_launches"] = launches
    st["fxb"] = dict(ms=ms, ratio=ratio, stages=stages)


def phase_fir(st: dict) -> None:
    import torch

    from dpdk_dc_sand_tpu_torch.ops import pfb, pfb_fir

    torch.cuda.empty_cache()  # phase 10's engine and buffers are gone
    dev = torch.device("cuda")
    nb, taps, fft, s = 160, 16, 65536, 256  # the flagship's streams and frames
    n_frames = s + taps - 1
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    x = torch.randint(-128, 128, (nb, n_frames * fft), dtype=torch.int8, device=dev,
                      generator=gen)
    win = pfb.default_window(taps, fft, device=dev)
    tag = f"[{nb} x {n_frames} x {fft}, {taps} taps]"

    def kern():
        return pfb.pfb_fir(x, win)

    def plain():
        return pfb_fir.pfb_fir_reference(x.view(nb, n_frames, fft), win)

    got = kern()
    err = _exact(f"k6 int8 {tag}", (got.view(nb, s, fft),), (plain(),))
    del got
    ms, pms = cuda_ms(kern), cuda_ms(plain, iters=1)
    # What PyTorch's own streaming kernels reach on this byte mix: an int8 ->
    # f32 copy of the frames (2.84 GB in, 11.4 GB out) and a fill of K6's
    # output shape (10.7 GB out, nothing in).
    yard = torch.empty((nb, n_frames, fft), dtype=torch.float32, device=dev)
    copy_ms = cuda_ms(lambda: yard.copy_(x.view(nb, n_frames, fft)))
    fill_ms = cuda_ms(lambda: yard.view(-1)[: nb * s * fft].fill_(1.0))
    del yard
    log(f"k6 yardsticks: int8 -> f32 copy of the frames {copy_ms:.3f} ms "
        f"({5 * x.numel() / copy_ms / 1e9:.2f} TB/s), fill of [{nb}, {s}, {fft}] f32 "
        f"{fill_ms:.3f} ms ({4 * nb * s * fft / fill_ms / 1e9:.2f} TB/s) ({st['card']})")
    xf = torch.randn((8, n_frames * fft), device=dev, generator=gen) * 40
    _exact(f"k6 f32 [8 x {n_frames} x {fft}]", (pfb.pfb_fir(xf, win).view(8, s, fft),),
           (pfb_fir.pfb_fir_reference(xf.view(8, n_frames, fft), win),))
    f32_ms = cuda_ms(lambda: pfb.pfb_fir(xf, win))
    del xf
    torch.cuda.empty_cache()
    copies = _k6_ragged(torch, pfb_fir, dev, gen)
    bodies = {}
    for depth in (4, 8, 16):
        for f32 in (False, True):
            for mode in pfb_fir.COPY_MODES:
                at = pfb_fir.kernel_attributes(depth, f32, mode)
                bodies[f"{depth}/{'f32' if f32 else 'int8'}/{mode}"] = at
                if at["local_bytes"]:
                    raise AssertionError(f"k6 body {depth}/{f32}/{mode} spills: {at}")
    log("k6 bodies (register-ring depth / frames / copy: registers, local bytes): "
        + ", ".join(f"{k} {v['regs']}, {v['local_bytes']}" for k, v in bodies.items()))
    k6_bound = bound(nb * n_frames * fft + taps * fft * 4 + nb * s * fft * 4,
                     f32=fir_ops(nb * s * fft, taps))
    # The yardstick: one cuDNN depthwise conv1d computes the same sums over
    # the frames laid out [B, F, n_frames] in f32 (layout and cast untimed).
    lib_ms, lib_note = _conv1d_fir(
        lambda xt: xt.copy_(x.view(nb, n_frames, fft).transpose(1, 2)), (nb, fft, n_frames),
        win, pfb_fir.pfb_fir_reference(x[:8].view(8, n_frames, fft), win))
    lib_txt = f"{lib_ms:.3f} ms ({lib_note})" if lib_ms is not None else lib_note
    log(f"k6 {tag}: kernel {ms:.3f} ms, plain {pms:.3f} ms, bound {k6_bound['bound_ms']:.3f} ms "
        f"({k6_bound['bound_by']}), library conv1d {lib_txt}; f32 frames [8 streams] "
        f"{f32_ms:.3f} ms ({st['card']})")
    st["k6"] = dict(max_abs_err=err, ms=ms, plain_ms=pms, **k6_bound, library_ms=lib_ms,
                    f32_8_streams_ms=f32_ms, copy_ms=copy_ms, fill_ms=fill_ms,
                    ragged_copies=copies,
                    regs={k: (v["regs"], v["local_bytes"]) for k, v in bodies.items()})


#: K6's ragged shape: fft not a multiple of 16, more than 16 taps (two
#: passes), S over one block's run of 256 spectra, 3 streams.
K6_RAGGED = dict(fft=1000, taps=17, s=300, nb=3)


def _k6_ragged(torch, pfb_fir, dev, gen) -> list:
    """K6 bit-exact against plain at ``K6_RAGGED``, on bases that take the
    scalar (int8 and f32 from ``x[1:]``) and async (int8 and f32, aligned)
    copies; returns the copy modes that ran."""
    import math

    fft, taps, s, nb = (K6_RAGGED[k] for k in ("fft", "taps", "s", "nb"))
    n = nb * (s + taps - 1) * fft
    win = torch.randn((taps, fft), device=dev, generator=gen)
    copies = []
    for dtype, off in ((torch.int8, 1), (torch.int8, 0), (torch.float32, 1), (torch.float32, 0)):
        if dtype == torch.int8:
            raw = torch.randint(-128, 128, (n + off,), dtype=dtype, device=dev, generator=gen)
        else:
            raw = torch.randn((n + off,), device=dev, generator=gen) * 50
        frames = raw[off:].view(nb, s + taps - 1, fft)
        plan = pfb_fir._fir_plan(fft, taps, frames.element_size(),
                                 math.gcd(frames.data_ptr(), 16), n_spectra=s)
        _exact(f"k6 ragged {str(dtype)[6:]} [{nb} x {s + taps - 1} x {fft}, {taps} taps, "
               f"base +{off}, {plan.copy}, {len(plan.passes)} passes]",
               (pfb_fir.pfb_fir_frames(frames, win),), (pfb_fir.pfb_fir_reference(frames, win),))
        copies.append(plan.copy)
    if copies != ["scalar", "async"] * 2:
        raise AssertionError(f"k6 ragged: the copy modes run were {copies}")
    return copies


def phase_fengine_dit(st: dict) -> None:
    import torch

    from dpdk_dc_sand_tpu_torch.ops import fengine_fused as ff
    from dpdk_dc_sand_tpu_torch.ops.pfb import default_window

    dev = torch.device("cuda")
    _fir_bodies(st, "k7")
    # 8 of the flagship's 160 streams: fft 65536, 16 taps, S = 256.
    fft, taps, s, lead = 2 * FLAG["n_channels"], FLAG["n_taps"], FLAG_S, (4, 2)
    nb, c, n_frames = lead[0] * lead[1], fft // 2, s + taps - 1
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    frames = torch.randint(-64, 64, (*lead, n_frames, fft), dtype=torch.int8, device=dev,
                           generator=gen)
    fd = torch.rand(lead, device=dev, generator=gen) - 0.5
    ph = -3.14159265 * fd / 2
    win = default_window(taps, fft, device=dev)
    kw = dict(n_channels=c, quant_scale=QUANT_SCALE)
    pass_counters = (ff.k1_fir, ff.dit_dft, ff.k1_fir_f32, ff.dit_dft_f32, *_k7_stage_fns(ff))
    for f in (ff.fengine_dit, ff.fengine_fused, *pass_counters):
        f.launches = 0
    outs, passes = {}, {}
    for dt in ("bfloat16", "float32"):  # each type's FIR pass, then its DFT pass
        before = [f.launches for f in pass_counters]
        for deint in ("matmul", "bitcast"):
            outs[(dt, deint)] = ff.fengine_fused(frames, win, fd, ph, dft_dtype=dt, deint=deint,
                                                 **kw)
        torch.cuda.synchronize()
        passes[dt] = {f.__name__: f.launches - b for f, b in zip(pass_counters, before)}
    launches = {"k7": ff.fengine_dit.launches, "k1": ff.fengine_fused.launches}
    groups = {dt: -(-nb // ff._plane_group(nb, s, fft, size))  # plane groups a call
              for dt, size in (("bfloat16", 2), ("float32", 4))}
    log(f"fengine_dit launches: {launches}; its passes by DFT type ({groups} group(s) of "
        f"streams a call): {passes}")
    if launches != {"k7": 4, "k1": 0}:
        raise AssertionError(f"the DIT path did not run through K7 alone: {launches}")
    want = {dt: {f.__name__: 2 * groups[dt] * (f.__name__ in names) for f in pass_counters}
            for dt, names in (("bfloat16", ("k1_fir", "dit_dft")),
                              ("float32", ("k1_fir_f32", "dit_dft_f32")))}
    if passes != want:
        raise AssertionError(f"K7 did not run each type's two passes alone: {passes}, want "
                             f"{want}")
    _, n1, n2 = ff._deint_mode(c, "matmul")
    rc, rs = (r.reshape(nb, c) for r in ff._rotation_planes(fd, ph, c, QUANT_SCALE, (c,)))
    x = frames.view(nb, n_frames, fft)
    worst = 0
    times = {}
    for dt in ("bfloat16", "float32"):
        got, bc = outs[(dt, "matmul")], outs[(dt, "bitcast")]

        def plain():
            return ff.fengine_dit_reference(x, win, rc, rs, n1=n1, n2=n2, dft_dtype=dt)

        err = _code_diff(f"k7 {dt} [{nb} streams x S={s} x fft {fft}, {n1}x{n2}]",
                         [g.view(nb, s, c) for g in got], plain(),
                         max_frac=1e-3 if dt == "bfloat16" else 1e-4)
        if dt == "bfloat16":
            worst = max(worst, err)
        else:
            f32_err = err
        if not (torch.equal(got[0], bc[0]) and torch.equal(got[1], bc[1])):
            raise AssertionError(f"k7 {dt}: deint='bitcast' is not the bytes of 'matmul'")
        times[dt] = (cuda_ms(lambda: ff.fengine_fused(frames, win, fd, ph, dft_dtype=dt,
                                                      deint="matmul", **kw)),
                     cuda_ms(plain, iters=1))
        log(f"k7 {dt}: bitcast == matmul bytes; kernel {times[dt][0]:.3f} ms, plain "
            f"{times[dt][1]:.3f} ms ({st['card']})")
    del outs
    macs = 4 * n1 * n1 * n2 + 8 * n2 * n2 * n1  # per spectrum, both half-length DFTs
    nbytes = nb * n_frames * fft + taps * fft * 4 + 2 * nb * c * 4 + 2 * nb * s * c
    k7_bound = bound(nbytes, bf16=2 * macs * nb * s, f32=fir_ops(nb * s * fft, taps))
    f32_bound = bound(nbytes, f32=2 * macs * nb * s + fir_ops(nb * s * fft, taps))
    log(f"k7 bound: bf16 DFT {k7_bound['bound_ms']:.3f} ms ({k7_bound['bound_by']}), f32 DFT "
        f"{f32_bound['bound_ms']:.3f} ms ({f32_bound['bound_by']})")
    # The yardstick: cuFFT's rfft of the same 8 streams' f32 FIR (the DFT
    # part alone, without the FIR, the rotation or the requant).
    fir32 = ff._dit_fir(x, win)
    rfft_ms = cuda_ms(lambda: torch.fft.rfft(fir32, dim=-1))
    del fir32
    at = ff.dit_dft_attributes(n1, n2)
    log(f"k7 DFT pass body at {n1}x{n2}: {at['regs']} registers, {at['local_bytes']} local "
        f"(spill) bytes, KC {at['kc']}, K tiles {at['ktb']}, {at['stages']} ring stages, "
        f"{at['smem_bytes']} bytes of shared memory; rfft of the {nb} streams' f32 FIR "
        f"{rfft_ms:.3f} ms ({st['card']})")
    if at["local_bytes"]:
        raise AssertionError(f"K7's DFT pass spills: {at}")
    # f32 K7 on the same streams: each f32 pass alone, the f32 pass's body.
    flat, zeros = x.view(nb, n_frames * fft), torch.zeros(nb, dtype=torch.int64, device=dev)
    plane = ff.k1_fir_f32(flat, zeros, win, n_spectra=s)
    if not torch.equal(plane, ff._dit_fir(x, win)):
        raise AssertionError("K1's f32 FIR pass on zero starts is not K7's f32 FIR")
    pr, pi = ff.dit_dft_f32(plane, rc, rs, n1=n1, n2=n2)
    got = ff.fengine_fused(frames, win, fd, ph, dft_dtype="float32", deint="matmul", **kw)
    if not (torch.equal(pr, got[0].view(nb, s, c)) and torch.equal(pi, got[1].view(nb, s, c))):
        raise AssertionError("K7 f32's DFT pass alone differs from K7 f32 on the same streams")
    del pr, pi, got
    fir_ms = cuda_ms(lambda: ff.k1_fir_f32(flat, zeros, win, n_spectra=s))
    dft_ms = cuda_ms(lambda: ff.dit_dft_f32(plane, rc, rs, n1=n1, n2=n2))
    dft_plain_ms = cuda_ms(lambda: ff.dit_dft_f32_reference(plane, rc, rs, n1=n1, n2=n2),
                           iters=1)
    del plane
    a32 = ff.dit_dft_f32_attributes(n1, n2)
    if a32["local_bytes"]:
        raise AssertionError(f"K7's f32 DFT pass spills: {a32}")
    dft32_bound = bound(nb * s * fft * 4 + 2 * nb * c * 4 + 2 * nb * s * c, f32=2 * macs * nb * s)
    log(f"k7 f32 [{nb} streams x S={s} x fft {fft}]: two passes {times['float32'][0]:.3f} ms "
        f"(bound {f32_bound['bound_ms']:.3f}), plain {times['float32'][1]:.3f} ms; f32 FIR "
        f"pass {fir_ms:.3f} ms, f32 DFT pass {dft_ms:.3f} ms (bound "
        f"{dft32_bound['bound_ms']:.3f}, {dft32_bound['bound_ms'] / dft_ms:.1%} of it; plain "
        f"{dft_plain_ms:.3f}); the f32 DFT pass's body {a32} ({st['card']})")
    st["k7"] = dict(max_abs_err=float(worst), ms=times["bfloat16"][0],
                    plain_ms=times["bfloat16"][1], **k7_bound, library_ms=None,
                    f32_ms=times["float32"][0], f32_plain_ms=times["float32"][1],
                    f32_bound_ms=f32_bound["bound_ms"],
                    f32_max_abs_err=float(f32_err), launches=launches["k7"],
                    fir_launches=passes["bfloat16"]["k1_fir"],
                    dft_launches=passes["bfloat16"]["dit_dft"], rfft_ms=rfft_ms,
                    dft_regs=at["regs"], dft_local_bytes=at["local_bytes"])
    st["dit_dft_f32"] = dict(max_abs_err=float(f32_err), subset_ms=dft_ms,
                             subset_plain_ms=dft_plain_ms, subset_fir_ms=fir_ms,
                             subset_bound_ms=dft32_bound["bound_ms"],
                             launches=passes["float32"]["dit_dft_f32"],
                             fir_launches=passes["float32"]["k1_fir_f32"],
                             regs=a32["regs"], local_bytes=a32["local_bytes"],
                             kc=a32["kc"], sb=a32["sb"])
    del frames, x, flat
    torch.cuda.empty_cache()
    _k7_flagship(st, n1, n2, gen)
    torch.cuda.empty_cache()  # the flagship streams are gone
    _k7_routes(st, gen)


def _k7_flagship(st: dict, n1: int, n2: int, gen) -> None:
    """K7 bf16 at the flagship's full width (160 streams, S = 256, fft 65536):
    checked on its last 8 streams (K1's last plane group) against plain;
    timed whole, each pass alone and the DFT pass's stops; its scratch."""
    import torch

    from dpdk_dc_sand_tpu_torch.ops import fengine_fused as ff
    from dpdk_dc_sand_tpu_torch.ops.pfb import default_window

    dev = torch.device("cuda")
    fft, taps, s = 2 * FLAG["n_channels"], FLAG["n_taps"], FLAG_S
    nb, c, n_frames = FLAG["n_ants"] * 2, fft // 2, s + taps - 1
    frames = torch.randint(-64, 64, (nb, n_frames, fft), dtype=torch.int8, device=dev,
                           generator=gen)
    fd = torch.rand(nb, device=dev, generator=gen) - 0.5
    rc, rs = (r.reshape(nb, c) for r in ff._rotation_planes(fd, -3.14159265 * fd / 2, c,
                                                             QUANT_SCALE, (c,)))
    win = default_window(taps, fft, device=dev)

    def k7():
        return ff.fengine_dit(frames, win, rc, rs, n1=n1, n2=n2)

    ff.fengine_dit.launches = ff.k1_fir.launches = ff.dit_dft.launches = 0
    got = k7()
    torch.cuda.synchronize()
    launches = {"k7": ff.fengine_dit.launches, "k1_fir": ff.k1_fir.launches,
                "dit_dft": ff.dit_dft.launches}
    group = ff._plane_group(nb, s, fft)
    if launches != {"k7": 1, "k1_fir": -(-nb // group), "dit_dft": -(-nb // group)}:
        raise AssertionError(f"K7 at {nb} streams did not run a pair of passes a group: {launches}")
    last = slice(nb - 8, nb)
    err = _code_diff(f"k7 bf16 [streams {nb - 8}..{nb - 1} of {nb} x S={s} x fft {fft}]",
                     [g[last] for g in got],
                     ff.fengine_dit_reference(frames[last], win, rc[last], rs[last], n1=n1, n2=n2))
    del got
    ms = cuda_ms(k7, iters=2)
    # Each pass alone over all 160 streams (the FIR pass into a whole plane).
    flat = frames.view(nb, n_frames * fft)
    zeros = torch.zeros(nb, dtype=torch.int64, device=dev)
    fir_ms = cuda_ms(lambda: ff.k1_fir(flat, zeros, win, n_spectra=s), iters=2)
    plane = ff.k1_fir(flat, zeros, win, n_spectra=s)
    dft_ms = cuda_ms(lambda: ff.dit_dft(plane, rc, rs, n1=n1, n2=n2), iters=2)
    # The DFT pass's stops: checked on 8 streams of a plane scaled by a power
    # of two (exact in bf16) so that stage B's re stays in int8 range, then
    # timed on the whole plane.
    chk = (plane[:8].to(torch.float32) * 2.0 ** -7).to(torch.bfloat16)
    for stop in ff.DIT_DFT_STOPS:
        g, r = ff.dit_dft_stop(chk, n1=n1, n2=n2, stop=stop), ff.dit_dft_stop_reference(
            stop, chk, n1=n1, n2=n2)
        if stop == "stagea":
            _exact("k7 DFT pass stop stagea [8 streams] (writes nothing)", g, r)
        else:
            _code_diff(f"k7 DFT pass stop {stop} [8 streams, plane x 2^-7]", g, r)
    del chk
    stop_ms = {stop: cuda_ms(lambda: ff.dit_dft_stop(plane, n1=n1, n2=n2, stop=stop), iters=2)
               for stop in ff.DIT_DFT_STOPS}
    stop_ms["full"] = dft_ms
    del plane
    # The scratch: one call's peak above what was allocated before it, less
    # its two int8 outputs.
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    outs = k7()
    torch.cuda.synchronize()
    scratch = torch.cuda.max_memory_allocated() - before - sum(
        o.numel() * o.element_size() for o in outs)
    del outs
    macs = 4 * n1 * n1 * n2 + 8 * n2 * n2 * n1
    k7_bound = bound(nb * n_frames * fft + taps * fft * 4 + 2 * nb * c * 4 + 2 * nb * s * c,
                     bf16=2 * macs * nb * s, f32=fir_ops(nb * s * fft, taps))
    fir_bound = bound(nb * n_frames * fft + taps * fft * 4 + nb * s * fft * 2,
                      f32=fir_ops(nb * s * fft, taps))
    dft_bound = bound(nb * s * fft * 2 + 2 * nb * c * 4 + 2 * nb * s * c, bf16=2 * macs * nb * s)
    steps = list(stop_ms.items())
    split = ", ".join(f"{b} +{t - a:.3f}" for (_, a), (b, t) in zip(steps, steps[1:]))
    log(f"k7 bf16 [{nb} streams x S={s} x fft {fft}]: {ms:.3f} ms (bound "
        f"{k7_bound['bound_ms']:.3f}, {k7_bound['bound_by']}); FIR pass {fir_ms:.3f} (bound "
        f"{fir_bound['bound_ms']:.3f}), DFT pass {dft_ms:.3f} (bound {dft_bound['bound_ms']:.3f}); "
        f"DFT pass stops " + ", ".join(f"{k} {v:.3f}" for k, v in stop_ms.items())
        + f" (steps: {split}); K1 at the F+B flagship {st['k1']['ms']:.3f} ms; scratch "
        f"{scratch / 1e9:.3f} GB a call (peak over its outputs); launches {launches} "
        f"({st['card']})")
    st["k7"].update(ms_160=ms, max_abs_err_160=float(err), fir_ms=fir_ms, dft_ms=dft_ms,
                    dft_stop_ms=stop_ms, scratch_bytes=scratch, launches_160=launches)
    _k7_f32_flagship(st, n1, n2, frames, win, rc, rs)


def _k7_f32_flagship(st: dict, n1: int, n2: int, frames, win, rc, rs) -> None:
    """K7 f32 at the flagship's full width (the same 160 streams): K1's f32
    FIR pass and the FFMA DFT pass a group of 16; checked on its last 8
    streams against plain at the f32 contract; timed whole, each pass alone
    over all 160 streams (into a whole f32 plane) and the plain version; its
    bound, scratch and launches."""
    import torch

    from dpdk_dc_sand_tpu_torch.ops import fengine_fused as ff

    dev = torch.device("cuda")
    nb, n_frames, fft = frames.shape
    taps, c = win.shape[0], fft // 2
    s = n_frames - taps + 1

    def k7():
        return ff.fengine_dit(frames, win, rc, rs, n1=n1, n2=n2, dft_dtype="float32")

    counters = (ff.fengine_dit, ff.k1_fir_f32, ff.dit_dft_f32, ff.k1_fir, ff.dit_dft,
                *_k7_stage_fns(ff))
    for f in counters:
        f.launches = 0
    got = k7()
    torch.cuda.synchronize()
    launches = {f.__name__: f.launches for f in counters}
    groups = -(-nb // ff._plane_group(nb, s, fft, 4))
    if launches != {f.__name__: {"fengine_dit": 1, "k1_fir_f32": groups,
                                 "dit_dft_f32": groups}.get(f.__name__, 0) for f in counters}:
        raise AssertionError(f"K7 f32 at {nb} streams did not run a pair of f32 passes a "
                             f"group alone: {launches}")
    last = slice(nb - 8, nb)
    err = _code_diff(f"k7 f32 [streams {nb - 8}..{nb - 1} of {nb} x S={s} x fft {fft}]",
                     [g[last] for g in got],
                     ff.fengine_dit_reference(frames[last], win, rc[last], rs[last], n1=n1,
                                              n2=n2, dft_dtype="float32"), max_frac=1e-4)
    del got
    ms = cuda_ms(k7, iters=2)
    plain_ms = cuda_ms(_chunked(lambda b: ff.fengine_dit_reference(
        frames[b], win, rc[b], rs[b], n1=n1, n2=n2, dft_dtype="float32"), nb), iters=1)
    flat = frames.view(nb, n_frames * fft)
    zeros = torch.zeros(nb, dtype=torch.int64, device=dev)
    fir_ms = cuda_ms(lambda: ff.k1_fir_f32(flat, zeros, win, n_spectra=s), iters=2)
    plane = ff.k1_fir_f32(flat, zeros, win, n_spectra=s)
    dft_ms = cuda_ms(lambda: ff.dit_dft_f32(plane, rc, rs, n1=n1, n2=n2), iters=2)
    dft_plain_ms = cuda_ms(_chunked(lambda b: ff.dit_dft_f32_reference(
        plane[b], rc[b], rs[b], n1=n1, n2=n2), nb), iters=1)
    del plane
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    outs = k7()
    torch.cuda.synchronize()
    scratch = torch.cuda.max_memory_allocated() - before - sum(
        o.numel() * o.element_size() for o in outs)
    del outs
    macs = 4 * n1 * n1 * n2 + 8 * n2 * n2 * n1
    k7_bound = bound(nb * n_frames * fft + taps * fft * 4 + 2 * nb * c * 4 + 2 * nb * s * c,
                     f32=2 * macs * nb * s + fir_ops(nb * s * fft, taps))
    fir_bound = bound(nb * n_frames * fft + taps * fft * 4 + nb * s * fft * 4,
                      f32=fir_ops(nb * s * fft, taps))
    dft_bound = bound(nb * s * fft * 4 + 2 * nb * c * 4 + 2 * nb * s * c, f32=2 * macs * nb * s)
    log(f"k7 f32 [{nb} streams x S={s} x fft {fft}]: {ms:.3f} ms (bound "
        f"{k7_bound['bound_ms']:.3f}, {k7_bound['bound_by']}), plain {plain_ms:.3f}; f32 FIR "
        f"pass {fir_ms:.3f} (bound "
        f"{fir_bound['bound_ms']:.3f}, {fir_bound['bound_by']}), f32 DFT pass {dft_ms:.3f} "
        f"(bound {dft_bound['bound_ms']:.3f}, {dft_bound['bound_by']}, "
        f"{dft_bound['bound_ms'] / dft_ms:.1%} of it; plain {dft_plain_ms:.3f}); scratch "
        f"{scratch / 1e9:.3f} GB a call (peak over its outputs); launches {launches} "
        f"({st['card']})")
    st["k7"].update(f32_ms_160=ms, f32_plain_ms_160=plain_ms,
                    f32_bound_ms_160=k7_bound["bound_ms"], f32_max_abs_err_160=float(err),
                    f32_fir_ms=fir_ms, f32_dft_ms=dft_ms, f32_scratch_bytes=scratch,
                    f32_launches_160=launches)
    st["dit_dft_f32"].update(ms=dft_ms, plain_ms=dft_plain_ms, **dft_bound, library_ms=None,
                             max_abs_err_160=float(err), launches_160=launches["dit_dft_f32"])


#: K7's routes off the flagship's split at full width (phase 12): (fft,
#: operand type, streams, S), each 160 x 256 x 65536 samples, as the F+B
#: flagship: N1 = 8 (fft 1024, 8 x 64) in both forms on the two passes, f32
#: 1024 x 1024 (fft 2^21) and bf16 and f32 2048 x 2048 (fft 2^23) on the
#: three passes.
K7_ROUTE_CASES = ((1024, "bfloat16", 160, 16384), (1024, "float32", 160, 16384),
                  (1 << 21, "float32", 160, 8), (1 << 23, "bfloat16", 160, 2),
                  (1 << 23, "float32", 160, 2))


#: K7 at its routes' geometries as the parent's SIMT body is timed there
#: (``_k7_timed``, on this checkout in phase 12 and on a checkout of the
#: parent beside it): (fft, operand type, streams, S, taps). fft 1024 at
#: full width; f32 fft 2^21 on 16 streams x S = 8 (one wave of the SIMT
#: body's blocks); fft 2^23 on 2 streams x S = 2 x 4 taps (the SIMT body
#: took ~21 s there).
K7_TIMED_CASES = ((1024, "bfloat16", 160, 16384, 16), (1024, "float32", 160, 16384, 16),
                  (1 << 21, "float32", 16, 8, 16), (1 << 23, "bfloat16", 2, 2, 4),
                  (1 << 23, "float32", 2, 2, 4))


def _k7_timed(ff, fft: int, dft_dtype: str, nb: int, s: int, taps: int) -> float:
    """ms of one K7 call through ``ff.fengine_fused(deint="matmul")`` of the
    module ``ff`` (it needs nothing newer than that entry point) on streams
    made on the card from ``SEED``: one call at the same size first (the
    buffers' first allocation), then the mean of 3 calls (1 where a call
    takes over a second) by CUDA events."""
    import torch

    from dpdk_dc_sand_tpu_torch.ops.pfb import default_window

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    frames = torch.randint(-64, 64, (nb, s + taps - 1, fft), dtype=torch.int8, device=dev,
                           generator=gen)
    fd = torch.rand(nb, device=dev, generator=gen) - 0.5
    win = default_window(taps, fft, device=dev)
    kw = dict(n_channels=fft // 2, quant_scale=QUANT_SCALE * (65536 / fft) ** 0.5,
              dft_dtype=dft_dtype, deint="matmul")
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    ff.fengine_fused(frames, win, fd, -1.5 * fd, **kw)
    e1.record()
    e1.synchronize()
    iters = 1 if e0.elapsed_time(e1) > 1000 else 3
    e0.record()
    for _ in range(iters):
        ff.fengine_fused(frames, win, fd, -1.5 * fd, **kw)
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def _k7_stage_fns(ff) -> tuple:
    """K7's three-pass stage wrappers (their launch counters)."""
    return (ff.dit_stage_a, ff.dit_stage_b, ff.dit_stage_a_f32, ff.dit_stage_b_f32)


def _k7_case(n1, n2, nb, s, taps, dft_dtype, three):
    """K7's bound at a case (``chip_smoke.py:bound``) and its passes' own,
    as ``_k1_case``: each input byte read once (the frames, the window, the
    combine factors, the rotation planes), each output written once; the
    FIR's f32 operations and both half-length DFTs' (4·N1²·N2 + 8·N2²·N1
    multiply-adds a spectrum) in the operand type. Per pass: the FIR pass
    writes its plane; stage A reads it and writes T re and im; stage B (or
    the DFT pass) reads those and writes the outputs."""
    fft, n = 2 * n1 * n2, n1 * n2
    item = 2 if dft_dtype == "bfloat16" else 4
    kind = "bf16" if dft_dtype == "bfloat16" else "f32"
    x_bytes = nb * (s + taps - 1) * fft + taps * fft * 4
    rest = 2 * nb * n * 4 + 2 * n * 4 + 2 * nb * s * n  # rotation, combine, outputs
    plane = nb * s * fft * item
    f_ops = fir_ops(nb * s * fft, taps)
    a_ops, b_ops = nb * s * 2 * 4 * n1 * n1 * n2, nb * s * 2 * 8 * n2 * n2 * n1
    ops = {"f32": f_ops}
    ops[kind] = ops.get(kind, 0) + a_ops + b_ops
    k7 = bound(x_bytes + rest, **ops)
    passes = {"fir": bound(x_bytes + plane, f32=f_ops)}
    if three:
        passes["stage_a"] = bound(3 * plane, **{kind: a_ops})
        passes["stage_b"] = bound(2 * plane + rest, **{kind: b_ops})
    else:
        passes["dft"] = bound(plane + rest, **{kind: a_ops + b_ops})
    return k7, passes


def _k7_routes(st: dict, gen) -> None:
    """K7 on its routes off the flagship's split at full width
    (``K7_ROUTE_CASES``): the route's passes, each once a group of its
    scratch, and nothing else (the counts set to 0 just before, read just
    after); the last streams against plain within the form's code contract;
    the call, each pass over all the streams (the call's own groups and
    buffers), the plain version on the checked streams, the bounds and the
    scratch; on the three-pass route each stage alone against its plain
    version on the last stream; every body's registers and spill bytes (a
    spill fails the phase)."""
    import torch

    from dpdk_dc_sand_tpu_torch.ops import fengine_fused as ff
    from dpdk_dc_sand_tpu_torch.ops.pfb import default_window

    dev = torch.device("cuda")
    taps = FLAG["n_taps"]
    bodies = {"dit_dft n1=8": ff.dit_dft_attributes(8, 64),
              "dit_dft_f32 n1=8": ff.dit_dft_f32_attributes(8, 64)}
    for n1, n2, dt in ((1024, 1024, "float32"), (2048, 2048, "bfloat16"),
                       (2048, 2048, "float32")):
        for stage, at in ff.dit_stage_attributes(n1, n2, dt).items():
            bodies[f"stage {stage} {dt} {n1}x{n2}"] = at
    log("k7 route bodies: " + "; ".join(f"{k} {v['regs']} registers, {v['local_bytes']} local "
                                        f"bytes" for k, v in bodies.items()) + f" ({st['card']})")
    st["k7_routes"] = {}
    for fft, dt, nb, s in K7_ROUTE_CASES:
        _, n1, n2 = ff._deint_mode(fft // 2, "matmul")
        f32 = dt == "float32"
        body = ff._dit_body(n1, n2, dt)
        three = body.startswith("three_pass")
        c, n_frames = fft // 2, s + taps - 1
        frames = torch.randint(-64, 64, (nb, n_frames, fft), dtype=torch.int8, device=dev,
                               generator=gen)
        fd = torch.rand(nb, device=dev, generator=gen) - 0.5
        scale = QUANT_SCALE * (65536 / fft) ** 0.5  # the codes' rms as at the flagship
        rc, rs = (r.reshape(nb, c) for r in ff._rotation_planes(fd, -1.5 * fd, c, scale, (c,)))
        win = default_window(taps, fft, device=dev)
        fir_fn = ff.k1_fir_f32 if f32 else ff.k1_fir
        if three:
            passes = (fir_fn, *(_k7_stage_fns(ff)[2:] if f32 else _k7_stage_fns(ff)[:2]))
        else:
            passes = (fir_fn, ff.dit_dft_f32 if f32 else ff.dit_dft)
        counters = (ff.fengine_dit, ff.k1_fir, ff.k1_fir_f32, ff.dit_dft, ff.dit_dft_f32,
                    *_k7_stage_fns(ff))

        def k7():
            return ff.fengine_dit(frames, win, rc, rs, n1=n1, n2=n2, dft_dtype=dt)

        tag = f"k7 {dt} fft {fft} [{nb} streams x S={s} x {taps} taps, {n1}x{n2}, {body}]"
        for f in counters:
            f.launches = 0
        got = k7()
        torch.cuda.synchronize()
        launches = {f.__name__: f.launches for f in counters}
        group = ff._plane_group(nb, s, fft, (3 if three else 1) * (4 if f32 else 2))
        groups = -(-nb // group)
        want = {f.__name__: groups if f in passes else int(f is ff.fengine_dit) for f in counters}
        if launches != want:
            raise AssertionError(f"{tag} ran {launches}, want {want}")
        k = 8 if fft <= 65536 else (2 if fft <= 1 << 21 else 1)  # streams held to plain
        last = slice(nb - k, nb)

        def plain():
            return ff.fengine_dit_reference(frames[last], win, rc[last], rs[last], n1=n1, n2=n2,
                                            dft_dtype=dt)

        err = _code_diff(tag + f" [last {k} streams]", [g[last] for g in got], plain(),
                         max_frac=1e-4 if f32 else 1e-3)
        del got
        ms = cuda_ms(k7, iters=1 if fft > 65536 else 2)
        plain_ms = cuda_ms(plain, iters=1)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        outs = k7()
        torch.cuda.synchronize()
        scratch = torch.cuda.max_memory_allocated() - before - sum(
            o.numel() * o.element_size() for o in outs)
        # Each pass over all the streams, in the call's groups and buffers.
        outr, outi = outs
        dtype = torch.float32 if f32 else torch.bfloat16
        plane = torch.empty((group, s, fft), dtype=dtype, device=dev)
        flat = frames.view(nb, n_frames * fft)
        zeros = torch.zeros(nb, dtype=torch.int64, device=dev)
        spans = [slice(b0, min(nb, b0 + group)) for b0 in range(0, nb, group)]
        pass_ms = {"fir": cuda_ms(lambda: [ff._fir_pass(flat[b], zeros[b], win,
                                                        plane[:b.stop - b.start])
                                           for b in spans], iters=1)}
        if three:
            tr, ti = (torch.empty((group, s, *ff._t_layout(n1, 2 * n2, dtype)), dtype=dtype,
                                  device=dev) for _ in range(2))
            pass_ms["stage_a"] = cuda_ms(lambda: [ff._dit_stage_a_pass(
                plane[:b.stop - b.start], tr[:b.stop - b.start], ti[:b.stop - b.start], n1=n1,
                n2=n2) for b in spans], iters=1)
            pass_ms["stage_b"] = cuda_ms(lambda: [ff._dit_stage_b_pass(
                tr[:b.stop - b.start], ti[:b.stop - b.start], rc[b], rs[b], outr[b], outi[b],
                n1=n1, n2=n2) for b in spans], iters=1)
            del tr, ti
        else:
            dft = ff._dit_dft_f32_pass if f32 else ff._dit_dft_pass
            pass_ms["dft"] = cuda_ms(lambda: [dft(plane[:b.stop - b.start], rc[b], rs[b],
                                                  outr[b], outi[b], n1=n1, n2=n2)
                                              for b in spans], iters=1)
        del outs, outr, outi, plane
        k7_bound, pass_bounds = _k7_case(n1, n2, nb, s, taps, dt, three)
        rec = dict(fft=fft, n1=n1, n2=n2, streams=nb, s=s, route=body, ms=ms, plain_ms=plain_ms,
                   plain_streams=k, max_abs_err=float(err), **k7_bound, launches=launches,
                   groups=groups, pass_ms=pass_ms,
                   pass_bound_ms={p: b["bound_ms"] for p, b in pass_bounds.items()},
                   pass_bound_by={p: b["bound_by"] for p, b in pass_bounds.items()},
                   scratch_bytes=scratch)
        if three:
            # Each stage alone on the last stream, against its plain version.
            one = slice(nb - 1, nb)
            p1 = fir_fn(flat[one], zeros[one], win, n_spectra=s)
            if not torch.equal(p1, ff.k1_fir_reference(flat[one], zeros[one], win, n_spectra=s,
                                                       dft_dtype=dt)):
                raise AssertionError(f"{tag}: the FIR pass differs from plain [last stream]")
            stage_a, stage_b = (ff.dit_stage_a_f32, ff.dit_stage_b_f32) if f32 else (
                ff.dit_stage_a, ff.dit_stage_b)
            tr, ti = stage_a(p1, n1=n1, n2=n2)
            wr, wi = ff.dit_stage_a_reference(p1, n1=n1, n2=n2, dft_dtype=dt)
            t_err = max(float((g.float() - w.float()).abs().max()) for g, w in ((tr, wr), (ti, wi)))
            t_share = max(float((g != w).float().mean()) for g, w in ((tr, wr), (ti, wi)))
            del tr, ti
            sb = stage_b(wr.contiguous(), wi.contiguous(), rc[one], rs[one], n1=n1, n2=n2)
            b_err = _code_diff(tag + " stage B alone on plain T [last stream]", sb,
                               ff.dit_stage_b_reference(wr, wi, rc[one], rs[one], n1=n1, n2=n2,
                                                        dft_dtype=dt),
                               max_frac=1e-4 if f32 else 1e-3)
            a_plain = cuda_ms(lambda: ff.dit_stage_a_reference(p1, n1=n1, n2=n2, dft_dtype=dt),
                              iters=1)
            b_plain = cuda_ms(lambda: ff.dit_stage_b_reference(wr, wi, rc[one], rs[one], n1=n1,
                                                               n2=n2, dft_dtype=dt), iters=1)
            rec.update(stage_a_t_max_abs_err=t_err, stage_a_t_differ=t_share,
                       stage_b_max_abs_err=float(b_err), stage_a_plain_ms_1=a_plain,
                       stage_b_plain_ms_1=b_plain)
            del p1, wr, wi, sb
        else:
            pk = fir_fn(flat[last], zeros[last], win, n_spectra=s)
            if not torch.equal(pk, ff.k1_fir_reference(flat[last], zeros[last], win,
                                                       n_spectra=s, dft_dtype=dt)):
                raise AssertionError(f"{tag}: the FIR pass differs from plain [last {k} streams]")
            ref_fn = ff.dit_dft_f32_reference if f32 else ff.dit_dft_reference
            rec["dft_plain_ms"] = cuda_ms(lambda: ref_fn(pk, rc[last], rs[last], n1=n1, n2=n2),
                                          iters=1)
            del pk
        st["k7_routes"][(fft, dt)] = rec
        log(f"{tag}: {ms:.3f} ms (bound {k7_bound['bound_ms']:.3f}, {k7_bound['bound_by']}); "
            + ", ".join(f"{p} {t:.3f} (bound {pass_bounds[p]['bound_ms']:.3f}, "
                        f"{pass_bounds[p]['bound_by']})" for p, t in pass_ms.items())
            + f"; plain {plain_ms:.3f} ms on {k} streams"
            + (f" (its DFT pass {rec['dft_plain_ms']:.3f})" if not three else "")
            + f"; scratch {scratch / 1e9:.3f} GB a call; "
            f"{groups} group(s) of {group}; launches {launches}"
            + (f"; stage A alone: T differs on {rec['stage_a_t_differ']:.2e} of values (max "
               f"{rec['stage_a_t_max_abs_err']:.3g}), plain {rec['stage_a_plain_ms_1']:.3f} ms a "
               f"stream; stage B plain {rec['stage_b_plain_ms_1']:.3f} ms a stream" if three else
               "") + f" ({st['card']})")
        del frames, flat, zeros, rc, rs, fd
        torch.cuda.empty_cache()
    timed = {case: _k7_timed(ff, *case) for case in K7_TIMED_CASES}
    st["k7_timed"] = timed
    log("k7 at the SIMT comparison's geometries (fft, type, streams, S, taps): "
        + "; ".join(f"{c} {ms:.3f} ms" for c, ms in timed.items()) + f" ({st['card']})")
    spills = {k: v["local_bytes"] for k, v in bodies.items() if v["local_bytes"]}
    if spills:
        raise AssertionError(f"a K7 route body spills: {spills}")


def _plain_fir(samples, window):
    """The composed chain's FIR by the plain version (K6's comparison)."""
    from dpdk_dc_sand_tpu_torch.ops.pfb_fir import pfb_fir_reference

    return pfb_fir_reference(samples.reshape(*samples.shape[:-1], -1, window.shape[1]), window)


def _profile_split(torch, fn, buckets):
    """Device time of one call of ``fn`` by kernel, in ms: ``buckets`` is a
    list of (label, name fragments); a kernel goes to the first label one of
    whose fragments its name holds, and the last label takes the rest."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    split = {label: 0.0 for label, _ in buckets}
    names = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        key = next((label for label, frags in buckets[:-1]
                    if any(f in e.key.lower() for f in frags)), buckets[-1][0])
        split[key] += us / 1e3
        names.append((us / 1e3, e.key[:60]))
    return split, sorted(names, reverse=True)[:6]


def phase_f_flagship(st: dict) -> None:
    import numpy as np
    import torch

    from dpdk_dc_sand_tpu_torch import ArrayConfig
    from dpdk_dc_sand_tpu_torch.models import FBEngine, FEngine, FXBEngine
    from dpdk_dc_sand_tpu_torch.models.fengine import composed_f
    from dpdk_dc_sand_tpu_torch.ops import bstage, corner_turn as ct, fengine_fused as ff
    from dpdk_dc_sand_tpu_torch.ops import pfb_fir, xcorr as xc
    from dpdk_dc_sand_tpu_torch.ops.beamform import beamform_turned

    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    cfg = ArrayConfig(n_ants=80, n_channels=32768, n_taps=16)
    a, p, s, c = cfg.n_ants, cfg.n_pols, 256, cfg.n_channels
    fe = FEngine(cfg, n_spectra=s, quant_scale=QUANT_SCALE, device=dev)
    rng = np.random.default_rng(SEED + 7)
    margin = 8192
    cd = rng.integers(0, margin, a).astype(np.int32)
    fd = rng.uniform(-0.5, 0.5, a).astype(np.float32)
    ph = (-np.pi * fd / 2).astype(np.float32)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    adc = torch.empty((a, p, fe.samples_in + margin), dtype=torch.int8, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = {"k6": pfb_fir.pfb_fir_frames, "k1": ff.fengine_fused, "k7": ff.fengine_dit}
    for fn in counters.values():
        fn.launches = 0
    times = []
    out = None

    def timed_step():
        nonlocal out
        adc.random_(-64, 64, generator=gen)  # fresh flat ADC every step
        out = None
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        out = fe(adc, cd, fd, ph)
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))

    for _ in range(3):
        timed_step()
    fd = (fd * 0.5).astype(np.float32)  # a fine-delay update
    ph = (-np.pi * fd / 2).astype(np.float32)
    for _ in range(2):
        timed_step()
    launches = {k: fn.launches for k, fn in counters.items()}
    log(f"f flagship launches: {launches}")
    if launches["k6"] < 1 or launches["k1"] or launches["k7"]:
        raise AssertionError(f"the F path did not run through K6 alone: {launches}")
    if tuple(out.shape) != (a, p, s, c, 2) or out.dtype != torch.int8:
        raise AssertionError(f"FEngine output {tuple(out.shape)} {out.dtype}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ms = float(np.median(times[1:]))
    samples = a * p * s * cfg.fft_size
    log(f"f flagship [80 ant x 32768 ch x 16 taps, S=256]: step ms "
        f"{['%.3f' % t for t in times]}, median(after first) {ms:.3f} ms, "
        f"{samples / ms / 1e3:.1f} Msamples/s, peak memory {peak_gb:.2f} GB ({st['card']})")
    # The same composed chain with the plain FIR in K6's place, on the same
    # device tensors: bit for bit.
    plain = torch.empty_like(out)
    delays = [torch.as_tensor(v, device=dev) for v in (cd, fd, ph)]
    composed_f(adc, *delays, fe.window, plain[..., 0], plain[..., 1],
               quant_scale=QUANT_SCALE, fir=_plain_fir)
    _exact("f flagship vs the composed chain with the plain FIR", (out,), (plain,))
    del plain
    # The coarse-delay copy runs as a generic copy kernel, indistinguishable
    # by name from the rotation's and the requant's.
    split, top = _profile_split(torch, lambda: fe(adc, cd, fd, ph), [
        ("K6 (FIR)", ("fir_",)), ("rfft (cuFFT)", ("fft",)),
        ("coarse delay, fine delay, requant", ())])
    busy = sum(split.values())
    log("f flagship split (ms, torch.profiler, one step): "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
        + f"; device busy {busy:.3f} vs step {ms:.3f}, idle share "
        f"{max(0.0, 1 - busy / ms):.2%}; top kernels {top} ({st['card']})")
    st["f"] = dict(ms=ms, msamples_s=samples / ms / 1e3, peak_gb=peak_gb, split=split)
    st["f_launches"] = launches
    del out, adc
    torch.cuda.empty_cache()

    # The qualification's CW tone on the card (test_channelisation.py:35-73).
    tcfg = ArrayConfig(n_ants=1, n_channels=128, n_taps=16)
    tone_fe = FEngine(tcfg, n_spectra=8, quant_scale=1.0, quantise_output=False, device=dev)
    k = 37
    n = np.arange(tone_fe.samples_in + 8)
    tone = np.broadcast_to((100.0 * np.cos(2 * np.pi * k * n / tcfg.fft_size)).astype(
        np.float32), (1, tcfg.n_pols, n.size)).copy()
    z = np.zeros(1, np.float32)
    spec = tone_fe(tone, np.zeros(1, np.int32), z, z).double().cpu().numpy()
    power = (spec[..., 0] ** 2 + spec[..., 1] ** 2)[0, 0, 4]
    rel_db = 10 * np.log10(power / power[k] + 1e-300)
    worst = float(np.delete(rel_db, k).max())
    log(f"CW tone at channel {k} of 128, 16 taps, on the card: peak {int(np.argmax(power))}, "
        f"worst leakage {worst:.2f} dB (spec -62 dB)")
    if int(np.argmax(power)) != k or worst > -62.0:
        raise AssertionError("the CW tone fails the channelisation spec on the card")

    # FB and FXB with the composed F stage, held to the plain chain.
    ecfg = ArrayConfig(n_ants=8, n_channels=32768, n_beams=16, n_taps=16)
    ea, es = ecfg.n_ants, 256
    kernels = {"k6": pfb_fir.pfb_fir_frames, "k1": ff.fengine_fused, "k2": bstage.beamform_turned_fused,
               "k4": ct.corner_turn_planes, "k3": xc.correlate_planes_fused}
    for cls in (FBEngine, FXBEngine):
        kw = dict(beam_layout="natural") if cls is FBEngine else {}
        eng = cls(ecfg, n_spectra=es, quant_scale=QUANT_SCALE, precision="bf16", fengine="xla",
                  device=dev, **kw)
        ex_adc, ex_cd, ex_fd, ex_ph, dv = eng.example_inputs(seed=SEED, margin=8192)
        eng.set_beam_delays(dv)
        for fn in kernels.values():
            fn.launches = 0
        got = eng.step(ex_adc, ex_cd, ex_fd, ex_ph)
        torch.cuda.synchronize()
        ran = {k: fn.launches for k, fn in kernels.items()}
        want = ("k6", "k2") if cls is FBEngine else ("k6", "k4", "k3")
        name = f"{cls.__name__}(fengine='xla') [A=8 C=32768 B=16 taps=16 S=256]"
        log(f"{name} launches: {ran}")
        if min(ran[k] for k in want) < 1 or ran["k1"]:
            raise AssertionError(f"{name}: a kernel of its path never launched: {ran}")
        shape = (ea, ecfg.n_pols, es, ecfg.n_channels)
        qr, qi = (torch.empty(shape, dtype=torch.int8, device=dev) for _ in range(2))
        composed_f(torch.as_tensor(ex_adc, device=dev),
                   *(torch.as_tensor(v, device=dev) for v in (ex_cd, ex_fd, ex_ph)),
                   eng.window, qr, qi, quant_scale=QUANT_SCALE, fir=_plain_fir)
        _exact(f"{name} F planes vs the plain composed chain",
               eng._f(ex_adc, ex_cd, ex_fd, ex_ph), (qr, qi))
        w = eng.coeff_blocks
        if cls is FBEngine:
            _beam_diff(f"{name} beams", got,
                       bstage.beamform_turned_fused_reference(qr, qi, w, "bf16"))
        else:
            beams, vre, vim = got
            ref = _stack_beams(torch, beamform_turned(ct.corner_turn_planes_reference(qr, qi),
                                                      w, n_pols=ecfg.n_pols, precision="bf16"))
            _beam_diff(f"{name} beams", beams, ref)
            _exact(f"{name} visibilities vs the gram of the plain F planes", (vre, vim),
                   xc.correlate_planes_fused_reference(qr, qi))
        del eng, got
        torch.cuda.empty_cache()

#: The 8-antenna cut of the flagship array that phases 14 and 15's engine
#: checks use.
SMALL_ANTS = 8
#: Spectra per step of the FXB run outside K2's and K4's gates (P·S = 192).
FXB_PLANAR_S = 96


def _timed_steps(torch, step, adc, gen, times):
    """Fresh wire-rowed ADC, then one step timed with CUDA events."""
    adc.random_(-64, 64, generator=gen)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = step()
    t1.record()
    t1.synchronize()
    times.append(t0.elapsed_time(t1))
    return out


def phase_bforms(st: dict) -> None:
    import numpy as np
    import torch

    from dpdk_dc_sand_tpu_torch import ArrayConfig
    from dpdk_dc_sand_tpu_torch.models import FBEngine, FXBEngine
    from dpdk_dc_sand_tpu_torch.models.fbengine import _b_stage, _coeff_blocks
    from dpdk_dc_sand_tpu_torch.ops import bstage, corner_turn as ct, fengine_fused as ff
    from dpdk_dc_sand_tpu_torch.ops import xcorr as xc
    from dpdk_dc_sand_tpu_torch.ops.fengine_fused import _deint_mode, ingest_alignment

    torch.cuda.empty_cache()  # phase 13's engines and buffers are gone
    dev = torch.device("cuda")
    cfg = ArrayConfig(**FLAG)
    a, p, s, c = cfg.n_ants, cfg.n_pols, FLAG_S, cfg.n_channels
    _, n1, n2 = _deint_mode(c)
    rows, lanes = n2 // 2, n1
    tag = f"[A={a} P={p} S={s} C={c}: {rows}x{lanes} rows x lanes]"

    # K8 against its plain version and against K4's halves, both planes.
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    qr, qi = _planes(torch, a, p, s, c, gen, dev)
    k4 = ct.corner_turn_planes(qr, qi)
    k8_err = 0.0
    for half, q in enumerate((qr, qi)):
        q5 = q.view(a, p, s, rows, lanes)
        got = ct.corner_turn_plane_native(q5)
        k8_err = max(k8_err, _exact(f"k8 plane {half} {tag}", (got,),
                                    (ct.corner_turn_plane_native_reference(q5),)))
        if not torch.equal(got, k4[:, half * a:(half + 1) * a]):
            raise AssertionError(f"k8 plane {half} is not K4's half {half}")
        del got
    log("k8: both planes equal K4's halves [:, :A] and [:, A:] byte for byte")
    del k4
    q5 = qr.view(a, p, s, rows, lanes)
    k8_ms = cuda_ms(lambda: ct.corner_turn_plane_native(q5))
    k8_pms = cuda_ms(lambda: ct.corner_turn_plane_native_reference(q5), iters=1)
    k8_lib = cuda_ms(lambda: qr.permute(3, 0, 1, 2).contiguous())
    k8_bound = bound(2 * a * p * s * c)  # one plane read, one written
    gbytes = 2 * a * p * s * c / 1e9
    log(f"k8 {tag}: kernel {k8_ms:.3f} ms ({gbytes / k8_ms:.2f} TB/s of {gbytes:.2f} GB), plain "
        f"{k8_pms:.3f} ms, permute(3, 0, 1, 2).contiguous() {k8_lib:.3f} ms, bound "
        f"{k8_bound['bound_ms']:.3f} ms ({st['card']})")
    st["k8"] = dict(max_abs_err=k8_err, ms=k8_ms, plain_ms=k8_pms, **k8_bound, library_ms=k8_lib)
    del qr, qi, q5
    torch.cuda.empty_cache()

    # The native-handoff F+B flagship.
    common = dict(n_spectra=s, quant_scale=QUANT_SCALE, precision="bf16", bstage="turned",
                  beam_layout="natural", device=dev)
    fb = FBEngine(cfg, fengine_native_handoff=True, **common)
    rng = np.random.default_rng(SEED + 8)
    margin = 8192
    cd = rng.integers(0, margin, a).astype(np.int32)
    fd = rng.uniform(-0.5, 0.5, a).astype(np.float32)
    ph = (-np.pi * fd / 2).astype(np.float32)
    dv = np.zeros((cfg.n_beams, a, 4), np.float32)
    dv[..., 0] = rng.uniform(0, 5e-9, dv.shape[:-1])
    dv[..., 2] = rng.uniform(-np.pi, np.pi, dv.shape[:-1])
    adc_n2 = ingest_alignment(cfg.fft_size)
    adc = torch.empty((a, p, (fb.samples_in + margin) // adc_n2, adc_n2), dtype=torch.int8,
                      device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = {"k1": ff.fengine_fused, "k8": ct.corner_turn_plane_native,
                "k4": ct.corner_turn_planes, "k2": bstage.beamform_turned_fused}
    for fn in counters.values():
        fn.launches = 0
    times: list = []
    fb.set_beam_delays(dv)
    for _ in range(3):
        out = _timed_steps(torch, lambda: fb.step(adc, cd, fd, ph), adc, gen, times)
    dv[..., 2] += 0.25  # delay update: new steering phases and fine delays
    fd = (fd * 0.5).astype(np.float32)
    fb.set_beam_delays(dv, t_s=1e-3)
    for _ in range(2):
        out = _timed_steps(torch, lambda: fb.step(adc, cd, fd, ph), adc, gen, times)
    launches = {k: fn.launches for k, fn in counters.items()}
    log(f"native flagship launches: {launches}")
    if launches["k1"] != 5 or launches["k8"] != 10 or launches["k4"] or launches["k2"]:
        raise AssertionError(f"the native path is not K1 then K8 twice a step: {launches}")
    if tuple(out.shape) != (c, p * s, 2 * cfg.n_beams) or out.dtype != torch.float32:
        raise AssertionError(f"beams {tuple(out.shape)} {out.dtype}")
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("non-finite beams")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ms = float(np.median(times[1:]))
    samples = a * p * s * cfg.fft_size
    split, top = _profile_split(torch, lambda: fb.step(adc, cd, fd, ph), [
        ("K1 (F)", ("fengine_ct", "k1_")), ("K8 (native turn)", ("corner_turn",)),
        ("bmm (cuBLAS)", ("gemm", "cutlass")), ("casts and copies (plain)", ())])
    busy = sum(split.values())
    log("native flagship split (ms, torch.profiler, one step): "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
        + f"; device busy {busy:.3f} vs step {ms:.3f}, idle share "
        f"{max(0.0, 1 - busy / ms):.2%}; top kernels {top} ({st['card']})")
    log(f"native flagship [{a} ant x {c} ch x {cfg.n_beams} beams x {cfg.n_taps} taps, S={s}]: "
        f"step ms "
        f"{['%.3f' % t for t in times]}, median(after first) {ms:.3f} ms, "
        f"{samples / ms / 1e3:.1f} Msamples/s, peak memory {peak_gb:.2f} GB ({st['card']})")
    # The flat turned path (K4 + the one product) on the same device inputs.
    flat = FBEngine(cfg, **common)
    flat.set_beam_delays(dv, t_s=1e-3)
    _beam_diff("native flagship vs the flat turned path", out, flat.step(adc, cd, fd, ph),
               rtol=1e-4, atol=1e-3)
    st["k8_launches"] = launches["k8"]
    st["native"] = dict(ms=ms, msamples_s=samples / ms / 1e3, peak_gb=peak_gb, split=split)

    # Each B form's stage timed once on the native step's F planes.
    q5r, q5i = fb._f(adc, cd, fd, ph)
    q4r, q4i = q5r.view(a, p, s, c), q5i.view(a, p, s, c)
    blocks = fb.coeff_blocks
    planar_w = _coeff_blocks(torch.as_tensor(dv, device=dev), torch.ones(a, device=dev), 1e-3,
                             cfg=cfg, dtype=torch.bfloat16, folded=False)
    del out, flat
    torch.cuda.empty_cache()
    kw = dict(cfg=cfg, precision="bf16")
    forms = {
        "planar": lambda: _b_stage(q4r, q4i, planar_w, bstage="planar", **kw),
        "folded": lambda: _b_stage(q4r, q4i, blocks, bstage="folded", **kw),
        "turned": lambda: _b_stage(q4r, q4i, blocks, bstage="turned", **kw),
        "turned-split": lambda: _b_stage(q5r, q5i, blocks, bstage="turned", **kw),
        "turned (natural)": lambda: _b_stage(q4r, q4i, blocks, bstage="turned",
                                             beam_layout="natural", **kw),
        "turned-split (natural)": lambda: _b_stage(q5r, q5i, blocks, bstage="turned",
                                                   beam_layout="natural", **kw),
    }
    b_ms = {name: cuda_ms(fn, iters=1) for name, fn in forms.items()}
    log("b stage by form at the flagship (ms, split [P, C, S, B, 2] beams unless natural): "
        + ", ".join(f"{k} {v:.3f}" for k, v in b_ms.items()) + f" ({st['card']})")
    st["native"]["b_stage_ms"] = b_ms
    del fb, q5r, q5i, q4r, q4i, planar_w, blocks, adc
    torch.cuda.empty_cache()

    # Planar and folded against turned at 8 antennas, f32 weights.
    ecfg = ArrayConfig(**{**FLAG, "n_ants": SMALL_ANTS})
    engines = {b: FBEngine(ecfg, n_spectra=s, quant_scale=QUANT_SCALE, precision="f32",
                           bstage=b, device=dev) for b in ("turned", "planar", "folded")}
    inputs = engines["turned"].example_inputs(seed=SEED, margin=8192, rowed=True)
    outs = {}
    for b, eng in engines.items():
        for fn in counters.values():
            fn.launches = 0
        outs[b] = eng(*inputs)
        torch.cuda.synchronize()
        ran = {k: fn.launches for k, fn in counters.items()}
        want = {"k1": 1, "k8": 0, "k4": int(b == "turned"), "k2": 0}
        if ran != want:
            raise AssertionError(f"FBEngine(bstage={b!r}) launched {ran}, want {want}")
    for b in ("planar", "folded"):
        _beam_diff(f"FBEngine(bstage={b!r}) vs 'turned' [A={ecfg.n_ants} C={c} S={s}, f32]",
                   outs[b], outs["turned"], rtol=1e-5, atol=1e-4)
    del engines, outs
    torch.cuda.empty_cache()

    # FXB outside K2's and K4's gates: the planar B stage and the plain grams.
    fxb = FXBEngine(ecfg, n_spectra=FXB_PLANAR_S, quant_scale=QUANT_SCALE, precision="bf16",
                    device=dev)
    if fxb.bstage != "planar":
        raise AssertionError(f"FXB at S={FXB_PLANAR_S} resolved bstage={fxb.bstage!r}")
    adc_e, cd_e, fd_e, ph_e, dv_e = fxb.example_inputs(seed=SEED, margin=8192, rowed=True)
    fxb.set_beam_delays(dv_e)
    x_counters = {**counters, "k3": xc.correlate_planes_fused, "k5b": xc.correlate_turned_fused}
    for fn in x_counters.values():
        fn.launches = 0
    beams, vre, vim = fxb.step(adc_e, cd_e, fd_e, ph_e)
    torch.cuda.synchronize()
    ran = {k: fn.launches for k, fn in x_counters.items()}
    if ran != {"k1": 1, "k8": 0, "k4": 0, "k2": 0, "k3": 0, "k5b": 0}:
        raise AssertionError(f"FXB at S={FXB_PLANAR_S} launched {ran}")
    qr, qi = fxb._f(adc_e, cd_e, fd_e, ph_e)  # the step's own F planes (K1 again)
    name = f"FXBEngine(S={FXB_PLANAR_S}, planar) [A={ecfg.n_ants} C={c}]"
    _exact(f"{name} visibilities vs the gram of its F planes", (vre, vim),
           xc.correlate_planes_fused_reference(qr, qi))
    _beam_diff(f"{name} beams vs the planar B stage of its F planes", beams,
               _b_stage(qr, qi, fxb.coeff_blocks, cfg=ecfg, precision="bf16", bstage="planar"))
    del fxb, beams, vre, vim, qr, qi
    torch.cuda.empty_cache()


def phase_qualification(st: dict) -> None:
    import numpy as np
    import torch

    from dpdk_dc_sand_tpu_torch.ops import fengine_fused as ff
    from dpdk_dc_sand_tpu_torch.ops.pfb import default_window

    dev = torch.device("cuda")
    # The CW tone through K1's unquantised output, bf16 and f32 DFT.
    tone = torch.from_numpy(qualification_tone()).to(dev)
    win = default_window(TONE_TAPS, 2 * TONE_C, device=dev)
    zero = torch.zeros((1, 1), device=dev)
    ff.fengine_fused.launches = 0
    worst = {}
    for dt in ("bfloat16", "float32"):
        fr, fi = ff.fengine_fused(tone, win, zero, zero, n_channels=TONE_C, quant_scale=1.0,
                                  dft_dtype=dt, quantise=False)
        power = (fr.double() ** 2 + fi.double() ** 2)[0, 0].mean(0).cpu().numpy()
        rel_db = 10 * np.log10(power / power[TONE_K] + 1e-300)
        peak, worst[dt] = int(np.argmax(power)), float(np.delete(rel_db, TONE_K).max())
        log(f"qualification tone through K1 (quantise=False, {dt} DFT) on the card: peak "
            f"channel {peak} (want {TONE_K}), worst leakage {worst[dt]:.2f} dB (spec "
            f"{LEAKAGE_SPEC_DB:.0f} dB)")
        if peak != TONE_K or worst[dt] > LEAKAGE_SPEC_DB:
            raise AssertionError(f"the tone through K1 ({dt}) fails the channelisation spec")
    if ff.fengine_fused.launches != 2:
        raise AssertionError(f"the tone did not run through K1: {ff.fengine_fused.launches}")
    if worst["bfloat16"] > worst["float32"] + 6.0:
        raise AssertionError("bf16 DFT operands lift the leakage floor by more than 6 dB")
    # The tone above has N1 = 8 (fft 1024), which both K1 forms run on their
    # two passes' N1 = 8 plans. The same recipe at twice the channels (fft
    # 2048, N1 = 16, the tone in channel 2 * TONE_K) takes the f32 two passes
    # at their 16-row plan: its leakage meets the spec and lies within 1 dB
    # of the plain version's on that tone.
    c2, k2 = 2 * TONE_C, 2 * TONE_K
    tone2 = torch.from_numpy(qualification_tone(c2, k2)).to(dev).view(1, -1)
    win2 = default_window(TONE_TAPS, 2 * c2, device=dev)
    n1t, n2t = ff._split_ct(2 * c2)
    kw2 = dict(n_spectra=TONE_S, n1=n1t, n2=n2t, dft_dtype="float32", quantise=False)
    args2 = (tone2, torch.zeros(1, dtype=torch.int64, device=dev), win2,
             torch.ones((1, c2), device=dev), torch.zeros((1, c2), device=dev))
    before = _k1_counts(ff)
    for body, planes in (("two passes", ff._launch(*args2, **kw2)),
                         ("plain version", ff.fengine_fused_reference(*args2, **kw2))):
        power = (planes[0].double() ** 2 + planes[1].double() ** 2)[0].mean(0).cpu().numpy()
        rel_db = 10 * np.log10(power / power[k2] + 1e-300)
        peak, worst[f"float32_{c2}ch_{body}"] = int(np.argmax(power)), float(
            np.delete(rel_db, k2).max())
        log(f"qualification tone at {c2} channels (fft {2 * c2}, {n1t}x{n2t}) through K1's f32 "
            f"{body}: peak channel {peak} (want {k2}), worst leakage "
            f"{worst[f'float32_{c2}ch_{body}']:.2f} dB (spec {LEAKAGE_SPEC_DB:.0f} dB)")
        if peak != k2 or worst[f"float32_{c2}ch_{body}"] > LEAKAGE_SPEC_DB:
            raise AssertionError(f"the tone through K1's f32 {body} fails the channelisation spec")
    ran = {k: v - before[k] for k, v in _k1_counts(ff).items()}
    if ran != {k: int(k in ("k1_fir_f32", "k1_dft_f32")) for k in ran}:
        raise AssertionError(f"the f32 tone at fft {2 * c2} ran {ran}")
    if abs(worst[f"float32_{c2}ch_two passes"] - worst[f"float32_{c2}ch_plain version"]) > 1.0:
        raise AssertionError("the f32 two passes' leakage is not within 1 dB of the plain "
                             "version's")
    st["qualification"] = worst

    # K1's f32 output against its plain version on 8 of the 160 flagship streams.
    fft, taps, s, lead = 2 * FLAG["n_channels"], FLAG["n_taps"], FLAG_S, (4, 2)
    nb, c = lead[0] * lead[1], fft // 2
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    frames = torch.randint(-64, 64, (*lead, s + taps - 1, fft), dtype=torch.int8, device=dev,
                           generator=gen)
    fd = torch.rand(lead, device=dev, generator=gen) - 0.5
    ph = -3.14159265 * fd / 2
    win = default_window(taps, fft, device=dev)
    _, n1, n2 = ff._deint_mode(c)
    rc, rs = (r.reshape(nb, c) for r in ff.fine_rotation_planes(
        fd, ph, n_channels=c, quant_scale=QUANT_SCALE))
    starts = torch.zeros(nb, dtype=torch.int64, device=dev)
    out = {}
    for dt in ("bfloat16", "float32"):
        kw = dict(n_channels=c, quant_scale=QUANT_SCALE, dft_dtype=dt)

        def kern():
            return ff.fengine_fused(frames, win, fd, ph, quantise=False, **kw)

        def plain():
            return ff.fengine_fused_reference(frames.view(nb, -1), starts, win, rc, rs,
                                              n_spectra=s, n1=n1, n2=n2, dft_dtype=dt,
                                              quantise=False)

        got = [g.view(nb, s, c) for g in kern()]
        ref = plain()
        q8 = ff.fengine_fused(frames, win, fd, ph, **kw)  # the int8 output of the same kernel
        worst_d, share = 0.0, 0.0
        for name, g, r, q in zip(("re", "im"), got, ref, q8):
            d = (g - r).abs()
            over = d > 1e-2 + 1e-4 * r.abs()
            worst_d = max(worst_d, float(d.max()))
            share = max(share, float(over.float().mean()))
            log(f"k1 f32 output {dt} {name} [{nb} streams x S={s} x fft {fft}]: max|d| "
                f"{float(d.max()):.3e}, share over rtol 1e-4 / atol 1e-2 "
                f"{float(over.float().mean()):.3e}, |plain| max {float(r.abs().max()):.1f}")
            if not torch.equal(torch.round(g).clamp(-127, 127).to(torch.int8), q.view(nb, s, c)):
                raise AssertionError(f"k1 {dt}: the int8 output is not the requant of the f32 one")
        ms, pms = cuda_ms(kern), cuda_ms(plain, iters=1)
        log(f"k1 f32 output {dt}: kernel {ms:.3f} ms, plain {pms:.3f} ms; int8 output = requant "
            f"of the f32 output, bit for bit ({st['card']})")
        out[dt] = dict(ms=ms, plain_ms=pms, max_abs_err=worst_d, share_over=share)
        # f32 DFT: rtol 1e-4 / atol 1e-2 everywhere. bf16 DFT: the kernel sums
        # stage A in another order than the plain version, which moves a few
        # values across a bf16 rounding boundary; each such flip moves the 128
        # outputs of its column by up to 2^-8 of the value (PERF.md). So
        # bf16 is held to < 1 code unit everywhere (the requant then moves no
        # code by more than 1, K1's int8 contract) and the f32 bound on all
        # but 1e-2 of the samples.
        if dt == "float32" and share:
            raise AssertionError("k1's f32 output (f32 DFT) disagrees with plain")
        if dt == "bfloat16" and (worst_d >= 1.0 or share > 1e-2):
            raise AssertionError("k1's f32 output (bf16 DFT) disagrees with plain")
    st["k1"].update(f32_out_subset_ms=out["bfloat16"]["ms"],
                    f32_out_subset_plain_ms=out["bfloat16"]["plain_ms"],
                    f32_out_subset_max_abs_err=out["bfloat16"]["max_abs_err"],
                    f32_out_subset_share_over_tol=out["bfloat16"]["share_over"],
                    f32_out_subset_f32dft_ms=out["float32"]["ms"])
    _qual_flagship_scenarios(st)


#: The beam-steering and delay-tracking scenarios' tone (tests/qualification/
#: test_*_qual.py: channel 40 of fft 256, amplitude 80) with its channel scaled
#: with the fft, K = 40 * fft / 256: the tone's period is 32 samples at every
#: fft, and the delay's phase error 2*pi*K*d/fft stays the scenario's own.
SCEN_PERIOD, SCEN_AMP, SCEN_SPECTRUM, SCEN_DELAY = 32, 80.0, 4, 3.25


def _periodic(torch, period, n, dev):
    """``period`` ``[..., SCEN_PERIOD]`` tiled along its last axis to ``n`` samples on
    the card."""
    reps = -(-n // SCEN_PERIOD)
    return torch.from_numpy(period).to(dev).repeat(*(1,) * (period.ndim - 1), reps)[..., :n]


def _qual_flagship_scenarios(st: dict) -> None:
    """Beam steering through FBEngine's default path (K1 + K2, natural packed
    beams) and delay tracking through FEngine (K6, f32 output) at the
    flagship width, with the JAX scenarios' signals and asserts."""
    import numpy as np
    import torch

    from dpdk_dc_sand_tpu_torch import ArrayConfig, delay_solution
    from dpdk_dc_sand_tpu_torch.models import FBEngine, FEngine
    from dpdk_dc_sand_tpu_torch.ops import bstage, fengine_fused as ff, pfb_fir

    card = st["card"]
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    counters = {"k1": ff.fengine_fused, "k2": bstage.beamform_turned_fused,
                "k6": pfb_fir.pfb_fir_frames}
    for fn in counters.values():
        fn.launches = 0

    # Beam steering: 80 antennas see the tone with a uniform phase gradient
    # over one full turn; beam 0 is steered at the source, beam 1 is boresight.
    cfg = ArrayConfig(**FLAG)
    a, p, s, c, fft = cfg.n_ants, cfg.n_pols, FLAG_S, cfg.n_channels, cfg.fft_size
    k = 40 * fft // 256
    gain = 2.0 / fft  # the tone's bin holds about SCEN_AMP * fft / 2: codes near SCEN_AMP
    fb = FBEngine(cfg, n_spectra=s, quant_scale=gain, precision="bf16", beam_layout="natural",
                  device=dev)
    if (fb.fengine, fb.bstage) != ("fused", "fused"):
        raise AssertionError(f"the default path resolved {fb.fengine}, {fb.bstage}")
    phases = np.arange(a) * (2 * np.pi / a)
    t = np.arange(SCEN_PERIOD)
    codes = np.clip(np.round(SCEN_AMP * np.cos(2 * np.pi * k * t / fft + phases[:, None])),
                    -127, 127).astype(np.int8)
    adc = _periodic(torch, codes, fb.samples_in + 64, dev)[:, None].expand(a, p, -1).contiguous()
    zi, zf = np.zeros(a, np.int32), np.zeros(a, np.float32)
    dv = np.zeros((cfg.n_beams, a, 4), np.float32)
    dv[0, :, 2] = -phases
    nb, pack = cfg.n_beams, 128 // (2 * cfg.n_beams)

    def tone_power(out, beam):
        x = out.reshape(c // pack, p, s, pack, 2, nb)[k // pack, 0, SCEN_SPECTRUM, k % pack, :, beam]
        return float((x.double() ** 2).sum())

    fb.set_beam_delays(dv)
    out = fb.step(adc, zi, zf, zf)
    p_on, p_off = tone_power(out, 0), tone_power(out, 1)
    onehot = np.zeros(a, np.float32)
    onehot[0] = 1.0  # one antenna's power from the same engine: K2 need not take A = 1
    fb.set_beam_delays(dv, ant_weights=onehot)
    p_single = tone_power(fb.step(adc, zi, zf, zf), 0)
    qr, qi = fb._f(adc, zi, zf, zf)
    peak = int(max(qr[..., k].abs().max(), qi[..., k].abs().max()))
    array_gain = p_on / p_single
    off_db = 10 * np.log10(max(p_off, 1e-12 * p_on) / p_on)
    log(f"qualification beam steering [{a} ant x {c} ch x {nb} beams x {cfg.n_taps} taps, "
        f"S={s}; K1 + K2, natural packed beams, bf16]: tone in channel {k}, F requant gain {gain:.6e}, the "
        f"tone's int8 codes peak at {peak}; steered/single-antenna power {array_gain:.3f} "
        f"(want >= {0.95 * a * a:.0f} = 0.95 x {a}^2), boresight {off_db:.2f} dB (want <= "
        f"-20) ({card})")
    if peak >= 127 or peak < 16:
        raise AssertionError(f"the tone's codes are saturated or too small: peak {peak}")
    if array_gain < 0.95 * a * a or off_db > -20.0:
        raise AssertionError("the steered flagship beam fails the beam-steering scenario")
    del fb, adc, out, qr, qi
    torch.cuda.empty_cache()

    # Delay tracking: antenna 1 sees the wavefront SCEN_DELAY samples late.
    cfg = ArrayConfig(n_ants=2, n_channels=FLAG["n_channels"], n_taps=FLAG["n_taps"])
    fe = FEngine(cfg, n_spectra=s, quant_scale=1.0, quantise_output=False, device=dev)
    wave = np.stack([SCEN_AMP * np.cos(2 * np.pi * k * (t - d) / fft) for d in (0.0, SCEN_DELAY)])
    adc = _periodic(torch, wave.astype(np.float32), fe.samples_in + 64, dev)
    adc = adc[:, None].expand(2, cfg.n_pols, -1).contiguous()
    rate = cfg.adc_sample_rate
    coarse, frac, _ = delay_solution.delay_solution(
        np.array([0.0, SCEN_DELAY / rate]), np.zeros(2), np.zeros(2), np.zeros(2), t_s=0.0,
        adc_sample_rate=rate)
    ph = (-np.pi * frac / 2).astype(np.float32)

    def tone(out):
        z = out[:, 0, SCEN_SPECTRUM, k].double().cpu().numpy()
        return z[:, 0] + 1j * z[:, 1]

    a0, a1 = tone(fe(adc, coarse, frac, ph))
    phase_err = float(np.angle(a1 / a0))
    coherence = float(abs(a0 + a1) / (abs(a0) + abs(a1)))
    u0, u1 = tone(fe(adc, np.zeros(2, np.int32), np.zeros(2, np.float32),
                     np.zeros(2, np.float32)))
    uncorrected = float(abs(u0 + u1) / (abs(u0) + abs(u1)))
    log(f"qualification delay tracking [2 ant x {cfg.n_channels} ch x {cfg.n_taps} taps, "
        f"S={s}; FEngine, K6, f32 output]: delay {SCEN_DELAY} samples, tone in channel {k} (uncorrected phase error "
        f"{2 * np.pi * k * SCEN_DELAY / fft:.3f} rad), coarse {coarse.tolist()}, frac "
        f"{frac.tolist()}; corrected phase error {phase_err:.3e} rad (want < 0.02), coherence "
        f"{coherence:.6f} (want > 0.999); uncorrected coherence {uncorrected:.4f} (want < 0.5) "
        f"({card})")
    if abs(phase_err) >= 0.02 or coherence <= 0.999 or uncorrected >= 0.5:
        raise AssertionError("the flagship-width delay chain fails the delay-tracking scenario")
    launches = {name: fn.launches for name, fn in counters.items()}
    log(f"qualification scenarios' launches: {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the scenarios never launched: {launches}")
    del fe, adc
    torch.cuda.empty_cache()
    st["qualification"].update(array_gain=array_gain, boresight_db=float(off_db),
                               tone_code_peak=peak,
                               f_gain=gain, phase_error_rad=phase_err, coherence=coherence,
                               uncorrected_coherence=uncorrected)


def phase_e1(st: dict) -> None:
    import torch

    from dpdk_dc_sand_tpu_torch.examples.vector_add import VectorAddTest
    from dpdk_dc_sand_tpu_torch.ops import vector_add as va

    # The path: the example under the PipelineTest harness, counted from 0.
    va.vector_add.launches = 0
    times = VectorAddTest(1 << 22).run_test(iters=3)
    st["e1_launches"] = va.vector_add.launches
    for line in times.report().splitlines():
        log(f"e1 example [n = 1 << 22, {st['card']}] {line}")
    if not times.passed or st["e1_launches"] < 1:
        raise AssertionError(f"the example failed or never launched E1 ({st['e1_launches']})")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    for log2n in (22, 28):
        n = 1 << log2n
        x = torch.randn(n, device=dev, generator=gen)
        y = torch.randn(n, device=dev, generator=gen)
        err = _exact(f"e1 [n = 1 << {log2n}]", (va.vector_add(x, y),),
                     (va.vector_add_reference(x, y),))
    out = torch.empty_like(x)
    ms = cuda_ms(lambda: va.vector_add(x, y), iters=20)
    plain_ms = cuda_ms(lambda: va.vector_add_reference(x, y), iters=20)
    library_ms = cuda_ms(lambda: torch.add(x, y, out=out), iters=20)
    b = bound(12 * n, f32=n)  # read x and y, write the sum; one add each
    log(f"e1 [n = 1 << 28]: kernel {ms:.3f} ms ({12 * n / ms / 1e9:.2f} TB/s), plain "
        f"{plain_ms:.3f} ms, torch.add(out=) {library_ms:.3f} ms, bound {b['bound_ms']:.3f} ms "
        f"({st['card']})")
    st["e1"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms, **b)


#: The node phases. ``node``: the flagship array through ``EngineNode`` with
#: NODE_SLOTS page-locked ring slots: NODE_IN_PLACE chunks committed in place
#: (the slots filled once, as a NIC's DMA would fill them), NODE_PROFILED more
#: under torch.profiler, then NODE_COPIED copied into a slot by the producer.
#: ``node_udp``: benchmarks/NODE_RATE.json's scaled geometry through loopback
#: SPEAD-lite UDP ingest and int8 UDP egress, UDP_CHUNKS chunks a run.
NODE_SLOTS = 3
NODE_IN_PLACE, NODE_PROFILED, NODE_COPIED = 12, 4, 6
UDP_CFG = dict(n_ants=16, n_channels=4096, n_beams=8, n_taps=8)
UDP_S = 64
UDP_CHUNKS = 4
#: Every UDP sender of ``node_udp`` is paced to this rate: a heap (18.6 MB of
#: ADC, 8.4 MB of beams, 33.6 MB of visibilities) is larger than a socket
#: buffer, and an unpaced loopback burst overruns the receiver.
UDP_GBPS = 1.0
#: Where the node phases build their nodes and each wait's deadline (s).
NODE_DEVICE = "cuda"
NODE_TIMEOUT = 120.0


async def _until(cond, what, timeout=NODE_TIMEOUT):
    import asyncio

    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise TimeoutError(f"timed out waiting for {what}")
        await asyncio.sleep(0.005)


async def _node_sensors(client) -> dict:
    vals = {}
    for name in ("chunks-processed", "chunks-lost", "device-status"):
        _, informs = await client.request("sensor-value", name)
        vals[name] = informs[0].args[4]
    return vals


def _check_node(tag, sensors, n_submitted, logs):
    """Fail unless every chunk was processed, none lost, the device is ok
    and no error #log went out."""
    want = {"chunks-processed": str(n_submitted), "chunks-lost": "0", "device-status": "ok"}
    errors = [a for a in logs if a and a[0] in ("error", "fatal")]
    log(f"{tag} sensors: {sensors}; #log errors: {len(errors)}")
    if sensors != want or errors:
        raise AssertionError(f"{tag}: sensors {sensors} (want {want}), errors {errors[:3]}")


def _union_ms(spans) -> float:
    """Length in ms of the union of (start, end) intervals given in us."""
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return (busy + cur_e - cur_s) / 1e3


def _busy_share(torch, prof):
    """(device busy ms, kernel busy ms, window ms): the union of the device's
    kernel, copy and fill intervals, that of its kernels alone, and the span
    from the first to the last of them."""
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    kernels = [(s, e) for s, e, name in spans if not name.startswith(("Memcpy", "Memset"))]
    if not kernels:
        raise AssertionError("the profiler saw no kernel on the device")
    window = (max(e for _, e, _ in spans) - spans[0][0]) / 1e3
    return _union_ms([(s, e) for s, e, _ in spans]), _union_ms(kernels), window


def phase_node(st: dict) -> None:
    import asyncio

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dpdk_dc_sand_tpu_torch import ArrayConfig
    from dpdk_dc_sand_tpu_torch.control import Client
    from dpdk_dc_sand_tpu_torch.engine_node import EngineNode
    from dpdk_dc_sand_tpu_torch.ops import corner_turn as ct, fengine_fused as ff

    cfg = ArrayConfig(**FLAG)
    node = EngineNode(cfg, n_spectra=FLAG_S, beam_quant_scale=0.25, ring_slots=NODE_SLOTS,
                      engine_opts=dict(quant_scale=QUANT_SCALE), device=NODE_DEVICE)
    fb, dev = node.fb, node.device
    samples = cfg.n_ants * cfg.n_pols * FLAG_S * cfg.fft_size  # per chunk
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    adc_dev = torch.empty(node.chunk_shape, dtype=torch.int8, device=dev)
    adc_dev.random_(-64, 64, generator=gen)
    flat = adc_dev.cpu().numpy().reshape(-1).view(np.uint8)  # to the host once
    nbytes = flat.nbytes
    log(f"node [80 ant x 32768 ch x 16 beams x 16 taps, S=256]: F {fb.fengine}, B "
        f"{fb.bstage}, chunk {node.chunk_shape} = {nbytes / 1e9:.3f} GB (margin "
        f"{node.margin}, budget {node.delay_budget}), {NODE_SLOTS} slots, pinned "
        f"{node.ring.pinned}")
    rng = np.random.default_rng(SEED + 6)
    dm = np.zeros((cfg.n_ants, 4))
    dm[:, 0] = rng.integers(0, node.delay_budget + 1, cfg.n_ants)
    dm[:, 1] = rng.uniform(-0.5, 0.5, cfg.n_ants)
    dm[:, 2] = -np.pi * dm[:, 1] / 2
    dv = np.zeros((cfg.n_beams, cfg.n_ants, 4))
    dv[..., 0] = rng.uniform(0, 5e-9, dv.shape[:-1])
    dv[..., 2] = rng.uniform(-np.pi, np.pi, dv.shape[:-1])
    n_a, n_p = NODE_IN_PLACE, NODE_IN_PLACE + NODE_PROFILED
    n_all = n_p + NODE_COPIED
    keep = (1, n_a - 1)  # the chunks whose beams are held against fb.step
    arrivals, kept, fills = {}, {}, [0]

    def on_beams(beams, seq):
        arrivals[seq] = time.perf_counter()
        if seq in keep:
            kept[seq] = beams

    node.on_beams = on_beams

    def wait_slot(cond):
        deadline = time.monotonic() + NODE_TIMEOUT
        while not cond():
            if time.monotonic() > deadline:
                raise TimeoutError("the node's ring stayed full")
            time.sleep(2e-4)

    def commit_in_place(seqs):  # the ring's write side, as a NIC's DMA uses it
        for seq in seqs:
            wait_slot(lambda: len(node.ring) < node.ring.n_slots)
            buf = node.ring.acquire_write()
            if fills[0] < node.ring.n_slots:  # each slot is filled once
                buf[:nbytes] = flat
                fills[0] += 1
            node.ring.commit_write(nbytes, seq)

    def submit_copies(seqs):  # the producer copies each chunk into a slot
        for seq in seqs:
            wait_slot(lambda: len(node.ring) < node.ring.n_slots)
            if not node.submit_chunk(flat, seq):
                raise AssertionError(f"chunk {seq} dropped")

    async def scenario():
        await node.start()
        client = await Client("127.0.0.1", node.port).connect()
        logs = []
        client.on_inform(lambda m: logs.append(m.args) if m.name == "log" else None)
        try:
            await client.request("delay-model", *dm.ravel())
            for b in range(cfg.n_beams):
                await client.request("beam-delays", b, *dv[b].ravel())
            ff.fengine_fused.launches = ct.corner_turn_planes.launches = 0
            await asyncio.to_thread(commit_in_place, range(n_a))
            await _until(lambda: len(arrivals) >= n_a, "the in-place chunks' beams")
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                await asyncio.to_thread(commit_in_place, range(n_a, n_p))
                await _until(lambda: len(arrivals) >= n_p, "the profiled chunks' beams")
            await asyncio.to_thread(submit_copies, range(n_p, n_all))
            await _until(lambda: len(arrivals) >= n_all, "the copied chunks' beams")
            launches = {"k1": ff.fengine_fused.launches, "k4": ct.corner_turn_planes.launches}
            await _until(lambda: int(node.s_processed.value) >= n_all, "the sensors")
            return await _node_sensors(client), logs, launches, prof
        finally:
            await client.close()
            await node.stop()

    sensors, logs, launches, prof = asyncio.run(scenario())
    _check_node("node", sensors, n_all, logs)
    log(f"node launches over {n_all} chunks: {launches}")
    if launches != {"k1": n_all, "k4": n_all}:
        raise AssertionError(f"the node's steps did not run K1 and K4 once each: {launches}")
    feed = node.feed
    if feed.pinned_copies != n_all or feed.stream is None or feed.stream == node.stream:
        raise AssertionError(f"H2D not from pinned slots on the feed's stream: pinned "
                             f"{feed.pinned_copies} of {n_all}, stream {feed.stream}")
    want = fb.step(adc_dev, node._coarse, node._frac, node._phase).cpu().numpy()
    for seq in keep:
        if not np.array_equal(kept[seq], want):
            raise AssertionError(f"the node's beams of chunk {seq} are not fb.step's")
    log(f"node beams of chunks {keep}: equal to fb.step on the same chunk, bit for bit "
        f"({want.dtype} {want.shape})")

    # The decomposition.
    def rate(a, b):  # Msamples/s from the beam arrivals of chunks a..b
        return (b - a) * samples / (arrivals[b] - arrivals[a]) / 1e6

    in_place = rate(4, n_a - 1)  # the slots are full after chunk 3
    copied = rate(n_p + 1, n_all - 1)
    h2d = [nb / ms / 1e6 for nb, ms in feed.h2d_log]
    step_ms = cuda_ms(lambda: fb.step(adc_dev, node._coarse, node._frac, node._phase))
    beams = fb.step(adc_dev, node._coarse, node._frac, node._phase)
    # The node's copy back (a fresh pageable tensor each step), and beside
    # it the same bytes into one page-locked buffer reused (not the node's).
    pinned_out = torch.empty(beams.shape, dtype=beams.dtype, pin_memory=True)
    d2h, d2h_pinned = [], []
    for _ in range(3):
        for out, copy in ((d2h, beams.cpu), (d2h_pinned, lambda: pinned_out.copy_(beams))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            copy()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
    busy, kernel_busy, window = _busy_share(torch, prof)
    st["node"] = dict(
        step_ms=step_ms, compute_msps=samples / step_ms / 1e3, in_place_msps=in_place,
        copied_msps=copied, h2d_gbps=float(np.median(h2d)), d2h_ms=float(np.median(d2h)),
        d2h_pinned_ms=float(np.median(d2h_pinned)), idle=1 - busy / window,
        kernel_idle=1 - kernel_busy / window, chunk_gb=nbytes / 1e9, beams_mb=beams.numel() / 1e6,
    )
    n = st["node"]
    log(f"node decomposition ({st['card']}): compute-only step {step_ms:.3f} ms "
        f"({n['compute_msps']:.1f} Msamples/s); node, slots committed in place "
        f"{in_place:.1f} Msamples/s ({samples / in_place / 1e3:.3f} ms a chunk); node, producer copying each chunk {copied:.1f} "
        f"Msamples/s; H2D on the copy stream median {n['h2d_gbps']:.2f} GB/s "
        f"(min {min(h2d):.2f}, max {max(h2d):.2f}, {len(h2d)} copies of "
        f"{n['chunk_gb']:.3f} GB); D2H of the beams ({n['beams_mb']:.1f} MB int8, "
        f"pageable) median {n['d2h_ms']:.3f} ms (into one reused page-locked buffer "
        f"{n['d2h_pinned_ms']:.3f} ms); device idle share over the "
        f"{NODE_PROFILED} profiled chunks {100 * n['idle']:.2f}% with neither a kernel "
        f"nor a copy ({busy:.1f} of {window:.1f} ms busy), {100 * n['kernel_idle']:.2f}% "
        f"without a kernel ({kernel_busy:.1f} ms of kernels)")


def phase_node_udp(st: dict) -> None:
    import asyncio

    import numpy as np
    import torch

    from dpdk_dc_sand_tpu_torch import ArrayConfig
    from dpdk_dc_sand_tpu_torch.control import Client
    from dpdk_dc_sand_tpu_torch.engine_node import EngineNode
    from dpdk_dc_sand_tpu_torch.ops import corner_turn as ct, fengine_fused as ff, xcorr as xc
    from dpdk_dc_sand_tpu_torch.stream import Chunk, ChunkRing, UdpReceiver, UdpSender

    cfg = ArrayConfig(**UDP_CFG)
    n_in = cfg.n_ants * cfg.n_pols
    rng = np.random.default_rng(SEED + 7)
    dm = np.zeros((cfg.n_ants, 4))
    dm[:, 0] = rng.integers(0, 65, cfg.n_ants)
    dm[:, 1] = rng.uniform(-0.5, 0.5, cfg.n_ants)
    dm[:, 2] = -np.pi * dm[:, 1] / 2
    poly = np.zeros((cfg.n_ants, 4))
    poly[:, 2], poly[:, 3] = 0.5, 0.8e3  # phase 0.5 rad, rate 800 rad/s

    def one_run(emit_visibilities):
        tag = "node_udp " + ("FXB" if emit_visibilities else "FB")
        node = EngineNode(cfg, n_spectra=UDP_S, beam_quant_scale=0.25, ring_slots=4,
                          coeff_update_steps=1, emit_visibilities=emit_visibilities,
                          vis_accum_steps=2, engine_opts=dict(quant_scale=1 / 32),
                          device=NODE_DEVICE)
        chunks = [rng.integers(-64, 64, node.chunk_shape, dtype=np.int8)
                  for _ in range(UDP_CHUNKS)]
        beam_bytes = cfg.n_pols * cfg.n_channels * UDP_S * cfg.n_beams * 2  # int8
        vis_bytes = cfg.n_channels * n_in * n_in * 2 * 4
        rings = [ChunkRing(4, beam_bytes + 64), ChunkRing(4, vis_bytes + 64)]
        rxs, got = [], [{}, {}]

        def drain(i):
            while (item := rings[i].acquire_read()) is not None:
                view, seq = item
                got[i][seq] = UdpReceiver.unpack(view).payload.copy()
                rings[i].release_read()
            return got[i]

        async def scenario():
            tx = client = None
            logs = []
            try:
                rxs.append(UdpReceiver(("127.0.0.1", 0), rings[0]).start())
                node.attach_udp_egress(("127.0.0.1", rxs[0].port), rate_gbps=UDP_GBPS)
                if emit_visibilities:
                    rxs.append(UdpReceiver(("127.0.0.1", 0), rings[1]).start())
                    node.attach_udp_vis_egress(("127.0.0.1", rxs[1].port), rate_gbps=UDP_GBPS)
                adc_rx = node.attach_udp_ingest()
                await node.start()
                tx = UdpSender(("127.0.0.1", adc_rx.port), rate_gbps=UDP_GBPS)
                client = await Client("127.0.0.1", node.port).connect()
                client.on_inform(lambda m: logs.append(m.args) if m.name == "log" else None)
                await client.request("delay-model", *dm.ravel())
                await client.request("beam-delays", 0, *poly.ravel())
                for seq, adc in enumerate(chunks):  # one heap in flight at a time
                    t0 = time.perf_counter()
                    tx.send_chunk(Chunk(adc.reshape(-1).view(np.uint8), seq=seq,
                                        timestamp=seq * node.fb.samples_in))
                    await _until(lambda: seq in drain(0), f"{tag} beam heap {seq}")
                    log(f"{tag} chunk {seq}: {adc.nbytes / 1e6:.1f} MB in, "
                        f"{len(got[0][seq]) / 1e6:.1f} MB of beams back in "
                        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
                if emit_visibilities:
                    await _until(lambda: len(drain(1)) == UDP_CHUNKS // 2, f"{tag} dumps")
                await _until(lambda: int(node.s_processed.value) >= UDP_CHUNKS, "the sensors")
                sensors = await _node_sensors(client)
                _, informs = await client.request("sensor-value", "ingest-rate-gbps")
                log(f"{tag} ingest-rate-gbps {informs[0].args[4]}")
                return sensors, logs
            finally:
                if client is not None:
                    await client.close()
                if tx is not None:
                    tx.close()
                await node.stop()
                for rx in rxs:
                    rx.stop()

        counts = (ff.fengine_fused, ct.corner_turn_planes, xc.correlate_planes_fused)
        for fn in counts:
            fn.launches = 0
        sensors, logs = asyncio.run(scenario())
        launches = [fn.launches for fn in counts]
        _check_node(tag, sensors, UDP_CHUNKS, logs)
        # Heaps that never completed, at the node's ADC receiver and at each
        # consumer; the dumps' heap ids step by the window, so only the
        # ADC and beam streams are held to no heap-id gap as well.
        lost = [rx.assembler.incomplete_dropped for rx in (node._udp_rx, *rxs)]
        lost += [node._udp_rx.assembler.stats.lost, rxs[0].assembler.stats.lost]
        dumps = list(range(0, UDP_CHUNKS, 2)) if emit_visibilities else []
        if sorted(got[0]) != list(range(UDP_CHUNKS)) or sorted(got[1]) != dumps or any(lost):
            raise AssertionError(f"{tag}: beam heaps {sorted(got[0])}, dumps {sorted(got[1])}, "
                                 f"heaps lost {lost}")
        # At S = 64 the reference's X dispatch takes the plain grams (K5a's
        # and K3's gates need S % 128 == 0), so K3 stays at 0 here.
        log(f"{tag} launches K1, K4, K3: {launches}")
        if launches != [UDP_CHUNKS, UDP_CHUNKS, 0]:
            raise AssertionError(f"{tag}: launches {launches}")
        # The last chunk's beams (steering re-extrapolated every chunk, so
        # the engine's cache holds the last chunk's) and the last dump.
        last = torch.from_numpy(chunks[-1]).to(node.device)
        out = node.fb.step(last, node._coarse, node._frac, node._phase)
        beams = out[0] if emit_visibilities else out
        if not np.array_equal(got[0][UDP_CHUNKS - 1].view(np.int8),
                              beams.cpu().numpy().reshape(-1)):
            raise AssertionError(f"{tag}: the last beam heap is not fb.step's beams")
        if emit_visibilities:
            vre = vim = 0
            for adc in chunks[-2:]:
                _, r, i = node.fb.step(torch.from_numpy(adc).to(node.device), node._coarse,
                                       node._frac, node._phase)
                vre, vim = vre + r, vim + i
            vis = np.stack([vre.cpu().numpy(), vim.cpu().numpy()], axis=-1)
            if not np.array_equal(got[1][UDP_CHUNKS - 2].view("<f4"), vis.reshape(-1)):
                raise AssertionError(f"{tag}: the last visibility dump is not the sum of "
                                     "its steps' visibilities")
        log(f"{tag}: {UDP_CHUNKS} ADC heaps of {chunks[0].nbytes / 1e6:.1f} MB in, every "
            f"beam heap{' and visibility dump' if emit_visibilities else ''} out; last "
            "heap equal to fb.step")

    log(f"node_udp [16 ant x 4096 ch x 8 beams x 8 taps, S=64] ({st['card']})")
    one_run(False)
    one_run(True)


#: The probes' geometries: P5 at the flagship's S (its stops split phase 6's
#: K1), P4 and P1 at their scripts' default S, P2 at its default S on 8
#: streams (as phase 12 runs K7).
PROBE_S5, PROBE_S4, PROBE_S2, PROBE_STREAMS2, PROBE_S1 = 256, 128, 64, 8, 128
#: The window's scale in the checks of P5's and P2's stops: their values a
#: few codes at the FIR, tens at stage B (tests/test_torch_probes.py).
PROBE_P5_SCALE = {"dma": 1 / 64, "fir": 1 / 64, "stagea": 1 / 256, "stageb": 1 / 1024,
                  "full": 1 / 256}
PROBE_P2_SCALE = {"dma": 1 / 64, "conv": 1 / 64, "fir": 1 / 64, "deint": 1 / 64,
                  "stagea": 1 / 64, "stageb": 1 / 256, "full": 1 / 64}


def _probe_path(counters, run):
    """Drive one probe's path with its launch counters at 0 (``counters``:
    (wrapper, attribute) pairs); return what it returned and the counts it
    left, failing if any counter stayed at 0."""
    import torch

    for fn, attr in counters:
        setattr(fn, attr, 0)
    out = run()
    torch.cuda.synchronize()
    counts = {f"{fn.__name__}.{attr}": getattr(fn, attr) for fn, attr in counters}
    if not all(counts.values()):
        raise AssertionError(f"a kernel of the probe's path never launched: {counts}")
    return out, counts


def phase_probes(st: dict) -> None:
    """P1-P5 at their own full geometries through the port's probe modules."""
    import torch

    from dpdk_dc_sand_tpu_torch.benchmarks import ct_ablate, ct_kernel_probe as ctp
    from dpdk_dc_sand_tpu_torch.benchmarks import dma_bisect, fir_probe as fp, fused_ablate
    from dpdk_dc_sand_tpu_torch.ops import fengine_fused as ff

    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    card = st["card"]
    probes = {}

    # P5: K1 cut after each stage at the flagship's 160 streams, S = 256, so
    # that its stops split phase 6's K1; held against plain on 8 streams.
    s5, fft, taps = PROBE_S5, ct_ablate.FFT, ct_ablate.TAPS
    # The check runs 8 streams of the probe's data with the window scaled so
    # that each stop's values stay in int8 range (the probe's own standard-
    # normal window puts stage B near 2^12, where one bf16 rounding of T
    # that another f32 order flips moves a code by tens).
    chk = ct_ablate.make_inputs(s5, dev, batch=8)
    win = chk["wina"]
    err = 0.0
    for stop in ct_ablate.STOPS:
        chk["wina"] = win * PROBE_P5_SCALE[stop]
        got, ref = ct_ablate.call(stop, chk), ct_ablate.reference(stop, chk)
        tag = f"p5 {stop} [8 streams x S={s5}, window x {PROBE_P5_SCALE[stop]}]"
        err = max(err, _exact(tag, got, ref) if stop in ("dma", "fir") else
                  _code_diff(tag, got, ref))
    del chk, win, got, ref
    inp = ct_ablate.make_inputs(s5, dev)
    nb, c = inp["fr"].shape[0], fft // 2
    last = slice(nb - 8, nb)  # the last of K1's groups of 32 streams
    for stop in ("dma", "fir"):
        _exact(f"p5 {stop} [streams {nb - 8}..{nb - 1} of {nb} x S={s5}]",
               tuple(g[last] for g in ct_ablate.call(stop, inp)),
               ct_ablate.reference(stop, inp, last))
    ms5, counts5 = _probe_path(
        [(ff.fengine_fused, "ablate_launches"), (ff.k1_fir, "launches"), (ff.k1_dft, "launches")],
        lambda: {stop: ct_ablate.run_variant(stop, s5, 16, inp=inp) for stop in ct_ablate.STOPS})
    plain5 = cuda_ms(lambda: ct_ablate.reference("full", inp, slice(0, 8)), iters=1)
    n1 = n2 = ct_ablate.N1
    k1_bound = bound(nb * (s5 + taps - 1) * fft + taps * fft * 4 + 2 * nb * c * 4 + 2 * nb * s5 * c,
                     bf16=nb * s5 * 2 * (2 * n1 * n1 * n2 + 2 * n2 * n2 * n1),
                     f32=fir_ops(nb * s5 * fft, taps))
    steps = list(ms5.items())
    split = ", ".join(f"{b} +{ms - ma:.3f}" for (_, ma), (b, ms) in zip(steps, steps[1:]))
    log(f"p5 [{nb} streams x S={s5}, fft {fft}] ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in ms5.items()) + f"; steps: {split}; full vs phase 6's K1 "
        f"{st['k1']['ms']:.3f} ms; plain (full, 8 streams) {plain5:.3f} ms; launches {counts5}; "
        f"bound {k1_bound['bound_ms']:.3f} ms ({k1_bound['bound_by']}) ({card})")
    probes["p5"] = dict(ms=ms5["full"], ms_by_stop=ms5, plain_ms=plain5, plain_streams=8,
                        max_abs_err=err, launches=sum(counts5.values()), launches_by=counts5,
                        **k1_bound, library_ms=None)
    del inp
    torch.cuda.empty_cache()

    # P4: K1's DMA stop from three input layouts, S = 128, all 160 streams.
    s4 = PROBE_S4
    err = 0.0
    for name in dma_bisect.VARIANTS:
        call, fr = dma_bisect.make_variant(s4, name, dev)
        got = tuple(g.reshape(nb, s4, c) for g in call())
        err = max(err, _exact(f"p4 {name} [{nb} streams x S={s4}]", got,
                              dma_bisect.reference(fr)))
        del call, fr, got
    ms4, counts4 = _probe_path([(ff.fengine_fused, "ablate_launches")],
                               lambda: {n: dma_bisect.run(s4, n, dev) for n in dma_bisect.VARIANTS})
    _, fr = dma_bisect.make_variant(s4, "v0", dev)
    plain4 = cuda_ms(lambda: dma_bisect.reference(fr), iters=1)
    del fr
    dma_bound = bound(nb * (s4 + taps - 1) * fft + 2 * nb * s4 * c)
    log(f"p4 [{nb} streams x S={s4}] ms: " + ", ".join(f"{k} {v:.3f}" for k, v in ms4.items())
        + f"; plain {plain4:.3f} ms; launches {counts4}; bound {dma_bound['bound_ms']:.3f} ms "
        f"({dma_bound['bound_by']}) ({card})")
    probes["p4"] = dict(ms=ms4["v0"], ms_by_variant=ms4, plain_ms=plain4, max_abs_err=err,
                        launches=sum(counts4.values()), **dma_bound, library_ms=None)
    torch.cuda.empty_cache()

    # P2: K7 cut after each stage on 8 streams, S = 64 (phase 12's K7 runs 8
    # of the 160 streams too).
    s2, nb2 = PROBE_S2, PROBE_STREAMS2
    inp = fused_ablate.make_inputs(s2, dev, batch=nb2)
    win = inp["win"]
    err = 0.0
    for stop in fused_ablate.STOPS:  # checked with a scaled window, as P5
        inp["win"] = win * PROBE_P2_SCALE[stop]
        tag = f"p2 {stop} [{nb2} streams x S={s2}, window x {PROBE_P2_SCALE[stop]}]"
        got, ref = fused_ablate.call(stop, inp), fused_ablate.reference(stop, inp)
        err = max(err, _exact(tag, got, ref) if stop in ("dma", "conv", "fir", "deint") else
                  _code_diff(tag, got, ref))
    inp["win"] = win
    del got, ref
    ms2, counts2 = _probe_path(
        [(ff.fengine_dit_ablate, "launches")],
        lambda: {stop: fused_ablate.run_variant(stop, s2, 16, inp=inp)
                 for stop in fused_ablate.STOPS})
    plain2 = cuda_ms(lambda: fused_ablate.reference("full", inp), iters=1)
    d1, d2 = fused_ablate.N1, fused_ablate.N2
    macs = 4 * d1 * d1 * d2 + 8 * d2 * d2 * d1
    k7_bound = bound(nb2 * (s2 + taps - 1) * fft + taps * fft * 4 + 2 * nb2 * s2 * c,
                     bf16=2 * macs * nb2 * s2, f32=fir_ops(nb2 * s2 * fft, taps))
    steps = list(ms2.items())
    split = ", ".join(f"{b} +{ms - ma:.3f}" for (_, ma), (b, ms) in zip(steps, steps[1:]))
    log(f"p2 [{nb2} streams x S={s2}] ms: " + ", ".join(f"{k} {v:.3f}" for k, v in ms2.items())
        + f"; steps: {split}; plain (full) {plain2:.3f} ms; phase 12's K7 (S=256) "
        f"{st['k7']['ms']:.3f} ms; launches {counts2}; bound {k7_bound['bound_ms']:.3f} ms "
        f"({k7_bound['bound_by']}) ({card})")
    probes["p2"] = dict(ms=ms2["full"], ms_by_stop=ms2, plain_ms=plain2, max_abs_err=err,
                        launches=sum(counts2.values()), launches_by=counts2, **k7_bound,
                        library_ms=None)
    del inp
    torch.cuda.empty_cache()

    # P3: the FIR loop orders on resident data, whole.
    x, w = fp.make_inputs(dev)
    ref = fp.fir_probe_reference(x, w)
    err = max(_exact(f"p3 {kind}", (fp.fir_probe(x, w, kind),), (ref,)) for kind in fp.KINDS)
    ms3, counts3 = _probe_path([(fp.fir_probe, "launches")],
                               lambda: {kind: fp.run(kind, x, w) for kind in fp.KINDS})
    # The kernel is shorter than a Python launch, so the chain times the host:
    # its device time comes from torch.profiler over 20 launches.
    dev3 = {}
    for kind in fp.KINDS:
        split, _ = _profile_split(torch, lambda: [fp.fir_probe(x, w, kind) for _ in range(20)],
                                  [("probe", ["fir_probe_kernel"]), ("other", [])])
        dev3[kind] = split["probe"] / 20
    plain3 = cuda_ms(lambda: fp.fir_probe_reference(x, w), iters=1)
    fma = fp.REPS * fp.J * fp.TAPS * fp.N1 * fp.N2
    p3_bound = bound(x.numel() * 2 + w.numel() * 4 + fp.J * fp.N1 * fp.N2 * 4, f32=2 * fma)
    # Shared-memory bytes a pass loads: persi 16 x (bf16) + 16 w (f32) an
    # output, tapouter 16 w + 128 x per J outputs.
    outs = fp.REPS * fp.J * fp.N1 * fp.N2
    loads = {"persi": outs * (16 * 2 + 16 * 4), "tapouter": outs * (16 * 4 + 128 * 2) / fp.J}
    rates = {k: loads[k] / dev3[k] / 1e9 for k in loads}  # TB/s
    # The yardstick: one cuDNN depthwise conv1d over the REPS passes as a
    # batch (f32, layout untimed); it computes the sums without the chain.
    xt = x.float().reshape(fp.J + fp.TAPS - 1, -1).t().contiguous().unsqueeze(0)
    xt = xt.expand(fp.REPS, -1, -1).contiguous()
    wt = w.reshape(fp.TAPS, -1).t().contiguous().unsqueeze(1)
    lib_out = torch.nn.functional.conv1d(xt[:1], wt, groups=wt.shape[0])[0]
    lib_d = float((lib_out.t().reshape(ref.shape) - fp.fir_probe_reference(x, w, 1)).abs().max())
    lib3 = cuda_ms(lambda: torch.nn.functional.conv1d(xt, wt, groups=wt.shape[0]), iters=3)
    del xt, wt, lib_out
    log(f"p3 [N1 = N2 = {fp.N1}, J = {fp.J}, {fp.REPS} passes] chained ms: " + ", ".join(
        f"{k} {v:.4f}" for k, v in ms3.items()) + "; device ms (torch.profiler): " + ", ".join(
        f"{k} {v:.4f}" for k, v in dev3.items()) + "; shared-memory loads " + ", ".join(
        f"{k} {v:.2f} TB/s" for k, v in rates.items()) + f"; plain {plain3:.3f} ms; conv1d "
        f"(batch of {fp.REPS}) {lib3:.3f} ms (max |d| vs one pass {lib_d:.2e}); launches "
        f"{counts3}; bound {p3_bound['bound_ms']:.4f} ms ({p3_bound['bound_by']}) ({card})")
    probes["p3"] = dict(ms=dev3["tapouter"], ms_by_kind=dev3, chained_ms_by_kind=ms3,
                        plain_ms=plain3, max_abs_err=err,
                        launches=sum(counts3.values()), smem_load_tb_s=rates, **p3_bound,
                        library_ms=lib3)
    del x, w, ref

    # P1: the corner-turn tilings and turns at S = 128, whole.
    s1 = PROBE_S1
    planes = ctp.make_inputs(s1, dev)
    # The script's default specs and the minor-antenna modes; a spec whose
    # spectra chunk exceeds S (i8:64:256 at S = 128: an empty grid in the
    # original) is not run.
    specs = [sp for sp in ctp.SPECS + ("i8m:128:128", "i8m2:128:128")
             if s1 % int(sp.split(":")[2]) == 0]
    skipped = sorted(set(ctp.SPECS) - set(specs))
    if skipped:
        log(f"p1: not run at S={s1} (its spectra chunk does not divide S): {', '.join(skipped)}")
    res1, counts1 = _probe_path([(ctp.ct_probe, "launches")],
                                lambda: {sp: ctp.run_variant(sp, s1, planes=planes) for sp in specs})
    bad = [sp for sp, (_, ok) in res1.items() if not ok]
    if bad:
        raise AssertionError(f"p1: {bad} disagree with plain")
    ms1 = {sp: ms for sp, (ms, _) in res1.items()}
    plain1 = cuda_ms(lambda: ctp.ct_probe_reference(*planes, "i8"), iters=1)
    stacked = torch.stack(planes)
    lib1 = cuda_ms(lambda: stacked.permute(4, 0, 1, 2, 3).contiguous())
    del stacked
    nbytes1 = 2 * sum(q.numel() for q in planes)
    p1_bound = bound(nbytes1)
    log(f"p1 [A={ctp.A} P={ctp.P} S={s1} C={ctp.C}] ms: " + ", ".join(
        f"{k} {v:.3f} ({nbytes1 / v / 1e9:.2f} TB/s)" for k, v in ms1.items())
        + f"; each bit-exact against plain; plain {plain1:.3f} ms; permute().contiguous() "
        f"{lib1:.3f} ms; K4 at S=256 {st['k4']['ms']:.3f} ms; launches {counts1}; bound "
        f"{p1_bound['bound_ms']:.3f} ms ({p1_bound['bound_by']}) ({card})")
    probes["p1"] = dict(ms=ms1["i8:128:128"], ms_by_spec=ms1, plain_ms=plain1, max_abs_err=0.0,
                        launches=sum(counts1.values()), **p1_bound, library_ms=lib1)
    del planes
    torch.cuda.empty_cache()
    st["probes"] = probes


def _event_ms(torch, fn):
    """``(ms, out)`` of one call of ``fn`` by CUDA events."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1), out


def phase_sharded(st: dict) -> None:
    """The sharded engine on a one-rank NCCL group at the flagship width."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from dpdk_dc_sand_tpu_torch import ArrayConfig
    from dpdk_dc_sand_tpu_torch.models import FBEngine
    from dpdk_dc_sand_tpu_torch.ops import bstage, corner_turn as ct, fengine_fused as ff
    from dpdk_dc_sand_tpu_torch.ops import xcorr as xc
    from dpdk_dc_sand_tpu_torch.parallel import ShardedFBEngine, make_mesh

    card = st["card"]
    torch.cuda.empty_cache()
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = ArrayConfig(n_ants=80, n_channels=32768, n_beams=16, n_taps=16)
    a, p, s, c = cfg.n_ants, cfg.n_pols, 256, cfg.n_channels
    rng = np.random.default_rng(SEED + 20)
    fd = rng.uniform(-0.5, 0.5, a).astype(np.float32)
    ph = (-np.pi * fd / 2).astype(np.float32)
    dv = np.zeros((cfg.n_beams, a, 4), np.float32)
    dv[..., 0] = rng.uniform(0, 5e-9, dv.shape[:-1])
    dv[..., 2] = rng.uniform(-np.pi, np.pi, dv.shape[:-1])
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    # One rank holds the whole array: its shard is the global stream.
    adc = torch.empty((a, p, s * cfg.fft_size), dtype=torch.int8, device=dev)
    halo = (cfg.n_taps - 1) * cfg.fft_size
    zeros = torch.zeros(a, dtype=torch.int32, device=dev)
    samples = a * p * s * cfg.fft_size
    common = dict(n_spectra=s, quant_scale=QUANT_SCALE, precision="bf16")
    counters = {"k1": ff.fengine_fused, "k4": ct.corner_turn_planes,
                "k2": bstage.beamform_turned_fused, "k3": xc.correlate_planes_fused}
    launches = dict.fromkeys(counters, 0)

    def driven(run):
        """``run()`` with every count at 0 just before; add what it launched."""
        for fn in counters.values():
            fn.launches = 0
        out = run()
        torch.cuda.synchronize()
        for k, fn in counters.items():
            launches[k] += fn.launches
        return out

    def steps(eng):
        """set_beam_delays, then 5 steps on fresh ADC: (step ms, last beams)."""
        times: list = []
        eng.set_beam_delays(dv)
        for _ in range(5):
            out = _timed_steps(torch, lambda: eng(adc, fd, ph, dv), adc, gen, times)
        return times, out

    def reference(bstage_name):
        """FBEngine with the same backends on the tail-prepended stream of the
        current ADC: (its step ms, its beams)."""
        fb = FBEngine(cfg, fengine="fused", bstage=bstage_name, device=dev, **common)
        fb.set_beam_delays(dv)
        ext = torch.cat([adc[..., -halo:], adc], dim=-1)
        times = [_event_ms(torch, lambda: fb.step(ext, zeros, fd, ph))[0] for _ in range(4)]
        want = fb.step(ext, zeros, fd, ph)
        planes = fb._f(ext, zeros, fd, ph) if bstage_name == "turned" else None
        return float(np.median(times)), want, planes

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    shape = f"[{a} ant x {c} ch x {cfg.n_beams} beams x {cfg.n_taps} taps, S={s}]"
    report = {}
    with tempfile.TemporaryDirectory(prefix="nccl-") as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", rank=0,
                                world_size=1)
        try:
            mesh = make_mesh(shape=(1, 1))
            backend = dist.get_backend()
            log(f"sharded: process group {backend}, mesh {tuple(mesh.mesh_dim_names)} "
                f"{tuple(mesh.shape)}, rank {dist.get_rank()} of {dist.get_world_size()} ({card})")
            if backend != "nccl":
                raise AssertionError(f"backend {backend}, want nccl")
            # (a) "auto": fused F and turned B, so K1, then K4 and the product.
            eng = ShardedFBEngine(cfg, mesh, **common)
            plan = (eng.fengine, eng.bstage, eng.ici_chunks, eng.rowed_ingest)
            log(f"sharded (a) auto resolved fengine={plan[0]} bstage={plan[1]} "
                f"ici_chunks={plan[2]} rowed_ingest={plan[3]}")
            if plan[:3] != ("fused", "turned", 1):
                raise AssertionError(f"auto resolved {plan}")
            times_a, out_a = driven(lambda: steps(eng))
            split, top = _profile_split(torch, lambda: eng(adc, fd, ph, dv), [
                ("NCCL", ("nccl",)), ("K1 (F)", ("k1_",)), ("K4 (turn)", ("corner_turn",)),
                ("bmm (cuBLAS)", ("gemm", "cutlass")), ("copies and the rest", ())])
            fb_ms, want, planes = reference("turned")
            err_a = _beam_diff("sharded (a) vs FBEngine (turned)", out_a, want, rtol=1e-4,
                               atol=1e-3)
            del want
            # (c) ici_chunks=2 on the same ADC: equal to (a) bit for bit.
            chunked = ShardedFBEngine(cfg, mesh, ici_chunks=2, **common)
            chunked.set_beam_delays(dv)
            out_c = driven(lambda: chunked(adc, fd, ph, dv))
            d_c = float((out_c - out_a).abs().max())
            log(f"sharded (c) ici_chunks=2 vs 1: max|d| {d_c:.3e}, equal "
                f"{torch.equal(out_c, out_a)}")
            if not torch.equal(out_c, out_a):
                raise AssertionError("ici_chunks=2 differs from the monolithic step")
            del chunked, out_c
            # (d) emit_visibilities: the gram of the single-device planes.
            vis_eng = ShardedFBEngine(cfg, mesh, emit_visibilities=True, **common)
            beams_d, vre, vim = driven(lambda: vis_eng(adc, fd, ph, dv))
            if not torch.equal(beams_d, out_a):
                raise AssertionError("emit_visibilities changed the beams")
            del beams_d, vis_eng, out_a
            wre, wim = xc.correlate_planes_fused(*planes)
            eq = torch.equal(vre, wre) and torch.equal(vim, wim)
            log(f"sharded (d) visibilities {tuple(vre.shape)} vs correlate_planes_fused of "
                f"FBEngine's planes: max|d| {float((vre - wre).abs().max()):.3e} / "
                f"{float((vim - wim).abs().max()):.3e}, equal {eq}")
            if not eq:
                raise AssertionError("the sharded visibilities differ from K3 on the planes")
            del vre, vim, wre, wim, planes, eng
            torch.cuda.empty_cache()
            # (b) bstage="fused": K1 then K2.
            fused = ShardedFBEngine(cfg, mesh, bstage="fused", **common)
            times_b, out_b = driven(lambda: steps(fused))
            fb_ms_b, want_b, _ = reference("fused")
            err_b = _beam_diff("sharded (b) vs FBEngine (fused)", out_b, want_b, rtol=1e-4,
                               atol=1e-3)
            del fused, out_b, want_b
        finally:
            dist.destroy_process_group()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"sharded launches (the sharded runs only, counts at 0 before each): {launches}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the sharded path never launched: {launches}")
    for tag, times, ref_ms, err in (("(a) turned", times_a, fb_ms, err_a),
                                    ("(b) fused", times_b, fb_ms_b, err_b)):
        ms = float(np.median(times[1:]))
        report[tag] = dict(ms=ms, msamples_s=samples / ms / 1e3, fb_ms=ref_ms,
                           fb_msamples_s=samples / ref_ms / 1e3, max_abs_err=err)
        log(f"sharded {tag} {shape}: step ms {['%.3f' % t for t in times]}, median(2-5) "
            f"{ms:.3f} ms, {samples / ms / 1e3:.1f} Msamples/s; FBEngine same backends "
            f"{ref_ms:.3f} ms, {samples / ref_ms / 1e3:.1f} Msamples/s; max|d| {err:.3e} ({card})")
    busy = sum(split.values())
    log("sharded (a) split (ms, torch.profiler, one step): "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
        + f"; device busy {busy:.3f}; top kernels {top} ({card})")
    log(f"sharded peak memory {peak_gb:.2f} GB ({card})")
    torch.cuda.empty_cache()
    st["sharded"] = dict(report, split=split, peak_gb=peak_gb, backend=backend)
    st["sharded_launches"] = launches


def phase_characterize(st: dict) -> None:
    """The characterisation probes on the card: numbers, not gates."""
    import math

    import torch

    from dpdk_dc_sand_tpu_torch.characterize import (
        TransferRateTest,
        matmul_roofline,
        mem_rate_sweep,
        mxu_dynamic_range,
    )
    from dpdk_dc_sand_tpu_torch.characterize.membw import _numpy_rate

    card = st["card"]
    for dtype in ("bfloat16", "float32"):
        got = mxu_dynamic_range(dtype=dtype)
        plain = mxu_dynamic_range(dtype=dtype, device="cpu")
        log(f"characterize mxu_dynamic_range {dtype}: expected {got['expected']!r} got "
            f"{got['got']!r} rel_err {got['rel_err']:.6e} survives {bool(got['survives'])}; "
            f"plain (f32 product of the rounded inputs) {plain['got']!r} ({card})")
        if got != plain:
            raise AssertionError(f"the tensor-core product differs from plain: {got} {plain}")
    rates = {}
    for dtype, n in (("bfloat16", 8192), ("float32", 4096)):
        r = matmul_roofline(n=n, dtype=dtype)
        rates[f"matmul {dtype} n={n} TFLOP/s"] = r["tflops"]
    for direction in ("h2d", "d2h", "both"):
        test = TransferRateTest(direction=direction)  # 100 frames x 5 MiB, pageable
        test.transfer(10)
        rates[f"{direction} Gbps (100 x 5 MiB)"] = test.transfer(test.n_frames)
        del test
    for threads in (1, 2, 3, 4):  # the numpy scan, then the native one
        for mode, name in ((0, "write"), (1, "read")):
            rates[f"host RAM {name} {threads} threads GB/s, numpy"] = _numpy_rate(
                threads, 128 << 20, 0.3, mode) / 1e9
    for threads, w, r in mem_rate_sweep(thread_range=(1, 2, 3, 4)):
        rates[f"host RAM write {threads} threads GB/s, native membw_scan"] = w
        rates[f"host RAM read {threads} threads GB/s, native membw_scan"] = r
    for k, v in rates.items():
        log(f"characterize {k}: {v:.3f} ({card})")
    bad = {k: v for k, v in rates.items() if not (math.isfinite(v) and v > 0)}
    if bad:
        raise AssertionError(f"non-finite or non-positive rates: {bad}")
    torch.cuda.empty_cache()
    st["characterize"] = rates


#: ``instrument``: the servlet's per-node request deadline (s; a request
#: only sets a node's state, but the nodes' steps share the host with it),
#: the secret the servlet, both nodes and the client share, and each node's
#: page-locked ring slots.
INSTRUMENT_TIMEOUT = 60.0
INSTRUMENT_SECRET = "flagship-instrument"
INSTRUMENT_SLOTS = 2
INSTRUMENT_SENSORS = ("chunks-processed", "chunks-lost", "device-status", "ingest-rate-gbps")


def phase_instrument(st: dict) -> None:
    """A port CorrServlet fronting two port EngineNodes on the card."""
    import asyncio
    import gc

    import numpy as np
    import torch

    from dpdk_dc_sand_tpu_torch import ArrayConfig
    from dpdk_dc_sand_tpu_torch.control import Client, CorrServlet, FailReply, Status
    from dpdk_dc_sand_tpu_torch.engine_node import EngineNode
    from dpdk_dc_sand_tpu_torch.ops import corner_turn as ct, fengine_fused as ff

    card = st["card"]
    gc.collect()  # phase 17's node, ring and buffers are gone before two nodes start
    torch.cuda.empty_cache()
    cfg = ArrayConfig(**FLAG)
    arrivals, beams = [{}, {}], [{}, {}]

    def on_beams(i):
        def take(b, seq):
            arrivals[i][seq] = time.perf_counter()
            beams[i][seq] = b
        return take

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nodes = [EngineNode(cfg, n_spectra=FLAG_S, beam_quant_scale=0.25, ring_slots=INSTRUMENT_SLOTS,
                        auth_secret=INSTRUMENT_SECRET, on_beams=on_beams(i),
                        engine_opts=dict(quant_scale=QUANT_SCALE), device=NODE_DEVICE)
             for i in range(2)]
    dev, budget = nodes[0].device, nodes[0].delay_budget
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    adc_dev = torch.empty(nodes[0].chunk_shape, dtype=torch.int8, device=dev)
    adc_dev.random_(-64, 64, generator=gen)
    flat = adc_dev.cpu().numpy().reshape(-1).view(np.uint8)  # to the host once
    rng = np.random.default_rng(SEED + 22)
    dm = np.zeros((cfg.n_ants, 4))
    dm[:, 0] = rng.integers(0, budget + 1, cfg.n_ants)
    dm[:, 1] = rng.uniform(-0.5, 0.5, cfg.n_ants)
    dm[:, 2] = -np.pi * dm[:, 1] / 2
    weights = rng.uniform(0.25, 1.5, cfg.n_ants)
    bad = dm.copy()
    bad[int(rng.integers(cfg.n_ants)), 0] = budget + 1
    log(f"instrument [2 nodes x ({cfg.n_ants} ant x {cfg.n_channels} ch x {cfg.n_beams} beams "
        f"x {cfg.n_taps} taps, S={FLAG_S})]: F "
        f"{nodes[0].fb.fengine}, B {nodes[0].fb.bstage}, int8 split beams (beam_quant_scale "
        f"0.25), {INSTRUMENT_SLOTS} page-locked slots a node (pinned {nodes[0].ring.pinned}), "
        f"chunk {nodes[0].chunk_shape}, budget {budget}; servlet request_timeout "
        f"{INSTRUMENT_TIMEOUT} s, one auth_secret shared by the servlet, both nodes and the "
        f"client; the servlet, the nodes and the client on one asyncio loop")

    async def chunk(seq):
        """Both nodes take the same chunk at once; each node's ms from its
        commit to its beams at on_beams."""
        async def one(node):
            await _until(lambda: len(node.ring) < node.ring.n_slots, "a free slot")
            if not await asyncio.to_thread(node.submit_chunk, flat, seq):
                raise AssertionError(f"chunk {seq} dropped")
            return time.perf_counter()

        committed = await asyncio.gather(*(one(n) for n in nodes))
        await _until(lambda: all(seq in a for a in arrivals), f"chunk {seq}'s beams")
        return [(arrivals[i][seq] - t0) * 1e3 for i, t0 in enumerate(committed)]

    async def scenario():
        servlet = client = None
        try:
            for node in nodes:
                await node.start()
            servlet = CorrServlet("corr3", cfg.n_ants, request_timeout=INSTRUMENT_TIMEOUT,
                                  auth_secret=INSTRUMENT_SECRET,
                                  engine_endpoints=[("127.0.0.1", n.port) for n in nodes])
            await servlet.start()
            client = await Client("127.0.0.1", servlet.port,
                                  auth_secret=INSTRUMENT_SECRET).connect()
            ff.fengine_fused.launches = ct.corner_turn_planes.launches = 0
            ms = {"a": await chunk(0)}  # (a)
            rtt = []
            for req in (("delay-model", *dm.ravel()), ("beam-weights", *weights)):  # (b)
                t0 = time.perf_counter()
                await client.request(*req)
                rtt.append((time.perf_counter() - t0) * 1e3)
            ms["c"] = await chunk(1)  # (c)
            try:  # (d)
                await client.request("delay-model", *bad.ravel())
                raise AssertionError("the out-of-budget delay model was accepted")
            except FailReply as e:
                failure = str(e)
            status = servlet.sensors["device-status"]
            degraded = (status.value, status.status)
            ms["d"] = await chunk(2)
            launches = {"k1": ff.fengine_fused.launches, "k4": ct.corner_turn_planes.launches}
            # (e): the mirrored node sensors against each node's own.
            pairs = [(servlet.sensors[f"node{i}.{name}"], node.sensors[name])
                     for i, node in enumerate(nodes) for name in INSTRUMENT_SENSORS]
            await _until(lambda: all(int(n.s_processed.value) == 3 for n in nodes)
                         and all(m.format_value() == o.format_value() and m.status == o.status
                                 for m, o in pairs), "the mirrored sensors")
            mirrored = {}
            for i, node in enumerate(nodes):
                for name in INSTRUMENT_SENSORS:
                    _, informs = await client.request("sensor-value", f"node{i}.{name}")
                    own = node.sensors[name]
                    mirrored[f"node{i}.{name}"] = informs[0].args[3:5]
                    if informs[0].args[3:5] != [own.status.value, own.format_value()]:
                        raise AssertionError(f"node{i}.{name}: {informs[0].args} vs "
                                             f"{own.status.value} {own.format_value()}")
            return ms, rtt, failure, degraded, launches, mirrored
        finally:
            if client is not None:
                await client.close()
            if servlet is not None:
                await servlet.stop()
            for node in nodes:
                await node.stop()

    ms, rtt, failure, degraded, launches, mirrored = asyncio.run(scenario())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"instrument launches (a)-(d), 3 chunks on 2 nodes: {launches}")
    if launches != {"k1": 6, "k4": 6}:
        raise AssertionError(f"the nodes' steps did not run K1 and K4 once a chunk: {launches}")
    log(f"instrument (d): {failure!r}; servlet device-status {degraded[0]} / "
        f"{degraded[1].value}")
    if not ("node0" in failure and "node1" in failure) or degraded != ("degraded", Status.WARN):
        raise AssertionError("the out-of-budget fan-out did not fail on both nodes and degrade")
    for i, node in enumerate(nodes):
        if not (np.array_equal(node._coarse, dm[:, 0].astype(np.int32))
                and np.array_equal(node._weights_scale, weights.astype(np.float32))):
            raise AssertionError(f"node {i} does not hold (b)'s state")
        if node.feed.pinned_copies != 3 or node.feed.stream is None:
            raise AssertionError(f"node {i}: H2D not from pinned slots on its own stream")
        want = node.fb.step(adc_dev, node._coarse, node._frac, node._phase).cpu().numpy()
        if not (np.array_equal(beams[i][1], want) and np.array_equal(beams[i][2], want)):
            raise AssertionError(f"node {i}: beams after the update are not fb.step's")
        if np.array_equal(beams[i][0], beams[i][1]):
            raise AssertionError(f"node {i}: the update did not change the beams")
    if nodes[0].feed.stream == nodes[1].feed.stream:
        raise AssertionError("the two nodes' feeds share a copy stream")
    log(f"instrument beams of chunks 1 and 2 on both nodes: equal to fb.step with (b)'s state, "
        f"bit for bit ({beams[0][1].dtype} {beams[0][1].shape}), and unlike chunk 0's; "
        f"mirrored sensors {mirrored}")
    log(f"instrument ({card}): chunk ms, commit to beams, both nodes sharing the card: (a) "
        f"{['%.3f' % t for t in ms['a']]} (first steps), (c) {['%.3f' % t for t in ms['c']]}, "
        f"(d) {['%.3f' % t for t in ms['d']]}; fan-out round trip ?delay-model {rtt[0]:.3f} ms, "
        f"?beam-weights {rtt[1]:.3f} ms; peak device memory {peak_gb:.2f} GB")
    st["instrument"] = dict(chunk_ms=ms, rtt_ms=rtt, peak_gb=peak_gb)
    st["instrument_launches"] = launches
    del nodes, adc_dev
    gc.collect()
    torch.cuda.empty_cache()


#: ``node_native``: the flagship channeliser (32768 ch x 16 taps x 16 beams,
#: bf16) at NATIVE_ANTS antennas x 2 pol, S = NATIVE_S, through ``EngineNode``
#: (fused F, turned B: K1, then K4 and the product; int8 split beams) fed by
#: the native burst-UDP engine straight into its page-locked native ring.
#: NATIVE_CHUNKS heaps a correctness run, one in flight; each rate trial and
#: each transport blast lasts NATIVE_TRIAL_S; the blast's heaps are 4 MiB
#: (benchmarks/UDP_RATE.json's rows); AF_XDP on a veth pair of its own.
NATIVE_CFG = dict(n_ants=4, n_channels=32768, n_beams=16, n_taps=16)
NATIVE_S = 64
NATIVE_SLOTS = 4
NATIVE_CHUNKS = 4
NATIVE_MTU, NATIVE_XDP_MTU = 4096, 3584
NATIVE_MODES, NATIVE_WIRES = ("burst", "gso", "uring"), ("lite", "spead64")
NATIVE_TRIAL_S, NATIVE_TRIALS = 2.0, 5
NATIVE_BLAST_BYTES = 4 << 20
NATIVE_VETH = ("dcsnxdp0", "dcsnxdp1")
NATIVE_XDP_PORT = 5012
#: A correctness run sends each chunk once; its heap must complete within
#: NATIVE_HEAP_S.
NATIVE_HEAP_S = 10.0
#: A rate trial counts as lossless only where the rate it sent at is within
#: NATIVE_PACE_TOL of its target (a sender that cannot keep up is not a
#: lossless trial at the target).
NATIVE_PACE_TOL = 0.03
#: Realtime at 4 antennas x 2 pol: 8 x 1712 Msamples/s (MeerKAT L-band).
NATIVE_REALTIME_MSPS = 8 * 1712.0


def _native_modes() -> dict:
    """Each socket engine mode: None where a receiver and a sender open on
    loopback, else the OSError that refused it."""
    from dpdk_dc_sand_tpu_torch.stream import ChunkRing
    from dpdk_dc_sand_tpu_torch.stream.udp_native import BurstUdpReceiver, BurstUdpSender

    out = {}
    for mode in NATIVE_MODES:
        ring = ChunkRing(2, 1 << 16, native=True)
        rx = tx = None
        try:
            rx = BurstUdpReceiver(("127.0.0.1", 0), ring, mode=mode)
            tx = BurstUdpSender(("127.0.0.1", rx.port), mode=mode)
            out[mode] = None
        except OSError as e:
            out[mode] = f"{type(e).__name__}: {e}"
        finally:
            if tx is not None:
                tx.close()
            if rx is not None:
                rx.stop()
            ring.close()
    return out


def _native_node(st, dm, dv, got):
    """A fresh node at NATIVE_CFG whose beams land in ``got``; its ring must
    be native and a slot view page-locked. Returns (node, delay requests)."""
    import torch

    from dpdk_dc_sand_tpu_torch import ArrayConfig
    from dpdk_dc_sand_tpu_torch.engine_node import EngineNode

    node = EngineNode(ArrayConfig(**NATIVE_CFG), n_spectra=NATIVE_S, beam_quant_scale=0.25,
                      ring_slots=NATIVE_SLOTS, engine_opts=dict(quant_scale=QUANT_SCALE),
                      on_beams=lambda b, seq: got.setdefault(seq, b), device=NODE_DEVICE)
    slot = node.ring.acquire_write()  # a slot view; nothing is committed
    if not (node.ring.native and node.ring.pinned and torch.from_numpy(slot).is_pinned()):
        raise AssertionError(f"the node's ring: native {node.ring.native}, pinned "
                             f"{node.ring.pinned}, slot view page-locked "
                             f"{torch.from_numpy(slot).is_pinned()}")
    reqs = [("delay-model", *dm.ravel())]
    reqs += [("beam-delays", b, *dv[b].ravel()) for b in range(len(dv))]
    return node, reqs


def _native_run(st, tag, node, reqs, attach, send_chunk, mtu, chunks, got):
    """Drive ``node``: attach its ingest (``attach(node)`` -> receiver), send
    the delay requests through ``Client``, then ``send_chunk(chunk)`` each
    chunk once, wait NATIVE_HEAP_S for its heap and then for its beams.
    Holds the run to one heap a chunk, every packet of ``mtu`` payload bytes
    received once, no drop, no eviction, K1 and K4 once a chunk, the
    sensors, and each chunk's beams equal to ``node.fb.step`` on it bit for
    bit. Returns the run's numbers."""
    import asyncio

    import numpy as np
    import torch

    from dpdk_dc_sand_tpu_torch.control import Client
    from dpdk_dc_sand_tpu_torch.ops import corner_turn as ct, fengine_fused as ff
    from dpdk_dc_sand_tpu_torch.stream import Chunk

    counts = (ff.fengine_fused, ct.corner_turn_planes)
    wire_ms, chunk_ms = [], []

    async def scenario():
        client = None
        rx = attach(node)
        try:
            await node.start()
            client = await Client("127.0.0.1", node.port).connect()
            logs = []
            client.on_inform(lambda m: logs.append(m.args) if m.name == "log" else None)
            for req in reqs:
                await client.request(*req)
            for fn in counts:
                fn.launches = 0
            for seq, adc in enumerate(chunks):  # one heap in flight at a time
                chunk = Chunk(adc.reshape(-1).view(np.uint8), seq=seq,
                              timestamp=seq * node.fb.samples_in)
                t0 = time.perf_counter()
                await asyncio.to_thread(send_chunk, chunk)
                wire_ms.append((time.perf_counter() - t0) * 1e3)
                try:
                    await _until(lambda: rx.stats()["heaps"] > seq, f"{tag} heap {seq}",
                                 NATIVE_HEAP_S)
                except TimeoutError as e:
                    raise TimeoutError(f"{e} (sent once; receiver {rx.stats()})") from None
                await _until(lambda: seq in got, f"{tag} chunk {seq}'s beams")
                chunk_ms.append((time.perf_counter() - t0) * 1e3)
            launches = [fn.launches for fn in counts]
            await _until(lambda: int(node.s_processed.value) >= len(chunks), "the sensors")
            return rx.stats(), launches, await _node_sensors(client), logs
        finally:
            if client is not None:
                await client.close()
            await node.stop()

    stats, launches, sensors, logs = asyncio.run(scenario())
    _check_node(tag, sensors, len(chunks), logs)
    n = len(chunks)
    pkts = n * -(-chunks[0].nbytes // mtu)
    if ((stats["heaps"], stats["packets"], stats["ring_drops"], stats["evicted"]) != (n, pkts, 0, 0)
            or launches != [n, n]):
        raise AssertionError(f"{tag}: receiver {stats}, K1 and K4 launches {launches} (want {n} "
                             f"heaps of {pkts} packets, no drop or eviction, {n} launches each)")
    for seq, adc in enumerate(chunks):
        want = node.fb.step(torch.from_numpy(adc).to(node.device), node._coarse, node._frac,
                            node._phase).cpu().numpy()
        if not np.array_equal(got[seq], want):
            raise AssertionError(f"{tag}: chunk {seq}'s beams are not fb.step's")
    h2d = [ms for _, ms in node.feed.h2d_log]
    log(f"{tag}: {n} heaps, receiver {stats}, K1/K4 launches {launches}, beams equal fb.step "
        f"bit for bit; wire ms {['%.1f' % t for t in wire_ms]}, send to beams ms "
        f"{['%.1f' % t for t in chunk_ms]}, H2D ms {['%.2f' % t for t in h2d]} "
        f"(pinned copies {node.feed.pinned_copies}) ({st['card']})")
    if node.feed.pinned_copies != n:
        raise AssertionError(f"{tag}: {node.feed.pinned_copies} of {n} H2D copies pinned")
    return dict(wire_ms=wire_ms, chunk_ms=chunk_ms, h2d_ms=h2d, launches=launches)


def phase_node_native(st: dict) -> None:
    import asyncio
    import shutil
    import threading

    import numpy as np
    import torch

    from dpdk_dc_sand_tpu_torch import ArrayConfig
    from dpdk_dc_sand_tpu_torch.stream import Chunk, ChunkRing
    from dpdk_dc_sand_tpu_torch.stream import udp_xdp
    from dpdk_dc_sand_tpu_torch.stream.udp_native import BurstUdpReceiver, BurstUdpSender

    card = st["card"]
    cfg = ArrayConfig(**NATIVE_CFG)
    rng = np.random.default_rng(SEED + 23)
    dm = np.zeros((cfg.n_ants, 4))
    dm[:, 0] = rng.integers(0, 65, cfg.n_ants)
    dm[:, 1] = rng.uniform(-0.5, 0.5, cfg.n_ants)
    dm[:, 2] = -np.pi * dm[:, 1] / 2
    dv = np.zeros((cfg.n_beams, cfg.n_ants, 4))
    dv[..., 0] = rng.uniform(0, 5e-9, dv.shape[:-1])
    dv[..., 2] = rng.uniform(-np.pi, np.pi, dv.shape[:-1])
    got: dict = {}
    node, reqs = _native_node(st, dm, dv, got)
    shape, samples_in = node.chunk_shape, node.fb.samples_in
    gen = torch.Generator(device=node.device).manual_seed(SEED + 23)
    chunks = [torch.randint(-64, 64, shape, dtype=torch.int8, generator=gen,
                            device=node.device).cpu().numpy() for _ in range(NATIVE_CHUNKS)]
    nbytes = chunks[0].nbytes
    samples = cfg.n_ants * cfg.n_pols * NATIVE_S * cfg.fft_size  # a chunk's
    pkts = -(-nbytes // NATIVE_MTU)
    log(f"node_native [{cfg.n_ants} ant x {cfg.n_channels} ch x {cfg.n_beams} beams x "
        f"{cfg.n_taps} taps, S={NATIVE_S}]: F {node.fb.fengine}, B {node.fb.bstage}, chunk "
        f"{shape} = {nbytes} B ({pkts} packets of {NATIVE_MTU} B), {NATIVE_SLOTS} slots, ring "
        f"native {node.ring.native} and page-locked ({card})")

    # (a) every mode that opens, both wire formats, one heap in flight.
    opened = _native_modes()
    for mode, err in opened.items():
        if err is not None:
            log(f"node_native mode {mode} does not open here: {err}")
    runs, native_launches = {}, [0, 0]
    for mode in [m for m, err in opened.items() if err is None]:
        for wire in NATIVE_WIRES:
            got.clear()
            if node is None:
                node, reqs = _native_node(st, dm, dv, got)
            txs = []

            def attach(n, mode=mode, wire=wire):
                rx = n.attach_ingest(BurstUdpReceiver(("127.0.0.1", 0), n.ring,
                                                      mtu_payload=NATIVE_MTU, mode=mode))
                txs.append(BurstUdpSender(("127.0.0.1", rx.port), mtu_payload=NATIVE_MTU,
                                          mode=mode, wire_format=wire))
                return rx

            try:
                runs[(mode, wire)] = r = _native_run(
                    st, f"node_native (a) {mode}/{wire}", node, reqs, attach,
                    lambda chunk: txs[0].send_chunk(chunk), NATIVE_MTU, chunks, got)
            finally:
                for tx in txs:
                    tx.close()
            native_launches = [a + b for a, b in zip(native_launches, r["launches"])]
            node = None
    if not runs:
        raise AssertionError(f"no socket engine mode opens: {opened}")

    # (b) the lossless rate: gso, lite frames, paced a chunk at a time; the
    # node steps each chunk.
    mode = "gso" if opened.get("gso") is None else next(iter(r[0] for r in runs))
    got.clear()
    node, reqs = _native_node(st, dm, dv, got)
    chunk_bits = nbytes * 8

    def trial(tx, rx, gbps, first_seq):
        """Send chunks paced at ``gbps`` for NATIVE_TRIAL_S; wait for the node;
        (chunks sent, chunks whose beams arrived, receiver stats delta)."""
        st0 = rx.stats()
        period = chunk_bits / (gbps * 1e9)
        sent, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < NATIVE_TRIAL_S:
            seq = first_seq + sent
            tx.send_chunk(Chunk(chunks[seq % NATIVE_CHUNKS].reshape(-1).view(np.uint8),
                                seq=seq, timestamp=seq * samples_in))
            sent += 1
            lag = t0 + sent * period - time.perf_counter()
            if lag > 0:
                time.sleep(lag)
        elapsed = time.perf_counter() - t0
        seqs = range(first_seq, first_seq + sent)
        # Wait until every chunk is stepped, or nothing has moved for a
        # second with the ring empty (the heaps lost will not come).
        deadline, last, since = time.monotonic() + 10, None, time.monotonic()
        while not all(s in got for s in seqs) and time.monotonic() < deadline:
            now = (rx.stats()["heaps"], len(got))
            if now != last:
                last, since = now, time.monotonic()
            elif time.monotonic() - since > 1.0 and len(node.ring) == 0:
                break
            time.sleep(0.01)
        done = sum(s in got for s in seqs)
        delta = {k: v - st0[k] for k, v in rx.stats().items()}
        return sent, done, elapsed, delta

    async def rate_scenario():
        tx = None
        rx = node.attach_ingest(BurstUdpReceiver(("127.0.0.1", 0), node.ring,
                                                 mtu_payload=NATIVE_MTU, mode=mode))
        try:
            await node.start()
            tx = BurstUdpSender(("127.0.0.1", rx.port), mtu_payload=NATIVE_MTU, mode=mode)
            seq = 0
            # The chunk split, one heap in flight: the wire, then the node.
            wire = []
            for _ in range(3):
                t0 = time.perf_counter()
                tx.send_chunk(Chunk(chunks[seq % NATIVE_CHUNKS].reshape(-1).view(np.uint8),
                                    seq=seq))
                wire.append((time.perf_counter() - t0) * 1e3)
                await _until(lambda: seq in got, f"rate warm-up chunk {seq}")
                seq += 1
            adc = torch.from_numpy(chunks[0]).to(node.device)  # the step alone, no H2D
            step_ms = cuda_ms(lambda: node.fb.step(adc, node._coarse, node._frac, node._phase))
            beams = node.fb.step(adc, node._coarse, node._frac, node._phase)
            d2h = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                beams.cpu()
                d2h.append((time.perf_counter() - t0) * 1e3)
            split = dict(wire_ms=float(np.median(wire)), step_ms=step_ms,
                         d2h_ms=float(np.median(d2h)), beams_mb=beams.numel() / 1e6)
            node_ms = split["step_ms"] + split["d2h_ms"]  # the processing thread's share
            gbps = 0.9 * chunk_bits / (node_ms * 1e6)
            lo, hi, best, tried = 0.0, None, None, []
            for _ in range(NATIVE_TRIALS):
                sent, done, elapsed, delta = await asyncio.to_thread(trial, tx, rx, gbps, seq)
                seq += sent
                achieved = sent * chunk_bits / elapsed / 1e9
                kept_pace = achieved >= (1 - NATIVE_PACE_TOL) * gbps
                ok = done == sent and delta["ring_drops"] == 0 and kept_pace
                tried.append(dict(target_gbps=gbps, gbps=achieved, sent=sent, done=done,
                                  elapsed_s=elapsed, heaps=delta["heaps"],
                                  ring_drops=delta["ring_drops"], evicted=delta["evicted"],
                                  kept_pace=kept_pace, lossless=ok))
                log(f"node_native (b) {mode}/lite paced at {gbps:.3f} Gbps for {elapsed:.2f} s: "
                    f"sent at {achieved:.3f} Gbps (kept pace {kept_pace}), {sent} chunks sent, "
                    f"{done} stepped, receiver {delta} ({card})")
                if ok:
                    best, lo = tried[-1], gbps
                    gbps = gbps * 1.3 if hi is None else (lo + hi) / 2
                else:
                    hi = gbps
                    gbps = (lo + gbps) / 2
            # The H2D of every chunk of the run (the trials' too), timed on
            # the feed's copy stream while the node steps and copies back.
            split["h2d_ms"] = float(np.median([ms for _, ms in node.feed.h2d_log]))
            return split, tried, best
        finally:
            if tx is not None:
                tx.close()
            await node.stop()

    split, tried, best = asyncio.run(rate_scenario())
    node = None
    if best is None:  # a finding, not a failure: the rates are not gated
        rate = dict(mode=mode, lossless_gbps=None, trials=tried, split=split)
        log(f"node_native (b) no paced rate was lossless ({mode}, lite), down to "
            f"{min(t['target_gbps'] for t in tried):.3f} Gbps ({card})")
    else:
        period_ms = chunk_bits / (best["gbps"] * 1e6)
        rate = dict(mode=mode, lossless_gbps=best["gbps"], node_msps=samples / period_ms / 1e3,
                    realtime=samples / period_ms / 1e3 / NATIVE_REALTIME_MSPS, trials=tried,
                    split=split)
        log(f"node_native (b) lossless {best['gbps']:.3f} Gbps sent ({mode}, lite; paced at "
            f"{best['target_gbps']:.3f}): node "
            f"{rate['node_msps']:.1f} Msamples/s, {rate['realtime']:.4f} x realtime "
            f"({NATIVE_REALTIME_MSPS:.0f} Msamples/s) ({card})")
    log(f"node_native (b) chunk split: wire {split['wire_ms']:.3f} ms "
        f"(unpaced send), H2D {split['h2d_ms']:.3f} ms (median, page-locked slot, copy stream), step "
        f"{split['step_ms']:.3f} ms, D2H {split['d2h_ms']:.3f} ms ({split['beams_mb']:.1f} MB "
        f"of int8 beams, pageable) ({card})")

    # (c) the transport alone: 4 MiB heaps as fast as each mode sends them.
    blast = {}
    payload = np.random.default_rng(SEED).integers(0, 256, NATIVE_BLAST_BYTES, dtype=np.uint8)
    for mode in [m for m, err in opened.items() if err is None]:
        ring = ChunkRing(8, NATIVE_BLAST_BYTES + 16, native=True)
        rx = BurstUdpReceiver(("127.0.0.1", 0), ring, mtu_payload=NATIVE_MTU, mode=mode)
        tx = BurstUdpSender(("127.0.0.1", rx.port), mtu_payload=NATIVE_MTU, mode=mode)
        stop = threading.Event()

        def consume():
            while not stop.is_set():
                if ring.acquire_read() is None:
                    time.sleep(0.0005)
                    continue
                ring.release_read()

        t = threading.Thread(target=consume)
        t.start()
        try:
            tx.send_chunk(Chunk(payload, seq=1 << 40))  # warm-up, outside the window
            time.sleep(0.25)
            st0, (_, b0) = rx.stats(), tx.stats()
            sent, t0 = 0, time.perf_counter()
            while time.perf_counter() - t0 < NATIVE_TRIAL_S:
                tx.send_chunk(Chunk(payload, seq=sent))
                sent += 1
            elapsed = time.perf_counter() - t0
            time.sleep(0.3)
            delta = {k: v - st0[k] for k, v in rx.stats().items()}
            tx_bytes = tx.stats()[1] - b0
        finally:
            stop.set()
            t.join()
            tx.close()
            rx.stop()
            ring.close()
        blast[mode] = dict(tx_gbps=tx_bytes * 8 / elapsed / 1e9,
                           rx_gbps=delta["bytes"] * 8 / elapsed / 1e9, sent=sent,
                           heaps=delta["heaps"], loss=1 - delta["heaps"] / sent,
                           evicted=delta["evicted"], ring_drops=delta["ring_drops"])
        b = blast[mode]
        log(f"node_native (c) {mode} blast, 4 MiB heaps for {elapsed:.2f} s: tx "
            f"{b['tx_gbps']:.3f} Gbps, rx {b['rx_gbps']:.3f} Gbps, {sent} sent, {b['heaps']} "
            f"delivered, loss {100 * b['loss']:.3f}% ({card})")

    # (d) AF_XDP over a veth pair: the node's heaps steered off the veth into
    # its ring, each sent once.
    pair = udp_xdp.veth_pair(*NATIVE_VETH)
    xdp = None
    if pair is None:
        xdp = ("not run: veth_pair() returned None: " + (
            "no `ip` command (iproute2) on PATH" if shutil.which("ip") is None
            else "`ip link add` / `ip link set` refused"))
    else:
        try:
            got.clear()
            node, reqs = _native_node(st, dm, dv, got)
            senders = []
            try:
                rx = node.attach_ingest(udp_xdp.XdpReceiver(pair[1], NATIVE_XDP_PORT, node.ring,
                                                            mtu_payload=NATIVE_XDP_MTU))
                senders.append(udp_xdp.XdpSender(pair[0], "10.99.1.1", "10.99.1.2",
                                                 NATIVE_XDP_PORT, mtu_payload=NATIVE_XDP_MTU))
            except OSError as e:
                xdp = f"not run: {e}"
                if getattr(node, "_udp_rx", None) is not None:
                    node._udp_rx.stop()
            if xdp is None:
                xdp = _native_run(st, "node_native (d) afxdp/lite", node, reqs, lambda n: rx,
                                  senders[0].send_chunk, NATIVE_XDP_MTU, chunks, got)
                native_launches = [a + b for a, b in zip(native_launches, xdp["launches"])]
        finally:
            for tx in senders:
                tx.close()
            udp_xdp.veth_destroy(pair[0])
    if isinstance(xdp, str):
        log(f"node_native (d) AF_XDP {xdp}")
    st["node_native"] = dict(modes=opened, runs={f"{m}/{w}": r for (m, w), r in runs.items()},
                             rate=rate, blast=blast, xdp=xdp)
    st["native_launches"] = dict(k1=native_launches[0], k4=native_launches[1])
    del node
    torch.cuda.empty_cache()


def _k7_route_kernels(st: dict) -> list:
    """The kernels line's entries of K7's routes off the flagship's split
    (phase 12's full-width cases): the DFT passes' N1 = 8 plans, the
    three-pass stages (stage A K1's kernel on K7's [N1, 2·N2] view). ms:
    the pass over all the case's streams; plain_ms: its plain version on
    ``plain_streams`` of them."""
    routes = st["k7_routes"]
    out = []
    for fft, dt, name, kern, pas, src in (
            (1024, "bfloat16", "dit_dft_n1_8", "dit_dft_kernel<128, true, DFT_FULL, true>: "
             "K7's DFT pass at N1 = 8 (16 spectra a unit), after k1_fir_kernel", "dft",
             "fengine_dit.cu"),
            (1024, "float32", "dit_dft_f32_n1_8", "dit_dft_f32_kernel<8>: K7's f32 DFT pass at "
             "N1 = 8, after k1_fir_kernel<..., float>", "dft", "fengine_dit.cu"),
            (1 << 23, "bfloat16", "dit_stage_a", "k1_stage_a_kernel on K7's [N1, 2·N2] view "
             "(the column-doubled twiddles): K7's three-pass stage A", "stage_a",
             "fengine_ct.cu"),
            (1 << 23, "bfloat16", "dit_stage_b", "dit_stage_b_kernel: K7's three-pass stage B",
             "stage_b", "fengine_dit.cu"),
            (1 << 21, "float32", "dit_stage_a_f32", "k1_stage_a_f32_kernel on K7's [N1, 2·N2] "
             "view: K7's f32 three-pass stage A", "stage_a", "fengine_ct.cu"),
            (1 << 21, "float32", "dit_stage_b_f32", "dit_stage_b_f32_kernel: K7's f32 "
             "three-pass stage B", "stage_b", "fengine_dit.cu")):
        rec = routes[(fft, dt)]
        counter = {"dft": "dit_dft" if dt == "bfloat16" else "dit_dft_f32",
                   "stage_a": name, "stage_b": name}[pas]
        plain = {"dft": rec.get("dft_plain_ms"), "stage_a": rec.get("stage_a_plain_ms_1"),
                 "stage_b": rec.get("stage_b_plain_ms_1")}[pas]
        err = {"dft": rec["max_abs_err"], "stage_a": rec.get("stage_a_t_max_abs_err"),
               "stage_b": rec.get("stage_b_max_abs_err")}[pas]
        entry = dict(name=name, route="cuda", source=f"dpdk_dc_sand_tpu_torch/csrc/{src}",
                     kernel=kern, replaces="dpdk_dc_sand_tpu/ops/fengine_pallas.py:275",
                     path="fengine_dit_routes", launches=rec["launches"][counter],
                     max_abs_err=err, ms=rec["pass_ms"][pas], plain_ms=plain,
                     plain_streams=rec["plain_streams"] if pas == "dft" else 1,
                     bound_ms=rec["pass_bound_ms"][pas], bound_by=rec["pass_bound_by"][pas],
                     library_ms=None,
                     case={k: v for k, v in rec.items() if k not in ("launches", "pass_ms")})
        if dt == "float32" and pas != "dft":
            big = routes[(1 << 23, dt)]
            entry["fft_2_23"] = dict(ms=big["pass_ms"][pas], bound_ms=big["pass_bound_ms"][pas],
                                     launches=big["launches"][counter], k7_ms=big["ms"])
        out.append(entry)
    return out


def main() -> int:
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        log("FAIL device: torch.cuda.is_available() is False")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    st: dict = {}
    fns = {n: globals()[f"phase_{n}"] for n in PHASES}
    for name in PHASES:
        t0 = time.perf_counter()
        try:
            fns[name](st)
        except Exception as e:  # report the phase, then fail the run
            log(f"PHASE {name} FAILED after {time.perf_counter() - t0:.1f} s: "
                f"{type(e).__name__}: {e}")
            raise
        log(f"PHASE {name} ok ({time.perf_counter() - t0:.1f} s)")
    ref = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "dpdk_dc_sand_tpu"))
    if ref:
        raise AssertionError(f"the port pulled in JAX or the reference package: {ref}")
    # launches: each kernel's count from the run of its path (phase 6 for the
    # F+B step and, for K1's f32 passes, the fused_f32 F+B step; phase 3's
    # full-width K1 at fft 2^22 for the three-pass stages; phase 10 for
    # the FXB step, phase 9 for the 64-channel FXB step,
    # phase 12 for the DIT F form, phase 13 for the F-engine step, phase 14
    # for the native-handoff F+B step, phase 16 for the example under
    # PipelineTest, phase 19 for each probe's timed runs); sharded_launches:
    # K1's, K2's, K4's and K3's counts from phase 20's sharded runs;
    # instrument_launches: K1's and K4's from phase 22's two nodes;
    # native_launches: K1's and K4's from phase 23's checked node runs.
    full = st["k1_full"]
    kernels = [
        dict(name="fengine_ct", route="cuda",
             source="dpdk_dc_sand_tpu_torch/csrc/fengine_ct.cu",
             replaces="dpdk_dc_sand_tpu/ops/fengine_pallas.py:504", path="fb_flagship",
             launches=st["launches"]["k1"], sharded_launches=st["sharded_launches"]["k1"],
             instrument_launches=st["instrument_launches"]["k1"],
             native_launches=st["native_launches"]["k1"], fft_1024=full[(1024, "bfloat16")],
             fb_512ch=st["fb512"], **st["k1"]),
        *(dict(name=f"k1_stage_{stage}{sfx}", route="cuda",
               source="dpdk_dc_sand_tpu_torch/csrc/fengine_ct.cu",
               kernel=f"k1_stage_{stage}{sfx}_kernel: K1's three-pass route ({dt}), stage "
                      f"{stage.upper()}",
               replaces="dpdk_dc_sand_tpu/ops/fengine_pallas.py:504",
               path="k1_fft_2_22_full_width",
               launches=full[(K1_THREE_PASS_FFT, dt)]["launches"][f"k1_stage_{stage}{sfx}"],
               k1_fft_2_22_full_width={k: v for k, v in full[(K1_THREE_PASS_FFT, dt)].items()
                                       if k != "passes"},
               k1_fft_2_22_2x2x4=st["k1_2_22_small"][dt],
               **full[(K1_THREE_PASS_FFT, dt)]["passes"][f"stage_{stage}"])
          for dt, sfx in (("bfloat16", ""), ("float32", "_f32")) for stage in "ab"),
        dict(name="k1_fir", route="cuda", source="dpdk_dc_sand_tpu_torch/csrc/fengine_ct.cu",
             kernel="k1_fir_kernel: the FIR pass of K1 and K7 into the bf16 plane (cp.async "
                    "ring, two-word copies where a start is off 4 bytes)",
             replaces="dpdk_dc_sand_tpu/ops/fengine_pallas.py:504",
             also_replaces=["dpdk_dc_sand_tpu/ops/fengine_pallas.py:275"], path="fb_flagship",
             routes={k: v for k, v in st["k1_fir_routes"].items() if k.endswith("bfloat16")},
             bodies=st["k1_fir_bodies"], **st["k1_fir"]),
        dict(name="k1_fir_f32", route="cuda",
             source="dpdk_dc_sand_tpu_torch/csrc/fengine_ct.cu",
             kernel="k1_fir_kernel<..., float>: K1's FIR pass into the f32 plane",
             replaces="dpdk_dc_sand_tpu/ops/fengine_pallas.py:504", path="fb_flagship_fused_f32",
             launches=st["f32_launches"]["k1_fir_f32"],
             routes={k: v for k, v in st["k1_fir_routes"].items() if k.endswith("float32")},
             **st["k1_fir_f32"]),
        dict(name="k1_dft_f32", route="cuda",
             source="dpdk_dc_sand_tpu_torch/csrc/fengine_ct.cu",
             kernel="k1_dft_f32_kernel: K1's DFT pass with f32 operands (FFMA)",
             replaces="dpdk_dc_sand_tpu/ops/fengine_pallas.py:504", path="fb_flagship_fused_f32",
             launches=st["f32_launches"]["k1_dft_f32"], fft_1024=full[(1024, "float32")],
             **st["k1_dft_f32"]),
        dict(name="k1_ablate", route="cuda",
             source="dpdk_dc_sand_tpu_torch/csrc/fengine_ct_stops.cu",
             also_source="dpdk_dc_sand_tpu_torch/csrc/fengine_ct_stops_dft.cu",
             kernel="K1's route cut at each stage stop (fengine_fused(_ablate=...)): "
                    "k1_fir_kernel at STOP_DMA / STOP_FIR_RND, k1_dft[_f32]_kernel at "
                    "STOP_STAGEA_RND / STOP_STAGEB, k1_stage_b[_f32]_kernel at STOP_STAGEB, "
                    "k1_t_slice_kernel; timed on the fused_f32 flagship route (ms: whole)",
             replaces="dpdk_dc_sand_tpu/ops/fengine_pallas.py:504",
             path="fb_flagship_fused_f32_stops", off_flagship=st["k1_stops"],
             **st["k1_f32_stops"]),
        dict(name="bstage_fused", route="cuda",
             source="dpdk_dc_sand_tpu_torch/csrc/bstage_fused.cu",
             also_source="dpdk_dc_sand_tpu_torch/csrc/bstage_fused_stops.cu",
             replaces="dpdk_dc_sand_tpu/ops/bstage_pallas.py:69", path="fb_flagship",
             launches=st["launches"]["k2"], sharded_launches=st["sharded_launches"]["k2"],
             **st["k2"]),
        dict(name="bstage_fused_f32", route="cuda",
             source="dpdk_dc_sand_tpu_torch/csrc/bstage_fused.cu",
             also_source="dpdk_dc_sand_tpu_torch/csrc/bstage_fused_stops.cu",
             kernel="bstage_ring_kernel<..., float>: K2's f32-weight form (each weight three "
                    "exact bf16 terms on the tensor cores)",
             replaces="dpdk_dc_sand_tpu/ops/bstage_pallas.py:69",
             path="fb_flagship_default_precision", launches=st["f32w_launches"]["k2"],
             fb_default=st["fb_default"], **st["k2_f32"]),
        dict(name="corner_turn", route="cuda",
             source="dpdk_dc_sand_tpu_torch/csrc/corner_turn.cu",
             replaces="dpdk_dc_sand_tpu/ops/corner_turn.py:77",
             also_replaces=["dpdk_dc_sand_tpu/ops/corner_turn.py:90",
                            "dpdk_dc_sand_tpu/ops/corner_turn.py:274"],
             path="fxb_flagship", launches=st["fxb_launches"]["k4"],
             sharded_launches=st["sharded_launches"]["k4"],
             instrument_launches=st["instrument_launches"]["k4"],
             native_launches=st["native_launches"]["k4"], **st["k4"]),
        dict(name="xcorr_fused", route="cuda", source="dpdk_dc_sand_tpu_torch/csrc/xcorr.cu",
             replaces="dpdk_dc_sand_tpu/ops/xcorr_pallas.py:135", path="fxb_flagship",
             launches=st["fxb_launches"]["k3"], sharded_launches=st["sharded_launches"]["k3"],
             **st["k3"]),
        dict(name="xcorr_turned", route="cuda", source="dpdk_dc_sand_tpu_torch/csrc/xcorr.cu",
             replaces="dpdk_dc_sand_tpu/ops/xcorr_pallas.py:47", path="fxb_64ch",
             launches=st["fxb64_launches"]["k5b"], **st["k5b"]),
        dict(name="pfb_fir", route="cuda", source="dpdk_dc_sand_tpu_torch/csrc/pfb_fir.cu",
             replaces="dpdk_dc_sand_tpu/ops/pfb_pallas.py:52", path="f_flagship",
             launches=st["f_launches"]["k6"], **st["k6"]),
        dict(name="fengine_dit", route="cuda",
             source="dpdk_dc_sand_tpu_torch/csrc/fengine_dit.cu",
             replaces="dpdk_dc_sand_tpu/ops/fengine_pallas.py:275", path="fengine_dit",
             **st["k7"]),
        dict(name="dit_dft_f32", route="cuda",
             source="dpdk_dc_sand_tpu_torch/csrc/fengine_dit.cu",
             kernel="dit_dft_f32_kernel: K7's DFT pass with f32 operands (FFMA), after "
                    "k1_fir_kernel<..., float>",
             replaces="dpdk_dc_sand_tpu/ops/fengine_pallas.py:275", path="fengine_dit",
             **st["dit_dft_f32"]),
        *_k7_route_kernels(st),
        dict(name="corner_turn_plane_native", route="cuda",
             source="dpdk_dc_sand_tpu_torch/csrc/corner_turn.cu",
             replaces="dpdk_dc_sand_tpu/ops/corner_turn.py:123", path="fb_native_flagship",
             launches=st["k8_launches"], **st["k8"]),
        dict(name="vector_add", route="cuda", source="dpdk_dc_sand_tpu_torch/csrc/vector_add.cu",
             replaces="examples/vector_add_pallas.py:24", path="examples/vector_add",
             launches=st["e1_launches"], **st["e1"]),
        dict(name="ct_ablate", route="cuda",
             source="dpdk_dc_sand_tpu_torch/csrc/fengine_ct_stops.cu",
             kernel="K1's k1_fir_kernel / k1_dft_kernel at each STOP (csrc/fengine_ct.cu)",
             replaces="benchmarks/ct_ablate.py:36", path="benchmarks/ct_ablate",
             **st["probes"]["p5"]),
        dict(name="dma_bisect", route="cuda",
             source="dpdk_dc_sand_tpu_torch/csrc/fengine_ct_stops.cu",
             kernel="P5's kernel at its dma stop (k1_fir_kernel<0, STOP_DMA>: the FIR "
                    "pass's ring copies alone)",
             replaces="benchmarks/dma_bisect.py:72", path="benchmarks/dma_bisect",
             **st["probes"]["p4"]),
        dict(name="fused_ablate", route="cuda",
             source="dpdk_dc_sand_tpu_torch/csrc/fengine_dit.cu",
             also_source="dpdk_dc_sand_tpu_torch/csrc/fengine_ct_stops.cu",
             kernel="K7's route at each STOP: k1_fir_kernel<..., STOP_DIT_*> (dma, conv, fir, "
                    "deint), k1_fir_kernel then dit_dft_kernel<64, true, DFT_STAGEA_T | "
                    "DFT_STAGEB> (stagea, stageb), K7's two passes (full)",
             replaces="benchmarks/fused_ablate.py:33", path="benchmarks/fused_ablate",
             **st["probes"]["p2"]),
        dict(name="fir_probe", route="cuda", source="dpdk_dc_sand_tpu_torch/csrc/fir_probe.cu",
             replaces="benchmarks/fir_probe.py:40", path="benchmarks/fir_probe",
             **st["probes"]["p3"]),
        dict(name="ct_kernel_probe", route="cuda",
             source="dpdk_dc_sand_tpu_torch/csrc/corner_turn.cu",
             kernel="ct_probe_kernel", replaces="benchmarks/ct_kernel_probe.py:42",
             path="benchmarks/ct_kernel_probe", **st["probes"]["p1"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
