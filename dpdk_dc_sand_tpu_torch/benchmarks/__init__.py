"""The port's probes: counterparts of the JAX package's ``benchmarks/`` scripts
that reach a TPU kernel, each on its own hand-written Hopper kernel.

- :mod:`.ct_ablate` (P5) and :mod:`.dma_bisect` (P4): K1 cut after each
  stage (``fengine_fused(_ablate=...)``);
- :mod:`.fused_ablate` (P2): K7 cut after each stage;
- :mod:`.fir_probe` (P3): the FIR's loop order on resident data;
- :mod:`.ct_kernel_probe` (P1): corner-turn tilings and turn methods.

Each runs on the card (``python -m dpdk_dc_sand_tpu_torch.benchmarks.ct_ablate
256``) and prints the lines its original prints, timed by the chained
marginal of :mod:`._chain`.
"""
