"""Runnable examples of the port (counterparts of the repository's ``examples/``).

- :mod:`.vector_add`: E1, the teaching vector add, under ``PipelineTest``;
- :mod:`.streaming_demo`: UDP → ring → ``DeviceFeed`` with loss accounting;
- :mod:`.full_instrument_demo`: digitiser → UDP → ``EngineNode`` → UDP beams,
  driven over the control plane;
- :mod:`.signal_chain_demo`: a delayed-array tone through the golden
  models (PFB, fine delay, beamform), on the host only.

The first three run on the card by default and on the CPU with ``--cpu``:
``python -m dpdk_dc_sand_tpu_torch.examples.<name> [--cpu]``.
"""
