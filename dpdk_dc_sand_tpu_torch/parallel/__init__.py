"""Distributed execution over a named device mesh (counterpart of ``dpdk_dc_sand_tpu/parallel``).

The reference scales by channel-sharding engines over hosts via multicast
subscription (xeng_id, coeff_generator.py:49-53), reduces over antennas
with warp shuffles (BeamformerKernels.cu:318-341), and splits time into
blocks (BeamformerParameters.h:44-51). Here, one process a rank on a
``DeviceMesh`` (NCCL on the cards, gloo on the CPU):

- channel sharding  → mesh axis + ``all_to_all_single`` corner turn
- antenna reduction → ``all_reduce`` over the antenna axis's group
- time-block split  → sequence sharding with a ``batch_isend_irecv``
  overlap-save halo exchange for the PFB FIR

:mod:`.launch` starts ranks (:func:`~.launch.run_ranks`) and certifies
the step (:func:`~.launch.dryrun_multichip`).
"""

from dpdk_dc_sand_tpu_torch.parallel.mesh import factor_devices, make_mesh  # noqa: F401
from dpdk_dc_sand_tpu_torch.parallel.fbengine_sharded import ShardedFBEngine  # noqa: F401
from dpdk_dc_sand_tpu_torch.parallel.ingest import (  # noqa: F401
    assemble_global,
    initialize_distributed,
    scatter_local,
    shard_indices,
)
