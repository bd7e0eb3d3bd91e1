"""Hardware characterisation (counterpart of ``dpdk_dc_sand_tpu/characterize``):
measure the busses and units the pipeline must saturate on the card
(utilities/pcie_bandwidth_tests, tensor_core in the reference).

- :mod:`.transfer`: host↔device transfer rate (the PCIe rate test).
- :mod:`.membw`: host RAM bandwidth thread sweep (memRateTest).
- :mod:`.mxu`: tensor-core dynamic-range probe and matmul roofline
  (tc_dynamic_range).
"""

from dpdk_dc_sand_tpu_torch.characterize.membw import mem_rate_sweep  # noqa: F401
from dpdk_dc_sand_tpu_torch.characterize.mxu import (  # noqa: F401
    matmul_roofline,
    mxu_dynamic_range,
)
from dpdk_dc_sand_tpu_torch.characterize.transfer import TransferRateTest  # noqa: F401
