"""CPU golden models in numpy, the test oracles (counterpart of ``dpdk_dc_sand_tpu/golden``).

Each op of the signal chain paired with a plain numpy reference, as the
reference sandbox pairs each GPU op with a CPU one (SURVEY.md §4):
``beamformer/beamforming/reorder.py``,
``beamformer/unit_test/coeff_generator_cpu.py``,
``beamformer/unit_test/complex_mult_cpu.py``. Everything here is plain
numpy, deliberately simple and loop-light, and imports no torch: the
oracles stay independent of the code they check. The package's one home
of ``pfb_window`` (re-exported by :mod:`..ops.pfb`) and of the host
``requantise`` (used by :mod:`..stream.feed`).
"""

from dpdk_dc_sand_tpu_torch.golden.reorder import reorder, reorder_inverse  # noqa: F401
from dpdk_dc_sand_tpu_torch.golden.coeffs import (  # noqa: F401
    steering_coeffs_complex,
    steering_coeffs_matrix,
    complex_to_matrix,
)
from dpdk_dc_sand_tpu_torch.golden.beamform import beamform, beamform_complex  # noqa: F401
from dpdk_dc_sand_tpu_torch.golden.pfb import (  # noqa: F401
    pfb_window,
    pfb_fir,
    pfb_channelise,
)
from dpdk_dc_sand_tpu_torch.golden.delay import (  # noqa: F401
    coarse_delay,
    fine_delay_phase,
    apply_fine_delay,
)
from dpdk_dc_sand_tpu_torch.golden.requant import requantise  # noqa: F401
from dpdk_dc_sand_tpu_torch.golden.correlate import correlate, correlate_planar  # noqa: F401
