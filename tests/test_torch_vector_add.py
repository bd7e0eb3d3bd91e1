"""E1 and the harness: the port's vector add, PipelineTest and profiler hooks
vs the JAX package.

The JAX ``vector_add`` (``examples/vector_add_pallas.py``) returns ``x + y``
off the TPU; the port's plain E1 is the same f32 add, so the two are held
bit-exact (tolerance 0: one f32 add is exactly rounded). ``PipelineTest``
runs on the CPU with ``device="cpu"``; its report is the JAX harness's.
The CUDA kernel itself is held against the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import importlib.util
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpdk_dc_sand_tpu.utils.timing import StageTimes as JStageTimes
from dpdk_dc_sand_tpu_torch import _build
from dpdk_dc_sand_tpu_torch.examples import vector_add as example
from dpdk_dc_sand_tpu_torch.ops.vector_add import vector_add, vector_add_reference
from dpdk_dc_sand_tpu_torch.utils import PipelineTest, StageTimes, annotate, trace

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "vector_add_pallas", ROOT / "examples" / "vector_add_pallas.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n", [1, 3, 1024, 4099, 1 << 16])
def test_plain_e1_is_bit_exact_against_jax(n):
    rng = np.random.default_rng(n)
    x = rng.normal(size=n).astype(np.float32)
    y = (rng.normal(size=n) * 1e3).astype(np.float32)
    want = np.asarray(_jax_example().vector_add(jnp.asarray(x), jnp.asarray(y)))
    got = vector_add_reference(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_array_equal(got, want)
    before = vector_add.launches
    np.testing.assert_array_equal(vector_add(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
                                  want)
    assert vector_add.launches == before  # CPU tensors take the plain version


@pytest.mark.parametrize(
    "x, y",
    [(torch.zeros(4), torch.zeros(5)), (torch.zeros(4, dtype=torch.float64),) * 2,
     (torch.zeros(4), torch.zeros(4, dtype=torch.int32))],
    ids=["shape", "f64", "mixed"],
)
def test_vector_add_rejects_what_the_kernel_does_not_take(x, y):
    with pytest.raises(ValueError):
        vector_add(x, y)


def test_e1_is_built_and_bound_like_the_other_kernels():
    assert (_build.CSRC / "vector_add.cu").is_file()
    assert "vector_add.cu" in [p.name for p in _build._sources()]
    assert len(_build._SIGNATURES["vector_add_launch"]) == 5


def test_pipeline_test_runs_e1_on_the_cpu():
    t = example.VectorAddTest(4099, device="cpu")
    times = t.run_test(iters=2)
    assert times.passed is True
    for ms in (times.simulate_ms, times.h2d_ms, times.kernel_ms, times.d2h_ms, times.verify_ms):
        assert ms >= 0
    assert "result         : PASS" in times.report()


def test_stage_times_report_matches_reference():
    vals = dict(simulate_ms=1.5, h2d_ms=2.25, kernel_ms=7.0, d2h_ms=1.0,
                verify_ms=0.5)
    for passed in (True, False, None):
        port, ref = StageTimes(**vals, passed=passed), JStageTimes(**vals, passed=passed)
        assert port.report() == ref.report()
        assert port.limiting_stage == ref.limiting_stage == "kernel"
        assert port.kernel_transfer_ratio == ref.kernel_transfer_ratio


def test_pipeline_test_fails_a_wrong_result():
    class Wrong(example.VectorAddTest):
        def run_kernel(self, device):
            return {"sum": device["x"] - device["y"]}

    assert Wrong(64, device="cpu").run_test().passed is False


def test_pipeline_test_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        assert PipelineTest().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            PipelineTest()


def test_example_main_on_the_cpu(capsys):
    assert example.main(["1000", "--cpu"]) == 0
    assert "result         : PASS" in capsys.readouterr().out


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "t")) as path:
        with annotate("e1-region"):
            vector_add(torch.ones(256), torch.ones(256))
    assert path is not None
    events = json.loads(pathlib.Path(path).read_text())["traceEvents"]
    assert any(e.get("name") == "e1-region" for e in events)
