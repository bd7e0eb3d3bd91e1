"""The port's characterisation probes vs the JAX package's, on the CPU.

The dynamic-range probe is held to the reference's numbers exactly (its
product has one non-zero term, so the f32 output is the exact product of
the rounded inputs). The rates are only checked to be positive and of the
reference's shape here: a rate means something on the card alone
(``chip_smoke.py`` phase 21).
"""

import pytest

from dpdk_dc_sand_tpu.characterize import mem_rate_sweep as j_mem_rate_sweep
from dpdk_dc_sand_tpu.characterize import mxu_dynamic_range as j_mxu_dynamic_range
from dpdk_dc_sand_tpu_torch.characterize import (
    TransferRateTest,
    matmul_roofline,
    mem_rate_sweep,
    mxu_dynamic_range,
)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dynamic_range_is_the_reference_result(dtype):
    got = mxu_dynamic_range(dtype=dtype, device="cpu")
    want = j_mxu_dynamic_range(dtype=dtype)
    for key in ("expected", "got", "rel_err", "survives"):
        assert got[key] == want[key], key
    if dtype == "bfloat16":
        assert got["got"] == 0.9766845703125  # 65024 x bf16(1.5e-5), in f32


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_matmul_roofline_gives_a_rate(dtype):
    r = matmul_roofline(n=128, dtype=dtype, iters=2, device="cpu")
    assert r["n"] == 128 and r["iters"] == 2 and r["tflops"] > 0


@pytest.mark.parametrize("direction", ["h2d", "d2h", "both"])
def test_transfer_rate_in_each_direction(direction):
    t = TransferRateTest(frame_bytes=256 * 1024, n_frames=10, direction=direction, device="cpu")
    assert t.transfer(4) > 0
    assert t.transfer_for_length_of_time(0.05) > 0


def test_mem_rate_sweep_has_the_reference_shape():
    kw = dict(thread_range=(1, 2), bytes_per_thread=8 * 1024 * 1024, seconds=0.03)
    got, want = mem_rate_sweep(**kw), j_mem_rate_sweep(**kw)
    assert [r[0] for r in got] == [r[0] for r in want] == [1, 2]
    assert all(len(r) == 3 and r[1] > 0 and r[2] > 0 for r in got)


def test_the_probes_default_to_the_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        mxu_dynamic_range()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TransferRateTest()


def test_cli_prints_its_rows(capsys):
    from dpdk_dc_sand_tpu_torch.characterize.__main__ import main

    main(["-s", "-d", "-b", "-m", "1", "-M", "2", "-t", "0.03", "--frame-mb", "0.25",
          "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "threads,mem_write_GBps,mem_read_GBps,h2d_Gbps,d2h_Gbps,both_Gbps"
    assert [line.split(",")[0] for line in lines[1:]] == ["1", "2"]
    assert all(float(v) > 0 for line in lines[1:] for v in line.split(",")[1:])
