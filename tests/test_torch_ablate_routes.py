"""K1's stopped calls on each route, with the kernel library stubbed: a stop
runs the passes of the route its whole call takes (``_k1_body``), over that
route's groups of streams (``_route_group``), up to the stop, and counts one
stopped pass a group on ``fengine_fused.ablate_launches``."""

import pytest
import torch

from dpdk_dc_sand_tpu_torch.ops import fengine_fused as ff


class _Lib:
    """The library's K1 entry points: the plan queries answer as the card's
    (the DFT passes' plans to N2 = 1024, the three-pass tiles above), the
    launches record their names and the stop, type and requant flags."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name.endswith("_attributes"):
            two = name in ("k1_dft_attributes", "k1_dft_f32_attributes")
            return lambda n1, n2, out: -1 if two and n2 > 1024 else 0

        def launch(*args):
            self.calls.append((name, args))
            return 0
        return launch


@pytest.fixture
def lib(monkeypatch):
    stub = _Lib()
    monkeypatch.setattr(ff._build, "library", lambda: stub)
    monkeypatch.setattr(ff.torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 0})())
    ff._k1_body.cache_clear()
    yield stub
    ff._k1_body.cache_clear()


FIR = {"bfloat16": "k1_fir_launch", "float32": "k1_fir_f32_launch"}
STAGE_A = {"bfloat16": "k1_stage_a_launch", "float32": "k1_stage_a_f32_launch"}
DFT_STOP = {"bfloat16": "k1_dft_stop_launch", "float32": "k1_dft_f32_stop_launch"}


@pytest.mark.parametrize("quantise", [True, False])
@pytest.mark.parametrize("dft_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("stop", ["dma", "fir", "stagea", "stageb"])
@pytest.mark.parametrize("fft", [16384, 1 << 22])
def test_a_stop_runs_its_routes_passes_group_by_group(lib, monkeypatch, fft, stop, dft_dtype,
                                                       quantise):
    n1, n2 = ff._split_ct(fft)
    s, taps, batch = 2, 2, 5
    body = ff._k1_body(n1, n2, dft_dtype)
    three = body.startswith("three_pass")
    elem = 4 if dft_dtype == "float32" else 2
    # Two streams a group of the route's scratch: three groups of 2, 2, 1.
    monkeypatch.setattr(ff, "K1_SCRATCH_BYTES", 2 * (3 if three else 1) * elem * s * fft)
    assert ff._route_group(body, batch, s, fft) == 2
    x = torch.zeros((batch, (s + taps - 1) * fft), dtype=torch.int8)
    starts = torch.zeros(batch, dtype=torch.int64)
    win = torch.zeros((taps, fft))
    rot = torch.zeros((batch, fft // 2))
    before = ff.fengine_fused.ablate_launches
    outr, _ = ff._launch(x, starts, win, rot, rot, n_spectra=s, n1=n1, n2=n2,
                         dft_dtype=dft_dtype, quantise=quantise, ablate=stop)
    assert outr.dtype == (torch.int8 if quantise else torch.float32)
    assert ff.fengine_fused.ablate_launches == before + 3
    if stop in ("dma", "fir"):
        want = ["k1_fir_stop_launch"]
    elif three:
        want = [FIR[dft_dtype], STAGE_A[dft_dtype],
                "k1_t_slice_launch" if stop == "stagea" else "k1_stage_b_stop_launch"]
    else:
        want = [FIR[dft_dtype], DFT_STOP[dft_dtype]]
    assert [name for name, _ in lib.calls] == want * 3
    for name, args in lib.calls:
        if name == "k1_fir_stop_launch":  # stop, the view's N2, plane f32, quantise
            f32_plane = int(stop == "fir" and dft_dtype == "float32")
            assert args[-5:-1] == (ff.ABLATE_STOPS[stop], n2, f32_plane, int(quantise))
        elif name in DFT_STOP.values():  # stop, quantise
            assert args[-3:-1] == (ff.ABLATE_STOPS[stop], int(quantise))
        elif name in ("k1_t_slice_launch", "k1_stage_b_stop_launch"):  # f32, quantise
            assert args[-3:-1] == (int(dft_dtype == "float32"), int(quantise))


def test_p5_stops_run_on_the_bf16_two_pass_route_only(lib):
    """P5's stops (``p5=True``: its fir's halves, its stagea's T before the
    rounding) take their own numbers; on another route they raise."""
    fft, s, taps = 65536, 2, 2
    x = torch.zeros((1, (s + taps - 1) * fft), dtype=torch.int8)
    z = torch.zeros(1, dtype=torch.int64)
    rot = torch.zeros((1, fft // 2))
    win = torch.zeros((taps, fft))
    for stop in ("fir", "stagea"):
        ff._launch(x, z, win, rot, rot, n_spectra=s, n1=256, n2=256, dft_dtype="bfloat16",
                   quantise=True, ablate=stop, p5=True)
    assert [n for n, _ in lib.calls] == ["k1_fir_stop_launch", "k1_fir_launch",
                                         "k1_dft_stop_launch"]
    assert lib.calls[0][1][-5] == ff.P5_STOPS["fir"] != ff.ABLATE_STOPS["fir"]
    assert lib.calls[2][1][-3] == ff.P5_STOPS["stagea"] != ff.ABLATE_STOPS["stagea"]
    with pytest.raises(ValueError, match="bf16 two-pass route only"):
        ff._launch(x, z, win, rot, rot, n_spectra=s, n1=256, n2=256, dft_dtype="float32",
                   quantise=True, ablate="fir", p5=True)
