"""K1's stageb stop at fft 2^22 (N1 = N2 = 2048, the three-pass route on the
card) on the port against the JAX reference's, in each operand type, at S = 4
and 2 taps: ``tests/test_torch_ablate.py``'s inputs and tolerances, in a file
of its own so that ``--dist loadfile`` runs these slow cases (about 10 s of
interpret mode each) beside the others."""

import pytest

from tests.test_torch_ablate import assert_stop_close, run_both


@pytest.mark.parametrize("dft_dtype", ["bfloat16", "float32"])
def test_stageb_at_2_22_matches_the_reference(dft_dtype):
    got, want = run_both(1 << 22, "stageb", dft_dtype, True, seed=22 + len(dft_dtype), s=4,
                         taps=2)
    assert_stop_close("stageb", dft_dtype, True, got, want)
