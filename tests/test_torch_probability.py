"""Port parity of the closed-form lossless probabilities (paper Eqs. 8-10,
Fig. 2): every function of ``repro_torch.core.probability`` equals the JAX
package's exactly (pure Python on ``math.comb``), and the reference's own
checks hold in the port."""
import math

import numpy as np
import pytest

from repro_torch.core import probability as P
from repro_torch.core import selection

pytest.importorskip("jax")  # the card's test environment has no JAX
from repro.core import probability as JP  # noqa: E402

FUNCS = ["p_lossless_swis", "p_lossless_swis_c", "p_lossless_layerwise"]


@pytest.mark.parametrize("bits", [4, 5, 6, 7, 8])
@pytest.mark.parametrize("name", FUNCS)
def test_probabilities_equal_the_reference(name, bits):
    got = [getattr(P, name)(n, bits) for n in range(9)]
    want = [getattr(JP, name)(n, bits) for n in range(9)]
    assert got == want


@pytest.mark.parametrize("bits", [4, 8])
def test_lossless_table_equals_the_reference(bits):
    assert P.lossless_table(bits) == JP.lossless_table(bits)


def test_no_shift_swis_c_is_only_zero():
    # Eq. 9 assumes N >= 1: with no shifts only the value 0 is exact
    for bits in (4, 8):
        assert P.p_lossless_swis_c(0, bits) == 0.5 ** bits


def test_orderings_and_limits():
    t = P.lossless_table()
    for a, b, c in zip(t["swis"], t["swis_c"], t["layerwise"]):
        assert a >= b - 1e-12 >= c - 2e-12
    assert abs(t["swis"][8] - 1) < 1e-12
    assert abs(t["swis_c"][8] - 1) < 1e-12
    assert abs(t["layerwise"][8] - 1) < 1e-12
    assert abs(t["swis"][0] - 2 ** -8) < 1e-12


def test_fig2_reference_values():
    assert abs(P.p_lossless_swis(4) - sum(
        math.comb(8, n) for n in range(5)) / 256) < 1e-12
    assert abs(P.p_lossless_swis_c(1) - 9 / 256) < 1e-12
    assert abs(P.p_lossless_layerwise(2) - 4 / 256) < 1e-12


def test_monte_carlo_agreement():
    vals = np.random.default_rng(0).integers(0, 256, 100000)
    for variant, closed in (("swis", P.p_lossless_swis),
                            ("swis_c", P.p_lossless_swis_c)):
        for n in (2, 3, 4):
            cand = selection.combo_candidates(n, 8, variant)
            ok = np.zeros(len(vals), bool)
            for c in range(cand.shape[0]):
                ok |= np.isin(vals, cand[c].astype(np.int64))
            assert abs(ok.mean() - closed(n)) < 0.01, (variant, n)
