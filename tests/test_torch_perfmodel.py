"""Port parity of the analytical performance model (the paper's 28 nm
bit-serial systolic accelerator): networks, the layer and network
simulator, the Table-4 rows, the headline ratios and the Fig. 1 DRAM ratios
equal the JAX package's exactly (pure Python floats, evaluated in the same
order); the reference's seven checks hold in the port. Every figure is a
model prediction for the paper's design, not a measurement of any chip."""
import dataclasses

import pytest

from repro_torch.perfmodel import (NETWORKS, PE_LIBRARY, LayerShape,
                                   SystolicArray, simulate_layer,
                                   simulate_network)
from repro_torch.perfmodel.evaluate import (TABLE4_POINTS, evaluate_table4,
                                            fig1_dram_ratio, headline_ratios)

pytest.importorskip("jax")  # the card's test environment has no JAX
from repro.perfmodel import NETWORKS as J_NETWORKS  # noqa: E402
from repro.perfmodel import PE_LIBRARY as J_PE_LIBRARY  # noqa: E402
from repro.perfmodel import systolic as jsystolic  # noqa: E402
from repro.perfmodel import evaluate as jevaluate  # noqa: E402

METHODS = ["fixed8", "act_trunc", "wgt_trunc", "bitfusion", "swis",
           "swis_c", "swis_c_ss"]


def test_networks_equal_the_reference():
    assert list(NETWORKS) == list(J_NETWORKS)
    for net in NETWORKS:
        assert ([dataclasses.astuple(c) for c in NETWORKS[net]]
                == [dataclasses.astuple(c) for c in J_NETWORKS[net]])
        assert ([(c.macs, c.weight_count, c.act_in_count, c.act_out_count)
                 for c in NETWORKS[net]]
                == [(c.macs, c.weight_count, c.act_in_count, c.act_out_count)
                    for c in J_NETWORKS[net]])


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("pe", ["fixed8", "swis_ss", "swis_ds",
                                "bitfusion_4x8"])
def test_simulate_layer_equals_the_reference(pe, method):
    for net in NETWORKS:
        for n_shifts in (2, 2.5, 3, 4, 8):
            arr = SystolicArray(PE_LIBRARY[pe])
            jarr = jsystolic.SystolicArray(J_PE_LIBRARY[pe])
            for layer, jlayer in zip(NETWORKS[net], J_NETWORKS[net]):
                got = simulate_layer(arr, LayerShape.from_conv(layer),
                                     n_shifts=n_shifts, method=method)
                want = jsystolic.simulate_layer(
                    jarr, jsystolic.LayerShape.from_conv(jlayer),
                    n_shifts=n_shifts, method=method)
                assert got == want, (net, layer.name, n_shifts)


def test_table4_rows_equal_the_reference():
    assert TABLE4_POINTS == jevaluate.TABLE4_POINTS
    for rows, cols in ((8, 8), (16, 16)):
        assert evaluate_table4(rows, cols) == jevaluate.evaluate_table4(
            rows, cols)


def test_headline_and_fig1_equal_the_reference():
    assert headline_ratios() == jevaluate.headline_ratios()
    assert headline_ratios(16, 16) == jevaluate.headline_ratios(16, 16)
    assert fig1_dram_ratio() == jevaluate.fig1_dram_ratio()


# -- the reference's checks (tests/test_perfmodel.py), in the port alone ----

def _net(cfg_name, n_shifts, method, net="resnet18"):
    arr = SystolicArray(PE_LIBRARY[cfg_name])
    return simulate_network(arr, NETWORKS[net], n_shifts=n_shifts,
                            method=method)


def test_fewer_shifts_faster():
    prev = None
    for n in (6, 4, 3, 2):
        r = _net("swis_ss", n, "swis")
        if prev is not None:
            assert r["frames_per_s"] > prev["frames_per_s"]
            assert r["frames_per_j"] > prev["frames_per_j"]
        prev = r


def test_double_shift_faster_than_single():
    ss = _net("swis_ss", 4, "swis")
    ds = _net("swis_ds", 4, "swis")
    assert ds["frames_per_s"] > ss["frames_per_s"] * 1.5


def test_swis_c_better_compression_dram():
    s = _net("swis_ss", 3, "swis")
    c = _net("swis_c_ss", 3, "swis_c")
    assert c["wgt_dram_bytes"] < s["wgt_dram_bytes"]


def test_headline_claims_reproduced():
    h = headline_ratios()
    assert 4.5 <= h["max_speedup_vs_act_trunc"] <= 6.5
    assert 1.5 <= h["max_energy_ratio_vs_act_trunc"] <= 2.1
    assert 1.8 <= h["dram_reduction_vs_fixed8"] <= 2.6


def test_table4_fs_anchors():
    paper_fs = {("swis_ss", "hi"): 28.6, ("swis_ds", "hi"): 42.9,
                ("act_trunc", "hi"): 12.2, ("fixed8", "hi"): 23.2,
                ("swis_ds", "lo"): 85.7}
    rows = {(r["config"], r["point"]): r for r in evaluate_table4()
            if r["network"] == "resnet18"}
    for key, want in paper_fs.items():
        got = rows[key]["frames_per_s"]
        assert abs(got - want) / want < 0.12, (key, got, want)


def test_fig1_weight_dominated_layers():
    ratios = [r for _, r in fig1_dram_ratio()]
    assert max(ratios) > 50
    assert min(ratios) < 1


def test_mobilenet_depthwise_underutilization():
    sw = _net("swis_ss", 3, "swis", "mobilenet_v2")
    fx = _net("fixed8", 8, "fixed8", "mobilenet_v2")
    sw_r = _net("swis_ss", 3, "swis", "resnet18")
    fx_r = _net("fixed8", 8, "fixed8", "resnet18")
    assert (sw["frames_per_s"] / fx["frames_per_s"]
            < sw_r["frames_per_s"] / fx_r["frames_per_s"])
