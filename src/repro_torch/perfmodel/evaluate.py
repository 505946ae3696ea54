"""Table-4 reproduction: F/J and F/s for every accelerator configuration at
the paper's iso-accuracy shift counts, plus Fig. 1 (DRAM W/A access ratio)
and speedup/energy headline ratios: a copy of ``repro.perfmodel.evaluate``.
Every figure is a prediction of the analytical model of the paper's 28 nm
accelerator (:mod:`repro_torch.perfmodel.systolic`), not a measurement of
any chip.

Accuracy-matched shift counts come straight from the paper's Table 4 rows
("S" columns): e.g. ResNet-18 @ >69.1%: SWIS-SS 3, SWIS-DS 4, SWIS-C-SS 4,
SWIS-C-DS 4, act-trunc 7, wgt-trunc 6.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.perfmodel.networks import NETWORKS
from repro_torch.perfmodel.pe import PE_LIBRARY
from repro_torch.perfmodel.systolic import SystolicArray, simulate_network

# (config, shift counts per accuracy point) — paper Table 4 "S" columns.
TABLE4_POINTS = {
    "resnet18": {
        "hi": {"swis_ss": 3, "swis_ds": 4, "swis_c_ss": 4, "swis_c_ds": 4,
               "act_trunc": 7, "wgt_trunc": 6, "bitfusion_4x8": 4,
               "fixed8": 8},
        "lo": {"swis_ss": 2, "swis_ds": 2, "swis_c_ss": 2, "swis_c_ds": 2,
               "act_trunc": 6, "wgt_trunc": 4, "fixed8": 8},
    },
    "mobilenet_v2": {
        "hi": {"swis_ss": 5, "swis_ds": 5, "swis_c_ss": 5, "swis_c_ds": 6,
               "act_trunc": 7, "wgt_trunc": 6, "fixed8": 8},
        "lo": {"swis_ss": 3.5, "swis_ds": 4, "swis_c_ss": 4, "swis_c_ds": 4,
               "act_trunc": 6, "wgt_trunc": 5, "fixed8": 8},
    },
    "vgg16_cifar": {
        "hi": {"swis_ss": 3, "swis_ds": 4, "swis_c_ss": 4, "swis_c_ds": 4,
               "act_trunc": 7, "wgt_trunc": 6, "bitfusion_4x8": 4,
               "fixed8": 8},
        "lo": {"swis_ss": 2.5, "swis_ds": 2.5, "swis_c_ss": 3,
               "swis_c_ds": 3, "act_trunc": 6, "wgt_trunc": 4, "fixed8": 8},
    },
}

_METHOD_FOR = {
    "swis_ss": "swis", "swis_ds": "swis",
    "swis_c_ss": "swis_c", "swis_c_ds": "swis_c",
    "act_trunc": "act_trunc", "wgt_trunc": "wgt_trunc",
    "bitfusion_4x8": "bitfusion", "fixed8": "fixed8",
}


def evaluate_table4(rows: int = 8, cols: int = 8) -> List[Dict]:
    out = []
    for net, points in TABLE4_POINTS.items():
        layers = NETWORKS[net]
        for point, cfgs in points.items():
            for cfg_name, n_shifts in cfgs.items():
                arr = SystolicArray(PE_LIBRARY[cfg_name], rows, cols)
                r = simulate_network(arr, layers, n_shifts=n_shifts,
                                     method=_METHOD_FOR[cfg_name])
                out.append({
                    "network": net, "point": point, "config": cfg_name,
                    "n_shifts": n_shifts,
                    "frames_per_s": r["frames_per_s"],
                    "frames_per_j": r["frames_per_j"],
                    "area_mm2": arr.area_mm2(),
                    "dram_bytes": r["dram_bytes"],
                })
    return out


def headline_ratios(rows: int = 8, cols: int = 8) -> Dict[str, float]:
    """The paper's claims: up to 6x speedup / 1.9x energy vs act-trunc
    bit-serial; weight DRAM bandwidth reduction vs fixed8."""
    table = evaluate_table4(rows, cols)

    def get(net, point, cfg):
        for r in table:
            if (r["network"], r["point"], r["config"]) == (net, point, cfg):
                return r
        raise KeyError((net, point, cfg))

    speedups, energies = [], []
    for net in TABLE4_POINTS:
        for point in ("hi", "lo"):
            at = get(net, point, "act_trunc")
            for cfg in ("swis_ss", "swis_ds"):
                sw = get(net, point, cfg)
                speedups.append(sw["frames_per_s"] / at["frames_per_s"])
                energies.append(sw["frames_per_j"] / at["frames_per_j"])
    fx = get("resnet18", "hi", "fixed8")
    sw = get("resnet18", "lo", "swis_c_ss")
    return {
        "max_speedup_vs_act_trunc": max(speedups),
        "min_speedup_vs_act_trunc": min(speedups),
        "max_energy_ratio_vs_act_trunc": max(energies),
        "dram_reduction_vs_fixed8": fx["dram_bytes"] / sw["dram_bytes"],
    }


def fig1_dram_ratio() -> List[Tuple[str, float]]:
    """Fig. 1: per-layer DRAM weight/activation access ratio, ResNet-18."""
    from repro_torch.perfmodel.systolic import LayerShape, simulate_layer

    arr = SystolicArray(PE_LIBRARY["fixed8"])
    out = []
    for layer in NETWORKS["resnet18"]:
        r = simulate_layer(arr, LayerShape.from_conv(layer), n_shifts=8,
                           method="fixed8")
        out.append((layer.name,
                    r["wgt_dram_bytes"] / max(r["act_dram_bytes"], 1)))
    return out
