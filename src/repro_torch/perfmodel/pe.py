"""Processing-element area/energy models (paper §3.1, Fig. 3; Table 4 anchors).

A copy of ``repro.perfmodel.pe`` (pure Python); the serve cost model
(:mod:`repro_torch.serve.costmodel`) reads its shift-pass constants.

The paper synthesizes 8-bit fixed-point, single-shift (SS) and double-shift
(DS) bit-serial PEs at group sizes 2-16 in 28nm TSMC. We calibrate an
analytical PE model against the paper's own Table 4 (ResNet-18 column):

* "8-b FX" baseline = conventional 8x8 systolic array (ONE 8-bit MAC per PE
  per cycle — group applies to the bit-serial PEs).
* Bit-serial PEs process a G=4 depth-wise group per shift pass; SWIS needs
  ceil(N / shifts_per_cycle) passes (N = effective shifts).
* BitFusion 4x8 = decomposable array, 2x MAC lanes at 4-bit weights, with a
  fusion-network energy overhead.

Calibration (grid-fit to 10 Table-4 ResNet-18 points, see EXPERIMENTS.md):
  clock 650 MHz; MAC8 = 0.15 pJ; bit-serial pass = 0.34 * MAC8 (DS pass
  1.15x); fixed per-MAC buffering overhead 0.08 * MAC8; SRAM 1.1 pJ/B;
  DRAM 24 pJ/B (LPDDR4-class, with OS-dataflow weight re-fetch); BitFusion energy overhead 1.6x.
Fit quality: F/s within 5% on all 10 points; F/J within 7% on the SWIS
family; the act-trunc / wgt-trunc / fixed8 / BitFusion baselines come out
15-60% MORE energy-efficient than the paper reports, i.e. our reproduced
speedup/energy ratios are CONSERVATIVE w.r.t. the paper's claims.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

CLOCK_HZ = 0.65e9
MAC8_PJ = 0.15  # 8-bit fixed-point MAC energy, pJ (28nm, calibrated)
SRAM_PJ_PER_BYTE = 1.1
DRAM_PJ_PER_BYTE = 24.0
PASS_RATIO = 0.34  # bit-serial shift-pass energy / MAC8 (per group-MAC)
PASS_OVERHEAD = 0.08  # activation buffering etc., x MAC8 per MAC
DS_PASS_FACTOR = 1.15  # double-shift pass costs 1.3x an SS pass (does 2 shifts)
BITFUSION_E_OVERHEAD = 1.6
FIXED_PE_AREA_MM2 = 0.0042  # one 8-bit MAC lane incl. local buffers


@dataclasses.dataclass(frozen=True)
class PEConfig:
    """One PE variant of the paper's design space."""

    name: str
    style: str  # 'fixed' | 'bitserial'
    shifts_per_cycle: int = 1  # 1 = SS, 2 = DS
    group: int = 4  # MAC lanes (bit-serial: weights sharing a shift pass)
    energy_overhead: float = 1.0

    def area_ratio(self) -> float:
        """Fig. 3a: a group-G bit-serial PE ~ area of G/4 fixed MAC lanes
        (paper arrays are all ~0.54-0.55 mm^2 at G=4)."""
        if self.style == "fixed":
            return 1.0 * self.group
        base = self.group / 4.0
        if self.shifts_per_cycle == 2:
            base *= 1.04  # DS adds a second shifter path (0.55 vs 0.54 mm^2)
        return base

    def area_mm2(self) -> float:
        return FIXED_PE_AREA_MM2 * self.area_ratio()

    def cycles_per_mac_group(self, n_shifts: float) -> float:
        """Cycles to retire one group of MACs."""
        if self.style == "fixed":
            return 1.0
        return max(math.ceil(n_shifts / self.shifts_per_cycle), 1)

    def energy_per_mac_pj(self, n_shifts: float) -> float:
        """Energy per equivalent 8-bit MAC (Fig. 3b shape, Table 4 calib)."""
        if self.style == "fixed":
            return MAC8_PJ * self.energy_overhead
        per_pass = MAC8_PJ * PASS_RATIO
        if self.shifts_per_cycle == 2:
            per_pass *= DS_PASS_FACTOR
        passes = max(math.ceil(n_shifts / self.shifts_per_cycle), 1)
        return per_pass * passes + MAC8_PJ * PASS_OVERHEAD

    def macs_per_cycle(self, n_shifts: float, depthwise: bool = False) -> float:
        g = 1 if (depthwise and self.style == "bitserial") else self.group
        return g / self.cycles_per_mac_group(n_shifts)


PE_LIBRARY: Dict[str, PEConfig] = {
    # conventional 8-bit array: 1 MAC/PE/cycle
    "fixed8": PEConfig("fixed8", "fixed", 1, 1),
    "swis_ss": PEConfig("swis_ss", "bitserial", 1, 4),
    "swis_ds": PEConfig("swis_ds", "bitserial", 2, 4),
    # SWIS-C shares the PE; only shift decode differs
    "swis_c_ss": PEConfig("swis_c_ss", "bitserial", 1, 4),
    "swis_c_ds": PEConfig("swis_c_ds", "bitserial", 2, 4),
    # Stripes-like activation-serial; weights parallel (8b), acts serial
    "act_trunc": PEConfig("act_trunc", "bitserial", 1, 4),
    "wgt_trunc": PEConfig("wgt_trunc", "bitserial", 1, 4),
    # BitFusion: 2x lanes at 4-bit weights + fusion-network overhead
    "bitfusion_4x8": PEConfig("bitfusion_4x8", "fixed", 1, 2,
                              energy_overhead=BITFUSION_E_OVERHEAD),
}
