"""Output-stationary systolic-array simulator (SCALE-Sim-style analytical
model, paper §3.2 / §5) for bit-serial SWIS execution: a copy of
``repro.perfmodel.systolic`` (pure Python floats, evaluated in the same
order, so every figure equals the reference's). Its cycles, bytes and
joules are predictions for the paper's 28 nm accelerator, not measurements
of any chip.

Array: R x C PEs, each PE processes a depth-wise group of G weights per
cycle (G MACs/cycle for fixed point; G per shift pass for bit-serial).
OS dataflow mapping for a conv layer lowered to GEMM
(M = out pixels, N = out channels, K = k*k*C_in):

  spatial tiles: M over rows (R), N over columns (C), K in groups of G
  cycles(tile)  = K/G * passes + (R + C) pipeline fill
  passes        = ceil(n_shifts / shifts_per_cycle)   (1 for fixed point)

SRAM traffic: OS keeps the output stationary; each (R x C) tile streams its
activations and weights once per K-pass. Weight DRAM traffic is divided by
the SWIS compression ratio (the paper's §3.3 bandwidth saving); activations
are read/written once per layer (+ re-reads when the weight working set
exceeds the weight SRAM).

Depthwise convolutions under-utilize the group dimension (G_eff = 1),
matching the paper's MobileNet discussion.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

from repro_torch.core.packing import compression_ratio
from repro_torch.perfmodel.networks import ConvLayer
from repro_torch.perfmodel.pe import (CLOCK_HZ, DRAM_PJ_PER_BYTE, PEConfig,
                                SRAM_PJ_PER_BYTE)


@dataclasses.dataclass(frozen=True)
class SystolicArray:
    pe: PEConfig
    rows: int = 8
    cols: int = 8
    act_sram_kb: int = 64
    wgt_sram_kb: int = 64
    out_sram_kb: int = 16

    def area_mm2(self) -> float:
        return self.rows * self.cols * self.pe.area_mm2() + 0.27  # SRAM+NoC


@dataclasses.dataclass
class LayerShape:
    m: int  # output pixels
    n: int  # output channels
    k: int  # reduction (k*k*C_in)
    depthwise: bool = False
    ifmap_elems: int = 0  # true input feature map size (line-buffer reuse)
    ofmap_elems: int = 0

    def __post_init__(self):
        if not self.ifmap_elems:
            self.ifmap_elems = self.m * self.k
        if not self.ofmap_elems:
            self.ofmap_elems = self.m * self.n

    @classmethod
    def from_conv(cls, layer: ConvLayer) -> "LayerShape":
        ch = layer.c_in if not layer.depthwise else 1
        return cls(m=layer.out_h * layer.out_w, n=layer.c_out,
                   k=layer.k * layer.k * ch, depthwise=layer.depthwise,
                   ifmap_elems=layer.act_in_count,
                   ofmap_elems=layer.act_out_count)


def _weight_bits_per_element(method: str, n_shifts: float, group: int) -> float:
    if method == "fixed8":
        return 8.0
    if method == "act_trunc":
        return 8.0  # weights stay 8-bit; activations are truncated
    if method == "wgt_trunc":
        return max(n_shifts, 1.0) + 1.0  # N-bit weights + sign
    if method == "bitfusion":
        return 4.0
    variant = "swis_c" if method.startswith("swis_c") else "swis"
    return 8.0 / compression_ratio(group, int(round(n_shifts)), variant)


def simulate_layer(arr: SystolicArray, shape: LayerShape, *,
                   n_shifts: float, method: str) -> Dict[str, float]:
    """Cycle + energy model for one GEMM-lowered layer."""
    pe = arr.pe
    g_eff = 1 if (shape.depthwise and pe.style == "bitserial") else pe.group
    # serial passes over shift planes (weight-serial SWIS / weight trunc),
    # or over activation bits (activation truncation — same cycle count)
    if pe.style == "fixed":
        passes = 1
    else:
        passes = max(math.ceil(n_shifts / pe.shifts_per_cycle), 1)

    m_tiles = math.ceil(shape.m / arr.rows)
    n_tiles = math.ceil(shape.n / arr.cols)
    k_steps = math.ceil(shape.k / g_eff)
    fill = arr.rows + arr.cols  # pipeline fill/drain per tile
    cycles = m_tiles * n_tiles * (k_steps * passes + fill)

    macs = shape.m * shape.n * shape.k
    e_mac = pe.energy_per_mac_pj(n_shifts if pe.style != "fixed" else 8)
    if shape.depthwise and pe.style == "bitserial":
        # group under-utilization: energy still paid for the full group
        e_mac = e_mac * pe.group

    # --- SRAM traffic (bytes) ---
    act_reads = shape.m * shape.k * n_tiles  # ifmap streamed per col tile
    act_bits = 8.0
    wgt_bits = _weight_bits_per_element(method, n_shifts, pe.group)
    wgt_reads_elems = shape.k * shape.n * m_tiles
    out_writes = shape.m * shape.n
    sram_bytes = (act_reads * act_bits + wgt_reads_elems * wgt_bits) / 8.0 \
        + out_writes * 2  # 16-bit partial-sum writeback

    # --- DRAM traffic (bytes) ---
    # Weights are RE-STREAMED once per output-row tile when the footprint
    # exceeds the weight SRAM (OS dataflow; this is the paper's Fig.-1
    # "weights dominate DRAM accesses" effect, which SWIS compression
    # divides directly). Activations get line-buffer reuse (ifmap read once,
    # ofmap written once).
    wgt_footprint = shape.k * shape.n * wgt_bits / 8.0
    wgt_sram_bytes = arr.wgt_sram_kb * 1024
    refetch = m_tiles if wgt_footprint > wgt_sram_bytes else 1
    wgt_bytes_dram = wgt_footprint * refetch
    act_bytes_dram = (shape.ifmap_elems + shape.ofmap_elems) * act_bits / 8.0
    dram_bytes = wgt_bytes_dram + act_bytes_dram

    energy_pj = (macs * e_mac + sram_bytes * SRAM_PJ_PER_BYTE
                 + dram_bytes * DRAM_PJ_PER_BYTE)
    return {
        "cycles": float(cycles),
        "macs": float(macs),
        "energy_pj": energy_pj,
        "dram_bytes": dram_bytes,
        "wgt_dram_bytes": wgt_bytes_dram,
        "act_dram_bytes": act_bytes_dram,
        "sram_bytes": sram_bytes,
    }


def simulate_network(arr: SystolicArray, layers: List[ConvLayer], *,
                     n_shifts: float, method: str) -> Dict[str, float]:
    tot: Dict[str, float] = {}
    for layer in layers:
        r = simulate_layer(arr, LayerShape.from_conv(layer),
                           n_shifts=n_shifts, method=method)
        for k, v in r.items():
            tot[k] = tot.get(k, 0.0) + v
    secs = tot["cycles"] / CLOCK_HZ
    joules = tot["energy_pj"] * 1e-12
    tot["frames_per_s"] = 1.0 / secs
    tot["frames_per_j"] = 1.0 / joules
    return tot
