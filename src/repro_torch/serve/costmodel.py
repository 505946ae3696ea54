"""Analytical per-dispatch cost model for the serve engine (port of
``repro.serve.costmodel``; the formulas are the reference's, line for
line, so the counters equal its own on the same traffic).

The SWIS paper's headline numbers are *cost-model* numbers — cycles and
DRAM traffic as a function of bit-slice counts (§3.3, Table 4) — and the
serve stack's wall-clock observability cannot attribute a regression to
the quantity that actually explains bit-serial speedups: bytes moved.
This module closes that gap with pure shape-in/cost-out functions for
every launch kind the engine issues (decode batch, prefill, chunked
prefill, fused ``mixed_step``, speculative draft, ``verify_step``), each
returning a :class:`DispatchCost`:

* **flops** — GEMM work (2·K·C per token per weight), dense attention
  over the attended window (the launches compute masked full-length
  attention, so the window is the *capacity*, not the row's position),
  and the unembed GEMM over however many positions the launch unembeds.
* **hbm_bytes** — read + written: weights once per dispatch (packed
  leaves at their bit-plane footprint via
  :func:`repro_torch.core.packing.compression_ratio`, honoring
  ``keep_slices`` truncation — a truncated draft launch streams only the
  planes it reads), K/V read over the attended window and written per token,
  residual-stream activations, plus the gathered-K/V copy the reference
  paged-decode path materializes (:func:`decode_gathered_bytes`).
* **swis_cycles** — shift-pass cycles on a weight-stationary
  ``ARRAY_ROWS x ARRAY_COLS`` bit-serial array using the calibrated
  :mod:`repro_torch.perfmodel.pe` constants: a packed GEMM retires one
  ``group_size`` MAC group per ``ceil(n_eff / shifts_per_cycle)`` passes
  (``n_eff`` = kept bit-slices), dense GEMMs run one MAC per PE per
  cycle. Attention (activation x activation, no stationary weights) is
  excluded by construction.

Approximations, stated once: MoE leaves count every expert (weights are
modeled as streamed per dispatch — an upper bound when routing is
sparse); chunked-prefill attention uses the working-tree length the
engine actually allocates; sub-byte tail effects of nibble-packed shift
metadata are folded into ``compression_ratio`` exactly as the paper's
§3.3 accounting does.

The engine wires a :class:`CostModel` (one per engine, built from the
live — possibly packed — parameter tree and the cache geometry) into
every dispatch site and records ``cost.flops`` / ``cost.hbm_bytes`` /
``cost.swis_cycles`` counters and per-kind histograms.

What differs from the reference is where the shapes come from: the tree
holds torch tensors (packed planes as ``int32`` views of the ``uint32``
words, whose bytes are never read: a packed leaf's traffic comes from
``compression_ratio``), the cache dtype is a torch dtype, and the paged
backend is the port's (:func:`decode_gathered_bytes`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.packing import compression_ratio
from repro_torch.perfmodel.pe import CLOCK_HZ, PE_LIBRARY, PEConfig

# weight-leaf names the model's dense() path treats as GEMMs (mirrors
# repro_torch.serve.quantized._eligible, minus the packability constraints —
# a GEMM too small to pack is still a GEMM)
GEMM_LEAF_NAMES = ("w", "wi", "wo", "wg", "shared_wi", "shared_wo",
                   "shared_wg")
_NON_GEMM_PATHS = ("embed", "router", "frontend")

# modeled systolic-array geometry: 8x8 PEs, the paper's §3.1 arrays
ARRAY_ROWS = 8
ARRAY_COLS = 8


@dataclasses.dataclass(frozen=True)
class GemmSpec:
    """One GEMM weight leaf: a trailing (k, c) matrix times ``stack``
    stacked copies (scanned layers and/or experts)."""

    k: int
    c: int
    stack: int = 1
    itemsize: int = 4  # dense storage bytes/element (float32 serving)
    packed: bool = False
    n_shifts: int = 0
    group_size: int = 4
    method: str = "swis"

    @property
    def macs(self) -> int:
        """MACs this weight contributes per processed token."""
        return self.stack * self.k * self.c

    def eff_shifts(self, keep_slices: Optional[int] = None) -> int:
        """Bit-slices a launch actually evaluates (keep_slices caps)."""
        if not self.packed:
            return 0
        if keep_slices is None:
            return self.n_shifts
        return max(1, min(keep_slices, self.n_shifts))

    def weight_bytes(self, keep_slices: Optional[int] = None) -> float:
        """HBM bytes one dispatch streams for this weight. Packed leaves
        read sign plane + kept mask planes + kept shift nibbles — exactly
        the §3.3 storage accounting, so ``compression_ratio`` of the kept
        slice count gives the footprint relative to 8-bit dense."""
        if not self.packed:
            return float(self.macs * self.itemsize)
        ratio = compression_ratio(self.group_size,
                                  self.eff_shifts(keep_slices), self.method)
        return self.macs / ratio  # 8-bit dense bytes / compression


@dataclasses.dataclass(frozen=True)
class CacheGeometry:
    """KV-cache shape facts the per-launch costs depend on."""

    n_layers: int
    n_kv_heads: int
    head_dim: int
    kv_itemsize: int
    attended_len: int  # positions a masked launch attends over (capacity)
    block_size: Optional[int] = None  # None: contiguous per-slot rows
    paged_impl: Optional[str] = None  # None | 'xla' (CPU) | 'cuda' (kernel)

    @property
    def kv_bytes_per_pos(self) -> int:
        """K + V bytes for one position, summed over layers."""
        return 2 * self.n_kv_heads * self.head_dim * self.kv_itemsize \
            * self.n_layers


@dataclasses.dataclass(frozen=True)
class DispatchCost:
    """Predicted cost of one model launch."""

    kind: str
    flops: float
    hbm_bytes: float  # read + written, gathered copy included
    swis_cycles: float
    gathered_bytes: float = 0.0  # materialized K/V copy (gather path)


def gemm_inventory(params: Any,
                   method: str = "swis") -> Tuple[List[GemmSpec], float]:
    """Walk a (possibly SWIS-packed) parameter tree.

    Returns ``(specs, other_bytes)``: the GEMM weight leaves the cost
    model accounts per token, and the total bytes of every other
    parameter (embed table, norms, routers, ...) — read once per
    dispatch but doing no per-token GEMM work (the unembed GEMM over the
    tied embed table is costed separately from the launch's unembedded
    position count)."""
    specs: List[GemmSpec] = []
    other = 0.0

    def walk(path, node):
        nonlocal other
        if isinstance(node, dict):
            if "mask_planes" in node:  # packed leaf (quantized.is_packed)
                sign, mask = node["sign_plane"], node["mask_planes"]
                k = int(sign.shape[-2]) * 32
                c = int(sign.shape[-1])
                stack = int(np.prod(mask.shape[:-3], dtype=np.int64))
                specs.append(GemmSpec(
                    k=k, c=c, stack=max(stack, 1), packed=True,
                    n_shifts=int(mask.shape[-3]),
                    group_size=k // int(node["shifts"].shape[-3]),
                    method=method))
                return
            for key, v in node.items():
                walk(path + (str(key),), v)
            return
        if not hasattr(node, "shape"):
            return
        itemsize = _itemsize(node.dtype)
        nbytes = int(np.prod(node.shape, dtype=np.int64)) * itemsize
        joined = "/".join(path)
        if (len(node.shape) >= 2 and path and path[-1] in GEMM_LEAF_NAMES
                and not any(p in joined for p in _NON_GEMM_PATHS)):
            specs.append(GemmSpec(
                k=int(node.shape[-2]), c=int(node.shape[-1]),
                stack=max(int(np.prod(node.shape[:-2], dtype=np.int64)), 1),
                itemsize=itemsize))
        else:
            other += nbytes

    walk((), params)
    return specs, other


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def decode_gathered_bytes(geom: CacheGeometry, n_rows: int) -> float:
    """Bytes of gathered K/V one paged-decode launch materializes, as the
    reference counts them. The gather path (``paged_impl`` None) rebuilds
    each row's contiguous arena view; the plain paged version on the CPU
    (``"xla"``) is the reference's XLA scan and touches one block_size
    slab per scan step; the CUDA kernel (``"cuda"``) indexes the arena in
    place and gathers nothing, as the reference's Pallas kernel;
    contiguous (non-block) caches never gather."""
    if geom.block_size is None:
        return 0.0
    kv = 2 * n_rows * geom.n_kv_heads * geom.head_dim * geom.n_layers
    if geom.paged_impl is None:
        return float(kv * geom.attended_len * geom.kv_itemsize)
    if geom.paged_impl == "xla":
        return float(kv * geom.block_size * geom.kv_itemsize)
    return 0.0  # the CUDA kernel: in-kernel indirection


def launch_cost(kind: str, cfg: ArchConfig, specs: List[GemmSpec],
                other_bytes: float, geom: CacheGeometry,
                pe: PEConfig, *, n_rows: int, s: int, kv_len: int,
                unembed_positions: int,
                keep_slices: Optional[int] = None,
                gather_rows: int = 0,
                act_itemsize: int = 4) -> DispatchCost:
    """Cost one model launch of ``n_rows`` rows x ``s`` token positions
    attending over ``kv_len`` cached positions and unembedding
    ``unembed_positions`` positions in total."""
    tokens = n_rows * s
    d_attn = cfg.n_heads * cfg.head_dim

    gemm_macs = sum(sp.macs for sp in specs)
    flops = 2.0 * tokens * gemm_macs
    flops += 4.0 * n_rows * s * kv_len * d_attn * cfg.n_layers
    flops += 2.0 * cfg.d_model * cfg.padded_vocab * unembed_positions

    weight = sum(sp.weight_bytes(keep_slices) for sp in specs) + other_bytes
    weight += 0.0  # unembed table already counted in other_bytes (tied)
    kv_read = float(n_rows) * kv_len * geom.kv_bytes_per_pos
    kv_write = float(tokens) * geom.kv_bytes_per_pos
    act = 2.0 * tokens * cfg.d_model * act_itemsize * cfg.n_layers
    gathered = decode_gathered_bytes(geom, gather_rows) if gather_rows \
        else 0.0
    hbm = weight + kv_read + kv_write + act + gathered

    array_macs = ARRAY_ROWS * ARRAY_COLS
    cycles = 0.0
    for sp in specs:
        if sp.packed:
            passes = pe.cycles_per_mac_group(sp.eff_shifts(keep_slices))
            cycles += tokens * sp.macs * passes / (array_macs * pe.group)
        else:
            cycles += tokens * sp.macs / array_macs
    cycles += cfg.d_model * cfg.padded_vocab * unembed_positions \
        / array_macs

    return DispatchCost(kind=kind, flops=flops, hbm_bytes=hbm,
                        swis_cycles=cycles, gathered_bytes=gathered)


class CostModel:
    """Per-dispatch cost predictions bound to one engine's geometry.

    Construct once (the inventory walk is O(n_leaves)); each ``decode``/
    ``prefill``/``chunk``/``mixed``/``draft``/``verify`` call is memoized
    by its launch shape, so the per-step recording overhead is a dict
    lookup for every steady-state shape."""

    def __init__(self, cfg: ArchConfig, params: Any, *, kv_itemsize: int,
                 attended_len: int, block_size: Optional[int] = None,
                 paged_impl: Optional[str] = None, method: str = "swis",
                 pe: Optional[PEConfig] = None):
        self.cfg = cfg
        self.specs, self.other_bytes = gemm_inventory(params, method)
        self.geom = CacheGeometry(
            n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim, kv_itemsize=kv_itemsize,
            attended_len=attended_len, block_size=block_size,
            paged_impl=paged_impl)
        self.pe = pe or PE_LIBRARY["swis_ss"]
        self._memo: Dict[tuple, DispatchCost] = {}

    @classmethod
    def for_engine(cls, engine) -> "CostModel":
        """Build from a live ContinuousBatchingEngine: packed params,
        cache dtype/geometry, and paged backend as configured."""
        cache = engine.cache
        attended = cache.eff_len if cache.block_size else engine.max_len
        return cls(engine.cfg, engine.params,
                   kv_itemsize=_itemsize(cache.dtype),
                   attended_len=attended, block_size=cache.block_size,
                   paged_impl=engine.paged_impl,
                   method=engine.cfg.quant.cfg.method)

    # -- launch kinds ----------------------------------------------------

    def _launch(self, kind: str, n_rows: int, s: int, kv_len: int,
                unembed_positions: int, keep_slices: Optional[int],
                gather_rows: int) -> DispatchCost:
        key = (kind, n_rows, s, kv_len, unembed_positions, keep_slices,
               gather_rows)
        cost = self._memo.get(key)
        if cost is None:
            cost = self._memo[key] = launch_cost(
                kind, self.cfg, self.specs, self.other_bytes, self.geom,
                self.pe, n_rows=n_rows, s=s, kv_len=kv_len,
                unembed_positions=unembed_positions,
                keep_slices=keep_slices, gather_rows=gather_rows)
        return cost

    def decode(self, n_rows: int) -> DispatchCost:
        """One batched S=1 decode step over ``n_rows`` slots."""
        return self._launch("decode", n_rows, 1, self.geom.attended_len,
                            n_rows, None, n_rows)

    def prefill(self, n_rows: int, s: int,
                kv_len: Optional[int] = None) -> DispatchCost:
        """One whole/suffix prefill group: ``n_rows`` rows of ``s``
        (padded) suffix tokens over a full-capacity working tree."""
        kv = self.geom.attended_len if kv_len is None else kv_len
        return self._launch("prefill", n_rows, s, kv, n_rows, None, 0)

    def chunk(self, n_rows: int, s: int, kv_len: int) -> DispatchCost:
        """One chunk-advance launch over the group's working tree
        (``kv_len`` = the tree length the engine allocated)."""
        return self._launch("chunk", n_rows, s, kv_len, n_rows, None, 0)

    def mixed(self, n_rows: int, s: int) -> DispatchCost:
        """One fused chunk+decode ``mixed_step``: every row computes
        ``s`` (masked) positions against the arena capacity."""
        return self._launch("mixed", n_rows, s, self.geom.attended_len,
                            n_rows, None, n_rows)

    def draft(self, n_rows: int,
              keep_slices: Optional[int] = None) -> DispatchCost:
        """One S=1 speculative draft launch with packed GEMMs truncated
        to ``keep_slices`` bit-planes (None: full precision)."""
        return self._launch("draft", n_rows, 1, self.geom.attended_len,
                            n_rows, keep_slices, n_rows)

    def verify(self, n_rows: int, s: int) -> DispatchCost:
        """One full-precision ``verify_step`` scoring all ``s`` positions
        per row (unembeds every position, unlike decode/prefill)."""
        return self._launch("verify", n_rows, s, self.geom.attended_len,
                            n_rows * s, None, n_rows)

    # -- static facts ----------------------------------------------------

    def summary(self) -> Dict[str, float]:
        """Model-static facts for the metrics snapshot: per-dispatch
        weight traffic (packed vs dense), per-token GEMM work, and the
        modeled compression."""
        dense = sum(sp.macs * (sp.itemsize if not sp.packed else 1)
                    for sp in self.specs) + self.other_bytes
        actual = sum(sp.weight_bytes() for sp in self.specs) \
            + self.other_bytes
        return {
            "n_gemm_leaves": len(self.specs),
            "n_packed_leaves": sum(sp.packed for sp in self.specs),
            "weight_bytes_per_dispatch": actual,
            "weight_bytes_dense8": float(dense),
            "gemm_flops_per_token":
                2.0 * sum(sp.macs for sp in self.specs),
            "swis_cycles_per_token": sum(
                (sp.macs * self.pe.cycles_per_mac_group(sp.n_shifts)
                 / (ARRAY_ROWS * ARRAY_COLS * self.pe.group)) if sp.packed
                else sp.macs / (ARRAY_ROWS * ARRAY_COLS)
                for sp in self.specs),
        }


def predicted_bandwidth(total_hbm_bytes: float,
                        total_step_seconds: float) -> float:
    """Model-implied HBM bandwidth (bytes/s) of a measured serving run:
    the bytes the cost model says the issued dispatches should move,
    over the wall time the step loop actually took. The engine exports
    this as the ``cost.hbm_bytes_per_s`` gauge (model-vs-measured
    utilization: compare against the substrate's peak)."""
    if total_step_seconds <= 0.0:
        return 0.0
    return total_hbm_bytes / total_step_seconds


def cycle_time_s(cycles: float, clock_hz: Optional[float] = None) -> float:
    """Seconds the modeled array needs for ``cycles`` shift-pass cycles
    (defaults to the paper's calibrated 650 MHz clock)."""
    return cycles / (clock_hz or CLOCK_HZ)
