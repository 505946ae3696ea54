"""SWIS weight quantization (paper §2, §4): PyTorch port of ``repro.core.swis``.

:func:`quantize` is the post-training path that packing and serving use:
it returns the dequantized weights and all metadata needed for packing
(signs / masks / shifts / scales), for the swis, swis_c and trunc methods
and for fractional shift targets (filter scheduling, paper §4.3).
``fake_quant`` and ``act_truncate`` (QAT and the activation-truncation
baseline) are not ported yet: serving with ``mode="off"`` does not reach
them.

Weight layout convention: 2-D ``(K, C)`` with K the reduction (input) dim —
groups of ``group_size`` weights are taken along K per output column C.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import selection


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Configuration for SWIS quantization of one weight family.

    method: 'none' | 'swis' | 'swis_c' | 'trunc' (layer-wise weight
        truncation baseline).
    n_shifts: effective number of shifts; fractional values engage filter
        scheduling (§4.3).
    group_size: PE group size M (weights sharing a support vector).
    alpha: MSE++ signed-error coefficient (Eq. 12).
    bits: underlying integer precision B.
    per_channel: per-output-column scales (True) or per-tensor (False).
    double_shift: restrict per-column shift counts to even values (DS PE,
        §3.1); fractional/odd targets are met by mixing even counts.
    schedule: enable filter scheduling for fractional targets.
    round_trunc: round-to-nearest instead of the paper's floor for trunc.
    """

    method: str = "swis"
    n_shifts: float = 4
    group_size: int = 4
    alpha: float = 1.0
    bits: int = 8
    per_channel: bool = False
    double_shift: bool = False
    schedule: bool = True
    round_trunc: bool = False

    @property
    def variant(self) -> str:
        return {"swis": "swis", "swis_c": "swis_c", "trunc": "trunc"}[self.method]

    def shift_levels(self) -> tuple[int, int, float]:
        """(n_lo, n_hi, fraction_of_columns_at_hi) realizing ``n_shifts``."""
        t = float(self.n_shifts)
        step = 2 if self.double_shift else 1
        lo = int(t // step) * step
        if lo == t and lo > 0:
            return lo, lo, 0.0
        lo = max(lo, 0)
        hi = lo + step
        if lo == 0:
            return hi, hi, 0.0  # below one step: round up
        return lo, hi, (t - lo) / step


def _to_int_domain(w: torch.Tensor, bits: int, per_channel: bool):
    """Symmetric sign-magnitude quantization to B bits (Eq. 2 domain)."""
    maxq = float(2 ** bits - 1)
    absw = torch.abs(w)
    amax = (torch.amax(absw, dim=0, keepdim=True) if per_channel
            else torch.amax(absw))
    scale = torch.clamp_min(amax / maxq, 1e-12)
    mags = torch.clamp(torch.round(absw / scale), 0.0, maxq)
    signs = torch.where(w < 0, -1.0, 1.0)
    return mags.float(), signs.float(), scale


def _column_costs(mags, signs, n, cfg: QuantConfig):
    out = selection.quantize_grouped(
        mags, signs, n_shifts=n, group_size=cfg.group_size, bits=cfg.bits,
        variant=cfg.variant, alpha=cfg.alpha)
    return out, out["cost"].sum(dim=0)  # (C,) summed MSE++ per column


def _floor_truncate(mags: torch.Tensor, n: int, bits: int) -> torch.Tensor:
    """Hardware LSB truncation: drop the lowest (bits - n) magnitude bits."""
    step = float(2 ** (bits - int(n)))
    return torch.floor(mags / step) * step


@dataclasses.dataclass
class QuantizedWeight:
    """Full PTQ result for one (K, C) weight matrix."""

    qweights: torch.Tensor  # (K, C) dequantized float
    qmags: torch.Tensor  # (K, C) integer-valued magnitudes
    signs: torch.Tensor  # (K, C) {-1, +1}
    masks: torch.Tensor  # (K, C) int32 mask-bit pattern per weight
    shifts: torch.Tensor  # (K//M, C, N) int32 selected bit positions
    scale: torch.Tensor  # (1, C) or scalar
    col_shifts: torch.Tensor  # (C,) int32 per-column shift count
    cost: torch.Tensor  # (K//M, C) group MSE++
    cfg: QuantConfig


def quantize(w: torch.Tensor, cfg: QuantConfig) -> QuantizedWeight:
    """Post-training SWIS quantization with metadata (offline)."""
    if w.ndim != 2:
        raise ValueError("quantize expects a 2-D (K, C) matrix; reshape first")
    K, C = w.shape
    if K % cfg.group_size:
        raise ValueError(f"K={K} not divisible by group size {cfg.group_size}")
    dev = w.device
    mags, signs, scale = _to_int_domain(w, cfg.bits, cfg.per_channel)
    n_lo, n_hi, frac = cfg.shift_levels()

    if cfg.method == "trunc" and not cfg.round_trunc:
        n = max(n_lo, 1)
        qm = _floor_truncate(mags, n, cfg.bits)
        window = torch.arange(cfg.bits - n, cfg.bits, dtype=torch.int32,
                              device=dev)
        masks = (qm / float(2 ** (cfg.bits - n))).to(torch.int32)
        shifts = window.expand(K // cfg.group_size, C, n).clone()
        err = mags - qm
        cost = (err ** 2).reshape(K // cfg.group_size, cfg.group_size, C).sum(1)
        return QuantizedWeight(
            qweights=(signs * qm * scale).to(w.dtype),
            qmags=qm, signs=signs, masks=masks, shifts=shifts, scale=scale,
            col_shifts=torch.full((C,), n, dtype=torch.int32, device=dev),
            cost=cost, cfg=cfg)

    if n_lo == n_hi or not cfg.schedule or frac == 0.0:
        n = n_hi if n_lo != n_hi else n_lo
        out, _ = _column_costs(mags, signs, n, cfg)
        col_shifts = torch.full((C,), n, dtype=torch.int32, device=dev)
        qm, masks, shifts, cost = (out["qmags"], out["masks"], out["shifts"],
                                   out["cost"])
    else:
        out_lo, cost_lo = _column_costs(mags, signs, n_lo, cfg)
        out_hi, cost_hi = _column_costs(mags, signs, n_hi, cfg)
        # §4.3: the columns with the largest penalty for being demoted keep
        # the higher shift count (stable order, as the reference sorts)
        penalty = cost_lo - cost_hi
        k_hi = int(round(frac * C))
        order = torch.argsort(-penalty, stable=True)
        use_hi = torch.zeros((C,), dtype=torch.bool, device=dev)
        use_hi[order[:k_hi]] = True
        qm = torch.where(use_hi[None, :], out_hi["qmags"], out_lo["qmags"])
        masks = torch.where(use_hi[None, :], out_hi["masks"], out_lo["masks"])
        # pad lo shifts with an inert extra position (repeat last)
        pad_n = out_hi["shifts"].shape[-1] - out_lo["shifts"].shape[-1]
        lo_shifts = torch.cat(
            [out_lo["shifts"]] + [out_lo["shifts"][..., -1:]] * pad_n, dim=-1)
        shifts = torch.where(use_hi[None, :, None], out_hi["shifts"], lo_shifts)
        cost = torch.where(use_hi[None, :], out_hi["cost"], out_lo["cost"])
        col_shifts = torch.where(use_hi, n_hi, n_lo).to(torch.int32)

    return QuantizedWeight(
        qweights=(signs * qm * scale).to(w.dtype), qmags=qm, signs=signs,
        masks=masks, shifts=shifts, scale=scale, col_shifts=col_shifts,
        cost=cost, cfg=cfg)
