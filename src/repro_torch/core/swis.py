"""SWIS weight quantization (paper §2, §4): PyTorch port of ``repro.core.swis``.

* :func:`quantize`     — the post-training path that packing and serving
                         use: the dequantized weights and all metadata
                         needed for packing (signs / masks / shifts /
                         scales), for the swis, swis_c and trunc methods
                         and for fractional shift targets (filter
                         scheduling, paper §4.3).
* :func:`fake_quant`   — quantize-dequantize only (QAT and PTQ in the
                         loss graph); :func:`fake_quant_stack` quantizes
                         each matrix of a stack on its own, as the
                         reference's ``jax.vmap(fake_quant)`` does.
* :func:`act_truncate` — the activation-truncation baseline (paper §5).

Selection works on integer-domain magnitudes, so its costs are exact
integers in float32 and the results equal the reference's bit for bit.
The one sum that can round is a column's cost over its groups, used by
filter scheduling at fractional ``n_shifts``: it is exact while it stays
under 2**24.

Weight layout convention: 2-D ``(K, C)`` with K the reduction (input) dim —
groups of ``group_size`` weights are taken along K per output column C.
"""
from __future__ import annotations

import dataclasses

import numpy as np
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


def _recip(x: float) -> float:
    """float32 1/x. The reference jits its in-graph paths, and XLA turns a
    division by a constant into a product with the constant's float32
    reciprocal: the scales of ``fake_quant`` and ``act_truncate`` are
    ``amax * (1/maxq)``, one ulp off ``amax / maxq`` at times."""
    return float(np.float32(1.0) / np.float32(x))


# The in-graph path selects over at most this many magnitudes a pass (the
# reference never chunks it; chunking along the group axis changes no
# result and bounds the selection's temporaries to a few hundred MB).
FAKE_QUANT_CHUNK_ELEMS = 1 << 24


def _stack_qmags(mags: torch.Tensor, signs: torch.Tensor, n: int,
                 cfg: QuantConfig):
    """Quantized magnitudes and per-column costs of a stack (B, K, C) of
    integer-domain matrices: groups of ``group_size`` along K, each
    selected on its own. Returns (qmags (B, K, C), column cost (B, C))."""
    b, k, c = mags.shape
    m = cfg.group_size
    g_mags = mags.reshape(b, k // m, m, c).transpose(-1, -2)
    g_signs = signs.reshape(b, k // m, m, c).transpose(-1, -2)
    q, cost = selection.select_qmags(
        g_mags.reshape(-1, c, m), g_signs.reshape(-1, c, m), n_shifts=n,
        bits=cfg.bits, variant=cfg.variant, alpha=cfg.alpha,
        chunk_elems=FAKE_QUANT_CHUNK_ELEMS)
    q = q.reshape(b, k // m, c, m).transpose(-1, -2).reshape(b, k, c)
    return q, cost.reshape(b, k // m, c).sum(dim=1)


def _fake_quant_impl(w: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    """Fake-quant of a stack (B, K, C), each (K, C) matrix with its own
    scale, as the reference's ``_fake_quant_impl`` of one matrix. The
    gradient flows through the scale alone: round, floor and sign have
    zero gradient in the reference, so selection runs on detached
    magnitudes."""
    b, k, c = w.shape
    maxq = float(2 ** cfg.bits - 1)
    absw = torch.abs(w)
    amax = (torch.amax(absw, dim=1, keepdim=True) if cfg.per_channel
            else torch.amax(absw, dim=(1, 2), keepdim=True))
    scale = torch.clamp_min(amax * _recip(maxq), 1e-12)
    with torch.no_grad():
        mags = torch.clamp(torch.round(absw / scale), 0.0, maxq).float()
        signs = torch.where(w < 0, -1.0, 1.0).float()
        n_lo, n_hi, frac = cfg.shift_levels()
        if cfg.method == "trunc" and not cfg.round_trunc:
            q = _floor_truncate(mags, max(n_lo, 1), cfg.bits)
        elif n_lo == n_hi or not cfg.schedule or frac == 0.0:
            q, _ = _stack_qmags(mags, signs, n_hi if n_lo != n_hi else n_lo,
                                cfg)
        else:
            q_lo, cost_lo = _stack_qmags(mags, signs, n_lo, cfg)
            q_hi, cost_hi = _stack_qmags(mags, signs, n_hi, cfg)
            # §4.3 (in-graph form): the k_hi columns with the largest
            # penalty for being demoted keep the higher shift count; a
            # stable descending order puts the lower index first on ties,
            # as the reference's top_k does
            penalty = cost_lo - cost_hi
            k_hi = int(round(frac * c))
            order = torch.argsort(penalty, dim=-1, descending=True,
                                  stable=True)
            use_hi = torch.zeros((b, c), dtype=torch.bool, device=w.device)
            use_hi.scatter_(1, order[:, :k_hi], True)
            q = torch.where(use_hi[:, None, :], q_hi, q_lo)
    return (signs * q * scale).to(w.dtype)


def _as_stack(w: torch.Tensor, lead: int, m: int):
    """(B, K, C) view of ``w`` — ``lead`` leading stack axes, then K (the
    reduction axis), then anything flattened into columns — with K padded
    with zeros to a multiple of ``m``. Returns (stack, K)."""
    b = 1
    for d in w.shape[:lead]:
        b *= d
    k = w.shape[lead]
    w3 = w.reshape(b, k, -1)
    if k % m:
        w3 = torch.nn.functional.pad(w3, (0, 0, 0, (-k) % m))
    return w3, k


def fake_quant(w: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    """Quantize-dequantize ``w`` under ``cfg`` (no packing).

    Accepts any tensor whose *leading* axis is the reduction dim; trailing
    axes are flattened into columns and K is zero-padded to a multiple of
    the group size, as in the reference."""
    if cfg.method == "none":
        return w
    w3, k = _as_stack(w, 0, cfg.group_size)
    return _fake_quant_impl(w3, cfg)[:, :k].reshape(w.shape)


def fake_quant_stack(w: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    """:func:`fake_quant` of every ``w[i]`` on its own (its own scale, its
    own column schedule): the reference's ``jax.vmap(fake_quant)`` over a
    stack of layers or experts, in one selection pass."""
    if cfg.method == "none":
        return w
    w3, k = _as_stack(w, 1, cfg.group_size)
    return _fake_quant_impl(w3, cfg)[:, :k].reshape(w.shape)


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


def rmse(w: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean((w - q) ** 2))


def act_truncate(a: torch.Tensor, n_shifts: int, bits: int = 8) -> torch.Tensor:
    """Layer-wise activation LSB truncation baseline (paper §5).

    Quantizes activations to ``bits`` then zeroes the lowest ``bits-n``
    bits (one scale for the whole tensor)."""
    maxq = float(2 ** bits - 1)
    amax = torch.clamp_min(torch.amax(torch.abs(a)), 1e-12)
    scale = amax * _recip(maxq)
    mags = torch.clamp(torch.round(torch.abs(a) / scale), 0.0, maxq)
    step = float(2 ** (bits - n_shifts))
    mags = torch.floor(mags / step) * step
    return (torch.sign(a) * mags * scale).to(a.dtype)
