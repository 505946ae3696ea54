"""SWIS shift selection (paper §4.1): per-group support-vector enumeration.

PyTorch port of ``repro.core.selection``. A *group* is ``M`` weights along
the reduction dimension that share a support vector of ``N`` bit positions
out of ``B`` underlying bits. For every candidate support vector each weight
magnitude is quantized to the nearest representable subset-sum and the group
is scored with MSE++ (Eq. 12):

    MSE++ = alpha * (sum_i sign_i * (|w_i| - |q_i|))^2 + sum_i (|w_i| - |q_i|)^2

Costs are integer-valued and exact in float32, so the port reproduces the
reference's choices bit for bit as long as the tie rules match: the first
minimum over combos wins (``cost < best``), a magnitude halfway between two
candidates rounds down (``<=``), and ``searchsorted`` is left-sided. The
candidate tables are the reference's numpy tables (stable argsort).
"""
from __future__ import annotations

import functools
from itertools import combinations

import numpy as np
import torch

VARIANTS = ("swis", "swis_c", "trunc")


@functools.lru_cache(maxsize=None)
def support_combos(n_shifts: int, bits: int = 8, variant: str = "swis") -> np.ndarray:
    """All candidate support vectors, shape (C, N), ascending bit positions."""
    if n_shifts <= 0 or n_shifts > bits:
        raise ValueError(f"n_shifts must be in [1, {bits}], got {n_shifts}")
    if variant == "swis":
        combos = list(combinations(range(bits), n_shifts))
    elif variant == "swis_c":
        combos = [tuple(range(o, o + n_shifts)) for o in range(bits - n_shifts + 1)]
    elif variant == "trunc":
        # layer-wise static: the fixed MSB window (LSB truncation).
        combos = [tuple(range(bits - n_shifts, bits))]
    else:
        raise ValueError(f"unknown variant {variant!r}")
    return np.asarray(combos, dtype=np.int32)


@functools.lru_cache(maxsize=None)
def combo_candidates(n_shifts: int, bits: int = 8, variant: str = "swis") -> np.ndarray:
    """Subset sums for every combo, shape (C, 2**N).

    Candidate ``k`` of combo ``c`` has value ``sum_j ((k >> j) & 1) * 2**s_cj``
    so the candidate index *is* the mask-bit pattern.
    """
    combos = support_combos(n_shifts, bits, variant)
    n = combos.shape[1]
    ks = np.arange(2 ** n, dtype=np.int64)
    sel = (ks[None, :, None] >> np.arange(n)[None, None, :]) & 1  # (1, K, N)
    vals = (sel * (2 ** combos.astype(np.int64))[:, None, :]).sum(-1)  # (C, K)
    return vals.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _sorted_candidates(n_shifts: int, bits: int, variant: str):
    """Sorted candidate values + the mask index that produced each, per combo."""
    cand = combo_candidates(n_shifts, bits, variant)  # (C, K)
    order = np.argsort(cand, axis=1, kind="stable")
    return np.take_along_axis(cand, order, axis=1), order.astype(np.int32)


def _nearest_sorted(cand_sorted: torch.Tensor, mags: torch.Tensor):
    """Nearest value in a sorted 1-D candidate tensor for each magnitude.

    Returns (quantized values, index into the *sorted* tensor).
    """
    k = cand_sorted.shape[0]
    idx = torch.searchsorted(cand_sorted, mags).clamp_(1, k - 1)
    lo = cand_sorted[idx - 1]
    hi = cand_sorted[idx]
    take_lo = (mags - lo) <= (hi - mags)
    q = torch.where(take_lo, lo, hi)
    j = torch.where(take_lo, idx - 1, idx)
    return q, j


def _group_cost(mags, signs, q, alpha):
    """MSE++ over the last axis (the group axis), Eq. 12 (up to the 1/M
    factor, which does not change the argmin)."""
    err = mags - q
    signed = torch.sum(signs * err, dim=-1)
    return alpha * signed * signed + torch.sum(err * err, dim=-1)


def select_shifts_scan(mags: torch.Tensor, signs: torch.Tensor, *,
                       n_shifts: int, bits: int = 8, variant: str = "swis",
                       alpha: float = 1.0):
    """Running-min selection over the combo table.

    Args:
      mags:  (..., M) float32 integer-domain magnitudes in [0, 2**bits - 1].
      signs: (..., M) float32 in {-1, +1}.

    Returns dict (leading batch dims preserved): ``qmags`` (..., M),
    ``shifts`` (..., N) int32 ascending bit positions, ``masks`` (..., M)
    int32 mask-bit patterns, ``combo`` None, ``cost`` (...) float32.
    """
    cand_sorted_np, order_np = _sorted_candidates(n_shifts, bits, variant)
    combos_np = support_combos(n_shifts, bits, variant)
    dev = mags.device
    cand_sorted = torch.from_numpy(cand_sorted_np).to(dev)
    order = torch.from_numpy(order_np).to(dev)
    combos = torch.from_numpy(combos_np).to(dev)
    mags = mags.contiguous()
    lead = mags.shape[:-1]
    n = combos_np.shape[1]

    best_cost = torch.full(lead, float("inf"), dtype=torch.float32, device=dev)
    q = torch.zeros(mags.shape, dtype=torch.float32, device=dev)
    masks = torch.zeros(mags.shape, dtype=torch.int32, device=dev)
    shifts = torch.zeros(lead + (n,), dtype=torch.int32, device=dev)
    for c in range(combos_np.shape[0]):
        qi, jpos = _nearest_sorted(cand_sorted[c], mags)
        cost = _group_cost(mags, signs, qi, alpha)
        better = cost < best_cost
        best_cost = torch.where(better, cost, best_cost)
        q = torch.where(better[..., None], qi, q)
        masks = torch.where(better[..., None], order[c][jpos], masks)
        shifts = torch.where(better[..., None], combos[c], shifts)
    return {"qmags": q, "shifts": shifts, "masks": masks, "combo": None,
            "cost": best_cost}


def quantize_grouped(mags: torch.Tensor, signs: torch.Tensor, *,
                     n_shifts: int, group_size: int, bits: int = 8,
                     variant: str = "swis", alpha: float = 1.0,
                     chunk_elems: int = 1 << 22):
    """Group a (K, C) magnitude matrix along K and run selection.

    Group g of column c is ``mags[g*M:(g+1)*M, c]`` (depth-wise grouping,
    paper §3.2). Selection is elementwise per group, so chunking along the
    K//M axis only bounds memory and never changes a result.

    Returns dict shaped back to the matrix layout:
      qmags (K, C), masks (K, C), shifts (K//M, C, N), cost (K//M, C).
    """
    K, C = mags.shape
    M = group_size
    if K % M:
        raise ValueError(f"reduction dim {K} not divisible by group size {M}")
    kg = K // M
    g_mags = mags.reshape(kg, M, C).permute(0, 2, 1)
    g_signs = signs.reshape(kg, M, C).permute(0, 2, 1)
    chunk_kg = max(int(chunk_elems) // max(C * M, 1), 1)
    outs = [select_shifts_scan(g_mags[i:i + chunk_kg], g_signs[i:i + chunk_kg],
                               n_shifts=n_shifts, bits=bits, variant=variant,
                               alpha=alpha)
            for i in range(0, kg, chunk_kg)]
    out = {key: torch.cat([o[key] for o in outs]) if len(outs) > 1
           else outs[0][key] for key in ("qmags", "masks", "shifts", "cost")}
    return {
        "qmags": out["qmags"].permute(0, 2, 1).reshape(K, C),
        "masks": out["masks"].permute(0, 2, 1).reshape(K, C),
        "shifts": out["shifts"],
        "combo": None,
        "cost": out["cost"],
    }
