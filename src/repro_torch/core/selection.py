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

:func:`select_shifts_scan` is the running-min selection that packing uses;
:func:`select_qmags` is its in-graph (fake-quant) form, which carries only
the quantized magnitudes and the cost; :func:`select_shifts` is the
reference's whole-table enumeration and :func:`select_shifts_bruteforce`
its numpy oracle (small inputs only).
"""
from __future__ import annotations

import functools
from itertools import combinations

import numpy as np
import torch

VARIANTS = ("swis", "swis_c", "trunc")

# passes of the in-graph selection (:func:`select_qmags`): "calls" counts
# chunks, "combos" the candidate support vectors they scanned; a QAT step
# reads them to report what its selection launched
PASSES = {"calls": 0, "combos": 0}


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


def _tables(n_shifts: int, bits: int, variant: str, dev):
    cand_sorted_np, order_np = _sorted_candidates(n_shifts, bits, variant)
    combos_np = support_combos(n_shifts, bits, variant)
    return (torch.from_numpy(cand_sorted_np).to(dev),
            torch.from_numpy(order_np).to(dev),
            torch.from_numpy(combos_np).to(dev))


def select_qmags(mags: torch.Tensor, signs: torch.Tensor, *, n_shifts: int,
                 bits: int = 8, variant: str = "swis", alpha: float = 1.0,
                 chunk_elems: int = 1 << 24):
    """:func:`select_shifts_scan`'s ``qmags`` and ``cost`` alone, for the
    fake-quant path, which needs neither masks nor shifts (the reference's
    jit drops them from its graph). ``mags``/``signs`` (G, ..., M) are
    chunked along G so that a pass holds at most ``chunk_elems``
    magnitudes; selection is per group, so chunking changes no result."""
    cand_sorted, _, _ = _tables(n_shifts, bits, variant, mags.device)
    n_combos = cand_sorted.shape[0]
    per_row = max(mags[0].numel(), 1)
    step = max(int(chunk_elems) // per_row, 1)
    qs, costs = [], []
    for i in range(0, mags.shape[0], step):
        m, s = mags[i:i + step].contiguous(), signs[i:i + step]
        best = torch.full(m.shape[:-1], float("inf"), dtype=torch.float32,
                          device=m.device)
        q = torch.zeros(m.shape, dtype=torch.float32, device=m.device)
        for c in range(n_combos):
            qi, _ = _nearest_sorted(cand_sorted[c], m)
            cost = _group_cost(m, s, qi, alpha)
            better = cost < best
            best = torch.where(better, cost, best)
            q = torch.where(better[..., None], qi, q)
        qs.append(q)
        costs.append(best)
        PASSES["calls"] += 1
        PASSES["combos"] += n_combos
    if len(qs) == 1:
        return qs[0], costs[0]
    return torch.cat(qs), torch.cat(costs)


def select_shifts(mags: torch.Tensor, signs: torch.Tensor, *, n_shifts: int,
                  bits: int = 8, variant: str = "swis", alpha: float = 1.0):
    """Exact enumeration over support vectors for grouped magnitudes: the
    cost of every combo at once, the first minimum, then the winner's
    nearest candidates (first minimum of the distance, i.e. the lower
    candidate on a tie).

    Args: ``mags`` (..., M) float32 integer-domain magnitudes, ``signs``
    (..., M) in {-1, +1}. Returns dict: ``qmags`` (..., M), ``shifts``
    (..., N) int32, ``masks`` (..., M), ``combo`` (...) and ``cost`` (...).
    """
    cand_sorted, order, combos = _tables(n_shifts, bits, variant,
                                         mags.device)
    costs = torch.stack([_group_cost(mags, signs,
                                     _nearest_sorted(cs, mags)[0], alpha)
                         for cs in cand_sorted])  # (C, ...)
    best_cost = torch.amin(costs, dim=0)
    best = torch.argmin(costs, dim=0)  # the first minimum, as jnp.argmin
    cs_best = cand_sorted[best]  # (..., K)
    d = torch.abs(mags[..., None] - cs_best[..., None, :])  # (..., M, K)
    jpos = torch.argmin(d, dim=-1)
    qmags = torch.gather(cs_best, -1, jpos)
    masks = torch.gather(order[best], -1, jpos)
    return {"qmags": qmags, "shifts": combos[best], "masks": masks,
            "combo": best.to(torch.int32), "cost": best_cost}


def select_shifts_bruteforce(mags: np.ndarray, signs: np.ndarray, *,
                             n_shifts: int, bits: int = 8,
                             variant: str = "swis", alpha: float = 1.0):
    """Reference oracle in numpy: materializes every (combo, mask) pair.
    ``mags``/``signs`` (G, M). Small inputs only."""
    cand = combo_candidates(n_shifts, bits, variant)  # (C, K)
    g, m = mags.shape
    d = np.abs(mags[:, None, :, None] - cand[None, :, None, :])  # (G,C,M,K)
    kbest = np.argmin(d, axis=-1)  # (G, C, M)
    q = np.take_along_axis(
        np.broadcast_to(cand[None, :, None, :], d.shape), kbest[..., None],
        axis=-1)[..., 0]
    err = mags[:, None, :] - q
    signed = (signs[:, None, :] * err).sum(-1)
    cost = alpha * signed ** 2 + (err ** 2).sum(-1)  # (G, C)
    best = cost.argmin(axis=1)
    ar = np.arange(g)
    combos = support_combos(n_shifts, bits, variant)
    return {"qmags": q[ar, best], "shifts": combos[best],
            "masks": kbest[ar, best], "combo": best, "cost": cost[ar, best]}


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
