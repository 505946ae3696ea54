"""Cross-layer shift-budget allocation (beyond-paper extension of §4.3):
PyTorch port of ``repro.core.budget``.

The paper schedules shift counts across *filters within one layer*. The same
marginal-cost greedy extends across *layers*: under a global parameter-
weighted average-shift budget, layers that are cheap to demote (low weight-
space MSE++ increase per saved bit) give up shifts so sensitive layers keep
them. This is the knapsack-greedy on marginal returns:

  1. profile: for every eligible GEMM weight, weight-space MSE++ at each
     candidate shift count (scale^2 folds the int-domain cost back to
     weight space so layers are comparable);
  2. allocate: start every tensor at max(levels); repeatedly demote the
     tensor with the smallest  d(cost) / d(bits saved)  until the
     parameter-weighted average hits the target;
  3. apply: per-tensor QuantConfig overrides (PTQ or QAT).

The profile and the quantized tree are computed on the tree's device.
Selection costs are integers in float32. The reference sums a unit's
group costs in float32 (per column, then over the columns), which is exact
while every partial sum stays under 2**24, as at smoke sizes. At full
width the level-1 sums pass 2**24 and float32 sums then depend on the
order of the additions: smollm-135m's float32 level-1 sums can differ
in their last bits between the card and the CPU. The port sums the group costs in
float64 instead, which is exact in any order: it equals the reference's
float32 sum wherever that one is exact, and gives the same value on every
device. ``allocate`` is pure Python:
its heap breaks ties by comparing unit paths, tuples of the tree's ``str``
keys and an ``int`` unit index, which the port's trees share with the
reference's.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.swis import (QuantConfig, _column_costs, _to_int_domain,
                                   fake_quant)


_NAMES = ("w", "wi", "wo", "wg", "shared_wi", "shared_wo", "shared_wg")


def _budget_eligible(path, arr) -> bool:
    # fake-quant pads K, so (unlike bit-plane packing) no K%32 constraint
    if len(arr.shape) < 2 or str(path[-1]) not in _NAMES:
        return False
    joined = "/".join(str(p) for p in path)
    return not ("embed" in joined or "router" in joined
                or "frontend" in joined)


def _eligible_leaves(params) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    out = []

    def walk(path, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(path + (k,), v)
            return
        if _budget_eligible(path, node):
            out.append((path, node))

    walk((), params)
    return out


def sensitivity_profile(
    params,
    qcfg: QuantConfig,
    levels: Sequence[int] = (1, 2, 3, 4, 5),
) -> Dict[Tuple, Dict[int, float]]:
    """Weight-space MSE++ at each shift count, per allocation unit.

    Stacked leaves (scan-over-layers: (L, K, C) / (L, E, K, C)) are
    unstacked so every layer (and expert) gets its own unit — the
    cross-layer analogue of the paper's per-filter granularity. Selection
    runs in chunks of groups (``selection.quantize_grouped``), which bounds
    its working set at full width and changes no cost.
    """
    profile: Dict[Tuple, Dict[int, float]] = {}
    for path, w in _eligible_leaves(params):
        w = w.float()
        units = ([(path, w)] if w.ndim == 2 else
                 [(path + (i,), w.reshape(-1, *w.shape[-2:])[i])
                  for i in range(int(np.prod(w.shape[:-2])))])
        for upath, w2 in units:
            k = w2.shape[0]
            if k % qcfg.group_size:
                pad = (-k) % qcfg.group_size
                w2 = torch.nn.functional.pad(w2, (0, 0, 0, pad))
            mags, signs, scale = _to_int_domain(w2, qcfg.bits,
                                                qcfg.per_channel)
            costs = {}
            for n in levels:
                out, _ = _column_costs(mags, signs, n, qcfg)
                # group costs are integers under 2**24 (at an integer
                # alpha): their float64 sum is exact, in any order
                total = float(out["cost"].sum(dtype=torch.float64))
                costs[n] = total * float(torch.mean(scale)) ** 2
            profile[upath] = costs
    return profile


@dataclasses.dataclass
class BudgetAllocation:
    shifts: Dict[Tuple[str, ...], int]
    effective_shifts: float
    total_cost: float


def allocate(
    profile: Dict[Tuple[str, ...], Dict[int, float]],
    sizes: Dict[Tuple[str, ...], int],
    target_avg: float,
    levels: Sequence[int] = (1, 2, 3, 4, 5),
) -> BudgetAllocation:
    """Greedy marginal-cost demotion to a parameter-weighted average."""
    levels = sorted(levels)
    hi = levels[-1]
    cur = {p: hi for p in profile}
    total_params = sum(sizes[p] for p in profile)
    budget_bits = target_avg * total_params

    def bits(assign):
        return sum(assign[p] * sizes[p] for p in profile)

    # heap of (marginal cost per saved bit, path)
    def push(heap, p):
        n = cur[p]
        idx = levels.index(n)
        if idx == 0:
            return
        lo = levels[idx - 1]
        d_cost = profile[p][lo] - profile[p][n]
        d_bits = (n - lo) * sizes[p]
        heapq.heappush(heap, (d_cost / max(d_bits, 1), p, n))

    heap: list = []
    for p in profile:
        push(heap, p)
    while bits(cur) > budget_bits and heap:
        _, p, n_at_push = heapq.heappop(heap)
        if cur[p] != n_at_push:
            continue  # stale entry
        idx = levels.index(cur[p])
        if idx == 0:
            continue
        lo = levels[idx - 1]
        # no-overshoot: accept a budget-crossing demotion only if it lands
        # closer to the target than staying put
        before = bits(cur)
        after = before - (cur[p] - lo) * sizes[p]
        if after < budget_bits and (budget_bits - after) >= (before - budget_bits):
            continue
        cur[p] = lo
        push(heap, p)

    total_cost = sum(profile[p][cur[p]] for p in profile)
    eff = bits(cur) / total_params
    return BudgetAllocation(shifts=cur, effective_shifts=eff,
                            total_cost=total_cost)


def quantize_with_allocation(params, qcfg: QuantConfig,
                             alloc: BudgetAllocation):
    """PTQ the tree with per-unit shift counts from an allocation.

    Every unit of a stacked leaf is fake-quantized as its own 2-D matrix
    (its own scale and column schedule), as the reference does; leaves that
    are not eligible, and units the allocation does not name, pass through
    unchanged."""

    def walk(path, node):
        if isinstance(node, dict):
            return {k: walk(path + (k,), v) for k, v in node.items()}
        if not _budget_eligible(path, node):
            return node
        if node.ndim == 2:
            if path not in alloc.shifts:
                return node
            return fake_quant(node, dataclasses.replace(
                qcfg, n_shifts=alloc.shifts[path]))
        lead = node.shape[:-2]
        flat = node.reshape(-1, *node.shape[-2:])
        slices = []
        for i in range(flat.shape[0]):
            n = alloc.shifts.get(path + (i,))
            slices.append(flat[i] if n is None else fake_quant(
                flat[i], dataclasses.replace(qcfg, n_shifts=n)))
        return torch.stack(slices).reshape(lead + node.shape[-2:])

    return walk((), params)


def leaf_sizes(params) -> Dict[Tuple, int]:
    sizes: Dict[Tuple, int] = {}
    for path, w in _eligible_leaves(params):
        if w.ndim == 2:
            sizes[path] = int(np.prod(w.shape))
        else:
            unit = int(np.prod(w.shape[-2:]))
            for i in range(int(np.prod(w.shape[:-2]))):
                sizes[path + (i,)] = unit
    return sizes
