"""SWIS filter scheduling (paper §4.3) — exact offline scheduler (port of
``repro.core.scheduling``).

Two phases, faithful to the paper:

1. **Greedy demotion.** All filters (output columns) start one level above
   the target. Repeatedly compute the MSE++ cost *increase* of demoting each
   filter by one shift, demote the ``n_demote`` cheapest, recompute, until
   the layer-average number of shifts equals the target.

2. **Systolic-group snapping.** Filters sorted by assigned shift count are
   partitioned into groups of ``sa_cols`` filters that the systolic array
   schedules simultaneously — all filters in a group must share a shift
   count. We enumerate nondecreasing per-group shift sequences that meet the
   layer-average budget and pick the sequence with the lowest total MSE++.

Runs offline in numpy on the host, as the reference does; the output feeds
:func:`repro_torch.core.swis.quantize` column assignments and the packer.

The reference scores every sequence of
``itertools.combinations_with_replacement(levels, n_groups)`` in a Python
loop: C(n_groups + L - 1, L - 1) sequences (67,525 for 72 groups on 4
levels, 1,216,865 for 192). This port walks the same sequences in the same
order as count vectors (how many groups sit at each level), keeps those
that meet the budget, and sums each kept sequence's group costs left to
right in the costs' type as the reference's loop does, so the chosen sequence,
ties included, and its cost are the reference's. Phase 1 computes every
column's demotion penalty with one array operation per shift level instead
of one Python step per column; the values, and so the ``argsort``, are the
reference's.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Sequence

import numpy as np


@dataclasses.dataclass
class Schedule:
    col_shifts: np.ndarray  # (C,) per-column shift counts (original order)
    order: np.ndarray  # (C,) column permutation (sorted by shifts)
    group_shifts: np.ndarray  # (n_groups,) shift count per systolic group
    total_cost: float
    effective_shifts: float


def _check_costs(costs: dict[int, np.ndarray]) -> Sequence[int]:
    levels = sorted(costs)
    c = len(next(iter(costs.values())))
    for n in levels:
        if len(costs[n]) != c:
            raise ValueError("cost arrays must share column count")
    return levels


def greedy_demotion(
    costs: dict[int, np.ndarray],
    target: float,
    *,
    n_demote: int = 1,
    step: int = 1,
) -> np.ndarray:
    """Phase 1: per-filter shift counts averaging to ``target``.

    ``costs[n][c]`` is the layer MSE++ of column ``c`` quantized with ``n``
    shifts. ``step`` is 2 for double-shift PEs (even counts only).
    """
    levels = _check_costs(costs)
    c = len(costs[levels[0]])
    hi = min(lv for lv in levels if lv >= target + (step - 1e-9)) if any(
        lv >= target + step - 1e-9 for lv in levels
    ) else max(levels)
    cur = np.full(c, hi, np.int64)
    lo = min(levels)
    total_budget = target * c
    demotions_needed = int(round((cur.sum() - total_budget) / step))
    arrs = {n: np.asarray(costs[n]) for n in levels}
    dtype = np.result_type(*arrs.values())
    for _ in range(max(demotions_needed, 0)):
        cand = cur - step >= lo
        if not cand.any():
            break
        # costs[max(n - step, lo)][i] - costs[n][i] for every column i, one
        # array operation per distinct current level
        delta = np.empty(c, dtype)
        for n in np.unique(cur):
            at = cur == n
            n = int(n)
            delta[at] = arrs[max(n - step, lo)][at] - arrs[n][at]
        penalty = np.where(cand, delta, np.inf)
        order = np.argsort(penalty)
        for idx in order[:n_demote]:
            if cur[idx] - step >= lo and cur.sum() - step >= total_budget:
                cur[idx] -= step
    return cur


@functools.lru_cache(maxsize=None)
def _count_vectors(total: int, n_levels: int) -> np.ndarray:
    """Every way to put ``total`` groups on ``n_levels`` levels, as counts
    (rows of shape (n_levels,)), in the order
    ``itertools.combinations_with_replacement`` yields the matching
    nondecreasing sequences: the first count descending, then the second,
    and so on."""
    return np.concatenate(list(_count_blocks(total, n_levels)))


def _count_blocks(total: int, n_levels: int):
    """:func:`_count_vectors` in blocks, one a value of the first count
    (descending)."""
    if n_levels == 1:
        yield np.array([[total]], np.int64)
        return
    for first in range(total, -1, -1):
        rest = _count_vectors(total - first, n_levels - 1)
        yield np.concatenate(
            [np.full((len(rest), 1), first, np.int64), rest], axis=1)


def _budget_sequences(levels, n_groups: int, sa_cols: int, budget: float):
    """The count vectors of every nondecreasing sequence over ``levels`` of
    length ``n_groups`` whose group-weighted sum is within 1e-6 of
    ``budget``, in enumeration order. Filtered a block at a time, so at
    most C(n_groups + L - 2, L - 2) vectors are held at once."""
    lv = np.asarray(levels)
    return np.concatenate([
        b[np.abs((b @ lv) * sa_cols - budget) <= 1e-6]
        for b in _count_blocks(n_groups, len(levels))])


def n_sequences(n_groups: int, n_levels: int) -> int:
    """How many nondecreasing sequences the exact enumeration visits."""
    return math.comb(n_groups + n_levels - 1, n_levels - 1)


def snap_to_groups(
    col_shifts: np.ndarray,
    costs: dict[int, np.ndarray],
    target: float,
    *,
    sa_cols: int,
    step: int = 1,
) -> Schedule:
    """Phase 2: enforce a uniform shift count per systolic group.

    Sorts columns by phase-1 shift count, then enumerates nondecreasing
    per-group sequences with the required average and picks the cheapest
    (the first in enumeration order on a tie).
    """
    levels = sorted(costs)
    c = len(col_shifts)
    if c % sa_cols:
        raise ValueError(f"column count {c} not divisible by sa_cols {sa_cols}")
    n_groups = c // sa_cols
    order = np.argsort(col_shifts, kind="stable")
    budget = target * c

    # each group's cost at each level, summed as the reference sums it
    group_cost = np.array([[costs[n][order[g * sa_cols:(g + 1) * sa_cols]]
                            .sum() for g in range(n_groups)]
                           for n in levels])  # (L, n_groups)
    counts = _budget_sequences(levels, n_groups, sa_cols, budget)
    best_seq, best_cost = None, np.inf
    if len(counts):
        # level index of every group of every kept sequence
        edges = np.cumsum(counts, axis=1)[:, :-1]  # (S, L - 1)
        g = np.arange(n_groups)
        idx = (g[None, :, None] >= edges[:, None, :]).sum(-1)  # (S, n_groups)
        cost = np.zeros(len(counts), group_cost.dtype)
        for j in range(n_groups):  # left to right, as the reference adds
            cost = cost + group_cost[idx[:, j], j]
        # the reference keeps a sequence only if its cost < the best so
        # far, starting from inf: NaN and inf costs are never chosen
        cost = np.where(np.isnan(cost), np.inf, cost)
        pick = int(np.argmin(cost))  # the first minimum
        if cost[pick] < np.inf:
            best_cost = cost[pick]
            best_seq = tuple(levels[i] for i in idx[pick])

    if best_seq is None:
        # Fall back to the uniform ceiling level (target not representable).
        lvl = min((lv for lv in levels if lv >= target),
                  default=max(levels))
        best_seq = tuple([lvl] * n_groups)
        best_cost = sum(costs[lvl][order].sum() for _ in range(1)) * 1.0

    out = np.zeros(c, np.int64)
    for g, n in enumerate(best_seq):
        out[order[g * sa_cols : (g + 1) * sa_cols]] = n
    return Schedule(
        col_shifts=out,
        order=order,
        group_shifts=np.asarray(best_seq, np.int64),
        total_cost=float(best_cost),
        effective_shifts=float(out.mean()),
    )


def schedule_layer(
    cost_fn: Callable[[int], np.ndarray],
    target: float,
    *,
    levels: Sequence[int],
    sa_cols: int = 8,
    double_shift: bool = False,
    n_demote: int = 1,
) -> Schedule:
    """End-to-end §4.3 scheduling for one layer.

    ``cost_fn(n)`` returns per-column MSE++ at shift count ``n``.
    """
    step = 2 if double_shift else 1
    if double_shift:
        levels = [lv for lv in levels if lv % 2 == 0]
    costs = {n: np.asarray(cost_fn(n), np.float64) for n in levels}
    phase1 = greedy_demotion(costs, target, n_demote=n_demote, step=step)
    return snap_to_groups(phase1, costs, target, sa_cols=sa_cols, step=step)

