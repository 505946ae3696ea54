"""Port parity of the exact offline filter scheduler (paper §4.3): every
field of ``schedule_layer``'s ``Schedule`` (``col_shifts``, ``order``,
``group_shifts``, ``total_cost``, ``effective_shifts``) equals the JAX
package's exactly, ties and the fallback branch included. The port walks
the reference's ``combinations_with_replacement`` order as count vectors
and sums each sequence left to right, so the choice on a tie and the cost
are the reference's; the cases here include integer costs with many ties.
The reference's own invariants hold in the port."""
import numpy as np
import pytest
import torch

from repro_torch.core import scheduling, swis

pytest.importorskip("jax")  # the card's test environment has no JAX
import jax.numpy as jnp  # noqa: E402
from repro.core import scheduling as jscheduling  # noqa: E402
from repro.core import swis as jswis  # noqa: E402


def _costs(rng, c=32, levels=(1, 2, 3, 4, 5)):
    # the reference test's synthetic costs, strictly decreasing in n
    base = rng.random(c) * 10 + 1
    return {n: base * (0.5 ** n) for n in levels}


def _assert_same(got, want):
    np.testing.assert_array_equal(got.col_shifts, want.col_shifts)
    np.testing.assert_array_equal(got.order, want.order)
    np.testing.assert_array_equal(got.group_shifts, want.group_shifts)
    assert got.group_shifts.dtype == want.group_shifts.dtype
    assert got.col_shifts.dtype == want.col_shifts.dtype
    assert got.total_cost == want.total_cost
    assert got.effective_shifts == want.effective_shifts


def _both(costs, target, **kw):
    want = jscheduling.schedule_layer(lambda n: costs[n], target, **kw)
    got = scheduling.schedule_layer(lambda n: costs[n], target, **kw)
    _assert_same(got, want)
    return got


@pytest.mark.parametrize("target", [2.0, 2.5, 3.0])
def test_synthetic_costs_equal_the_reference(target):
    costs = _costs(np.random.default_rng(0))
    _both(costs, target, levels=[1, 2, 3, 4, 5], sa_cols=8)


def test_heterogeneous_sensitivity_equals_the_reference():
    sens = np.concatenate([np.full(16, 0.1), np.full(16, 10.0)])
    costs = {n: sens * (0.5 ** n) for n in (1, 2, 3, 4, 5)}
    _both(costs, 3.0, levels=[1, 2, 3, 4, 5], sa_cols=8)


@pytest.mark.parametrize("target", [3.0, 4.5])
def test_double_shift_equals_the_reference(target):
    rng = np.random.default_rng(1)
    costs = {n: _costs(rng, levels=(2, 4, 6))[n] for n in (2, 4, 6)}
    sched = _both(costs, target, levels=[2, 4, 6], sa_cols=8,
                  double_shift=True)
    assert set(np.unique(sched.col_shifts)) <= {2, 4, 6}


@pytest.mark.parametrize("target,c,sa", [(3.25, 8, 8), (2.3, 16, 8),
                                         (7.0, 32, 8)])
def test_unrepresentable_target_takes_the_fallback(target, c, sa):
    """No nondecreasing group sequence meets the budget: both packages
    fall back to the uniform ceiling level (or the top level)."""
    costs = _costs(np.random.default_rng(2), c=c, levels=(1, 2, 3, 4, 5))
    sched = _both(costs, target, levels=[1, 2, 3, 4, 5], sa_cols=sa)
    assert len(set(sched.group_shifts.tolist())) == 1


@pytest.mark.parametrize("seed", range(6))
def test_tied_integer_costs_equal_the_reference(seed):
    """Integer costs in {0, 1, 2} tie almost everywhere: the sequence
    chosen among equal costs is the first the reference enumerates, and
    phase 1's argsort sees the same penalties."""
    rng = np.random.default_rng(10 + seed)
    c = int(rng.choice([16, 32, 48]))
    levels = [1, 2, 3, 4]
    costs = {n: rng.integers(0, 3, c).astype(float) for n in levels}
    for target in (1.5, 2.0, 2.5, 3.25):
        for n_demote in (1, 3):
            _both(costs, target, levels=levels, sa_cols=8, n_demote=n_demote)
    flat = {n: np.ones(c) for n in levels}
    _both(flat, 2.5, levels=levels, sa_cols=8)


def test_phases_equal_the_reference_on_float32_costs():
    """Called directly on float32 costs, both phases keep the costs' type
    (the reference adds numpy float32 scalars)."""
    rng = np.random.default_rng(3)
    costs = {n: rng.random(32).astype(np.float32) * 3 for n in (1, 2, 3)}
    for target in (1.5, 2.0, 2.25):
        want1 = jscheduling.greedy_demotion(costs, target)
        got1 = scheduling.greedy_demotion(costs, target)
        np.testing.assert_array_equal(got1, want1)
        _assert_same(
            scheduling.snap_to_groups(got1, costs, target, sa_cols=4),
            jscheduling.snap_to_groups(want1, costs, target, sa_cols=4))


def test_column_costs_of_a_weight_equal_the_reference():
    """Costs from each package's ``_column_costs`` on one seeded (256, 64)
    weight are equal, and so are the schedules at the paper-table settings
    (levels 1-4 at 2.5, 2-4 at 3.0, ``sa_cols`` 8); the port's cost
    function may return a CPU tensor."""
    w = np.random.default_rng(4).normal(0, 0.05, (256, 64)).astype(np.float32)
    jq, tq = (jswis.QuantConfig(n_shifts=3, group_size=4),
              swis.QuantConfig(n_shifts=3, group_size=4))
    jm, js, _ = jswis._to_int_domain(jnp.asarray(w), 8, False)
    tm, ts, _ = swis._to_int_domain(torch.from_numpy(w), 8, False)
    jcost = {n: np.asarray(jswis._column_costs(jm, js, n, jq)[1])
             for n in (1, 2, 3, 4)}
    tcost = {n: swis._column_costs(tm, ts, n, tq)[1] for n in (1, 2, 3, 4)}
    for n in jcost:
        np.testing.assert_array_equal(tcost[n].numpy(), jcost[n])
    for target, levels in ((2.5, [1, 2, 3, 4]), (3.0, [2, 3, 4])):
        want = jscheduling.schedule_layer(lambda n: jcost[n], target,
                                          levels=levels, sa_cols=8)
        got = scheduling.schedule_layer(lambda n: tcost[n], target,
                                        levels=levels, sa_cols=8)
        _assert_same(got, want)
        assert got.effective_shifts == target
    assert got.total_cost <= float(jcost[3].astype(np.float64).sum())


def test_sequence_count():
    assert scheduling.n_sequences(72, 4) == 67525
    assert scheduling.n_sequences(192, 4) == 1216865


# -- the reference's invariants (tests/test_scheduling.py), in the port -----

def test_average_hits_target():
    costs = _costs(np.random.default_rng(5))
    for target in (2.0, 2.5, 3.0):
        sched = scheduling.schedule_layer(
            lambda n: costs[n], target, levels=[1, 2, 3, 4, 5], sa_cols=8)
        assert abs(sched.effective_shifts - target) < 1e-9


def test_groups_uniform_and_nondecreasing():
    costs = _costs(np.random.default_rng(6))
    sched = scheduling.schedule_layer(
        lambda n: costs[n], 2.5, levels=[1, 2, 3, 4, 5], sa_cols=8)
    gs = sched.group_shifts
    assert list(gs) == sorted(gs)
    for g in range(len(gs)):
        cols = sched.order[g * 8:(g + 1) * 8]
        assert len(set(sched.col_shifts[cols])) == 1


def test_scheduling_beats_uniform():
    sens = np.concatenate([np.full(16, 0.1), np.full(16, 10.0)])
    costs = {n: sens * (0.5 ** n) for n in (1, 2, 3, 4, 5)}
    sched = scheduling.schedule_layer(
        lambda n: costs[n], 3.0, levels=[1, 2, 3, 4, 5], sa_cols=8)
    assert sched.total_cost <= costs[3].sum() + 1e-9


def test_double_shift_levels():
    rng = np.random.default_rng(7)
    costs = {n: _costs(rng, levels=(2, 4, 6))[n] for n in (2, 4, 6)}
    sched = scheduling.schedule_layer(
        lambda n: costs[n], 3.0, levels=[2, 4, 6], sa_cols=8,
        double_shift=True)
    assert set(np.unique(sched.col_shifts)) <= {2, 4, 6}
    assert abs(sched.effective_shifts - 3.0) < 1e-9
