"""Port parity of the cross-layer shift-budget allocator
(``repro_torch.core.budget``) against the JAX package's, in one process on
the same weights (the reference's params, built once and bridged): the
same allocation units, profile values within rel 1e-6 (the port sums
the integer group costs exactly, the reference in float32, which is exact
while under 2**24, as here), identical allocations,
``quantize_with_allocation`` bit-identical leaf for leaf, non-eligible
leaves untouched. phi3-mini-3.8b's smoke config as in
``tests/test_budget.py``, and qwen2-moe-a2.7b's for per-expert units of
(L, E, K, C) stacks. The reference's own checks hold in the port."""
import functools

import numpy as np
import pytest
import torch

from repro_torch.core import budget
from repro_torch.core.swis import QuantConfig

pytest.importorskip("jax")  # the card's test environment has no JAX
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import repro.configs as C  # noqa: E402
from repro.core import budget as jbudget  # noqa: E402
from repro.core.swis import QuantConfig as JQuantConfig  # noqa: E402
from repro.models import params as jpp  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch.bridge import from_jax_params  # noqa: E402

ARCHS = ["phi3-mini-3.8b", "qwen2-moe-a2.7b"]
LEVELS = (1, 2, 3, 4)
TARGETS = [1.5, 2.0, 2.5, 3.0]


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """Both packages' params, qcfgs, profiles and unit sizes."""
    cfg = C.get_smoke(arch).replace(compute_dtype="float32")
    jparams = jpp.init_params(JModel(cfg).build(), jax.random.key(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    kw = dict(method="swis", n_shifts=2, group_size=4)
    jq, tq = JQuantConfig(**kw), QuantConfig(**kw)
    jprof = jbudget.sensitivity_profile(jparams, jq, levels=LEVELS)
    tprof = budget.sensitivity_profile(tparams, tq, levels=LEVELS)
    return dict(jparams=jparams, tparams=tparams, jq=jq, tq=tq, jprof=jprof,
                tprof=tprof, jsizes=jbudget.leaf_sizes(jparams),
                tsizes=budget.leaf_sizes(tparams))


def _walk(jtree, ttree, fn, path=()):
    if isinstance(jtree, dict):
        assert list(jtree) == list(ttree), path
        for k in jtree:
            _walk(jtree[k], ttree[k], fn, path + (k,))
    else:
        fn(path, jtree, ttree)


@pytest.mark.parametrize("arch", ARCHS)
def test_units_and_sizes_equal_the_reference(arch):
    s = _setup(arch)
    assert list(s["tprof"]) == list(s["jprof"])
    assert s["tsizes"] == s["jsizes"]
    if arch == "qwen2-moe-a2.7b":  # per-expert units of a 4-D stack
        cfg = C.get_smoke(arch)
        experts = [p for p in s["tprof"] if "moe" in p and "wi" in p]
        assert len(experts) >= cfg.moe.n_experts


@pytest.mark.parametrize("arch", ARCHS)
def test_profile_equals_the_reference(arch):
    s = _setup(arch)
    for unit, want in s["jprof"].items():
        got = s["tprof"][unit]
        assert list(got) == list(want)
        for n in want:
            assert abs(got[n] - want[n]) <= 1e-6 * abs(want[n]), (unit, n)


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("arch", ARCHS)
def test_allocation_equals_the_reference(arch, target):
    s = _setup(arch)
    want = jbudget.allocate(s["jprof"], s["jsizes"], target, levels=LEVELS)
    got = budget.allocate(s["tprof"], s["tsizes"], target, levels=LEVELS)
    assert got.shifts == want.shifts
    assert got.effective_shifts == want.effective_shifts
    assert abs(got.total_cost - want.total_cost) <= 1e-6 * want.total_cost


@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_with_allocation_bit_identical(arch):
    """The same allocation applied by each package gives the same bits in
    every leaf; leaves that are not eligible are the input's own."""
    s = _setup(arch)
    alloc = jbudget.allocate(s["jprof"], s["jsizes"], 2.0, levels=LEVELS)
    want = jbudget.quantize_with_allocation(s["jparams"], s["jq"], alloc)
    got = budget.quantize_with_allocation(s["tparams"], s["tq"], alloc)
    changed = []

    def same(path, j, t):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), str(path))
        if not budget._budget_eligible(path, t):
            orig = s["tparams"]
            for k in path:
                orig = orig[k]
            assert t is orig, path
        else:
            orig = s["tparams"]
            for k in path:
                orig = orig[k]
            changed.append(not torch.equal(t, orig))

    _walk(want, got, same)
    assert changed and all(changed)


def _small_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "embed": {"w": rng.normal(0, 0.05, (32, 16)).astype(np.float32)},
        "norm": {"scale": np.ones(16, np.float32)},
        "proj": {"w": rng.normal(0, 0.05, (70, 33)).astype(np.float32)},
        "stack": {"wi": rng.normal(0, 0.05, (3, 2, 64, 24)).astype(
            np.float32)},
    }  # keys in sorted order, as jax.tree.map leaves them


@pytest.mark.parametrize("per_channel", [False, True])
def test_padded_and_per_channel_units_equal_the_reference(per_channel):
    """A K that is not a multiple of the group (zero-padded), per-channel
    scales and a 4-D stack: profile, allocation and quantized leaves equal
    the reference's."""
    tree = _small_tree()
    kw = dict(method="swis", n_shifts=3, group_size=4,
              per_channel=per_channel)
    jtree = jax.tree.map(jnp.asarray, tree)
    ttree = {k: {n: torch.from_numpy(a) for n, a in v.items()}
             for k, v in tree.items()}
    jprof = jbudget.sensitivity_profile(jtree, JQuantConfig(**kw))
    tprof = budget.sensitivity_profile(ttree, QuantConfig(**kw))
    assert list(tprof) == list(jprof) and len(tprof) == 7
    for unit in jprof:
        for n in jprof[unit]:
            assert abs(tprof[unit][n] - jprof[unit][n]) <= 1e-6 * abs(
                jprof[unit][n])
    sizes = jbudget.leaf_sizes(jtree)
    assert budget.leaf_sizes(ttree) == sizes
    alloc = jbudget.allocate(jprof, sizes, 2.5)
    assert budget.allocate(tprof, sizes, 2.5).shifts == alloc.shifts
    want = jbudget.quantize_with_allocation(jtree, JQuantConfig(**kw), alloc)
    got = budget.quantize_with_allocation(ttree, QuantConfig(**kw), alloc)
    _walk(want, got, lambda p, j, t: np.testing.assert_array_equal(
        t.numpy(), np.asarray(j), str(p)))


# -- the reference's checks (tests/test_budget.py), in the port alone --------

def test_profile_monotone():
    prof = _setup("phi3-mini-3.8b")["tprof"]
    assert len(prof) >= 5
    for costs in prof.values():
        vals = [costs[n] for n in sorted(costs)]
        assert all(a >= b - 1e-9 for a, b in zip(vals, vals[1:]))


@pytest.mark.parametrize("target", [1.5, 2.0, 3.0])
def test_allocation_hits_budget(target):
    s = _setup("phi3-mini-3.8b")
    alloc = budget.allocate(s["tprof"], s["tsizes"], target_avg=target,
                            levels=LEVELS)
    assert abs(alloc.effective_shifts - target) < 0.5
    assert all(n in LEVELS for n in alloc.shifts.values())


def test_allocation_cost_between_uniform_neighbours():
    s = _setup("phi3-mini-3.8b")
    alloc = budget.allocate(s["tprof"], s["tsizes"], target_avg=2.5,
                            levels=LEVELS)
    c2 = sum(c[2] for c in s["tprof"].values())
    c3 = sum(c[3] for c in s["tprof"].values())
    assert c3 - 1e-9 <= alloc.total_cost <= c2 + 1e-9


def test_quantize_with_allocation_applies():
    s = _setup("phi3-mini-3.8b")
    alloc = budget.allocate(s["tprof"], s["tsizes"], target_avg=2.0,
                            levels=LEVELS)
    qp = budget.quantize_with_allocation(s["tparams"], s["tq"], alloc)
    w0 = s["tparams"]["blocks"]["sub0_attn"]["mlp"]["wi"]["w"]
    w1 = qp["blocks"]["sub0_attn"]["mlp"]["wi"]["w"]
    assert float((w0 - w1).abs().max()) > 0
    assert torch.equal(s["tparams"]["embed"]["tok"], qp["embed"]["tok"])
