"""Port parity: the MoE family. ``moe_apply`` of the port against the JAX
``repro.models.moe.moe_apply`` on bridged params — the decode branch (S =
1, dropless dispatch over every expert), the capacity branch over several
groups, its one-group fallback, and a case at the default capacity factor
that drops tokens — with packed (SWIS expert stacks) and unpacked leaves,
fp32 compute, rtol = atol = 1e-5; ``keep_slices`` leaves the experts
untouched, as in the reference. Also: the expert-axis op against the
reference's ``dequant_leaf`` + einsum, layer-by-layer packing against
``pack_tree``, and the full configs' parameter counts."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch import configs as TC
from repro_torch.bridge import from_jax_params
from repro_torch.configs.base import QuantPolicy as TPolicy
from repro_torch.core.swis import QuantConfig as TQuant
from repro_torch.kernels import ops
from repro_torch.models import moe as tmoe
from repro_torch.models import params as tpp
from repro_torch.models.model import Model as TModel
from repro_torch.serve import quantized as tquantized

pytest.importorskip("jax")  # the card's test environment has no JAX
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import repro.configs as C  # noqa: E402
from repro.configs.base import QuantPolicy as JPolicy  # noqa: E402
from repro.core.swis import QuantConfig as JQuant  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import params as jpp  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serve import quantized as jquantized  # noqa: E402
import torch_port  # noqa: E402,F401  (one torch thread per test worker)

TOL = 1e-5
# (arch, extra config fields): the qwen2-moe smoke (shared experts; its
# 48-wide expert down projection is too narrow to pack, so packed leaves
# mix with a dense one), the same widened to 64 with 6 experts padded to 8
# (every stack packed, unroutable padded experts), and the dbrx smoke (no
# shared experts, GQA)
VARIANTS = {
    "qwen2": ("qwen2-moe-a2.7b", {}),
    "qwen2-wide-padded": ("qwen2-moe-a2.7b", dict(
        d_ff=64, moe=dict(n_experts=6, n_experts_padded=8, d_ff_expert=64))),
    "dbrx": ("dbrx-132b", {}),
}


def _cfgs(variant, keep_slices=None):
    arch, fields = VARIANTS[variant]
    out = []
    for mod, policy, quant in ((C, JPolicy, JQuant), (TC, TPolicy, TQuant)):
        cfg = mod.get_smoke(arch)
        f = dict(fields, compute_dtype="float32",
                 quant=policy(cfg=quant(n_shifts=3), mode="off",
                              keep_slices=keep_slices))
        if "moe" in f:
            f["moe"] = dataclasses.replace(cfg.moe, **f["moe"])
        out.append(cfg.replace(**f))
    return out


@functools.lru_cache(maxsize=None)
def _moe_params(variant, packed):
    """The JAX package's random MoE params (packed with its pack_tree when
    asked), and the same bridged into the port."""
    jcfg, _ = _cfgs(variant)
    jp = jpp.init_params(jmoe.build_moe(jcfg), jax.random.key(4))
    if packed:
        jp, stats = jquantized.pack_tree(jp, JQuant(n_shifts=3))
        assert stats["n_packed"] >= 3
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, tp


# one compile per config and shape, instead of one dispatch per op
_jmoe_apply = jax.jit(jmoe.moe_apply, static_argnums=2)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


# (label, B, S, repeated rows): S = 1 is decode; the smoke's group_tokens
# is 64, so 2 x 64 tokens run two groups, 2 x 50 falls back to one group of
# 100, and 3 x 7 is one group smaller than group_tokens
SHAPES = [("decode", 5, 1), ("two groups", 2, 64), ("fallback", 2, 50),
          ("short", 3, 7)]


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("label,b,s", SHAPES)
def test_moe_apply_matches_reference(variant, packed, label, b, s):
    jcfg, tcfg = _cfgs(variant)
    jp, tp = _moe_params(variant, packed)
    x = np.random.default_rng(s).normal(0, 1, (b, s, jcfg.d_model)).astype(
        np.float32)
    jy, jaux = _jmoe_apply(jp, jnp.asarray(x), jcfg)
    ty, taux = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg)
    assert ty.shape == (b, s, jcfg.d_model) and ty.dtype == torch.float32
    _close(ty, jy)
    _close(taux["moe_aux"], jaux["moe_aux"])


def _loads(x, router, cfg):
    """Per-expert assignment counts of one group, from the router alone."""
    logits = x.reshape(-1, x.shape[-1]) @ router
    logits[:, cfg.moe.n_experts:] = -1e30
    top = np.argsort(-logits, axis=-1, kind="stable")[:, :cfg.moe.top_k]
    return np.bincount(top.ravel(), minlength=cfg.moe.e_total)


@pytest.mark.parametrize("variant", ["qwen2", "dbrx"])
@pytest.mark.parametrize("packed", [False, True])
def test_capacity_drops_match_reference(variant, packed):
    """At the default capacity factor, a batch whose rows repeat (as pad
    tokens do) overflows its experts' capacity: the dropped choices, the
    priority order and the combine weights must be the reference's."""
    jcfg, tcfg = _cfgs(variant)
    jp, tp = _moe_params(variant, packed)
    rng = np.random.default_rng(9)
    x = rng.normal(0, 1, (2, 24, jcfg.d_model)).astype(np.float32)
    x[1, 6:] = x[1, 5]  # 18 identical rows: the same experts, over capacity
    mc = jcfg.moe
    assert mc.capacity_factor == 1.25  # the default
    cap = max(int(48 * mc.top_k * mc.capacity_factor / mc.n_experts), 1)
    router = np.asarray(jp["router"], np.float32)
    assert _loads(x, router, jcfg).max() > cap  # tokens are dropped
    jy, jaux = _jmoe_apply(jp, jnp.asarray(x), jcfg)
    ty, taux = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg)
    _close(ty, jy)
    _close(taux["moe_aux"], jaux["moe_aux"])


@pytest.mark.parametrize("s", [1, 16])
def test_keep_slices_leaves_experts_unchanged(s):
    """The reference's MoE dequantizes every plane whatever keep_slices
    says: a truncated policy gives the same expert output."""
    jfull, tfull = _cfgs("qwen2-wide-padded")
    jcut, tcut = _cfgs("qwen2-wide-padded", keep_slices=1)
    jp, tp = _moe_params("qwen2-wide-padded", True)
    x = np.random.default_rng(2).normal(0, 1, (2, s, 64)).astype(np.float32)
    full, _ = tmoe.moe_apply(tp, torch.from_numpy(x), tfull)
    cut, _ = tmoe.moe_apply(tp, torch.from_numpy(x), tcut)
    torch.testing.assert_close(cut, full, rtol=0, atol=0)
    jy, _ = _jmoe_apply(jp, jnp.asarray(x), jcut)
    _close(cut, jy)


@pytest.mark.parametrize("method", ["swis", "swis_c"])
def test_expert_op_matches_dequant_einsum(method):
    """ops.swis_matmul_experts on the CPU against the reference's
    dequant_leaf of the stack and its einsums, shared rows and per-expert
    rows, with ragged M, and its x-gradient against the einsum's."""
    rng = np.random.default_rng(5)
    w = rng.normal(0, 0.05, (3, 96, 40)).astype(np.float32)
    q = dict(method=method, n_shifts=3)
    jleaf = jquantized.pack_tree({"wi": jnp.asarray(w)}, JQuant(**q))[0]["wi"]
    tleaf = tquantized.pack_tree({"wi": torch.from_numpy(w)}, TQuant(**q))[0]["wi"]
    jw = jquantized.dequant_leaf(jleaf, consecutive=method == "swis_c")
    c = method == "swis_c"
    x = rng.normal(0, 1, (5, 96)).astype(np.float32)
    _close(ops.swis_matmul_experts(torch.from_numpy(x), tleaf, consecutive=c),
           jnp.einsum("td,edf->etf", jnp.asarray(x), jw))
    xe = rng.normal(0, 1, (3, 7, 96)).astype(np.float32)
    _close(ops.swis_matmul_experts(torch.from_numpy(xe), tleaf, consecutive=c),
           jnp.einsum("egd,edf->egf", jnp.asarray(xe), jw))
    with pytest.raises(ValueError):
        ops.swis_matmul_experts(torch.zeros((2, 7, 96)), tleaf)  # E mismatch
    with pytest.raises(ValueError):
        ops.swis_matmul_experts(torch.from_numpy(xe), tleaf, keep_slices=4)
    # differentiable in x: the gradient of the reference's einsum over its
    # dequantized stack (rows shared by every expert sum over the experts)
    xt = torch.from_numpy(x).requires_grad_(True)
    ops.swis_matmul_experts(xt, tleaf, consecutive=c).sum().backward()
    _close(xt.grad, jax.grad(lambda a: jnp.einsum(
        "td,edf->etf", a, jw).sum())(jnp.asarray(x)))


def test_expert_op_takes_wide_stacks_on_cpu():
    """A stack quantized to 10 bits (shifts up to 9, which the card's expert
    kernel refuses) still goes through the plain version on the CPU, equal
    to the reference's dequant_leaf and einsum."""
    rng = np.random.default_rng(6)
    w = rng.normal(0, 0.05, (2, 64, 24)).astype(np.float32)
    q = dict(method="swis", n_shifts=4, bits=10)
    jleaf = jquantized.pack_tree({"wi": jnp.asarray(w)}, JQuant(**q))[0]["wi"]
    tleaf = tquantized.pack_tree({"wi": torch.from_numpy(w)}, TQuant(**q))[0]["wi"]
    nibbles = torch.cat([tleaf["shifts"] & 15, tleaf["shifts"] >> 4])
    assert int(nibbles.max()) >= 8  # a shift the 3-bit format cannot hold
    x = rng.normal(0, 1, (2, 5, 64)).astype(np.float32)
    _close(ops.swis_matmul_experts(torch.from_numpy(x), tleaf, bits=10),
           jnp.einsum("egd,edf->egf", jnp.asarray(x),
                      jquantized.dequant_leaf(jleaf)))


@pytest.mark.parametrize("method", ["swis", "swis_c"])
def test_pack_tree_expert_stacks_bit_identical(method):
    """The port's pack_tree packs each (E, K, C) expert stack in one
    selection pass; every plane equals the JAX package's matrix-by-matrix
    pack_tree bit for bit (uint32 words as int32 views)."""
    jcfg, _ = _cfgs("qwen2-wide-padded")
    jp = jpp.init_params(jmoe.build_moe(jcfg), jax.random.key(8))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    q = dict(method=method, n_shifts=3)
    want, jstats = jquantized.pack_tree(jp, JQuant(**q))
    got, tstats = tquantized.pack_tree(tp, TQuant(**q))
    assert tstats == jstats
    for name in ("wi", "wg", "wo", "shared_wi"):
        for key in tquantized.PACKED_KEYS:
            w = np.asarray(want[name][key])
            g = got[name][key].numpy()
            np.testing.assert_array_equal(
                g.view(np.uint32) if g.dtype == np.int32 else g, w,
                f"{name}/{key}")


def test_repeated_arena_writes_keep_the_last():
    """Writes that repeat an arena slot (invalid tokens all land in the
    trash block) leave it with the last write's values, as the reference's
    scatter does on the CPU, whatever order the card applies them in."""
    from repro_torch.models.attention import _last_writes

    rng = np.random.default_rng(3)
    phys = torch.from_numpy(rng.integers(0, 3, 40))
    off = torch.from_numpy(rng.integers(0, 4, 40))
    vals = torch.from_numpy(rng.normal(0, 1, (40, 5)).astype(np.float32))
    want = torch.zeros((3, 4, 5))
    for i in range(40):  # a serial scatter
        want[phys[i], off[i]] = vals[i]
    got = torch.zeros((3, 4, 5))
    src = _last_writes(phys, off, got.shape[:2])
    for i in reversed(range(40)):  # any order gives the same arena
        got[phys[i], off[i]] = vals[src[i]]
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "dbrx-132b"])
def test_layerwise_packing_equals_pack_tree(arch):
    """Packing one layer at a time gives exactly pack_tree of the same
    float32 weights, stats included."""
    cfg = TC.get_smoke(arch).replace(compute_dtype="float32", n_layers=3)
    tree = TModel(cfg).build()
    qcfg = TQuant(n_shifts=3)
    dense = tpp.init_params_layerwise(tree, torch.Generator().manual_seed(7),
                                      device="cpu")
    want, want_stats = tquantized.pack_tree(dense, qcfg)
    got, stats = tquantized.init_packed_params(
        tree, qcfg, torch.Generator().manual_seed(7), device="cpu")
    assert stats == want_stats and stats["n_packed"] >= 4
    flat_w, flat_g = [], []
    tpp.tree_map(flat_w.append, want)
    tpp.tree_map(flat_g.append, got)
    assert len(flat_g) == len(flat_w)
    for a, b in zip(flat_g, flat_w):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_param_counts_match_reference():
    """The full configs' placeholder trees (no allocation) count the JAX
    package's weights: qwen2-moe-a2.7b ~15.1 B (14.52 B in the GEMMs),
    dbrx-132b ~131.6 B."""
    for arch in ("qwen2-moe-a2.7b", "dbrx-132b"):
        jn = jpp.count_params(JModel(C.get_config(arch)).build())
        tn = tpp.count_params(TModel(TC.get_config(arch)).build())
        assert tn == jn, arch
    assert tpp.count_params(TModel(TC.get_config("qwen2-moe-a2.7b")).build()) \
        == 15_146_256_384
