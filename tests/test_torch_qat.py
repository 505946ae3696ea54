"""Port parity of the quantization core that training uses: ``fake_quant``
(the reference's jitted in-graph path), ``select_shifts`` and its numpy
oracle, ``act_truncate``, ``rmse``, ``unpack_dense``, ``dpred_compression``
and the packed-weight accounting are bit-identical to the JAX reference on
the same seeded inputs; the STE and PTQ gradients equal ``jax.grad``'s
within float32 rounding (rtol 1e-6); ``quantize_tree`` reproduces the
reference's treatment of 4-D MoE expert stacks.

Selection runs on integer-domain magnitudes, so its costs are exact
integers in float32. The one sum that can round is a column's cost over
its groups (filter scheduling at fractional ``n_shifts``): exact while it
stays under 2**24, which the tests' weights do
(``test_column_cost_sums_stay_exact``).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import packing, qat, selection, swis
from repro_torch.kernels import ops
from repro_torch.serve import quantized

pytest.importorskip("jax")  # the card's test environment has no JAX
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.core import packing as jpacking  # noqa: E402
from repro.core import qat as jqat  # noqa: E402
from repro.core import selection as jselection  # noqa: E402
from repro.core import swis as jswis  # noqa: E402
from repro.serve import quantized as jquantized  # noqa: E402

SHAPES = [(64, 48), (70, 33)]  # K a multiple of the group, and padded


def _cfgs(**kw):
    return jswis.QuantConfig(**kw), swis.QuantConfig(**kw)


def _w(shape, seed=0):
    return np.random.default_rng(seed).normal(0, 0.05, shape).astype(
        np.float32)


@pytest.mark.parametrize("double_shift", [False, True])
@pytest.mark.parametrize("n_shifts", [2, 3, 2.5, 4.3])
@pytest.mark.parametrize("method", ["swis", "swis_c", "trunc"])
def test_fake_quant_bit_exact(method, n_shifts, double_shift):
    for shape in SHAPES:
        for per_channel in (False, True):
            jc, tc = _cfgs(method=method, n_shifts=n_shifts,
                           double_shift=double_shift, per_channel=per_channel)
            w = _w(shape)
            want = np.asarray(jswis.fake_quant(jnp.asarray(w), jc))
            got = swis.fake_quant(torch.from_numpy(w), tc).numpy()
            np.testing.assert_array_equal(got, want, f"{shape} {per_channel}")


@pytest.mark.parametrize("n_shifts", [3, 2.5])
def test_fake_quant_stack_is_the_reference_vmap(n_shifts):
    """Each matrix of a stack on its own scale and column schedule, as
    ``jax.vmap(fake_quant)``; a 4-D leaf through ``fake_quant`` is one
    tensor reduced along its leading axis."""
    jc, tc = _cfgs(n_shifts=n_shifts, group_size=4)
    w = _w((3, 64, 40), seed=1)
    want = np.asarray(jax.vmap(lambda m: jswis.fake_quant(m, jc))(
        jnp.asarray(w)))
    np.testing.assert_array_equal(
        swis.fake_quant_stack(torch.from_numpy(w), tc).numpy(), want)
    w4 = _w((2, 3, 64, 8), seed=2)
    np.testing.assert_array_equal(
        swis.fake_quant(torch.from_numpy(w4), tc).numpy(),
        np.asarray(jswis.fake_quant(jnp.asarray(w4), jc)))


def _mags(g, m, bits=8, seed=3):
    rng = np.random.default_rng(seed)
    mags = rng.integers(0, 2 ** bits, (g, m)).astype(np.float32)
    mags[0] = np.arange(m)  # small values: ties between candidates
    signs = np.where(rng.random((g, m)) < 0.5, -1.0, 1.0).astype(np.float32)
    return mags, signs


@pytest.mark.parametrize("variant,n_shifts", [("swis", 2), ("swis", 3),
                                              ("swis", 4), ("swis_c", 3),
                                              ("trunc", 3)])
def test_select_shifts_matches_oracle_and_reference(variant, n_shifts):
    mags, signs = _mags(300, 4)
    kw = dict(n_shifts=n_shifts, variant=variant, alpha=1.0)
    oracle = selection.select_shifts_bruteforce(mags, signs, **kw)
    joracle = jselection.select_shifts_bruteforce(mags, signs, **kw)
    jout = jselection.select_shifts(jnp.asarray(mags), jnp.asarray(signs),
                                    **kw)
    tout = selection.select_shifts(torch.from_numpy(mags),
                                   torch.from_numpy(signs), **kw)
    for key in ("qmags", "shifts", "masks", "combo", "cost"):
        np.testing.assert_array_equal(oracle[key], joracle[key], key)
        np.testing.assert_array_equal(tout[key].numpy(),
                                      np.asarray(jout[key]), key)
    # the oracle and the enumeration agree on the cost and the quantized
    # values (combo ties may pick another support with the same values)
    np.testing.assert_array_equal(tout["cost"].numpy(), oracle["cost"])
    np.testing.assert_array_equal(tout["qmags"].numpy(), oracle["qmags"])
    # the in-graph form: the running-min scan's qmags and cost
    q, cost = selection.select_qmags(torch.from_numpy(mags),
                                     torch.from_numpy(signs), chunk_elems=64,
                                     **kw)
    scan = selection.select_shifts_scan(torch.from_numpy(mags),
                                        torch.from_numpy(signs), **kw)
    np.testing.assert_array_equal(q.numpy(), scan["qmags"].numpy())
    np.testing.assert_array_equal(cost.numpy(), scan["cost"].numpy())


def test_selection_chunks_are_counted():
    mags, signs = _mags(64, 4)
    before = dict(selection.PASSES)
    selection.select_qmags(torch.from_numpy(mags), torch.from_numpy(signs),
                           n_shifts=3, chunk_elems=4 * 16)
    assert selection.PASSES["calls"] - before["calls"] == 4
    assert selection.PASSES["combos"] - before["combos"] == 4 * 56


@pytest.mark.parametrize("n_shifts", [1, 3, 6])
def test_act_truncate_and_rmse(n_shifts):
    rng = np.random.default_rng(5)
    for shape in ((7, 33), (2, 5, 64)):
        a = rng.normal(0, 1.3, shape).astype(np.float32)
        want = np.asarray(jswis.act_truncate(jnp.asarray(a), n_shifts))
        got = swis.act_truncate(torch.from_numpy(a), n_shifts).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(
            float(swis.rmse(torch.from_numpy(a), torch.from_numpy(got))),
            float(jswis.rmse(jnp.asarray(a), jnp.asarray(want))), rtol=1e-6)


@pytest.mark.parametrize("method", ["swis", "swis_c"])
def test_unpack_dense_and_accounting(method):
    w = _w((128, 40), seed=6)
    jc, tc = _cfgs(method=method, n_shifts=3)
    jpw = jpacking.pack(jswis.quantize(jnp.asarray(w), jc))
    tpw = packing.pack(swis.quantize(torch.from_numpy(w), tc))
    want = np.asarray(jpacking.unpack_dense(jpw))
    got = packing.unpack_dense(tpw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert tpw.stored_bits == jpw.stored_bits
    assert tpw.compression_ratio == jpw.compression_ratio
    assert set(tpw.tree()) == set(jpw.tree())
    for k, v in tpw.tree().items():
        a = v.numpy()
        np.testing.assert_array_equal(
            a.view(np.uint32) if a.dtype == np.int32 else a,
            np.asarray(jpw.tree()[k]), k)


def test_dpred_compression():
    rng = np.random.default_rng(8)
    for k, m in ((64, 4), (66, 8), (128, 16)):
        mags = rng.integers(0, 256, (k, 24)).astype(np.float32)
        mags[: k // 2] //= 16  # small groups need fewer bits
        assert packing.dpred_compression(mags, m) == jpacking.dpred_compression(
            mags, m)


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("method,n_shifts", [("swis", 3), ("swis", 2.5),
                                             ("trunc", 3)])
def test_ste_and_ptq_gradients_match_jax(method, n_shifts, per_channel):
    """STE (mode ``qat``): the gradient is the incoming one. PTQ (mode
    ``ptq``): it flows through the scale alone (round, floor and sign have
    zero gradient), into the weight(s) that set the scale."""
    jc, tc = _cfgs(method=method, n_shifts=n_shifts, per_channel=per_channel)
    w = _w((64, 24), seed=9)
    gy = np.random.default_rng(10).normal(0, 1, w.shape).astype(np.float32)
    for mode in ("qat", "ptq"):
        jg = np.asarray(jax.grad(lambda x: jnp.sum(
            jqat.maybe_quant(x, jc, mode) * gy))(jnp.asarray(w)))
        x = torch.from_numpy(w).requires_grad_(True)
        torch.sum(qat.maybe_quant(x, tc, mode) * torch.from_numpy(gy)
                  ).backward()
        np.testing.assert_allclose(x.grad.numpy(), jg, rtol=1e-6,
                                   atol=1e-6 * np.abs(jg).max())
        if mode == "qat":
            np.testing.assert_array_equal(x.grad.numpy(), gy)
        else:  # nonzero only where |w| sets a scale
            assert np.count_nonzero(jg) == (24 if per_channel else 1)
    # a stack: each matrix's scale gets its own gradient (the vmap)
    w3 = _w((3, 64, 8), seed=11)
    jg = np.asarray(jax.grad(lambda x: jnp.sum(jax.vmap(
        lambda m: jswis.fake_quant(m, jc))(x) ** 2))(jnp.asarray(w3)))
    x = torch.from_numpy(w3).requires_grad_(True)
    torch.sum(qat.maybe_quant(x, tc, "ptq", stacked=True) ** 2).backward()
    np.testing.assert_allclose(x.grad.numpy(), jg, rtol=1e-6,
                               atol=1e-6 * np.abs(jg).max())


def test_quantize_tree_expert_stack_along_layer_axis():
    """Reference fact: ``quantize_tree`` vmaps only 3-D leaves, so a stacked
    MoE expert leaf (layers, E, K, N) is quantized as one tensor reduced
    along its layer axis (one scale for the stack, layer pairs zero-padded
    into groups of 4), where the per-layer path quantizes each expert
    matrix on its own. The port reproduces both, bit for bit."""
    jc, tc = _cfgs(method="swis", n_shifts=2, group_size=4)
    w = _w((2, 8, 64, 48), seed=12)
    tree = {"blocks": {"sub0_moe": {"moe": {"wi": w}}},
            "blocks2": {"attn": {"wq": {"w": w[0, 0]}}}}
    jq = jqat.quantize_tree(jax.tree.map(jnp.asarray, tree), jc)
    tq = qat.quantize_tree(jax.tree.map(torch.from_numpy, tree), tc)
    hoisted = tq["blocks"]["sub0_moe"]["moe"]["wi"].numpy()
    np.testing.assert_array_equal(
        hoisted, np.asarray(jq["blocks"]["sub0_moe"]["moe"]["wi"]))
    np.testing.assert_array_equal(
        tq["blocks2"]["attn"]["wq"]["w"].numpy(),
        np.asarray(jq["blocks2"]["attn"]["wq"]["w"]))
    per_expert = np.stack([
        np.asarray(jax.vmap(lambda m: jswis.fake_quant(m, jc))(
            jnp.asarray(w[i]))) for i in range(2)])
    got = np.stack([swis.fake_quant_stack(torch.from_numpy(w[i]), tc).numpy()
                    for i in range(2)])
    np.testing.assert_array_equal(got, per_expert)
    # the two paths are different functions: far fewer distinct levels
    # under one scale, and values apart by far more than rounding
    n_hoisted = np.unique(np.abs(hoisted)).size
    n_per_expert = np.unique(np.abs(per_expert)).size
    assert n_hoisted * 4 < n_per_expert, (n_hoisted, n_per_expert)
    assert np.abs(hoisted - per_expert).max() > 0.01


@pytest.mark.parametrize("n_shifts", [2.5, 3.3])
def test_column_cost_sums_stay_exact(n_shifts):
    """The column costs that filter scheduling ranks are exact in float32
    for the tests' weights (every sum below 2**24), so the port's sums
    equal the reference's whatever their order."""
    _, tc = _cfgs(n_shifts=n_shifts)
    n_lo, n_hi, _ = tc.shift_levels()
    for shape in SHAPES:
        w = torch.from_numpy(_w(shape))
        w3, _ = swis._as_stack(w, 0, tc.group_size)
        mags, signs, _ = swis._to_int_domain(w3[0], tc.bits, False)
        for n in (n_lo, n_hi):
            _, col = swis._stack_qmags(mags[None], signs[None], n, tc)
            assert float(col.max()) < 2 ** 24


@pytest.mark.parametrize("shared", [True, False])
def test_expert_op_backward_matches_jax(shared):
    """The x-gradient of the packed expert op (its plain version on the
    CPU) equals ``jax.grad`` through the reference's dequantized copy and
    einsum (``repro.models.moe``): ``g[e] @ dequant(w[e]).T``, summed over
    the experts for rows they share; rtol 1e-6 of max |grad|."""
    e, m, k, n = 4, 3, 64, 40
    w = _w((e, k, n), seed=13)
    qc = swis.QuantConfig(n_shifts=3)
    leaf = quantized.pack_tree({"wi": torch.from_numpy(w)}, qc)[0]["wi"]
    jleaf = jquantized.pack_tree({"wi": jnp.asarray(w)}, jswis.QuantConfig(
        n_shifts=3))[0]["wi"]
    rng = np.random.default_rng(14)
    x = rng.normal(0, 1, (m, k) if shared else (e, m, k)).astype(np.float32)
    gy = rng.normal(0, 1, (e, m, n)).astype(np.float32)

    def jf(xx):
        wd = jquantized.dequant_leaf(jleaf)
        xe = jnp.broadcast_to(xx, (e, m, k)) if shared else xx
        return jnp.sum(jnp.einsum("emk,ekn->emn", xe, wd) * gy)

    want = np.asarray(jax.grad(jf)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    (ops.swis_matmul_experts(xt, leaf) * torch.from_numpy(gy)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
