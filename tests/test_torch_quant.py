"""Port parity: SWIS quantization and packing are bit-identical to the JAX
reference (``repro.core.swis.quantize`` + ``repro.core.packing.pack``) on
the same weights, for swis, swis_c, trunc and a fractional shift target,
and ``pack_tree`` of the smoke model's params matches leaf for leaf."""
import numpy as np
import pytest
import torch

from repro_torch.bridge import from_jax_params
from repro_torch.core import packing, swis
from repro_torch.kernels import ref
from repro_torch.serve import quantized

pytest.importorskip("jax")  # the card's test environment has no JAX
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import repro.configs as C  # noqa: E402
from repro.core import packing as jpacking  # noqa: E402
from repro.core import swis as jswis  # noqa: E402
from repro.models import params as jpp  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serve import quantized as jquantized  # noqa: E402

PLANES = ("sign_plane", "mask_planes", "shifts", "scale")


def _u32(t: torch.Tensor) -> np.ndarray:
    """Port planes are int32 views of the reference's uint32 words."""
    a = t.numpy()
    return a.view(np.uint32) if a.dtype == np.int32 else a


CASES = [
    # (method, n_shifts, group, per_channel, K, C)
    ("swis", 4, 4, False, 128, 48),
    ("swis", 3, 8, True, 96, 40),
    ("swis_c", 3, 4, False, 128, 48),
    ("trunc", 2, 4, False, 64, 32),
    ("swis", 2.5, 4, False, 128, 40),  # fractional: filter scheduling
]


@pytest.mark.parametrize("method,n_shifts,group,per_channel,k,c", CASES)
def test_quantize_and_pack_bit_identical(method, n_shifts, group, per_channel,
                                         k, c):
    rng = np.random.default_rng(7)
    w = rng.normal(0, 0.05, (k, c)).astype(np.float32)
    jcfg = jswis.QuantConfig(method=method, n_shifts=n_shifts,
                             group_size=group, per_channel=per_channel)
    tcfg = swis.QuantConfig(method=method, n_shifts=n_shifts,
                            group_size=group, per_channel=per_channel)
    jqw = jswis.quantize(jnp.asarray(w), jcfg)
    tqw = swis.quantize(torch.from_numpy(w), tcfg)
    for name in ("qmags", "masks", "shifts", "col_shifts", "qweights"):
        np.testing.assert_array_equal(getattr(tqw, name).numpy(),
                                      np.asarray(getattr(jqw, name)), name)
    jpw, tpw = jpacking.pack(jqw), packing.pack(tqw)
    for name in PLANES:
        np.testing.assert_array_equal(_u32(getattr(tpw, name)),
                                      np.asarray(getattr(jpw, name)), name)
    assert (tpw.n_shifts, tpw.group_size, tpw.method) == (
        jpw.n_shifts, jpw.group_size, jpw.method)
    dense = ref.dequant_ref(tpw.sign_plane, tpw.mask_planes, tpw.shifts,
                            tpw.scale.reshape(-1).expand(c), group=group,
                            consecutive=method == "swis_c")
    np.testing.assert_array_equal(dense.numpy(), np.asarray(jqw.qweights))


def test_bit_and_nibble_packing_roundtrip():
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, (64, 5, 3)).astype(np.int32)
    bits[31, 0, 0] = 1  # sign bit of the first word
    jw = np.asarray(jpacking.pack_bits_u32(jnp.asarray(bits)))
    tw = packing.pack_bits_u32(torch.from_numpy(bits))
    assert tw.dtype == torch.int32
    np.testing.assert_array_equal(_u32(tw), jw)
    np.testing.assert_array_equal(packing.unpack_bits_u32(tw).numpy(), bits)
    sh = rng.integers(0, 8, (6, 4, 5)).astype(np.int32)
    jn = np.asarray(jpacking.pack_shift_nibbles(jnp.asarray(sh)))
    tn = packing.pack_shift_nibbles(torch.from_numpy(sh))
    np.testing.assert_array_equal(tn.numpy(), jn)
    np.testing.assert_array_equal(
        packing.unpack_shift_nibbles(tn, 5).numpy(), sh)


@pytest.mark.parametrize("method", ["swis", "swis_c"])
def test_pack_tree_smoke_params_leaf_for_leaf(method):
    cfg = C.get_smoke("smollm-135m")
    jparams = jpp.init_params(JModel(cfg).build(), jax.random.key(0))
    jq = jswis.QuantConfig(method=method, n_shifts=3, group_size=4)
    tq = swis.QuantConfig(method=method, n_shifts=3, group_size=4)
    jtree, jstats = jquantized.pack_tree(jparams, jq)
    ttree, tstats = quantized.pack_tree(
        from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu"), tq)
    assert tstats == jstats
    jleaves = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tflat = {}

    def walk(path, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(path + (k,), v)
        else:
            tflat[path] = node

    walk((), ttree)
    assert len(tflat) == len(jleaves)
    for path, jleaf in jleaves:
        key = tuple(p.key for p in path)
        np.testing.assert_array_equal(_u32(tflat[key]), np.asarray(jleaf),
                                      "/".join(key))
    assert quantized.total_slices(ttree) == jquantized.total_slices(jtree)
    # packing a packed tree is a no-op (the engine relies on it)
    again, _ = quantized.pack_tree(ttree, tq)
    leaf = ttree["blocks"]["sub0_attn"]["mlp"]["wo"]["w"]
    jleaf = jtree["blocks"]["sub0_attn"]["mlp"]["wo"]["w"]
    assert again["blocks"]["sub0_attn"]["mlp"]["wo"]["w"]["sign_plane"] is \
        leaf["sign_plane"]
    np.testing.assert_array_equal(
        quantized.dequant_leaf(leaf, consecutive=method == "swis_c").numpy(),
        np.asarray(jquantized.dequant_leaf(jleaf,
                                           consecutive=method == "swis_c")))
