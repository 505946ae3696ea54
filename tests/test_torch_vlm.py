"""Port parity: the VLM family (llama-3.2-vision) against the JAX package, on
the same numpy tokens and patches and bridged params in one process,
float32, with every ``xgate`` set to 0.5 in both packages' weights (the
reference inits it to 0, which keeps the patches from every logit).

Cross ``attention_apply`` alone; ``Model.apply`` logits with and without
patches, unpacked and packed; a decode step after a prefill with patches
against the full forward (the reference's ``test_decode_matches_full_
forward``); and ``xgate`` 0 pinning that the patches then change no logit;
the serve engines are held in ``test_torch_engine_vlm.py``. Logits within
rtol 1e-5 and atol 1e-5 * max|ref|."""
import numpy as np
import pytest
import torch

from repro_torch.bridge import from_jax_params
from repro_torch.core.swis import QuantConfig as TQuant
from repro_torch.models import attention as tattn
from repro_torch.models import params as tpp
from repro_torch.models.model import Model as TModel
from repro_torch.serve import quantized as tquantized

pytest.importorskip("jax")  # the card's test environment has no JAX
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.core.swis import QuantConfig as JQuant  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import params as jpp  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serve.quantized import pack_tree as jpack_tree  # noqa: E402
from torch_port import bridged_smoke, with_xgate  # noqa: E402

ARCH = "llama-3.2-vision-11b"
QCFG = dict(n_shifts=3)


def _patches(cfg, b, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1, (b, cfg.vlm.n_patches,
                             cfg.vlm.vision_dim)).astype(np.float32)


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=tol,
                               atol=tol * np.abs(want).max())


def _packed(packed):
    jcfg, tcfg, jparams, tparams = bridged_smoke(arch=ARCH)
    if packed:
        jparams, jstats = jpack_tree(jparams, JQuant(**QCFG))
        tparams, tstats = tquantized.pack_tree(tparams, TQuant(**QCFG))
        # (attn) 7 GEMMs, (self_cross) 7 and xattn's q/k/v/o
        assert tstats == jstats and tstats["n_packed"] == 18
    return jcfg, tcfg, jparams, tparams


@pytest.mark.parametrize("packed", [False, True])
def test_cross_attention_matches_reference(packed):
    """One layer's ``xattn``: K/V from the patches (no RoPE, no cache),
    queries from x at any positions, no causal mask."""
    jcfg, tcfg, jparams, tparams = _packed(packed)
    jp = jax.tree.map(lambda a: a[0],
                      jparams["blocks"]["sub1_self_cross"]["xattn"])
    tp = tpp.tree_map(lambda a: a[0],
                      tparams["blocks"]["sub1_self_cross"]["xattn"])
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, 5, jcfg.d_model)).astype(np.float32)
    ctx = _patches(jcfg, 2, seed=2)
    pos = np.arange(7, 12, dtype=np.int32)
    want, jcache = jattn.attention_apply(
        jp, jnp.asarray(x), jcfg, positions=jnp.asarray(pos), causal=False,
        ctx=jnp.asarray(ctx))
    got, tcache = tattn.attention_apply(
        tp, torch.from_numpy(x), tcfg, positions=torch.from_numpy(pos),
        causal=False, ctx=torch.from_numpy(ctx))
    assert jcache is None and tcache is None
    _close(got, want)


@pytest.mark.parametrize("packed", [False, True])
def test_logits_with_patches_match_reference(packed):
    jcfg, tcfg, jparams, tparams = _packed(packed)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab, (2, 9)).astype(np.int32)
    patches = _patches(jcfg, 2, seed=4)
    jm, tm = JModel(jcfg), TModel(tcfg)
    out = {}
    for with_p in (True, False):
        jb = {"tokens": jnp.asarray(toks)}
        tb = {"tokens": torch.from_numpy(toks).long()}
        if with_p:
            jb["patches"] = jnp.asarray(patches)
            tb["patches"] = torch.from_numpy(patches)
        want = jm.apply(jparams, jb)[0]
        got = tm.apply(tparams, tb)[0]
        _close(got, want)
        out[with_p] = got
    # the gate is open: the image moves every position's logits
    assert (out[True] - out[False]).abs().amax(dim=-1).min() > 1e-4


def test_decode_with_patches_matches_full_forward():
    """The reference's ``test_decode_matches_full_forward`` on the port:
    prefill 15 tokens with patches, then decode the 16th with them; its
    logits equal the full forward's last position (and the JAX decode's).
    A decode without patches, as the engines run it, equals the JAX one."""
    jcfg, tcfg, jparams, tparams = bridged_smoke(arch=ARCH)
    rng = np.random.default_rng(5)
    b, s = 2, 16
    toks = rng.integers(0, jcfg.vocab, (b, s)).astype(np.int32)
    patches = _patches(jcfg, b, seed=6)
    tm, jm = TModel(tcfg), JModel(jcfg)
    tp = torch.from_numpy(patches)
    full = tm.apply(tparams, {"tokens": torch.from_numpy(toks).long(),
                              "patches": tp})[0]
    for with_p in (True, False):
        tcache = tpp.init_params(tm.build_cache(b, s, torch.float32), None,
                                 device="cpu")
        _, tcache = tm.prefill(tparams, {
            "tokens": torch.from_numpy(toks[:, :-1]).long(),
            "patches": tp}, tcache)
        dec = {"tokens": torch.from_numpy(toks[:, -1:]).long()}
        jcache = jpp.init_params(jm.build_cache(b, s, jnp.float32),
                                 jax.random.key(0))
        _, jcache = jm.prefill(jparams, {
            "tokens": jnp.asarray(toks[:, :-1]),
            "patches": jnp.asarray(patches)}, jcache)
        jdec = {"tokens": jnp.asarray(toks[:, -1:])}
        if with_p:
            dec["patches"], jdec["patches"] = tp, jnp.asarray(patches)
        got = tm.apply(tparams, dec, cache=tcache, cache_index=s - 1)[0]
        want = jm.apply(jparams, jdec, cache=jcache,
                        cache_index=jnp.int32(s - 1))[0]
        _close(got, want)
        if with_p:
            _close(got[:, -1], full[:, -1].numpy())


def test_zero_xgate_keeps_patches_from_every_logit():
    """With the reference's initial ``xgate`` of 0, tanh(0) = 0 and the
    patches change no logit in either package: a parity test at the
    initial weights could not see cross-attention."""
    jcfg, tcfg, jparams, _ = bridged_smoke(arch=ARCH)
    jparams = with_xgate(jparams, 0.0)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    assert float(tparams["blocks"]["sub1_self_cross"]["xgate"].abs().max()) == 0
    toks = np.random.default_rng(7).integers(0, jcfg.vocab, (2, 6))
    patches = _patches(jcfg, 2, seed=8)
    tb = {"tokens": torch.from_numpy(toks).long()}
    jb = {"tokens": jnp.asarray(toks, jnp.int32)}
    t0 = TModel(tcfg).apply(tparams, tb)[0]
    t1 = TModel(tcfg).apply(tparams, dict(tb, patches=torch.from_numpy(
        patches)))[0]
    j0 = JModel(jcfg).apply(jparams, jb)[0]
    j1 = JModel(jcfg).apply(jparams, dict(jb, patches=jnp.asarray(patches)))[0]
    assert torch.equal(t0, t1)
    np.testing.assert_array_equal(np.asarray(j0), np.asarray(j1))


def test_scalar_leaves_stack_draw_pack_and_bridge():
    """``xgate`` is a 0-d placeholder: stacked to (n_units,), drawn as
    zeros whole or layer by layer, passed through packing, carried by
    the bridge as a 0-d array; and ``init_packed_params`` reports the
    reference's ``pack_tree`` stats of the VLM smoke tree."""
    jcfg, tcfg, jparams, _ = bridged_smoke(arch=ARCH)
    tree = TModel(tcfg).build()
    leaf = tree["blocks"]["sub1_self_cross"]["xgate"]
    assert leaf.shape == (TModel(tcfg).n_units,) and leaf.init == "zeros"
    whole = tpp.init_params(tree, torch.Generator().manual_seed(1),
                            device="cpu")
    layered = tpp.init_params_layerwise(
        tree, torch.Generator().manual_seed(1), device="cpu")
    for params in (whole, layered):
        got = params["blocks"]["sub1_self_cross"]["xgate"]
        assert got.shape == leaf.shape and not got.any()
    qcfg = TQuant(**QCFG)
    packed, stats = tquantized.init_packed_params(
        tree, qcfg, torch.Generator().manual_seed(1), device="cpu")
    assert stats == tquantized.pack_tree(layered, qcfg)[1]
    assert stats == jpack_tree(jparams, JQuant(**QCFG))[1]
    assert packed["blocks"]["sub1_self_cross"]["xgate"].shape == leaf.shape
    scalar = from_jax_params({"g": np.asarray(np.float32(0.5))},
                             device="cpu")["g"]
    assert scalar.shape == () and float(scalar) == 0.5
