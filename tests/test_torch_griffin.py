"""Port parity: the Griffin family (recurrentgemma) against the JAX package,
on the same numpy inputs and bridged params in one process, float32.

The RG-LRU scan (the port's log-depth scan against the reference's
associative scan and a plain loop, rtol 1e-5 / atol 1e-6 as the
reference's ``test_rglru_scan_vs_loop``), the causal conv, ``rglru_apply``
in its three branches, ``block_apply`` for ``rec`` and ``attn_local``
(including a ring of the smoke window, 8, that wraps), and the smoke
model's logits (one stacked (rec, rec, attn_local) unit and one tail rec
layer), packed and unpacked, within rtol 1e-4 and atol 1e-4 * max|ref|."""
import functools

import numpy as np
import pytest
import torch

from repro_torch import configs as TC
from repro_torch.bridge import from_jax_params
from repro_torch.configs.base import QuantPolicy as TPolicy
from repro_torch.core.swis import QuantConfig as TQuant
from repro_torch.models import params as tpp
from repro_torch.models import rglru as trglru
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttfm
from repro_torch.models.model import Model as TModel

pytest.importorskip("jax")  # the card's test environment has no JAX
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import repro.configs as C  # noqa: E402
from repro.configs.base import QuantPolicy as JPolicy  # noqa: E402
from repro.core.swis import QuantConfig as JQuant  # noqa: E402
from repro.models import params as jpp  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serve.quantized import pack_tree as jpack_tree  # noqa: E402
from torch_port import bridged_smoke  # noqa: E402

ARCH = "recurrentgemma-2b"


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, rtol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("length", [1, 24, 37])
def test_rglru_scan_matches_reference_and_loop(with_h0, length):
    rng = np.random.default_rng(length)
    b, w = 2, 8
    log_a = -np.abs(rng.normal(0, 1, (b, length, w))).astype(np.float32)
    x = rng.normal(0, 1, (b, length, w)).astype(np.float32)
    h0 = rng.normal(0, 1, (b, w)).astype(np.float32) if with_h0 else None
    got = trglru._rglru_scan(_t(log_a), _t(x),
                             None if h0 is None else _t(h0)).numpy()
    want = np.asarray(jrglru._rglru_scan(
        jnp.asarray(log_a), jnp.asarray(x),
        None if h0 is None else jnp.asarray(h0)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    h = np.zeros((b, w)) if h0 is None else h0.astype(np.float64)
    for t in range(length):
        h = np.exp(log_a[:, t]) * h + x[:, t]
        np.testing.assert_allclose(got[:, t], h, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2, 9, 6)).astype(np.float32)
    w = rng.normal(0, 1, (4, 6)).astype(np.float32)
    st = rng.normal(0, 1, (2, 3, 6)).astype(np.float32) if with_state else None
    got, got_state = tssm._causal_conv(_t(x), _t(w),
                                       None if st is None else _t(st))
    want, want_state = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                         None if st is None else jnp.asarray(st))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    if with_state:
        np.testing.assert_array_equal(got_state.numpy(), np.asarray(want_state))
    else:
        assert got_state is None and want_state is None


def _rec_params(jparams):
    """Layer 0's rec block of the smoke model, both packages."""
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["sub0_rec"]["rec"])
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


def _cache_pair(kind, cfg_j, cfg_t, batch, max_len, per_slot, rng=None):
    """The block cache of ``kind`` in both packages; with ``rng``, recurrent
    state filled with the same random numbers."""
    jc = jpp.init_params(jtfm.build_block_cache(cfg_j, kind, batch, max_len,
                                                jnp.float32, per_slot),
                         jax.random.key(0))
    if rng is not None:
        jc = {k: jnp.asarray(rng.normal(0, 1, v.shape).astype(np.float32))
              for k, v in jc.items()}
    return jc, from_jax_params(jax.tree.map(np.asarray, jc), device="cpu")


@pytest.mark.parametrize("branch", ["no-cache", "decode", "prefill-from-state"])
def test_rglru_apply_matches_reference(branch):
    jcfg, tcfg, jparams, _ = bridged_smoke(arch=ARCH)
    jp, tp = _rec_params(jparams)
    rng = np.random.default_rng(4)
    length = 1 if branch == "decode" else 13
    x = rng.normal(0, 1, (2, length, jcfg.d_model)).astype(np.float32)
    jc = tc = None
    if branch != "no-cache":
        jc, tc = _cache_pair("rec", jcfg, tcfg, 2, 32, True, rng)
    jy, jnew = jrglru.rglru_apply(jp, jnp.asarray(x), jcfg, jc)
    ty, tnew = trglru.rglru_apply(tp, _t(x), tcfg, tc)
    _close(ty, jy, rtol=1e-5)
    if branch == "no-cache":
        assert tnew is None and jnew is None
        return
    assert tnew is tc  # the state is written in place
    for leaf in ("h", "conv"):
        _close(tnew[leaf], jnew[leaf], rtol=1e-5)


def test_block_apply_rec_and_wrapping_local_ring_match_reference():
    """Prefill 11 tokens through a rec block and an attn_local block whose
    ring is the smoke window (8 < 11: the ring keeps the tail in ring
    order), then 6 per-slot decode steps at unequal depths, which wrap the
    ring; outputs and caches against the reference's."""
    jcfg, tcfg, jparams, tparams = bridged_smoke(arch=ARCH)
    assert jcfg.griffin.window == 8
    rng = np.random.default_rng(5)
    b, s0 = 2, 11
    for kind, key in (("rec", "sub0_rec"), ("attn_local", "sub2_attn_local")):
        jp = jax.tree.map(lambda a: a[0], jparams["blocks"][key])
        tp = tpp.tree_map(lambda a: a[0], tparams["blocks"][key])
        jc, tc = _cache_pair(kind, jcfg, tcfg, b, 32, True)
        if kind == "attn_local":
            assert tc["k"].shape[1] == 8
        x = rng.normal(0, 1, (b, s0, jcfg.d_model)).astype(np.float32)
        pos = np.arange(s0, dtype=np.int32)
        jy, jc, _ = jtfm.block_apply(jp, jnp.asarray(x), jcfg, kind,
                                     positions=jnp.asarray(pos), cache=jc,
                                     cache_index=jnp.int32(0))
        ty, tc, _ = ttfm.block_apply(tp, _t(x), tcfg, kind,
                                     positions=_t(pos), cache=tc,
                                     cache_index=0)
        _close(ty, jy)
        depth = np.array([s0, s0 - 3], np.int32)  # row 1 lags behind
        for step in range(6):
            x = rng.normal(0, 1, (b, 1, jcfg.d_model)).astype(np.float32)
            idx = depth + step
            jy, jc, _ = jtfm.block_apply(
                jp, jnp.asarray(x), jcfg, kind,
                positions=jnp.asarray(idx[:, None]), cache=jc,
                cache_index=jnp.asarray(idx))
            ty, tc, _ = ttfm.block_apply(tp, _t(x), tcfg, kind,
                                         positions=_t(idx[:, None]), cache=tc,
                                         cache_index=_t(idx))
            _close(ty, jy)
        for leaf, want in jc.items():
            if leaf == "pos":  # the ring invariant slot == pos % 8
                np.testing.assert_array_equal(tc[leaf].numpy(),
                                              np.asarray(want))
                got = tc[leaf].numpy()
                assert (got[got >= 0] % 8 == np.nonzero(got >= 0)[1]).all()
            else:
                _close(tc[leaf], want)


@functools.lru_cache(maxsize=None)
def _params(packed):
    jcfg, _, jparams, tparams = bridged_smoke(arch=ARCH)
    if not packed:
        return jparams, tparams
    jparams, stats = jpack_tree(jparams, JQuant(n_shifts=3))
    # per rec layer in_x, in_gate, out and the MLP's 3; attn_local's q, k,
    # v, o and its MLP: 6 + 6 + 7 stacked leaves, 6 in the tail rec layer
    assert stats["n_packed"] == 25
    return jparams, from_jax_params(jax.tree.map(np.asarray, jparams),
                                    device="cpu")


@pytest.mark.parametrize("packed", [False, True])
def test_smoke_model_logits_match_reference(packed):
    jcfg, tcfg, _, _ = bridged_smoke(arch=ARCH)
    if packed:
        jcfg = jcfg.replace(quant=JPolicy(cfg=JQuant(n_shifts=3), mode="off"))
        tcfg = tcfg.replace(quant=TPolicy(cfg=TQuant(n_shifts=3), mode="off"))
    jparams, tparams = _params(packed)
    jm, tm = JModel(jcfg), TModel(tcfg)
    assert tm.tail == jm.tail == ("rec",) and tm.n_units == 1
    assert set(tparams["tail"]) == {"tail0_rec"}
    toks = np.random.default_rng(6).integers(0, jcfg.vocab, (2, 19))
    jl, _, _ = jm.apply(jparams, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, _, _ = tm.apply(tparams, {"tokens": _t(toks).long()})
    _close(tl, jl)
    # prefill into a cache, then a decode step, through every layer's
    # cache (the tail's too)
    jc = jpp.init_params(jm.build_cache(2, 32, jnp.float32), jax.random.key(0))
    tc = tpp.init_params(tm.build_cache(2, 32, torch.float32), device="cpu")
    assert set(tc) == {"blocks", "tail"}
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks, jnp.int32)}, jc)
    tl, tc = tm.prefill(tparams, {"tokens": _t(toks).long()}, tc)
    _close(tl, jl)
    nxt = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
    jl, jc = jm.decode_step(jparams, jnp.asarray(nxt), jc, jnp.int32(19))
    tl, tc = tm.decode_step(tparams, _t(nxt).long(), tc, 19)
    _close(tl, jl)
    _close(tc["tail"]["tail0_rec"]["h"], jc["tail"]["tail0_rec"]["h"])


def test_full_config_param_count_matches_reference():
    jn = jpp.count_params(JModel(C.get_config(ARCH)).build())
    tn = tpp.count_params(TModel(TC.get_config(ARCH)).build())
    assert tn == jn
    # the published ~2.7 B, of which 26 layers: 8 stacked units + 2 tail
    assert 2.4e9 < tn < 3.0e9
    tree = TModel(TC.get_config(ARCH)).build()
    assert set(tree["tail"]) == {"tail0_rec", "tail1_rec"}
    assert tree["blocks"]["sub2_attn_local"]["attn"]["wq"]["w"].shape[0] == 8
