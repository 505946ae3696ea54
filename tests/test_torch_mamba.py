"""Port parity: the Mamba2 family against the JAX package, on the same numpy
inputs and bridged params in one process, float32.

The chunked SSD scan at chunks 8, 16 and 32, with and without an initial
state, against the reference's and the naive recurrence (rtol 2e-4 and
atol 2e-4 * max|ref|, as the reference's ``test_mamba_ssd_vs_naive``); the
decode step; ``mamba_apply`` in decode, in prefill from a cached state, and
with L not a multiple of the chunk (the dt = 0 padding); and the smoke
model's logits, packed and unpacked (rtol 1e-4, atol 1e-4 * max|ref|)."""
import functools

import numpy as np
import pytest
import torch

from repro_torch import configs as TC
from repro_torch.bridge import from_jax_params
from repro_torch.configs.base import QuantPolicy as TPolicy
from repro_torch.core.swis import QuantConfig as TQuant
from repro_torch.models import params as tpp
from repro_torch.models import ssm as tssm
from repro_torch.models.model import Model as TModel

pytest.importorskip("jax")  # the card's test environment has no JAX
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import repro.configs as C  # noqa: E402
from repro.configs.base import QuantPolicy as JPolicy  # noqa: E402
from repro.core.swis import QuantConfig as JQuant  # noqa: E402
from repro.models import params as jpp  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serve.quantized import pack_tree as jpack_tree  # noqa: E402
from torch_port import bridged_smoke  # noqa: E402

ARCH = "mamba2-2.7b"


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, rtol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _ssd_inputs(rng, b=2, length=32, h=3, p=4, n=8):
    x = rng.normal(0, 1, (b, length, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(0, 1, (b, length, h)))).astype(np.float32)
    a_neg = -np.exp(rng.normal(0, .5, (h,))).astype(np.float32)
    bm = rng.normal(0, 1, (b, length, n)).astype(np.float32)
    cm = rng.normal(0, 1, (b, length, n)).astype(np.float32)
    return x, dt, a_neg, bm, cm


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_ssd_chunked_matches_reference_and_naive(chunk, with_state):
    rng = np.random.default_rng(chunk)
    x, dt, a_neg, bm, cm = _ssd_inputs(rng)
    b, length, h, p = x.shape
    s = (rng.normal(0, 1, (b, h, p, bm.shape[-1])).astype(np.float32)
         if with_state else np.zeros((b, h, p, bm.shape[-1]), np.float32))
    init = s if with_state else None
    got, got_state = tssm.ssd_chunked(
        _t(x), _t(dt), _t(a_neg), _t(bm), _t(cm), chunk,
        init_state=None if init is None else _t(init))
    want, want_state = jssm.ssd_chunked(
        jnp.asarray(x), jnp.asarray(dt), jnp.asarray(a_neg), jnp.asarray(bm),
        jnp.asarray(cm), chunk,
        init_state=None if init is None else jnp.asarray(init))
    _close(got, want, 2e-4)
    _close(got_state, want_state, 2e-4)
    s = s.astype(np.float64)
    ys = []
    for t in range(length):
        da = np.exp(dt[:, t] * a_neg[None, :])
        s = s * da[:, :, None, None] + np.einsum(
            "bhp,bn->bhpn", x[:, t] * dt[:, t, :, None], bm[:, t])
        ys.append(np.einsum("bhpn,bn->bhp", s, cm[:, t]))
    _close(got, np.stack(ys, 1), 2e-4)
    _close(got_state, s, 2e-4)


def test_ssd_decode_step_matches_reference():
    rng = np.random.default_rng(2)
    x, dt, a_neg, bm, cm = _ssd_inputs(rng, length=1)
    state = rng.normal(0, 1, (2, 3, 4, 8)).astype(np.float32)
    got, got_state = tssm.ssd_decode_step(_t(x), _t(dt), _t(a_neg), _t(bm),
                                          _t(cm), _t(state))
    want, want_state = jssm.ssd_decode_step(
        jnp.asarray(x), jnp.asarray(dt), jnp.asarray(a_neg), jnp.asarray(bm),
        jnp.asarray(cm), jnp.asarray(state))
    _close(got, want, 1e-5)
    _close(got_state, want_state, 1e-5)


@pytest.mark.parametrize("branch,length", [
    ("no-cache", 40),  # 40 = 2 chunks of 16 + 8 dt = 0 padding steps
    ("decode", 1),
    ("prefill-from-state", 21),
])
def test_mamba_apply_matches_reference(branch, length):
    jcfg, tcfg, jparams, _ = bridged_smoke(arch=ARCH)
    assert jcfg.mamba2.chunk == 16
    jp = jax.tree.map(lambda a: a[1], jparams["blocks"]["sub0_mamba"]["mixer"])
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(length)
    # A_log, D and dt_bias are constants at init: vary them
    for name in ("A_log", "D", "dt_bias"):
        v = rng.normal(0, .5, jp[name].shape).astype(np.float32)
        jp[name], tp[name] = jnp.asarray(v), _t(v)
    x = rng.normal(0, 1, (2, length, jcfg.d_model)).astype(np.float32)
    jc = tc = None
    if branch != "no-cache":
        jc = {k: jnp.asarray(rng.normal(0, 1, v.shape).astype(np.float32))
              for k, v in jpp.init_params(jssm.build_mamba_cache(
                  jcfg, 2, jnp.float32), jax.random.key(0)).items()}
        tc = from_jax_params(jax.tree.map(np.asarray, jc), device="cpu")
    jy, jnew = jssm.mamba_apply(jp, jnp.asarray(x), jcfg, jc)
    ty, tnew = tssm.mamba_apply(tp, _t(x), tcfg, tc)
    _close(ty.numpy(), jy, 2e-4)
    if branch == "no-cache":
        assert tnew is None and jnew is None
        return
    assert tnew is tc  # the state is written in place
    for leaf in ("ssm", "conv"):
        _close(tnew[leaf].numpy(), jnew[leaf], 2e-4)


@functools.lru_cache(maxsize=None)
def _params(packed):
    jcfg, _, jparams, tparams = bridged_smoke(arch=ARCH)
    if not packed:
        return jparams, tparams
    jparams, stats = jpack_tree(jparams, JQuant(n_shifts=3))
    assert stats["n_packed"] == 2  # the stacked in_proj and out_proj
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
    assert tm.tail == () and "tail" not in tparams
    toks = np.random.default_rng(7).integers(0, jcfg.vocab, (2, 37))
    jl, _, _ = jm.apply(jparams, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, _, _ = tm.apply(tparams, {"tokens": _t(toks).long()})
    _close(tl.numpy(), jl)
    # prefill (37 = 2 chunks + 11 padded) into a cache, then 3 decode steps
    jc = jpp.init_params(jm.build_cache(2, 48, jnp.float32), jax.random.key(0))
    tc = tpp.init_params(tm.build_cache(2, 48, torch.float32), device="cpu")
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks, jnp.int32)}, jc)
    tl, tc = tm.prefill(tparams, {"tokens": _t(toks).long()}, tc)
    _close(tl.numpy(), jl)
    for i in range(3):
        nxt = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        jl, jc = jm.decode_step(jparams, jnp.asarray(nxt), jc,
                                jnp.int32(37 + i))
        tl, tc = tm.decode_step(tparams, _t(nxt).long(), tc, 37 + i)
        _close(tl.numpy(), jl)
    _close(tc["blocks"]["sub0_mamba"]["ssm"].numpy(),
           jc["blocks"]["sub0_mamba"]["ssm"])


def test_full_config_param_count_matches_reference():
    jn = jpp.count_params(JModel(C.get_config(ARCH)).build())
    tn = tpp.count_params(TModel(TC.get_config(ARCH)).build())
    assert tn == jn
    assert 2.4e9 < tn < 3.0e9  # the published ~2.7 B
    tree = TModel(TC.get_config(ARCH)).build()
    # in_proj: z, x, B, C and dt of 80 heads, N = 10576 (not a multiple of
    # 32); out_proj K = 5120
    assert tree["blocks"]["sub0_mamba"]["mixer"]["in_proj"]["w"].shape == (
        64, 2560, 10576)
    assert tree["blocks"]["sub0_mamba"]["mixer"]["out_proj"]["w"].shape == (
        64, 5120, 2560)
