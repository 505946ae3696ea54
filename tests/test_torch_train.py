"""Port parity of the train step and the training loop.

``make_train_step`` against the reference's jitted step from the same
bridged params and batch (SWIS QAT hoisted, clip, AdamW):
- float32 compute: metrics within rtol 1e-5 (lr exact), gradients
  within 1e-4 x each leaf's max |g|, and updated weights: none more than
  2.05 x lr apart and at most 1e-3 of them more than 0.01 x lr (AdamW's
  first step moves a weight by lr x g / (|g| + 1e-8): a gradient within
  its rounding of 0 can move it either way);
- bfloat16 compute (the configs' default): the loss within rtol 1e-4,
  gradients within 5e-2 x max |g|, and updated weights: none more than
  2.05 x lr apart and at most 2 % more than 0.1 x lr (bf16 rounding flips
  the sign of more small gradients).
Gradient accumulation and int8 compression too. The loop is in
``test_torch_trainer.py``.
"""
import dataclasses

import numpy as np
import pytest

from repro_torch.data.pipeline import to_device
from repro_torch.models.model import Model
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.train import init_state, make_train_step
from repro_torch.train.steps import make_grad_fn
from torch_train_port import (LR, assert_tree_close, leaves_by_path,
                              qat_configs)

pytest.importorskip("jax")  # the card's test environment has no JAX
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.core.qat import quantize_tree as jquantize_tree  # noqa: E402
from repro.data import SyntheticPipeline as JPipeline  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import warmup_cosine as jwarmup_cosine  # noqa: E402
from repro.train.steps import init_state as jinit_state  # noqa: E402
from repro.train.steps import make_train_step as jmake_train_step  # noqa: E402



def _jax_grads(jcfg, jparams, batch):
    """The reference step's loss function (hoisted QAT, compute cast)."""
    inner = JModel(jcfg.replace(quant=dataclasses.replace(jcfg.quant,
                                                          mode="off")))
    dt = jnp.dtype(jcfg.compute_dtype)

    def loss_fn(p):
        q = jax.tree.map(lambda a: a.astype(dt) if a.ndim >= 2
                         and a.dtype == jnp.float32 else a,
                         jquantize_tree(p, jcfg.quant.cfg))
        return inner.loss(q, batch)

    return jax.jit(jax.grad(lambda p: loss_fn(p)[0]))(jparams)


def _step_both(jcfg, tcfg, jparams, tparams, batch_np):
    jstep = jax.jit(jmake_train_step(JModel(jcfg), JAdamW(),
                                     jwarmup_cosine(LR, 1, 10)))
    jstate, jm = jstep(jinit_state(jparams),
                       jax.tree.map(jnp.asarray, batch_np))
    tstep = make_train_step(Model(tcfg), AdamW(), warmup_cosine(LR, 1, 10))
    tstate, tm = tstep(init_state(tparams), to_device(batch_np, "cpu"))
    return jstate, jm, tstate, tm


def _param_moves(got, want):
    """|got - want| / LR over every leaf, flattened."""
    g, w = leaves_by_path(got), leaves_by_path(want)
    return np.concatenate([np.abs(g[k].numpy() - np.asarray(w[k])).ravel()
                           for k in w]) / LR


@pytest.mark.parametrize("n_shifts", [3, 2.5])
def test_qat_train_step_matches_jax_fp32(n_shifts):
    jcfg, tcfg, jparams, tparams = qat_configs("float32", n_shifts)
    batch = JPipeline(jcfg, 32, 4, seed=0).batch_at(0)
    jstate, jm, tstate, tm = _step_both(jcfg, tcfg, jparams, tparams, batch)
    for k in ("loss", "ce", "accuracy", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    assert float(tm["lr"]) == float(jm["lr"]) == np.float32(LR)
    grads, _ = make_grad_fn(Model(tcfg))(tparams, to_device(batch, "cpu"))
    assert_tree_close(grads, _jax_grads(jcfg, jparams,
                                        jax.tree.map(jnp.asarray, batch)),
                      1e-4, "grads")
    moves = _param_moves(tstate.params, jstate.params)
    assert moves.max() <= 2.05
    assert np.mean(moves > 0.01) <= 1e-3, np.mean(moves > 0.01)
    assert int(tstate.step) == int(jstate.step) == 1


def test_qat_train_step_matches_jax_bf16():
    jcfg, tcfg, jparams, tparams = qat_configs("bfloat16", 3)
    batch = JPipeline(jcfg, 32, 4, seed=0).batch_at(0)
    jstate, jm, tstate, tm = _step_both(jcfg, tcfg, jparams, tparams, batch)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-2)
    grads, _ = make_grad_fn(Model(tcfg))(tparams, to_device(batch, "cpu"))
    assert_tree_close(grads, _jax_grads(jcfg, jparams,
                                        jax.tree.map(jnp.asarray, batch)),
                      5e-2, "bf16 grads")
    moves = _param_moves(tstate.params, jstate.params)
    assert moves.max() <= 2.05
    assert np.mean(moves > 0.1) <= 0.02, np.mean(moves > 0.1)


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen2-moe-a2.7b"])
def test_grad_accumulation_and_compression_match_jax(arch):
    """Two microbatches (gradients summed in fp32, then halved) and the
    int8 compression in the update path, float32 compute."""
    jcfg, tcfg, jparams, tparams = qat_configs("float32", 3, arch=arch,
                                            grad_accum=2, grad_compress=True)
    batch = JPipeline(jcfg, 16, 4, seed=1).batch_at(2)
    jstate, jm, tstate, tm = _step_both(jcfg, tcfg, jparams, tparams, batch)
    for k in ("loss", "ce", "aux", "accuracy", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    moves = _param_moves(tstate.params, jstate.params)
    assert moves.max() <= 2.05
    assert np.mean(moves > 0.01) <= 1e-3
