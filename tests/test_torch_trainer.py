"""The port's training loop and the step's remat modes: loss falls,
restart is bit-exact (the reference's ``tests/test_substrates.py``),
failure injection, the straggler counter, a mesh on another device
refused, unit checkpointing recomputes the same gradients, and the port's
``Trainer``
follows the reference's over a few steps (losses within rtol 2e-4)."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch.configs.base import QuantPolicy
from repro_torch.core.swis import QuantConfig
from repro_torch.data.pipeline import to_device
from repro_torch.models.model import Model
from repro_torch.train import SimulatedFailure, Trainer, make_eval_step
from repro_torch.train.steps import make_grad_fn
from torch_train_port import LR, leaves_by_path, qat_configs

pytest.importorskip("jax")  # the card's test environment has no JAX
from repro.data import SyntheticPipeline as JPipeline  # noqa: E402
from repro.train import loop as jloop  # noqa: E402


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen2-moe-a2.7b"])
def test_remat_modes_give_the_same_gradients(arch):
    """Unit checkpointing ('full', 'dots') recomputes the same numbers:
    gradients bit-identical to no checkpointing."""
    _, tcfg, _, tparams = qat_configs("float32", 3, arch=arch)
    batch = to_device(JPipeline(tcfg, 16, 2, seed=3).batch_at(0), "cpu")
    got = {}
    for mode in ("none", "full", "dots"):
        cfg = tcfg.replace(parallel=dataclasses.replace(tcfg.parallel,
                                                        remat=mode))
        got[mode] = leaves_by_path(make_grad_fn(Model(cfg))(tparams, batch)[0])
    for mode in ("full", "dots"):
        for k, v in got["none"].items():
            assert (v is None and got[mode][k] is None) or torch.equal(
                v, got[mode][k]), (mode, k)


def test_eval_step_is_the_loss_without_gradients():
    _, tcfg, _, tparams = qat_configs("float32", 3)
    batch = to_device(JPipeline(tcfg, 16, 2, seed=4).batch_at(0), "cpu")
    m = make_eval_step(Model(tcfg))(tparams, batch)
    _, want = Model(tcfg).loss(tparams, batch)
    assert float(m["loss"]) == float(want["loss"])
    assert not m["loss"].requires_grad


def _smoke(quant: bool):
    from repro_torch import configs as TC

    cfg = TC.get_smoke("smollm-135m")
    if quant:
        cfg = cfg.replace(quant=QuantPolicy(cfg=QuantConfig(n_shifts=3),
                                            mode="qat"))
    return cfg


@pytest.mark.parametrize("quant", [False, True])
def test_trainer_loss_decreases_and_restart_bitexact(tmp_path, quant):
    cfg = _smoke(quant)
    kw = dict(seq_len=32, global_batch=8, total_steps=10, ckpt_every=4,
              warmup=2, peak_lr=1e-2, device="cpu")
    out_a = Trainer(cfg, workdir=str(tmp_path / "a"), **kw).run(10)
    assert out_a["last_loss"] < out_a["first_loss"] + 0.1
    b1 = Trainer(cfg, workdir=str(tmp_path / "b"), fail_at_step=6, **kw)
    with pytest.raises(SimulatedFailure):
        b1.run(10)
    assert sorted(os.listdir(tmp_path / "b")) == ["step_00000004"]
    out_b = Trainer(cfg, workdir=str(tmp_path / "b"), **kw).run(10)
    assert out_b["losses"] == out_a["losses"][4:]
    ga, gb = leaves_by_path(out_a["state"].params), leaves_by_path(
        out_b["state"].params)
    assert all(torch.equal(ga[k], gb[k]) for k in ga)
    assert [r["step"] for r in out_b["records"]] == list(range(5, 11))


def test_straggler_deadline_counter():
    tr = Trainer(_smoke(False), seq_len=32, global_batch=8, total_steps=3,
                 warmup=1, step_deadline_s=1e-9, device="cpu")
    assert tr.run(3)["straggler_events"] >= 2


def test_trainer_needs_a_card_or_cpu_and_refuses_a_mesh():
    """A mesh of another device type than the trainer's is refused."""

    class CudaMesh:
        device_type = "cuda"

    with pytest.raises(ValueError, match="mesh on cuda"):
        Trainer(_smoke(False), mesh=CudaMesh(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Trainer(_smoke(False))


def test_trainer_follows_the_reference_trainer():
    """The reference's Trainer and the port's from the same bridged params
    (float32, QAT at 3 shifts, 4 steps of the cosine schedule): the same
    batches, losses within rtol 2e-4 step for step."""
    jcfg, tcfg, jparams, tparams = qat_configs("float32", 3)
    kw = dict(seq_len=32, global_batch=4, total_steps=4, warmup=2,
              peak_lr=LR)
    want = jloop.Trainer(jcfg, init_params=jparams, **kw).run(4)["losses"]
    got = Trainer(tcfg, init_params=tparams, device="cpu", **kw).run(4)[
        "losses"]
    np.testing.assert_allclose(got, want, rtol=2e-4)
