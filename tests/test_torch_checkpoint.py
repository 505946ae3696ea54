"""Checkpoints across the two packages. The port's manager writes the
reference's files (``.params__embed__tok.npy``, ``manifest.json`` with the
step, data cursor and sorted key paths), atomically, with retention and an
async writer. A checkpoint the JAX trainer writes restores in the port
leaf for leaf, the port's trainer resumes from it (float32 compute,
losses within rtol 1e-5), and both serve
launchers' ``--ckpt`` serve it to the same greedy tokens; a checkpoint
the port's trainer writes restores in the JAX manager leaf for leaf."""
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs as TC
from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch import serve as tserve
from repro_torch.models.model import Model
from repro_torch.train import Trainer, TrainState
from torch_train_port import leaves_by_path

pytest.importorskip("jax")  # the card's test environment has no JAX
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import repro.configs as C  # noqa: E402
from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import params as jpp  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro.train.steps import init_state as jinit_state  # noqa: E402

ARCH = "smollm-135m"
TRAIN = dict(seq_len=16, global_batch=4, total_steps=4, ckpt_every=2,
             warmup=2, peak_lr=1e-2)


def _template():
    tree = Model(TC.get_smoke(ARCH)).build()
    return TrainState(step=None, params=tree, opt={"m": tree, "v": tree})


def _assert_state_equal(port_state, jax_state):
    got = leaves_by_path({"step": port_state.step,
                          "params": port_state.params, "opt": port_state.opt})
    want = leaves_by_path({"step": jax_state.step,
                           "params": jax_state.params, "opt": jax_state.opt})
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                      "/".join(k))


def test_manager_roundtrip_retention_async(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "b": {"c": torch.ones(4)}}
    for step in (1, 2, 3):
        cm.save(step, tree, meta={"data": {"step": step}},
                blocking=(step != 3))
        tree["b"]["c"] += 1  # a later change never reaches a saved step
    cm.wait()
    assert cm.all_steps() == [2, 3]
    restored, meta = cm.restore({"a": None, "b": {"c": None}})
    assert meta["step"] == 3 and meta["keys"] == ["a", "b/c"]
    assert torch.equal(restored["a"], tree["a"])
    assert torch.equal(restored["b"]["c"], torch.full((4,), 3.0))
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    with pytest.raises(KeyError, match="missing leaf"):
        cm.restore({"a": None, "z": None})


def test_jax_checkpoint_restores_resumes_and_serves(tmp_path, capsys,
                                                    monkeypatch):
    jcfg = C.get_smoke(ARCH).replace(compute_dtype="float32")
    out = jloop.Trainer(jcfg, workdir=str(tmp_path / "jax"), **TRAIN).run(4)
    jfiles = sorted(os.listdir(tmp_path / "jax" / "step_00000004"))
    assert ".params__embed__tok.npy" in jfiles

    # restore leaf for leaf, and the same file names when the port saves it
    state, meta = CheckpointManager(str(tmp_path / "jax")).restore(
        _template())
    assert meta["step"] == 4 and meta["data"] == {"seed": 0, "step": 4}
    _assert_state_equal(state, out["state"])
    CheckpointManager(str(tmp_path / "port")).save(4, state, meta={
        "data": meta["data"], "loss": meta["loss"]})
    assert sorted(os.listdir(tmp_path / "port" / "step_00000004")) == jfiles
    manifest = [json.load(open(tmp_path / d / "step_00000004" /
                               "manifest.json")) for d in ("jax", "port")]
    assert manifest[0] == manifest[1]

    # the port's trainer resumes the reference's run at step 2
    shutil.copytree(tmp_path / "jax" / "step_00000002",
                    tmp_path / "resume" / "step_00000002")
    tout = Trainer(TC.get_smoke(ARCH).replace(compute_dtype="float32"),
                   workdir=str(tmp_path / "resume"), device="cpu",
                   **TRAIN).run(4)
    np.testing.assert_allclose(tout["losses"], out["losses"][2:], rtol=1e-5)

    # both launchers serve the checkpoint to the same greedy tokens
    for extra in ([], ["--packed"]):
        argv = ["--arch", ARCH, "--smoke", "--requests", "2", "--n-slots",
                "2", "--prompt-len", "8", "--tokens", "6", "--ckpt",
                str(tmp_path / "jax")] + extra
        monkeypatch.setattr(sys, "argv", ["serve"] + argv)
        jserve.main()
        want = capsys.readouterr().out.rsplit("sample:", 1)[1]
        tserve.run(tserve.parse_args(argv + ["--device", "cpu"]))
        got = capsys.readouterr().out.rsplit("sample:", 1)[1]
        assert json.loads(got) == json.loads(want), extra


def test_port_checkpoint_restores_in_jax(tmp_path):
    tr = Trainer(TC.get_smoke(ARCH), workdir=str(tmp_path), device="cpu",
                 **TRAIN)
    out = tr.run(4)
    template = jinit_state(jpp.abstract_params(JModel(
        C.get_smoke(ARCH)).build()))
    jstate, meta = JManager(str(tmp_path)).restore(template)
    assert meta["step"] == 4 and meta["data"] == {"seed": 0, "step": 4}
    assert meta["loss"] == out["losses"][-1]
    _assert_state_equal(out["state"], jax.tree.map(jnp.asarray, jstate))
    assert np.asarray(jstate.step).dtype == np.int32
