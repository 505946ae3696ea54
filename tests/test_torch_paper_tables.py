"""The port's trained-model paper tables (``repro_torch.benchmarks``)
against the reference's (``benchmarks/paper_tables.py``) on the CPU (the
others are in ``test_torch_paper_tables_host.py``):

- Tables 3, 2 and Fig. 6: the reference's model, trained a
  few steps in this process (its checkpoint under ``tmp_path``), carried
  into the port with ``bridge.from_jax_params``; both sides evaluate one
  held-out batch per quantization config (each config once), so that the
  reference's eager evaluation fits the file's time. Row names equal; the
  offline scheduling rows and the RMSE rows equal exactly; accuracies
  within ``ACC_TOL`` (below).
- Table 5 at a few QAT steps: the port's warm-started losses follow the
  reference's ``Trainer`` with the same arguments (rtol 2e-4, as
  ``test_torch_trainer.py``), and the carried params are left unchanged.
"""
import numpy as np
import pytest
import torch

import torch_port  # noqa: F401  (one torch thread under xdist)
from repro_torch import configs as TC
from repro_torch.benchmarks import common as tcommon
from repro_torch.benchmarks import paper_tables as tpt
from repro_torch.bridge import from_jax_params
from repro_torch.models import params as pp
from torch_train_port import leaves_by_path

pytest.importorskip("jax")  # the card's test environment has no JAX
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from benchmarks import common as jcommon  # noqa: E402
from benchmarks import paper_tables as jpt  # noqa: E402

TRAIN_STEPS = 60  # the reference's recipe (seq 64, batch 16), cut short
# Accuracies are argmax counts over one batch of 16 x 64 predictions: the
# same weights give logits a few ulps apart in the two packages, which can
# flip a near tie, 1/1024 of accuracy each.
ACC_TOL = 2 / 1024


def _one_batch_once(eval_acc):
    """``eval_acc`` on one held-out batch, each quantization config
    evaluated once (Tables 3, 2 and Fig. 6 repeat some)."""
    seen = {}

    def f(cfg, eval_params=None, n_batches=1):
        if eval_params is not None:
            return eval_acc(cfg, eval_params, n_batches)
        key = repr(cfg.quant)
        if key not in seen:
            seen[key] = eval_acc(cfg, n_batches=n_batches)
        return seen[key]

    return f


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """(reference triple, port triple) on the same trained weights."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcommon, "BENCH_DIR", str(tmp_path_factory.mktemp("bench")))
        mp.setattr(jcommon, "_MODEL_CACHE", {})
        jcfg, jparams, jeval = jcommon.trained_smoke_model(steps=TRAIN_STEPS)
    tcfg = TC.get_smoke("smollm-135m").replace(compute_dtype="float32")
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    teval = tcommon.eval_fn(tcfg, tparams, device="cpu")
    return ((jcfg, jparams, _one_batch_once(jeval)),
            (tcfg, tparams, _one_batch_once(teval)))


def _assert_rows_close(got, want, exact):
    """Equal names; rows whose name starts with one of ``exact`` equal
    strings, the accuracy rows within ``ACC_TOL``."""
    assert [r[0] for r in got] == [r[0] for r in want]
    for (name, _, g), (_, _, w) in zip(got, want):
        if name.startswith(exact):
            assert g == w, name
        else:
            assert abs(float(g) - float(w)) <= ACC_TOL, (name, g, w)


@pytest.mark.parametrize("name,exact", [
    ("table3_ptq", ()),
    ("table2_scheduling", ("table2/offline/",)),
    ("fig6_groupsize", ("fig6/rmse/",)),
])
def test_trained_tables_follow_the_reference(models, monkeypatch, name,
                                             exact):
    jmodel, tmodel = models
    monkeypatch.setattr(jpt, "trained_smoke_model", lambda: jmodel)
    want = getattr(jpt, name)()
    got = getattr(tpt, name)(device="cpu", model=tmodel)
    _assert_rows_close(got, want, exact)


def test_table5_warm_starts_from_a_copy_and_follows_the_reference(
        models, monkeypatch):
    from repro.train.loop import Trainer as JTrainer

    (jcfg, jparams, jeval), tmodel = models
    seen = {}

    class Recording(tpt.Trainer):
        def run(self, n_steps=None):
            seen["kwargs"] = dict(seq_len=self.seq_len,
                                  global_batch=self.global_batch,
                                  total_steps=self.total_steps,
                                  warmup=self.warmup, peak_lr=self.peak_lr)
            seen["cfg"] = self.cfg
            out = super().run(n_steps)
            seen["losses"] = out["losses"]
            return out

    monkeypatch.setattr(tpt, "Trainer", Recording)
    before = pp.tree_map(torch.clone, tmodel[1])
    rows = tpt.table5_retraining(device="cpu", model=tmodel, qat_steps=3)
    assert [r[0] for r in rows] == ["table5/ptq_swis/N2", "table5/qat_swis/N2",
                                    "table5/ptq_trunc/N2"]
    after = leaves_by_path(tmodel[1])
    assert all(torch.equal(v, after[k]) for k, v in
               leaves_by_path(before).items())
    assert seen["kwargs"] == dict(seq_len=64, global_batch=16, total_steps=3,
                                  warmup=10, peak_lr=5e-4)
    assert seen["cfg"].quant.mode == "qat"
    ptq = jcommon.quant_policy("swis", 2)
    jqat = jcfg.replace(quant=ptq.__class__(cfg=ptq.cfg, mode="qat"))
    want = JTrainer(jqat, init_params=jax.tree.map(jnp.array, jparams),
                    **seen["kwargs"]).run(3)["losses"]
    np.testing.assert_allclose(seen["losses"], want, rtol=2e-4)
    for (name, _, got), cfg in ((rows[0], jcfg.replace(quant=ptq)), (
            rows[2], jcfg.replace(quant=jcommon.quant_policy("trunc", 2)))):
        assert abs(float(got) - jeval(cfg)) <= ACC_TOL, name
