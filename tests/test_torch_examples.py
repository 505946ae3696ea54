"""The port's training examples on the CPU at a few steps:
``examples.train_swis_qat`` trains under QAT, checkpoints and reads PTQ
against QAT accuracy; ``examples.quickstart``'s RMSE table equals the
reference's ``fake_quant`` RMSEs (rtol 1e-6), its packed product equals
the dense one, and its PTQ accuracies are read from a trained model."""
import numpy as np
import pytest
import torch

from repro_torch.examples import quickstart, train_swis_qat


def test_train_swis_qat_example(tmp_path):
    out = train_swis_qat.main(["--steps", "6", "--device", "cpu",
                               "--workdir", str(tmp_path)])
    assert all(np.isfinite(out["loss"]))
    assert 0.0 <= out["ptq"] <= 1.0 and 0.0 <= out["qat"] <= 1.0
    assert sorted(p.name for p in tmp_path.iterdir())[-1] == "step_00000006"


def test_quickstart_example():
    pytest.importorskip("jax")  # the card's test environment has no JAX
    import jax.numpy as jnp
    from repro.core.swis import QuantConfig, fake_quant, rmse

    torch.manual_seed(0)
    out = quickstart.main(["--device", "cpu", "--steps", "10"])
    w = jnp.asarray(np.random.default_rng(0).normal(0, 0.05, (256, 128))
                    .astype(np.float32))
    for (n, method), got in out["rmse"].items():
        want = float(rmse(w, fake_quant(w, QuantConfig(
            method=method, n_shifts=n, group_size=4))))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    assert out["rel_err"] < 1e-6
    assert all(0.0 <= a <= 1.0 for a in out["accuracy"].values())
