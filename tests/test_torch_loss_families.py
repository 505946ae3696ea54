"""``Model.loss`` and its gradients against the reference (see
``test_torch_loss.py``) for the recurrent families."""
import pytest

from torch_train_port import check_loss_and_grads

pytest.importorskip("jax")  # the card's test environment has no JAX


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "mamba2-2.7b"])
def test_loss_and_grads_match_jax(arch):
    check_loss_and_grads(arch)
