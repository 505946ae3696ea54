"""``Model.loss`` and its gradients against the reference (see
``test_torch_loss.py``) for the VLM (with patches, ``xgate`` 0.5 in both
packages) and the encoder (frames; its unused token table has no
gradient in the port and a zero one in the reference)."""
import pytest

from torch_train_port import check_loss_and_grads

pytest.importorskip("jax")  # the card's test environment has no JAX


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "hubert-xlarge"])
def test_loss_and_grads_match_jax(arch):
    check_loss_and_grads(arch)
