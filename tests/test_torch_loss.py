"""Port parity of ``Model.loss`` and its gradients, as the reference's
``tests/test_models.py::test_smoke_forward_and_train_step`` drives them:
the smoke config of each dense and MoE arch (float32 compute), the JAX
package's random params bridged into the port, a batch with masked
labels. The loss, its parts and the accuracy within rtol 1e-5; every
gradient leaf within 1e-4 x its max |g| (a leaf the loss never reads has
``None`` in the port and zeros in the reference). The recurrent, VLM and
encoder archs are in ``test_torch_loss_families.py``."""
import pytest

from torch_train_port import check_loss_and_grads

pytest.importorskip("jax")  # the card's test environment has no JAX

ARCHS = ["smollm-135m", "phi3-mini-3.8b", "deepseek-7b", "mistral-large-123b",
         "qwen2-moe-a2.7b", "dbrx-132b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    check_loss_and_grads(arch)
