"""Shared fixtures of the PyTorch port's tests (``tests/test_torch_*.py``).

Tests that need the card carry the ``gpu`` marker and take the
``cuda_device`` fixture, which skips when no CUDA device is present. The
decision is made when the test runs, never at import or collection, so
every worker collects the same tests. On the card:
``python -m pytest -q -m gpu tests/test_torch_*.py``.
"""
import pytest
import torch


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with "
                    "`python -m pytest -m gpu tests/test_torch_*.py`")
    # plain float32 products in the plain versions, as the kernels compute
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")
