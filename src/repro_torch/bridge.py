"""Carry parameters from the JAX reference package into the port.

The reference initializes parameters from Python's salted ``hash()``, so two
processes never draw the same weights; parity tests therefore build the
reference's params once and bridge them into the port in the same process.
The bridge takes a nested dict of numpy arrays (``np.asarray`` of each JAX
leaf) and imports neither JAX nor the reference package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.models.params import tree_map

_DTYPES = (np.float32, np.float16, np.int32, np.uint8)


def from_jax_params(tree, device="cuda"):
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``.

    Packed ``uint32`` planes cross as ``int32`` views of the same bits;
    ``uint8`` shift bytes, ``int32``, ``float32`` and ``float16`` leaves keep
    their dtype; any other dtype raises.
    """
    dev = _device.resolve(device)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        if a.dtype not in _DTYPES:
            raise ValueError(f"cannot bridge a leaf of dtype {a.dtype}")
        return torch.from_numpy(np.array(a)).to(dev)

    return tree_map(leaf, tree)
