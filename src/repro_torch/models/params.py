"""Parameter placeholder trees (PyTorch port of ``repro.models.params``).

Model ``build*`` functions return nested dicts of :class:`P` placeholders
(shape + logical axes + initializer); :func:`init_params` materializes one
into tensors. Parameter trees are plain nested dicts of tensors, stacked
layers carrying a leading layer axis, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as _device


@dataclasses.dataclass(frozen=True)
class P:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical axis names, len == ndim
    init: str = "normal"  # 'normal' | 'zeros' | 'ones' | 'fill' | 'embed'
    scale: Optional[float] = None  # stddev ('normal'/'embed') or fill value
    dtype: Any = None  # param dtype override (torch dtype)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def is_placeholder(x) -> bool:
    return isinstance(x, P)


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every non-dict leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def stack(tree, n: int, axis_name: str = "layers"):
    """Prepend a stacked-layers axis to every placeholder in the tree."""
    return tree_map(
        lambda p: P((n,) + p.shape, (axis_name,) + p.axes, p.init, p.scale,
                    p.dtype), tree)


def init_params(tree, generator: Optional[torch.Generator] = None,
                dtype=torch.float32, device="cuda"):
    """Materialize a placeholder tree into tensors on ``device``.

    Random leaves are drawn in the tree's order from ``generator``, with the
    reference's distributions: ``normal`` leaves are N(0, 1/fan_in) (or
    ``scale``), ``embed`` leaves N(0, scale). The numbers differ from the
    reference's ``jax.random`` draws; parity tests bridge the reference's
    params instead (:mod:`repro_torch.bridge`).
    """
    dev = _device.resolve(device)

    def make(p: P):
        dt = p.dtype or dtype
        if p.init == "zeros":
            return torch.zeros(p.shape, dtype=dt, device=dev)
        if p.init == "ones":
            return torch.ones(p.shape, dtype=dt, device=dev)
        if p.init == "fill":
            return torch.full(p.shape, p.scale, dtype=dt, device=dev)
        if generator is None:
            raise ValueError("random init needs a torch.Generator")
        if p.init == "embed":
            std = p.scale if p.scale is not None else 1.0
        else:
            fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
            std = (p.scale if p.scale is not None
                   else 1.0 / np.sqrt(max(fan_in, 1)))
        x = torch.randn(p.shape, generator=generator, device=generator.device)
        return (x * std).to(device=dev, dtype=dt)

    return tree_map(make, tree)
