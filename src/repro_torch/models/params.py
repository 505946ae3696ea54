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


def abstract_params(tree, dtype=torch.float32):
    """Shape and dtype stand-ins for a placeholder tree, as tensors on the
    ``meta`` device (no allocation): the dry-run's state."""
    return tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype or dtype,
                                          device="meta"), tree)


map_placeholders = tree_map


def count_params(tree) -> int:
    """Number of weights a placeholder tree describes (no allocation)."""
    total = 0

    def add(p: P):
        nonlocal total
        total += int(np.prod(p.shape, dtype=np.int64))

    tree_map(add, tree)
    return total


def init_params_layerwise(tree, generator: Optional[torch.Generator],
                          dtype=torch.float32, device="cuda",
                          transform: Optional[Callable] = None):
    """:func:`init_params` for a model tree whose ``"blocks"`` subtree is
    stacked over layers, never holding that subtree whole before
    ``transform``: each layer is materialized on its own, passed through
    ``transform`` as ``{"blocks": layer}`` and copied into stacked tensors
    allocated once, at the first layer's transformed shapes; each other
    top-level subtree is materialized and passed through as ``{key:
    subtree}``. ``transform`` returns a tree of the same top-level key
    (identity by default; :func:`repro_torch.serve.quantized.
    init_packed_params` packs each layer with it, so a model too large in
    float32 is built packed). Draws come from ``generator`` in the tree's
    key order, layer by layer within the blocks: the numbers differ from
    :func:`init_params`'s, which draws each stacked leaf at once."""
    dev = _device.resolve(device)
    transform = transform or (lambda t: t)
    out = {}
    for key, sub in tree.items():
        if key != "blocks":
            out.update(transform({key: init_params(sub, generator, dtype,
                                                   dev)}))
            continue
        n = _first_leaf(sub).shape[0]
        layer = tree_map(lambda p: P(p.shape[1:], p.axes[1:], p.init,
                                     p.scale, p.dtype), sub)
        stacked = None
        for i in range(n):
            got = transform({"blocks": init_params(layer, generator, dtype,
                                                   dev)})["blocks"]
            if stacked is None:
                stacked = tree_map(lambda a: torch.empty(
                    (n,) + tuple(a.shape), dtype=a.dtype, device=a.device),
                    got)
            _copy_layer(stacked, got, i)
            del got
        out["blocks"] = stacked
    return out


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def _copy_layer(dst, src, i: int) -> None:
    if isinstance(dst, dict):
        for k in dst:
            _copy_layer(dst[k], src[k], i)
    else:
        dst[i].copy_(src)
