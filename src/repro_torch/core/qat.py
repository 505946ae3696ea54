"""Quantization-aware retraining support (paper §5.1.2): PyTorch port of
``repro.core.qat``.

The forward pass quantizes weights with SWIS (shift selection re-run per
step, "treated as a special quantization, updated per batch input"); the
backward pass is a straight-through estimator (STE), so gradients flow to
the latent full-precision weights unchanged.
"""
from __future__ import annotations

import torch

from repro_torch.core.swis import QuantConfig, fake_quant, fake_quant_stack


class _Ste(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, cfg, stacked):
        return (fake_quant_stack if stacked else fake_quant)(w, cfg)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def ste_quant(w: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    """SWIS fake-quant with identity (straight-through) gradient."""
    return _Ste.apply(w, cfg, False)


def ste_quant_stack(w: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    """:func:`ste_quant` of every ``w[i]`` on its own (the reference's
    ``jax.vmap(ste_quant)``)."""
    return _Ste.apply(w, cfg, True)


def quantize_tree(params, qcfg: QuantConfig):
    """STE fake-quant of every eligible GEMM weight leaf of a parameter
    tree, once per optimizer step.

    As in the reference, a 3-D leaf (layers, K, C) is quantized layer by
    layer and every other rank as one tensor whose leading axis is the
    reduction axis: a stacked MoE expert leaf (layers, E, K, N) is
    quantized along its layer axis with one scale for the whole stack
    (``repro.core.qat.quantize_tree`` vmaps ``ndim == 3`` leaves only).
    """
    from repro_torch.serve.quantized import _eligible

    def walk(path, node):
        if isinstance(node, dict):
            return {k: walk(path + (k,), v) for k, v in node.items()}
        if not _eligible(path, node):
            return node
        if node.ndim == 3:
            return ste_quant_stack(node, qcfg)
        return ste_quant(node, qcfg)

    return walk((), params)


def maybe_quant(w: torch.Tensor, cfg: QuantConfig | None, mode: str,
                stacked: bool = False) -> torch.Tensor:
    """Uniform entry point used by model layers.

    mode: 'off' (no quant), 'qat' (STE fake-quant), 'ptq' (fake-quant, no
    gradient bypass: the gradient flows through the scale alone).
    ``stacked``: quantize each ``w[i]`` on its own (MoE expert stacks).
    """
    if cfg is None or cfg.method == "none" or mode == "off":
        return w
    if mode == "qat":
        return (ste_quant_stack if stacked else ste_quant)(w, cfg)
    if mode == "ptq":
        return (fake_quant_stack if stacked else fake_quant)(w, cfg)
    raise ValueError(f"unknown quant mode {mode!r}")
