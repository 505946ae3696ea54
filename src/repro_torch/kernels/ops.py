"""Public SWIS matmul ops.

:func:`swis_matmul` ports ``repro.kernels.ops.swis_matmul``: ``x @
dequant(pw)`` for any rank of ``x``. The device of ``x`` picks the path (the
CUDA kernel on the card, the plain version on the CPU); a
``torch.autograd.Function`` makes it differentiable in ``x``: the weights
are frozen after PTQ and the gradient is ``g @ dequant(w, keep_slices).T``,
as the reference's custom VJP computes it.

:func:`swis_matmul_experts` is the MoE expert GEMM over a packed expert
stack, one launch for every expert; forward only (its backward comes with
the training path).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.packing import PackedWeight
from repro_torch.kernels import ref
from repro_torch.kernels.swis_matmul import (swis_matmul_experts_packed,
                                             swis_matmul_packed)


class _SwisMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sign_plane, mask_planes, shifts, scale, group,
                n_shifts, consecutive, keep_slices):
        ctx.save_for_backward(sign_plane, mask_planes, shifts, scale)
        ctx.static = (group, consecutive, keep_slices)
        return swis_matmul_packed(
            x, sign_plane, mask_planes, shifts, scale, n_shifts=n_shifts,
            group=group, consecutive=consecutive, keep_slices=keep_slices)

    @staticmethod
    def backward(ctx, g):
        group, consecutive, keep_slices = ctx.static
        sign_plane, mask_planes, shifts, scale = ctx.saved_tensors
        # the gradient of a truncated matmul is the truncated w^T
        w = ref.dequant_ref(sign_plane, mask_planes, shifts, scale,
                            group=group, dtype=g.dtype,
                            consecutive=consecutive, keep_slices=keep_slices)
        return (g @ w.T,) + (None,) * 8


def swis_matmul(x: torch.Tensor, pw: PackedWeight, *,
                keep_slices: Optional[int] = None) -> torch.Tensor:
    """``x @ dequant(pw)`` over the last axis of ``x`` -> float32.

    ``keep_slices=k`` evaluates only the k most significant bit-planes
    (None = all planes)."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1]).contiguous()
    # a per-tensor scale broadcasts over the columns, as in the reference
    scale = pw.scale.reshape(-1).expand(pw.sign_plane.shape[1]).contiguous()
    y = _SwisMatmul.apply(
        x2, pw.sign_plane, pw.mask_planes, pw.shifts, scale, pw.group_size,
        pw.n_shifts, pw.method == "swis_c", keep_slices)
    return y.reshape(*shape[:-1], y.shape[-1])


def swis_matmul_experts(x: torch.Tensor, leaf: dict, *,
                        consecutive: bool = False,
                        keep_slices: Optional[int] = None) -> torch.Tensor:
    """``x[e] @ dequant(leaf[e])`` for each expert e of a packed stack
    ``leaf`` (sign (E, K/32, N), masks (E, n, K/32, N), shifts, scale (E,
    1, N)) -> (E, M, N) float32. ``x`` is (E, M, K), or (M, K) rows that
    every expert reads. ``consecutive``: the SWIS-C shift layout."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError(
            "swis_matmul_experts is forward-only; its backward comes with "
            "the training path")
    sign, mask, shifts = (leaf["sign_plane"], leaf["mask_planes"],
                          leaf["shifts"])
    e = sign.shape[0]
    if x.ndim == 2:  # one set of rows for every expert: expert stride 0
        x = x.contiguous()[None].expand(e, *x.shape)
    elif not (x.stride(0) == 0 and x[0].is_contiguous()):
        x = x.contiguous()
    return swis_matmul_experts_packed(
        x, sign, mask, shifts, leaf["scale"], n_shifts=int(mask.shape[-3]),
        group=sign.shape[-2] * 32 // shifts.shape[-3],
        consecutive=consecutive, keep_slices=keep_slices)
