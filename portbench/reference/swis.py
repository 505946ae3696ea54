"""SWIS dequantization in plain PyTorch, frozen with the benchmark.

The packed format (the SWIS paper, section 3.3), for a (K, N) weight in
groups of ``M`` weights along K:

* ``sign_plane`` int32 (K/32, N): bit b of word w is weight 32*w + b, set
  when the weight is negative;
* ``mask_planes`` int32 (P, K/32, N): plane j says which weights hold
  shift j;
* ``shifts`` uint8 (K/M, N, ceil(P/2)): the group's P shift values, two a
  byte, low nibble first;
* ``scale`` float32 (1, N).

w[k, n] = sign * sum_j mask_j[k, n] * 2**shift_j[k // M, n] * scale[n].
Leading axes (layers, experts) pass through.
"""
from __future__ import annotations

import torch


def _bits(words: torch.Tensor) -> torch.Tensor:
    """(..., K/32, N) int32 words -> (..., K, N) int32 {0, 1}."""
    b = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words.unsqueeze(-2) >> b.view(32, 1)) & 1  # (..., K/32, 32, N)
    return bits.reshape(*words.shape[:-2], words.shape[-2] * 32,
                        words.shape[-1])


def dequant(leaf: dict) -> torch.Tensor:
    """Dense float32 weights of a packed leaf, any leading axes."""
    sign = 1 - 2 * _bits(leaf["sign_plane"])
    planes = leaf["mask_planes"].shape[-3]
    k = sign.shape[-2]
    group = k // leaf["shifts"].shape[-3]
    acc = torch.zeros_like(sign)
    for j in range(planes):
        byte = leaf["shifts"][..., j // 2].to(torch.int32)
        nib = (byte >> (4 * (j % 2))) & 0xF
        acc += _bits(leaf["mask_planes"][..., j, :, :]) << \
            nib.repeat_interleave(group, dim=-2)
    return (sign * acc).float() * leaf["scale"].float()
