"""Plain PyTorch versions of the port's kernels.

Each function computes what its CUDA kernel computes, from the same
operands, with the reference package's arithmetic:

* :func:`dequant_ref` / :func:`swis_matmul_ref` — ``repro.kernels.ref``;
* :func:`swis_matmul_experts_ref` — the reference's MoE expert GEMM
  (``repro.models.moe``): every expert's weights dequantized
  (``repro.serve.quantized.dequant_leaf``), then one einsum;
* :func:`paged_attention_ref` — ``repro.kernels.paged_attention.
  _paged_attention_xla``: the same online-softmax recurrence over logical
  blocks with the same mask fill, one (B, block_size) slab per step.

The kernel wrappers take these for CPU tensors; the tests and
``chip_smoke.py`` hold the kernels against them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.packing import unpack_bits_u32


def dequant_ref(sign_plane: torch.Tensor, mask_planes: torch.Tensor,
                shifts: torch.Tensor, scale: torch.Tensor, *, group: int,
                dtype=torch.float32, consecutive: bool = False,
                keep_slices: Optional[int] = None) -> torch.Tensor:
    """Dense (K, N) dequantized weights from packed planes.

    ``consecutive``: SWIS-C layout — ``shifts`` holds one offset byte per
    group and shift j = offset + j. ``keep_slices``: keep only the k most
    significant bit-planes (plane shifts ascend, so the last k).
    """
    n_shifts = mask_planes.shape[0]
    if keep_slices is not None and not 1 <= keep_slices <= n_shifts:
        raise ValueError(
            f"keep_slices must be in [1, {n_shifts}], got {keep_slices}")
    first = 0 if keep_slices is None else n_shifts - keep_slices
    sign = 1 - 2 * unpack_bits_u32(sign_plane)  # (K, N) int32
    acc = torch.zeros_like(sign)
    for j in range(first, n_shifts):
        bits = unpack_bits_u32(mask_planes[j])
        if consecutive:
            s = shifts[:, :, 0].to(torch.int32) + j
        else:
            s = (shifts[:, :, j // 2].to(torch.int32) >> (4 * (j % 2))) & 0xF
        acc += bits << s.repeat_interleave(group, dim=0)
    w = (sign * acc).float() * scale.float().reshape(1, -1)
    return w.to(dtype)


def swis_matmul_ref(x: torch.Tensor, sign_plane: torch.Tensor,
                    mask_planes: torch.Tensor, shifts: torch.Tensor,
                    scale: torch.Tensor, *, group: int,
                    consecutive: bool = False,
                    keep_slices: Optional[int] = None) -> torch.Tensor:
    """``x (M, K) @ dequant(planes) -> (M, N) float32``. The weights are
    rounded to ``x.dtype`` and the product accumulates in float32, as the
    reference's ``preferred_element_type=float32`` dot does."""
    w = dequant_ref(sign_plane, mask_planes, shifts, scale, group=group,
                    dtype=x.dtype, consecutive=consecutive,
                    keep_slices=keep_slices)
    return torch.matmul(x.float(), w.float())


def swis_matmul_experts_ref(x: torch.Tensor, sign_plane: torch.Tensor,
                            mask_planes: torch.Tensor, shifts: torch.Tensor,
                            scale: torch.Tensor, *, group: int,
                            consecutive: bool = False,
                            keep_slices: Optional[int] = None) -> torch.Tensor:
    """``x (E, M, K)`` against a stack of E packed (K, N) weights ->
    (E, M, N) float32: each expert dequantized to ``x.dtype``, then
    ``einsum("emk,ekn->emn")`` in float32."""
    w = torch.stack([
        dequant_ref(s, m, sh, sc, group=group, dtype=x.dtype,
                    consecutive=consecutive, keep_slices=keep_slices)
        for s, m, sh, sc in zip(sign_plane, mask_planes, shifts, scale)])
    return torch.einsum("emk,ekn->emn", x.float(), w.float())


def paged_attention_ref(q4: torch.Tensor, k_arena: torch.Tensor,
                        v_arena: torch.Tensor, pos_arena: torch.Tensor,
                        block_tables: torch.Tensor, q_pos: torch.Tensor,
                        q_lens: torch.Tensor, *, sq: int, causal: bool,
                        window: Optional[int], neg: float) -> torch.Tensor:
    """q4: (B, Hkv, Sq*G, Dh) -> (B, Hkv, Sq*G, Dh) float32.

    Scores that are masked get ``neg`` (the float32 mask fill), the same
    value the running max starts from, so a row whose every score is
    masked ends as the unweighted mean of V over every position its table
    visits — the reference's behaviour, reproduced here on purpose.
    """
    b, hkv, sg, dh = q4.shape
    g = sg // sq
    dev = q4.device
    qh = q4.float() * (dh ** -0.5)
    qi = torch.arange(sq, dtype=torch.int32, device=dev)
    qpos = q_pos[:, None] + qi[None, :]  # (B, Sq)
    qvalid = qi[None, :] < q_lens[:, None]
    qpos_sg = qpos.repeat_interleave(g, dim=1)  # (B, Sq*G)
    qvalid_sg = qvalid.repeat_interleave(g, dim=1)
    m = torch.full((b, hkv, sg), neg, dtype=torch.float32, device=dev)
    denom = torch.zeros((b, hkv, sg), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, sg, dh), dtype=torch.float32, device=dev)
    for tcol in block_tables.long().T:  # (B,) physical ids of logical block j
        kj = k_arena[tcol].float()  # (B, bs, Hkv, Dh)
        vj = v_arena[tcol].float()
        pj = torch.where((tcol == 0)[:, None], -1, pos_arena[tcol])  # (B, bs)
        s = torch.einsum("bhgd,bkhd->bhgk", qh, kj)
        valid = (pj[:, None, None, :] >= 0) & qvalid_sg[:, None, :, None]
        if causal:
            valid = valid & (pj[:, None, None, :] <= qpos_sg[:, None, :, None])
        if window is not None:
            valid = valid & (pj[:, None, None, :]
                             > qpos_sg[:, None, :, None] - window)
        s = torch.where(valid, s, neg)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        denom = denom * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgk,bkhd->bhgd", p, vj)
        m = m_new
    return acc / torch.clamp_min(denom[..., None], 1e-30)
