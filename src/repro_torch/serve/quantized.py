"""SWIS-packed parameters for serving (PyTorch port of ``repro.serve.quantized``).

``pack_tree`` walks a parameter tree and replaces every eligible GEMM weight
(``{'w': (..., K, C)}`` leaves, leading axes being stacked layers) with its
packed SWIS representation {sign_plane, mask_planes, shifts, scale}. The
model's ``dense`` path detects packed leaves and runs the SWIS matmul
kernel on them, so the weight bytes a GEMM reads are the packed bytes.
Already-packed leaves pass through unchanged, so packing a packed tree is a
no-op.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core import packing, selection
from repro_torch.core.swis import QuantConfig, _true_div, quantize
from repro_torch.models import params as pp

PACKED_KEYS = ("sign_plane", "mask_planes", "shifts", "scale")


def is_packed(leaf) -> bool:
    return isinstance(leaf, dict) and "mask_planes" in leaf


def _eligible(path_keys, arr) -> bool:
    # any rank >= 2: trailing (K, C) is the GEMM matrix, leading dims are
    # stacked layers and/or experts
    if len(arr.shape) < 2:
        return False
    k = arr.shape[-2]
    if k % 32 or k < 64:
        return False
    name = str(path_keys[-1])
    if name not in ("w", "wi", "wo", "wg", "shared_wi", "shared_wo",
                    "shared_wg"):
        return False
    joined = "/".join(str(p) for p in path_keys)
    if "embed" in joined or "router" in joined or "frontend" in joined:
        return False
    return True


def _pack_matrix(w: torch.Tensor, qcfg: QuantConfig) -> Dict[str, torch.Tensor]:
    pw = packing.pack(quantize(w.float(), qcfg))
    scale = pw.scale.float()
    return {
        "sign_plane": pw.sign_plane,
        "mask_planes": pw.mask_planes,
        "shifts": pw.shifts,
        "scale": (scale.reshape(1, -1) if scale.ndim
                  else torch.full((1, w.shape[-1]), float(scale),
                                  dtype=torch.float32, device=w.device)),
    }


def _batched(qcfg: QuantConfig) -> bool:
    """Whether :func:`_pack_stack` applies: methods whose shift selection
    is per group and per column (no filter scheduling across a matrix's
    columns, no layer-wise truncation window)."""
    n_lo, n_hi, frac = qcfg.shift_levels()
    return (qcfg.method in ("swis", "swis_c")
            and (n_lo == n_hi or not qcfg.schedule or frac == 0.0))


def _pack_stack(w: torch.Tensor, qcfg: QuantConfig) -> Dict[str, torch.Tensor]:
    """:func:`_pack_matrix` of every (K, C) matrix of a stack (E, K, C) in
    one selection pass over (K, E*C): each matrix keeps its own scale and
    selection is per group and column, so every plane equals the
    matrix-by-matrix result bit for bit, in a few hundred launches a stack
    instead of a few hundred a matrix."""
    e, k, c = w.shape
    maxq = float(2 ** qcfg.bits - 1)
    absw = torch.abs(w.float())
    amax = absw.amax(dim=-2 if qcfg.per_channel else (-2, -1), keepdim=True)
    scale = torch.clamp_min(_true_div(amax, maxq), 1e-12)  # (E, 1, C)/(E, 1, 1)
    mags = torch.clamp(torch.round(absw / scale), 0.0, maxq)
    signs = torch.where(w < 0, -1.0, 1.0)
    n_lo, n_hi, _ = qcfg.shift_levels()
    out = selection.quantize_grouped(
        mags.permute(1, 0, 2).reshape(k, e * c),
        signs.permute(1, 0, 2).reshape(k, e * c), n_shifts=n_hi,
        group_size=qcfg.group_size, bits=qcfg.bits, variant=qcfg.variant,
        alpha=qcfg.alpha, chunk_elems=1 << 26)
    masks, shifts = out["masks"], out["shifts"]  # (K, E*C), (K/M, E*C, N)
    n = shifts.shape[-1]

    def experts_first(a, lead):  # (*lead, E*C, ...) -> (E, *lead, C, ...)
        a = a.reshape(*lead, e, c, *a.shape[len(lead) + 1:])
        return a.movedim(len(lead), 0).contiguous()

    planes = torch.stack([packing.pack_bits_u32((masks >> j) & 1)
                          for j in range(n)])  # (n, K/32, E*C)
    store = (shifts[..., :1].to(torch.uint8) if qcfg.method == "swis_c"
             else packing.pack_shift_nibbles(shifts))
    return {
        "sign_plane": experts_first(packing.pack_bits_u32(
            (signs < 0).permute(1, 0, 2).reshape(k, e * c).to(torch.int32)),
            (k // 32,)),
        "mask_planes": experts_first(planes, (n, k // 32)),
        "shifts": experts_first(store, (k // qcfg.group_size,)),
        "scale": scale.expand(e, 1, c).contiguous(),
    }


def pack_tree(params, qcfg: QuantConfig):
    """Returns (packed_tree, stats). Non-eligible leaves pass through."""
    n_packed = 0
    dense_bits = 0
    packed_bits = 0

    def walk(path, node):
        nonlocal n_packed, dense_bits, packed_bits
        if isinstance(node, dict):
            return {k: walk(path + (k,), v) for k, v in node.items()}
        arr = node
        if not _eligible(path, arr):
            return arr
        if arr.ndim > 2:
            lead = arr.shape[:-2]
            flat = arr.reshape(-1, *arr.shape[-2:])
            if _batched(qcfg):
                packed = _pack_stack(flat, qcfg)
                out = {k: packed[k].reshape(lead + packed[k].shape[1:])
                       for k in PACKED_KEYS}
            else:
                packed = [_pack_matrix(flat[i], qcfg)
                          for i in range(flat.shape[0])]
                out = {k: torch.stack([p[k] for p in packed]).reshape(
                    lead + packed[0][k].shape) for k in PACKED_KEYS}
        else:
            out = _pack_matrix(arr, qcfg)
        n_packed += 1
        k, c = arr.shape[-2], arr.shape[-1]
        e = int(np.prod(arr.shape[:-2])) if arr.ndim > 2 else 1
        dense_bits += e * k * c * 8
        n = int(out["mask_planes"].shape[-3])
        groups = k // qcfg.group_size * c
        shift_bits = 3 if qcfg.method == "swis_c" else 3 * n
        packed_bits += e * (k * c * (1 + n) + groups * shift_bits)
        return out

    tree = walk((), params)
    stats = {
        "n_packed": n_packed,
        "dense_bits": dense_bits,
        "packed_bits": packed_bits,
        "compression": dense_bits / max(packed_bits, 1),
    }
    return tree, stats


def init_packed_params(tree, qcfg: QuantConfig, generator, *,
                       dtype=torch.float32, device="cuda"):
    """Random weights for the placeholder ``tree``, SWIS-packed one layer
    at a time, so that the float32 tree never exists whole (qwen2-moe-a2.7b
    is ~60 GB in float32 and ~16 GB packed). Returns (packed tree, stats),
    equal to ``pack_tree(init_params_layerwise(tree, generator, dtype,
    device), qcfg)`` of the same generator, stats included (a stacked leaf
    counts once in ``n_packed``)."""
    parts = []  # (top-level key, stats) of each transform call

    def pack(sub):
        packed, st = pack_tree(sub, qcfg)
        parts.append((next(iter(sub)), st))
        return packed

    tree = pp.init_params_layerwise(tree, generator, dtype, device,
                                    transform=pack)
    firsts = {}
    for key, st in parts:
        firsts.setdefault(key, st["n_packed"])
    dense_bits = sum(st["dense_bits"] for _, st in parts)
    packed_bits = sum(st["packed_bits"] for _, st in parts)
    return tree, {"n_packed": sum(firsts.values()), "dense_bits": dense_bits,
                  "packed_bits": packed_bits,
                  "compression": dense_bits / max(packed_bits, 1)}


def pack_placeholders(tree, qcfg: QuantConfig):
    """Placeholder-tree version of :func:`pack_tree` (dry-run: shapes +
    logical axes only, no data). Eligible P leaves become dicts of P leaves
    with the packed shapes and the reference's axes; sharding rules apply
    to them like any other. The planes are int32 where the reference's are
    uint32: the port has carried its 32-bit plane words as int32 since its
    first slice (same bytes, the kernel's type)."""
    n_eff = int(np.ceil(qcfg.n_shifts))
    m = qcfg.group_size
    P = pp.P

    def walk(path, node):
        if isinstance(node, dict):
            return {k: walk(path + (k,), v) for k, v in node.items()}
        p = node
        if not pp.is_placeholder(p) or not _eligible(path, p):
            return p
        lead = p.shape[:-2]
        lead_axes = p.axes[:-2]
        k, c = p.shape[-2], p.shape[-1]
        ak, ac = p.axes[-2], p.axes[-1]
        if k % m:
            return p
        return {
            "sign_plane": P(lead + (k // 32, c), lead_axes + (ak, ac),
                            init="zeros", dtype=torch.int32),
            "mask_planes": P(lead + (n_eff, k // 32, c),
                             lead_axes + (None, ak, ac),
                             init="zeros", dtype=torch.int32),
            # nibble-packed shift values (SWIS-C: one offset byte/group)
            "shifts": P(lead + (k // m, c,
                                1 if qcfg.method == "swis_c"
                                else (n_eff + 1) // 2),
                        lead_axes + (ak, ac, None),
                        init="zeros", dtype=torch.uint8),
            "scale": P(lead + (1, c), lead_axes + (None, ac),
                       init="ones", dtype=torch.float32),
        }

    return walk((), tree)


def total_slices(tree) -> int:
    """Number of SWIS bit-slices (mask planes) in a packed tree, from the
    first packed leaf; 0 when the tree holds no packed leaves."""
    if is_packed(tree):
        return int(tree["mask_planes"].shape[-3])
    if isinstance(tree, dict):
        for v in tree.values():
            found = total_slices(v)
            if found:
                return found
    return 0


def dequant_leaf(leaf: Dict[str, torch.Tensor], dtype=torch.float32,
                 consecutive: bool = False) -> torch.Tensor:
    """Dense weights from a packed leaf (2-D or stacked 3-D)."""
    from repro_torch.kernels.ref import dequant_ref

    mask = leaf["mask_planes"]
    if mask.ndim == 4:  # (E, N, K/32, C)
        k = leaf["sign_plane"].shape[-2] * 32
        group = k // leaf["shifts"].shape[-3]
        return torch.stack([
            dequant_ref(s, m, sh, sc, group=group, dtype=dtype,
                        consecutive=consecutive)
            for s, m, sh, sc in zip(leaf["sign_plane"], mask, leaf["shifts"],
                                    leaf["scale"])])
    k = leaf["sign_plane"].shape[0] * 32
    group = k // leaf["shifts"].shape[0]
    return dequant_ref(leaf["sign_plane"], mask, leaf["shifts"],
                       leaf["scale"], group=group, dtype=dtype,
                       consecutive=consecutive)
