"""SWIS dequant-in-kernel matmul: the wrappers around ``csrc/swis_matmul.cu``.

:func:`swis_matmul_packed` ports ``repro.kernels.swis_matmul.
swis_matmul_packed``. :func:`swis_matmul_experts_packed` is the same kernel
over a stack of expert weights in one launch, where the reference
dequantizes the stack and runs an einsum (``repro.models.moe``). On CUDA
tensors each launches the hand-written kernel (or raises); on CPU tensors
it takes the plain version in :mod:`repro_torch.kernels.ref`. The TPU
kernel's tile-divisibility check is a TPU tiling artefact and is gone: the
CUDA kernel masks its ragged edges.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import Kernel, account_meta, stream_ptr

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = Kernel("swis_matmul", {
    "swis_matmul_launch": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _I, _I, _I, _P],
    "swis_matmul_experts_launch": [_I, _P, ctypes.c_longlong, _P, _P, _P, _P,
                                   _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                   _P],
})
_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(x, sign_plane, mask_planes, shifts, scale, n_shifts, group,
           consecutive, keep_slices, lead=()):
    """Shapes of one launch's operands; ``lead`` is the expert axis, () for
    the 2-D launch."""
    if keep_slices is not None and not 1 <= keep_slices <= n_shifts:
        raise ValueError(
            f"keep_slices must be in [1, {n_shifts}], got {keep_slices}")
    if sign_plane.ndim != 2 + len(lead):
        raise ValueError(f"sign_plane has shape {tuple(sign_plane.shape)}, "
                         f"expected {lead + ('K/32', 'N')}")
    if x.ndim != 2 + len(lead) or tuple(x.shape[:len(lead)]) != lead:
        raise ValueError(f"x must be {lead + ('M', 'K')}, got shape "
                         f"{tuple(x.shape)}")
    k = x.shape[-1]
    kw, n = sign_plane.shape[-2:]
    if k % 32 or kw * 32 != k:
        raise ValueError(f"K={k} must be a multiple of 32 and match the "
                         f"sign plane's {kw} words")
    if group < 1 or k % group:
        raise ValueError(f"K={k} must be a multiple of the group {group}")
    want = {
        "sign_plane": (sign_plane, lead + (kw, n)),
        "mask_planes": (mask_planes, lead + (n_shifts, kw, n)),
        "shifts": (shifts, lead + (k // group, n,
                                   1 if consecutive else (n_shifts + 1) // 2)),
    }
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    e = lead[0] if lead else 1
    if scale.numel() != e * n:
        raise ValueError(f"scale has {scale.numel()} entries, expected "
                         f"{e * n}")


def _check_card(x, operands):
    """Device, contiguity and dtypes of a launch's operands on the card."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    dtypes = {"sign_plane": torch.int32, "mask_planes": torch.int32,
              "shifts": torch.uint8, "scale": torch.float32}
    for name, t in operands.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in dtypes and t.dtype != dtypes[name]:
            raise ValueError(f"{name} must be {dtypes[name]}, got {t.dtype}")
    if x.dtype not in _X_DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")


def _meta_launch(x, operands, out_shape, flops_rows=None):
    """A launch traced on ``meta`` tensors (the dry-run): the output's
    shape, and the launch's cost reported to the tracing mode — 2 M K N
    operations, and each operand read and the output written once (x,
    the packed planes, shifts and scale)."""
    k = x.shape[-1]
    rows = x.shape[0] if flops_rows is None else flops_rows
    out = torch.empty(out_shape, dtype=torch.float32, device="meta")
    nbytes = sum(t.numel() * t.element_size() for t in (x,) + operands)
    account_meta(KERNEL.name, 2.0 * rows * k * out_shape[-1],
                 nbytes + out.numel() * 4)
    return out


def swis_matmul_packed(x: torch.Tensor, sign_plane: torch.Tensor,
                       mask_planes: torch.Tensor, shifts: torch.Tensor,
                       scale: torch.Tensor, *, n_shifts: int, group: int,
                       consecutive: bool = False,
                       keep_slices: Optional[int] = None) -> torch.Tensor:
    """``x (M, K) @ dequant(packed (K, N)) -> (M, N) float32``.

    ``keep_slices=k`` evaluates only the k most significant bit-planes.
    """
    _check(x, sign_plane, mask_planes, shifts, scale, n_shifts, group,
           consecutive, keep_slices)
    if x.device.type == "meta":
        return _meta_launch(x, (sign_plane, mask_planes, shifts, scale),
                            (x.shape[0], sign_plane.shape[-1]))
    if x.device.type == "cpu":
        return ref.swis_matmul_ref(
            x, sign_plane, mask_planes, shifts, scale, group=group,
            consecutive=consecutive, keep_slices=keep_slices)
    _check_card(x, {"x": x, "sign_plane": sign_plane,
                    "mask_planes": mask_planes, "shifts": shifts,
                    "scale": scale})
    if x.data_ptr() % 16:  # the kernel stages x 16 bytes at a time
        x = x.clone()
    m, k = x.shape
    n = sign_plane.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    first = 0 if keep_slices is None else n_shifts - keep_slices
    KERNEL.call(
        "swis_matmul_launch", _X_DTYPES[x.dtype], x.data_ptr(),
        sign_plane.data_ptr(), mask_planes.data_ptr(), shifts.data_ptr(),
        scale.data_ptr(), out.data_ptr(), m, k, n, group, n_shifts, first,
        int(consecutive), shifts.shape[-1], stream_ptr(x.device))
    return out


def swis_matmul_experts_packed(x: torch.Tensor, sign_plane: torch.Tensor,
                               mask_planes: torch.Tensor, shifts: torch.Tensor,
                               scale: torch.Tensor, *, n_shifts: int,
                               group: int, consecutive: bool = False,
                               keep_slices: Optional[int] = None
                               ) -> torch.Tensor:
    """``x[e] (M, K) @ dequant(packed[e] (K, N))`` for every expert e, in
    one launch -> (E, M, N) float32.

    Operands carry a leading expert axis: sign (E, K/32, N), masks (E, n,
    K/32, N), shifts (E, K/group, N, bytes), scale (E, 1, N). ``x`` is (E,
    M, K), contiguous, or an expanded view whose expert stride is 0 (every
    expert reads the same rows, as decode's ``wi`` and ``wg`` do).
    """
    e = sign_plane.shape[0] if sign_plane.ndim == 3 else None
    _check(x, sign_plane, mask_planes, shifts, scale, n_shifts, group,
           consecutive, keep_slices, lead=(e,))
    if x.device.type == "meta":
        rows = x[0] if x.stride(0) == 0 else x
        return _meta_launch(rows, (sign_plane, mask_planes, shifts, scale),
                            (e, x.shape[1], sign_plane.shape[-1]),
                            flops_rows=e * x.shape[1])
    if x.device.type == "cpu":
        return ref.swis_matmul_experts_ref(
            x, sign_plane, mask_planes, shifts, scale, group=group,
            consecutive=consecutive, keep_slices=keep_slices)
    shared = x.stride(0) == 0
    rows = x[0] if shared else x  # what the kernel reads
    _check_card(x, {"x": rows, "sign_plane": sign_plane,
                    "mask_planes": mask_planes, "shifts": shifts,
                    "scale": scale})
    if rows.data_ptr() % 16:  # the kernel stages x 16 bytes at a time
        rows = rows.clone()
    m, k = x.shape[1:]
    n = sign_plane.shape[-1]
    out = torch.empty((e, m, n), dtype=torch.float32, device=x.device)
    first = 0 if keep_slices is None else n_shifts - keep_slices
    KERNEL.call(
        "swis_matmul_experts_launch", _X_DTYPES[x.dtype], rows.data_ptr(),
        0 if shared else m * k, sign_plane.data_ptr(), mask_planes.data_ptr(),
        shifts.data_ptr(), scale.data_ptr(), out.data_ptr(), e, m, k, n,
        group, n_shifts, first, int(consecutive), shifts.shape[-1],
        stream_ptr(x.device))
    return out
