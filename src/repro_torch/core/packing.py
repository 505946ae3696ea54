"""SWIS compressed weight storage (paper §3.3): bit-planes along K.

PyTorch port of ``repro.core.packing``. Per group of ``M`` weights (along
K) the format stores:

* 1 sign bit / weight            -> ``sign_plane``  (K/32, C)
* N mask bits / weight           -> ``mask_planes`` (N, K/32, C)
* N shift values of 4 bits each  -> ``shifts``      uint8 (K/M, C, ceil(N/2))
  (SWIS-C stores a single offset byte per group -> (K/M, C, 1))
* per-column scale               -> ``scale``       float32 (1, C)

Words hold 32 weights along K, bit b = weight 32*w + b. The reference
stores them as ``uint32``; this build of torch implements ``&`` but not
``>>``/``<<`` for ``torch.uint32``, so the port carries the same 32 bits as
``int32`` (``(w >> b) & 1`` is still the right bit: the arithmetic shift
only sign-extends above bit 31-b). The CUDA kernels read the buffers as
``uint32_t``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.swis import QuantizedWeight


def pack_bits_u32(bits: torch.Tensor) -> torch.Tensor:
    """Pack a {0,1} tensor (K, ...) along axis 0 into int32 words (K/32, ...)."""
    k = bits.shape[0]
    if k % 32:
        raise ValueError(f"K={k} not divisible by 32")
    r = bits.reshape(k // 32, 32, *bits.shape[1:]).to(torch.int64)
    w = (torch.ones((), dtype=torch.int64, device=bits.device)
         << torch.arange(32, dtype=torch.int64, device=bits.device))
    v = torch.sum(r * w.reshape((1, 32) + (1,) * (bits.ndim - 1)), dim=1)
    # wrap the unsigned word into int32 explicitly (an out-of-range cast
    # is not relied on)
    v = v - (v >= 2 ** 31).to(torch.int64) * 2 ** 32
    return v.to(torch.int32)


def unpack_bits_u32(words: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_bits_u32` -> int32 {0,1} of shape (K, ...)."""
    kw = words.shape[0]
    idx = torch.arange(32, dtype=torch.int32, device=words.device).reshape(
        (1, 32) + (1,) * (words.ndim - 1))
    bits = (words[:, None].to(torch.int32) >> idx) & 1
    return bits.reshape(kw * 32, *words.shape[1:])


def pack_shift_nibbles(shifts: torch.Tensor) -> torch.Tensor:
    """Pack shift values two per byte: (..., N) int -> (..., ceil(N/2))
    uint8, low nibble = even index."""
    n = shifts.shape[-1]
    s = shifts.to(torch.uint8)
    if n % 2:
        s = torch.cat([s, torch.zeros(s.shape[:-1] + (1,), dtype=torch.uint8,
                                      device=s.device)], dim=-1)
    return s[..., 0::2] | (s[..., 1::2] << 4)


def unpack_shift_nibbles(packed: torch.Tensor, n_shifts: int) -> torch.Tensor:
    """Inverse of :func:`pack_shift_nibbles` -> (..., n_shifts) int32."""
    lo = (packed & 0x0F).to(torch.int32)
    hi = ((packed >> 4) & 0x0F).to(torch.int32)
    out = torch.stack([lo, hi], dim=-1).reshape(packed.shape[:-1] + (-1,))
    return out[..., :n_shifts]


@dataclasses.dataclass
class PackedWeight:
    """SWIS bit-plane weight container."""

    sign_plane: torch.Tensor  # int32 (K/32, C); bit=1 => negative
    mask_planes: torch.Tensor  # int32 (N, K/32, C)
    shifts: torch.Tensor  # uint8 (K/M, C, ceil(N/2)) nibble-packed
    scale: torch.Tensor  # float32 (1, C) or scalar
    group_size: int
    n_shifts: int
    k: int
    c: int
    method: str = "swis"

    def tree(self) -> dict:
        return {"sign_plane": self.sign_plane,
                "mask_planes": self.mask_planes,
                "shifts": self.shifts, "scale": self.scale}

    @property
    def stored_bits(self) -> int:
        """Exact metadata-true storage in bits (paper §3.3 accounting)."""
        n_groups = (self.k // self.group_size) * self.c
        mask_bits = self.k * self.c * self.n_shifts
        sign_bits = self.k * self.c
        shift_bits = n_groups * (3 if self.method == "swis_c"
                                 else 3 * self.n_shifts)
        return mask_bits + sign_bits + shift_bits

    @property
    def compression_ratio(self) -> float:
        return (self.k * self.c * 8) / self.stored_bits


def pack(qw: QuantizedWeight) -> PackedWeight:
    """Pack a :class:`QuantizedWeight` into bit planes. Columns quantized
    with fewer shifts than the max have all-zero high mask planes."""
    k, c = qw.qmags.shape
    n = int(qw.shifts.shape[-1])
    if k % 32:
        raise ValueError(f"K={k} must be a multiple of 32 to pack")
    sign_bits = (qw.signs < 0).to(torch.int32)
    planes = [pack_bits_u32((qw.masks >> j) & 1) for j in range(n)]
    if qw.cfg.method == "swis_c":
        # consecutive support vector: store only the per-group offset
        # (paper §2.2); shift j = offset + j
        shift_store = qw.shifts[..., :1].to(torch.uint8)
    else:
        shift_store = pack_shift_nibbles(qw.shifts)
    return PackedWeight(
        sign_plane=pack_bits_u32(sign_bits), mask_planes=torch.stack(planes),
        shifts=shift_store, scale=torch.as_tensor(qw.scale, dtype=torch.float32),
        group_size=qw.cfg.group_size, n_shifts=n, k=k, c=c,
        method=qw.cfg.method)


def unpack_dense(pw: PackedWeight, dtype=torch.float32) -> torch.Tensor:
    """Reconstruct the dense dequantized (K, C) matrix from planes, with
    the reference's float32 arithmetic (powers of two from ``exp2``)."""
    sign = 1.0 - 2.0 * unpack_bits_u32(pw.sign_plane).float()
    if pw.method == "swis_c":
        shifts = pw.shifts[..., :1].to(torch.int32) + torch.arange(
            pw.n_shifts, dtype=torch.int32, device=pw.shifts.device)
    else:
        shifts = unpack_shift_nibbles(pw.shifts, pw.n_shifts)
    acc = torch.zeros((pw.k, pw.c), dtype=torch.float32,
                      device=pw.sign_plane.device)
    for j in range(pw.n_shifts):
        bits = unpack_bits_u32(pw.mask_planes[j]).float()
        s = shifts[:, :, j].float()  # (K/M, C)
        acc = acc + bits * torch.exp2(s.repeat_interleave(pw.group_size,
                                                          dim=0))
    return (sign * acc * pw.scale).to(dtype)


def compression_ratio(group_size: int, n_shifts: int, method: str = "swis",
                      bits: int = 8) -> float:
    """Storage of ``bits``-bit dense weights over the packed format's
    (paper Fig. 5): per group of ``group_size`` weights, one sign and
    ``n_shifts`` mask bits a weight, plus 3 bits a shift (SWIS-C: one
    3-bit offset a group)."""
    m, n = group_size, n_shifts
    shift_bits = 3 if method == "swis_c" else 3 * n
    return bits * m / (m * (1 + n) + shift_bits)


def dpred_compression(mags: np.ndarray, group_size: int, bits: int = 8) -> float:
    """DPRed-style lossless per-group bitwidth compression (paper Fig. 5).

    Each group stores its weights with the bitwidth of the highest active
    bit position in the group, plus sign bits and a ceil(log2(B+1))-bit
    per-group width field."""
    k = mags.shape[0]
    m = group_size
    if k % m:
        mags = mags[: k - k % m]
    g = mags.reshape(-1, m, *mags.shape[1:])
    gmax = g.max(axis=1)
    width = np.ceil(np.log2(np.maximum(gmax, 1) + 1)).astype(np.int64)
    width = np.maximum(width, 1)
    n_groups = width.size
    total = ((width * m).sum() + n_groups * int(np.ceil(np.log2(bits + 1)))
             + g.size)
    return g.size * bits / float(total)
