"""Paged GQA attention over the KV block arena: the wrapper around
``csrc/paged_attention.cu``.

Port of ``repro.kernels.paged_attention``. ``paged_attention_decode`` keeps
the reference's signature and its Sq-major head folding; rows may carry
more than one query (``q_lens``, ``causal`` and ``window`` are all honoured).
On CUDA tensors the hand-written kernel runs (or the wrapper raises); on CPU
tensors the plain version :func:`repro_torch.kernels.ref.paged_attention_ref`
does. There is no implementation switch.

Masked queries (``i >= q_lens[b]``) do not come out as zeros, in the
reference or here: masked scores and the running max start share the fill
``mask_value(float32)``, so a fully masked row is the unweighted mean of V
over every position its table visits, the trash block included. The engine
discards those rows.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import Kernel, stream_ptr

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
KERNEL = Kernel("paged_attention", {
    "paged_attention_launch": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _I, _I, _I, _I, _I, _I, _I, _F, _F, _P],
    "paged_attention_smem_bytes": [_I, _I, _I, _I, _I],
})
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_HEAD_DIM = 256
_MAX_SMEM = 232448  # bytes of shared memory a block may use on Hopper


def mask_value(dtype) -> float:
    """Additive-mask fill for invalid attention scores: large-magnitude
    negative but inside ``dtype``'s range, so downcast scores never
    overflow to ``-inf``."""
    return float(torch.finfo(dtype).min) / 2


def paged_attention(q4: torch.Tensor, k_arena: torch.Tensor,
                    v_arena: torch.Tensor, pos_arena: torch.Tensor,
                    block_tables: torch.Tensor, q_pos: torch.Tensor,
                    q_lens: torch.Tensor, *, sq: int, causal: bool,
                    window: Optional[int]) -> torch.Tensor:
    """q4: (B, Hkv, Sq*G, Dh) -> (B, Hkv, Sq*G, Dh) float32."""
    b, hkv, sg, dh = q4.shape
    n_blocks, bs = pos_arena.shape
    nb = block_tables.shape[1]
    if sg % sq:
        raise ValueError(f"query rows {sg} not a multiple of Sq={sq}")
    if k_arena.shape != (n_blocks, bs, hkv, dh) or v_arena.shape != k_arena.shape:
        raise ValueError(f"k/v arena shapes {tuple(k_arena.shape)}, "
                         f"{tuple(v_arena.shape)} do not match "
                         f"({n_blocks}, {bs}, {hkv}, {dh})")
    if block_tables.shape[0] != b or q_pos.shape != (b,) or q_lens.shape != (b,):
        raise ValueError("block_tables, q_pos and q_lens need one row per slot")
    neg = mask_value(torch.float32)
    if q4.device.type == "cpu":
        return ref.paged_attention_ref(
            q4, k_arena, v_arena, pos_arena, block_tables, q_pos, q_lens,
            sq=sq, causal=causal, window=window, neg=neg)
    if q4.device.type != "cuda":
        raise ValueError(f"unsupported device {q4.device}")
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {dh} > {MAX_HEAD_DIM} is not supported")
    if k_arena.dtype not in _KV_DTYPES or v_arena.dtype != k_arena.dtype:
        raise ValueError(f"k/v arena must share one of {list(_KV_DTYPES)}, "
                         f"got {k_arena.dtype}, {v_arena.dtype}")
    operands = {"q4": q4, "k_arena": k_arena, "v_arena": v_arena,
                "pos_arena": pos_arena, "block_tables": block_tables,
                "q_pos": q_pos, "q_lens": q_lens}
    for name, t in operands.items():
        if t.device != q4.device:
            raise ValueError(f"{name} is on {t.device}, q4 on {q4.device}")
        if name not in ("q4", "k_arena", "v_arena") and t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q4.dtype != torch.float32:
        raise ValueError(f"q4 must be float32, got {q4.dtype}")
    lib = KERNEL.lib()
    kv_dtype = _KV_DTYPES[k_arena.dtype]
    # the kernel cuts the query rows into tiles that fit; this holds only
    # when a single row does not
    smem = lib.paged_attention_smem_bytes(kv_dtype, sg, dh, bs, nb)
    if smem > _MAX_SMEM:
        raise ValueError(f"{smem} bytes of shared memory needed for "
                         f"Dh={dh}, block_size={bs}; the card allows "
                         f"{_MAX_SMEM}")
    out = torch.empty((b, hkv, sg, dh), dtype=torch.float32, device=q4.device)
    KERNEL.call(
        "paged_attention_launch", kv_dtype, q4.data_ptr(),
        k_arena.data_ptr(), v_arena.data_ptr(), pos_arena.data_ptr(),
        block_tables.data_ptr(), q_pos.data_ptr(), q_lens.data_ptr(),
        out.data_ptr(), b, hkv, sg, sg // sq, dh, nb, bs, int(causal),
        int(window is not None), 0 if window is None else int(window),
        dh ** -0.5, neg, stream_ptr(q4.device))
    return out


def paged_attention_decode(q: torch.Tensor, k_arena: torch.Tensor,
                           v_arena: torch.Tensor, pos_arena: torch.Tensor,
                           block_tables: torch.Tensor, q_pos: torch.Tensor, *,
                           q_lens: Optional[torch.Tensor] = None,
                           causal: bool = True,
                           window: Optional[int] = None) -> torch.Tensor:
    """Paged GQA attention over the arena: q (B, S, H, Dh) -> (B, S, H, Dh)
    in ``q.dtype``. Row ``b`` carries ``q_lens[b]`` real queries (default
    S) at absolute positions ``q_pos[b] + [0, q_lens[b])``."""
    b, s, h, dh = q.shape
    hkv = k_arena.shape[2]
    g = h // hkv
    if q_lens is None:
        q_lens = torch.full((b,), s, dtype=torch.int32, device=q.device)
    # head index = hkv_idx * g + g_idx, and the query axis folds in
    # Sq-major, so score row i*G+g' maps back to query i of head group g'
    q4 = (q.reshape(b, s, hkv, g, dh).permute(0, 2, 1, 3, 4)
          .reshape(b, hkv, s * g, dh).float().contiguous())
    out = paged_attention(
        q4, k_arena, v_arena, pos_arena,
        block_tables.to(torch.int32).contiguous(),
        q_pos.to(torch.int32).contiguous(), q_lens.to(torch.int32).contiguous(),
        sq=s, causal=causal, window=window)
    return (out.reshape(b, hkv, s, g, dh).permute(0, 2, 1, 3, 4)
            .reshape(b, s, h, dh).to(q.dtype))
