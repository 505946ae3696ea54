"""Attention for the dense family (PyTorch port of ``repro.models.attention``).

Ported: GQA self-attention with RoPE, the KV-chunked online-softmax
prefill (:func:`chunked_attention`), the single-einsum decode
(:func:`full_attention`), and the cache paths serving reaches —
whole-prompt and suffix prefill writes into a per-slot working tree, and
block-table decode over the physical-block arena, either through the paged
attention kernel or through the materialized gather. The fused ``q_lens``
mixed step, cross-attention and the contiguous ring modes wait for later
slices and raise.

Caches are updated in place where the reference returned updated copies
(and donated the arena): the returned cache is the same dict, mutated.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.paged_attention import mask_value, paged_attention_decode
from repro_torch.models.layers import build_linear, dense, rope
from repro_torch.models.params import P


def build_attention(cfg: ArchConfig, kind: str = "self") -> dict:
    if kind != "self":
        raise NotImplementedError(f"{kind!r} attention is not ported yet")
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": build_linear(d, h * dh, ("embed", "q_proj")),
        "wk": build_linear(d, hkv * dh, ("embed", "kv_proj")),
        "wv": build_linear(d, hkv * dh, ("embed", "kv_proj")),
        "wo": build_linear(h * dh, d, ("q_proj", "embed")),
    }


def build_cache(cfg: ArchConfig, batch: int, max_len: int, dtype) -> dict:
    """K/V planes; the position plane is added by ``build_block_cache``."""
    hkv, dh = cfg.n_kv_heads, cfg.head_dim
    axes = ("batch", "kv_seq", "kv_heads", "head_dim")
    return {"k": P((batch, max_len, hkv, dh), axes, init="zeros", dtype=dtype),
            "v": P((batch, max_len, hkv, dh), axes, init="zeros", dtype=dtype)}


def _pos2(p: torch.Tensor) -> torch.Tensor:
    """(S,) shared or (B, S) per-slot positions -> (1 | B, S)."""
    return p if p.ndim == 2 else p[None, :]


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      q_pos: torch.Tensor, kv_pos: torch.Tensor, causal: bool,
                      window: Optional[int], chunk: int) -> torch.Tensor:
    """Online-softmax attention over KV chunks. q (B, Sq, H, Dh), k/v
    (B, Skv, Hkv, Dh); negative kv positions are padding."""
    b, sq, h, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    chunk = min(chunk, skv)
    kp, qp = _pos2(kv_pos), _pos2(q_pos)
    if skv % chunk:
        pad = (-skv) % chunk
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kp = torch.nn.functional.pad(kp, (0, pad), value=-1)
        skv += pad
    neg = mask_value(torch.float32)
    qh = q.reshape(b, sq, hkv, g, dh).float() * (dh ** -0.5)
    m = torch.full((b, hkv, g, sq), neg, dtype=torch.float32, device=q.device)
    denom = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, g, sq, dh), dtype=torch.float32, device=q.device)
    for c0 in range(0, skv, chunk):
        k_c = k[:, c0:c0 + chunk].float()
        v_c = v[:, c0:c0 + chunk].float()
        p_c = kp[:, c0:c0 + chunk]  # (1 | B, chunk)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qh, k_c)
        valid = p_c[:, None, :] >= 0
        if causal:
            valid = valid & (p_c[:, None, :] <= qp[:, :, None])
        if window is not None:
            valid = valid & (p_c[:, None, :] > qp[:, :, None] - window)
        s = torch.where(valid[:, None, None], s, neg)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        denom = denom * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, v_c)
        m = m_new
    out = acc / torch.clamp_min(denom[..., None], 1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh).to(q.dtype)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   q_pos: torch.Tensor, kv_pos: torch.Tensor, causal: bool,
                   window: Optional[int]) -> torch.Tensor:
    """One-shot softmax attention (decode). Shapes as chunked_attention."""
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qh = q.reshape(b, sq, hkv, g, dh).float() * (dh ** -0.5)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qh, k.float())
    qp, kp = _pos2(q_pos), _pos2(kv_pos)
    valid = kp[:, None, :] >= 0
    if causal:
        valid = valid & (kp[:, None, :] <= qp[:, :, None])
    if window is not None:
        valid = valid & (kp[:, None, :] > qp[:, :, None] - window)
    s = torch.where(valid[:, None, None], s, mask_value(torch.float32))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh).to(q.dtype)


def attention_apply(p: dict, x: torch.Tensor, cfg: ArchConfig, *,
                    positions: torch.Tensor, causal: bool = True,
                    window: Optional[int] = None,
                    cache: Optional[dict] = None,
                    cache_index=None,
                    block_tables: Optional[torch.Tensor] = None,
                    attend_cache: bool = False, paged: bool = False):
    """Returns (out (B, S, D), cache_or_None).

    ``cache`` is a per-slot tree {'k', 'v', 'pos'} with a (B, cache_len)
    position plane. With a scalar ``cache_index`` the S tokens are written
    at rows [cache_index, cache_index + S) (whole-prompt or suffix
    prefill); ``attend_cache`` makes them attend over the whole updated
    cache instead of only their own K/V. With a (B,) ``cache_index`` and
    ``block_tables`` the cache is the physical-block arena and each row
    decodes one token through its table; ``paged`` runs the paged
    attention kernel instead of materializing the gathered K/V.
    """
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    b, s, _ = x.shape
    q = dense(p["wq"], x, cfg).reshape(b, s, h, dh)
    k = dense(p["wk"], x, cfg).reshape(b, s, hkv, dh)
    v = dense(p["wv"], x, cfg).reshape(b, s, hkv, dh)
    q = rope(q, _pos2(positions), cfg.rope_theta)
    k = rope(k, _pos2(positions), cfg.rope_theta)

    if cache is None:
        out = chunked_attention(q, k, v, q_pos=positions, kv_pos=positions,
                                causal=causal, window=window,
                                chunk=cfg.attn_chunk)
        return dense(p["wo"], out.reshape(b, s, h * dh), cfg), None

    ck, cv, cp = cache["k"], cache["v"], cache["pos"]
    cache_len = ck.shape[1]
    if cp.ndim != 2:
        raise NotImplementedError("only per-slot caches are ported")
    kd, vd = k.to(ck.dtype), v.to(cv.dtype)
    new_pos = positions.to(torch.int32)
    idx = cache_index
    if torch.is_tensor(idx) and idx.ndim == 1:
        if block_tables is None:
            raise NotImplementedError(
                "per-slot decode without block tables (contiguous cache "
                "mode) is not ported yet")
        if s != 1:
            raise ValueError(f"block-table decode feeds one token per row, got {s}")
        # row r's token lands in logical block idx[r] // bs at offset
        # idx[r] % bs of the physical block its table maps that block to
        bi = torch.div(idx, cache_len, rounding_mode="floor").long()
        off = torch.remainder(idx, cache_len).long()
        phys = torch.gather(block_tables.long(), 1, bi[:, None])[:, 0]
        ck[phys, off] = kd[:, 0]
        cv[phys, off] = vd[:, 0]
        cp[phys, off] = new_pos[:, 0]
        if paged:
            out = paged_attention_decode(q, ck, cv, cp, block_tables,
                                         positions[:, 0], causal=causal,
                                         window=window)
        else:
            nb = block_tables.shape[1]
            tl = block_tables.long()
            gk = ck[tl].reshape((b, nb * cache_len) + ck.shape[2:])
            gv = cv[tl].reshape((b, nb * cache_len) + cv.shape[2:])
            # logical blocks mapped to the trash block 0 are invalid,
            # whatever block 0's pos plane holds
            gp = torch.where((tl == 0)[:, :, None], -1,
                             cp[tl]).reshape(b, nb * cache_len)
            out = full_attention(q, gk, gv, q_pos=positions, kv_pos=gp,
                                 causal=causal, window=window)
        return dense(p["wo"], out.reshape(b, s, h * dh), cfg), cache

    idx = int(idx)
    if idx + s > cache_len:
        raise NotImplementedError(
            f"writing {s} tokens at {idx} wraps a {cache_len}-row ring "
            f"cache; ring wrap-around is not ported yet")
    ck[:, idx:idx + s] = kd
    cv[:, idx:idx + s] = vd
    cp[:, idx:idx + s] = new_pos[None, :]
    if s == 1:
        out = full_attention(q, ck, cv, q_pos=positions, kv_pos=cp,
                             causal=causal, window=window)
    elif attend_cache and s < cache_len:
        # suffix prefill: rows [0, idx) hold a cached prefix, and the
        # suffix attends over the whole updated cache
        out = chunked_attention(q, ck, cv, q_pos=positions, kv_pos=cp,
                                causal=causal, window=window,
                                chunk=cfg.attn_chunk)
    else:
        # whole-prompt prefill attends over its own K/V
        out = chunked_attention(q, k, v, q_pos=positions, kv_pos=positions,
                                causal=causal, window=window,
                                chunk=cfg.attn_chunk)
    return dense(p["wo"], out.reshape(b, s, h * dh), cfg), cache
