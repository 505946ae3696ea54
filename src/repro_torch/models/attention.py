"""Attention (PyTorch port of ``repro.models.attention``).

Ported: GQA self-attention with RoPE, the KV-chunked online-softmax
prefill (:func:`chunked_attention`), the single-einsum decode
(:func:`full_attention`), and the cache paths serving reaches —
whole-prompt and suffix prefill writes into a per-slot working tree, and
block-table decode and the fused ``q_lens`` mixed step over the
physical-block arena, either through the paged attention kernel or through
the materialized gather, and the contiguous ring modes (per-slot decode,
lockstep decode, ring-tail prefill); and cross-attention over a context
(the VLM's patch embeddings), whose K/V come from the context, with no
RoPE and no cache.

Caches are updated in place where the reference returned updated copies
(and donated the arena): the returned cache is the same dict, mutated.

On a mesh (``shard``, :class:`repro_torch.parallel.comm.Local`) the
projections are local shards: column-split ``wq``/``wk``/``wv`` write
their heads, and a row-split ``wo`` leaves partial sums that one
all-reduce adds up. Attention runs on the local heads when the shards are
whole heads; otherwise the heads are gathered and every rank repeats it.
A cache split over ``kv_seq`` (what the rules give a decode cache:
``kv_seq`` precedes ``kv_heads``) is written by the rank that holds the
slot and attended split-softmax (:func:`_split_decode`). The engine's
modes (block tables, per-slot rows, the paged kernel) are not sharded:
the reference's engine has no mesh either.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.paged_attention import mask_value, paged_attention_decode
from repro_torch.models.layers import build_linear, dense, rope
from repro_torch.models.params import P
from repro_torch.parallel import comm


def build_attention(cfg: ArchConfig, kind: str = "self") -> dict:
    """``kind="cross"``: K/V project the VLM's ``vision_dim``-wide
    context."""
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kv_in = cfg.vlm.vision_dim if (kind == "cross" and cfg.vlm) else d
    return {
        "wq": build_linear(d, h * dh, ("embed", "q_proj")),
        "wk": build_linear(kv_in, hkv * dh, ("embed", "kv_proj")),
        "wv": build_linear(kv_in, hkv * dh, ("embed", "kv_proj")),
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


def _last_writes(phys: torch.Tensor, off: torch.Tensor, arena) -> torch.Tensor:
    """For each of a scatter's writes to arena slots (``phys``, ``off``),
    the index of the last write to the same slot. Invalid tokens all land
    in the trash block, so slots repeat; the reference's scatter leaves a
    repeated slot with its last write's values (XLA and torch on the CPU
    apply the writes in order), while the card's scatter picks any. Writing
    each slot's last values from every duplicate gives the reference's
    arena on both. The trash block is read by masked query rows (the mean
    of V over their tables), whose hidden states a MoE block routes, so
    its contents reach real tokens through expert capacity."""
    key = phys * arena[1] + off
    order = torch.arange(key.numel(), device=key.device)
    last = torch.full((arena[0] * arena[1],), -1, dtype=torch.long,
                      device=key.device)
    return last.scatter_reduce_(0, key, order, reduce="amax")[key]


def _split_decode(q, ck, cv, cp, q_pos, *, causal, window, ax):
    """:func:`full_attention` over a cache split along its positions over
    ``ax``: each rank scores its slots; the max, the normalizer and the
    weighted values are all-reduced (fp32, as ``full_attention``)."""
    b, sq, h, dh = q.shape
    hkv = ck.shape[2]
    qh = q.reshape(b, sq, hkv, h // hkv, dh).float() * (dh ** -0.5)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qh, ck.float())
    qp, kp = _pos2(q_pos), _pos2(cp)
    valid = kp[:, None, :] >= 0
    if causal:
        valid = valid & (kp[:, None, :] <= qp[:, :, None])
    if window is not None:
        valid = valid & (kp[:, None, :] > qp[:, :, None] - window)
    s = torch.where(valid[:, None, None], s, mask_value(torch.float32))
    m = comm.all_reduce(s.amax(dim=-1), ax, "max")
    e = torch.exp(s - m[..., None])
    denom = comm.all_reduce(e.sum(dim=-1), ax)
    acc = comm.all_reduce(torch.einsum("bhgqk,bkhd->bhgqd", e, cv.float()),
                          ax)
    out = acc / torch.clamp_min(denom[..., None], 1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh).to(q.dtype)


def _write_split(cache, k, v, pos, idx: int, ax):
    """The scalar-index writes of :func:`attention_apply` into a cache
    whose positions are split evenly over ``ax``: each rank writes the part
    it holds. One token wraps at the ring's end; a prompt of at least the
    cache's length keeps its last ``cache_len`` tokens in ring order; the
    rest must fit before the end."""
    ck, cv, cp = cache["k"], cache["v"], cache["pos"]
    n_l = ck.shape[1]
    cache_len = n_l * ax.size
    s = k.shape[1]
    if s >= cache_len:
        shift = (idx + s - cache_len) % cache_len
        k = torch.roll(k[:, -cache_len:], shift, dims=1)
        v = torch.roll(v[:, -cache_len:], shift, dims=1)
        pos = torch.roll(pos[..., -cache_len:], shift, dims=-1)
        s, idx = cache_len, 0
    lo = idx % cache_len if s == 1 else idx
    if lo + s > cache_len:
        raise NotImplementedError("a sharded prefill past the cache's end")
    a, b = max(lo, ax.rank * n_l), min(lo + s, (ax.rank + 1) * n_l)
    if a >= b:
        return
    src = slice(a - lo, b - lo)
    dst = slice(a - ax.rank * n_l, b - ax.rank * n_l)
    ck[:, dst] = k[:, src].to(ck.dtype)
    cv[:, dst] = v[:, src].to(cv.dtype)
    cp[..., dst] = pos[..., src].to(cp.dtype)


def attention_apply(p: dict, x: torch.Tensor, cfg: ArchConfig, *,
                    positions: torch.Tensor, causal: bool = True,
                    window: Optional[int] = None,
                    ctx: Optional[torch.Tensor] = None,
                    cache: Optional[dict] = None,
                    cache_index=None,
                    block_tables: Optional[torch.Tensor] = None,
                    attend_cache: bool = False, paged: bool = False,
                    q_lens: Optional[torch.Tensor] = None, shard=None):
    """Returns (out (B, S, D), cache_or_None).

    ``cache`` is a tree {'k', 'v', 'pos'} whose position plane is shared
    (cache_len,) or per-slot (B, cache_len); the write mode follows the
    reference:

    * ``block_tables`` with ``q_lens`` (the fused mixed step, and both
      speculative launches): row r carries ``q_lens[r]`` real tokens from
      its own ``cache_index[r]``; every valid token is written into the
      physical-block arena through the row's table inside this call,
      invalid ones go to the trash block 0 with pos -1, and only then does
      attention read the arena through the tables (write before attend:
      rejected drafts beyond the query positions stay causally masked);
    * ``block_tables`` alone: block-table decode, one token per row;
    * a (B,) ``cache_index`` without tables: per-slot decode into
      contiguous rows, each wrapping at its own ring position;
    * a scalar ``cache_index``: a prompt of at least ``cache_len`` tokens
      keeps its last ``cache_len`` in ring order; one token is a lockstep
      decode; otherwise the S tokens land at [cache_index, cache_index + S)
      (whole-prompt, suffix or chunk prefill), and ``attend_cache`` makes
      them attend over the whole updated cache instead of their own K/V.

    ``paged`` runs the paged attention kernel over the arena instead of
    materializing the gathered K/V.

    ``ctx`` (B, P, Dv) makes it cross-attention: K/V project the context,
    with no RoPE, at positions [0, P), attended without a causal mask or a
    cache.

    ``shard``: the parameters (and the cache) are local shards on a mesh;
    see the module docstring.
    """
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    b, s, _ = x.shape
    ax = comm.axis_of(shard)
    split = {w: comm.split_at(shard, w, "w")
             for w in ("wq", "wk", "wv", "wo")}
    parted = any(v is not None for v in split.values())
    split_cache = cache is not None and shard is not None
    if split_cache and (shard.cache["k"], shard.cache["pos"]) != (-3, -1):
        raise NotImplementedError(
            "on a mesh a KV cache is split over its positions (K, V and "
            "the position plane alike), not over its heads nor replicated")
    # heads of this rank: its own when the shards are whole heads, else all
    # of them, gathered
    own = (split["wq"] == split["wk"] == split["wv"] == comm.COL
           and split["wo"] == comm.ROW and h % ax.size == 0
           and hkv % ax.size == 0)
    hq, hk = (h // ax.size, hkv // ax.size) if own else (h, hkv)
    kv_src = ctx if ctx is not None else x
    if parted:
        x, kv_src = comm.copy_to(x, ax), comm.copy_to(kv_src, ax)

    def proj(w, src):
        y = dense(p[w], src, cfg)
        return comm.gather_from(y, ax, -1) if (
            split[w] == comm.COL and not own) else y

    q = proj("wq", x).reshape(b, s, hq, dh)
    k = proj("wk", kv_src).reshape(b, kv_src.shape[1], hk, dh)
    v = proj("wv", kv_src).reshape(b, kv_src.shape[1], hk, dh)

    def project(out):
        heads = out.shape[2]
        out = out.reshape(b, s, heads * dh)
        if split["wo"] is None:
            if heads != h:
                out = comm.gather_from(out, ax, -1)
            return dense(p["wo"], out, cfg)
        if split["wo"] != comm.ROW:
            raise NotImplementedError(
                f"attention output split {split['wo']}")
        if heads == h:  # every head here: the rows of this rank's wo shard
            out = comm.own_slice(comm.copy_to(out, ax), ax, -1)
        return comm.reduce_from(dense(p["wo"], out, cfg), ax)

    if ctx is not None:
        kv_pos = torch.arange(ctx.shape[1], dtype=torch.int32,
                              device=x.device)
        out = chunked_attention(q, k, v, q_pos=positions, kv_pos=kv_pos,
                                causal=False, window=None,
                                chunk=cfg.attn_chunk)
        return project(out), None

    q = rope(q, _pos2(positions), cfg.rope_theta)
    k = rope(k, _pos2(positions), cfg.rope_theta)
    if cache is None:
        out = chunked_attention(q, k, v, q_pos=positions, kv_pos=positions,
                                causal=causal, window=window,
                                chunk=cfg.attn_chunk)
        return project(out), None
    if split_cache:  # the cache's positions split over ax
        if torch.is_tensor(cache_index) and cache_index.ndim:
            raise NotImplementedError("per-slot cache indices on a mesh")
        _write_split(cache, comm.all_gather(k, ax, 2) if own else k,
                     comm.all_gather(v, ax, 2) if own else v,
                     positions.to(torch.int32), int(cache_index), ax)
        if s == 1:
            out = _split_decode(comm.all_gather(q, ax, 2) if own else q,
                                cache["k"], cache["v"], cache["pos"],
                                positions, causal=causal, window=window,
                                ax=ax)
        else:  # a prefill attends over its own K/V
            out = chunked_attention(q, k, v, q_pos=positions,
                                    kv_pos=positions, causal=causal,
                                    window=window, chunk=cfg.attn_chunk)
        return project(out), cache

    ck, cv, cp = cache["k"], cache["v"], cache["pos"]
    cache_len = ck.shape[1]
    per_slot = cp.ndim == 2
    kd, vd = k.to(ck.dtype), v.to(cv.dtype)
    new_pos = positions.to(torch.int32)
    idx = cache_index
    per_row = torch.is_tensor(idx) and idx.ndim == 1
    if block_tables is not None:
        if not (per_row and per_slot):
            raise ValueError("block tables need (B,) cache indices and a "
                             "per-slot cache")
        tl = block_tables.long()
        nb = tl.shape[1]
        if q_lens is not None:
            # row r writes at positions idx[r] + [0, S); its valid tokens
            # land in the blocks it owns (they never collide across rows),
            # the rest in the trash block
            tok_valid = (torch.arange(s, device=x.device)[None, :]
                         < q_lens[:, None])
            bi = torch.clamp(torch.div(new_pos, cache_len,
                                       rounding_mode="floor"), 0, nb - 1).long()
            phys = torch.where(tok_valid, torch.gather(tl, 1, bi), 0)
            fp = phys.reshape(-1)
            fo = torch.remainder(new_pos, cache_len).long().reshape(-1)
            src = _last_writes(fp, fo, ck.shape[:2])
            ck[fp, fo] = kd.reshape((b * s,) + kd.shape[2:])[src]
            cv[fp, fo] = vd.reshape((b * s,) + vd.shape[2:])[src]
            cp[fp, fo] = torch.where(tok_valid, new_pos, -1).reshape(-1)[src]
        else:
            if s != 1:
                raise ValueError(
                    f"block-table decode feeds one token per row, got {s}")
            # row r's token lands in logical block idx[r] // bs at offset
            # idx[r] % bs of the physical block its table maps that block to
            bi = torch.div(idx, cache_len, rounding_mode="floor").long()
            off = torch.remainder(idx, cache_len).long()
            phys = torch.gather(tl, 1, bi[:, None])[:, 0]
            src = _last_writes(phys, off, ck.shape[:2])
            ck[phys, off] = kd[src, 0]
            cv[phys, off] = vd[src, 0]
            cp[phys, off] = new_pos[src, 0]
        if paged:
            out = paged_attention_decode(q, ck, cv, cp, block_tables,
                                         new_pos[:, 0], q_lens=q_lens,
                                         causal=causal, window=window)
            return project(out), cache
        gk = ck[tl].reshape((b, nb * cache_len) + ck.shape[2:])
        gv = cv[tl].reshape((b, nb * cache_len) + cv.shape[2:])
        # logical blocks mapped to the trash block 0 are invalid, whatever
        # block 0's pos plane holds
        gp = torch.where((tl == 0)[:, :, None], -1,
                         cp[tl]).reshape(b, nb * cache_len)
        if q_lens is not None:
            out = chunked_attention(q, gk, gv, q_pos=positions, kv_pos=gp,
                                    causal=causal, window=window,
                                    chunk=cfg.attn_chunk)
        else:
            out = full_attention(q, gk, gv, q_pos=positions, kv_pos=gp,
                                 causal=causal, window=window)
        return project(out), cache

    if per_row:
        # per-slot decode over contiguous rows: row r writes its token at
        # ring position idx[r] % cache_len
        if s != 1 or not per_slot:
            raise ValueError("per-slot decode feeds one token per row into "
                             "a per-slot cache")
        rows = torch.arange(b, device=x.device)
        slot = torch.remainder(idx, cache_len).long()
        ck[rows, slot] = kd[:, 0]
        cv[rows, slot] = vd[:, 0]
        cp[rows, slot] = new_pos[:, 0]
    elif s >= cache_len:
        # keep the ring invariant slot == pos % cache_len, so later
        # one-token writes overwrite the oldest entry
        shift = (int(idx) + s - cache_len) % cache_len  # new_pos[-cache_len]
        ck.copy_(torch.roll(kd[:, -cache_len:], shift, dims=1))
        cv.copy_(torch.roll(vd[:, -cache_len:], shift, dims=1))
        cp.copy_(torch.roll(new_pos[-cache_len:], shift).expand(cp.shape))
    else:
        # one lockstep token at its ring position, or S tokens from idx;
        # the start clamps to [0, cache_len - S] as the reference's
        # dynamic_update_slice does (engines never ask for a wrap here)
        lo = int(idx) % cache_len if s == 1 else min(max(int(idx), 0),
                                                     cache_len - s)
        ck[:, lo:lo + s] = kd
        cv[:, lo:lo + s] = vd
        cp[..., lo:lo + s] = new_pos
    if s == 1:
        out = full_attention(q, ck, cv, q_pos=positions, kv_pos=cp,
                             causal=causal, window=window)
    elif attend_cache and s < cache_len:
        # suffix or chunk prefill: rows [0, idx) hold committed K/V, and
        # the S tokens attend over the whole updated cache
        out = chunked_attention(q, ck, cv, q_pos=positions, kv_pos=cp,
                                causal=causal, window=window,
                                chunk=cfg.attn_chunk)
    else:
        # whole-prompt prefill attends over its own K/V (a ring shorter
        # than the prompt keeps only the tail)
        out = chunked_attention(q, k, v, q_pos=positions, kv_pos=positions,
                                causal=causal, window=window,
                                chunk=cfg.attn_chunk)
    return project(out), cache
