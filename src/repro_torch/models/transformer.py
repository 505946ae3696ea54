"""Block assembly (PyTorch port of ``repro.models.transformer``): every
family is a repeating pattern unit of blocks, stacked over depth, with any
remainder layers unrolled as a tail (``models.model``). Kinds:

  attn        pre-norm self-attention + MLP               (dense / vlm self)
  enc         bidirectional self-attention + MLP          (hubert)
  attn_local  sliding-window self-attention + MLP         (griffin)
  moe         self-attention + mixture-of-experts FFN     (qwen2-moe / dbrx)
  rec         RG-LRU temporal mix + MLP                   (griffin)
  mamba       Mamba-2 SSD mixer (no MLP)                  (mamba2)
  self_cross  self-attn + gated cross-attn + MLP          (llama-3.2-vision)

so every family of the reference is served (the encoder only through
``Model.apply``: it has no decoder). On a mesh (``shard``) the attention
kinds, the MLP and the MoE FFN compute on local shards; the recurrent
kinds (``rec``, ``mamba``) gather their weights and state and run whole on
every rank of the model axis."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import spans
from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import build_mlp, build_norm, mlp_apply, norm_apply
from repro_torch.models.params import P
from repro_torch.parallel import model as sharded
from repro_torch.parallel.ctx import constrain


def pattern_for(cfg: ArchConfig) -> Tuple[str, ...]:
    if cfg.family == "dense":
        return ("attn",)
    if cfg.family == "moe":
        return ("moe",)
    if cfg.family == "griffin":
        return cfg.griffin.pattern
    if cfg.family == "mamba2":
        return ("mamba",)
    if cfg.family == "encoder":
        return ("enc",)
    if cfg.family == "vlm":
        return ("attn",) * (cfg.vlm.cross_every - 1) + ("self_cross",)
    raise ValueError(cfg.family)


def build_block(cfg: ArchConfig, kind: str) -> dict:
    d = cfg.d_model
    if kind == "mamba":
        return {"ln": build_norm(d), "mixer": ssm_mod.build_mamba(cfg)}
    if kind == "rec":
        return {"ln1": build_norm(d), "rec": rglru_mod.build_rglru_block(cfg),
                "ln2": build_norm(d), "mlp": build_mlp(cfg)}
    if kind == "self_cross":
        # the reference's key order: init_params draws leaves in it
        return {"ln1": build_norm(d), "attn": attn_mod.build_attention(cfg),
                "lnx": build_norm(d),
                "xattn": attn_mod.build_attention(cfg, kind="cross"),
                "xgate": P((), (), init="zeros"),
                "ln2": build_norm(d), "mlp": build_mlp(cfg)}
    if kind not in ("attn", "enc", "attn_local", "moe"):
        raise ValueError(kind)
    ffn = ({"moe": moe_mod.build_moe(cfg)} if kind == "moe"
           else {"mlp": build_mlp(cfg)})
    return {"ln1": build_norm(d), "attn": attn_mod.build_attention(cfg),
            "ln2": build_norm(d), **ffn}


def build_block_cache(cfg: ArchConfig, kind: str, batch: int, max_len: int,
                      dtype, per_slot: bool = False) -> dict:
    """The attention kinds keep K/V and a position plane (``attn_local``
    a ring of ``min(max_len, window)`` positions; ``self_cross`` for its
    self-attention only); ``rec`` and ``mamba`` keep their recurrent
    state, with no position plane; ``enc`` keeps nothing (``{}``)."""
    if kind == "rec":
        return rglru_mod.build_rglru_cache(cfg, batch, dtype)
    if kind == "mamba":
        return ssm_mod.build_mamba_cache(cfg, batch, dtype)
    if kind == "enc":
        return {}
    if kind == "attn_local":
        max_len = min(max_len, cfg.griffin.window)
    elif kind not in ("attn", "moe", "self_cross"):
        raise ValueError(kind)
    c = attn_mod.build_cache(cfg, batch, max_len, dtype)
    cache_len = c["k"].shape[1]
    # position slots start invalid (-1) so unwritten entries are masked
    if per_slot:
        c["pos"] = P((batch, cache_len), ("batch", "kv_seq"), init="fill",
                     scale=-1, dtype=torch.int32)
    else:
        c["pos"] = P((cache_len,), ("kv_seq",), init="fill", scale=-1,
                     dtype=torch.int32)
    return c


def block_apply(p: dict, x: torch.Tensor, cfg: ArchConfig, kind: str, *,
                positions: torch.Tensor, ctx: Optional[torch.Tensor] = None,
                cache: Optional[dict] = None,
                cache_index=None, block_tables: Optional[torch.Tensor] = None,
                attend_cache: bool = False, paged: bool = False,
                q_lens: Optional[torch.Tensor] = None, shard=None,
                layer: int = -1):
    """Returns (x, cache, aux): ``aux`` holds ``moe_aux`` for a moe block,
    and is empty otherwise. A cached block updates ``cache`` in place.

    The attention kinds record call spans (:mod:`repro_torch.spans`),
    tagged with the block's index ``layer``: ``attn`` (the norm, the
    attention, the residual; a ``self_cross`` block's cross-attention
    too), then ``mlp`` or ``moe`` (the norm, the FFN, the residual).

    ``enc`` attends both ways whatever ``cfg.causal`` says. A
    ``self_cross`` block adds the gated cross residual ``tanh(xgate) *
    xattn(lnx(x), ctx)`` only when ``ctx`` (the patch embeddings) is
    given: launches without it skip cross-attention, as the reference's
    decode, mixed, draft and verify launches do."""
    if shard is not None and kind in ("rec", "mamba"):
        full = sharded.gather_cache(cache, shard) if cache else None
        x, full, aux = block_apply(
            sharded.gather_params(p, shard.split, shard.tp), x, cfg, kind,
            positions=positions, cache=full, cache_index=cache_index)
        if cache:
            sharded.scatter_cache(cache, full, shard)
        return x, cache, aux
    if kind == "mamba":
        h, cache = ssm_mod.mamba_apply(p["mixer"], norm_apply(p["ln"], x, cfg),
                                       cfg, cache)
        return constrain(x + h, ("batch", "seq", "embed")), cache, {}
    if kind == "rec":
        h, cache = rglru_mod.rglru_apply(p["rec"], norm_apply(p["ln1"], x, cfg),
                                         cfg, cache)
        x = x + h
        x = x + mlp_apply(p["mlp"], norm_apply(p["ln2"], x, cfg), cfg)
        return constrain(x, ("batch", "seq", "embed")), cache, {}
    def sub(key):
        return None if shard is None else shard[key]

    window = cfg.griffin.window if kind == "attn_local" else None
    with spans.span("attn", layer):
        h, cache = attn_mod.attention_apply(
            p["attn"], norm_apply(p["ln1"], x, cfg), cfg,
            positions=positions, causal=cfg.causal and kind != "enc",
            window=window, cache=cache, cache_index=cache_index,
            block_tables=block_tables, attend_cache=attend_cache,
            paged=paged, q_lens=q_lens, shard=sub("attn"))
        x = x + h
        if kind == "self_cross" and ctx is not None:
            hx, _ = attn_mod.attention_apply(
                p["xattn"], norm_apply(p["lnx"], x, cfg), cfg,
                positions=positions, causal=False, ctx=ctx,
                shard=sub("xattn"))
            x = x + torch.tanh(p["xgate"]).to(x.dtype) * hx
    aux = {}
    if kind == "moe":
        with spans.span("moe", layer):
            h, aux = moe_mod.moe_apply(p["moe"],
                                       norm_apply(p["ln2"], x, cfg), cfg,
                                       sub("moe"))
            x = x + h
    else:
        with spans.span("mlp", layer):
            x = x + mlp_apply(p["mlp"], norm_apply(p["ln2"], x, cfg), cfg,
                              sub("mlp"))
    return constrain(x, ("batch", "seq", "embed")), cache, aux
