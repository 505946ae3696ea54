"""Top-level model of every family (PyTorch port of
``repro.models.model``): embedding (or the encoder's frame projection) ->
layer stack -> norm -> unembed, with the serving entry points ``prefill``,
``prefill_bucketed``, ``prefill_chunk``, ``decode_step``, ``mixed_step``
and ``verify_step``, which pass the batch dict through: a VLM batch that
carries ``patches`` runs cross-attention, one without skips it.

The depth is ``n_units`` repetitions of the family's pattern unit, stacked
under ``"blocks"``, plus the unrolled ``tail`` layers that remain (Griffin's
26 layers are 8 units of (rec, rec, attn_local) and 2 tail rec layers),
each under ``"tail"`` by its own key. The reference scans the stacked
axis; here the units are a Python loop over it, each reading its slice (a
view) of the stacked parameter and cache tensors, so cache writes land in
the stacked tensors in place. ``apply`` returns the MoE blocks'
load-balancing aux summed over the layers, as the reference does; the
serving entry points ignore it.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import params as pp
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (build_embed, build_norm, embed_apply,
                                       norm_apply, unembed_apply)
from repro_torch.models.params import P


def _layer(tree, i: int):
    return pp.tree_map(lambda a: a[i], tree)


class Model:
    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg
        self.unit = tfm.pattern_for(cfg)
        u = len(self.unit)
        self.n_units = cfg.n_layers // u
        self.tail = tuple(self.unit[:cfg.n_layers % u])

    # -- parameter / cache trees (placeholders) ---------------------------

    def build(self) -> dict:
        cfg = self.cfg
        unit_tree = {f"sub{i}_{kind}": tfm.build_block(cfg, kind)
                     for i, kind in enumerate(self.unit)}
        tree = {"embed": build_embed(cfg),
                "blocks": pp.stack(unit_tree, self.n_units),
                "final_norm": build_norm(cfg.d_model)}
        if self.tail:
            tree["tail"] = {f"tail{i}_{kind}": tfm.build_block(cfg, kind)
                            for i, kind in enumerate(self.tail)}
        if cfg.family == "encoder":
            # modality frontend stub: projects precomputed frame embeddings
            tree["frontend"] = {
                "w": P((cfg.d_model, cfg.d_model), ("embed", "embed2"))}
        return tree

    def build_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                    per_slot: bool = False) -> dict:
        """``per_slot=True`` builds the continuous-batching layout: the
        position plane is (batch, cache_len) so every row decodes at its
        own depth."""
        unit_cache = {
            f"sub{i}_{kind}": tfm.build_block_cache(self.cfg, kind, batch,
                                                    max_len, dtype, per_slot)
            for i, kind in enumerate(self.unit)}
        cache = {"blocks": pp.stack(unit_cache, self.n_units)}
        if self.tail:
            cache["tail"] = {
                f"tail{i}_{kind}": tfm.build_block_cache(
                    self.cfg, kind, batch, max_len, dtype, per_slot)
                for i, kind in enumerate(self.tail)}
        return cache

    # -- forward ------------------------------------------------------------

    def apply(self, params, batch: Dict[str, torch.Tensor], *, cache=None,
              cache_index=None, last_only: bool = False, last_index=None,
              block_tables=None, attend_cache: bool = False,
              paged: bool = False, q_lens=None):
        """Forward pass over ``batch["tokens"]`` (B, S), or the encoder's
        ``batch["frames"]`` (B, S, D), with the VLM's optional
        ``batch["patches"]`` (B, P, Dv) as the cross-attention context.
        Returns (logits (B, S, V) — or (B, 1, V) with ``last_index``
        (scalar or (B,)) or ``last_only`` — cache, aux) — ``aux`` the sum
        of the layers' ``moe_aux`` (0 for the dense family).

        ``cache_index``: None (no cache), an int (write offset shared by
        the batch) or a (B,) tensor (per-slot start positions). ``q_lens``
        ((B,), with ``block_tables``) selects the fused mixed path: row r
        carries ``q_lens[r]`` real tokens.
        """
        cfg = self.cfg
        dt = getattr(torch, cfg.compute_dtype)
        if cfg.family == "encoder":
            x = batch["frames"].to(dt) @ params["frontend"]["w"].to(dt)
        else:
            x = embed_apply(params["embed"], batch["tokens"], cfg)
        ctx = batch.get("patches")
        if ctx is not None:
            ctx = ctx.to(dt)
        s = x.shape[1]
        ar = torch.arange(s, dtype=torch.int32, device=x.device)
        if cache_index is None:
            positions = ar
        elif torch.is_tensor(cache_index) and cache_index.ndim == 1:
            positions = cache_index.to(torch.int32)[:, None] + ar[None, :]
        else:
            positions = int(cache_index) + ar
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        # (params, cache, key, kind) of every layer: the stacked units' in
        # depth order, then the tail's
        layers = []
        for i in range(self.n_units):
            unit_params = _layer(params["blocks"], i)
            unit_cache = (_layer(cache["blocks"], i) if cache is not None
                          else None)
            layers += [(unit_params, unit_cache, f"sub{j}_{kind}", kind)
                       for j, kind in enumerate(self.unit)]
        layers += [(params["tail"], cache["tail"] if cache is not None
                    else None, f"tail{j}_{kind}", kind)
                   for j, kind in enumerate(self.tail)]
        for lp, lc, key, kind in layers:
            x, _, aux = tfm.block_apply(
                lp[key], x, cfg, kind, positions=positions, ctx=ctx,
                # an empty block cache ("enc") is a stateless block
                cache=(lc[key] or None) if lc is not None else None,
                cache_index=cache_index, block_tables=block_tables,
                attend_cache=attend_cache, paged=paged, q_lens=q_lens)
            if "moe_aux" in aux:
                aux_total = aux_total + aux["moe_aux"]
        if last_index is not None:
            b = x.shape[0]
            idx = torch.as_tensor(last_index, device=x.device).long()
            x = x[torch.arange(b, device=x.device), idx.expand(b)][:, None]
        elif last_only:
            x = x[:, -1:]
        x = norm_apply(params["final_norm"], x, cfg)
        logits = unembed_apply(params["embed"], x, cfg)
        return logits, cache, aux_total

    # -- serving ------------------------------------------------------------

    def prefill(self, params, batch, cache):
        """Process a whole prompt, fill the cache from row 0 (a prompt of
        at least the cache's length keeps its tail in ring order), and
        return the last token's logits."""
        logits, cache, _ = self.apply(params, batch, cache=cache,
                                      cache_index=0, last_only=True)
        return logits[:, -1], cache

    def prefill_bucketed(self, params, batch, cache, last_index):
        """Whole-prompt prefill over bucket-padded tokens, writing the
        cache's rows [0, S). Returns each row's last *real* token's logits
        (``last_index``, scalar or (B,)). The caller invalidates the pad
        positions the cache recorded before it is decoded from."""
        logits, cache, _ = self.apply(params, batch, cache=cache,
                                      cache_index=0, last_index=last_index)
        return logits[:, -1], cache

    def prefill_chunk(self, params, batch, cache, committed, last_index):
        """Prefill past ``committed`` rows that already hold valid K/V (a
        cached prefix): write the chunk at [committed, committed + S) and
        attend over the whole updated cache. Returns the logits of each
        row's last real token (``last_index``, chunk-relative)."""
        logits, cache, _ = self.apply(params, batch, cache=cache,
                                      cache_index=int(committed),
                                      last_index=last_index,
                                      attend_cache=True)
        return logits[:, -1], cache

    def decode_step(self, params, token, cache, index, block_tables=None, *,
                    paged: bool = False):
        """One decode step. token: (B, 1); index: (B,) per-slot positions;
        ``block_tables`` (B, n_blocks) int32 indexes the physical-block
        arena; ``paged`` runs the paged attention kernel over it."""
        logits, cache, _ = self.apply(params, {"tokens": token}, cache=cache,
                                      cache_index=index,
                                      block_tables=block_tables, paged=paged)
        return logits[:, -1], cache

    def mixed_step(self, params, batch, cache, start, q_lens, last_index,
                   block_tables, *, paged: bool = False):
        """One fused chunk+decode step over the block arena: row r of
        ``batch['tokens']`` (B, S) carries ``q_lens[r]`` real tokens from
        absolute position ``start[r]`` (decode rows 1, chunk rows up to S,
        idle rows 0). Each row's valid K/V is committed through its block
        table inside this call; returns each row's ``last_index`` logits."""
        logits, cache, _ = self.apply(
            params, batch, cache=cache, cache_index=_ints(start, batch),
            last_index=last_index, block_tables=block_tables, paged=paged,
            q_lens=_ints(q_lens, batch))
        return logits[:, -1], cache

    def verify_step(self, params, batch, cache, start, q_lens, block_tables,
                    *, paged: bool = False):
        """Speculative verify: the routing of :meth:`mixed_step`, but the
        logits of every position come back, (B, S, V): position j of row r
        is the next-token distribution after its first j + 1 fed tokens."""
        logits, cache, _ = self.apply(
            params, batch, cache=cache, cache_index=_ints(start, batch),
            block_tables=block_tables, paged=paged,
            q_lens=_ints(q_lens, batch))
        return logits, cache


def _ints(a, batch) -> torch.Tensor:
    """(B,) int32 on the tokens' device."""
    return torch.as_tensor(a, dtype=torch.int32,
                           device=batch["tokens"].device)
