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
serving entry points ignore it, and :meth:`Model.loss` adds it to the
cross-entropy.

Under autograd with no cache, each unit runs under
``torch.utils.checkpoint`` (``use_reentrant=False``) as the reference
wraps its unit function in ``jax.checkpoint``: ``parallel.remat="full"``
keeps only each unit's input and recomputes the unit in the backward;
``"dots"`` also keeps the output of every plain 2-D matrix product
(``aten.mm``: the dense GEMMs, the unembedding), the counterpart of
``dots_with_no_batch_dims_saveable``, and recomputes the batched products
(attention, expert einsums) and everything elementwise; ``"none"`` keeps
everything.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import params as pp
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (build_embed, build_norm, embed_apply,
                                       norm_apply, unembed_apply)
from repro_torch.models.params import P
from repro_torch.parallel import model as sharded
from repro_torch.parallel.comm import Local
from repro_torch.parallel.ctx import constrain


def _layer(tree, i: int):
    return pp.tree_map(lambda a: a[i], tree)


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective checkpointing for ``remat="dots"``: keep plain matrix
    products, recompute the rest."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, mode: str):
    """``fn`` under the unit checkpoint ``mode`` ('none' | 'full' | 'dots')."""
    if mode == "full":
        return functools.partial(_ckpt.checkpoint, fn, use_reentrant=False)
    if mode == "dots":
        return functools.partial(
            _ckpt.checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                _ckpt.create_selective_checkpoint_contexts, _dots_policy))
    return fn


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
              paged: bool = False, q_lens=None, gather_vocab: bool = True):
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

        On a mesh (``DTensor`` params under active rules) every rank
        computes on its local shards (:mod:`repro_torch.parallel.model`)
        and returns its rows of the batch, with every vocab column or,
        with ``gather_vocab=False``, its vocab shard.
        """
        cfg = self.cfg
        env = sharded.env_of(params)
        splits = csplits = None
        cache_in = cache
        if env is not None:
            sharded.check_modes(cfg, block_tables=block_tables,
                                attend_cache=attend_cache, paged=paged,
                                q_lens=q_lens)
            first = batch["frames" if cfg.family == "encoder" else "tokens"]
            params, splits = sharded.localize(params, env)
            cache, csplits = sharded.localize_cache(cache, env)
            batch = sharded.local_batch(batch)

        def shard(*path):
            """This rank's view of the subtree at ``path`` of the params
            (and of the cache, where it has one); None unsharded."""
            if env is None:
                return None
            split = functools.reduce(dict.__getitem__, path, splits)
            csplit = (functools.reduce(dict.__getitem__, path, csplits)
                      if csplits is not None and path[0] in csplits
                      else None)
            return Local(env.tp, split, csplit,
                         math.prod(ax.size for ax in env.batch))

        dt = getattr(torch, cfg.compute_dtype)
        if cfg.family == "encoder":
            w = params["frontend"]["w"]
            if env is not None:
                w = sharded.gather_params(w, splits["frontend"]["w"], env.tp)
            x = batch["frames"].to(dt) @ w.to(dt)
        else:
            x = embed_apply(params["embed"], batch["tokens"], cfg,
                            shard("embed"))
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
        x = (constrain(x, ("batch", "seq", "embed")) if env is None
             else sharded.residual(x, first, env))

        def run(x, lp, lc, group, keys):
            """The layers ``keys`` [(key, kind)] of one unit (or the tail,
            ``group`` "blocks" or "tail") -> (x, their moe_aux summed)."""
            aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
            for key, kind in keys:
                # an empty block cache ("enc") is a stateless block
                c = (lc[key] or None) if lc is not None else None
                x, _, aux = tfm.block_apply(
                    lp[key], x if env is None else sharded.enter(x, env),
                    cfg, kind, positions=positions, ctx=ctx, cache=c,
                    cache_index=cache_index, block_tables=block_tables,
                    attend_cache=attend_cache, paged=paged, q_lens=q_lens,
                    shard=shard(group, key))
                if env is not None:
                    x = sharded.residual(x, first, env)
                if "moe_aux" in aux:
                    aux_sum = aux_sum + aux["moe_aux"]
            return x, aux_sum

        unit_keys = [(f"sub{j}_{kind}", kind)
                     for j, kind in enumerate(self.unit)]
        unit_fn = (_remat(run, cfg.parallel.remat)
                   if cache is None and torch.is_grad_enabled() else run)
        for i in range(self.n_units):
            unit_cache = (_layer(cache["blocks"], i) if cache is not None
                          else None)
            x, aux = unit_fn(x, _layer(params["blocks"], i), unit_cache,
                             "blocks", unit_keys)
            aux_total = aux_total + aux
        if self.tail:  # unrolled, outside the unit checkpoint
            x, aux = run(x, params["tail"],
                         cache["tail"] if cache is not None else None, "tail",
                         [(f"tail{j}_{kind}", kind)
                          for j, kind in enumerate(self.tail)])
            aux_total = aux_total + aux
        if env is not None:
            x = sharded.enter(x, env)
        if last_index is not None:
            b = x.shape[0]
            idx = torch.as_tensor(last_index, device=x.device).long()
            x = x[torch.arange(b, device=x.device), idx.expand(b)][:, None]
        elif last_only:
            x = x[:, -1:]
        x = norm_apply(params["final_norm"], x, cfg)
        logits = unembed_apply(params["embed"], x, cfg, shard("embed"),
                               gather_vocab=gather_vocab)
        return logits, cache_in, aux_total

    # -- loss -----------------------------------------------------------------

    def loss(self, params, batch) -> Tuple[torch.Tensor,
                                           Dict[str, torch.Tensor]]:
        """Masked next-token cross-entropy (labels < 0 are masked), plus
        the MoE load-balancing aux times ``router_aux_weight``, and the
        masked accuracy: (total, {"loss", "ce", "aux", "accuracy"}).

        On a mesh each rank's rows are summed over the batch axes (every
        rank returns the global loss), and logits split over the vocab
        stay split (:func:`repro_torch.parallel.model.split_vocab_ll`)."""
        cfg = self.cfg
        env = sharded.env_of(params)
        logits, _, aux = self.apply(params, batch, gather_vocab=False)
        labels = batch["labels"]
        if env is not None:
            labels = sharded.local_batch({"labels": labels})["labels"]
        labels = labels.long()
        mask = (labels >= 0).float()
        labels = torch.clamp_min(labels, 0)
        if logits.shape[-1] == cfg.padded_vocab:  # every vocab column here
            logp = F.log_softmax(logits, dim=-1)
            ll = torch.gather(logp, -1, labels[..., None])[..., 0]
            right = torch.argmax(logits, -1) == labels
        else:
            ll, right = sharded.split_vocab_ll(logits, labels, env.tp)
        denom = torch.clamp_min(sharded.sum_batch(mask.sum(), env), 1.0)
        ce = -sharded.sum_batch((ll * mask).sum(), env) / denom
        if env is not None:  # the mean of the batch ranks' aux
            aux = sharded.sum_batch(aux, env) / math.prod(
                ax.size for ax in env.batch)
        total = ce
        if cfg.moe is not None:
            total = total + cfg.moe.router_aux_weight * aux
        acc = sharded.sum_batch((right * mask).sum(), env) / denom
        return total, {"loss": total, "ce": ce, "aux": aux, "accuracy": acc}

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


    # -- dry-run input specs ------------------------------------------------

    def input_specs(self, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
        """Stand-ins for every model input, as tensors on the ``meta``
        device (no allocation), with the reference's shapes and dtypes."""
        cfg = self.cfg
        b = shape.global_batch
        s = shape.seq_len
        dt = getattr(torch, cfg.compute_dtype)

        def meta(shp, dtype):
            return torch.empty(shp, dtype=dtype, device="meta")

        if shape.kind not in ("train", "prefill", "decode"):
            raise ValueError(shape.kind)
        if shape.kind == "decode":
            specs = {"tokens": meta((b, 1), torch.int32)}
        elif cfg.family == "encoder":
            specs = {"frames": meta((b, s, cfg.d_model), dt)}
        else:
            specs = {"tokens": meta((b, s), torch.int32)}
        if shape.kind == "train":
            specs["labels"] = meta((b, s), torch.int32)
        if cfg.family == "vlm":
            specs["patches"] = meta((b, cfg.vlm.n_patches, cfg.vlm.vision_dim),
                                    dt)
        return specs


def _ints(a, batch) -> torch.Tensor:
    """(B,) int32 on the tokens' device."""
    return torch.as_tensor(a, dtype=torch.int32,
                           device=batch["tokens"].device)
