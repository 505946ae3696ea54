"""Continuous-batching serve engine over SWIS-packed weights (PyTorch port
of ``repro.serve.engine.ContinuousBatchingEngine``, block mode).

A :class:`~repro_torch.serve.scheduler.RequestScheduler` admits requests
into free slots; the block-mode :class:`~repro_torch.serve.kv_cache.
SlotKVCache` and the :class:`~repro_torch.serve.prefix_cache.
RadixPrefixCache` let an admitted request reference the cached blocks of
its longest block-aligned prompt prefix and prefill only the rest. Each
``step()`` admits, prefills the admitted requests (bucketed whole-prompt
prefill, or suffix prefill past a cached prefix), and runs one batched
decode step over every slot, through the paged attention kernel with
``use_paged_kernel=True``. With ``packed=True`` every GEMM reads SWIS
bit-planes through the SWIS matmul kernel.

Decoding is greedy. Seeded sampling at temperature > 0 must reproduce the
reference's ``jax.random`` (threefry) draws to be token-exact and is not
ported yet; neither are chunked prefill, the fused mixed step, speculative
decode, the contiguous cache mode, metrics and tracing. Each raises
``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs.base import ArchConfig, QuantPolicy
from repro_torch.core.swis import QuantConfig
from repro_torch.models import params as pp
from repro_torch.models.model import Model
from repro_torch.serve.config import EngineConfig, SamplingParams
from repro_torch.serve.kv_cache import SlotKVCache
from repro_torch.serve.prefix_cache import BlockPool, RadixPrefixCache
from repro_torch.serve.quantized import pack_tree
from repro_torch.serve.scheduler import Finished, RequestScheduler

_NOT_PORTED = {
    "prefill_chunk": "chunked prefill (ROADMAP A6, port queue item 2)",
    "fused_step": "the fused mixed step (ROADMAP A6, port queue item 3)",
    "spec_decode": "speculative decode (ROADMAP A6, port queue item 4)",
    "enable_metrics": "metrics and tracing (ROADMAP A7, port queue item 6)",
}


def sample_greedy(logits: torch.Tensor) -> np.ndarray:
    """Greedy next tokens (first maximum on ties, as ``jnp.argmax``)."""
    return logits.argmax(dim=-1).to(torch.int32).cpu().numpy()


def _maybe_pack(cfg: ArchConfig, params, packed: bool,
                quant_cfg: Optional[QuantConfig]):
    """Common packing path: returns (cfg, params, pack_stats)."""
    if not packed:
        return cfg, params, None
    qcfg = quant_cfg or cfg.quant.cfg
    params, stats = pack_tree(params, qcfg)
    # record the pack method so dense() unpacks with the right
    # (consecutive vs sparse) shift semantics
    return cfg.replace(quant=QuantPolicy(cfg=qcfg, mode="off")), params, stats


class ContinuousBatchingEngine:
    """Step-driven serve engine: requests join mid-flight.

    ``ContinuousBatchingEngine(cfg, params, config=EngineConfig(...),
    device="cuda")``; ``submit(prompt_1d, SamplingParams(max_tokens))
    -> rid``; ``step()`` runs one scheduler round and returns the requests
    that finished; ``drain()`` steps until idle. ``params`` are moved to
    ``device``; a packed tree may be passed with ``packed=True`` (packing a
    packed tree is a no-op).

    ``n_prefill_calls`` and ``n_decode_steps`` count the model calls made,
    so a caller can check how many kernel launches a run should have made.
    """

    def __init__(self, cfg: ArchConfig, params: Any,
                 config: Optional[EngineConfig] = None, *, device="cuda"):
        config = config or EngineConfig()
        if not isinstance(config, EngineConfig):
            raise TypeError(f"config must be an EngineConfig, got "
                            f"{type(config).__name__}")
        for name, what in _NOT_PORTED.items():
            if getattr(config, name) not in (None, False):
                raise NotImplementedError(f"{name}: {what} is not ported yet")
        if not config.prefix_cache:
            raise NotImplementedError(
                "prefix_cache=False: the contiguous cache mode (ROADMAP A6, "
                "port queue item 5) is not ported yet")
        self.config = config
        self.device = _device.resolve(device)
        params = pp.tree_map(lambda a: a.to(self.device), params)
        self.cfg, self.params, self.pack_stats = _maybe_pack(
            cfg, params, config.packed, config.quant_cfg)
        self.max_len = config.max_len
        self.n_slots = config.n_slots
        self.model = Model(self.cfg)
        if not SlotKVCache.supports_blocks(self.model, self.max_len):
            raise NotImplementedError(
                "this family's cache is not block-compatible; the contiguous "
                "cache mode is not ported yet")
        self.bucket_prompts = config.bucket_prompts
        bps = -(-self.max_len // config.block_size)
        extra = (2 * bps if config.n_cache_blocks is None
                 else config.n_cache_blocks)
        n_blocks = self.n_slots * bps + extra + 1  # +1: trash block
        self.cache = SlotKVCache(self.model, self.n_slots, self.max_len,
                                 config.cache_dtype,
                                 block_size=config.block_size,
                                 n_blocks=n_blocks, device=self.device)
        self.paged = config.use_paged_kernel
        self.reset()

    # -- request API ----------------------------------------------------

    def submit(self, prompt, params: SamplingParams) -> int:
        """Enqueue a request; returns its id."""
        if not isinstance(params, SamplingParams):
            raise TypeError(f"submit() expects SamplingParams, got "
                            f"{type(params).__name__}")
        if params.temperature > 0:
            raise NotImplementedError(
                "temperature > 0 needs a threefry2x32 sampler matching the "
                "reference's jax.random draws (port queue item 1); only "
                "greedy decoding is ported")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size + params.max_tokens > self.max_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_tokens ({params.max_tokens}) "
                f"exceeds max_len ({self.max_len})")
        return self.scheduler.submit(prompt, params.max_tokens, 0.0, None)

    def step(self) -> List[Finished]:
        """One scheduler round: admit queued requests and prefill them,
        then one batched decode step over the DECODING slots."""
        admitted = self.scheduler.admit()
        if admitted:
            self._run_prefill(self._assign_blocks(admitted))
        if self.scheduler.needs_decode():
            self._decode_once()
        return self.scheduler.pop_finished()

    def drain(self) -> Dict[int, np.ndarray]:
        """Step until idle. Returns {rid: prompt + generated tokens}."""
        out: Dict[int, np.ndarray] = {}
        while self.scheduler.pending():
            for f in self.step():
                out[f.rid] = np.concatenate([f.prompt, f.tokens])
        return out

    def generate(self, prompt: np.ndarray, n_tokens: int,
                 temperature: float = 0.0) -> np.ndarray:
        """Static-batch wrapper: prompt (B, S0) -> (B, S0 + n_tokens)."""
        if self.scheduler.pending():
            raise RuntimeError("generate() requires an idle engine")
        rids = [self.submit(row, SamplingParams(max_tokens=n_tokens,
                                                temperature=temperature))
                for row in np.asarray(prompt)]
        out = self.drain()
        return np.stack([out[rid] for rid in rids])

    def reset(self) -> None:
        """Return an idle engine to its post-construction state: empty
        queue, empty prefix cache, zeroed counters. Stale arena K/V stays:
        admission scrubs the blocks it takes over before they are read."""
        if getattr(self, "scheduler", None) is not None and \
                self.scheduler.pending():
            raise RuntimeError("reset() requires an idle engine")
        self.scheduler = RequestScheduler(self.n_slots)
        self.prefix_cache = RadixPrefixCache(
            BlockPool(self.cache.n_blocks, self.cache.block_size))
        self.scheduler.on_release = self._release_slot
        self.scheduler.admission_priority = self._hit_score
        self._slot_meta: Dict[int, dict] = {}
        for slot in range(self.n_slots):
            self.cache.clear_table(slot)
        self._stat_prefill_tokens = 0
        self._stat_saved_tokens = 0
        self.n_prefill_calls = 0
        self.n_decode_steps = 0

    def prefix_stats(self) -> Dict[str, Any]:
        """Prefix-cache health: hit rate, tokens saved vs computed, block
        commits and evictions, arena occupancy."""
        out = self.prefix_cache.stats()
        out.update(enabled=True, block_size=self.cache.block_size,
                   prefill_tokens=self._stat_prefill_tokens,
                   saved_tokens=self._stat_saved_tokens,
                   hit_tokens=self._stat_saved_tokens, prefill_chunk=None,
                   prefill_chunk_steps=0)
        return out

    # -- internals ------------------------------------------------------

    def _hit_score(self, req) -> int:
        """Cache-aware admission: expected cached-prefix tokens."""
        bs = self.cache.block_size
        return bs * self.prefix_cache.peek_blocks(
            req.prompt, max_blocks=(len(req.prompt) - 1) // bs)

    def _bucket(self, s: int, prefix_len: int) -> int:
        """Pad a (suffix) prefill length up to a power-of-two bucket,
        clamped to the cache capacity past the prefix."""
        if not self.bucket_prompts:
            return s
        cap = self.cache.eff_len - prefix_len
        return min(max(8, 1 << max(s - 1, 0).bit_length()), cap)

    def _assign_blocks(self, admitted):
        """Match each admitted prompt against the radix trie, reference the
        cached prefix blocks and allocate owned blocks for the rest
        (evicting unreferenced LRU blocks on pressure). Requests the pool
        cannot cover yet go back to the queue."""
        pool = self.prefix_cache.pool
        bs = self.cache.block_size
        ok, failed = [], []
        for slot, st in admitted:
            req = st.req
            s0 = len(req.prompt)
            need = -(-(s0 + req.n_tokens) // bs)
            # at least one suffix token must run through the model: its
            # logits seed generation
            matched = self.prefix_cache.match(req.prompt,
                                              max_blocks=(s0 - 1) // bs)
            pool.incref(matched)
            own = need - len(matched)
            if pool.n_free() < own:
                self.prefix_cache.evict(own - pool.n_free())
            ids = pool.alloc(own)
            if ids is None:
                self.prefix_cache.release(matched)
                failed.append(slot)
                continue
            self.prefix_cache.count_lookup(matched)
            pool.incref(ids)
            self.cache.set_table(slot, matched + ids)
            self._slot_meta[slot] = {"matched": matched, "owned": ids,
                                     "need": need,
                                     "prefix_blocks": len(matched)}
            self._stat_saved_tokens += len(matched) * bs
            ok.append((slot, st))
        for slot in reversed(failed):  # appendleft: reverse keeps FIFO
            self.scheduler.unadmit(slot)
        return ok

    def _release_slot(self, slot: int, st) -> None:
        """Scheduler release hook: commit the request's full token blocks
        into the trie, drop its block references, and park the slot's
        table on the trash block."""
        meta = self._slot_meta.pop(slot, None)
        if meta is None:
            return
        # cache rows hold K/V for prompt + every fed-back token (the final
        # sampled token never re-enters the model)
        seq = np.concatenate([st.req.prompt,
                              np.asarray(st.tokens[:-1], np.int32)])
        n_commit = min(len(seq) // self.cache.block_size, meta["need"])
        self.prefix_cache.commit(
            seq, self.cache.block_tables[slot, :n_commit].tolist())
        self.prefix_cache.release(meta["matched"] + meta["owned"])
        self.cache.clear_table(slot)

    def _run_prefill(self, admitted) -> None:
        # one batched prefill per (prefix length, bucketed suffix length)
        groups: Dict[Any, list] = {}
        bs = self.cache.block_size
        for slot, st in admitted:
            p_len = self._slot_meta[slot]["prefix_blocks"] * bs
            s_real = len(st.req.prompt) - p_len
            groups.setdefault((p_len, self._bucket(s_real, p_len)),
                              []).append((slot, st))
        for (p_len, s_pad), group in groups.items():
            g = len(group)
            toks = np.zeros((g, s_pad), np.int32)
            lasts = np.empty(g, np.int64)
            for i, (_, st) in enumerate(group):
                sfx = st.req.prompt[p_len:]
                toks[i, :len(sfx)] = sfx
                lasts[i] = len(sfx) - 1
            batch = {"tokens": torch.from_numpy(toks).long().to(self.device)}
            last_idx = torch.from_numpy(lasts).to(self.device)
            self._stat_prefill_tokens += int(lasts.sum()) + g
            meta = [self._slot_meta[slot] for slot, _ in group]
            cache = self.cache.prefix_tree([m["matched"] for m in meta], p_len)
            self.n_prefill_calls += 1
            if p_len:
                logits, cache = self.model.prefill_chunk(
                    self.params, batch, cache, p_len, last_idx)
            else:
                logits, cache = self.model.prefill_bucketed(
                    self.params, batch, cache, last_idx)
            for i, (slot, st) in enumerate(group):
                self.cache.scatter_row(cache, i, meta[i]["owned"],
                                       meta[i]["prefix_blocks"],
                                       len(st.req.prompt) - p_len)
            for (slot, _), tok in zip(group, sample_greedy(logits)):
                self.scheduler.record_prefill(slot, tok)

    def _decode_once(self) -> None:
        toks, idxs, _, _, _ = self.scheduler.decode_batch(None)
        self.n_decode_steps += 1
        logits, self.cache.tree = self.model.decode_step(
            self.params, torch.from_numpy(toks).long().to(self.device)[:, None],
            self.cache.tree, torch.from_numpy(idxs).to(self.device),
            self.cache.tables_device(), paged=self.paged)
        self.scheduler.record_decode(sample_greedy(logits))
