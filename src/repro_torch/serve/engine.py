"""Serve engines over SWIS-packed weights (PyTorch port of
``repro.serve.engine``).

Two engines share the model, the packing path and the seeded sampler
:func:`sample_step`:

* :class:`ContinuousBatchingEngine` — the serving hot path. A
  :class:`~repro_torch.serve.scheduler.RequestScheduler` admits requests
  into free slots of a :class:`~repro_torch.serve.kv_cache.SlotKVCache`;
  admitted requests prefill (whole, suffix past a cached prefix, or chunk
  by chunk) while the other slots keep decoding, one batched step at a
  time. It serves every option of the reference engine: the block arena
  with the radix prefix cache or contiguous rows, chunked prefill, the
  fused mixed step, self-speculative decode and seeded sampling, with the
  reference's observability: phase timers, counters and per-dispatch
  cost-model counters in a :class:`~repro_torch.serve.metrics.
  MetricsRegistry`, request lifecycles and phase spans in a
  :class:`~repro_torch.serve.trace.RequestTracer`, all read through
  ``engine.metrics()`` (``enable_metrics``, on by default).
* :class:`DecodeEngine` — the static-batch engine (one lockstep batch, a
  fresh contiguous cache per call), kept as the parity oracle.

With ``packed=True`` every GEMM reads SWIS bit-planes through the SWIS
matmul kernel; with ``use_paged_kernel=True`` every launch over the block
arena (decode, mixed, draft, verify) runs the paged attention kernel.
"""
from __future__ import annotations

import collections
import dataclasses
import warnings
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs.base import ArchConfig, QuantPolicy
from repro_torch.core.swis import QuantConfig
from repro_torch.models import params as pp
from repro_torch.models.model import Model
from repro_torch.serve import prng
from repro_torch.serve import trace as tr
from repro_torch.serve.config import EngineConfig, SamplingParams
from repro_torch.serve.costmodel import CostModel
from repro_torch.serve.kv_cache import SlotKVCache
from repro_torch.serve.metrics import MetricsRegistry, cost_buckets
from repro_torch.serve.prefix_cache import BlockPool, RadixPrefixCache
from repro_torch.serve.quantized import pack_tree, total_slices
from repro_torch.serve.scheduler import Finished, RequestScheduler
from repro_torch.serve.trace import RequestTracer

# shared bucket edges for per-dispatch cost histograms (the registry only
# consults edges when a histogram is first created)
_COST_EDGES = cost_buckets()
_COST_FIELDS = ("flops", "hbm_bytes", "swis_cycles")


def sample_step(logits: torch.Tensor, keys, steps, temps) -> torch.Tensor:
    """Seeded per-row sampling, token-exact with the reference's.

    Row r draws ``argmax(logits[r] / max(temps[r], 1e-6) + gumbel)`` with
    the gumbel noise of key ``fold_in(keys[r], steps[r])`` — the
    reference's ``categorical`` — or the greedy ``argmax(logits[r])`` when
    ``temps[r] <= 0``. ``keys`` (B, 2) key data, ``steps`` (B,) ints,
    ``temps`` (B,) floats; returns (B,) int32 on the logits' device.
    """
    greedy = logits.argmax(dim=-1).to(torch.int32)
    temps = torch.as_tensor(np.asarray(temps, np.float32))
    if not bool((temps > 0).any()):
        return greedy  # a greedy batch draws no noise: same tokens
    dev = logits.device
    keys = torch.as_tensor(keys).to(dev)
    steps = torch.as_tensor(np.asarray(steps, np.int64)).to(dev)
    temps = temps.to(dev)
    noise = prng.gumbel(prng.fold_in(keys, steps), logits.shape[-1])
    scaled = logits.float() / torch.clamp_min(temps, 1e-6)[:, None]
    sampled = (noise + scaled).argmax(dim=-1).to(torch.int32)
    return torch.where(temps <= 0, greedy, sampled)


def _sample(logits, keys: List[torch.Tensor], steps, temps) -> np.ndarray:
    return sample_step(logits, torch.stack(list(keys)), steps,
                       temps).cpu().numpy()


def require_decoder(cfg: ArchConfig) -> None:
    """The engines serve decoders only: an encoder-only config
    (``has_decoder`` False, hubert-xlarge) raises ``ValueError``. The
    reference's engines cannot serve one either (its prefill has no
    ``frames``); an encoder runs through ``Model.apply``."""
    if not cfg.has_decoder:
        raise ValueError(f"{cfg.name} is encoder-only (has_decoder=False): "
                         f"the serve engines need a decoder; run it through "
                         f"Model.apply")


def _extra_sig(extra):
    """Prefill grouping key of a request's extra inputs: their names and
    shapes (None without any), so that requests with and without, e.g., VLM
    patches never share a batch."""
    return (tuple(sorted((k, tuple(np.shape(v))) for k, v in extra.items()))
            if extra else None)


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
    device="cuda")``; ``submit(prompt_1d, SamplingParams(max_tokens,
    temperature, seed | key)) -> rid``; ``step()`` runs one scheduler round
    and returns the requests that finished; ``drain()`` steps until idle.
    ``params`` are moved to ``device``; a packed tree may be passed with
    ``packed=True`` (packing a packed tree is a no-op).

    Options, as in the reference engine: ``prefix_cache`` (block arena and
    radix prefix cache; False: contiguous rows), ``prefill_chunk`` (at most
    one chunk of prefill per step, round-robin over the admitted groups,
    ``prefill_backlog`` groups in flight), ``fused_step`` (the chunk and the
    decode batch in one ``mixed_step`` launch), ``spec_decode`` (``spec_k``
    drafts from the model cut to ``draft_slices`` bit-planes, one verify
    launch, token-exact against plain decode). Families whose caches are
    not full-length attention caches (Griffin, Mamba2) always take the
    contiguous rows, with no bucket padding: prompts prefill in groups of
    one exact length, so no recurrent row sees a pad token; the three
    options that need the block arena raise for them.

    Observability, as in the reference: ``metrics()`` is one snapshot of
    the phase timers (``step.*_s``), counters (``step.model_dispatches``,
    ``spec.*``, ``cost.*``), scheduler gauges, prefix-cache and block-pool
    stats and the trace ring; ``tracer`` holds the request lifecycles and
    phase spans (JSONL and Chrome trace export). ``paged_impl`` names the
    paged backend the cost model counts: ``"cuda"`` (the kernel, no
    gathered K/V), ``"xla"`` (the plain version on the CPU, which walks
    the blocks as the reference's XLA scan), or None (the gather path).

    Requests may carry extra inputs (``submit(..., extra={"patches":
    ...})``, the VLM's patch embeddings): only their prefill launches read
    them (decode, mixed, draft and verify launches feed tokens alone, as
    in the reference); they never match or commit prefix-cache blocks and
    score 0 for admission; prefill groups them by their extra inputs'
    shapes; and their chunk groups take the separate path, never the
    fused step. An encoder-only config raises ``ValueError``.

    Counters of the model calls made, so a caller can check how many
    kernel launches a run should have made: ``n_prefill_calls`` (whole or
    suffix prefill), ``n_chunk_calls`` (separate chunk prefill),
    ``n_mixed_steps``, ``n_decode_steps``, ``n_draft_steps`` and
    ``n_verify_steps``; and ``spec_proposed`` / ``spec_accepted`` draft
    tokens.
    """

    def __init__(self, cfg: ArchConfig, params: Any,
                 config: Optional[EngineConfig] = None, *, device="cuda",
                 **legacy):
        """The reference's deprecated loose kwargs still work:
        ``ContinuousBatchingEngine(cfg, params, max_len=..., n_slots=...)``
        warns (``DeprecationWarning``) and builds ``EngineConfig(**legacy)``;
        with ``config=`` as well it raises ``TypeError``, as does a name
        that is not a field of the port's :class:`EngineConfig`. The
        reference's ``paged_impl`` is not one (the tensors' device picks the
        paged kernel or its plain version), so ``paged_impl=`` raises that
        ``TypeError`` here."""
        if legacy:
            if config is not None:
                raise TypeError(
                    "pass either config=EngineConfig(...) or the legacy "
                    "loose kwargs, not both")
            known = {f.name for f in dataclasses.fields(EngineConfig)}
            unknown = set(legacy) - known
            if unknown:
                raise TypeError(
                    f"unknown engine kwargs {sorted(unknown)}; valid "
                    f"EngineConfig fields: {sorted(known)}")
            warnings.warn(
                "ContinuousBatchingEngine(cfg, params, max_len=..., ...) "
                "loose kwargs are deprecated; pass "
                "config=EngineConfig(...) instead", DeprecationWarning,
                stacklevel=2)
            config = EngineConfig(**legacy)
        elif config is None:
            config = EngineConfig()
        elif not isinstance(config, EngineConfig):
            raise TypeError(
                f"config must be an EngineConfig, got "
                f"{type(config).__name__} (legacy positional max_len is "
                f"not supported here — pass EngineConfig(max_len=...))")
        require_decoder(cfg)
        self.config = config
        # enable_metrics=False swaps in no-op instruments: the hot path
        # pays one attribute check per phase
        self.metrics_registry = MetricsRegistry(enabled=config.enable_metrics)
        self.tracer = RequestTracer(capacity=config.trace_capacity,
                                    enabled=config.enable_metrics)
        self.device = _device.resolve(device)
        params = pp.tree_map(lambda a: a.to(self.device), params)
        self.cfg, self.params, self.pack_stats = _maybe_pack(
            cfg, params, config.packed, config.quant_cfg)
        self.max_len = config.max_len
        self.n_slots = config.n_slots
        self.model = Model(self.cfg)
        uniform = SlotKVCache.supports_blocks(self.model, self.max_len)
        # bucket padding is sound only for pure attention caches, whose
        # pad writes are masked out by pos
        self.bucket_prompts = config.bucket_prompts and uniform
        self.block_mode = config.prefix_cache and uniform
        if self.block_mode:
            bps = -(-self.max_len // config.block_size)
            extra = (2 * bps if config.n_cache_blocks is None
                     else config.n_cache_blocks)
            n_blocks = self.n_slots * bps + extra + 1  # +1: trash block
            self.cache = SlotKVCache(self.model, self.n_slots, self.max_len,
                                     config.cache_dtype,
                                     block_size=config.block_size,
                                     n_blocks=n_blocks, device=self.device)
        else:
            self.cache = SlotKVCache(self.model, self.n_slots, self.max_len,
                                     config.cache_dtype, block_size=None,
                                     device=self.device)
        for name, on in (("prefill_chunk", config.prefill_chunk is not None),
                         ("use_paged_kernel", config.use_paged_kernel),
                         ("spec_decode", config.spec_decode)):
            if on and not self.block_mode:
                raise ValueError(f"{name} requires the block-mode prefix "
                                 f"cache (uniform attention caches with "
                                 f"prefix_cache=True)")
        chunk = config.prefill_chunk
        if chunk is not None:
            # chunk boundaries are block-aligned so each chunk commits
            # whole blocks into the arena as it lands
            bs = self.cache.block_size
            chunk = max(bs, -(-chunk // bs) * bs)
        self.prefill_chunk = chunk
        self.prefill_backlog = config.prefill_backlog
        self.fused_step = config.fused_step
        self.paged = config.use_paged_kernel
        self.paged_impl = (None if not self.paged else
                           "cuda" if self.device.type == "cuda" else "xla")
        # self-speculative decode: the draft model is the target model
        # under a policy whose keep_slices cuts every packed GEMM to the
        # top draft_slices bit-planes (None: a full-precision draft)
        self.spec_decode = config.spec_decode
        self.spec_k = config.spec_k
        self.draft_model = self.model
        if config.spec_decode and config.draft_slices is not None:
            total = total_slices(self.params)
            if not 1 <= config.draft_slices <= total:
                raise ValueError(
                    f"draft_slices={config.draft_slices} out of range: the "
                    f"packed weights carry {total} bit-slices (1 <= "
                    f"draft_slices <= {total})")
            self.draft_model = Model(self.cfg.replace(quant=dataclasses.replace(
                self.cfg.quant, keep_slices=config.draft_slices)))
        # analytical per-dispatch cost model: every model call records its
        # predicted FLOPs, HBM bytes and SWIS shift-pass cycles
        self.cost_model = CostModel.for_engine(self)
        self._dummy_key = prng.key(0)
        self.scheduler = None
        self.reset()

    # -- request API ----------------------------------------------------

    def submit(self, prompt, params: Optional[SamplingParams] = None,
               n_tokens: Optional[int] = None, temperature: float = 0.0,
               key=None, seed: Optional[int] = None, extra=None) -> int:
        """Enqueue a request; returns its id. ``params.seed`` (or an
        explicit ``params.key``, two uint32 words) makes its sampling
        reproducible; otherwise it gets the distinct key
        ``fold_in(key(0), rid)``. ``extra`` ({name: array}, e.g. the VLM's
        ``patches`` (P, Dv)) joins the batch of the request's prefill
        launches, stacked over the group's rows. The reference's legacy
        signature ``submit(prompt, n_tokens, temperature=..., key=...,
        seed=...)`` still works behind a ``DeprecationWarning`` (``key``:
        two uint32 words, as ``SamplingParams.key``)."""
        if isinstance(params, SamplingParams):
            if (n_tokens is not None or temperature or key is not None
                    or seed is not None):
                raise TypeError(
                    "legacy sampling kwargs (n_tokens/temperature/key/"
                    "seed) cannot be combined with SamplingParams")
        else:
            if isinstance(params, (int, np.integer)):
                if n_tokens is not None:
                    raise TypeError(
                        "got both a positional token budget and n_tokens")
                n_tokens = int(params)
            elif params is not None:
                raise TypeError(
                    f"submit() expects SamplingParams, got "
                    f"{type(params).__name__}")
            if n_tokens is None:
                raise TypeError(
                    "submit() needs a SamplingParams (or the deprecated "
                    "n_tokens kwarg)")
            warnings.warn(
                "submit(prompt, n_tokens, temperature=..., key=..., "
                "seed=...) is deprecated; pass "
                "submit(prompt, SamplingParams(max_tokens, ...))",
                DeprecationWarning, stacklevel=2)
            params = SamplingParams(
                max_tokens=int(n_tokens), temperature=temperature,
                seed=seed if key is None else None, key=key)
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size + params.max_tokens > self.max_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_tokens ({params.max_tokens}) "
                f"exceeds max_len ({self.max_len})")
        if params.key is not None:
            key = prng.as_key(params.key)
        elif params.seed is not None:
            key = prng.key(params.seed)
        else:
            key = prng.fold_in(self._dummy_key, self.scheduler.next_rid())
        rid = self.scheduler.submit(prompt, params.max_tokens,
                                    params.temperature, key, extra)
        self.tracer.event(tr.SUBMIT, rid, prompt_len=int(prompt.size),
                          n_tokens=int(params.max_tokens))
        return rid

    def step(self) -> List[Finished]:
        """One scheduler round: admit queued requests (unless the chunk
        backlog is full) and prefill them or stage their chunks, run at
        most one chunk of prefill, then one batched decode step over the
        DECODING slots. With ``fused_step`` the chunk and the decode batch
        ride one ``mixed_step`` launch.

        Phase timers (``step.*_s`` histograms): admit, prefix_match,
        prefill_dispatch, chunk_advance, mixed_dispatch, decode_dispatch,
        device_sync (the wait for the logits, split from the host's
        sampling), sample_host, and ``step.total_s`` for the whole round;
        ``step.model_dispatches`` counts model calls."""
        m = self.metrics_registry
        self.tracer.current_step = self._step_no
        with self._phase("step.total_s", "step"):
            if len(self._prefill_groups) < self.prefill_backlog:
                with self._phase("step.admit_s", "admit"):
                    admitted = self.scheduler.admit()
                if admitted:
                    for slot, st in admitted:
                        self.tracer.event(tr.ADMIT, st.req.rid, slot=slot)
                    self._prefill_admitted(admitted)
            decoded = False
            if self._prefill_groups:
                if self._prefill_groups[0].get("fused"):
                    self._mixed_once()  # the chunk AND the decode batch
                    decoded = True
                else:
                    with self._phase("step.chunk_advance_s",
                                     "chunk_advance"):
                        self._advance_chunk()
            if not decoded and self.scheduler.needs_decode():
                if self.spec_decode:
                    self._spec_once()
                else:
                    self._decode_once()
            finished = self.scheduler.pop_finished()
        for f in finished:
            self.tracer.event(tr.FINISH, f.rid, n_tokens=len(f.tokens))
        m.counter("step.count").inc()
        self._step_no += 1
        if m.enabled:
            # model-vs-measured utilization: bytes the cost model says the
            # issued dispatches should have moved, over measured step time
            total = m.histogram("step.total_s").total
            if total > 0.0:
                m.gauge("cost.hbm_bytes_per_s").set(
                    m.counter("cost.hbm_bytes").value / total)
                m.gauge("cost.flops_per_s").set(
                    m.counter("cost.flops").value / total)
        return finished

    def drain(self) -> Dict[int, np.ndarray]:
        """Step until idle. Returns {rid: prompt + generated tokens}."""
        out: Dict[int, np.ndarray] = {}
        while self.scheduler.pending():
            for f in self.step():
                out[f.rid] = np.concatenate([f.prompt, f.tokens])
        return out

    def generate(self, prompt: np.ndarray, n_tokens: int,
                 extra: Optional[Dict[str, Any]] = None,
                 temperature: float = 0.0, seed: int = 0) -> np.ndarray:
        """Static-batch wrapper: prompt (B, S0) -> (B, S0 + n_tokens). Row r
        samples with key fold_in(key(seed), r), as :class:`DecodeEngine`,
        and carries row r of each ``extra`` input."""
        if self.scheduler.pending():
            raise RuntimeError("generate() requires an idle engine")
        rng = prng.key(seed)
        rids = [self.submit(row, SamplingParams(
                    max_tokens=n_tokens, temperature=temperature,
                    key=prng.fold_in(rng, r)),
                    extra={k: v[r] for k, v in extra.items()} if extra
                    else None)
                for r, row in enumerate(np.asarray(prompt))]
        out = self.drain()
        return np.stack([out[rid] for rid in rids])

    def reset(self) -> None:
        """Return an idle engine to its post-construction state: empty
        queue, empty prefix cache, zeroed counters, metrics and trace (the
        registry's instruments are zeroed in place). Stale arena K/V stays:
        every allocation path scrubs the blocks it takes over (the whole
        scattered working tree unchunked, ``invalidate_blocks`` chunked)
        before their positions can enter a mask."""
        if self.scheduler is not None and self.scheduler.pending():
            raise RuntimeError("reset() requires an idle engine")
        self.scheduler = RequestScheduler(self.n_slots)
        self._prefill_groups: collections.deque = collections.deque()
        self.prefix_cache: Optional[RadixPrefixCache] = None
        if self.block_mode:
            self.prefix_cache = RadixPrefixCache(
                BlockPool(self.cache.n_blocks, self.cache.block_size))
            self.scheduler.on_release = self._release_slot
            self.scheduler.admission_priority = self._hit_score
            self._slot_meta: Dict[int, dict] = {}
            for slot in range(self.n_slots):
                self.cache.clear_table(slot)
        self._stat_prefill_tokens = 0
        self._stat_saved_tokens = 0
        self._stat_chunk_steps = 0
        self.n_prefill_calls = 0
        self.n_chunk_calls = 0
        self.n_mixed_steps = 0
        self.n_decode_steps = 0
        self.n_draft_steps = 0
        self.n_verify_steps = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.metrics_registry.reset()
        self.tracer.reset()
        self._step_no = 0

    def model_calls(self) -> int:
        """Every model call so far (each runs every GEMM once)."""
        return (self.n_prefill_calls + self.n_chunk_calls + self.n_mixed_steps
                + self.n_decode_steps + self.n_draft_steps
                + self.n_verify_steps)

    def arena_calls(self) -> int:
        """Model calls whose attention reads the block arena through the
        tables (the paged kernel's calls with ``use_paged_kernel``)."""
        if not self.block_mode:
            return 0
        return (self.n_mixed_steps + self.n_decode_steps + self.n_draft_steps
                + self.n_verify_steps)

    # -- observability ---------------------------------------------------

    def _phase(self, hist: str, span: str):
        """Phase timing context: one clock pair feeds the ``hist``
        histogram and (tracer enabled) a named span in the trace ring,
        nested under the enclosing ``step`` span by containment."""
        if self.tracer.enabled:
            return self.tracer.span_timer(
                span, self.metrics_registry.histogram(hist))
        return self.metrics_registry.timer(hist)

    def _device_sync(self, logits: torch.Tensor) -> None:
        """With metrics on, wait for the device to finish ``logits`` under
        ``step.device_sync_s``, so that the dispatch phase before it times
        the launches and ``sample_host`` the host's sampling (the logits
        are read right after either way). Nothing to wait for on the CPU."""
        if not self.metrics_registry.enabled:
            return
        with self._phase("step.device_sync_s", "device_sync"):
            if logits.device.type == "cuda":
                torch.cuda.synchronize(logits.device)

    def _record_cost(self, cost) -> None:
        """Count one model call and record its predicted cost: global and
        per-kind ``cost.*`` counters, per-kind per-dispatch histograms."""
        m = self.metrics_registry
        m.counter("step.model_dispatches").inc()
        if not m.enabled:
            return
        for field in _COST_FIELDS:
            v = getattr(cost, field)
            m.counter(f"cost.{field}").inc(v)
            m.counter(f"cost.{cost.kind}.{field}").inc(v)
            m.histogram(f"cost.{cost.kind}.{field}",
                        _COST_EDGES).observe(v)
        if cost.gathered_bytes:
            m.counter("cost.gathered_bytes").inc(cost.gathered_bytes)

    def metrics(self) -> Dict[str, Any]:
        """One observability snapshot, keyed as the reference's: engine
        phase timers and counters, scheduler gauges, prefix-cache and
        block-pool stats, and trace-ring health. ``prefix_stats()`` is a
        view of the ``prefix_cache`` section."""
        snap = self.metrics_registry.snapshot()
        out: Dict[str, Any] = {
            "engine": {"n_slots": self.n_slots, "max_len": self.max_len,
                       "prefill_chunk": self.prefill_chunk,
                       "paged_impl": self.paged_impl,
                       "chunk_backlog_depth": len(self._prefill_groups),
                       "phases": snap["histograms"],
                       "counters": snap["counters"],
                       "gauges": snap["gauges"],
                       "cost_model": self.cost_model.summary()},
            "scheduler": self.scheduler.gauges(),
            "prefix_cache": self.prefix_stats(),
            "trace": {"events": len(self.tracer),
                      "dropped": self.tracer.dropped,
                      "capacity": self.tracer.capacity,
                      "spans": len(self.tracer.spans()),
                      "dropped_spans": self.tracer.dropped_spans},
        }
        if self.prefix_cache is not None:
            out["block_pool"] = self.prefix_cache.pool.occupancy()
        return out

    def prefix_stats(self) -> Dict[str, Any]:
        """Prefix-cache health: hit rate, tokens saved vs computed, block
        commits and evictions, arena occupancy; the same dict as
        ``metrics()["prefix_cache"]``."""
        if self.prefix_cache is None:
            return {"enabled": False,
                    "prefill_tokens": self._stat_prefill_tokens,
                    "saved_tokens": 0, "prefill_chunk": None,
                    "prefill_chunk_steps": 0}
        out = self.prefix_cache.stats()
        out.update(enabled=True, block_size=self.cache.block_size,
                   prefill_tokens=self._stat_prefill_tokens,
                   saved_tokens=self._stat_saved_tokens,
                   hit_tokens=self._stat_saved_tokens,
                   prefill_chunk=self.prefill_chunk,
                   prefill_chunk_steps=self._stat_chunk_steps)
        return out

    # -- internals ------------------------------------------------------

    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device)

    def _hit_score(self, req) -> int:
        """Cache-aware admission: expected cached-prefix tokens (0 for a
        request with extra inputs, which never shares prefixes)."""
        if req.extra:
            return 0
        bs = self.cache.block_size
        return bs * self.prefix_cache.peek_blocks(
            req.prompt, max_blocks=(len(req.prompt) - 1) // bs)

    def _bucket(self, s: int, prefix_len: int) -> int:
        """Pad a (suffix) prefill length up to a power-of-two bucket,
        clamped to the cache capacity past the prefix."""
        if not self.bucket_prompts:
            return s
        cap = (self.cache.eff_len if self.block_mode
               else self.max_len) - prefix_len
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
            # logits seed generation; K/V computed beside extra inputs
            # (patches) is never shared
            matched = ([] if req.extra else self.prefix_cache.match(
                req.prompt, max_blocks=(s0 - 1) // bs))
            pool.incref(matched)
            own = need - len(matched)
            if pool.n_free() < own:
                self.prefix_cache.evict(own - pool.n_free())
            ids = pool.alloc(own)
            if ids is None:
                self.prefix_cache.release(matched)
                failed.append(slot)
                self.tracer.event(tr.UNADMIT, req.rid, slot=slot,
                                  blocks_needed=own,
                                  blocks_free=pool.n_free())
                continue
            if not req.extra:
                self.prefix_cache.count_lookup(matched)
            if matched:
                self.tracer.event(tr.PREFIX_HIT, req.rid, slot=slot,
                                  blocks=len(matched),
                                  tokens=len(matched) * bs)
            pool.incref(ids)
            if self.prefill_chunk is None:
                self.cache.set_table(slot, matched + ids)
            # chunked: the table stays on the trash block until the last
            # chunk lands, so a PREFILLING slot's dummy decode row cannot
            # write into (possibly shared) live blocks
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
        into the trie (unless it carried extra inputs), drop its block
        references, and park the slot's table on the trash block."""
        meta = self._slot_meta.pop(slot, None)
        if meta is None:
            return
        if not st.req.extra:
            # cache rows hold K/V for prompt + every fed-back token (the
            # final sampled token never re-enters the model)
            seq = np.concatenate([st.req.prompt,
                                  np.asarray(st.tokens[:-1], np.int32)])
            n_commit = min(len(seq) // self.cache.block_size, meta["need"])
            self.prefix_cache.commit(
                seq, self.cache.block_tables[slot, :n_commit].tolist())
        self.prefix_cache.release(meta["matched"] + meta["owned"])
        self.cache.clear_table(slot)

    def _prefill_admitted(self, admitted) -> None:
        if self.block_mode:
            with self._phase("step.prefix_match_s", "prefix_match"):
                admitted = self._assign_blocks(admitted)
            if self.prefill_chunk is not None:
                with self._phase("step.chunk_advance_s", "chunk_advance"):
                    self._stage_chunked(admitted)
                return
        with self._phase("step.prefill_dispatch_s", "prefill_dispatch"):
            self._run_prefill(admitted)

    def _batch(self, toks: np.ndarray, extras) -> Dict[str, torch.Tensor]:
        """A prefill launch's batch: the tokens, and each extra input
        stacked over the group's rows (``extras``: one dict or None a
        row, all of one signature)."""
        batch = {"tokens": self._dev(toks).long()}
        if extras[0]:
            for k in extras[0]:
                batch[k] = torch.stack([torch.as_tensor(ex[k])
                                        for ex in extras]).to(self.device)
        return batch

    def _run_prefill(self, admitted) -> None:
        # one batched prefill per (prefix length, bucketed suffix length,
        # extra-input signature)
        groups: Dict[Any, list] = {}
        bs = self.cache.block_size
        for slot, st in admitted:
            p_len = (self._slot_meta[slot]["prefix_blocks"] * bs
                     if self.block_mode else 0)
            s_real = len(st.req.prompt) - p_len
            groups.setdefault((p_len, self._bucket(s_real, p_len),
                               _extra_sig(st.req.extra)),
                              []).append((slot, st))
        for (p_len, s_pad, _), group in groups.items():
            g = len(group)
            toks = np.zeros((g, s_pad), np.int32)
            lasts = np.empty(g, np.int64)
            for i, (_, st) in enumerate(group):
                sfx = st.req.prompt[p_len:]
                toks[i, :len(sfx)] = sfx
                lasts[i] = len(sfx) - 1
            batch = self._batch(toks, [st.req.extra for _, st in group])
            last_idx = self._dev(lasts)
            self._stat_prefill_tokens += int(lasts.sum()) + g
            self.n_prefill_calls += 1
            self._record_cost(self.cost_model.prefill(g, s_pad))
            if self.block_mode:
                meta = [self._slot_meta[slot] for slot, _ in group]
                cache = self.cache.prefix_tree([m["matched"] for m in meta],
                                               p_len)
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
            else:
                cache = self.cache.fresh(g)
                logits, cache = self.model.prefill_bucketed(
                    self.params, batch, cache, last_idx)
                cache = self.cache.mask_pos_tail(
                    cache, [len(st.req.prompt) for _, st in group])
                self.cache.write_slots(cache, [slot for slot, _ in group])
            first = _sample(logits, [st.req.key for _, st in group],
                            np.zeros(g, np.int32),
                            [st.req.temperature for _, st in group])
            for (slot, st), tok in zip(group, first):
                self.tracer.event(tr.FIRST_TOKEN, st.req.rid, slot=slot)
                self.scheduler.record_prefill(slot, tok)

    def _stage_chunked(self, admitted) -> None:
        """Stage admitted requests as chunk-prefill groups (no model work
        yet: ``_advance_chunk`` or ``_mixed_once`` runs one chunk per
        step). Grouped by (prefix length, chunk count, bucketed final-chunk
        length, extra-input signature), so every row of a group advances
        in lockstep; every chunk of a group with extra inputs carries
        them."""
        chunk = self.prefill_chunk
        bs = self.cache.block_size
        groups: Dict[Any, list] = {}
        for slot, st in admitted:
            p_len = self._slot_meta[slot]["prefix_blocks"] * bs
            s_real = len(st.req.prompt) - p_len
            n_chunks = -(-s_real // chunk)
            tail = self._bucket(s_real - (n_chunks - 1) * chunk,
                                p_len + (n_chunks - 1) * chunk)
            groups.setdefault((p_len, n_chunks, tail,
                               _extra_sig(st.req.extra)),
                              []).append((slot, st))
        for (p_len, n_chunks, tail, sig), members in groups.items():
            g = len(members)
            s_pad = (n_chunks - 1) * chunk + tail
            toks = np.zeros((g, s_pad), np.int32)
            lasts = np.empty(g, np.int64)
            metas = []
            for i, (slot, st) in enumerate(members):
                meta = self._slot_meta[slot]
                metas.append(meta)
                sfx = st.req.prompt[p_len:]
                toks[i, :len(sfx)] = sfx
                lasts[i] = len(sfx) - (n_chunks - 1) * chunk - 1
            # owned blocks commit chunk by chunk, so their stale positions
            # are scrubbed up front: the tail not reached yet must never
            # enter an attention mask
            self.cache.invalidate_blocks(
                [b for m in metas for b in m["owned"]])
            grp = {"members": members, "metas": metas, "toks": toks,
                   "lasts": lasts, "p_len": p_len, "n_chunks": n_chunks,
                   "tail": tail, "done": 0, "tree": None,
                   "extra": [st.req.extra for _, st in members]}
            if self.fused_step and sig is None:
                # each chunk commits straight into the arena through the
                # group's own tables inside the mixed launch (a group with
                # extra inputs takes the separate path: a mixed batch
                # carries no per-row side inputs)
                grp["fused"] = True
                grp["tables"] = self.cache.group_tables(
                    [m["matched"] + m["owned"] for m in metas])
            else:
                # the working tree holds the committed rows and the padded
                # suffix, rounded up to a power of two (then whole blocks)
                need = p_len + s_pad
                length = -(-(1 << max(need - 1, 0).bit_length()) // bs) * bs
                length = min(self.cache.eff_len, max(length, bs))
                grp["tree"] = self.cache.prefix_tree(
                    [m["matched"] for m in metas], p_len, length=length)
                grp["tree_len"] = length  # the chunk's attended positions
            self._prefill_groups.append(grp)

    def _finish_group(self, grp, first) -> None:
        """The group's last chunk has landed: its slots' tables go live and
        each samples ``first`` as its first token."""
        for i, (slot, st) in enumerate(grp["members"]):
            meta = grp["metas"][i]
            self.cache.set_table(slot, meta["matched"] + meta["owned"])
            self._stat_prefill_tokens += len(st.req.prompt) - grp["p_len"]
            self.tracer.event(tr.FIRST_TOKEN, st.req.rid, slot=slot)
            self.scheduler.record_prefill(slot, int(first[i]))

    def _advance_chunk(self) -> None:
        """Run one chunk of prefill for the head group (round-robin across
        groups): prefill the chunk at the group's committed offset, attend
        over everything committed so far, and scatter the chunk's blocks
        into the arena. On the last chunk, sample each row's first token
        and let its slot's table go live."""
        grp = self._prefill_groups[0]
        chunk = self.prefill_chunk
        bs = self.cache.block_size
        k = grp["done"]
        final = k == grp["n_chunks"] - 1
        s_chunk = grp["tail"] if final else chunk
        lo = k * chunk
        g = len(grp["members"])
        batch = self._batch(grp["toks"][:, lo:lo + s_chunk], grp["extra"])
        last_idx = self._dev(grp["lasts"] if final
                             else np.full(g, s_chunk - 1, np.int64))
        committed = grp["p_len"] + lo
        self._stat_chunk_steps += 1
        self.n_chunk_calls += 1
        self._record_cost(self.cost_model.chunk(g, s_chunk, grp["tree_len"]))
        if committed == 0:
            # first chunk of an uncached prompt: it attends over its own
            # K/V like a whole-prompt prefill
            logits, tree = self.model.prefill_bucketed(
                self.params, batch, grp["tree"], last_idx)
        else:
            logits, tree = self.model.prefill_chunk(
                self.params, batch, grp["tree"], committed, last_idx)
        grp["tree"] = tree
        grp["done"] = k + 1
        b0 = lo // bs  # this chunk's first logical block past the prefix
        for i, (slot, st) in enumerate(grp["members"]):
            meta = grp["metas"][i]
            n_valid = min(len(st.req.prompt) - grp["p_len"] - lo, s_chunk)
            nb = -(-n_valid // bs)
            self.cache.scatter_row(tree, i, meta["owned"][b0:b0 + nb],
                                   meta["prefix_blocks"] + b0, n_valid)
            self.tracer.event(tr.PREFILL_CHUNK, st.req.rid, slot=slot,
                              index=k, n_chunks=grp["n_chunks"],
                              tokens=int(n_valid))
        if not final:
            # a short group admitted behind a long prefill gets the next step
            self._prefill_groups.rotate(-1)
            return
        self._prefill_groups.popleft()
        self._finish_group(grp, _sample(
            logits, [st.req.key for _, st in grp["members"]],
            np.zeros(g, np.int32),
            [st.req.temperature for _, st in grp["members"]]))

    def _mixed_once(self) -> None:
        """The head fused chunk group AND the whole decode batch in one
        ``mixed_step`` launch. Rows [0, n_slots) are the per-slot decode
        rows (``q_lens`` 1 for DECODING slots, 0 otherwise); rows
        [n_slots, n_slots + g) carry the group's chunk through the group's
        tables. Every row commits its valid K/V inside the launch; invalid
        tokens go to the trash block."""
        grp = self._prefill_groups[0]
        chunk = self.prefill_chunk
        k = grp["done"]
        final = k == grp["n_chunks"] - 1
        s_chunk = grp["tail"] if final else chunk
        lo = k * chunk
        g = len(grp["members"])
        n = self.n_slots
        toks, idxs, steps, temps, keys = self.scheduler.decode_batch(
            self._dummy_key)
        decoding = self.scheduler.decoding_slots()
        live = self._live(decoding, steps)
        btoks = np.zeros((n + g, s_chunk), np.int32)
        btoks[:n, 0] = toks
        btoks[n:] = grp["toks"][:, lo:lo + s_chunk]
        q_lens = np.zeros(n + g, np.int32)
        q_lens[decoding] = 1
        start = np.zeros(n + g, np.int32)
        start[:n] = idxs
        start[n:] = grp["p_len"] + lo
        last_idx = np.zeros(n + g, np.int64)
        last_idx[n:] = grp["lasts"] if final else s_chunk - 1
        for i, (_, st) in enumerate(grp["members"]):
            q_lens[n + i] = min(len(st.req.prompt) - grp["p_len"] - lo,
                                s_chunk)
        tables = np.concatenate([self.cache.block_tables, grp["tables"]])
        self._stat_chunk_steps += 1
        self.n_mixed_steps += 1
        self._record_cost(self.cost_model.mixed(n + g, s_chunk))
        with self._phase("step.mixed_dispatch_s", "mixed_dispatch"):
            logits, self.cache.tree = self.model.mixed_step(
                self.params, {"tokens": self._dev(btoks).long()},
                self.cache.tree, start, q_lens, self._dev(last_idx),
                self._dev(tables), paged=self.paged)
        self._device_sync(logits)
        members = [st for _, st in grp["members"]]
        with self._phase("step.sample_host_s", "sample_host"):
            nxt = _sample(logits, list(keys) + [st.req.key for st in members],
                          np.concatenate([steps, np.zeros(g, np.int32)]),
                          np.concatenate([temps, np.asarray(
                              [st.req.temperature for st in members],
                              np.float32)]))
            self.scheduler.record_decode(nxt[:n])
        for slot, rid, step in live:
            self.tracer.event(tr.DECODE_STEP, rid, slot=slot, step=step)
        for i, (slot, st) in enumerate(grp["members"]):
            self.tracer.event(tr.PREFILL_CHUNK, st.req.rid, slot=slot,
                              index=k, n_chunks=grp["n_chunks"],
                              tokens=int(q_lens[n + i]))
        grp["done"] = k + 1
        if not final:
            self._prefill_groups.rotate(-1)
            return
        self._prefill_groups.popleft()
        self._finish_group(grp, nxt[n:])

    def _live(self, decoding, steps):
        """(slot, rid, step) of the DECODING rows, for their trace events:
        taken before ``record_decode`` frees the slots that finish."""
        if not self.tracer.enabled:
            return []
        return [(s, self.scheduler.slots[s].req.rid, int(steps[s]))
                for s in decoding]

    def _decode_once(self) -> None:
        toks, idxs, steps, temps, keys = self.scheduler.decode_batch(
            self._dummy_key)
        live = self._live(self.scheduler.decoding_slots(), steps)
        self.n_decode_steps += 1
        self._record_cost(self.cost_model.decode(self.n_slots))
        tables = self.cache.tables_device() if self.block_mode else None
        with self._phase("step.decode_dispatch_s", "decode_dispatch"):
            logits, self.cache.tree = self.model.decode_step(
                self.params, self._dev(toks).long()[:, None], self.cache.tree,
                self._dev(idxs), tables, paged=self.paged)
        self._device_sync(logits)
        with self._phase("step.sample_host_s", "sample_host"):
            self.scheduler.record_decode(_sample(logits, keys, steps, temps))
        for slot, rid, step in live:
            self.tracer.event(tr.DECODE_STEP, rid, slot=slot, step=step)

    def _spec_once(self) -> None:
        """One self-speculative round over the DECODING slots.

        Draft: ``k_max`` one-token launches of the truncated-slice draft
        model, each sampling with the same (key, step) the verify targets
        use; a row drafts up to ``min(spec_k, remaining - 1)`` tokens and
        then sits out with ``q_lens`` 0. Verify: one full-precision
        ``verify_step`` feeds ``[t0, d1..dk]`` per row, rewriting every
        draft-fed position; row r accepts drafts while they equal the
        targets and always emits at least the first target, the token
        plain decode would have produced.
        """
        toks, idxs, steps, temps, keys = self.scheduler.decode_batch(
            self._dummy_key)
        decoding = self.scheduler.decoding_slots()
        n = self.n_slots
        k_rows = np.zeros(n, np.int32)
        for s in decoding:
            st = self.scheduler.slots[s]
            k_rows[s] = min(self.spec_k, st.req.n_tokens - st.n_gen - 1)
        k_max = int(k_rows.max(initial=0))
        if k_max == 0:
            # every live row is one token from its budget: plain decode
            self._decode_once()
            return
        m = self.metrics_registry
        live = self._live(decoding, steps)
        tables = self.cache.tables_device()
        zeros = np.zeros(n, np.int64)
        draft_toks = np.zeros((n, k_max), np.int32)
        cur = toks
        m.counter("spec.steps").inc()
        with self._phase("spec.draft_s", "spec_draft"):
            for j in range(k_max):
                self.n_draft_steps += 1
                self._record_cost(self.cost_model.draft(
                    n, keep_slices=self.config.draft_slices))
                logits, self.cache.tree = self.draft_model.mixed_step(
                    self.params, {"tokens": self._dev(cur).long()[:, None]},
                    self.cache.tree, idxs + j, (k_rows > j).astype(np.int32),
                    self._dev(zeros), tables, paged=self.paged)
                cur = _sample(logits, keys, steps + j, temps)
                draft_toks[:, j] = cur
        s_v = k_max + 1
        btoks = np.zeros((n, s_v), np.int32)
        btoks[:, 0] = toks
        btoks[:, 1:] = draft_toks
        q_lens = np.zeros(n, np.int32)
        q_lens[decoding] = k_rows[decoding] + 1
        self.n_verify_steps += 1
        self._record_cost(self.cost_model.verify(n, s_v))
        with self._phase("spec.verify_s", "spec_verify"):
            logits, self.cache.tree = self.model.verify_step(
                self.params, {"tokens": self._dev(btoks).long()},
                self.cache.tree, idxs, q_lens, tables, paged=self.paged)
        self._device_sync(logits)
        with self._phase("step.sample_host_s", "sample_host"):
            # entry (r, j) draws with (keys[r], steps[r] + j): exactly the
            # (key, step) plain decode would use for that token
            targets = _sample(
                logits.reshape(n * s_v, -1),
                [k for k in keys for _ in range(s_v)],
                (steps[:, None]
                 + np.arange(s_v, dtype=np.int32)[None]).reshape(-1),
                np.repeat(temps, s_v)).reshape(n, s_v)
        accepted: Dict[int, np.ndarray] = {}
        for s in decoding:
            a = 0
            while a < k_rows[s] and draft_toks[s, a] == targets[s, a]:
                a += 1
            accepted[s] = targets[s, :a + 1]
        proposed = int(k_rows.sum())
        n_accepted = sum(len(v) - 1 for v in accepted.values())
        self.spec_proposed += proposed
        self.spec_accepted += n_accepted
        m.counter("spec.proposed").inc(proposed)
        m.counter("spec.accepted").inc(n_accepted)
        m.counter("spec.tokens").inc(sum(len(v) for v in accepted.values()))
        self.scheduler.record_spec(accepted)
        for slot, rid, step in live:
            got = len(accepted[slot])
            self.tracer.event(tr.SPEC_ACCEPT, rid, slot=slot,
                              proposed=int(k_rows[slot]),
                              accepted=got - 1, tokens=got)
            for j in range(got):
                self.tracer.event(tr.DECODE_STEP, rid, slot=slot,
                                  step=step + j)


@dataclasses.dataclass
class DecodeEngine:
    """Static-batch decode: prefill plus lockstep decode over a contiguous
    ring cache, a fresh cache per ``generate`` call. The parity oracle the
    continuous engine is held against; runs on ``device`` (the card unless
    the caller asks for the CPU)."""

    cfg: ArchConfig
    params: Any
    max_len: int = 256
    batch: int = 1
    packed: bool = False
    quant_cfg: Optional[QuantConfig] = None
    cache_dtype: Any = torch.float32
    device: Any = "cuda"

    def __post_init__(self):
        require_decoder(self.cfg)
        self.device = _device.resolve(self.device)
        params = pp.tree_map(lambda a: a.to(self.device), self.params)
        self.cfg, self.params, self.pack_stats = _maybe_pack(
            self.cfg, params, self.packed, self.quant_cfg)
        self.model = Model(self.cfg)

    def new_cache(self):
        tree = self.model.build_cache(self.batch, self.max_len,
                                      self.cache_dtype)
        return pp.init_params(tree, None, device=self.device)

    def generate(self, prompt: np.ndarray, n_tokens: int,
                 extra: Optional[Dict[str, Any]] = None,
                 temperature: float = 0.0, seed: int = 0) -> np.ndarray:
        """prompt: (B, S0) int32. Returns (B, S0 + n_tokens). ``extra``
        ({name: (B, ...)}) joins the prefill's batch only."""
        prompt = np.asarray(prompt, np.int32)
        b, s0 = prompt.shape
        if b != self.batch or s0 + n_tokens > self.max_len:
            raise ValueError(f"prompt {prompt.shape} + {n_tokens} tokens does "
                             f"not fit batch {self.batch}, max_len "
                             f"{self.max_len}")
        cache = self.new_cache()
        batch = {"tokens": torch.as_tensor(prompt).long().to(self.device)}
        if extra:
            batch.update({k: torch.as_tensor(v).to(self.device)
                          for k, v in extra.items()})
        logits, cache = self.model.prefill(self.params, batch, cache)
        keys = prng.fold_in(prng.key(seed).expand(b, 2), torch.arange(b))
        temps = np.full(b, temperature, np.float32)
        out = [prompt]
        tok = self._sample(logits, keys, temps, 0)
        for i in range(n_tokens):
            out.append(tok)
            if i == n_tokens - 1:
                break
            logits, cache = self.model.decode_step(
                self.params, torch.as_tensor(tok).long().to(self.device),
                cache, s0 + i)
            tok = self._sample(logits, keys, temps, i + 1)
        return np.concatenate(out, axis=1)

    @staticmethod
    def _sample(logits, keys, temps, i) -> np.ndarray:
        steps = np.full(logits.shape[0], i, np.int32)
        return sample_step(logits, keys, steps, temps).cpu().numpy()[:, None]
