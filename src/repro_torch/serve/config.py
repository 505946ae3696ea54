"""Typed construction / submission surface for the serve engine (PyTorch
port of ``repro.serve.config``).

The fields keep the reference's names, meaning and defaults, with two
differences: ``cache_dtype`` is a torch dtype, and there is no
``paged_impl`` (the device of the tensors picks the kernel or its plain
version; ``engine.paged_impl`` names the one in use).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core.swis import QuantConfig


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """All :class:`~repro_torch.serve.engine.ContinuousBatchingEngine` knobs.

    Capacity: max_len (per-slot prompt + generated tokens), n_slots.
    Cache: block_size, n_cache_blocks (extra arena blocks; None: two
      slots' worth), cache_dtype, prefix_cache (block arena + radix cache).
    Prefill: prefill_chunk, prefill_backlog, bucket_prompts (pad prefill
      lengths to pow2 buckets), fused_step.
    Kernel: packed (serve SWIS bit-plane weights), quant_cfg (packing
      config; None: the arch's policy), use_paged_kernel (paged attention
      over the arena instead of the gathered K/V).
    Speculative decode: spec_decode, spec_k, draft_slices.
    Observability: enable_metrics (phase timers, counters, the cost model
      and the lifecycle tracer; on by default, as in the reference),
      trace_capacity (trace ring size, events).
    """

    max_len: int = 256
    n_slots: int = 4
    # cache
    block_size: int = 8
    n_cache_blocks: Optional[int] = None
    cache_dtype: Any = torch.float32
    prefix_cache: bool = True
    # prefill
    prefill_chunk: Optional[int] = None
    prefill_backlog: int = 2
    bucket_prompts: bool = True
    fused_step: bool = False
    # kernel
    packed: bool = False
    quant_cfg: Optional[QuantConfig] = None
    use_paged_kernel: bool = False
    # speculative decode
    spec_decode: bool = False
    spec_k: int = 3
    draft_slices: Optional[int] = None
    # observability
    enable_metrics: bool = True
    trace_capacity: int = 65536

    def __post_init__(self):
        for name, floor in (("max_len", 1), ("n_slots", 1),
                            ("block_size", 1), ("prefill_backlog", 1),
                            ("trace_capacity", 1)):
            if getattr(self, name) < floor:
                raise ValueError(f"{name} must be >= {floor}, "
                                 f"got {getattr(self, name)}")
        if self.prefill_chunk is not None and self.prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1 (or None for whole-prompt "
                f"prefill), got {self.prefill_chunk}")
        if self.n_cache_blocks is not None and self.n_cache_blocks < 0:
            raise ValueError(
                f"n_cache_blocks must be >= 0, got {self.n_cache_blocks}")
        if self.prefill_chunk is not None and not self.prefix_cache:
            raise ValueError("prefill_chunk requires the block-mode prefix "
                             "cache (prefix_cache=True)")
        if self.use_paged_kernel and not self.prefix_cache:
            raise ValueError("use_paged_kernel requires the block-mode "
                             "prefix cache (prefix_cache=True)")
        if self.fused_step and self.prefill_chunk is None:
            raise ValueError("fused_step requires prefill_chunk to be set")
        if self.spec_decode and not self.prefix_cache:
            raise ValueError("spec_decode requires the block-mode prefix "
                             "cache (prefix_cache=True)")
        if self.spec_decode and self.spec_k < 1:
            raise ValueError(f"spec_k must be >= 1 when spec_decode is on, "
                             f"got {self.spec_k}")
        if self.draft_slices is not None:
            if not self.spec_decode:
                raise ValueError("draft_slices is set but spec_decode=False")
            if not self.packed:
                raise ValueError("draft_slices requires packed=True")
            if self.draft_slices < 1:
                raise ValueError(
                    f"draft_slices must be >= 1, got {self.draft_slices}")


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling contract for ``submit(prompt, params)``.

    max_tokens — tokens to generate (0 allowed: prefill-only request);
    temperature — 0 greedy; > 0 samples, token-exact with the reference's
      seeded ``jax.random`` draws;
    seed / key — reproducibility handles, mutually exclusive (``key`` is
      the reference's key data: two uint32 words).
    """

    max_tokens: int
    temperature: float = 0.0
    seed: Optional[int] = None
    key: Any = None

    def __post_init__(self):
        if self.max_tokens < 0:
            raise ValueError(
                f"max_tokens must be >= 0, got {self.max_tokens}")
        if self.temperature < 0:
            raise ValueError(
                f"temperature must be >= 0, got {self.temperature}")
        if self.seed is not None and self.key is not None:
            raise ValueError("seed and key are mutually exclusive")
