"""Deterministic, shardable, checkpointable synthetic data pipeline (the
port's own numpy copy of ``repro.data.pipeline``: the same seed gives the
same batches in both packages).

``batch_at(step)`` is a pure function of (seed, step), which gives the
three properties large-scale training needs for free:

* restart determinism — resuming from a checkpoint replays the exact stream
  (the checkpoint stores only the step cursor),
* host sharding — each data-parallel host slices its rows of the global
  batch without coordination (``host_slice``),
* straggler-safe skipping — a skipped step is just a skipped integer.

The token stream is a per-sequence increment recurrence
``tok[t+1] = (tok[t] + a) mod vocab`` with a small per-sequence stride
``a`` — an induction-style structure a small LM masters quickly, so
quantization-induced accuracy loss is well above the noise floor. Encoder
batches embed the label stream through a fixed random projection; VLM
batches add deterministic patch embeddings. Batches are numpy arrays;
:func:`to_device` makes tensors of them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass
class SyntheticPipeline:
    cfg: ArchConfig
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        b, s, v = self.global_batch, self.seq_len, cfg.vocab
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step]))
        a = rng.integers(1, min(v, 9), (b, 1), dtype=np.int64)
        t0 = rng.integers(0, v, (b, 1), dtype=np.int64)
        toks = np.empty((b, s + 1), np.int64)
        toks[:, 0:1] = t0
        for t in range(s):
            toks[:, t + 1:t + 2] = (toks[:, t:t + 1] + a) % v
        tokens = toks[:, :-1].astype(np.int32)
        labels = toks[:, 1:].astype(np.int32)

        if cfg.family == "encoder":
            # frames = fixed random projection of the label ids (learnable)
            proj_rng = np.random.default_rng(self.seed + 1)
            table = proj_rng.normal(0, 1, (v, cfg.d_model)).astype(np.float32)
            frames = table[labels % v]
            batch = {"frames": frames, "labels": labels}
        else:
            batch = {"tokens": tokens, "labels": labels}
        if cfg.family == "vlm":
            batch["patches"] = rng.normal(
                0, 1, (b, cfg.vlm.n_patches, cfg.vlm.vision_dim)
            ).astype(np.float32)
        return batch

    def host_slice(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        if self.n_hosts == 1:
            return batch
        per = self.global_batch // self.n_hosts
        lo = self.host_id * per
        return {k: v[lo:lo + per] for k, v in batch.items()}

    # checkpointable cursor ------------------------------------------------
    def state(self, step: int) -> dict:
        return {"seed": self.seed, "step": int(step)}

    @staticmethod
    def resume_step(state: dict) -> int:
        return int(state["step"])


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device`` (token ids stay int32)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}
