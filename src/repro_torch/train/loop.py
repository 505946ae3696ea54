"""Fault-tolerant training loop (PyTorch port of ``repro.train.loop``).

Responsibilities:
  * run the train step on one device (the card unless ``device="cpu"``),
  * checkpoint every ``ckpt_every`` steps (async), storing the data
    cursor, so a restart resumes bit-exactly,
  * restart semantics: a ``Trainer`` whose ``workdir`` holds checkpoints
    picks up the newest one,
  * failure injection (``fail_at_step``) used by the fault-tolerance tests,
  * straggler hook: a per-step deadline; overruns are counted.

A resumed run repeats the first run's steps bit for bit on the card too:
every operation of the step is deterministic there, the embedding
gather's backward included (``models.layers._Gather`` sums each token's
rows in a fixed order, where the card's own indexing backward
accumulates with atomics).

Each step's record (``Trainer.records``) holds its loss, wall ms, the ms
of its parts (``train.steps.StepTimer``: device time between CUDA events
on the card, the host clock on the CPU), tokens/s, the QAT selection's
passes and, on the card, the peak memory allocated so far.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch import device as _device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.core.selection import PASSES
from repro_torch.data import SyntheticPipeline
from repro_torch.data.pipeline import to_device
from repro_torch.models import params as pp
from repro_torch.models.model import Model
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.train.steps import (StepTimer, TrainState, init_state,
                                     make_train_step)


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class Trainer:
    cfg: ArchConfig
    seq_len: int = 128
    global_batch: int = 8
    workdir: Optional[str] = None
    peak_lr: float = 3e-3
    warmup: int = 20
    total_steps: int = 200
    ckpt_every: int = 0
    keep: int = 3
    seed: int = 0
    mesh: Any = None
    step_deadline_s: float = 0.0  # 0 => no deadline
    fail_at_step: int = -1  # inject a crash (tests)
    init_params: Any = None  # warm-start params (e.g. QAT retraining)
    device: Any = "cuda"

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "Trainer(mesh=...): sharded training waits for the port of "
                "parallel/ and launch/mesh.py (ROADMAP queue 1, item 3)")
        self.device = _device.resolve(self.device)
        self.model = Model(self.cfg)
        self.pipeline = SyntheticPipeline(self.cfg, self.seq_len,
                                          self.global_batch, seed=self.seed)
        self.optimizer = AdamW()
        self.lr_fn = warmup_cosine(self.peak_lr, self.warmup, self.total_steps)
        self.ckpt = (CheckpointManager(self.workdir, keep=self.keep)
                     if self.workdir else None)
        self.straggler_events = 0
        self.records: List[Dict[str, Any]] = []

    def init_or_restore(self) -> tuple[TrainState, int]:
        tree = self.model.build()
        if self.ckpt is not None and self.ckpt.latest_step() is not None:
            template = TrainState(step=None, params=tree,
                                  opt={"m": tree, "v": tree})
            state, meta = self.ckpt.restore(template, device=self.device)
            return state, int(meta["step"])
        if self.init_params is not None:
            params = pp.tree_map(lambda a: a.to(self.device),
                                 self.init_params)
        else:
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
            params = pp.init_params(tree, gen, device=self.device)
        return init_state(params), 0

    def run(self, n_steps: Optional[int] = None) -> Dict[str, Any]:
        n_steps = n_steps or self.total_steps
        state, start = self.init_or_restore()
        step_fn = make_train_step(self.model, self.optimizer, self.lr_fn)
        cuda = self.device.type == "cuda"
        tokens = self.global_batch * self.seq_len
        history = []
        try:
            for step in range(start, n_steps):
                if step == self.fail_at_step:
                    raise SimulatedFailure(f"injected failure at step {step}")
                passes = dict(PASSES)
                timer = StepTimer(self.device)
                t0 = time.monotonic()
                batch = to_device(self.pipeline.batch_at(step), self.device)
                state, metrics = step_fn(state, batch, timer)
                history.append(float(metrics["loss"]))  # waits for the step
                dt = time.monotonic() - t0
                if self.step_deadline_s and dt > self.step_deadline_s:
                    self.straggler_events += 1
                rec = {"step": step + 1, "loss": history[-1],
                       "wall_ms": dt * 1e3, "part_ms": timer.ms(),
                       "clock": "device" if cuda else "host",
                       "tokens_per_s": tokens / dt,
                       "selection_passes": PASSES["calls"] - passes["calls"],
                       "selection_combos": PASSES["combos"] - passes["combos"]}
                if cuda:
                    rec["peak_gb"] = torch.cuda.max_memory_allocated(
                        self.device) / 1e9
                self.records.append(rec)
                if (self.ckpt is not None and self.ckpt_every
                        and (step + 1) % self.ckpt_every == 0):
                    self.ckpt.save(step + 1, state,
                                   meta={"data": self.pipeline.state(step + 1),
                                         "loss": history[-1]},
                                   blocking=False)
        finally:
            if self.ckpt is not None:
                self.ckpt.wait()
        return {"first_loss": history[0] if history else float("nan"),
                "last_loss": history[-1] if history else float("nan"),
                "losses": history, "state": state,
                "straggler_events": self.straggler_events,
                "records": self.records}
