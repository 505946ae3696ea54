"""Fault-tolerant training loop (PyTorch port of ``repro.train.loop``).

Responsibilities:
  * run the train step on the card unless ``device="cpu"``, on one device
    or, with ``mesh`` (a ``DeviceMesh`` with axes ('data', 'model') over
    the initialized process group), sharded: the state's leaves are
    ``DTensor``s in :meth:`Trainer.state_shardings`' placements, each
    batch is split over ``batch``, and the step runs under the rules,
  * checkpoint every ``ckpt_every`` steps (async), storing the data
    cursor, so a restart resumes bit-exactly,
  * restart semantics: a ``Trainer`` whose ``workdir`` holds checkpoints
    picks up the newest one (elastic: the restore distributes the whole
    arrays onto the current mesh, whatever mesh saved them),
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

import contextlib
import dataclasses
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch import device as _device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import distribute
from repro_torch.configs.base import ArchConfig
from repro_torch.core.selection import PASSES
from repro_torch.data import SyntheticPipeline
from repro_torch.data.pipeline import to_device
from repro_torch.models import params as pp
from repro_torch.models.model import Model
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.parallel import ctx as par_ctx
from repro_torch.parallel.sharding import Rules
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
        self.device = _device.resolve(self.device)
        if self.mesh is not None and \
                self.mesh.device_type != self.device.type:
            raise ValueError(f"mesh on {self.mesh.device_type}, trainer on "
                             f"{self.device.type}")
        self.model = Model(self.cfg)
        self.pipeline = SyntheticPipeline(self.cfg, self.seq_len,
                                          self.global_batch, seed=self.seed)
        self.optimizer = AdamW()
        self.lr_fn = warmup_cosine(self.peak_lr, self.warmup, self.total_steps)
        self.ckpt = (CheckpointManager(self.workdir, keep=self.keep)
                     if self.workdir else None)
        self.straggler_events = 0
        self.records: List[Dict[str, Any]] = []
        self.rules = (Rules.for_arch(self.mesh, self.cfg)
                      if self.mesh is not None else None)

    def state_shardings(self) -> TrainState:
        """Placements of the state: params with ``fsdp_params``, the
        moments with ``fsdp_opt``."""
        tree = self.model.build()
        cfgp = self.cfg.parallel
        pspec = self.rules.param_shardings(tree, fsdp=cfgp.fsdp_params)
        ospec = self.rules.param_shardings(tree, fsdp=cfgp.fsdp_opt)
        return TrainState(step=self.rules.replicated(), params=pspec,
                          opt={"m": ospec, "v": ospec})

    def _placed(self) -> TrainState:
        """:meth:`state_shardings` as (mesh, placements) leaves, the step
        left whole."""
        sh = self.state_shardings()
        return TrainState(step=None, params=pp.tree_map(
            lambda pl: (self.mesh, pl), sh.params), opt={
            k: pp.tree_map(lambda pl: (self.mesh, pl), v)
            for k, v in sh.opt.items()})

    def init_or_restore(self) -> tuple[TrainState, int]:
        tree = self.model.build()
        if self.ckpt is not None and self.ckpt.latest_step() is not None:
            template = TrainState(step=None, params=tree,
                                  opt={"m": tree, "v": tree})
            state, meta = self.ckpt.restore(
                template, device=self.device,
                shardings=self._placed() if self.rules is not None else None)
            return state, int(meta["step"])
        if self.init_params is not None:
            params = pp.tree_map(lambda a: a.to(self.device),
                                 self.init_params)
        else:
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
            params = pp.init_params(tree, gen, device=self.device)
        state = init_state(params)
        if self.rules is not None:
            # the same whole tensors on every rank (one seed)
            state = distribute(state, self._placed())
        return state, 0

    def _batch(self, step: int):
        batch = to_device(self.pipeline.batch_at(step), self.device)
        if self.rules is None:
            return batch
        from torch.distributed.tensor import distribute_tensor

        sh = self.rules.batch_shardings(batch)
        return {k: distribute_tensor(v, self.mesh, sh[k], src_data_rank=None)
                for k, v in batch.items()}

    def run(self, n_steps: Optional[int] = None) -> Dict[str, Any]:
        n_steps = n_steps or self.total_steps
        state, start = self.init_or_restore()
        compute = None
        if self.rules is not None and self.cfg.parallel.fsdp_params:
            # the compute copy on the TP-only placements: ZeRO-3 gathers
            compute = self.rules.param_shardings(self.model.build())
        step_fn = make_train_step(self.model, self.optimizer, self.lr_fn,
                                  compute_shardings=compute)
        cuda = self.device.type == "cuda"
        tokens = self.global_batch * self.seq_len
        history = []
        rules = (par_ctx.use_rules(self.rules) if self.rules is not None
                 else contextlib.nullcontext())
        try:
            with rules:
                self._steps(state, start, n_steps, step_fn, cuda, tokens,
                            history)
        finally:
            if self.ckpt is not None:
                self.ckpt.wait()
                if self.rules is not None:
                    torch.distributed.barrier()
        return {"first_loss": history[0] if history else float("nan"),
                "last_loss": history[-1] if history else float("nan"),
                "losses": history, "state": self.state,
                "straggler_events": self.straggler_events,
                "records": self.records}

    def _steps(self, state, start, n_steps, step_fn, cuda, tokens, history):
        self.state = state
        for step in range(start, n_steps):
            if step == self.fail_at_step:
                raise SimulatedFailure(f"injected failure at step {step}")
            passes = dict(PASSES)
            timer = StepTimer(self.device)
            t0 = time.monotonic()
            batch = self._batch(step)
            state, metrics = step_fn(state, batch, timer)
            self.state = state
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
