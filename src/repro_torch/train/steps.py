"""Train / eval steps (PyTorch port of ``repro.train.steps``).

``make_train_step`` builds the full step: (SWIS QAT fake-quant of every
GEMM weight, once a step) -> loss -> grads (with optional gradient
accumulation over microbatches) -> global-norm clip -> optional int8
gradient compression -> AdamW. State transforms are plain functions over
nested dicts, so the same step works for every architecture family.

As in the reference, QAT is hoisted out of the layers: the step
quantizes the fp32 masters once (``core.qat.quantize_tree``) and runs the
model with per-layer quantization off. The gradient with respect to the
quantized weights is the masters' gradient (the STE is the identity), so
the step differentiates the loss with respect to the quantized copy
directly and never traces selection. Every >= 2-D float32 leaf is then
cast to the compute dtype once a step; 1-D leaves (norm scales) stay
float32.

Each step records device time per part on a :class:`StepTimer`
(``"select"``: the QAT fake-quant, ``"fwd_bwd"``: forward and backward,
``"optim"``: clip, compression and AdamW) from CUDA events on the card
and the host clock on the CPU.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.core.qat import quantize_tree
from repro_torch.models.model import Model
from repro_torch.models.params import tree_map
from repro_torch.optim import AdamW, clip_by_global_norm
from repro_torch.optim.compress import dequantize_grads, quantize_grads_int8

PARTS = ("select", "fwd_bwd", "optim")


@dataclasses.dataclass
class TrainState:
    step: Any  # 0-d int32 tensor
    params: Any
    opt: Any


def init_state(params) -> TrainState:
    dev = _first_leaf(params).device
    return TrainState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      params=params, opt=AdamW().init(params))


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def _flat(tree, prefix=()):
    """[(path, leaf)] of a nested dict, depth first."""
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += _flat(v, prefix + (k,))
        return out
    return [(prefix, tree)]


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _split_micro(batch, n):
    def s(x):
        b = x.shape[0]
        assert b % n == 0, (b, n)
        return x.reshape(n, b // n, *x.shape[1:])

    return {k: s(v) for k, v in batch.items()}


class StepTimer:
    """Marks between the parts of a step; ``ms()`` gives each part's time.
    On the card the marks are CUDA events, so a part's time is device time
    between its marks (it includes any gap the host leaves); on the CPU
    they are the host clock."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self, name: Optional[str]):
        """Close the running part and open ``name`` (None: close only)."""
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        else:
            ev = time.perf_counter()
        self.marks.append((name, ev))

    def ms(self) -> Dict[str, float]:
        out = {p: 0.0 for p in PARTS}
        for (name, a), (_, b) in zip(self.marks, self.marks[1:]):
            if name is None:
                continue
            out[name] = (a.elapsed_time(b) if self.cuda else (b - a) * 1e3)
        return out


def make_grad_fn(model: Model):
    """``grad_fn(params, batch, timer=None) -> (grads, metrics)``: the
    train step's loss gradients with respect to the fp32 masters (QAT
    fake-quant hoisted, compute-dtype cast, gradient accumulation). A leaf
    the loss never reads gets ``None`` without accumulation (a zero
    gradient for the optimizer), zeros with it."""
    cfg = model.cfg
    compute_dt = getattr(torch, cfg.compute_dtype)
    qat = cfg.quant.mode == "qat"
    inner = (Model(cfg.replace(quant=dataclasses.replace(cfg.quant,
                                                         mode="off")))
             if qat else model)

    def cast_for_compute(p):
        return (p.to(compute_dt) if p.ndim >= 2 and p.dtype == torch.float32
                else p)

    def compute_grads(params, batch, timer: Optional[StepTimer] = None):
        if timer:
            timer.mark("select")
        if qat:
            # hoisted SWIS QAT: quantize every GEMM weight once a step
            with torch.no_grad():
                params = quantize_tree(params, cfg.quant.cfg)
        if timer:
            timer.mark("fwd_bwd")
        flat = _flat(params)
        leaves = [p.detach().requires_grad_() for _, p in flat]
        tree = {}
        for (path, _), leaf in zip(flat, leaves):
            _set(tree, path, leaf)
        n = max(cfg.parallel.grad_accum, 1)
        micro = ([batch] if n == 1 else
                 [{k: v[i] for k, v in _split_micro(batch, n).items()}
                  for i in range(n)])
        grads, msum = None, None
        for mb in micro:
            _, metrics = inner.loss(tree_map(cast_for_compute, tree), mb)
            g = torch.autograd.grad(metrics["loss"], leaves,
                                    allow_unused=True)
            metrics = {k: v.detach() for k, v in metrics.items()}
            if n > 1:  # sum in fp32; an unread leaf has a zero gradient
                g = [torch.zeros(leaf.shape, dtype=torch.float32,
                                 device=leaf.device) if gi is None
                     else gi.float() for leaf, gi in zip(leaves, g)]
            if grads is None:
                grads, msum = list(g), metrics
            else:
                grads = [a + b for a, b in zip(grads, g)]
                msum = {k: msum[k] + metrics[k] for k in msum}
        if n > 1:
            grads = [g / n for g in grads]
            msum = {k: v / n for k, v in msum.items()}
        out = {}
        for (path, _), gi in zip(flat, grads):
            _set(out, path, gi)
        return out, msum

    return compute_grads


def make_train_step(model: Model, optimizer: AdamW, lr_fn: Callable, *,
                    max_grad_norm: float = 1.0):
    """``train_step(state, batch, timer=None) -> (new state, metrics)``.
    ``batch``: dict of tensors on the params' device."""
    cfg = model.cfg
    compute_grads = make_grad_fn(model)

    def train_step(state: TrainState, batch, timer: Optional[StepTimer] = None):
        grads, metrics = compute_grads(state.params, batch, timer)
        if timer:
            timer.mark("optim")
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        if cfg.parallel.grad_compress:
            q, s = quantize_grads_int8(grads)
            grads = dequantize_grads(q, s)
        lr = lr_fn(state.step)
        new_params, new_opt = optimizer.update(
            grads, state.opt, state.params, lr=lr, step=state.step)
        if timer:
            timer.mark(None)
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        metrics["lr"] = lr
        return TrainState(step=state.step + 1, params=new_params,
                          opt=new_opt), metrics

    return train_step


def make_eval_step(model: Model):
    def eval_step(params, batch):
        with torch.no_grad():
            _, metrics = model.loss(params, batch)
        return metrics

    return eval_step
