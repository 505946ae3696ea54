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

On a mesh (the state's leaves are ``DTensor``s, the step runs under
the trainer's rules) the same step runs sharded: the quantizer all-reduces
each shard's amax (:mod:`repro_torch.parallel.quant`), the compute-dtype
copy is redistributed once a step to ``compute_shardings`` (the TP-only
placements, when the masters are FSDP-sharded: the ZeRO-3 gathers then
move compute-dtype bytes), the model computes on local shards
(:mod:`repro_torch.parallel.model`), each gradient is reduced to its
master's placements, and AdamW updates each leaf in its moments'
placements (ZeRO-1 over ``data`` when ``fsdp_opt``) before the new
masters go back to theirs. The reference pins the cast with
``optimization_barrier`` only to stop XLA from sinking it into the layer
scan; eager PyTorch has no such pass.

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


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _to(t, placements):
    """A ``DTensor`` redistributed to ``placements`` (a no-op when equal)."""
    if tuple(t.placements) == tuple(placements):
        return t
    return t.redistribute(t.device_mesh, tuple(placements))


def _zip2(fn, a, b):
    if isinstance(a, dict):
        return {k: _zip2(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def _micro_batches(batch, n: int):
    """The ``n`` microbatches of a batch. A ``DTensor`` batch is split on
    each rank's own rows (microbatch i holds every rank's i-th slice), so
    no rows move; the accumulated gradient is the same sum."""
    if n == 1:
        return [batch]
    if not any(_is_dtensor(v) for v in batch.values()):
        return [{k: v[i] for k, v in _split_micro(batch, n).items()}
                for i in range(n)]
    from torch.distributed.tensor import DTensor

    out = []
    for i in range(n):
        mb = {}
        for k, v in batch.items():
            loc = _split_micro({k: v.to_local()}, n)[k][i]
            shape = (v.shape[0] // n,) + tuple(v.shape[1:])
            mb[k] = DTensor.from_local(loc, v.device_mesh, v.placements,
                                       shape=shape,
                                       stride=loc.contiguous().stride())
        out.append(mb)
    return out


def make_grad_fn(model: Model, compute_shardings=None):
    """``grad_fn(params, batch, timer=None) -> (grads, metrics)``: the
    train step's loss gradients with respect to the fp32 masters (QAT
    fake-quant hoisted, compute-dtype cast, gradient accumulation). A leaf
    the loss never reads gets ``None`` without accumulation (a zero
    gradient for the optimizer), zeros with it. ``compute_shardings``: the
    placements tree the compute-dtype copy of ``DTensor`` params is
    redistributed to (None: the masters' own)."""
    cfg = model.cfg
    compute_dt = getattr(torch, cfg.compute_dtype)
    qat = cfg.quant.mode == "qat"
    inner = (Model(cfg.replace(quant=dataclasses.replace(cfg.quant,
                                                         mode="off")))
             if qat else model)

    def cast_for_compute(p, target=None):
        if p.ndim >= 2 and p.dtype == torch.float32:
            p = p.to(compute_dt)
        return _to(p, target) if target is not None else p

    def compute_grads(params, batch, timer: Optional[StepTimer] = None):
        on_mesh = _is_dtensor(_first_leaf(params))
        if timer:
            timer.mark("select")
        if qat:
            # hoisted SWIS QAT: quantize every GEMM weight once a step
            with torch.no_grad():
                if on_mesh:
                    from repro_torch.parallel.quant import fake_quant_dtensor

                    params = quantize_tree(params, cfg.quant.cfg,
                                           quant=fake_quant_dtensor)
                else:
                    params = quantize_tree(params, cfg.quant.cfg)
        if timer:
            timer.mark("fwd_bwd")
        flat = _flat(params)
        leaves = [p.detach().requires_grad_() for _, p in flat]
        tree = {}
        for (path, _), leaf in zip(flat, leaves):
            _set(tree, path, leaf)
        n = max(cfg.parallel.grad_accum, 1)
        grads, msum = None, None
        for mb in _micro_batches(batch, n):
            compute = (tree_map(cast_for_compute, tree)
                       if compute_shardings is None
                       else _zip2(cast_for_compute, tree, compute_shardings))
            _, metrics = inner.loss(compute, mb)
            g = torch.autograd.grad(metrics["loss"], leaves,
                                    allow_unused=True)
            metrics = {k: v.detach() for k, v in metrics.items()}
            if on_mesh:  # each gradient in its master's placements
                g = [None if gi is None else _to(gi, leaf.placements)
                     for leaf, gi in zip(leaves, g)]
            if n > 1:  # sum in fp32; an unread leaf has a zero gradient
                g = [torch.zeros_like(leaf, dtype=torch.float32)
                     if gi is None else gi.float()
                     for leaf, gi in zip(leaves, g)]
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
                    max_grad_norm: float = 1.0, compute_shardings=None):
    """``train_step(state, batch, timer=None) -> (new state, metrics)``.
    ``batch``: dict of tensors on the params' device (``DTensor``s for a
    state on a mesh). ``compute_shardings``: see :func:`make_grad_fn`."""
    cfg = model.cfg
    compute_grads = make_grad_fn(model, compute_shardings)

    def update(grads, state):
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        if cfg.parallel.grad_compress:
            q, s = quantize_grads_int8(grads)
            grads = dequantize_grads(q, s)
        lr = lr_fn(state.step)
        new_params, new_opt = optimizer.update(
            grads, state.opt, state.params, lr=lr, step=state.step)
        return new_params, new_opt, gnorm, lr

    def sharded_update(grads, state):
        from torch.distributed.tensor.experimental import implicit_replication

        m = state.opt["m"]

        def in_opt(t, mt):  # a leaf in its moments' placements
            return None if t is None else _to(t, mt.placements)

        opt_view = dataclasses.replace(state, params=_zip2(in_opt,
                                                           state.params, m))
        with implicit_replication():
            new_p, new_opt, gnorm, lr = update(_zip2(in_opt, grads, m),
                                               opt_view)
        new_p = _zip2(lambda a, p: _to(a, p.placements), new_p, state.params)
        return new_p, new_opt, gnorm.full_tensor(), lr

    def train_step(state: TrainState, batch, timer: Optional[StepTimer] = None):
        grads, metrics = compute_grads(state.params, batch, timer)
        if timer:
            timer.mark("optim")
        new_params, new_opt, gnorm, lr = (
            sharded_update if _is_dtensor(_first_leaf(state.params))
            else update)(grads, state)
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
