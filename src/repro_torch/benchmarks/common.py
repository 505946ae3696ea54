"""Shared benchmark utilities (port of the reference's
``benchmarks/common.py``): timing, and a small trained model used by the
accuracy tables (Tables 2, 3 and 5, Fig. 6) and the examples.

No labelled dataset is used: accuracy is next-token accuracy on the
synthetic affine-recurrence stream of ``data.SyntheticPipeline``, which a
small LM learns well, so the tables reproduce the paper's orderings and
deltas on that task; the quantization math the paper's tables measure is
exercised identically.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Tuple

import torch

from repro_torch import configs as C
from repro_torch import device as _device
from repro_torch.configs.base import ArchConfig, QuantPolicy
from repro_torch.core.swis import QuantConfig
from repro_torch.data import SyntheticPipeline
from repro_torch.data.pipeline import to_device
from repro_torch.models.model import Model
from repro_torch.train.loop import Trainer


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_us(fn: Callable, *args, n: int = 3, warmup: int = 1) -> float:
    """Mean wall time of ``fn(*args)`` in µs over ``n`` calls after
    ``warmup`` calls; the card is synchronized after the warm-up and after
    the timed loop, so the time includes the device's work."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(n):
        fn(*args)
    _sync()
    return (time.perf_counter() - t0) / n * 1e6


def eval_fn(cfg: ArchConfig, params, seq: int = 64, batch: int = 16,
            device="cuda"):
    """``eval_acc(eval_cfg, eval_params=None, n_batches=4)``: the mean
    accuracy of ``Model(eval_cfg).loss`` over the held-out batches 100000+
    of ``cfg``'s synthetic stream (seed 0), with ``params`` unless
    ``eval_params`` is given."""
    device = _device.resolve(device)
    pipe = SyntheticPipeline(cfg, seq, batch, seed=0)

    def eval_acc(eval_cfg: ArchConfig, eval_params=None,
                 n_batches: int = 4) -> float:
        m = Model(eval_cfg)
        p = eval_params if eval_params is not None else params
        accs = []
        with torch.no_grad():
            for i in range(n_batches):
                b = to_device(pipe.batch_at(100000 + i), device)
                _, metrics = m.loss(p, b)
                accs.append(float(metrics["accuracy"]))
        return sum(accs) / len(accs)

    return eval_acc


_MODEL_CACHE: Dict[Tuple, tuple] = {}


def trained_smoke_model(steps: int = 400, seq: int = 64, batch: int = 16,
                        device="cuda", workdir=None):
    """Train the benchmark model, smollm's smoke config at float32 compute
    on the synthetic stream, and return ``(cfg, params, eval_acc)``
    (:func:`eval_fn`). Cached per arguments within a process. Unlike the
    reference, which caches its checkpoint under ``results/bench`` and
    loads it in later processes, every process trains anew; ``workdir``,
    when given, only receives the last step's checkpoint."""
    key = (steps, seq, batch, str(device))
    if key in _MODEL_CACHE:
        return _MODEL_CACHE[key]
    cfg = C.get_smoke("smollm-135m").replace(compute_dtype="float32")
    tr = Trainer(cfg, seq_len=seq, global_batch=batch, workdir=workdir,
                 total_steps=steps, ckpt_every=steps if workdir else 0,
                 warmup=20, peak_lr=5e-3, device=device)
    params = tr.run(steps)["state"].params
    _MODEL_CACHE[key] = (cfg, params, eval_fn(cfg, params, seq, batch,
                                              tr.device))
    return _MODEL_CACHE[key]


def quant_policy(method: str, n_shifts: float, *, ds: bool = False,
                 schedule: bool = True, group: int = 4,
                 act_shifts: int = 0) -> QuantPolicy:
    """The PTQ policy of a method ('swis', 'swis_c', 'trunc', or
    'act_trunc' for activation truncation) at ``n_shifts``."""
    if method == "act_trunc":
        return QuantPolicy(cfg=QuantConfig(method="none"), mode="off",
                           act_shifts=act_shifts or int(n_shifts))
    return QuantPolicy(
        cfg=QuantConfig(method=method, n_shifts=n_shifts, group_size=group,
                        double_shift=ds, schedule=schedule),
        mode="ptq")
