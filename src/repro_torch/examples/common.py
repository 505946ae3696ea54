"""What the port's examples need of the reference's ``benchmarks/common.py``:
a small trained model and the quantization policies its accuracy is read
under (the benchmarks themselves are not ported).

No labelled dataset is used: accuracy is next-token accuracy on the
synthetic induction-style stream of ``data.SyntheticPipeline``, which a
small LM learns well, so the quantization's accuracy loss shows above the
noise floor.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch import configs as C
from repro_torch.configs.base import ArchConfig, QuantPolicy
from repro_torch.core.swis import QuantConfig
from repro_torch.data import SyntheticPipeline
from repro_torch.data.pipeline import to_device
from repro_torch.models.model import Model
from repro_torch.train.loop import Trainer

_MODEL_CACHE: Dict[Tuple, tuple] = {}


def trained_smoke_model(steps: int = 400, seq: int = 64, batch: int = 16,
                        device="cuda", workdir=None):
    """Train the example model — smollm's smoke config on the synthetic
    stream, float32 compute — and return (cfg, params, eval_acc).
    ``eval_acc(cfg, eval_params=None, n_batches=4)`` is the mean accuracy
    of ``Model(cfg).loss`` over held-out batches (steps 100000+). Cached
    per arguments within a process."""
    key = (steps, seq, batch, str(device))
    if key in _MODEL_CACHE:
        return _MODEL_CACHE[key]
    cfg = C.get_smoke("smollm-135m").replace(compute_dtype="float32")
    tr = Trainer(cfg, seq_len=seq, global_batch=batch, workdir=workdir,
                 total_steps=steps, ckpt_every=steps if workdir else 0,
                 warmup=20, peak_lr=5e-3, device=device)
    out = tr.run(steps)
    params = out["state"].params
    pipe = SyntheticPipeline(cfg, seq, batch, seed=0)

    def eval_acc(eval_cfg: ArchConfig, eval_params=None,
                 n_batches: int = 4) -> float:
        m = Model(eval_cfg)
        p = eval_params if eval_params is not None else params
        accs = []
        with torch.no_grad():
            for i in range(n_batches):
                b = to_device(pipe.batch_at(100000 + i), tr.device)
                _, metrics = m.loss(p, b)
                accs.append(float(metrics["accuracy"]))
        return sum(accs) / len(accs)

    _MODEL_CACHE[key] = (cfg, params, eval_acc)
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
