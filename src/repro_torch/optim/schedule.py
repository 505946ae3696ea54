"""Learning-rate schedules (PyTorch port of ``repro.optim.schedule``):
callables of the step, computed in float32 as the reference does; each
returns a 0-d float32 tensor."""
from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).cpu()


def warmup_cosine(peak_lr: float, warmup: int, total: int, floor: float = 0.0):
    def lr(step):
        s = _f32(int(step))
        warm = peak_lr * (s + 1.0) / max(warmup, 1)
        frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (peak_lr - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(s < warmup, warm, cos)

    return lr


def warmup_linear(peak_lr: float, warmup: int, total: int, floor: float = 0.0):
    def lr(step):
        s = _f32(int(step))
        warm = peak_lr * (s + 1.0) / max(warmup, 1)
        frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        lin = peak_lr + (floor - peak_lr) * frac
        return torch.where(s < warmup, warm, lin)

    return lr
