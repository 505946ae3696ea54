"""Global-norm gradient clipping (PyTorch port of ``repro.optim.clip``).
A ``None`` leaf is a zero gradient."""
from __future__ import annotations

import torch

from repro_torch.models.params import tree_map


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def global_norm(tree) -> torch.Tensor:
    total = None
    for leaf in _leaves(tree):
        sq = torch.sum(torch.square(leaf.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total if total is not None else torch.zeros(()))


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled by min(1, max_norm / norm), norm)."""
    norm = global_norm(tree)
    scale = torch.clamp_max(
        torch.tensor(max_norm, dtype=torch.float32, device=norm.device)
        / torch.clamp_min(norm, 1e-9), 1.0)
    return tree_map(lambda a: None if a is None
                    else (a.float() * scale).to(a.dtype), tree), norm
