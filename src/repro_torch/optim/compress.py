"""Gradient compression (PyTorch port of ``repro.optim.compress``).

``quantize_grads_int8`` / ``dequantize_grads`` are per-leaf absmax int8
quantization, which the train step applies in its update path when
``parallel.grad_compress`` is set. ``compressed_allreduce`` is the
bandwidth-compressed mean over a ``torch.distributed`` group: each rank
all-gathers the int8 payload (1 byte an element) and its fp32 scale and
averages locally in fp32.
"""
from __future__ import annotations

import torch

from repro_torch.models.params import tree_map


def _q(g: torch.Tensor):
    g32 = g.float()
    # a 0-d divisor on the device keeps this a true division on the card
    scale = torch.clamp_min(torch.amax(torch.abs(g32)), 1e-12) / torch.tensor(
        127.0, device=g.device)
    return torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8), scale


def quantize_grads_int8(tree):
    """Per-leaf symmetric int8 quantization. Returns (q_tree, scale_tree);
    a ``None`` leaf stays ``None``."""
    pairs = tree_map(lambda g: None if g is None else _q(g), tree)
    return (tree_map(lambda t: None if t is None else t[0], pairs),
            tree_map(lambda t: None if t is None else t[1], pairs))


def dequantize_grads(q_tree, scale_tree):
    def deq(tree_q, tree_s):
        if isinstance(tree_q, dict):
            return {k: deq(tree_q[k], tree_s[k]) for k in tree_q}
        return None if tree_q is None else tree_q.float() * tree_s
    return deq(q_tree, scale_tree)


def compressed_allreduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Mean of ``x`` over the ranks of ``group`` (the default group when
    None) with an int8-compressed payload."""
    import torch.distributed as dist

    q, scale = _q(x)
    n = dist.get_world_size(group)
    qs = [torch.empty_like(q) for _ in range(n)]
    ss = [torch.empty_like(scale) for _ in range(n)]
    dist.all_gather(qs, q, group=group)
    dist.all_gather(ss, scale.reshape(()), group=group)
    deq = torch.stack(qs).float() * torch.stack(ss).reshape(
        (-1,) + (1,) * x.ndim)
    return deq.mean(dim=0).to(x.dtype)
