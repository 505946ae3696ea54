"""AdamW with decoupled weight decay (PyTorch port of
``repro.optim.adamw``), over nested dicts of tensors.

The state is a tree congruent with the params (fp32 moments ``m`` and
``v``). The update keeps the reference's formula: bias correction as
``mhat / (sqrt(vhat) + eps)`` and decay only on leaves with ndim >=
``decay_min_ndim``. A leaf whose gradient is ``None`` (a parameter the
loss never reads, such as the encoder's unused token table) counts as a
zero gradient, as the reference's ``jax.grad`` gives zeros there: its
moments decay and weight decay still applies.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.params import tree_map


def _zip_map(fn, *trees):
    """``fn`` over the leaves of congruent nested dicts (the first tree's
    structure)."""
    if isinstance(trees[0], dict):
        return {k: _zip_map(fn, *(t[k] if t is not None else None
                                  for t in trees))
                for k in trees[0]}
    return fn(*trees)


@dataclasses.dataclass(frozen=True)
class AdamW:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    # weight decay is skipped for 1-D leaves (norm scales, biases)
    decay_min_ndim: int = 2

    def init(self, params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    def update(self, grads, opt_state, params, *, lr, step):
        """One step. ``lr`` is a float32 number, ``step`` the 0-based step
        count (int or 0-d tensor). Returns (new params, new state)."""
        b1, b2, eps = self.b1, self.b2, self.eps
        count = torch.tensor(int(step) + 1, dtype=torch.float32)
        # float32 bias corrections, as the reference's weakly typed scalars
        c1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** count)
        c2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** count)
        lr = float(lr)

        def upd(g, m, v, p):
            g32 = (torch.zeros_like(m) if g is None else g.float())
            m_new = b1 * m + (1 - b1) * g32
            v_new = b2 * v + (1 - b2) * g32 * g32
            mhat = m_new / _scalar(c1, m)
            vhat = v_new / _scalar(c2, v)
            delta = mhat / (torch.sqrt(vhat) + eps)
            if self.weight_decay and p.ndim >= self.decay_min_ndim:
                delta = delta + self.weight_decay * p.float()
            p_new = p.float() - lr * delta
            return p_new.to(p.dtype), m_new, v_new

        out = _zip_map(upd, grads, opt_state["m"], opt_state["v"], params)

        def pick(i):
            return _zip_map_tuple(out, i)

        return pick(0), {"m": pick(1), "v": pick(2)}


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a float32 0-d tensor on ``like``'s device: a divisor that
    stays a true division on the card, where dividing by a Python number
    multiplies by its reciprocal."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _zip_map_tuple(tree, i):
    if isinstance(tree, dict):
        return {k: _zip_map_tuple(v, i) for k, v in tree.items()}
    return tree[i]
