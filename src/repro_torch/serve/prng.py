"""Threefry-2x32 keys and draws, bit-exact with the reference's
``jax.random`` (jax 0.9.0, ``jax_threefry_partitionable=True``, gumbel mode
``"low"``), so seeded sampling gives the reference's tokens.

A key is the reference's key data: two uint32 words ``(k1, k2)``, held
here as an int64 tensor of shape (..., 2). torch has no ``>>`` for
``uint32``, so every word is carried in int64 and masked to 32 bits after
each add and shift; all arithmetic runs on the tensors' device with plain
torch ops.

* :func:`key` — ``jax.random.key_data(jax.random.key(seed))``;
* :func:`fold_in` — ``jax.random.fold_in``: ``threefry_2x32(key,
  threefry_seed(data))``, i.e. the hash of the count pair (0, data);
* :func:`random_bits` — 32 random bits per element of a 1-D shape, the
  partitionable path: hash of the 64-bit iota split (hi, lo), folded
  ``bits1 ^ bits2``;
* :func:`uniform` / :func:`gumbel` — ``jax.random.uniform`` on
  ``[tiny, 1)`` and ``-log(-log(u))``.
"""
from __future__ import annotations

import numpy as np
import torch

_M = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & _M) | (x >> (32 - d))


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of the count pairs (x1, x2) under
    key (k1, k2); all int64 holding uint32 values, broadcast together.
    Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a = (x1 + ks[0]) & _M
    b = (x2 + ks[1]) & _M
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _M
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _M
        b = (b + ks[(i + 2) % 3] + i + 1) & _M
    return a, b


def key(seed: int, device="cpu") -> torch.Tensor:
    """The key data of ``jax.random.key(seed)``: (0, seed mod 2**32) for a
    seed in the int32 range, as the reference takes it in 32-bit mode."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError(f"seed {seed} is outside the int32 range")
    return torch.tensor([0, seed & _M], dtype=torch.int64, device=device)


def as_key(k, device="cpu") -> torch.Tensor:
    """Key data given as any 2-word array (numpy, tensor, list) -> int64
    tensor (2,) on ``device``."""
    t = torch.as_tensor(np.asarray(k, dtype=np.uint64).astype(np.int64))
    if t.shape != (2,):
        raise ValueError(f"a key is two uint32 words, got shape {tuple(t.shape)}")
    return t.to(device)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` for keys (..., 2) and uint32 ``data``
    (broadcast against the keys' leading shape) -> keys (..., 2)."""
    data = torch.as_tensor(data, dtype=torch.int64, device=keys.device) & _M
    o1, o2 = threefry2x32(keys[..., 0], keys[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack([o1, o2], dim=-1)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """32 random bits for each of ``n`` elements per key: keys (B, 2) ->
    int64 (B, n), the reference's partitionable ``random_bits`` of shape
    (n,)."""
    lo = torch.arange(n, dtype=torch.int64, device=keys.device)[None, :]
    hi = torch.zeros_like(lo)  # n < 2**32: the iota's high words are 0
    b1, b2 = threefry2x32(keys[:, :1], keys[:, 1:], hi, lo)
    return b1 ^ b2


def uniform(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.uniform(k, (n,), float32, minval=tiny, maxval=1)`` for
    each key: the top 23 bits as the mantissa of a float in [1, 2), minus
    one, scaled onto [tiny, 1) and floored at tiny."""
    bits = (random_bits(keys, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    span = float(np.float32(1.0) - np.float32(_TINY))  # maxval - minval in fp32
    return torch.clamp_min(floats * span + _TINY, _TINY)


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(k, (n,), float32)`` (mode "low") for each key."""
    return -torch.log(-torch.log(uniform(keys, n)))
