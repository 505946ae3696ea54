"""Griffin / RecurrentGemma RG-LRU recurrent block (arXiv:2402.19427;
PyTorch port of ``repro.models.rglru``).

Recurrence:  h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
with         a_t = exp(-c * softplus(lambda) * sigmoid(W_a x_t)),
             i_t = sigmoid(W_x x_t).

Prefill runs the recurrence as a log-depth scan (:func:`_rglru_scan`, the
reference's ``jax.lax.associative_scan``); decode keeps the O(1) state.
The in, gate and out projections go through :func:`dense` (the SWIS kernel
on the card); the block-diagonal gates, the conv and the scan are plain
torch, as the reference computes them outside any kernel.

A cached call writes its new state into ``cache`` in place and returns the
same dict, where the reference returned updated copies.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import dense
from repro_torch.models.params import P
from repro_torch.models.ssm import _causal_conv


def _n_blocks(cfg: ArchConfig) -> int:
    # block-diagonal gate matrices, one block per head where it divides
    gc = cfg.griffin
    nb = cfg.n_heads
    while gc.lru_width % nb:
        nb -= 1
    return nb


def build_rglru_block(cfg: ArchConfig) -> dict:
    gc = cfg.griffin
    d, w = cfg.d_model, gc.lru_width
    nb = _n_blocks(cfg)
    bs = w // nb
    return {
        "in_x": {"w": P((d, w), ("embed", "mlp"))},
        "in_gate": {"w": P((d, w), ("embed", "mlp"))},
        "conv_w": P((gc.conv_width, w), (None, "mlp")),
        "gate_a": P((nb, bs, bs), ("heads", None, None)),
        "gate_x": P((nb, bs, bs), ("heads", None, None)),
        "lambda_raw": P((w,), ("mlp",), init="ones"),
        "out": {"w": P((w, d), ("mlp", "embed"))},
    }


def _block_gate(w_blocks: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Block-diagonal matmul: x (B, L, W) @ blockdiag(w_blocks (NB, BS, BS))."""
    b, l, w = x.shape
    nb, bs, _ = w_blocks.shape
    y = torch.einsum("blni,nij->blnj", x.reshape(b, l, nb, bs),
                     w_blocks.to(x.dtype))
    return y.reshape(b, l, w)


def build_rglru_cache(cfg: ArchConfig, batch: int, dtype) -> dict:
    """The recurrent state (always float32) and the conv's last K-1 inputs
    (in the cache dtype); no position plane."""
    gc = cfg.griffin
    return {
        "h": P((batch, gc.lru_width), ("batch", "mlp"), init="zeros",
               dtype=torch.float32),
        "conv": P((batch, gc.conv_width - 1, gc.lru_width),
                  ("batch", None, "mlp"), init="zeros", dtype=dtype),
    }


def _rglru_scan(log_a: torch.Tensor, b: torch.Tensor,
                h0: Optional[torch.Tensor]) -> torch.Tensor:
    """h_t = exp(log_a_t) * h_{t-1} + b_t along axis 1 (h_{-1} = ``h0`` or
    0), as an inclusive Hillis-Steele scan over the reference's combine
    (la, ba) . (lb, bb) = (la + lb, exp(lb) * ba + bb): ceil(log2 L)
    rounds of whole-tensor ops, not a loop over L."""
    if h0 is not None:
        # fold the initial state into step 0: h_0 = exp(log_a_0) h0 + b_0
        b = torch.cat([b[:, :1] + (torch.exp(log_a[:, 0]) * h0)[:, None],
                       b[:, 1:]], dim=1)
    la, h = log_a, b
    d = 1
    while d < la.shape[1]:
        # element i absorbs the prefix ending at i - d
        h = torch.cat([h[:, :d], torch.exp(la[:, d:]) * h[:, :-d] + h[:, d:]],
                      dim=1)
        la = torch.cat([la[:, :d], la[:, :-d] + la[:, d:]], dim=1)
        d *= 2
    return h


def rglru_apply(p: dict, x: torch.Tensor, cfg: ArchConfig,
                cache: Optional[dict] = None):
    """Griffin recurrent block: x (B, L, D) -> (y (B, L, D), cache or None).
    With a cache, one token takes the recurrent step and more tokens the
    scan from the cached state; either way the new state is written into
    ``cache``."""
    gc = cfg.griffin
    f32 = torch.float32

    gate_branch = F.gelu(dense(p["in_gate"], x, cfg), approximate="tanh")
    xb = dense(p["in_x"], x, cfg)
    xb, new_conv = _causal_conv(
        xb, p["conv_w"], None if cache is None else cache["conv"])

    # RG-LRU gates (block-diagonal) and the float32 recurrence
    r = torch.sigmoid(_block_gate(p["gate_a"], xb).to(f32))
    i = torch.sigmoid(_block_gate(p["gate_x"], xb).to(f32))
    log_lambda = -F.softplus(p["lambda_raw"].to(f32))  # log a_base < 0
    log_a = gc.lru_c * log_lambda[None, None, :] * r  # (B, L, W) log decay
    a2 = torch.exp(2.0 * log_a)
    gated_in = torch.sqrt(torch.clamp_min(1.0 - a2, 1e-12)) * i * xb.to(f32)

    if cache is None:
        h = _rglru_scan(log_a, gated_in, None)
    elif x.shape[1] == 1:
        h = (torch.exp(log_a[:, 0]) * cache["h"] + gated_in[:, 0])[:, None]
    else:  # prefill from the carried state
        h = _rglru_scan(log_a, gated_in, cache["h"])
    if cache is not None:
        cache["h"].copy_(h[:, -1])
        cache["conv"].copy_(new_conv)

    y = h.to(x.dtype) * gate_branch
    return dense(p["out"], y, cfg), cache
