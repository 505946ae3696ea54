"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060) block (PyTorch port
of ``repro.models.ssm``).

The chunked SSD algorithm serves prefill (O(L * chunk) within chunks plus a
recurrence over L / chunk chunk states) and an O(1)-state recurrent step
serves decode. SWIS packing applies to the in and out projections, which
go through :func:`dense` (the SWIS kernel on the card); the scan is small
elementwise and einsum state math in float32, plain torch as the reference
left it to XLA.

A cached call writes its new SSM and conv state into ``cache`` in place and
returns the same dict, where the reference returned updated copies.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import dense, norm_apply
from repro_torch.models.params import P


def _dims(cfg: ArchConfig):
    mc = cfg.mamba2
    d_inner = mc.expand * cfg.d_model
    n_heads = d_inner // mc.head_dim
    return d_inner, n_heads, mc.d_state, mc.head_dim


def build_mamba(cfg: ArchConfig) -> dict:
    mc = cfg.mamba2
    d = cfg.d_model
    d_inner, n_heads, d_state, _ = _dims(cfg)
    conv_dim = d_inner + 2 * d_state
    return {
        "in_proj": {"w": P((d, 2 * d_inner + 2 * d_state + n_heads),
                           ("embed", "mlp"))},
        "conv_w": P((mc.conv_width, conv_dim), (None, "mlp")),
        "A_log": P((n_heads,), (None,), init="zeros"),
        "D": P((n_heads,), (None,), init="ones"),
        "dt_bias": P((n_heads,), (None,), init="zeros"),
        "out_norm": {"scale": P((d_inner,), ("mlp",), init="ones")},
        "out_proj": {"w": P((d_inner, d), ("mlp", "embed"))},
    }


def build_mamba_cache(cfg: ArchConfig, batch: int, dtype) -> dict:
    """The SSM state (always float32) and the conv's last K-1 inputs (in
    the cache dtype); no position plane."""
    mc = cfg.mamba2
    d_inner, n_heads, d_state, head_dim = _dims(cfg)
    conv_dim = d_inner + 2 * d_state
    return {
        "ssm": P((batch, n_heads, head_dim, d_state),
                 ("batch", "heads", None, None), init="zeros",
                 dtype=torch.float32),
        "conv": P((batch, mc.conv_width - 1, conv_dim),
                  ("batch", None, "mlp"), init="zeros", dtype=dtype),
    }


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable segment sum: out[..., i, j] = sum_{k in (j, i]} x[..., k],
    lower-triangular (i >= j), -inf above the diagonal."""
    t = x.shape[-1]
    csum = torch.cumsum(x, dim=-1)
    out = csum[..., :, None] - csum[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    return out.masked_fill(~mask, float("-inf"))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_neg: torch.Tensor,
                b_mat: torch.Tensor, c_mat: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None):
    """Chunked SSD (Mamba-2 algorithm 1). x (B, L, H, P), dt (B, L, H)
    (after softplus), a_neg (H,) = -exp(A_log), b_mat / c_mat (B, L, N),
    init_state (B, H, P, N). Returns (y (B, L, H, P), final state (B, H,
    P, N) float32). L must be a multiple of min(chunk, L)."""
    bsz, l, h, p = x.shape
    n = b_mat.shape[-1]
    q = min(chunk, l)
    if l % q:
        raise ValueError(f"sequence length {l} is not a multiple of the "
                         f"chunk {q}")
    nc = l // q

    xb = (x * dt[..., None]).reshape(bsz, nc, q, h, p)  # dt folded into x
    ab = (dt * a_neg[None, None, :]).reshape(bsz, nc, q, h)  # log decay
    bb = b_mat.reshape(bsz, nc, q, n)
    cb = c_mat.reshape(bsz, nc, q, n)

    ab_hl = ab.permute(0, 1, 3, 2)  # (B, NC, H, Q)
    a_cum = torch.cumsum(ab_hl, dim=-1)  # cumulative log decay in a chunk

    # 1) within chunks (diagonal blocks): Y_diag = (C B^T * L) X
    l_mat = torch.exp(_segsum(ab_hl))  # (B, NC, H, Q, Q)
    scores = torch.einsum("bcqn,bckn->bcqk", cb, bb)  # (B, NC, Q, Q)
    y_diag = torch.einsum("bchqk,bcqk,bckhp->bcqhp", l_mat, scores, xb)

    # 2) the state each chunk contributes
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)  # (B, NC, H, Q)
    states = torch.einsum("bckn,bchk,bckhp->bchpn", bb, decay_states, xb)

    # 3) the recurrence over chunk states, in float32 (the reference's
    # lax.scan): prev[c] is the state entering chunk c
    chunk_decay = torch.exp(a_cum[..., -1]).float()  # (B, NC, H)
    s = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    prev = []
    for c in range(nc):
        prev.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c].float()
    prev_states = torch.stack(prev, dim=1)  # (B, NC, H, P, N)

    # 4) what the entering state adds: Y_off = C * decay_in @ prev_state
    decay_out = torch.exp(a_cum)  # (B, NC, H, Q)
    y_off = torch.einsum("bcqn,bchq,bchpn->bcqhp", cb, decay_out,
                         prev_states.to(cb.dtype))

    y = (y_diag + y_off).reshape(bsz, l, h, p)
    return y, s


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, a_neg: torch.Tensor,
                    b_mat: torch.Tensor, c_mat: torch.Tensor,
                    state: torch.Tensor):
    """One recurrent step. x (B, 1, H, P), dt (B, 1, H), b_mat / c_mat (B, 1,
    N), state (B, H, P, N) float32. Returns (y (B, 1, H, P), new state)."""
    da = torch.exp(dt[:, 0, :, None, None] * a_neg[None, :, None, None])
    upd = torch.einsum("bhp,bn->bhpn", (x * dt[..., None])[:, 0],
                       b_mat[:, 0]).float()
    new_state = state * da + upd
    y = torch.einsum("bhpn,bn->bhp", new_state.to(c_mat.dtype), c_mat[:, 0])
    return y[:, None], new_state


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 cache: Optional[torch.Tensor] = None):
    """Depthwise causal conv along L. x (B, L, C), w (K, C), cache (B, K-1,
    C): the K-1 inputs before x (zeros without one). Returns (out, the last
    K-1 inputs, or None without a cache)."""
    k = w.shape[0]
    if cache is not None:
        xp = torch.cat([cache.to(x.dtype), x], dim=1)
        new_cache = xp[:, -(k - 1):] if k > 1 else cache
    else:
        xp = F.pad(x, (0, 0, k - 1, 0))
        new_cache = None
    s = x.shape[1]
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i:i + s] * w[i][None, None, :]
    return out, new_cache


def mamba_apply(p: dict, x: torch.Tensor, cfg: ArchConfig,
                cache: Optional[dict] = None):
    """x (B, L, D) -> (y (B, L, D), cache or None). With a cache, one token
    takes the recurrent step and more tokens the chunked scan from the
    cached state; either way the new state is written into ``cache``."""
    mc = cfg.mamba2
    d_inner, n_heads, d_state, head_dim = _dims(cfg)
    b, l, _ = x.shape
    f32 = torch.float32

    zxbcdt = dense(p["in_proj"], x, cfg)
    z, xc, bc, cc, dt_raw = torch.split(
        zxbcdt, [d_inner, d_inner, d_state, d_state, n_heads], dim=-1)
    conv_in = torch.cat([xc, bc, cc], dim=-1)
    conv_out, new_conv = _causal_conv(
        conv_in, p["conv_w"], None if cache is None else cache["conv"])
    conv_out = F.silu(conv_out)
    xc, bc, cc = torch.split(conv_out, [d_inner, d_state, d_state], dim=-1)

    dt = F.softplus(dt_raw.to(f32) + p["dt_bias"].to(f32))
    a_neg = -torch.exp(p["A_log"].to(f32))
    xh = xc.reshape(b, l, n_heads, head_dim)

    if cache is not None and l == 1:
        y, new_state = ssd_decode_step(xh.to(f32), dt, a_neg, bc.to(f32),
                                       cc.to(f32), cache["ssm"])
    else:
        # pad L to a chunk multiple with dt = 0 steps (decay 1, no input:
        # the state is unchanged); the padded outputs are cut off
        pad = (-l) % min(mc.chunk, l)
        y, new_state = ssd_chunked(
            F.pad(xh.to(f32), (0, 0, 0, 0, 0, pad)),
            F.pad(dt, (0, 0, 0, pad)), a_neg,
            F.pad(bc.to(f32), (0, 0, 0, pad)),
            F.pad(cc.to(f32), (0, 0, 0, pad)), mc.chunk,
            init_state=None if cache is None else cache["ssm"])
        y = y[:, :l]
    if cache is not None:
        cache["ssm"].copy_(new_state)
        cache["conv"].copy_(new_conv)

    y = y + xh.to(f32) * p["D"].to(f32)[None, None, :, None]
    y = y.reshape(b, l, d_inner).to(x.dtype)
    y = y * F.silu(z)  # gated output
    y = norm_apply(p["out_norm"], y, cfg)
    return dense(p["out_proj"], y, cfg), cache
