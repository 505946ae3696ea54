"""Basic model layers (PyTorch port of ``repro.models.layers``).

Every GEMM goes through :func:`dense`. A packed SWIS leaf runs the SWIS
matmul op (the CUDA kernel on the card); a dense leaf is a plain matmul.
The quantization policies that rewrite dense weights in the graph (QAT /
PTQ fake-quant, activation truncation) are not ported yet and raise.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.packing import PackedWeight
from repro_torch.kernels import ops
from repro_torch.models.params import P


# ---------------------------------------------------------------------------
# Builders (placeholder trees)
# ---------------------------------------------------------------------------


def build_norm(d: int) -> dict:
    return {"scale": P((d,), ("embed",), init="ones")}


def build_linear(d_in: int, d_out: int, axes=("embed", "mlp"), scale=None) -> dict:
    return {"w": P((d_in, d_out), axes, scale=scale)}


def build_mlp(cfg: ArchConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    p = {
        "wo": build_linear(f, d, ("mlp", "embed")),
        "wi": build_linear(d, f, ("embed", "mlp")),
    }
    if cfg.glu:
        p["wg"] = build_linear(d, f, ("embed", "mlp"))
    return p


def build_embed(cfg: ArchConfig) -> dict:
    v, d = cfg.padded_vocab, cfg.d_model
    p = {"tok": P((v, d), ("vocab", "embed"), init="embed", scale=0.02)}
    if not cfg.tie_embeddings:
        p["unembed"] = P((d, v), ("embed", "vocab"), scale=0.02)
    return p


# ---------------------------------------------------------------------------
# Appliers
# ---------------------------------------------------------------------------


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def norm_apply(p: dict, x: torch.Tensor, cfg: ArchConfig, eps: float = 1e-6):
    dt = x.dtype
    x32 = x.float()
    if cfg.norm == "rms":
        var = torch.mean(x32 * x32, dim=-1, keepdim=True)
        y = x32 * torch.rsqrt(var + eps)
    else:  # LayerNorm without bias
        mu = torch.mean(x32, dim=-1, keepdim=True)
        var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
        y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(dt)


def is_packed(w) -> bool:
    return isinstance(w, dict) and "mask_planes" in w


def packed_weight(w: dict, cfg: ArchConfig) -> PackedWeight:
    """A 2-D packed leaf as the SWIS op's :class:`PackedWeight`, with the
    shift layout of the model's pack method."""
    k = w["sign_plane"].shape[0] * 32
    return PackedWeight(
        sign_plane=w["sign_plane"], mask_planes=w["mask_planes"],
        shifts=w["shifts"], scale=w["scale"],
        group_size=k // w["shifts"].shape[0],
        n_shifts=int(w["mask_planes"].shape[0]), k=k,
        c=w["sign_plane"].shape[1],
        method="swis_c" if cfg.quant.cfg.method == "swis_c" else "swis")


def check_fake_quant(cfg: ArchConfig) -> None:
    """Dense weights under a fake-quant policy are not served yet."""
    if cfg.quant.mode != "off" and cfg.quant.cfg.method != "none":
        raise NotImplementedError(
            f"quant mode {cfg.quant.mode!r} (fake-quant) is not ported yet")


def dense(p: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Linear layer under the model's quantization policy."""
    w = p["w"]
    if is_packed(w):
        return ops.swis_matmul(x, packed_weight(w, cfg),
                               keep_slices=cfg.quant.keep_slices).to(x.dtype)
    if cfg.quant.act_shifts:
        raise NotImplementedError(
            "activation truncation (act_shifts) is not ported yet")
    check_fake_quant(cfg)
    return x @ w.to(x.dtype)


def _act(h: torch.Tensor, kind: str) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu(h) if kind == "silu" else F.gelu(h, approximate="tanh")


def mlp_apply(p: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    h = _act(dense(p["wi"], x, cfg), cfg.act)
    if cfg.glu:
        h = h * dense(p["wg"], x, cfg)
    return dense(p["wo"], h, cfg)


def embed_apply(p: dict, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if cfg.quant.quantize_embeddings and cfg.quant.mode != "off":
        raise NotImplementedError("embedding fake-quant is not ported yet")
    return p["tok"][tokens].to(_dtype(cfg.compute_dtype))


def unembed_apply(p: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    w = p["tok"].T if cfg.tie_embeddings else p["unembed"]
    # logits in fp32; a plain matmul, as the reference left it to XLA
    return (x @ w.to(x.dtype)).float()


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., S, n_heads, d_head); positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions[..., None].float() * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)
