"""Mixture-of-Experts FFN (PyTorch port of ``repro.models.moe``): top-k
routing, GShard-style capacity dispatch, optional shared (always-on)
experts — Qwen2-MoE (60 experts top-4, padded to 64, plus 4 shared) and
DBRX (16 experts top-4).

A packed expert stack runs the SWIS matmul kernel's expert-axis launch
(:func:`repro_torch.kernels.ops.swis_matmul_experts`): one launch a stack,
reading only the packed bytes, where the reference dequantizes the stack
and runs an einsum. As in the reference, ``keep_slices`` never applies to
the experts, routed or shared (the reference's ``_quant`` dequantizes
every plane), so a speculative draft truncates the attention GEMMs only.
Router math in fp32. The reference's expert-parallel sharding annotations
have no counterpart on one card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.core.qat import maybe_quant
from repro_torch.models.layers import _act, is_packed, packed_weight
from repro_torch.models.params import P


def _expert_dff(cfg: ArchConfig) -> int:
    return cfg.moe.d_ff_expert or cfg.d_ff


def build_moe(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    e = cfg.moe.e_total  # includes EP-divisibility padding
    f = _expert_dff(cfg)
    p = {
        "router": P((d, e), ("embed", "expert"), scale=0.02),
        "wi": P((e, d, f), ("expert", "embed", "mlp")),
        "wo": P((e, f, d), ("expert", "mlp", "embed")),
    }
    if cfg.glu:
        p["wg"] = P((e, d, f), ("expert", "embed", "mlp"))
    if cfg.moe.n_shared:
        fs = f * cfg.moe.n_shared
        p["shared_wi"] = P((d, fs), ("embed", "mlp"))
        p["shared_wo"] = P((fs, d), ("mlp", "embed"))
        if cfg.glu:
            p["shared_wg"] = P((d, fs), ("embed", "mlp"))
    return p


def _experts(x: torch.Tensor, w, cfg: ArchConfig) -> torch.Tensor:
    """Every expert's GEMM: x (E, M, K) — a stride-0 expert axis when all
    experts read the same rows — against the stack w (E, K, N), -> (E, M,
    N) in x's dtype. Packed: one SWIS expert-axis launch, all planes."""
    if is_packed(w):
        return ops.swis_matmul_experts(
            x, w, consecutive=cfg.quant.cfg.method == "swis_c").to(x.dtype)
    # each expert matrix quantized on its own, as the reference's vmap
    w = maybe_quant(w, cfg.quant.cfg, cfg.quant.mode, stacked=True)
    return torch.matmul(x, w.to(x.dtype))


def _shared(x: torch.Tensor, w, cfg: ArchConfig) -> torch.Tensor:
    """A shared expert's GEMM (2-D weight), all planes when packed."""
    if is_packed(w):
        return ops.swis_matmul(x, packed_weight(w, cfg)).to(x.dtype)
    w = maybe_quant(w, cfg.quant.cfg, cfg.quant.mode)
    return x @ w.to(x.dtype)


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, in descending
    order, ties broken toward the lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(x32: torch.Tensor, router: torch.Tensor, cfg: ArchConfig):
    """fp32 router: (probs, normalized top-k gate values, top-k expert
    indices); padded experts are unroutable."""
    mc = cfg.moe
    logits = x32 @ router.float()
    if mc.e_total > mc.n_experts:
        logits[..., mc.n_experts:] = -1e30
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = _top_k(probs, mc.top_k)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)
    return probs, gate_vals, gate_idx


def _add_shared(p: dict, x: torch.Tensor, y: torch.Tensor,
                cfg: ArchConfig) -> torch.Tensor:
    if "shared_wi" not in p:
        return y
    hs = _act(_shared(x, p["shared_wi"], cfg), cfg.act)
    if "shared_wg" in p:
        hs = hs * _shared(x, p["shared_wg"], cfg)
    return y + _shared(hs, p["shared_wo"], cfg)


def moe_apply(p: dict, x: torch.Tensor, cfg: ArchConfig):
    """x: (B, S, D) -> (y, {"moe_aux": scalar})."""
    mc = cfg.moe
    b, s, d = x.shape
    e, e_total, k = mc.n_experts, mc.e_total, mc.top_k
    dt = x.dtype
    tokens = x.reshape(-1, d)
    t = tokens.shape[0]

    if s == 1:
        # Decode: dropless dense dispatch over every expert (capacity
        # dropping at decode token counts would diverge from training).
        _, gate_vals, gate_idx = _route(tokens.float(), p["router"], cfg)
        comb = torch.zeros((t, e_total), dtype=torch.float32,
                           device=x.device).scatter_add_(1, gate_idx, gate_vals)
        xe = tokens.contiguous()[None].expand(e_total, t, d)  # shared rows
        h = _act(_experts(xe, p["wi"], cfg), cfg.act)  # (E, t, f)
        if "wg" in p:
            h = h * _experts(xe, p["wg"], cfg)
        ye = _experts(h, p["wo"], cfg)  # (E, t, d)
        y = torch.einsum("te,etd->td", comb.to(dt), ye)
        y = _add_shared(p, tokens, y, cfg)
        return y.reshape(b, s, d), {
            "moe_aux": torch.zeros((), dtype=torch.float32, device=x.device)}

    gs = min(mc.group_tokens, t)
    if t % gs:
        gs = t  # fall back to one group (smoke-scale inputs)
    g = t // gs
    xt = tokens.reshape(g, gs, d)

    # --- router (fp32) ---
    probs, gate_vals, gate_idx = _route(xt.float(), p["router"], cfg)

    # --- capacity + position bookkeeping (GShard) ---
    cap = max(int(gs * k * mc.capacity_factor / e), 1)
    onehot = F.one_hot(gate_idx, e_total).float()  # (g, gs, k, E)
    # priority: the k-th choice of earlier tokens first
    flat = onehot.permute(0, 2, 1, 3).reshape(g, k * gs, e_total)
    pos = torch.cumsum(flat, dim=1) - flat  # position within the expert
    flat = flat * (pos < cap)
    # a dropped choice (pos >= cap) has flat 0: clamping its position
    # changes nothing, and one_hot needs it in range
    pos_oh = (F.one_hot(pos.long().clamp_max(cap - 1), cap).float()
              * flat[..., None])
    pos_oh = pos_oh.reshape(g, k, gs, e_total, cap).permute(0, 2, 1, 3, 4)
    combine = (gate_vals[..., None, None] * pos_oh).sum(dim=2)  # (g, gs, E, cap)
    dispatch = (combine > 0).to(dt)

    # --- expert computation: each expert's g * cap rows ---
    xd = torch.einsum("gsec,gsd->egcd", dispatch, xt).reshape(
        e_total, g * cap, d)
    h = _act(_experts(xd, p["wi"], cfg), cfg.act)
    if "wg" in p:
        h = h * _experts(xd, p["wg"], cfg)
    yo = _experts(h, p["wo"], cfg).reshape(e_total, g, cap, d)
    y = torch.einsum("gsec,egcd->gsd", combine.to(dt), yo)
    y = _add_shared(p, xt, y, cfg)

    # --- aux load-balancing loss (Switch-style) ---
    density = flat.reshape(g, k, gs, e_total).sum(dim=(1, 2)) / gs
    router_prob = probs.mean(dim=1)  # (g, E)
    aux = (density * router_prob).sum(-1).mean() * e
    return y.reshape(b, s, d), {"moe_aux": aux}
