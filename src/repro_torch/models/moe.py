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
Router math in fp32. On a mesh (``shard``, :class:`repro_torch.parallel.
comm.Local`) every rank routes every token (a router split over experts is
gathered), then runs its local experts (experts over ``model``) or its
slice of every expert's hidden units, and one all-reduce combines them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.core.qat import maybe_quant
from repro_torch.models.layers import _act, is_packed, packed_weight
from repro_torch.models.params import P
from repro_torch.parallel import comm


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


def _route(x: torch.Tensor, router: torch.Tensor, cfg: ArchConfig,
           shard=None):
    """fp32 router: (probs, normalized top-k gate values, top-k expert
    indices); padded experts are unroutable."""
    if comm.split_at(shard, "router") is None:
        return route_logits(x.float() @ router.float(), cfg)
    ax = shard.tp
    # a copy: routing masks padded experts in place
    return route_logits(comm.gather_from(
        comm.copy_to(x, ax).float() @ router.float(), ax, -1).clone(), cfg)


def route_logits(logits: torch.Tensor, cfg: ArchConfig):
    """:func:`_route` from the fp32 router logits."""
    mc = cfg.moe
    if mc.e_total > mc.n_experts:
        logits[..., mc.n_experts:] = -1e30
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = _top_k(probs, mc.top_k)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)
    return probs, gate_vals, gate_idx


def _add_shared(p: dict, x: torch.Tensor, y: torch.Tensor,
                cfg: ArchConfig, shard=None) -> torch.Tensor:
    if "shared_wi" not in p:
        return y
    split_in = comm.split_at(shard, "shared_wi")
    split_out = comm.split_at(shard, "shared_wo")
    ax = comm.axis_of(shard)
    if split_in is not None or split_out is not None:
        x = comm.copy_to(x, ax)
    hs = _act(_shared(x, p["shared_wi"], cfg), cfg.act)
    if "shared_wg" in p:
        hs = hs * _shared(x, p["shared_wg"], cfg)
    ys, partial = comm.down(hs, split_in, split_out,
                            lambda t: _shared(t, p["shared_wo"], cfg), ax)
    return y + (comm.reduce_from(ys, ax) if partial else ys)


def moe_apply(p: dict, x: torch.Tensor, cfg: ArchConfig, shard=None):
    """x: (B, S, D) -> (y, {"moe_aux": scalar})."""
    mc = cfg.moe
    b, s, d = x.shape
    e_total = mc.e_total
    dt = x.dtype
    tokens = x.reshape(-1, d)
    t = tokens.shape[0]
    ax = comm.axis_of(shard)
    split_in, split_out = (comm.split_at(shard, "wi"),
                           comm.split_at(shard, "wo"))
    exp = split_in == comm.EXP  # local experts, else local hidden units
    if exp != (split_out == comm.EXP):
        raise NotImplementedError(f"expert split {split_in}, {split_out}")
    xin = (comm.copy_to(tokens, ax)
           if split_in is not None or split_out is not None else tokens)

    def experts(xe):
        """(output (E_local, M, D), whether it is a partial sum)."""
        h = _act(_experts(xe, p["wi"], cfg), cfg.act)
        if "wg" in p:
            h = h * _experts(xe, p["wg"], cfg)
        if exp:
            return _experts(h, p["wo"], cfg), True
        return comm.down(h, split_in, split_out,
                         lambda t: _experts(t, p["wo"], cfg), ax)

    def mine(w, dim):
        """The routing weights of the experts this rank computes."""
        return comm.own_slice(comm.copy_to(w, ax), ax, dim) if exp else w

    if s == 1:
        # Decode: dropless dense dispatch over every expert (capacity
        # dropping at decode token counts would diverge from training).
        _, gate_vals, gate_idx = _route(tokens, p["router"], cfg, shard)
        comb = mine(torch.zeros((t, e_total), dtype=torch.float32,
                                device=x.device).scatter_add_(
                                    1, gate_idx, gate_vals), 1)
        # every expert reads the same rows
        ye, partial = experts(xin.contiguous()[None].expand(
            comb.shape[1], t, d))
        if partial and not exp:
            comb = comm.copy_to(comb, ax)
        y = torch.einsum("te,etd->td", comb.to(dt), ye)
        if partial:
            y = comm.reduce_from(y, ax)
        y = _add_shared(p, tokens, y, cfg, shard)
        return y.reshape(b, s, d), {
            "moe_aux": torch.zeros((), dtype=torch.float32, device=x.device)}

    if shard is not None and shard.batch_ranks > 1 and t % mc.group_tokens:
        # a rank groups its own rows: the global grouping only when its
        # tokens make whole groups
        raise NotImplementedError(
            f"{t} tokens a rank do not make whole dispatch groups of "
            f"{mc.group_tokens} tokens: a group would span ranks")
    xt = group_tokens(tokens, cfg)
    g, gs = xt.shape[:2]
    probs, flat, combine, dispatch = capacity_dispatch(
        _route(xt, p["router"], cfg, shard), cfg, dt)
    cap = combine.shape[-1]
    combine = mine(combine, 2)
    if exp:
        dispatch = comm.own_slice(dispatch, ax, 2)
    e_l = combine.shape[2]

    # --- expert computation: each expert's g * cap rows ---
    xd = torch.einsum("gsec,gsd->egcd", dispatch,
                      xin.reshape(g, gs, d)).reshape(e_l, g * cap, d)
    yo, partial = experts(xd)
    if partial and not exp:
        combine = comm.copy_to(combine, ax)
    y = torch.einsum("gsec,egcd->gsd", combine.to(dt),
                     yo.reshape(e_l, g, cap, d))
    if partial:
        y = comm.reduce_from(y, ax)
    y = _add_shared(p, xt, y, cfg, shard)
    return y.reshape(b, s, d), {"moe_aux": load_balance_aux(probs, flat, cfg)}


def group_tokens(tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """(T, D) tokens as (g, gs, D) dispatch groups of ``group_tokens``
    (one group when that does not divide T)."""
    t, d = tokens.shape
    gs = min(cfg.moe.group_tokens, t)
    if t % gs:
        gs = t  # fall back to one group (smoke-scale inputs)
    return tokens.reshape(t // gs, gs, d)


def capacity_dispatch(routed, cfg: ArchConfig, dt):
    """GShard capacity bookkeeping of routed groups: ``routed`` is
    :func:`_route`'s (probs, gate values, expert indices) over (g, gs)
    tokens. Returns (probs, kept choices (g, k*gs, E), combine weights
    (g, gs, E, cap) fp32, dispatch mask (g, gs, E, cap) in ``dt``)."""
    probs, gate_vals, gate_idx = routed
    mc = cfg.moe
    e, e_total, k = mc.n_experts, mc.e_total, mc.top_k
    g, gs = gate_idx.shape[:2]
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
    return probs, flat, combine, (combine > 0).to(dt)


def load_balance_aux(probs: torch.Tensor, flat: torch.Tensor,
                     cfg: ArchConfig) -> torch.Tensor:
    """Switch-style load-balancing aux of :func:`capacity_dispatch`'s
    kept choices."""
    mc = cfg.moe
    g, gs = probs.shape[:2]
    density = flat.reshape(g, mc.top_k, gs, mc.e_total).sum(dim=(1, 2)) / gs
    router_prob = probs.mean(dim=1)  # (g, E)
    return (density * router_prob).sum(-1).mean() * mc.n_experts
