"""Basic model layers (PyTorch port of ``repro.models.layers``).

Every GEMM goes through :func:`dense`. A packed SWIS leaf runs the SWIS
matmul op (the CUDA kernel on the card); a dense leaf is a plain matmul
under the model's quantization policy, as in the reference: activation
truncation of x when ``act_shifts`` is set, then fake-quant of the weight
in modes ``qat`` (straight-through gradient) and ``ptq``.

The embedding gather's backward is deterministic (:class:`_Gather`): the
card's own backward of ``tok[tokens]`` accumulates repeated tokens with
atomics in no fixed order, and a resumed training run must repeat the
first run bit for bit.

On a mesh the appliers take ``shard`` (:class:`repro_torch.parallel.comm.
Local`): their parameters are local shards. The MLP's hidden units split
over the model axis as ``mlp`` divides (column-split ``wi``/``wg``,
row-split ``wo`` whose partial sums one all-reduce adds up); the
embedding looks up the local vocab rows, zeros elsewhere, and one
all-reduce adds them up; the unembedding writes the local vocab columns.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.packing import PackedWeight
from repro_torch.core.qat import maybe_quant
from repro_torch.core.swis import act_truncate
from repro_torch.kernels import ops
from repro_torch.models.params import P
from repro_torch.parallel import comm


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


def dense(p: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Linear layer under the model's quantization policy."""
    w = p["w"]
    if is_packed(w):
        return ops.swis_matmul(x, packed_weight(w, cfg),
                               keep_slices=cfg.quant.keep_slices).to(x.dtype)
    if cfg.quant.act_shifts:
        x = act_truncate(x, cfg.quant.act_shifts)
    w = maybe_quant(w, cfg.quant.cfg, cfg.quant.mode)
    return x @ w.to(x.dtype)


def _act(h: torch.Tensor, kind: str) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu(h) if kind == "silu" else F.gelu(h, approximate="tanh")


def mlp_apply(p: dict, x: torch.Tensor, cfg: ArchConfig,
              shard=None) -> torch.Tensor:
    split_in = comm.split_at(shard, "wi", "w")
    split_out = comm.split_at(shard, "wo", "w")
    if split_in not in (None, comm.COL) or split_out not in (None, comm.ROW):
        raise NotImplementedError(f"MLP split {split_in}, {split_out}")
    ax = comm.axis_of(shard)
    if split_in is not None or split_out is not None:
        x = comm.copy_to(x, ax)
    h = _act(dense(p["wi"], x, cfg), cfg.act)
    if cfg.glu:
        h = h * dense(p["wg"], x, cfg)
    y, partial = comm.down(h, split_in, split_out,
                           lambda t: dense(p["wo"], t, cfg), ax)
    return comm.reduce_from(y, ax) if partial else y


_GATHER_CHUNK = 8192  # positions a one-hot product of the gather's backward


class _Gather(torch.autograd.Function):
    """``table[ids]`` whose backward sums each id's rows in a fixed order:
    products of the (unique ids x positions) one-hot matrix with the
    incoming gradient, ``_GATHER_CHUNK`` positions at a time, accumulated
    in float32 and written to the unique rows."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.shape = table.shape
        return table[ids]

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        flat = ids.reshape(-1)
        g2 = g.reshape(flat.numel(), -1).float()
        uniq, inv = torch.unique(flat, return_inverse=True)
        rows = torch.zeros((uniq.numel(), g2.shape[1]), dtype=torch.float32,
                           device=g.device)
        for lo in range(0, flat.numel(), _GATHER_CHUNK):
            n = min(_GATHER_CHUNK, flat.numel() - lo)
            onehot = torch.zeros((uniq.numel(), n), dtype=torch.float32,
                                 device=g.device)
            onehot[inv[lo:lo + n], torch.arange(n, device=g.device)] = 1.0
            rows += onehot @ g2[lo:lo + n]
        grad = torch.zeros(ctx.shape, dtype=g.dtype, device=g.device)
        grad[uniq] = rows.to(g.dtype)
        return grad, None


def _gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    if torch.is_grad_enabled() and table.requires_grad \
            and table.device.type != "meta":
        return _Gather.apply(table, ids)
    return table[ids]


def embed_apply(p: dict, tokens: torch.Tensor, cfg: ArchConfig,
                shard=None) -> torch.Tensor:
    e = p["tok"]
    if cfg.quant.quantize_embeddings:
        e = maybe_quant(e, cfg.quant.cfg, cfg.quant.mode)
    dt = _dtype(cfg.compute_dtype)
    if comm.split_at(shard, "tok") is None:
        return _gather(e, tokens).to(dt)
    v_l = e.shape[0]
    ids = tokens.long() - shard.tp.rank * v_l
    inside = (ids >= 0) & (ids < v_l)
    rows = _gather(e, ids.clamp(0, v_l - 1)) * inside[..., None]
    return comm.reduce_from(rows.to(dt), shard.tp)


def unembed_apply(p: dict, x: torch.Tensor, cfg: ArchConfig, shard=None,
                  gather_vocab: bool = True) -> torch.Tensor:
    """Logits in fp32; on a vocab-split mesh this rank's vocab columns,
    gathered unless ``gather_vocab`` is False."""
    if cfg.tie_embeddings:
        w = p["tok"].T
        split = None if comm.split_at(shard, "tok") is None else comm.COL
    else:
        w, split = p["unembed"], comm.split_at(shard, "unembed")
    if split is None:
        # a plain matmul, as the reference left it to XLA
        return (x @ w.to(x.dtype)).float()
    logits = (comm.copy_to(x, shard.tp) @ w.to(x.dtype)).float()
    return comm.gather_from(logits, shard.tp, -1) if gather_vocab else logits


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
