"""The model's parameters, batch and cache on a mesh, as the local shards
that ``Model.apply`` and ``Model.loss`` compute on when the active rules'
parameters are ``DTensor``s.

Each rank computes on its local shards, Megatron-style: the layers
(``models.layers``, ``attention``, ``moe``, ``transformer``) take a
:class:`repro_torch.parallel.comm.Local` that says which dim of each local
leaf the ``model`` axis splits, and run the collectives of
:mod:`repro_torch.parallel.comm` over that axis. The loss is reduced over
the batch axes (``pod``, ``data``). The residual stream between blocks is
a ``DTensor`` (rows over the batch axes, see :func:`residual`) that goes
through ``constrain(x, ("batch", "seq", "embed"))`` at the reference's
places, so with sequence parallelism it is held split over ``model``
between blocks and gathered as a block starts (:func:`enter`).

Here: :func:`localize` turns the parameter tree into local shards and
their splits (FSDP shards gathered; the leaves of one packed weight first
brought to one common split, since the SWIS kernel reads the planes,
shifts and scale of one shard), :func:`localize_cache` does the same for a
cache, and the helpers of the recurrent kinds, which run whole on every
rank, gather their weights and state and write the state back.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import params as pp
from repro_torch.models.layers import is_packed
from repro_torch.parallel import comm
from repro_torch.parallel.comm import COL, EXP, ROW, Axis, Local
from repro_torch.parallel.ctx import active_rules, constrain

BATCH_AXES = ("pod", "data")

# dim (counted from the end) of each packed leaf's K, N and expert axes
_PACKED_DIMS = {"sign_plane": (-2, -1, -3), "mask_planes": (-2, -1, -4),
                "shifts": (-3, -2, -4), "scale": (None, -1, -3)}


@dataclasses.dataclass
class Env:
    mesh: object
    tp: Axis
    batch: tuple  # Axis of each batch mesh axis present
    batch_dims: tuple  # their mesh-dim indices
    model_dim: Optional[int]

    @classmethod
    def of(cls, mesh) -> "Env":
        names = tuple(mesh.mesh_dim_names)
        bd = tuple(i for i, n in enumerate(names) if n in BATCH_AXES)
        return cls(mesh, Axis.of(mesh, "model"),
                   tuple(Axis.of(mesh, names[i]) for i in bd), bd,
                   names.index("model") if "model" in names else None)


def env_of(params) -> Optional[Env]:
    """The mesh of ``params`` when it holds ``DTensor`` leaves under
    active rules, else None (the unsharded model)."""
    from torch.distributed.tensor import DTensor

    rules = active_rules()
    if rules is None:
        return None
    leaf = params
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return Env.of(rules.mesh) if isinstance(leaf, DTensor) else None


def check_modes(cfg: ArchConfig, *, block_tables, attend_cache, paged,
                q_lens):
    """What a sharded forward does not run: the engine's modes (the
    reference's engine has no mesh), and quantization inside the layers
    (the train step quantizes the whole tree once a step)."""
    if block_tables is not None or attend_cache or paged or q_lens is not None:
        raise NotImplementedError(
            "block tables, cached-prefix prefill, the paged kernel and the "
            "fused step are not sharded (the engine has no mesh)")
    if cfg.quant.mode != "off" or cfg.quant.act_shifts \
            or cfg.quant.quantize_embeddings:
        raise NotImplementedError(
            "a sharded forward quantizes no weight or activation itself: "
            "the train step quantizes the whole tree once a step "
            "(core.qat.quantize_tree with parallel.quant.fake_quant_dtensor)")


def _model_dim(t, env: Env):
    """The tensor dim (negative) that ``t``'s placement on the model axis
    shards, or None."""
    if env.model_dim is None:
        return None
    pl = t.placements[env.model_dim]
    return pl.dim - t.ndim if pl.is_shard() else None


def _tp_only(t, env: Env):
    """``t`` with its batch-axis shards (FSDP) gathered."""
    from torch.distributed.tensor import Replicate

    pls = list(t.placements)
    if not any(pls[i].is_shard() for i in env.batch_dims):
        return t
    for i in env.batch_dims:
        pls[i] = Replicate()
    return t.redistribute(t.device_mesh, tuple(pls))


def _local_leaf(t, env: Env):
    """A parameter ``DTensor`` as its local shard. Each batch rank
    differentiates its own rows, so the gradient is partial over the batch
    axes."""
    from torch.distributed.tensor import Partial

    t = _tp_only(t, env)
    grad = tuple(Partial() if i in env.batch_dims else pl
                 for i, pl in enumerate(t.placements))
    return t.to_local(grad_placements=grad)


def _common_split(leaf: dict, env: Env) -> dict:
    """The leaves of one packed weight, each replicated over the model
    axis unless all of them split it along the same logical axis (K, N or
    experts): the kernel reads the planes, shifts and scale of one
    shard."""
    from torch.distributed.tensor import Replicate

    dims = {k: _model_dim(v, env) for k, v in leaf.items()}
    for which in range(3):
        if all(dims[k] == _PACKED_DIMS[k][which] for k in leaf
               if _PACKED_DIMS[k][which] is not None) and \
                any(d is not None for d in dims.values()):
            return leaf
    if all(d is None for d in dims.values()):
        return leaf
    out = {}
    for k, v in leaf.items():
        pls = list(v.placements)
        pls[env.model_dim] = Replicate()
        out[k] = v.redistribute(v.device_mesh, tuple(pls))
    return out


def localize(params, env: Env):
    """(local tree, split tree): each leaf's local shard, and beside it the
    dim (counted from the end) that the model axis splits, or None. A
    packed leaf's split is its sign plane's, whose (E, K/32, N) dims count
    as a dense weight's: ``COL`` (N), ``ROW`` (K), ``EXP`` (experts)."""
    if is_packed(params):
        leaf = _common_split(params, env)
        return ({k: _local_leaf(v, env) for k, v in leaf.items()},
                _model_dim(leaf["sign_plane"], env))
    if isinstance(params, dict):
        pairs = {k: localize(v, env) for k, v in params.items()}
        return ({k: a for k, (a, _) in pairs.items()},
                {k: b for k, (_, b) in pairs.items()})
    return _local_leaf(params, env), _model_dim(params, env)


def localize_cache(cache, env: Env):
    """(local tree, split tree) of a cache: its leaves' local tensors (the
    layers write them in place; rows stay split over the batch axes) and
    their model-split dims."""
    from torch.distributed.tensor import DTensor

    if isinstance(cache, dict):
        pairs = {k: localize_cache(v, env) for k, v in cache.items()}
        return ({k: a for k, (a, _) in pairs.items()},
                {k: b for k, (_, b) in pairs.items()})
    if not isinstance(cache, DTensor):
        return cache, None
    return cache.to_local(), _model_dim(cache, env)


def local_batch(batch: dict) -> dict:
    from torch.distributed.tensor import DTensor

    return {k: v.to_local() if isinstance(v, DTensor) else v
            for k, v in batch.items()}


def gather_params(p, split, ax: Axis):
    """Local parameters with every model-split leaf gathered."""
    if is_packed(p):
        if split is None:
            return p
        which = {ROW: 0, COL: 1, EXP: 2}[split]
        return {k: comm.gather_from(v, ax, _PACKED_DIMS[k][which])
                if _PACKED_DIMS[k][which] is not None else v
                for k, v in p.items()}
    if isinstance(p, dict):
        return {k: gather_params(v, split[k], ax) for k, v in p.items()}
    return comm.gather_from(p, ax, split) if split is not None else p


def gather_cache(cache: dict, shard: Local) -> dict:
    """A block's local cache with every model-split leaf gathered."""
    return {k: comm.all_gather(v, shard.tp, shard.cache[k])
            if shard.cache[k] is not None else v for k, v in cache.items()}


def scatter_cache(cache: dict, full: dict, shard: Local) -> None:
    """Write ``full``, a block's whole new state, into its local cache."""
    for k, t in cache.items():
        if shard.cache[k] is not None:
            t.copy_(comm.own_slice(full[k], shard.tp, shard.cache[k]))
        elif t is not full[k]:
            t.copy_(full[k])


def contiguous_stride(shape):
    """The strides of a contiguous tensor of ``shape``."""
    stride, acc = [], 1
    for d in reversed(shape):
        stride.append(acc)
        acc *= d
    return tuple(reversed(stride))


def residual(x, like, env: Env):
    """Local rows -> the residual ``DTensor`` (rows over the batch axes as
    ``like``, the batch input, is split; replicated over model), under the
    rules' ``("batch", "seq", "embed")`` constraint."""
    from torch.distributed.tensor import DTensor, Replicate

    pls = tuple(like.placements[i] if i in env.batch_dims else Replicate()
                for i in range(len(like.placements)))
    shape = (like.shape[0],) + tuple(x.shape[1:])
    return constrain(DTensor.from_local(x, env.mesh, pls, shape=shape,
                                        stride=contiguous_stride(shape)),
                     ("batch", "seq", "embed"))


def enter(x, env: Env):
    """The residual ``DTensor`` as local rows, whole over the model axis."""
    from torch.distributed.tensor import Replicate

    if env.model_dim is not None and not isinstance(
            x.placements[env.model_dim], Replicate):
        pls = list(x.placements)
        pls[env.model_dim] = Replicate()
        x = x.redistribute(x.device_mesh, tuple(pls))
    return x.to_local()


def sum_batch(t: torch.Tensor, env: Optional[Env]) -> torch.Tensor:
    """``t`` summed over the batch axes (``t`` itself unsharded)."""
    for ax in (env.batch if env is not None else ()):
        t = comm.reduce_from(t, ax)
    return t


def split_vocab_ll(logits, labels, ax: Axis):
    """(log-likelihood of each label, whether it is the row's argmax) from
    logits split over the vocab: the log-normalizer and the label's logit
    are all-reduced over ``ax``, and a prediction counts as right when the
    label's logit is the row's maximum (argmax breaks ties toward the
    lower index)."""
    v_l = logits.shape[-1]
    lo = ax.rank * v_l
    mine = (labels >= lo) & (labels < lo + v_l)
    with torch.no_grad():
        m = comm.all_reduce(logits.amax(dim=-1), ax, "max")
    sumexp = comm.reduce_from(torch.exp(logits - m[..., None]).sum(dim=-1),
                              ax)
    picked = comm.reduce_from(torch.gather(
        logits, -1, (labels - lo).clamp(0, v_l - 1)[..., None])[..., 0]
        * mine, ax)
    return picked - m - torch.log(sumexp), picked.detach() >= m
