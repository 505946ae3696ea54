"""Collectives over one mesh axis, for the sharded model's local regions.

Each is a functional collective (``torch.ops._c10d_functional``), so the
dry-run's tracer sees every one with its kind, size and group, on NCCL, on
gloo and under the fake process group alike. The autograd functions are
the tensor-parallel pair of operators:

* :func:`copy_to` — identity forward, all-reduce backward: where a
  replicated activation enters a region whose ranks compute different
  parts (the gradients they send back are partial sums);
* :func:`reduce_from` — all-reduce forward, identity backward: where the
  ranks' partial results leave such a region;
* :func:`gather_from` — all-gather forward, the rank's own slice backward:
  where the shards of an activation are gathered for computation that
  every rank then repeats (its gradient is the same on every rank).

On an axis of one rank each is the identity and issues nothing.

:class:`Local` tells the model's layers that their parameters are local
shards, and along which dim each is split; the layers then run the
tensor-parallel regions above. Without it (``shard=None``) every helper
here is the identity, so the unsharded forward runs the same code.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

_F = torch.ops._c10d_functional


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as seen by this rank: its process group's name, its
    size and this rank's coordinate along it."""

    group: str
    size: int
    rank: int

    @classmethod
    def of(cls, mesh, name: str) -> "Axis":
        if name not in (mesh.mesh_dim_names or ()):
            return cls("", 1, 0)
        pg = mesh.get_group(name)
        return cls(pg.group_name, pg.size(), mesh.get_local_rank(name))


def all_reduce(x: torch.Tensor, ax: Axis, op: str = "sum") -> torch.Tensor:
    """All-reduce with no gradient of its own (``op``: sum, max, ...)."""
    if ax.size == 1:
        return x
    return _F.wait_tensor(_F.all_reduce(x.contiguous(), op, ax.group))


def all_gather(x: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    """The axis's shards of ``x`` concatenated along ``dim``."""
    if ax.size == 1:
        return x
    dim = dim % x.ndim
    y = _F.wait_tensor(_F.all_gather_into_tensor(
        x.movedim(dim, 0).contiguous(), ax.size, ax.group))
    return y.movedim(0, dim)


def own_slice(x: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    """This rank's contiguous 1/size of ``x`` along ``dim``."""
    if ax.size == 1:
        return x
    n = x.shape[dim] // ax.size
    return x.narrow(dim, ax.rank * n, n)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.ax), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return all_reduce(x, ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return all_gather(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        return own_slice(g, ctx.ax, ctx.dim).contiguous(), None, None


def copy_to(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    return x if ax.size == 1 else _CopyTo.apply(x, ax)


def reduce_from(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    return x if ax.size == 1 else _ReduceFrom.apply(x, ax)


def gather_from(x: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    return x if ax.size == 1 else _GatherFrom.apply(x, ax, dim)


NO_AXIS = Axis("", 1, 0)  # the unsharded model's axis: every op here a no-op

COL, ROW, EXP = -1, -2, -3  # a GEMM weight's (..., E, K, N) dims


@dataclasses.dataclass(frozen=True)
class Local:
    """A block's parameters as local shards on the model axis ``tp``:
    ``split`` is a tree like the parameters' whose leaves give the dim
    (counted from the end, ``COL``, ``ROW`` or ``EXP`` for a GEMM weight)
    that ``tp`` splits, or None; ``cache`` is the same for the block's
    cache. A packed weight's entry is its sign plane's split, read as a
    dense weight's. ``batch_ranks``: the ranks the batch rows are split
    over (each holds its own rows)."""

    tp: Axis
    split: dict
    cache: Optional[dict] = None
    batch_ranks: int = 1

    def __getitem__(self, key: str) -> "Local":
        return dataclasses.replace(self, split=self.split[key])


def axis_of(shard: Optional[Local]) -> Axis:
    return NO_AXIS if shard is None else shard.tp


def split_at(shard: Optional[Local], *path: str):
    """The split of the leaf at ``path`` of ``shard``'s tree (None when
    ``shard`` is None)."""
    if shard is None:
        return None
    node = shard.split
    for key in path:
        node = node[key]
    return node


def down(h: torch.Tensor, split_in, split_out, gemm: Callable,
         ax: Axis):
    """The output GEMM of a hidden layer whose input GEMMs split as
    ``split_in``: (output, whether it is a partial sum over ``ax``). A
    row-split weight reads this rank's columns of ``h``; a replicated one
    reads them all, gathered."""
    if split_out == ROW:
        if split_in != COL:  # keep the rows of this rank's shard
            h = own_slice(copy_to(h, ax), ax, -1)
        return gemm(h), True
    if split_in == COL:
        h = gather_from(h, ax, -1)
    return gemm(h), False
