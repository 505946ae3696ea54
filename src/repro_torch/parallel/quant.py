"""SWIS fake-quant of ``DTensor`` weights, the hoisted QAT step on a mesh.

SWIS scales each matrix by its whole-tensor max (``per_channel=False``,
the default) and selects shifts per group of ``group_size`` along K. So a
shard is quantized on its own rank, bit for bit as the whole matrix would
be, once its amax is all-reduced (MAX) over the mesh axes that split the
matrix, provided that a K split leaves whole groups and that no column
schedule (fractional ``n_shifts``) ranks columns another rank holds. A
leaf that does not meet that is gathered, quantized whole, and split
again. The train step on a mesh quantizes its tree with
``core.qat.quantize_tree(params, qcfg, quant=fake_quant_dtensor)``.
"""
from __future__ import annotations

import torch

from repro_torch.core.swis import QuantConfig, fake_quant, fake_quant_stack
from repro_torch.parallel.comm import Axis, all_reduce


def _splits(t):
    """{tensor dim: mesh dim index} of ``t``'s shards."""
    return {pl.dim: i for i, pl in enumerate(t.placements) if pl.is_shard()}


def fake_quant_dtensor(w, cfg: QuantConfig, stacked: bool):
    """:func:`fake_quant` (``stacked``: :func:`fake_quant_stack`) of a
    ``DTensor``, equal to the whole tensor's result on every shard."""
    from torch.distributed.tensor import DTensor, Replicate

    fn = fake_quant_stack if stacked else fake_quant
    mesh = w.device_mesh
    lead = 1 if stacked else 0  # the reduction (K) axis
    splits = _splits(w)
    m = cfg.group_size
    _, n_hi, frac = cfg.shift_levels()
    local_ok = lead not in splits or (w.shape[lead] % m == 0 and (
        w.shape[lead] // mesh.size(splits[lead])) % m == 0)
    # a column schedule ranks every column of a matrix by its cost summed
    # over all of its groups
    local_ok = local_ok and (frac == 0.0 or not cfg.schedule or not any(
        d >= lead for d in splits))
    if not local_ok:
        whole = w.redistribute(mesh, (Replicate(),) * mesh.ndim)
        out = fn(whole.to_local(), cfg)
        return DTensor.from_local(out, mesh, whole.placements).redistribute(
            mesh, w.placements)
    # the dims the amax runs over: all of each matrix, or K (per channel)
    reduced = ({lead} if cfg.per_channel
               else set(range(lead, w.ndim)))
    axes = [Axis.of(mesh, mesh.mesh_dim_names[i])
            for d, i in splits.items() if d in reduced]

    def reduce_amax(amax):
        for ax in axes:
            amax = all_reduce(amax, ax, "max")
        return amax

    out = fn(w.to_local(), cfg, reduce_amax=reduce_amax if axes else None)
    return DTensor.from_local(out, mesh, w.placements, shape=w.shape,
                              stride=w.stride())
