"""Logical-axis sharding rules (DP / FSDP / TP / SP / EP), PyTorch port of
``repro.parallel.sharding``.

Model code tags parameters and activations with *logical* axis names; a
:class:`Rules` instance maps them to mesh axes with the reference's
divisibility fallback (an axis that does not divide the dimension is
dropped rather than erroring — e.g. 8 KV heads on a 16-way model axis fall
back to replication and the KV cache picks up sequence sharding instead).

Default mapping (single-pod mesh ('data','model') / multi-pod
('pod','data','model')):

  batch            -> ('pod','data')   pure DP across pods
  vocab/heads/mlp/
  q_proj/kv_proj   -> 'model'          tensor parallelism
  expert           -> 'model'          expert parallelism (divisible MoE)
  seq              -> 'model'          sequence parallelism between blocks
  kv_seq           -> 'model'          decode KV-cache sharding
  embed/layers/...  -> replicated

FSDP: optimizer state (and optionally params) are additionally sharded over
'data' on the first still-unsharded divisible dimension (ZeRO-style).

A spec is a plain tuple with one entry per tensor dim: ``None``, a mesh-axis
name, or a tuple of names (``("pod", "data")``), so it compares entry for
entry with the reference's ``PartitionSpec``. :func:`placements` turns a
spec into ``DTensor`` placements over a ``DeviceMesh``: a tensor dim over
two mesh axes is ``Shard(d)`` on both, the major axis first, which is the
order ``PartitionSpec`` splits in. The spec logic reads only
``mesh.shape`` as a dict of axis sizes (or a ``DeviceMesh``'s named dims),
so it runs without any process group.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.models.params import P, tree_map

DEFAULT_MAPPING = {
    "batch": ("pod", "data"),
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "q_proj": ("model",),
    "kv_proj": ("model",),
    "mlp": ("model",),
    "mlp2": None,
    "expert": ("model",),
    "seq": ("model",),
    "kv_seq": ("model",),
    "embed": None,
    "embed2": None,
    "head_dim": None,
    "layers": None,
}


def mesh_axes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` (its named dims) or of any
    object whose ``.shape`` is such a dict."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def placements(spec, mesh):
    """``DTensor`` placements over ``mesh`` for ``spec``: ``Shard(d)`` on
    every mesh axis that tensor dim d names, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for name in ((entry,) if isinstance(entry, str) else entry):
            out[names.index(name)] = Shard(d)
    return tuple(out)


@dataclasses.dataclass
class Rules:
    mesh: object
    mapping: dict
    fsdp_axis: str = "data"

    @classmethod
    def for_arch(cls, mesh, cfg: Optional[ArchConfig] = None,
                 overrides: Optional[dict] = None) -> "Rules":
        mapping = dict(DEFAULT_MAPPING)
        if cfg is not None and not cfg.parallel.sp:
            mapping["seq"] = None
        if overrides:
            mapping.update(overrides)
        return cls(mesh=mesh, mapping=mapping)

    # ------------------------------------------------------------------

    def _axis_size(self, name: str) -> int:
        return int(mesh_axes(self.mesh).get(name, 0))

    def spec_for(self, axes, shape) -> tuple:
        """Logical axes -> spec tuple with divisibility fallback."""
        used = set()
        out = []
        for dim, ax in zip(shape, axes):
            entry = self.mapping.get(ax) if ax is not None else None
            if entry is None:
                out.append(None)
                continue
            names = (entry,) if isinstance(entry, str) else tuple(entry)
            names = [n for n in names if self._axis_size(n) and n not in used]
            total = int(np.prod([self._axis_size(n) for n in names])) if names else 0
            if not names or dim % max(total, 1):
                # try progressively smaller prefixes (e.g. drop 'pod')
                while names and dim % int(np.prod([self._axis_size(n) for n in names])):
                    names = names[:-1]
            if not names:
                out.append(None)
                continue
            used.update(names)
            out.append(tuple(names) if len(names) > 1 else names[0])
        return tuple(out)

    def sharding_for(self, axes, shape):
        """``DTensor`` placements of a tensor with these logical axes."""
        return placements(self.spec_for(axes, shape), self.mesh)

    def constrain(self, x, logical_axes):
        if len(logical_axes) != x.ndim:
            raise ValueError(f"axes {logical_axes} vs shape {tuple(x.shape)}")
        from torch.distributed.tensor import DTensor

        if not isinstance(x, DTensor):
            return x
        want = self.sharding_for(logical_axes, x.shape)
        if tuple(x.placements) == want:
            return x
        return x.redistribute(x.device_mesh, want)

    # ------------------------------------------------------------------

    def param_specs(self, tree, fsdp: bool = False):
        """Spec tree for a placeholder tree."""

        def one(p: P):
            spec = self.spec_for(p.axes, p.shape)
            if fsdp:
                spec = self._fsdp_spec(spec, p.shape)
            return spec

        return tree_map(one, tree)

    def param_shardings(self, tree, fsdp: bool = False):
        """Placements tree for a placeholder tree."""
        return tree_map(lambda s: placements(s, self.mesh),
                        self.param_specs(tree, fsdp=fsdp))

    def _fsdp_spec(self, spec: tuple, shape) -> tuple:
        """Shard the first unsharded divisible dim over the data axis."""
        n = self._axis_size(self.fsdp_axis)
        if not n:
            return spec
        used = set()
        for e in spec:
            if e is None:
                continue
            used.update((e,) if isinstance(e, str) else e)
        if self.fsdp_axis in used:
            return spec
        entries = list(spec)
        best = -1
        for i, (dim, e) in enumerate(zip(shape, entries)):
            if e is None and dim % n == 0 and dim >= n:
                if best < 0 or shape[i] > shape[best]:
                    best = i
        if best < 0:
            return spec
        entries[best] = self.fsdp_axis
        return tuple(entries)

    # ------------------------------------------------------------------

    def batch_specs(self, batch_tree):
        """Input-batch specs: the leading dim is the (global) batch."""

        def one(x):
            shape = x.shape
            axes = ("batch",) + (None,) * (len(shape) - 1)
            return self.spec_for(axes, shape)

        return tree_map(one, batch_tree)

    def batch_shardings(self, batch_tree):
        """Placements tree of :meth:`batch_specs`."""
        return tree_map(lambda s: placements(s, self.mesh),
                        self.batch_specs(batch_tree))

    def replicated(self):
        """The replicated placements over the mesh (spec ``()``)."""
        return placements((), self.mesh)

