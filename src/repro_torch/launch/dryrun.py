"""Multi-pod dry-run of the port: trace one step of every (architecture x
input shape) on the production meshes under a fake process group, and
record per-device memory, FLOPs and collectives (PyTorch port of
``repro.launch.dryrun``).

The world is a ``torch.distributed`` group of 256 (or 512) ranks under the
``fake`` backend, whose collectives return at once and leave undefined
values: nothing computed under it is a result, only shapes and counts are.
This process is rank 0. Its state is built directly as rank-local shards
on the ``meta`` device (``DTensor.from_local`` with the global shape), so
no cell materializes a model. One step is traced under a dispatch mode
(:class:`Tracer`) that sees every op on the local shards, so its FLOPs and
bytes are rank 0's, per device as XLA's ``cost_analysis`` is, and every
functional collective with its kind, size and group. The SWIS kernel's
wrappers report each launch's FLOPs and bytes there (nothing launches on
``meta``). Records go to ``--out`` (``results/dryrun_torch``, not the
reference's ``results/dryrun``), one JSON file a cell, with the
reference's keys.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-moe-a2.7b \
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

What the keys hold here: ``memory.argument_bytes`` the local bytes of the
step's inputs (state and batch; params, cache and tokens), ``output_bytes``
those of its outputs, ``alias_bytes`` those updated in place (the cache),
``temp_bytes`` the peak of the other tensors alive during the trace;
``cost.flops`` the FLOPs of every op (``torch.utils.flop_counter``'s
formulas, 2 M K N a SWIS launch); ``cost.bytes_accessed`` every non-view
op's inputs read and outputs written once (no fusion); ``lower_s`` the
seconds to build the state and trace, ``compile_s`` 0.0 (eager PyTorch
compiles nothing). The layers run as a Python loop, so the full-depth
trace is exact (``cost_raw_scan`` = ``cost``); ``cost_per_unit`` is
computed as the reference does, from traces at 1 and 2 pattern units,
which checks that the cost is linear in depth.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs as C
from repro_torch.configs.base import (SHAPES, ArchConfig, QuantPolicy,
                                      ShapeConfig, shape_applicable)
from repro_torch.core.swis import QuantConfig
from repro_torch.launch import roofline as RL
from repro_torch.models import params as pp
from repro_torch.models.model import Model
from repro_torch.optim import AdamW
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.parallel import ctx as par_ctx
from repro_torch.parallel.model import contiguous_stride
from repro_torch.parallel.sharding import Rules
from repro_torch.serve.quantized import pack_placeholders
from repro_torch.train.steps import TrainState, make_train_step

_F = torch.ops._c10d_functional
_COLLECTIVES = {
    _F.all_reduce.default: "all-reduce",
    _F.all_gather_into_tensor.default: "all-gather",
    _F.reduce_scatter_tensor.default: "reduce-scatter",
    _F.all_to_all_single.default: "all-to-all",
}
_VIEWS = {"view", "_unsafe_view", "t", "transpose", "permute", "expand",
          "slice", "select", "detach", "alias", "as_strided", "unsqueeze",
          "squeeze", "reshape", "unflatten", "split", "split_with_sizes",
          "chunk", "narrow", "unbind", "view_as_real", "lift_fresh",
          "_to_copy", "wait_tensor", "_wrap_tensor_autograd"}


def _group_size(name: str) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(name).size()


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class Tracer(TorchDispatchMode):
    """Counts what one rank's ops cost: FLOPs, bytes read and written,
    the collectives (kind, result bytes, group size), and the peak bytes
    of the tensors they create. Ops on ``DTensor``s are left to ``DTensor``
    first (``NotImplemented``), so only the local ops are counted."""

    def __init__(self, args=()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives = []  # (kind, result bytes, group size)
        self.kernels: Dict[str, int] = {}
        self.live = 0
        self.peak = 0
        self._refs = []
        # the arguments' storages are not temporaries
        self._seen = {id(t.untyped_storage()) for t in _local_tensors(args)}
        self._keep = [t.untyped_storage() for t in _local_tensors(args)]

    def account(self, kernel: str, flops: float, nbytes: float):
        self.flops += flops
        self.bytes += nbytes
        self.kernels[kernel] = self.kernels.get(kernel, 0) + 1

    def _track(self, t):
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)

        def gone(_, key=key, n=n, tracer=self):
            tracer.live -= n
            tracer._seen.discard(key)

        self._refs.append(weakref.ref(st, gone))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        kind = _COLLECTIVES.get(func)
        if kind is not None:
            g = _group_size(args[-1])
            r = _nbytes(out)
            self.collectives.append((kind, float(r), g))
            return out
        packet = func._overloadpacket
        if packet in self.registry:
            self.flops += float(self.registry[packet](*args, **kwargs,
                                                       out_val=out))
        name = packet.__name__
        outs = out if isinstance(out, (tuple, list)) else (out,)
        if name not in _VIEWS:  # an in-place op's output is an input
            moved = list(args) + list(kwargs.values())
            if not name.endswith("_"):
                moved += list(outs)
            self.bytes += sum(_nbytes(a) for a in moved
                              if isinstance(a, torch.Tensor))
        for o in outs:
            if isinstance(o, torch.Tensor):
                self._track(o)
        return out


# ---------------------------------------------------------------------------
# Rank-local state
# ---------------------------------------------------------------------------


def local_dtensor(shape, dtype, mesh, placements, device="meta"):
    """A ``DTensor`` of ``shape`` whose local shard (rank-local shape,
    uninitialized) is allocated on ``device`` alone, never the whole
    tensor."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    local_shape, _ = compute_local_shape_and_global_offset(
        tuple(shape), mesh, placements)
    local = torch.empty(local_shape, dtype=dtype, device=device)
    return DTensor.from_local(local, mesh, placements, shape=tuple(shape),
                              stride=contiguous_stride(tuple(shape)))


def local_tree(tree, shardings, mesh, dtype, device="meta"):
    """:func:`local_dtensor` of every placeholder of ``tree``."""
    if isinstance(tree, dict):
        return {k: local_tree(v, shardings[k], mesh, dtype, device)
                for k, v in tree.items()}
    return local_dtensor(tree.shape, tree.dtype or dtype, mesh, shardings,
                         device)


def _local_tensors(trees):
    """The local tensors of nested dicts, tuples, train states and
    ``DTensor``s."""
    from torch.distributed.tensor import DTensor

    stack = list(trees)
    while stack:
        t = stack.pop()
        if isinstance(t, dict):
            stack.extend(t.values())
        elif isinstance(t, (tuple, list)):
            stack.extend(t)
        elif isinstance(t, TrainState):
            stack.extend([t.step, t.params, t.opt])
        elif isinstance(t, DTensor):
            yield t.to_local()
        elif isinstance(t, torch.Tensor):
            yield t


def _arg_bytes(*trees) -> int:
    return sum(_nbytes(t) for t in _local_tensors(trees))


def _active_params(cfg: ArchConfig, tree) -> float:
    """Parameter count weighted by MoE activation fraction."""
    total = 0.0

    def walk(path, node):
        nonlocal total
        if isinstance(node, dict):
            for k, v in node.items():
                walk(path + (k,), v)
            return
        n = float(np.prod(node.shape))
        keys = "/".join(path)
        if cfg.moe is not None and any(
                k in keys for k in ("/wi", "/wo", "/wg")) and "shared" not in keys \
                and "moe" in keys:
            n *= cfg.moe.top_k / cfg.moe.n_experts
        total += n

    walk((), tree)
    return total


# ---------------------------------------------------------------------------
# One cell
# ---------------------------------------------------------------------------


def cell_cfg(cfg: ArchConfig, shape: ShapeConfig, quant: str,
             qcfg: QuantConfig) -> ArchConfig:
    """The model config a cell traces: a train cell's QAT policy
    (``quant`` "qat", or "off"); a serving cell with sequence parallelism
    off, as the reference serves with plain TP (one all-reduce a block)."""
    if shape.kind == "train":
        return cfg.replace(quant=QuantPolicy(
            cfg=qcfg, mode="qat" if quant == "qat" else "off"))
    if cfg.parallel.sp:
        cfg = cfg.replace(parallel=dataclasses.replace(cfg.parallel,
                                                       sp=False))
    return cfg


def build_step(model_cfg: ArchConfig, shape: ShapeConfig, mesh, *,
               quant: str, qcfg: QuantConfig, device="meta"):
    """(step function of no arguments, its argument trees, the trees it
    updates in place) for one cell, on rank-local shards."""
    model = Model(model_cfg)
    rules = Rules.for_arch(mesh, model_cfg)
    tree = model.build()
    bf16 = torch.bfloat16

    def batch_of(specs):
        sh = rules.batch_shardings(specs)
        return {k: local_dtensor(v.shape, v.dtype, mesh, sh[k], device)
                for k, v in specs.items()}

    if shape.kind == "train":
        cfgp = model_cfg.parallel
        params = local_tree(tree, rules.param_shardings(
            tree, fsdp=cfgp.fsdp_params), mesh, torch.float32, device)
        osh = rules.param_shardings(tree, fsdp=cfgp.fsdp_opt)
        opt = {k: local_tree(tree, osh, mesh, torch.float32, device)
               for k in ("m", "v")}
        step0 = torch.zeros((), dtype=torch.int32,
                            device="cpu" if device == "meta" else device)
        state = TrainState(step=step0, params=params, opt=opt)
        compute = (rules.param_shardings(tree) if cfgp.fsdp_params
                   else None)
        step_fn = make_train_step(model, AdamW(),
                                  warmup_cosine(1e-4, 100, 10000),
                                  compute_shardings=compute)
        batch = batch_of(model.input_specs(shape))
        return (lambda: step_fn(state, batch)), (state, batch), (), rules
    if quant != "off":
        tree = pack_placeholders(tree, qcfg)
    # serving runs on compute-dtype params; packed leaves keep their dtypes
    params = local_tree(tree, rules.param_shardings(tree), mesh, bf16,
                        device)
    batch = batch_of(model.input_specs(shape))
    if shape.kind == "prefill":
        if model_cfg.family == "encoder":
            return ((lambda: model.apply(params, batch)[0]), (params, batch),
                    (), rules)
        ctree = model.build_cache(shape.global_batch, shape.seq_len, bf16)
        cache = local_tree(ctree, rules.param_shardings(ctree), mesh, bf16,
                           device)
        return ((lambda: model.prefill(params, batch, cache)),
                (params, batch, cache), (cache,), rules)
    ctree = model.build_cache(shape.global_batch, shape.seq_len, bf16)
    cache = local_tree(ctree, rules.param_shardings(ctree), mesh, bf16,
                       device)
    if model_cfg.family == "vlm":
        def fn():
            logits, c2, _ = model.apply(params, batch, cache=cache,
                                        cache_index=0)
            return logits[:, -1], c2
        return fn, (params, batch, cache), (cache,), rules
    return ((lambda: model.decode_step(params, batch["tokens"], cache, 0)),
            (params, batch, cache), (cache,), rules)


def trace_step(model_cfg, shape, mesh, *, quant, qcfg) -> Dict[str, Any]:
    """Trace one step; its costs and memory, per device."""
    fn, args, inplace, rules = build_step(model_cfg, shape, mesh,
                                          quant=quant, qcfg=qcfg)
    tracer = Tracer(args)
    grad = torch.enable_grad() if shape.kind == "train" else torch.no_grad()
    with par_ctx.use_rules(rules), grad, tracer:
        out = fn()
    coll = RL.collective_bytes(tracer.collectives)
    arg = _arg_bytes(*args)
    alias = _arg_bytes(*inplace)
    outb = _arg_bytes(out)
    return {
        "flops": tracer.flops, "bytes_accessed": tracer.bytes,
        "collective_wire": float(coll["total"]),
        "collective_operand": float(coll["operand_total"]),
        "collectives": {k: coll[k] for k in RL.COLLECTIVES},
        "collective_counts": coll["counts"],
        "records": list(tracer.collectives),
        "kernels": dict(tracer.kernels),
        "memory": {"argument_bytes": arg, "output_bytes": outb,
                   "temp_bytes": tracer.peak, "alias_bytes": alias},
    }


def _shallow_cfg(cfg: ArchConfig, k_units: int) -> ArchConfig:
    """Reduced-depth config: ``k_units`` pattern units and the tail."""
    unit_len = len(Model(cfg).unit)
    tail = cfg.n_layers % unit_len
    return cfg.replace(
        n_layers=k_units * unit_len + tail,
        parallel=dataclasses.replace(cfg.parallel, grad_accum=1))


def lower_cell(cfg: ArchConfig, shape: ShapeConfig, mesh, *,
               quant: str = "qat", qcfg: Optional[QuantConfig] = None,
               depth_correct: bool = True) -> Dict[str, Any]:
    """Trace one (arch x shape x mesh) cell on rank 0; return the record
    (the reference's keys; see the module docstring)."""
    qcfg = qcfg or QuantConfig(method="swis", n_shifts=4, group_size=4)
    model_cfg = cell_cfg(cfg, shape, quant, qcfg)
    t0 = time.monotonic()
    raw = trace_step(model_cfg, shape, mesh, quant=quant, qcfg=qcfg)
    t_lower = time.monotonic() - t0
    n_units = Model(model_cfg).n_units
    per_unit = None
    fields = ("flops", "bytes_accessed", "collective_wire",
              "collective_operand")
    if depth_correct and n_units > 2:
        shallow = [trace_step(_shallow_cfg(model_cfg, k), shape, mesh,
                              quant=quant, qcfg=qcfg) for k in (1, 2)]
        per_unit = {f: shallow[1][f] - shallow[0][f] for f in fields}

    chips = int(np.prod(list(mesh.shape)))
    flops = raw["flops"]
    terms = RL.roofline_terms(flops, raw["bytes_accessed"],
                              raw["collective_wire"])
    tree = Model(cfg).build()
    n_params = pp.count_params(tree)
    n_active = _active_params(cfg, tree)
    tokens = shape.global_batch * (shape.seq_len
                                   if shape.kind in ("train", "prefill")
                                   else 1)
    mf_global = RL.model_flops(n_params, n_active, tokens,
                               "train" if shape.kind == "train" else "fwd")
    mf_per_chip = mf_global / chips
    return {
        "arch": cfg.name,
        "shape": shape.name,
        "kind": shape.kind,
        "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
        "chips": chips,
        "quant": quant,
        "lower_s": round(t_lower, 1),
        "compile_s": 0.0,
        "memory": raw["memory"],
        "cost_raw_scan": {k: raw[k] for k in
                          ("flops", "bytes_accessed", "collective_wire")},
        "cost": {f: raw[f] for f in fields},
        "cost_per_unit": per_unit,
        "n_units": n_units,
        "collectives": raw["collectives"],
        "collective_counts": raw["collective_counts"],
        "roofline": terms,
        "model_flops_per_chip": mf_per_chip,
        "useful_flops_fraction": (mf_per_chip / flops) if flops else 0.0,
        "n_params": n_params,
        "n_active_params": n_active,
        "kernel_launches": raw["kernels"],
    }


def cell_name(arch: str, shape: str, mesh_kind: str, quant: str) -> str:
    return f"{arch}__{shape}__{mesh_kind}__{quant}"


def fake_world(size: int) -> None:
    """This process as rank 0 of a fake group of ``size`` ranks (an
    existing group of that size is kept)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() != size:
            raise RuntimeError(f"a group of {dist.get_world_size()} ranks is "
                               f"initialized; the mesh needs {size}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def production_mesh(mesh_kind: str, device="cpu"):
    """The production mesh over a fake group of its size (rank 0)."""
    from repro_torch.launch.mesh import make_production_mesh

    fake_world(512 if mesh_kind == "multi" else 256)
    return make_production_mesh(multi_pod=mesh_kind == "multi",
                                device=device)


def run_cells(cells, out_dir: str, quant: str = "qat", force: bool = False):
    os.makedirs(out_dir, exist_ok=True)
    results = []
    for arch_id, shape_name, mesh_kind in cells:
        name = cell_name(arch_id, shape_name, mesh_kind, quant)
        path = os.path.join(out_dir, name + ".json")
        if os.path.exists(path) and not force:
            with open(path) as f:
                results.append(json.load(f))
            print(f"[skip] {name}")
            continue
        cfg = C.get_config(arch_id)
        shape = SHAPES[shape_name]
        ok, why = shape_applicable(cfg, shape)
        if not ok:
            rec = {"arch": arch_id, "shape": shape_name, "mesh": mesh_kind,
                   "skipped": why}
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            print(f"[n/a ] {name}: {why}")
            results.append(rec)
            continue
        print(f"[run ] {name} ...", flush=True)
        try:
            rec = lower_cell(cfg, shape, production_mesh(mesh_kind),
                             quant=quant)
            rec["mesh_kind"] = mesh_kind
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            r = rec["roofline"]
            print(f"  ok lower={rec['lower_s']}s compile={rec['compile_s']}s "
                  f"compute={r['compute_s']:.4f}s memory={r['memory_s']:.4f}s "
                  f"coll={r['collective_s']:.4f}s -> {r['bottleneck']}",
                  flush=True)
            results.append(rec)
        except Exception as e:  # one failing cell must not stop the sweep
            print(f"  FAIL {type(e).__name__}: {e}")
            traceback.print_exc()
            with open(os.path.join(out_dir, name + ".err"), "w") as f:
                f.write(traceback.format_exc())
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--quant", default="qat", choices=["qat", "off"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    mesh_kinds = (["single", "multi"] if args.mesh == "both"
                  else [args.mesh])
    if args.all:
        archs = list(C.ARCH_IDS)
        shapes = list(SHAPES)
    else:
        archs = [args.arch] if args.arch else list(C.ARCH_IDS)
        shapes = [args.shape] if args.shape else list(SHAPES)
    # one fake group a process: a sweep over both meshes runs the single
    # mesh's cells first, and a process can only join one group size
    for mk in mesh_kinds:
        if len(mesh_kinds) > 1 and mk == "multi":
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()
        run_cells([(a, s, mk) for a in archs for s in shapes], args.out,
                  quant=args.quant, force=args.force)


if __name__ == "__main__":
    main()
