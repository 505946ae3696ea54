"""One rank of ``tests/test_torch_distributed.py``'s gloo runs. Imports
torch and the port only (no JAX):

  python tests/torch_dist_port.py RANK WORLD RENDEZVOUS_FILE WORKDIR

Every rank runs the checks below in order on the CPU and rank 0 writes
their results to WORKDIR/result.json; WORKDIR/params.npz holds the JAX
package's qwen2-moe smoke params (bridged from numpy by path)."""
import dataclasses
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import configs as C  # noqa: E402
from repro_torch.core.qat import quantize_tree  # noqa: E402
from repro_torch.core.swis import QuantConfig  # noqa: E402
from repro_torch.models import params as pp  # noqa: E402
from repro_torch.models.layers import dense  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.parallel import comm  # noqa: E402
from repro_torch.parallel import model as sharded  # noqa: E402
from repro_torch.parallel import quant as pquant  # noqa: E402
from repro_torch.parallel.sharding import Rules  # noqa: E402
from repro_torch.serve.quantized import pack_tree  # noqa: E402
from repro_torch.train.loop import Trainer  # noqa: E402

# the sharded trainer runs (i)-(iii): seq 32, batch 8, warmup 2, lr 5e-3
KW = dict(seq_len=32, global_batch=8, warmup=2, peak_lr=5e-3, device="cpu")
FP32 = dict(compute_dtype="float32")


def mesh_of(shape):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))


def load_params(path):
    flat = np.load(path)
    tree = {}
    for key in flat.files:
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.from_numpy(flat[key].copy())
    return tree


def placements_of(t):
    return [str(p) for p in t.placements]


def moe_trainer(workdir):
    """(i) qwen2-moe smoke on (2, 2), the JAX params, float32."""
    cfg = C.get_smoke("qwen2-moe-a2.7b").replace(**FP32)
    out = Trainer(cfg, total_steps=6, mesh=mesh_of((2, 2)),
                  init_params=load_params(os.path.join(workdir, "params.npz")),
                  **KW).run(6)
    wq = out["state"].params["blocks"]["sub0_moe"]["attn"]["wq"]["w"]
    return {"losses": out["losses"], "wq": placements_of(wq)}


def elastic(workdir):
    """(ii) phi3-mini smoke: 2 steps on (2, 2) with a checkpoint, resumed
    on (4, 1) to step 6, against 6 unbroken steps on (2, 2)."""
    cfg = C.get_smoke("phi3-mini-3.8b").replace(**FP32)
    ck = os.path.join(workdir, "ckpt")
    Trainer(cfg, total_steps=6, ckpt_every=2, workdir=ck,
            mesh=mesh_of((2, 2)), **KW).run(2)
    resumed = Trainer(cfg, total_steps=6, ckpt_every=2, workdir=ck,
                      mesh=mesh_of((4, 1)), **KW).run(6)
    unbroken = Trainer(cfg, total_steps=6, mesh=mesh_of((2, 2)), **KW).run(6)
    wq = resumed["state"].params["blocks"]["sub0_attn"]["attn"]["wq"]["w"]
    return {"resumed": resumed["losses"], "unbroken": unbroken["losses"],
            "wq": placements_of(wq)}


def fsdp(workdir):
    """(iii) deepseek smoke, ZeRO-3 masters, two microbatches."""
    cfg = C.get_smoke("deepseek-7b")
    cfg = cfg.replace(parallel=dataclasses.replace(
        cfg.parallel, fsdp_params=True, grad_accum=2))
    out = Trainer(cfg, total_steps=4, mesh=mesh_of((2, 2)), **KW).run(4)
    wi = out["state"].params["blocks"]["sub0_attn"]["mlp"]["wi"]["w"]
    m = out["state"].opt["m"]["blocks"]["sub0_attn"]["mlp"]["wi"]["w"]
    return {"losses": out["losses"], "wi": placements_of(wi),
            "m": placements_of(m)}


def packed_split(workdir):
    """(iv) one packed weight split over N and over K: the local kernels
    (plain versions on the CPU) and the model axis's gather or all-reduce
    against the whole product."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh = mesh_of((2, 2))
    env = sharded.Env.of(mesh)
    g = torch.Generator().manual_seed(3)
    w = torch.randn((128, 64), generator=g) * 0.05
    x = torch.randn((5, 128), generator=g)
    leaf, _ = pack_tree({"w": w}, QuantConfig(n_shifts=4, group_size=4))
    leaf = leaf["w"]
    cfg = C.get_smoke("smollm-135m")
    whole = dense({"w": leaf}, x, cfg)
    errs = {}
    for name, dims in (("N", {"sign_plane": 1, "mask_planes": 2,
                              "shifts": 1, "scale": 1}),
                       ("K", {"sign_plane": 0, "mask_planes": 1,
                              "shifts": 0, "scale": None})):
        dt = {k: distribute_tensor(v, mesh, (Replicate(), Replicate() if
                                             dims[k] is None else
                                             Shard(dims[k])),
                                   src_data_rank=None)
              for k, v in leaf.items()}
        local, split = sharded.localize(dt, env)
        if name == "N":
            y = comm.all_gather(dense({"w": local}, x, cfg), env.tp, -1)
        else:
            y = comm.all_reduce(dense(
                {"w": local}, comm.own_slice(x, env.tp, -1), cfg), env.tp)
        errs[name] = {"split": split, "err": float((y - whole).abs().max()),
                      "scale": float(whole.abs().max())}
    return errs


def qat_bits(workdir):
    """(v) the hoisted fake-quant of every eligible leaf of a TP-sharded
    compute copy against the whole tree's, at 4 shifts (quantized on the
    shards) and 2.5 (a column schedule: gathered)."""
    from torch.distributed.tensor import distribute_tensor

    cfg = C.get_smoke("qwen2-moe-a2.7b")
    mesh = mesh_of((2, 2))
    tree = Model(cfg).build()
    params = pp.init_params(tree, torch.Generator().manual_seed(1),
                            device="cpu")
    sh = Rules.for_arch(mesh, cfg).param_shardings(tree)

    def dist_(p, s):
        if isinstance(p, dict):
            return {k: dist_(p[k], s[k]) for k in p}
        return distribute_tensor(p, mesh, s, src_data_rank=None)

    dparams = dist_(params, sh)
    out = {}
    for n in (4, 2.5):
        q = QuantConfig(method="swis", n_shifts=n, group_size=4)
        want = quantize_tree(params, q)
        got = quantize_tree(dparams, q, quant=pquant.fake_quant_dtensor)
        bad, sharded_leaves = [], 0

        def cmp(a, b, path=""):
            nonlocal sharded_leaves
            if isinstance(a, dict):
                for k in a:
                    cmp(a[k], b[k], path + "/" + k)
                return
            if any(p.is_shard() for p in a.placements):
                sharded_leaves += 1
            if not torch.equal(a.full_tensor(), b):
                bad.append(path)

        cmp(got, want)
        out[str(n)] = {"bad": bad, "sharded": sharded_leaves}
    return out


def sharded_decode(workdir):
    """(vi) a prefill of 64 tokens (one MoE dispatch group a row, so each
    rank's groups are the global ones) and 3 decode steps on a (2, 2)
    mesh, the decode cache split over its positions (``kv_seq`` over
    model), against the same model unsharded, float32: a dense arch (whole
    local heads), the MoE (local experts) and Griffin (recurrent state
    gathered, a windowed ring)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.parallel import ctx as par_ctx

    mesh = mesh_of((2, 2))
    out = {}
    for arch in ("smollm-135m", "qwen2-moe-a2.7b", "recurrentgemma-2b"):
        cfg = C.get_smoke(arch).replace(**FP32)
        model = Model(cfg)
        tree = model.build()
        params = pp.init_params(tree, torch.Generator().manual_seed(5),
                                device="cpu")
        rules = Rules.for_arch(mesh, cfg)

        def dist_(t, s):
            if isinstance(t, dict):
                return {k: dist_(t[k], s[k]) for k in t}
            return distribute_tensor(t, mesh, s, src_data_rank=None)

        ctree = model.build_cache(2, 72, torch.float32)
        cache = pp.init_params(ctree, None, device="cpu")
        dcache = dist_(pp.tree_map(torch.clone, cache),
                       rules.param_shardings(ctree))
        dparams = dist_(params, rules.param_shardings(tree))
        tokens = torch.randint(0, cfg.vocab, (2, 67),
                               generator=torch.Generator().manual_seed(6))
        bsh = rules.batch_shardings({"t": tokens[:, :64]})["t"]
        errs, scale = [], 0.0
        with torch.no_grad():
            for lo, hi in ((0, 64), (64, 65), (65, 66), (66, 67)):
                t = tokens[:, lo:hi]
                want, _, _ = model.apply(params, {"tokens": t}, cache=cache,
                                         cache_index=lo, last_only=True)
                with par_ctx.use_rules(rules):
                    got, _, _ = model.apply(
                        dparams, {"tokens": distribute_tensor(
                            t, mesh, bsh, src_data_rank=None)},
                        cache=dcache, cache_index=lo, last_only=True)
                # this rank's rows of the batch
                rows = want.shape[0] // 2
                r0 = mesh.get_local_rank("data") * rows
                errs.append(float((got - want[r0:r0 + rows]).abs().max()))
                scale = max(scale, float(want.abs().max()))
        split = rules.param_shardings(ctree)["blocks"]
        kv = [str(p) for p in next(
            v for v in split.values() if "k" in v)["k"]]
        out[arch] = {"errs": errs, "scale": scale, "k": kv}
        if cfg.moe is not None:  # 8 tokens a rank: a group spans ranks
            try:
                with par_ctx.use_rules(rules), torch.no_grad():
                    model.apply(dparams, {"tokens": distribute_tensor(
                        tokens[:, :8], mesh, bsh, src_data_rank=None)})
                out[arch]["spanning_groups"] = "ran"
            except NotImplementedError as e:
                out[arch]["spanning_groups"] = str(e)
    return out


CHECKS = (moe_trainer, elastic, fsdp, packed_split, qat_bits, sharded_decode)


def main(argv):
    rank, world, rdv, workdir = int(argv[0]), int(argv[1]), argv[2], argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                            world_size=world)
    try:
        results = {c.__name__: c(workdir) for c in CHECKS}
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(os.path.join(workdir, "result.json"), "w") as f:
            json.dump(results, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
