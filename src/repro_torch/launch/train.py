"""Training launcher of the port: the reference launcher's flags, on the
card unless asked for the CPU.

  python -m repro_torch.launch.train --arch smollm-135m --quant swis \
      --n-shifts 4 --steps 8 --ckpt-every 4 --workdir results/run1
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      --smoke --device cpu --steps 20 --quant swis --n-shifts 3

With ``--quant`` other than ``none`` the model trains under SWIS QAT
(hoisted fake-quant, straight-through gradient). The JSON report is the
reference's (arch, steps, first and last loss, stragglers); one line a
step on stderr gives the loss, wall ms, the device ms of the step's parts
(QAT selection, forward + backward, optimizer), tokens/s and, on the
card, peak memory. A run's checkpoint serves with ``python -m
repro_torch.launch.serve --arch ... --ckpt <workdir> --packed``.

``--mesh-data D --mesh-model M`` trains sharded on a (D, M) mesh of
``data`` x ``model`` ranks: one process a rank, under ``torchrun`` (which
sets the rank, the world size and the rendezvous address), in an NCCL
group on the card or a gloo group with ``--device cpu``; the world must
be D x M. Without ``torchrun`` a one-rank mesh (1, 1) runs in the calling
process on a group of its own at ``tcp://localhost``:

  torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch \
      smollm-135m --mesh-data 2 --mesh-model 2 --steps 8
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import socket
import sys
from typing import Any, Dict, Optional, Sequence

from repro_torch import configs as C
from repro_torch.configs.base import QuantPolicy
from repro_torch.core.swis import QuantConfig
from repro_torch.train.loop import Trainer


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.train",
        description="Train on the synthetic pipeline, optionally with SWIS "
                    "QAT, and checkpoint.")
    ap.add_argument("--arch", required=True, choices=list(C.ARCH_IDS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-friendly)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; there is "
                         "no fallback: pass cpu for the plain version)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--quant", default="none",
                    choices=["none", "swis", "swis_c", "trunc"])
    ap.add_argument("--n-shifts", type=float, default=4)
    ap.add_argument("--group-size", type=int, default=4)
    ap.add_argument("--mesh-data", type=int, default=0,
                    help="data-parallel ranks of a sharded run (see above)")
    ap.add_argument("--mesh-model", type=int, default=0,
                    help="tensor-parallel ranks of a sharded run")
    return ap.parse_args(argv)


def step_line(rec: Dict[str, Any]) -> str:
    """One step's record as a line: loss, wall ms, part ms, tokens/s."""
    parts = rec["part_ms"]
    line = (f"[step {rec['step']}] loss {rec['loss']:.5f} wall "
            f"{rec['wall_ms']:.1f} ms; {rec['clock']} ms: select "
            f"{parts['select']:.1f}, fwd+bwd {parts['fwd_bwd']:.1f}, optim "
            f"{parts['optim']:.1f}; {rec['tokens_per_s']:.0f} tokens/s")
    if "peak_gb" in rec:
        line += f"; peak {rec['peak_gb']:.2f} GB"
    return line


@contextlib.contextmanager
def _mesh(args):
    """(mesh or None, device) for the run: the (data, model) mesh over the
    process group, which is initialized here (and destroyed after) unless
    it already is."""
    if not (args.mesh_data or args.mesh_model):
        yield None, args.device
        return
    import torch
    import torch.distributed as dist

    from repro_torch import device as _device
    from repro_torch.launch.mesh import make_host_mesh

    shape = (max(args.mesh_data, 1), max(args.mesh_model, 1))
    dev = _device.resolve(args.device)
    own = not dist.is_initialized()
    if own:
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if "RANK" in os.environ:  # torchrun
            dist.init_process_group(backend)
        else:
            dist.init_process_group(
                backend, init_method=f"tcp://localhost:{_free_port()}",
                rank=0, world_size=1)
    try:
        if dist.get_world_size() != shape[0] * shape[1]:
            raise ValueError(f"a {shape} mesh needs {shape[0] * shape[1]} "
                             f"ranks, the world has {dist.get_world_size()}")
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(dev)
        yield make_host_mesh(model=shape[1], device=dev.type), dev
    finally:
        if own:
            dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(args: argparse.Namespace, **trainer_kw) -> Dict[str, Any]:
    """Train as the reference launcher's ``main`` does and print its report;
    ``trainer_kw`` are further ``Trainer`` fields (``init_params``, ...).
    Returns ``Trainer.run``'s output."""
    cfg = C.get_smoke(args.arch) if args.smoke else C.get_config(args.arch)
    if args.quant != "none":
        cfg = cfg.replace(quant=QuantPolicy(
            cfg=QuantConfig(method=args.quant, n_shifts=args.n_shifts,
                            group_size=args.group_size),
            mode="qat"))
    with _mesh(args) as (mesh, device):
        tr = Trainer(cfg, seq_len=args.seq, global_batch=args.batch,
                     workdir=args.workdir, total_steps=args.steps,
                     ckpt_every=args.ckpt_every, warmup=args.warmup,
                     peak_lr=args.lr, device=device, mesh=mesh, **trainer_kw)
        out = tr.run(args.steps)
    for rec in out["records"]:
        print(step_line(rec), file=sys.stderr)
    print(json.dumps({"arch": cfg.name, "steps": args.steps,
                      "first_loss": out["first_loss"],
                      "last_loss": out["last_loss"],
                      "stragglers": out["straggler_events"]}, indent=1))
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
