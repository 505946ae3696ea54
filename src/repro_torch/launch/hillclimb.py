"""Perf-iteration tooling (PyTorch port of ``repro.launch.hillclimb``):
trace a cell at shallow depth under the fake group (exact costs, a few
seconds) and report the dominant collectives and the roofline terms.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb \
      --arch mistral-large-123b --shape train_4k [--units 1] [--quant qat|off]

The collectives are the tracer's records (kind, result bytes, group size),
where the reference reads instructions out of XLA's HLO text.
"""
import argparse
from collections import defaultdict

from repro_torch import configs as C
from repro_torch.configs.base import SHAPES
from repro_torch.core.swis import QuantConfig
from repro_torch.launch import roofline as RL
from repro_torch.launch.dryrun import (_shallow_cfg, cell_cfg,
                                       production_mesh, trace_step)


def top_collectives(records, k: int = 12):
    """Aggregate collective records by (kind, group, size), largest total
    first: [(signature, count, total result bytes)]."""
    agg = defaultdict(lambda: [0, 0.0])
    for kind, size, g in records:
        sig = f"{kind} g={g} {int(size)} B"
        agg[sig][0] += 1
        agg[sig][1] += size
    rows = sorted(agg.items(), key=lambda kv: -kv[1][1])[:k]
    return [(sig, n, b) for sig, (n, b) in rows]


def measure(arch: str, shape_name: str, *, units: int = 1, quant: str = "qat",
            mesh_kind: str = "single", qcfg=None, show: int = 10):
    shape = SHAPES[shape_name]
    qcfg = qcfg or QuantConfig(method="swis", n_shifts=4, group_size=4)
    model_cfg = cell_cfg(C.get_config(arch), shape, quant, qcfg)
    scfg = _shallow_cfg(model_cfg, units)
    costs = trace_step(scfg, shape, production_mesh(mesh_kind), quant=quant,
                       qcfg=qcfg)
    terms = RL.roofline_terms(costs["flops"], costs["bytes_accessed"],
                              costs["collective_wire"])
    print(f"== {arch} x {shape_name} ({units} unit(s), quant={quant}) ==")
    print(f" flops/chip      {costs['flops']:.3e}")
    print(f" bytes/chip      {costs['bytes_accessed']:.3e}")
    print(f" coll wire/chip  {costs['collective_wire']:.3e}")
    print(f" terms: compute={terms['compute_s']:.4f}s "
          f"memory={terms['memory_s']:.4f}s coll={terms['collective_s']:.4f}s"
          f" -> {terms['bottleneck']}")
    print(" top collectives:")
    for sig, n, b in top_collectives(costs["records"], show):
        print(f"  {b/2**30:8.2f} GiB  x{n:<4d} {sig}")
    return costs, terms


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.hillclimb")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--units", type=int, default=1)
    ap.add_argument("--quant", default="qat")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--show", type=int, default=10)
    args = ap.parse_args(argv)
    measure(args.arch, args.shape, units=args.units, quant=args.quant,
            mesh_kind=args.mesh, show=args.show)


if __name__ == "__main__":
    main()
