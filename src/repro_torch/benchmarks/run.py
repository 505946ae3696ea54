"""One function per paper table. Print ``name,us_per_call,derived`` CSV.

    python -m repro_torch.benchmarks.run [filter] [--device cpu]

``filter`` keeps the tables whose function name contains it. The tables
run on the card unless ``--device cpu`` asks for the plain PyTorch path. A
table that raises prints ``<function>,0.0,ERROR`` and its traceback, the
others still run, and the exit code is then 1.
"""
from __future__ import annotations

import argparse
import sys
import traceback


def main(argv=None) -> int:
    from repro_torch import device as _device
    from repro_torch.benchmarks import paper_tables

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("filter", nargs="?", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    print("name,us_per_call,derived")
    failed = False
    for fn in paper_tables.ALL:
        if args.filter and args.filter not in fn.__name__:
            continue
        try:
            for name, us, derived in fn(device=dev):
                print(f"{name},{us:.1f},{derived}")
        except Exception:
            print(f"{fn.__name__},0.0,ERROR", flush=True)
            traceback.print_exc(file=sys.stderr)
            failed = True
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
