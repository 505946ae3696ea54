"""Readings that the limits in ``limits/<cell>.json`` are set from.

    python portbench/calibrate.py --workload <name> --seconds <s> \\
        --seeds <n,n,...> [--control]

For each seed: one run of the cell at its own size and load (set-up, a
window of ``--seconds``), judged as the benchmark judges it
(``harness.Run.judge``): the program's numbers and, with ``--control``,
the control's (``control_<name>``: the same positions judged for the
tokens, and their logits, that the reference computed in TF32 puts first).
One JSON line a seed; the benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1] / "src"),
                str(Path(__file__).resolve().parents[1])]


def reading(workload: str, seed: int, seconds: float, control: bool,
            device: str = "cuda", smoke: bool = False) -> dict:
    import torch

    from portbench import harness

    run = harness.Run(workload, seed, device, smoke=smoke)
    with torch.no_grad():
        run.setup()
        run.window(seconds)
    out = {"workload": workload, "seed": seed, **run.judge(control),
           "correct": run.correct}
    del run
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    for s in args.seeds.split(","):
        print(json.dumps(reading(args.workload, int(s), args.seconds,
                                 args.control)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
