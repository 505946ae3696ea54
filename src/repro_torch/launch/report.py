"""Aggregate the port's dry-run JSON records into roofline tables (PyTorch
port of ``repro.launch.report``; pure Python over the records).

  PYTHONPATH=src python -m repro_torch.launch.report --out results/dryrun_torch
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List


def load(out_dir: str) -> List[Dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def fmt_bytes(b: float) -> str:
    return f"{b / 2**30:.2f}"


def roofline_table(recs: List[Dict], mesh_kind: str = "single") -> str:
    rows = []
    header = ("| arch | shape | bottleneck | compute s | memory s | coll s | "
              "roofline s | useful FLOP frac | HBM GiB/dev | coll GiB/dev |")
    sep = "|" + "---|" * 10
    rows.append(header)
    rows.append(sep)
    for r in recs:
        if r.get("skipped") or r.get("mesh_kind", "single") != mesh_kind:
            continue
        t = r["roofline"]
        mem = (r["memory"]["argument_bytes"] + r["memory"]["temp_bytes"])
        rows.append(
            f"| {r['arch']} | {r['shape']} | **{t['bottleneck']}** "
            f"| {t['compute_s']:.4f} | {t['memory_s']:.4f} "
            f"| {t['collective_s']:.4f} | {t['roofline_bound_s']:.4f} "
            f"| {r['useful_flops_fraction']:.3f} "
            f"| {fmt_bytes(mem)} "
            f"| {fmt_bytes(r['cost']['collective_wire'])} |")
    return "\n".join(rows)


def skipped_table(recs: List[Dict]) -> str:
    rows = ["| arch | shape | mesh | reason |", "|---|---|---|---|"]
    for r in recs:
        if r.get("skipped"):
            rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} "
                        f"| {r['skipped']} |")
    return "\n".join(rows)


def summary(recs: List[Dict]) -> Dict:
    done = [r for r in recs if not r.get("skipped")]
    bottl = {}
    for r in done:
        b = r["roofline"]["bottleneck"]
        bottl[b] = bottl.get(b, 0) + 1
    return {"cells_compiled": len(done),
            "cells_skipped": len(recs) - len(done),
            "bottlenecks": bottl}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args()
    recs = load(args.out)
    print(json.dumps(summary(recs), indent=1))
    print("\n## single-pod (16x16)\n")
    print(roofline_table(recs, "single"))
    print("\n## multi-pod (2x16x16)\n")
    print(roofline_table(recs, "multi"))
    print("\n## skipped\n")
    print(skipped_table(recs))


if __name__ == "__main__":
    main()
