"""Quickstart: SWIS post-training quantization in a few minutes.

1. Quantize a weight matrix with SWIS / SWIS-C / truncation and compare
   RMSE (paper Table 1).
2. Pack to the compressed bit-plane format and run the SWIS matmul (the
   CUDA kernel on the card, its plain version on the CPU) against the
   dense result.
3. Quantize a whole small model (PTQ) and compare task accuracy against
   weight truncation.

Run:  python -m repro_torch.examples.quickstart [--steps 200]
      (on the card; add ``--device cpu`` for the plain PyTorch path)
"""
import argparse

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import packing
from repro_torch.core.swis import QuantConfig, fake_quant, quantize, rmse
from repro_torch.examples.common import quant_policy, trained_smoke_model
from repro_torch.kernels import ops


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=200,
                    help="training steps of the part-3 model")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    rng = np.random.default_rng(0)

    print("== 1. SWIS vs SWIS-C vs truncation (RMSE, group=4) ==")
    w = torch.from_numpy(rng.normal(0, 0.05, (256, 128)).astype(
        np.float32)).to(dev)
    table = {}
    for n in (2, 3, 4):
        row = []
        for method in ("swis", "swis_c", "trunc"):
            q = fake_quant(w, QuantConfig(method=method, n_shifts=n,
                                          group_size=4))
            table[(n, method)] = float(rmse(w, q))
            row.append(f"{method}={table[(n, method)]:.5f}")
        print(f"  N={n}: " + "  ".join(row))

    print(f"\n== 2. Packed bit-plane matmul ({dev.type}) ==")
    qw = quantize(w, QuantConfig(method="swis", n_shifts=3, group_size=4))
    pw = packing.pack(qw)
    print(f"  compression: {pw.compression_ratio:.2f}x vs int8 "
          f"({pw.stored_bits / 8 / 1024:.1f} KiB packed)")
    x = torch.from_numpy(rng.normal(0, 1, (16, 256)).astype(np.float32)).to(
        dev)
    y_packed = ops.swis_matmul(x, pw)
    y_dense = x @ qw.qweights
    err = float((y_packed - y_dense).abs().max() / y_dense.abs().max())
    print(f"  packed-vs-dense rel err: {err:.2e}")

    print("\n== 3. Whole-model PTQ on a small LM ==")
    cfg, _, eval_acc = trained_smoke_model(steps=args.steps, device=dev)
    acc = {"fp32": eval_acc(cfg)}
    print(f"  fp32 accuracy:        {acc['fp32']:.4f}")
    for n in (2, 3, 4):
        acc[("swis", n)] = eval_acc(cfg.replace(quant=quant_policy("swis", n)))
        acc[("trunc", n)] = eval_acc(cfg.replace(
            quant=quant_policy("trunc", n)))
        print(f"  N={n}: swis={acc[('swis', n)]:.4f}  "
              f"wgt-trunc={acc[('trunc', n)]:.4f}")
    return {"rmse": table, "rel_err": err, "accuracy": acc}


if __name__ == "__main__":
    main()
