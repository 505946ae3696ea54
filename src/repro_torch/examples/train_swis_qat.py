"""End-to-end driver: train a ~135M-class LM (the smollm-135m family) with
SWIS quantization-aware training, with checkpointing, then compare its
accuracy at the deployment shift count with post-training quantization of
a float-trained model (paper Table 5: QAT recovers accuracy).

The default is smollm's width/depth-reduced smoke config so a few hundred
steps finish quickly; ``--full`` trains the exact 135M config (the card's
job).

Run:  python -m repro_torch.examples.train_swis_qat [--steps 300]
      (on the card; add ``--device cpu`` for the plain PyTorch path)
"""
import argparse

from repro_torch import configs as C
from repro_torch.configs.base import QuantPolicy
from repro_torch.core.swis import QuantConfig
from repro_torch.examples.common import quant_policy, trained_smoke_model
from repro_torch.train.loop import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--n-shifts", type=float, default=2)
    ap.add_argument("--workdir", default="results/example_qat")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="use the exact smollm-135m config")
    args = ap.parse_args(argv)

    cfg = C.get_config("smollm-135m") if args.full else C.get_smoke(
        "smollm-135m")
    qcfg = QuantConfig(method="swis", n_shifts=args.n_shifts, group_size=4)
    cfg_qat = cfg.replace(quant=QuantPolicy(cfg=qcfg, mode="qat"))

    print(f"== SWIS QAT: {cfg.name}, N={args.n_shifts} shifts, "
          f"{args.steps} steps ==")
    tr = Trainer(cfg_qat, seq_len=64, global_batch=16, workdir=args.workdir,
                 total_steps=args.steps, ckpt_every=max(args.steps // 4, 1),
                 warmup=20, peak_lr=3e-3, device=args.device)
    out = tr.run(args.steps)
    print(f"loss: {out['first_loss']:.3f} -> {out['last_loss']:.3f}")

    # eval: the QAT weights under the deployment quantization (PTQ-style)
    if not args.full:
        base_cfg, _, eval_acc = trained_smoke_model(steps=args.steps,
                                                    device=args.device)
        ptq_cfg = base_cfg.replace(quant=quant_policy("swis", args.n_shifts))
        acc_ptq = eval_acc(ptq_cfg)  # float-trained, then quantized
        acc_qat = eval_acc(ptq_cfg, eval_params=out["state"].params)
        print(f"accuracy @ N={args.n_shifts}:  PTQ={acc_ptq:.4f}  "
              f"QAT={acc_qat:.4f}  (QAT recovers accuracy, paper Table 5)")
        return {"loss": (out["first_loss"], out["last_loss"]),
                "ptq": acc_ptq, "qat": acc_qat}
    return {"loss": (out["first_loss"], out["last_loss"])}


if __name__ == "__main__":
    main()
