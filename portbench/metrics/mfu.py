"""Whole model step: the model FLOPs that the window's tokens need
(``work.Model.model_flops``) over the window, as a share of the card's
989 TFLOP/s."""

from portbench.work import PEAK_FLOPS


def read(run):
    tokens = ctx = logits = 0
    for s in run.window_steps():
        for rid in s.prefill:
            n = len(run.reqs[rid].prompt)
            tokens += n
            ctx += n * (n + 1) // 2
            logits += 1
        tokens += len(s.decode_ctx)
        ctx += sum(s.decode_ctx)
        logits += len(s.decode_ctx)
    flops = run.work.model_flops(tokens, ctx, logits)
    return 100.0 * flops / (run.t1 - run.t0) / PEAK_FLOPS if tokens else None
