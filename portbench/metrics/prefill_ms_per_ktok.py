"""Model step, prefill: wall time of the window's prefill launches (their
dispatch and the wait for their logits, ``step.prefill_dispatch_s``) per
1000 real prompt tokens."""


def read(run):
    n, secs = run.phase("step.prefill_dispatch_s")
    tokens = sum(len(run.reqs[rid].prompt) for s in run.window_steps()
                 for rid in s.prefill)
    return 1e6 * secs / tokens if n and tokens else None
