"""Engine host dispatch: mean host time to enqueue one decode step
(``step.decode_dispatch_s``, apart from the wait for the device)."""


def read(run):
    n, secs = run.phase("step.decode_dispatch_s")
    return 1e3 * secs / n if n else None
