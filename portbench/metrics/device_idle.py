"""Device: share of the traced window in which no kernel ran."""


def read(run):
    t = run.devtrace_result
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
