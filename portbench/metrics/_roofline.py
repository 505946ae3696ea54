"""Shared arithmetic of the kernel roofline readers: the least time that
the traced steps' launches of one kernel could take, over the device time
the trace gives that kernel."""

from portbench.devtrace import kernel_seconds


def launches(run, kind):
    """Per-layer launch lists of the traced steps' model calls: each
    prefill launch as the program made it (its rows' real tokens past any
    cached prefix) and each decode step."""
    out = []
    if kind != "paged":
        for launch in run.launches:
            if run.steps[launch.step].traced:
                m = sum(len(run.reqs[r].prompt) - launch.p_len
                        for r in launch.rids)
                out.append(getattr(run.work, kind)(m))
    for s in run.steps:
        if s.traced and s.decode_ctx:
            out.append([run.work.paged(s.decode_ctx)] if kind == "paged"
                       else getattr(run.work, kind)(len(s.decode_ctx)))
    return out


def share(run, kind, *names):
    if run.devtrace_result is None:
        return None
    secs = kernel_seconds(run.devtrace_result["kernels"], *names)
    calls = launches(run, kind)
    if not secs or not calls:
        return None
    return 100.0 * sum(run.work.bound_s(c) for c in calls) / secs
