"""MoE routing and combine: share of the traced device-busy seconds in
kernels launched inside ``moe.router`` (router GEMM, softmax, top-k, gate
scatter, capacity bookkeeping and dispatch) or ``moe.combine`` (the
combine einsum) (``_calls.py``)."""

from portbench.metrics import _calls

ROUTE = ("moe.router", "moe.combine")


def read(run):
    t = _calls.reduce(run)
    if t is None or not t["busy_s"]:
        return None
    secs = sum(r["device_s"] for (_, name), r in t["rows"].items()
               if name in ROUTE)
    return 100.0 * secs / t["busy_s"] if secs else None
