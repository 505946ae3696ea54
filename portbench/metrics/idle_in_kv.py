"""Engine cache bookkeeping: share of the traced span in which no kernel
ran while the host was inside a cache call span (``kv.prefix_tree``,
``kv.scatter``, ``kv.tables``), each idle nanosecond charged to the
innermost span (``_calls.py``)."""

from portbench.metrics import _calls


def read(run):
    t = _calls.reduce(run)
    if t is None:
        return None
    idle = sum(r["idle_s"] for (_, name), r in t["rows"].items()
               if r["call"] and _calls.is_kv(name))
    return 100.0 * idle / t["window_s"]
