"""Engine host dispatch: host ms per traced engine step in runtime calls
that wait on the device or copy through host memory (``Synchronize``,
``Memcpy``) inside a call span other than ``sample`` (a model layer or a
cache operation): the syncs hidden in the dispatch (``_calls.py``)."""

from portbench.metrics import _calls


def read(run):
    t = _calls.reduce(run)
    if t is None or not t["steps"]:
        return None
    wait = sum(r["wait_s"] for (_, name), r in t["rows"].items()
               if r["call"] and name != "sample")
    return 1e3 * wait / t["steps"]
