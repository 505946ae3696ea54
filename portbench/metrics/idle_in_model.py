"""Model step, host enqueue: share of the traced span in which no kernel
ran while the host was inside a model call span (``embed``, ``attn``,
``attn.core``, ``mlp``, ``moe``, ``moe.*``, ``unembed``), each idle
nanosecond charged to the innermost span (``_calls.py``)."""

from portbench.metrics import _calls


def read(run):
    t = _calls.reduce(run)
    if t is None:
        return None
    idle = sum(r["idle_s"] for (_, name), r in t["rows"].items()
               if r["call"] and _calls.is_model(name))
    return 100.0 * idle / t["window_s"]
