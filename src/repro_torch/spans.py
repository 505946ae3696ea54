"""The active call-span recorder: one process-wide slot through which the
model's layers and the serving engine's cache operations reach the tracer
of the engine that is stepping.

:class:`~repro_torch.serve.engine.ContinuousBatchingEngine` fills the slot
around each ``step()`` while its tracer is enabled, and puts back what it
held after. A site is ``with spans.span(name):`` (a block's outer span
passes ``layer=``; its children inherit it). With the slot empty
(training, ``DecodeEngine``, an engine whose metrics are off) a site costs
one global read and returns a shared null context: no clock read, no
allocation.

The slot lives here, outside :mod:`repro_torch.serve`, because
:mod:`repro_torch.models` must not import the serving package. The
recorder is any object with ``call_span(name, layer)`` returning a context
manager (:meth:`repro_torch.serve.trace.RequestTracer.call_span`).
"""
from __future__ import annotations

import contextlib
from typing import Optional

NULL = contextlib.nullcontext()  # shared: it holds no state
_active = None  # the recorder of the engine stepping now, or None


def span(name: str, layer: Optional[int] = None):
    """A context that records one call span on the active recorder, or
    the shared null context when there is none. ``layer`` None inherits
    the enclosing span's layer (-1 outside the layer loop)."""
    rec = _active
    if rec is None:
        return NULL
    return rec.call_span(name, layer)


@contextlib.contextmanager
def recording(recorder):
    """Fill the slot with ``recorder`` for the body, then put back what it
    held."""
    global _active
    prev, _active = _active, recorder
    try:
        yield
    finally:
        _active = prev
