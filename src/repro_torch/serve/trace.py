"""Per-request lifecycle tracing for the continuous-batching engine (port
of ``repro.serve.trace``: numpy and json only, as the reference).

Every request leaves a strictly ordered event stream:

    submit -> admit -> [prefix_hit] -> [unadmit -> admit ...]
           -> prefill_chunk[0..k] -> first_token -> decode_step* -> finish

Each :class:`TraceEvent` carries a monotonic timestamp
(``time.perf_counter``), the request id, and event-specific fields
(slot, matched prefix blocks, chunk index, decode step). The tracer
anchors one (wall-clock, monotonic) epoch pair at construction so JSONL
export carries real wall-clock timestamps while all derived intervals
(TTFT, TPOT, queue wait) are computed on the monotonic clock and can
never go negative under NTP steps.

Events live in a bounded in-memory ring (oldest dropped first, drop
count kept) so a long-lived server cannot grow without bound;
:class:`TraceWriter` streams events to a JSONL file whose lines
round-trip exactly (`json` shortest-repr floats), pinned by
``tests/test_torch_trace.py``.

``repro_torch.launch.serve`` reports its TTFT and TPOT percentiles from
this layer (``RequestTracer.summary``).
"""
from __future__ import annotations

import collections
import dataclasses
import json
import time
from typing import Any, Dict, IO, Iterable, List, Optional

import numpy as np

# event kinds, in canonical lifecycle order (used by ordering checks)
SUBMIT = "submit"
ADMIT = "admit"
UNADMIT = "unadmit"
PREFIX_HIT = "prefix_hit"
PREFILL_CHUNK = "prefill_chunk"
FIRST_TOKEN = "first_token"
DECODE_STEP = "decode_step"
# speculative decode: one event per speculating slot per spec step, with
# proposed / accepted draft counts (decode_step events are still emitted
# per accepted token, so TTFT/TPOT derivations are spec-agnostic)
SPEC_ACCEPT = "spec_accept"
FINISH = "finish"

KINDS = (SUBMIT, ADMIT, UNADMIT, PREFIX_HIT, PREFILL_CHUNK, FIRST_TOKEN,
         DECODE_STEP, SPEC_ACCEPT, FINISH)


@dataclasses.dataclass
class SpanEvent:
    """One timed engine phase: a ``[ts, ts+dur)`` interval on the
    engine's step timeline, tagged with the step number it ran under.
    Spans live in their own bounded ring, separate from the request
    lifecycle ring — a chatty phase cannot evict lifecycle events."""

    name: str
    ts: float  # monotonic seconds (perf_counter), span start
    dur: float  # seconds
    step: int = 0


@dataclasses.dataclass
class TraceEvent:
    kind: str
    rid: int
    ts: float  # monotonic seconds (perf_counter)
    fields: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self, wall_offset: float = 0.0) -> Dict[str, Any]:
        d = {"kind": self.kind, "rid": self.rid, "ts": self.ts,
             "ts_wall": self.ts + wall_offset}
        d.update(self.fields)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TraceEvent":
        fields = {k: v for k, v in d.items()
                  if k not in ("kind", "rid", "ts", "ts_wall")}
        return cls(kind=d["kind"], rid=int(d["rid"]), ts=float(d["ts"]),
                   fields=fields)


class RequestTracer:
    """Bounded ring of :class:`TraceEvent` + derived per-request stats.

    ``enabled=False`` turns :meth:`event` into a single attribute check
    (no allocation, no clock read). The default capacity (65536) holds
    ~2k requests' full lifecycles at 24 generated tokens each.
    """

    def __init__(self, capacity: int = 65536, enabled: bool = True):
        self.enabled = enabled
        self.capacity = capacity
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self.dropped = 0
        # step-phase spans: separate bounded ring so phase spam (ten+
        # spans per step) can never evict request lifecycle events
        self._spans: collections.deque = collections.deque(maxlen=capacity)
        self.dropped_spans = 0
        self.current_step = 0  # engine sets this at each step() entry
        # wall-clock anchor: ts_wall = ts + wall_offset
        self._wall_offset = time.time() - time.perf_counter()

    # -- recording -------------------------------------------------------

    def event(self, kind: str, rid: int, ts: Optional[float] = None,
              **fields) -> None:
        if not self.enabled:
            return
        if len(self._ring) == self.capacity:
            self.dropped += 1
        self._ring.append(TraceEvent(
            kind, rid, time.perf_counter() if ts is None else ts, fields))

    def span(self, name: str, ts: float, dur: float) -> None:
        """Record one engine-phase span (monotonic start + duration)."""
        if not self.enabled:
            return
        if len(self._spans) == self.capacity:
            self.dropped_spans += 1
        self._spans.append(SpanEvent(name, ts, dur, self.current_step))

    def span_timer(self, name: str, hist=None) -> "_SpanTimer":
        """``with tracer.span_timer("decode_dispatch", hist):`` — on exit
        records a span AND observes the duration into ``hist`` (the
        phase histogram), so one clock read feeds both sinks."""
        return _SpanTimer(self, name, hist)

    def reset(self) -> None:
        self._ring.clear()
        self.dropped = 0
        self._spans.clear()
        self.dropped_spans = 0
        self.current_step = 0

    # -- access ----------------------------------------------------------

    def __len__(self) -> int:
        return len(self._ring)

    def events(self, rid: Optional[int] = None) -> List[TraceEvent]:
        if rid is None:
            return list(self._ring)
        return [e for e in self._ring if e.rid == rid]

    def spans(self, name: Optional[str] = None) -> List[SpanEvent]:
        if name is None:
            return list(self._spans)
        return [s for s in self._spans if s.name == name]

    @property
    def wall_offset(self) -> float:
        return self._wall_offset

    # -- derived per-request stats --------------------------------------

    def request_stats(self, rid: int) -> Dict[str, Any]:
        """Derived intervals for one request: queue wait (submit->admit),
        TTFT (submit->first_token), TPOT (mean decode-step delta), plus
        raw per-kind timestamps. Keys are absent when the ring no longer
        holds the events they need."""
        ts_of: Dict[str, float] = {}
        decode_ts: List[float] = []
        n_chunks = 0
        prefix_blocks = None
        for e in self._ring:
            if e.rid != rid:
                continue
            if e.kind == DECODE_STEP:
                decode_ts.append(e.ts)
            elif e.kind == PREFILL_CHUNK:
                n_chunks += 1
            elif e.kind == PREFIX_HIT:
                prefix_blocks = e.fields.get("blocks")
            if e.kind not in ts_of:  # first occurrence (re-admits later)
                ts_of[e.kind] = e.ts
        out: Dict[str, Any] = {"rid": rid, "n_decode_steps": len(decode_ts),
                               "n_prefill_chunks": n_chunks}
        if prefix_blocks is not None:
            out["prefix_hit_blocks"] = prefix_blocks
        if SUBMIT in ts_of and ADMIT in ts_of:
            out["queue_wait_s"] = ts_of[ADMIT] - ts_of[SUBMIT]
        if SUBMIT in ts_of and FIRST_TOKEN in ts_of:
            out["ttft_s"] = ts_of[FIRST_TOKEN] - ts_of[SUBMIT]
        if len(decode_ts) >= 1 and FIRST_TOKEN in ts_of:
            # time-per-output-token over the decode phase: first token is
            # t0, each decode step lands one more token
            out["tpot_s"] = ((decode_ts[-1] - ts_of[FIRST_TOKEN])
                             / len(decode_ts))
        return out

    def summary(self) -> Dict[str, Any]:
        """Aggregate derived stats over every rid present in the ring —
        TTFT / TPOT / queue-wait percentiles the bench reports."""
        rids = sorted({e.rid for e in self._ring})
        per = [self.request_stats(r) for r in rids]

        def pct(key):
            vals = [p[key] for p in per if key in p]
            if not vals:
                return {}
            a = np.asarray(vals)
            return {"p50": float(np.percentile(a, 50)),
                    "p95": float(np.percentile(a, 95)),
                    "mean": float(a.mean()), "n": len(vals)}

        return {"requests": len(rids), "events": len(self._ring),
                "dropped": self.dropped,
                "ttft_s": pct("ttft_s"), "tpot_s": pct("tpot_s"),
                "queue_wait_s": pct("queue_wait_s")}

    # -- export ----------------------------------------------------------

    def export_jsonl(self, path: str) -> int:
        """Dump the ring to a JSONL file (one event per line, wall-clock
        stamped). Returns the number of events written."""
        with TraceWriter(path, wall_offset=self._wall_offset) as w:
            for e in self._ring:
                w.write(e)
        return len(self._ring)

    def export_chrome_trace(self, path_or_file) -> int:
        """Write Chrome trace-event JSON (loads in Perfetto / chrome://
        tracing). Returns the number of trace events written. See
        :func:`export_chrome_trace`."""
        return export_chrome_trace(self, path_or_file)


class _SpanTimer:
    """Context manager: one ``perf_counter`` pair feeds both the phase
    histogram (seconds observed) and the tracer's span ring."""

    __slots__ = ("_tracer", "_name", "_hist", "_t0")

    def __init__(self, tracer: RequestTracer, name: str, hist=None):
        self._tracer = tracer
        self._name = name
        self._hist = hist

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self._t0
        if self._hist is not None:
            self._hist.observe(dur)
        self._tracer.span(self._name, self._t0, dur)
        return False


def _us(ts: float, base: float) -> float:
    """Monotonic seconds -> trace microseconds relative to ``base``."""
    return round((ts - base) * 1e6, 3)


# fixed pids for the exported trace: engine phases vs request lifecycles
_PID_ENGINE = 1
_PID_REQUESTS = 2


def export_chrome_trace(tracer: RequestTracer, path_or_file) -> int:
    """Export the tracer's spans + lifecycle events as Chrome
    trace-event JSON (the format Perfetto and chrome://tracing load).

    Layout:

    * **pid 1 "engine" / tid 0** — one ``X`` (complete) slice per
      recorded span. Phase spans (``admit``, ``decode_dispatch``, ...)
      nest under their enclosing ``step`` span by timestamp containment;
      ``args.step`` carries the engine step number.
    * **pid 2 "requests" / tid = rid** — per-request track: synthetic
      ``queued`` / ``prefill`` / ``decode`` interval slices derived from
      the lifecycle stream, every raw lifecycle event as an ``i``
      instant (fields in ``args``), and ``s``/``t``/``f`` flow arrows
      (id = rid) stitching the request's stages together so Perfetto
      draws the hand-off across tracks.

    Timestamps are microseconds relative to the earliest recorded event
    (Chrome traces care about relative placement, not epoch).
    """
    spans = list(tracer._spans)
    events = list(tracer._ring)
    ts0 = min([s.ts for s in spans] + [e.ts for e in events],
              default=0.0)

    out: List[Dict[str, Any]] = [
        {"ph": "M", "name": "process_name", "pid": _PID_ENGINE, "tid": 0,
         "ts": 0, "args": {"name": "engine"}},
        {"ph": "M", "name": "thread_name", "pid": _PID_ENGINE, "tid": 0,
         "ts": 0, "args": {"name": "engine.step"}},
        {"ph": "M", "name": "process_name", "pid": _PID_REQUESTS, "tid": 0,
         "ts": 0, "args": {"name": "requests"}},
    ]

    for s in spans:
        out.append({"ph": "X", "name": s.name, "cat": "phase",
                    "pid": _PID_ENGINE, "tid": 0, "ts": _us(s.ts, ts0),
                    "dur": round(s.dur * 1e6, 3),
                    "args": {"step": s.step}})

    by_rid: Dict[int, List[TraceEvent]] = {}
    for e in events:
        by_rid.setdefault(e.rid, []).append(e)

    for rid, evs in sorted(by_rid.items()):
        out.append({"ph": "M", "name": "thread_name", "pid": _PID_REQUESTS,
                    "tid": rid, "ts": 0, "args": {"name": f"req {rid}"}})
        first: Dict[str, float] = {}
        for e in evs:
            if e.kind not in first:
                first[e.kind] = e.ts
            out.append({"ph": "i", "name": e.kind, "cat": "lifecycle",
                        "pid": _PID_REQUESTS, "tid": rid,
                        "ts": _us(e.ts, ts0), "s": "t",
                        "args": dict(e.fields)})
        last_ts = evs[-1].ts
        # synthetic stage slices: queued -> prefill -> decode
        stages = []
        if SUBMIT in first and ADMIT in first:
            stages.append(("queued", first[SUBMIT], first[ADMIT]))
        if ADMIT in first and FIRST_TOKEN in first:
            stages.append(("prefill", first[ADMIT], first[FIRST_TOKEN]))
        if FIRST_TOKEN in first:
            end = first.get(FINISH, last_ts)
            stages.append(("decode", first[FIRST_TOKEN], end))
        for i, (name, t_lo, t_hi) in enumerate(stages):
            out.append({"ph": "X", "name": name, "cat": "request",
                        "pid": _PID_REQUESTS, "tid": rid,
                        "ts": _us(t_lo, ts0),
                        "dur": round(max(t_hi - t_lo, 0.0) * 1e6, 3),
                        "args": {"rid": rid}})
            # flow arrows thread the stages in lifecycle order
            ph = "s" if i == 0 else ("f" if i == len(stages) - 1 else "t")
            if len(stages) > 1:
                out.append({"ph": ph, "name": f"req{rid}",
                            "cat": "lifecycle", "id": rid,
                            "pid": _PID_REQUESTS, "tid": rid,
                            "ts": _us(t_lo, ts0)})

    doc = {"traceEvents": out, "displayTimeUnit": "ms"}
    if hasattr(path_or_file, "write"):
        json.dump(doc, path_or_file)
    else:
        with open(path_or_file, "w") as f:
            json.dump(doc, f)
    return len(out)


class TraceWriter:
    """Streaming JSONL sink for trace events.

    One JSON object per line; floats use python's shortest-repr encoding
    so a parse of the file reproduces every timestamp bit-exactly
    (round-trip pinned by ``tests/test_torch_trace.py``). Usable as a
    context manager or with an already-open file object.
    """

    def __init__(self, path_or_file, wall_offset: float = 0.0):
        if hasattr(path_or_file, "write"):
            self._f: IO = path_or_file
            self._own = False
        else:
            self._f = open(path_or_file, "w")
            self._own = True
        self.wall_offset = wall_offset
        self.n_written = 0

    def write(self, event: TraceEvent) -> None:
        self._f.write(json.dumps(event.to_dict(self.wall_offset),
                                 separators=(",", ":")) + "\n")
        self.n_written += 1

    def close(self) -> None:
        if self._own:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def read_jsonl(path_or_lines) -> List[TraceEvent]:
    """Parse a TraceWriter JSONL file (or iterable of lines) back into
    events."""
    if isinstance(path_or_lines, str):
        with open(path_or_lines) as f:
            lines: Iterable[str] = f.readlines()
    else:
        lines = path_or_lines
    return [TraceEvent.from_dict(json.loads(ln))
            for ln in lines if ln.strip()]
