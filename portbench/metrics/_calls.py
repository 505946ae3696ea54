"""Shared work of the call-span readers (``idle_in_model``, ``idle_in_kv``,
``host_wait_ms``, ``moe_route_share``): the device trace charged to the
spans the program records inside each step, once a run (:func:`reduce`,
memoized on the run).

* Each device event (kernel, copy, set) is tied through its correlation id
  to the runtime call that launched it; its device seconds in the traced
  span go to the innermost span open at that launch: a call span (a model
  layer, a cache operation, ``sample``), else the engine phase, else
  ``harness``.
* Each idle gap of the device is charged, nanosecond by nanosecond, to the
  innermost span the host was in. The spans nest on one thread, so one
  sweep cuts the timeline into pieces of one innermost span each, and
  nothing is counted twice.
* Each runtime call that waits on the device or copies through host
  memory (its name holds ``Synchronize`` or ``Memcpy``) is charged, in
  host seconds, to the innermost span open at its start.

The profiler clock is tied to ``perf_counter`` by the marker that
:mod:`portbench.devtrace` records, and the CUDA runtime's events to the
spans by the engine's device syncs (:func:`_offset`). :func:`reduce`
returns None, and every reader with it, when the run has no CUDA device,
the program records no call spans or dropped any, or fewer than 99 % of
the traced device seconds tie to a launch.
"""
from __future__ import annotations

import bisect
import collections
from typing import Dict, List, Optional, Tuple

import torch

from portbench.devtrace import MARK, _ns

TIED = 0.99  # least share of device seconds tied to a launch
WAITS = ("Synchronize", "Memcpy")
ANCHOR = "DeviceSynchronize"  # the engine's device_sync phase, traced
MAX_SKEW = 10_000_000  # ns: farthest an anchor may stand from the marker
MODEL = ("embed", "attn", "mlp", "moe", "unembed")  # and their children
HARNESS = ("", "harness")  # (phase, name) of time outside every span


def is_model(name: str) -> bool:
    return name.split(".")[0] in MODEL


def is_kv(name: str) -> bool:
    return name.startswith("kv.")


def reduce(run) -> Optional[dict]:
    """``{"window_s", "busy_s", "tied", "steps", "skew_us", "rows"}`` of a
    traced run, or None (see the module docstring). ``rows`` maps (phase,
    name) to ``{"call", "count", "self_s", "device_s", "idle_s",
    "wait_s"}``: the spans of that name under that engine phase (a phase
    under itself),
    their host self time, the device seconds they launched, the idle
    seconds and waiting calls charged to them, all inside the traced
    span; ``steps`` counts the engine steps there; ``skew_us`` is
    :func:`_offset`'s."""
    if "call_trace" not in vars(run):
        run.call_trace = _reduce(run)
    return run.call_trace


def _reduce(run) -> Optional[dict]:
    dt = getattr(run, "devtrace", None)
    engine = getattr(run, "engine", None)
    if dt is None or not dt.cuda or not dt.done or engine is None:
        return None
    tracer = engine.tracer
    if not hasattr(tracer, "call_spans") or tracer.dropped_call_spans:
        return None
    calls = tracer.call_spans()
    if not calls:
        return None
    offset, launch, device, waits, syncs = _events(dt)
    if offset is None:
        return None
    offset, skew = _offset(offset, syncs, [
        s for s in tracer.spans("device_sync")
        if dt.t0 <= s.ts + s.dur <= dt.t1])
    lo = int(dt.t0 * 1e9) + offset
    hi = int(dt.t1 * 1e9) + offset

    spans = [(s, False) for s in tracer.spans()] + [(s, True) for s in calls]
    nodes, segs = _sweep(spans, offset, lo, hi)
    starts = [s for s, _, _ in segs]
    rows: Dict[Tuple[str, str], dict] = collections.defaultdict(
        lambda: {"call": False, "count": 0, "self_s": 0.0, "device_s": 0.0,
                 "idle_s": 0.0, "wait_s": 0.0})
    for key, call in nodes:
        rows[key]["call"] = call
        rows[key]["count"] += 1

    def at(t: int):
        i = bisect.bisect_right(starts, t) - 1
        return nodes[segs[i][2]][0] if i >= 0 and t < segs[i][1] else HARNESS

    def spread(a: int, b: int, field: str) -> None:
        """Charge [a, b) to the pieces it overlaps, the rest to harness."""
        covered = 0
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(segs) and segs[i][0] < b:
            s, e, n = segs[i]
            o = min(e, b) - max(s, a)
            if o > 0:
                rows[nodes[n][0]][field] += o * 1e-9
                covered += o
            i += 1
        rows[HARNESS][field] += (b - a - covered) * 1e-9

    for s, e, n in segs:
        rows[nodes[n][0]]["self_s"] += (e - s) * 1e-9

    busy: List[Tuple[int, int]] = []
    tied = 0
    for s, e, corr in device:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        busy.append((s, e))
        if corr in launch:
            tied += e - s
            rows[at(launch[corr])]["device_s"] += (e - s) * 1e-9
    total = sum(e - s for s, e in busy)
    if not total or tied < TIED * total:
        return None
    merged = _union(busy)
    prev = lo
    for s, e in merged + [[hi, hi]]:
        if s > prev:
            spread(prev, s, "idle_s")
        prev = max(prev, e)

    for a, b in _union(waits):
        a, b = max(a, lo), min(b, hi)
        if b > a:
            rows[at(a)]["wait_s"] += (b - a) * 1e-9

    steps = sum(1 for s in tracer.spans("step")
                if lo <= int(s.ts * 1e9) + offset < hi)
    return {"window_s": (hi - lo) * 1e-9,
            "busy_s": sum(e - s for s, e in merged) * 1e-9,
            "tied": tied / total, "steps": steps, "skew_us": skew,
            "rows": dict(rows)}


def _events(dt):
    """(clock offset, {correlation id: launch start}, device events
    [(start, end, correlation id)], waiting runtime calls [(start, end)],
    the ``cudaDeviceSynchronize`` calls [(start, end)] by end) from the
    profiler's events, all in profiler nanoseconds."""
    offset = None
    launch: Dict[int, int] = {}
    device: List[Tuple[int, int, int]] = []
    waits: List[Tuple[int, int]] = []
    syncs: List[Tuple[int, int]] = []
    for e in dt.prof.profiler.kineto_results.events():
        start = _ns(e, "start")
        if e.device_type() == torch.autograd.DeviceType.CPU:
            name = e.name()
            if name == MARK:
                if offset is None:
                    offset = start - dt.mark
            elif name.startswith("cu") and e.correlation_id():
                # a CUDA API call (cuda*, cu*): what launched the device work
                # of its correlation id (the outermost, where calls nest)
                corr = e.correlation_id()
                launch[corr] = min(start, launch.get(corr, start))
                if any(w in name for w in WAITS):
                    waits.append((start, start + _ns(e, "duration")))
                if ANCHOR in name:
                    syncs.append((start, start + _ns(e, "duration")))
            continue
        device.append((start, start + _ns(e, "duration"),
                       e.correlation_id()))
    return offset, launch, device, waits, sorted(syncs, key=lambda c: c[1])


def _offset(mark: int, syncs: List[Tuple[int, int]], anchors):
    """The offset (profiler ns minus ``perf_counter`` ns) of the CUDA
    runtime's events, and the anchors' skew from the marker's offset in µs
    ([least, median, most], None without anchors: the marker's offset).

    The marker ties the profiler's clock for operators to ``perf_counter``;
    launches, copies and kernels carry the CUDA runtime's timestamps, which
    stood 60-190 µs after it on the card, more than the host spends
    between a layer's last launch and the next span (so a kernel would be
    charged to that span). Each ``device_sync`` phase span (``anchors``,
    those that end inside the traced span) holds its
    ``cudaDeviceSynchronize`` call ``syncs`` (start, end), the one whose
    end lies nearest the span's, within ``MAX_SKEW``: the call starts a
    little after the span and ends a little before it, so the offset lies
    between end gap and start gap. Each anchor gives their middle, and the
    offset is the median over anchors (no drift showed over a traced
    span)."""
    ends = [e for _, e in syncs]
    mids = []
    for s in anchors:
        a, b = int(s.ts * 1e9), int((s.ts + s.dur) * 1e9)
        i = bisect.bisect_left(ends, b + mark)
        near = [syncs[j] for j in (i - 1, i) if 0 <= j < len(syncs)]
        if near:
            start, end = min(near, key=lambda c: abs(c[1] - b - mark))
            if abs(end - b - mark) <= MAX_SKEW:
                mids.append((start - a + end - b) // 2)
    if not mids:
        return mark, None
    mids.sort()
    skew = [(o - mark) / 1e3 for o in (mids[0], mids[len(mids) // 2],
                                       mids[-1])]
    return mids[len(mids) // 2], skew


def _sweep(spans, offset: int, lo: int, hi: int):
    """Cut [lo, hi) into pieces of one innermost span each.

    ``spans``: (SpanEvent, is a call span) on the ``perf_counter`` clock,
    nested on one thread. Returns (nodes [((phase, name), is call)], pieces
    [(start, end, node index)] sorted and disjoint). A call span's phase is
    the engine phase it runs in (``step`` for one directly under the step),
    a phase's its own name; a child that outlasts its parent by a rounding
    is cut to it."""
    ivs = []
    for s, call in spans:
        a = int(s.ts * 1e9) + offset
        b = int((s.ts + s.dur) * 1e9) + offset
        if b > lo and a < hi:
            ivs.append((max(a, lo), min(b, hi), s.name, call))
    ivs.sort(key=lambda v: (v[0], -v[1]))
    nodes: List[Tuple[Tuple[str, str], bool]] = []
    segs: List[Tuple[int, int, int]] = []
    stack: List[Tuple[int, int, str]] = []  # (end, node, phase)
    cursor = lo

    def close_to(t: int) -> None:
        nonlocal cursor
        while stack and stack[-1][0] <= t:
            end, n, _ = stack.pop()
            if end > cursor:
                segs.append((cursor, end, n))
            cursor = max(cursor, end)

    for a, b, name, call in ivs:
        close_to(a)
        if stack:
            if a > cursor:
                segs.append((cursor, a, stack[-1][1]))
            b = min(b, stack[-1][0])
        cursor = max(cursor, a)
        phase = name if not call else stack[-1][2] if stack else ""
        nodes.append(((phase, name), call))
        stack.append((b, len(nodes) - 1, phase))
    close_to(hi)
    return nodes, segs


def _union(ivs):
    """The union of [start, end) intervals, sorted and disjoint."""
    out: List[List[int]] = []
    for a, b in sorted(ivs):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out
