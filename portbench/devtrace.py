"""Device trace of a steady part of the window, reduced to numbers.

``torch.profiler`` (CUPTI) records every kernel on the card while it is on.
From its events: busy seconds (the union of device activity), the kernels'
device time by name, the ten busiest, and the idle gaps, each charged to
what the host was doing then: the engine's phase spans (the port's
``RequestTracer``) that overlap it, the rest of a ``step`` span, else
``harness``. The
profiler's clock is tied to ``time.perf_counter`` by a marker.
"""
from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional, Tuple

import torch

MARK = "portbench.mark"


def _ns(e, which: str) -> int:
    fn = getattr(e, f"{which}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(e, f"{which}_us")() * 1000)


class DeviceTrace:
    """Readied when made (the profiler's set-up stalls the host), then
    ``start()`` and ``stop()`` around whole steps, then ``reduce(spans)``."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.prepare_trace()
        self.done = False

    def start(self) -> None:
        self.prof.start_trace()
        self.t0 = time.perf_counter()
        with torch.profiler.record_function(MARK):
            self.mark = time.perf_counter_ns()

    def stop(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop_trace()
        self.done = True

    def reduce(self, spans: List[Tuple[str, float, float]]) -> dict:
        """``spans``: (name, start, seconds) on the perf_counter clock."""
        events = self.prof.profiler.kineto_results.events()
        offset = None
        dev: List[Tuple[int, int, str]] = []
        for e in events:
            if e.device_type() == torch.autograd.DeviceType.CPU:
                if offset is None and e.name() == MARK:
                    offset = _ns(e, "start") - self.mark
                continue
            start = _ns(e, "start")
            dev.append((start, start + _ns(e, "duration"), e.name()))
        if offset is None:
            raise RuntimeError("the profiler lost its clock marker")
        lo = int(self.t0 * 1e9) + offset
        hi = int(self.t1 * 1e9) + offset
        by_name: Dict[str, float] = collections.defaultdict(float)
        merged: List[List[int]] = []
        for s, e, name in sorted(dev):
            by_name[name] += (e - s) * 1e-9
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        busy = sum(e - s for s, e in merged) * 1e-9
        gaps, prev = [], lo
        for s, e in merged:
            if s > prev:
                gaps.append((prev, s))
            prev = e
        if hi > prev:
            gaps.append((prev, hi))
        host = [(int(t * 1e9) + offset, int((t + d) * 1e9) + offset, name)
                for name, t, d in spans]
        idle = _charge(gaps, host)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])
        return {"busy_s": busy, "window_s": (hi - lo) * 1e-9,
                "kernels": dict(by_name),
                "device_ops": [[n, v] for n, v in top[:10]],
                "idle_gaps": [[n, v] for n, v in sorted(
                    idle.items(), key=lambda kv: -kv[1])[:10]]}


def _charge(gaps, host) -> Dict[str, float]:
    """Idle seconds by what the host was doing: each gap's overlap with
    the engine's phase spans, the rest of it inside a ``step`` span as
    ``step``, and outside every span as ``harness``."""
    leaves = sorted(h for h in host if h[2] != "step")
    steps = sorted(h for h in host if h[2] == "step")
    idle: Dict[str, float] = collections.defaultdict(float)

    def overlap(s, e, spans):
        out = []
        for a, b, name in spans:
            if a >= e:
                break
            if b > s:
                out.append((max(a, s), min(b, e), name))
        return out

    for s, e in gaps:
        covered = 0
        for a, b, name in overlap(s, e, leaves):
            idle[name] += (b - a) * 1e-9
            covered += b - a
        in_step = sum(b - a for a, b, _ in overlap(s, e, steps))
        idle["step"] += max(in_step - covered, 0) * 1e-9
        idle["harness"] += max(e - s - max(in_step, covered), 0) * 1e-9
    return {k: v for k, v in idle.items() if v > 0}


def kernel_seconds(kernels: Dict[str, float], *names: str) -> Optional[float]:
    """Device seconds of the kernels whose name holds any of ``names``
    (None when none ran)."""
    hits = [v for k, v in kernels.items() if any(n in k for n in names)]
    return sum(hits) if hits else None
