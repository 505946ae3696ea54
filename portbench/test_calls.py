"""CPU tests of the call-span readers (``portbench/metrics/_calls.py``) on a
hand-built profiler event list: kernels charged through their launch's
correlation id, idle gaps under nested spans charged once, the shares
bounded by ``device_idle``, and every reader None where it cannot read."""
from __future__ import annotations

import copy
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

from portbench.devtrace import MARK, DeviceTrace  # noqa: E402
from portbench.metrics import _calls, reader  # noqa: E402
from repro_torch.serve.trace import SpanEvent  # noqa: E402

T0 = 1.0  # perf_counter seconds at the traced span's start
OFFSET = 4_000_000_000  # profiler ns minus perf_counter ns
READERS = ("idle_in_model", "idle_in_kv", "host_wait_ms", "moe_route_share")


class Event:
    """The part of a kineto event the readers use; times in ms past T0."""

    def __init__(self, name, start_ms, dur_ms, corr=0, cpu=True):
        self._name, self._corr, self._cpu = name, corr, cpu
        self._start = int(T0 * 1e9) + OFFSET + round(start_ms * 1e6)
        self._dur = round(dur_ms * 1e6)

    def device_type(self):
        return (torch.autograd.DeviceType.CPU if self._cpu
                else torch.autograd.DeviceType.CUDA)

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def correlation_id(self):
        return self._corr


def _span(name, lo_ms, hi_ms, layer=-1, parent=""):
    return SpanEvent(name, T0 + lo_ms / 1e3, (hi_ms - lo_ms) / 1e3, 0, layer,
                     parent)


PHASES = [_span("step", 0, 100), _span("decode_dispatch", 10, 60),
          _span("device_sync", 60, 90)]
CALLS = [_span("kv.tables", 2, 8, parent="step"),
         _span("attn.core", 20, 30, 0, "attn"),
         _span("attn", 15, 40, 0, "decode_dispatch"),
         _span("moe.router", 41, 45, 0, "moe"),
         _span("moe", 40, 58, 0, "decode_dispatch")]
RUNTIME = [Event("cudaLaunchKernel", 25, 0.01, corr=1),  # in attn.core
           Event("cudaLaunchKernel", 17, 0.01, corr=2),  # in attn
           Event("cudaMemcpyAsync", 4, 2, corr=3),  # waits in kv.tables
           Event("cudaStreamSynchronize", 61, 20, corr=4),  # a phase's wait
           Event("cudaLaunchKernel", 42, 0.01, corr=5),  # in moe.router
           # an operator whose own id equals a launch's: never a launch
           Event("aten::mm", 50, 1, corr=1)]
DEVICE = [Event("kernel_a", 30, 20, corr=1, cpu=False),
          Event("kernel_b", 50, 5, corr=2, cpu=False),
          Event("Memcpy HtoD", 5, 1, corr=3, cpu=False),
          Event("kernel_router", 55, 2, corr=5, cpu=False)]
# busy: [5, 6) and [30, 57), 28 ms of 100; idle gaps [0, 5), [6, 30),
# [57, 100): kv.tables 3 + 2, attn 5, attn.core 10, moe 1, the rest the
# phases' own


def _shifted(events, ms):
    out = []
    for e in events:
        e = copy.copy(e)
        e._start += round(ms * 1e6)
        out.append(e)
    return out


def _run(device=DEVICE, dropped=0, cuda=True, calls=True, runtime=RUNTIME,
         skew_ms=0.0):
    """``skew_ms``: the runtime's and the device's events stand that far
    from the marker's clock."""
    mark = int(T0 * 1e9) - 1000
    events = [Event(MARK, -0.001, 0.0001)] + _shifted(runtime + device,
                                                       skew_ms)
    events[0]._start = mark + OFFSET
    dt = object.__new__(DeviceTrace)
    dt.cuda, dt.done, dt.mark, dt.t0, dt.t1 = cuda, True, mark, T0, T0 + 0.1
    dt.prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))

    class Tracer:
        dropped_call_spans = dropped

        def spans(self, name=None):
            return [s for s in PHASES if name in (None, s.name)]

        if calls:
            def call_spans(self):
                return list(CALLS)

    run = SimpleNamespace(devtrace=dt, engine=SimpleNamespace(tracer=Tracer()))
    run.devtrace_result = dt.reduce([(s.name, s.ts, s.dur) for s in PHASES])
    return run


def test_a_kernel_goes_to_the_innermost_span_of_its_launch():
    t = _calls.reduce(_run())
    rows = t["rows"]
    dev = {name: r["device_s"] for (_, name), r in rows.items()
           if r["device_s"]}
    assert dev == pytest.approx({"attn.core": 0.020, "attn": 0.005,
                                 "kv.tables": 0.001, "moe.router": 0.002})
    assert t["tied"] == 1.0 and t["steps"] == 1
    assert rows[("decode_dispatch", "attn.core")]["call"]
    assert rows[("step", "kv.tables")]["count"] == 1
    assert not rows[("decode_dispatch", "decode_dispatch")]["call"]


def test_a_gap_under_nested_spans_is_charged_once():
    run = _run()
    t = _calls.reduce(run)
    idle = {name: r["idle_s"] for (_, name), r in t["rows"].items()
            if r["idle_s"] > 1e-9}
    assert idle == pytest.approx({
        "step": 0.014, "kv.tables": 0.005, "decode_dispatch": 0.007,
        "attn": 0.005, "attn.core": 0.010, "moe": 0.001,
        "device_sync": 0.030}, abs=1e-8)
    total = t["window_s"] - t["busy_s"]
    assert sum(idle.values()) == pytest.approx(total, abs=1e-8)
    assert t["busy_s"] == pytest.approx(run.devtrace_result["busy_s"])
    # self time: every piece of the traced span has one innermost span
    assert sum(r["self_s"] for r in t["rows"].values()) == pytest.approx(
        t["window_s"], abs=1e-8)


def test_the_shares_and_the_waits():
    run = _run()
    got = {name: reader(name)(run) for name in READERS}
    assert got == pytest.approx({"idle_in_model": 16.0, "idle_in_kv": 5.0,
                                 "host_wait_ms": 2.0,
                                 "moe_route_share": 100 * 2 / 28}, abs=1e-5)
    idle = reader("device_idle")(run)
    assert idle == pytest.approx(72.0, abs=1e-5)
    assert got["idle_in_model"] + got["idle_in_kv"] <= idle


def test_a_runtime_clock_apart_from_the_marker_is_tied_by_the_syncs():
    """The CUDA runtime's events 3 ms after the marker's clock: without an
    anchor a launch is looked up in the wrong span; the engine's
    ``cudaDeviceSynchronize``, ending with its ``device_sync`` span, ties
    the clocks again."""
    # inside device_sync [60, 90), 10 µs from either end
    sync = [Event("cudaDeviceSynchronize", 60.01, 29.98, corr=6)]
    base = _calls.reduce(_run(runtime=RUNTIME + sync))
    skewed = _calls.reduce(_run(runtime=RUNTIME + sync, skew_ms=3))
    lost = _calls.reduce(_run(skew_ms=3))
    assert base["skew_us"] == pytest.approx([0, 0, 0], abs=1e-2)
    assert skewed["skew_us"] == pytest.approx([3000] * 3, abs=1e-2)
    assert lost["skew_us"] is None
    assert skewed["rows"].keys() == base["rows"].keys()
    for key, row in base["rows"].items():
        assert skewed["rows"][key] == pytest.approx(row, abs=1e-8), key
    # the marker alone charges attn's launch to attn.core
    assert lost["rows"][("decode_dispatch", "attn")]["device_s"] == 0


@pytest.mark.parametrize("case", [
    dict(dropped=1), dict(cuda=False), dict(calls=False),
    dict(device=DEVICE + [Event("orphan", 60, 1, corr=99, cpu=False)])])
def test_a_reader_returns_none_where_it_cannot_read(case):
    """A dropped call span, no card, a program that records no call spans
    (the parent of this benchmark's readers), or under 99 % of the device
    seconds tied to a launch: every reader None, none raising."""
    run = _run(**case)
    assert [reader(name)(run) for name in READERS] == [None] * len(READERS)
