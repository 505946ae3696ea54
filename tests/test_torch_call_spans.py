"""Call spans inside the model call (``repro_torch.spans`` and the tracer's
call ring), on a tiny dense and a tiny MoE config through
``ContinuousBatchingEngine`` on the CPU:

  * each decode call records one ``attn`` and one ``mlp`` or ``moe`` span
    a layer, with their children, each parent right, all inside their
    ``decode_dispatch`` span;
  * prefill records ``kv.prefix_tree``, ``kv.scatter`` and ``sample``
    inside ``prefill_dispatch``;
  * with metrics off nothing is recorded and a model call reads no clock;
  * the tokens are the same with metrics on and off;
  * the call ring drops its oldest spans and counts them, apart from the
    phase ring;
  * the Chrome trace carries them on a "model" track of the engine.

Tests compare names, parents, layers, counts and containment, never
durations.
"""
import functools
import json
import time

import numpy as np
import pytest
import torch

from repro_torch import configs as TC
from repro_torch import spans as call_spans
from repro_torch.models import params as pp
from repro_torch.models.model import Model
from repro_torch.serve import (ContinuousBatchingEngine, EngineConfig,
                               SamplingParams)
from repro_torch.serve.trace import RequestTracer

ARCHS = ["smollm-135m", "qwen2-moe-a2.7b"]
CHILDREN = {"attn": ["attn.core"], "mlp": [],
            "moe": ["moe.router", "moe.experts", "moe.combine",
                    "moe.shared"]}
EPS = 1e-9  # float rounding of ts + dur


@functools.cache
def _setup(arch):
    cfg = TC.get_smoke(arch).replace(compute_dtype="float32")
    params = pp.init_params(Model(cfg).build(),
                            torch.Generator().manual_seed(0), device="cpu")
    return cfg, params


def _serve(arch, enable_metrics=True, trace_capacity=65536):
    cfg, params = _setup(arch)
    eng = ContinuousBatchingEngine(
        cfg, params, config=EngineConfig(
            max_len=48, n_slots=2, prefix_cache=True, block_size=8,
            use_paged_kernel=True, enable_metrics=enable_metrics,
            trace_capacity=trace_capacity), device="cpu")
    rng = np.random.default_rng(3)
    rids = [eng.submit(rng.integers(0, cfg.vocab, n).astype(np.int32),
                       SamplingParams(max_tokens=4)) for n in (5, 11, 9)]
    out = eng.drain()
    return eng, [out[r] for r in rids]


def _inside(c, p):
    return p.ts <= c.ts and c.ts + c.dur <= p.ts + p.dur + EPS


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_call_spans_per_layer(arch):
    eng, _ = _serve(arch)
    n_layers = eng.cfg.n_layers
    ffn = "moe" if eng.cfg.family == "moe" else "mlp"
    calls = eng.tracer.call_spans()
    dispatches = eng.tracer.spans("decode_dispatch")
    assert len(dispatches) == eng.n_decode_steps > 0
    for d in dispatches:
        mine = [c for c in calls if _inside(c, d)]
        top = [c for c in mine if c.parent == "decode_dispatch"]
        assert sorted(c.name for c in top) == sorted(
            ["embed", "unembed"] + ["attn", ffn] * n_layers)
        for kind in ("attn", ffn):
            blocks = [c for c in top if c.name == kind]
            assert sorted(c.layer for c in blocks) == list(range(n_layers))
            for b in blocks:
                kids = [c for c in mine if _inside(c, b) and c is not b]
                assert sorted(c.name for c in kids) == sorted(CHILDREN[kind])
                assert all(c.parent == kind and c.layer == b.layer
                           and c.step == d.step for c in kids)
        assert all(c.layer == -1 for c in top
                   if c.name in ("embed", "unembed"))
    # every span under a decode dispatch lies inside one
    assert all(any(_inside(c, d) for d in dispatches) for c in calls
               if c.parent == "decode_dispatch")
    # block tables go to the device once a decode step, under the step
    assert len(eng.tracer.call_spans("kv.tables")) == eng.n_decode_steps
    assert {c.parent for c in eng.tracer.call_spans("kv.tables")} == {"step"}


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_records_cache_and_sample_spans(arch):
    eng, _ = _serve(arch)
    dispatches = eng.tracer.spans("prefill_dispatch")
    assert dispatches
    for name in ("kv.prefix_tree", "kv.scatter", "sample"):
        got = eng.tracer.call_spans(name)
        assert len(got) == eng.n_prefill_calls > 0, name
        assert all(c.parent == "prefill_dispatch" and c.layer == -1
                   and any(_inside(c, d) for d in dispatches) for c in got)
    m = eng.metrics()["trace"]
    assert m["call_spans"] == len(eng.tracer.call_spans()) > 0
    assert m["dropped_call_spans"] == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_metrics_off_records_nothing_and_reads_no_clock(arch, monkeypatch):
    cfg, params = _setup(arch)
    eng = ContinuousBatchingEngine(
        cfg, params, config=EngineConfig(
            max_len=48, n_slots=2, prefix_cache=True, block_size=8,
            use_paged_kernel=True, enable_metrics=False), device="cpu")
    clock = time.perf_counter
    reads = []
    model_calls = []

    def counting():
        reads.append(1)
        return clock()

    def watched(real):
        def call(*a, **kw):
            model_calls.append(call_spans._active)
            monkeypatch.setattr(time, "perf_counter", counting)
            try:
                return real(*a, **kw)
            finally:
                monkeypatch.setattr(time, "perf_counter", clock)
        return call

    for entry in ("prefill_bucketed", "decode_step"):
        setattr(eng.model, entry, watched(getattr(eng.model, entry)))
    eng.submit(np.arange(7, dtype=np.int32), SamplingParams(max_tokens=4))
    eng.drain()
    assert len(model_calls) == eng.n_prefill_calls + eng.n_decode_steps > 1
    assert set(model_calls) == {None}
    assert reads == []
    assert eng.tracer.call_spans() == []
    assert eng.metrics()["trace"]["call_spans"] == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_tokens_are_the_same_with_metrics_on_and_off(arch):
    _, on = _serve(arch, enable_metrics=True)
    _, off = _serve(arch, enable_metrics=False)
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a, b)
    assert call_spans._active is None  # the slot is empty between steps


def test_call_ring_drops_oldest_and_counts_apart_from_phases():
    t = RequestTracer(capacity=4)
    with t.span_timer("decode_dispatch"):
        for i in range(6):
            with t.call_span("attn", layer=i):
                with t.call_span("attn.core"):
                    pass
    got = t.call_spans()
    assert len(got) == 4 and t.dropped_call_spans == 8
    assert [(c.name, c.layer) for c in got] == [
        ("attn.core", 4), ("attn", 4), ("attn.core", 5), ("attn", 5)]
    assert [c.parent for c in got] == ["attn", "decode_dispatch"] * 2
    assert [s.name for s in t.spans()] == ["decode_dispatch"]
    assert t.dropped_spans == 0
    t.reset()
    assert t.call_spans() == [] and t.dropped_call_spans == 0


def test_engine_call_ring_drops_apart_from_phases():
    eng, _ = _serve("smollm-135m", trace_capacity=64)
    m = eng.metrics()["trace"]
    assert m["call_spans"] == 64 and m["dropped_call_spans"] > 0
    assert m["dropped_spans"] == 0 and m["spans"] == len(eng.tracer.spans())


def test_chrome_trace_puts_call_spans_on_a_model_track(tmp_path):
    eng, _ = _serve("qwen2-moe-a2.7b")
    path = tmp_path / "trace.json"
    n = eng.tracer.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    assert n == len(events)
    names = {(e["pid"], e["tid"]): e["args"]["name"] for e in events
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert names[(1, 0)] == "engine.step" and names[(1, 1)] == "model"
    model = [e for e in events if e["ph"] == "X" and e["pid"] == 1
             and e["tid"] == 1]
    assert len(model) == len(eng.tracer.call_spans())
    assert all(e["cat"] == "call" and {"step", "layer", "parent"}
               <= set(e["args"]) for e in model)
    router = [e for e in model if e["name"] == "moe.router"]
    assert router and {e["args"]["parent"] for e in router} == {"moe"}
    assert {e["args"]["layer"] for e in router} == set(
        range(eng.cfg.n_layers))
    phases = [e for e in events if e["ph"] == "X" and e["pid"] == 1
              and e["tid"] == 0]
    assert {e["name"] for e in phases} >= {"step", "decode_dispatch"}
