"""Trace semantics and engine-level observability of the port: the cases
of ``tests/test_trace.py`` against ``repro_torch`` on the CPU, and the
port's trace held equal to the JAX engine's on the same traffic and
bridged weights.

  * TTFT is exactly (first_token ts - submit ts); queue wait exactly
    (admit ts - submit ts); TPOT the mean decode-step delta;
  * events are strictly ordered per rid, under chunked prefill and prefix
    hits too, and each request's event kinds and fields equal the JAX
    engine's (staggered, prefix-hit, chunked, fused and speculative
    traffic);
  * JSONL export round-trips bit-exactly; the Chrome trace passes the
    reference's ``check_bench.check_chrome_trace``;
  * ``engine.metrics()`` is one snapshot, ``prefix_stats()`` a view of
    it, and ``engine.reset()`` clears metrics and trace;
  * with metrics off nothing is recorded and the tokens are the same.

Tests compare event kinds, order, fields and counts, never times.
"""
import functools
import json
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs as TC
from repro_torch.models import params as pp
from repro_torch.models.model import Model
from repro_torch.serve import (ContinuousBatchingEngine, EngineConfig,
                               SamplingParams)
from repro_torch.serve import trace as tr
from repro_torch.serve.trace import read_jsonl

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks"))
import check_bench  # noqa: E402

MAX_LEN = 48
BS = 8

# lifecycle phase rank per event kind: per-rid streams must never regress
# (UNADMIT shares ADMIT's rank — a starved request legitimately bounces)
_PHASE = {tr.SUBMIT: 0, tr.ADMIT: 1, tr.UNADMIT: 1, tr.PREFIX_HIT: 1,
          tr.PREFILL_CHUNK: 2, tr.FIRST_TOKEN: 3, tr.DECODE_STEP: 4,
          tr.SPEC_ACCEPT: 4, tr.FINISH: 5}


@functools.cache
def _setup():
    cfg = TC.get_smoke("smollm-135m").replace(compute_dtype="float32")
    params = pp.init_params(Model(cfg).build(),
                            torch.Generator().manual_seed(0), device="cpu")
    return cfg, params


def _engine(n_slots=2, **kw):
    cfg, params = _setup()
    return ContinuousBatchingEngine(
        cfg, params, config=EngineConfig(max_len=MAX_LEN, n_slots=n_slots,
                                         prefix_cache=True, block_size=BS,
                                         **kw), device="cpu")


def _prompt(rng, n):
    cfg, _ = _setup()
    return rng.integers(0, cfg.vocab, (n,)).astype(np.int32)


def _assert_ordered(events):
    assert events, "rid left no events"
    kinds = [e.kind for e in events]
    assert kinds[0] == tr.SUBMIT and kinds[-1] == tr.FINISH
    ts = [e.ts for e in events]
    assert ts == sorted(ts), "timestamps regressed"
    # a re-admission after unadmit may legally repeat phase 1; other
    # than that bounce, the lifecycle only moves forward
    ranks = [_PHASE[k] for k in kinds]
    for a, b in zip(ranks, ranks[1:]):
        assert b >= a or b == 1, (kinds, "lifecycle regressed")


# ---------------------------------------------------------------------------
# Derived-interval semantics
# ---------------------------------------------------------------------------


def test_ttft_tpot_queue_wait_from_raw_events(rng):
    eng = _engine()
    rid = eng.submit(_prompt(rng, 10), SamplingParams(max_tokens=6))
    eng.drain()
    evs = eng.tracer.events(rid)
    _assert_ordered(evs)
    first_of = {}
    for e in evs:
        first_of.setdefault(e.kind, e)
    stats = eng.tracer.request_stats(rid)
    assert stats["ttft_s"] == (first_of[tr.FIRST_TOKEN].ts
                               - first_of[tr.SUBMIT].ts)
    assert stats["queue_wait_s"] == (first_of[tr.ADMIT].ts
                                     - first_of[tr.SUBMIT].ts)
    dec = [e for e in evs if e.kind == tr.DECODE_STEP]
    # 6 generated tokens: first from prefill, 5 from decode steps
    assert len(dec) == 5 and stats["n_decode_steps"] == 5
    assert stats["tpot_s"] == ((dec[-1].ts - first_of[tr.FIRST_TOKEN].ts)
                               / len(dec))
    # decode steps carry their fold-in step index, strictly increasing
    assert [e.fields["step"] for e in dec] == list(range(1, 6))


def test_interleaved_requests_each_strictly_ordered(rng):
    eng = _engine(n_slots=2)
    rids = []
    for i in range(5):  # more requests than slots: recycling + queueing
        rids.append(eng.submit(_prompt(rng, 4 + 3 * i),
                               SamplingParams(max_tokens=4 + i, seed=i)))
        eng.step()
    eng.drain()
    for rid in rids:
        _assert_ordered(eng.tracer.events(rid))
    summ = eng.tracer.summary()
    assert summ["requests"] == 5 and summ["dropped"] == 0
    assert summ["ttft_s"]["n"] == 5 and summ["tpot_s"]["n"] == 5


def test_chunked_prefill_and_prefix_hit_events(rng):
    eng = _engine(n_slots=2, prefill_chunk=BS)
    base = _prompt(rng, 2 * BS + 3)
    r1 = eng.submit(base, SamplingParams(max_tokens=4, seed=0))
    eng.drain()  # commits base's blocks
    tail = np.concatenate([base, _prompt(rng, 5)])
    r2 = eng.submit(tail, SamplingParams(max_tokens=4, seed=1))
    eng.drain()
    evs1, evs2 = eng.tracer.events(r1), eng.tracer.events(r2)
    _assert_ordered(evs1)
    _assert_ordered(evs2)
    # r1: no cached prefix -> ceil((2*BS+3)/BS) = 3 chunks, no prefix_hit
    assert sum(e.kind == tr.PREFILL_CHUNK for e in evs1) == 3
    assert not any(e.kind == tr.PREFIX_HIT for e in evs1)
    # r2: 2 blocks cached -> prefix_hit(blocks=2), suffix of 8 -> 1 chunk
    hit = next(e for e in evs2 if e.kind == tr.PREFIX_HIT)
    assert hit.fields["blocks"] == 2 and hit.fields["tokens"] == 2 * BS
    assert sum(e.kind == tr.PREFILL_CHUNK for e in evs2) == 1
    assert eng.tracer.request_stats(r2)["prefix_hit_blocks"] == 2


def test_jsonl_roundtrip_same_events(rng, tmp_path):
    eng = _engine(n_slots=2, prefill_chunk=BS)
    base = _prompt(rng, 2 * BS + 3)
    for i in range(3):
        eng.submit(np.concatenate([base, _prompt(rng, 3 + i)]),
                   SamplingParams(max_tokens=5, seed=i))
        eng.step()
    eng.drain()
    events = eng.tracer.events()
    assert {e.kind for e in events} >= {tr.SUBMIT, tr.ADMIT, tr.PREFIX_HIT,
                                        tr.PREFILL_CHUNK, tr.FIRST_TOKEN,
                                        tr.DECODE_STEP, tr.FINISH}
    path = str(tmp_path / "trace.jsonl")
    n = eng.tracer.export_jsonl(path)
    assert n == len(events)
    back = read_jsonl(path)
    assert back == events  # bit-exact: kinds, rids, ts floats, fields
    # wall-clock stamps ride along and preserve the monotonic deltas
    with open(path) as f:
        walls = [json.loads(ln)["ts_wall"] for ln in f]
    assert walls == sorted(walls)


def test_trace_ring_is_bounded(rng):
    eng = _engine(trace_capacity=16)
    for i in range(3):
        eng.submit(_prompt(rng, 6), SamplingParams(max_tokens=8, seed=i))
    eng.drain()
    assert len(eng.tracer) == 16
    assert eng.tracer.dropped > 0
    assert eng.metrics()["trace"]["dropped"] == eng.tracer.dropped


def test_trace_ring_overflow_drop_count_exact():
    """`dropped` counts exactly the events pushed beyond capacity, and
    the ring retains exactly the newest `capacity` events."""
    t = tr.RequestTracer(capacity=4)
    for i in range(11):
        t.event(tr.DECODE_STEP, rid=0, step=i)
    assert len(t) == 4 and t.dropped == 7
    assert [e.fields["step"] for e in t.events()] == [7, 8, 9, 10]
    t.reset()
    assert len(t) == 0 and t.dropped == 0


def test_trace_ring_overflow_degrades_gracefully():
    """When a request's submit/admit events have been evicted, the
    derived stats lose exactly the intervals that needed them — no crash,
    no fabricated TTFT — and summary() still aggregates what remains."""
    t = tr.RequestTracer(capacity=8)
    t.event(tr.SUBMIT, rid=1, ts=0.0, prompt_len=4, n_tokens=6)
    t.event(tr.ADMIT, rid=1, ts=1.0, slot=0)
    t.event(tr.FIRST_TOKEN, rid=1, ts=2.0, slot=0)
    # 8 more events evict submit/admit/first_token out of the ring
    for j in range(7):
        t.event(tr.DECODE_STEP, rid=1, ts=3.0 + j, slot=0, step=1 + j)
    t.event(tr.FINISH, rid=1, ts=11.0, n_tokens=6)
    assert t.dropped == 3
    stats = t.request_stats(1)
    assert "ttft_s" not in stats and "queue_wait_s" not in stats
    assert "tpot_s" not in stats  # first_token evicted too
    assert stats["n_decode_steps"] == 7
    summ = t.summary()
    assert summ["requests"] == 1 and summ["dropped"] == 3
    assert summ["ttft_s"] == {} and summ["queue_wait_s"] == {}


def test_span_ring_bounded_separately_from_lifecycle():
    """Phase spans live in their own ring: span spam can never evict
    lifecycle events, and span overflow is counted separately."""
    t = tr.RequestTracer(capacity=4)
    t.event(tr.SUBMIT, rid=7, ts=0.0)
    for i in range(9):
        t.span("decode_dispatch", ts=float(i), dur=0.5)
    assert len(t) == 1 and t.dropped == 0  # lifecycle ring untouched
    assert len(t.spans()) == 4 and t.dropped_spans == 5
    assert [s.ts for s in t.spans()] == [5.0, 6.0, 7.0, 8.0]
    t.reset()
    assert t.spans() == [] and t.dropped_spans == 0


def test_engine_spans_nest_under_step_and_reset_clears(rng):
    eng = _engine()
    eng.submit(_prompt(rng, 10), SamplingParams(max_tokens=5))
    eng.drain()
    steps = eng.tracer.spans("step")
    assert steps and len(steps) == \
        eng.metrics_registry.counter("step.count").value
    # every non-step span falls inside some step span's interval, and
    # carries the step number it ran under
    for s in eng.tracer.spans():
        if s.name == "step":
            continue
        assert any(p.ts <= s.ts and s.ts + s.dur <= p.ts + p.dur + 1e-9
                   for p in steps), s.name
    assert {s.name for s in eng.tracer.spans()} >= {
        "step", "admit", "decode_dispatch", "device_sync", "sample_host"}
    m = eng.metrics()
    assert m["trace"]["spans"] == len(eng.tracer.spans())
    eng.reset()
    assert eng.tracer.spans() == [] and eng.tracer.dropped_spans == 0


def test_disabled_tracer_records_no_spans(rng):
    eng = _engine(enable_metrics=False)
    eng.submit(_prompt(rng, 8), SamplingParams(max_tokens=4))
    eng.drain()
    assert eng.tracer.spans() == [] and len(eng.tracer) == 0


@pytest.mark.parametrize("fused", [False, True])
def test_chrome_trace_export_schema(rng, tmp_path, fused):
    """Exported Chrome trace: every event carries ph/ts/pid, step spans
    exist with phase spans nested inside, lifecycle instants and flow
    arrows ride the request track; the reference's CI schema check
    passes it (plain decode, and chunks through the fused mixed step)."""
    kw = dict(prefill_chunk=BS, fused_step=True) if fused else {}
    eng = _engine(**kw)
    rid = eng.submit(_prompt(rng, 2 * BS + 3 if fused else 10),
                     SamplingParams(max_tokens=5))
    eng.drain()
    path = str(tmp_path / "trace.json")
    n = eng.tracer.export_chrome_trace(path)
    assert check_bench.check_chrome_trace(path) == []
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    assert n == len(events) > 0
    assert all(("ph" in e and "ts" in e and "pid" in e) for e in events)
    xs = [e for e in events if e["ph"] == "X"]
    steps = [e for e in xs if e["name"] == "step"]
    assert steps
    phase = "mixed_dispatch" if fused else "decode_dispatch"
    phases = [e for e in xs if e["pid"] == steps[0]["pid"]
              and e["name"] == phase]
    assert phases and all(
        any(s["ts"] <= p["ts"] and p["ts"] + p["dur"]
            <= s["ts"] + s["dur"] + 1e-6 for s in steps) for p in phases)
    # request track: stage slices + instants + flow arrows for the rid
    req = [e for e in events if e.get("tid") == rid and e["pid"] != 1]
    assert {e["name"] for e in req if e["ph"] == "X"} >= {"prefill",
                                                          "decode"}
    assert any(e["ph"] == "i" and e["name"] == tr.SUBMIT for e in req)
    flows = [e for e in events if e["ph"] in ("s", "t", "f")]
    assert flows and all(e["id"] == rid for e in flows)


# ---------------------------------------------------------------------------
# engine.metrics() — the unified snapshot
# ---------------------------------------------------------------------------


def test_metrics_unified_snapshot_and_prefix_stats_view(rng):
    eng = _engine()
    eng.submit(_prompt(rng, 12), SamplingParams(max_tokens=6))
    eng.drain()
    m = eng.metrics()
    assert set(m) == {"engine", "scheduler", "prefix_cache", "block_pool",
                      "trace"}
    assert m["engine"]["phases"]["step.total_s"]["count"] > 0
    for phase in ("step.admit_s", "step.decode_dispatch_s",
                  "step.device_sync_s", "step.sample_host_s",
                  "step.prefix_match_s"):
        assert phase in m["engine"]["phases"], phase
    assert m["scheduler"]["finished"] == 1
    assert m["scheduler"]["queue_depth"] == 0
    assert m["block_pool"]["used_blocks"] >= 1
    assert 0 < m["block_pool"]["occupancy"] <= 1
    assert m["prefix_cache"]["prefill_tokens"] == 12
    # prefix_stats() is a view of the unified snapshot
    assert eng.prefix_stats() == m["prefix_cache"]


def test_reset_clears_metrics_and_trace(rng):
    """Back-to-back runs on one engine start from clean counters: a reset
    pass must report identical lifecycle counts to the first."""
    eng = _engine(prefill_chunk=BS)

    def run():
        for i in range(3):
            eng.submit(_prompt(rng, 5 + 4 * i), SamplingParams(max_tokens=4,
                                                               seed=i))
        eng.drain()
        m = eng.metrics()
        return {"steps": m["engine"]["counters"]["step.count"],
                "finished": m["scheduler"]["finished"],
                "submitted": m["scheduler"]["submitted"],
                "prefill_tokens": m["prefix_cache"]["prefill_tokens"],
                "events": m["trace"]["events"]}

    rng_state = rng.bit_generator.state
    first = run()
    assert first["finished"] == 3 and first["events"] > 0
    eng.reset()
    assert len(eng.tracer) == 0 and eng.tracer.dropped == 0
    m = eng.metrics()
    assert m["scheduler"]["submitted"] == 0
    assert m["engine"]["counters"].get("step.count", 0) == 0
    assert m["engine"]["phases"]["step.total_s"]["count"] == 0
    assert m["prefix_cache"]["prefill_tokens"] == 0
    assert m["prefix_cache"]["lookups"] == 0
    rng.bit_generator.state = rng_state  # same prompts second time
    assert run() == first


def test_unadmit_under_pool_starvation_no_gauge_drift(rng):
    """Starve the BlockPool so admissions bounce via ``unadmit()`` for
    several steps: after every step the incremental scheduler gauges must
    equal a recount, and the bounces must be visible as unadmit events
    and counters."""
    eng = _engine(n_slots=2, prefill_chunk=BS)
    pool = eng.prefix_cache.pool
    pinned = pool.alloc(pool.n_free())
    pool.incref(pinned)
    rids = [eng.submit(_prompt(rng, 10 + i),
                       SamplingParams(max_tokens=5, seed=i))
            for i in range(2)]
    for _ in range(3):
        eng.step()
        g = eng.scheduler.gauges()
        for k, v in eng.scheduler.recount().items():
            assert g[k] == v, f"gauge {k} drifted after starved step"
    g = eng.scheduler.gauges()
    assert g["unadmitted"] >= 2 and g["queue_depth"] == 2
    assert g["active_slots"] == 0 and g["prefilling_slots"] == 0
    unadmits = [e for e in eng.tracer.events() if e.kind == tr.UNADMIT]
    assert len(unadmits) == g["unadmitted"]
    assert all(e.fields["blocks_free"] == 0 for e in unadmits)

    pool.decref(pinned)
    pool.free(pinned)
    out = eng.drain()
    assert sorted(out) == sorted(rids)
    g = eng.scheduler.gauges()
    for k, v in eng.scheduler.recount().items():
        assert g[k] == v, f"gauge {k} drifted after drain"
    assert g["finished"] == 2 and g["free_slots"] == 2


# ---------------------------------------------------------------------------
# The port's trace against the JAX engine's, same traffic, bridged weights
# ---------------------------------------------------------------------------

# (engine options, sampling temperature): staggered arrivals with prefix
# hits on the gather and paged paths, separate and fused chunks, and
# speculative decode with truncated drafts
PARITY = {
    "staggered-gather": (dict(), 0.0),
    "paged-sampled": (dict(use_paged_kernel=True), 0.8),
    "chunked": (dict(prefill_chunk=8), 0.0),
    "fused": (dict(prefill_chunk=8, fused_step=True,
                   use_paged_kernel=True), 0.0),
    "spec": (dict(packed=True, spec_decode=True, spec_k=2, draft_slices=2,
                  use_paged_kernel=True), 0.0),
}


def _parity_waves(vocab):
    rng = np.random.default_rng(11)
    shared = rng.integers(0, vocab, 16)
    return [
        ([np.concatenate([shared, rng.integers(0, vocab, 5)]),
          rng.integers(0, vocab, 11)], 6, 3),
        ([rng.integers(0, vocab, 19)], 5, 4),  # arrives mid-flight
        ([np.concatenate([shared, rng.integers(0, vocab, 9)]),
          np.concatenate([shared, rng.integers(0, vocab, 3)])], 7, 0),
    ]


def _run_both(kw, temp, enable_metrics=True):
    pytest.importorskip("jax")  # the card's test environment has no JAX
    from repro.serve import SamplingParams as JSampling
    from torch_port import bridged_smoke, jax_engine, run_waves

    jcfg, tcfg, _, tparams = bridged_smoke()
    kw = dict(max_len=48, n_slots=2, block_size=8, **kw)
    jeng = jax_engine(**kw)
    teng = ContinuousBatchingEngine(
        tcfg, tparams, config=EngineConfig(enable_metrics=enable_metrics,
                                           **kw), device="cpu")
    waves = _parity_waves(jcfg.vocab)
    want = run_waves(jeng, lambda n, i: JSampling(
        max_tokens=n, temperature=temp, seed=i), waves)
    got = run_waves(teng, lambda n, i: SamplingParams(
        max_tokens=n, temperature=temp, seed=i), waves)
    return jeng, teng, got, want


@pytest.mark.parametrize("name", sorted(PARITY))
def test_trace_events_equal_jax_engine(name):
    """Every request's lifecycle (event kinds in order, and each event's
    fields: slots, prefix blocks, chunk indices, decode steps, accepted
    drafts) equals the JAX engine's; so do the trace summary's counts and
    the phase spans' names per step."""
    kw, temp = PARITY[name]
    jeng, teng, got, want = _run_both(kw, temp)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    jev, tev = jeng.tracer.events(), teng.tracer.events()
    assert [(e.kind, e.rid, e.fields) for e in tev] == \
        [(e.kind, e.rid, e.fields) for e in jev]
    for rid in {e.rid for e in jev}:
        _assert_ordered(teng.tracer.events(rid))
    js, ts = jeng.tracer.summary(), teng.tracer.summary()
    for key in ("requests", "events", "dropped"):
        assert ts[key] == js[key], key
    for key in ("ttft_s", "tpot_s", "queue_wait_s"):
        assert ts[key]["n"] == js[key]["n"], key
    assert [(s.name, s.step) for s in teng.tracer.spans()] == \
        [(s.name, s.step) for s in jeng.tracer.spans()]
    if "spec" in name:
        assert any(e.kind == tr.SPEC_ACCEPT for e in tev)


@pytest.mark.parametrize("enable_metrics", [True, False])
def test_observability_is_inert_and_token_exact(enable_metrics):
    """Metrics on or off, the port emits the JAX engine's tokens (the JAX
    engine runs with its default, metrics on); off, nothing is recorded
    but the scheduler gauges and prefix stats, which are bookkeeping."""
    _, teng, got, want = _run_both(dict(use_paged_kernel=True), 0.8,
                                   enable_metrics=enable_metrics)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    m = teng.metrics()
    assert m["scheduler"]["finished"] == 5
    assert m["prefix_cache"]["prefill_tokens"] > 0
    if enable_metrics:
        assert len(teng.tracer) > 0
        assert m["engine"]["counters"]["step.model_dispatches"] == \
            teng.model_calls()
    else:
        assert len(teng.tracer) == 0 and teng.tracer.spans() == []
        assert m["engine"]["phases"] == {} and m["engine"]["counters"] == {}
