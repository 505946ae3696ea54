"""The port's metrics registry (``repro_torch.serve.metrics``) and the
scheduler's incrementally maintained gauges: the cases of
``tests/test_metrics.py`` against the port, and the registry held equal to
the reference's on the same observations.

Pure host-side bookkeeping (numpy only): no model, no device.
"""
import json
import math

import numpy as np
import pytest

from repro_torch.serve.metrics import (Histogram, MetricsRegistry,
                                       _NULL_TIMER, cost_buckets,
                                       format_report, log_buckets)
from repro_torch.serve.scheduler import RequestScheduler


# ---------------------------------------------------------------------------
# Instruments
# ---------------------------------------------------------------------------


def test_counter_and_gauge():
    reg = MetricsRegistry()
    reg.counter("reqs").inc()
    reg.counter("reqs").inc(4)
    reg.gauge("depth").set(7)
    reg.gauge("depth").inc(-2)
    snap = reg.snapshot()
    assert snap["counters"]["reqs"] == 5
    assert snap["gauges"]["depth"] == 5.0


def test_log_buckets_cover_domain_monotonically():
    edges = log_buckets()
    assert np.all(np.diff(edges) > 0)
    assert edges[0] <= 1e-6 * (1 + 1e-9) and edges[-1] >= 1000.0


def test_histogram_exact_percentiles_within_ring(rng):
    h = Histogram()
    vals = rng.uniform(1e-4, 1.0, 500)
    for v in vals:
        h.observe(v)
    # ring holds everything -> percentiles are exact, not interpolated
    assert h.percentile(50) == pytest.approx(np.percentile(vals, 50))
    assert h.percentile(95) == pytest.approx(np.percentile(vals, 95))
    s = h.summary()
    assert s["count"] == 500
    assert s["min"] == pytest.approx(vals.min())
    assert s["max"] == pytest.approx(vals.max())
    assert s["mean"] == pytest.approx(vals.mean())


def test_histogram_bucket_fallback_bounded_error(rng):
    h = Histogram()
    vals = np.exp(rng.uniform(math.log(1e-5), math.log(10.0), 6000))
    for v in vals:
        h.observe(v)
    assert h.count > h._ring.maxlen  # raw ring overflowed
    # log-spaced edges bound the interpolation error by the bucket ratio
    ratio = 10 ** (1 / 4)
    for q in (50, 95):
        exact = np.percentile(vals, q)
        est = h.percentile(q)
        assert exact / ratio <= est <= exact * ratio


def test_timer_observes_elapsed_seconds():
    reg = MetricsRegistry()
    with reg.timer("phase"):
        pass
    h = reg.histogram("phase")
    assert h.count == 1
    assert 0 <= h.vmax < 1.0


def test_disabled_registry_is_inert_and_allocation_free():
    reg = MetricsRegistry(enabled=False)
    # the timer is a shared singleton no-op context, not a fresh object
    assert reg.timer("x") is _NULL_TIMER
    assert reg.timer("y") is reg.timer("z")
    with reg.timer("x"):
        pass
    reg.counter("c").inc(10)
    reg.gauge("g").set(3)
    reg.histogram("h").observe(1.0)
    reg.observe("h", 2.0)
    snap = reg.snapshot()
    assert snap == {"counters": {}, "gauges": {}, "histograms": {}}


def test_reset_zeroes_in_place_keeping_references():
    reg = MetricsRegistry()
    c = reg.counter("c")
    h = reg.histogram("h")
    c.inc(3)
    h.observe(0.5)
    reg.reset()
    assert c.value == 0 and h.count == 0 and h.total == 0.0
    # held references stay live after reset
    c.inc()
    h.observe(0.25)
    assert reg.snapshot()["counters"]["c"] == 1
    assert reg.snapshot()["histograms"]["h"]["count"] == 1
    assert reg.counter("c") is c and reg.histogram("h") is h


def test_snapshot_is_json_ready():
    reg = MetricsRegistry()
    reg.counter("n").inc()
    reg.gauge("q").set(2)
    for v in (1e-5, 3e-3, 0.2):
        reg.observe("t", v)
    s = json.dumps(reg.snapshot())
    back = json.loads(s)
    assert back["histograms"]["t"]["count"] == 3
    assert all(c >= 1 for _, c in back["histograms"]["t"]["buckets"])
    # and the human-readable report renders every non-empty instrument
    rep = format_report(reg.snapshot())
    assert "t:" in rep and "n=3" in rep and "p95=" in rep


def test_registry_equals_reference_on_same_observations(rng):
    """The same counters, gauges and observations (phase times past the
    raw ring, so the bucket path is taken too, and cost-sized values on
    the cost edges) give the reference's snapshot and report exactly."""
    pytest.importorskip("jax")  # the reference package imports JAX
    from repro.serve import metrics as jm

    assert np.array_equal(log_buckets(), jm.log_buckets())
    assert np.array_equal(cost_buckets(), jm.cost_buckets())
    times = np.exp(rng.uniform(math.log(1e-5), math.log(10.0), 5000))
    costs = rng.uniform(1e3, 1e12, 300)
    regs = (MetricsRegistry(), jm.MetricsRegistry())
    for reg in regs:
        reg.counter("step.count").inc(7)
        reg.counter("cost.flops").inc(2.5e9)
        reg.gauge("cost.hbm_bytes_per_s").set(1.25e11)
        for v in times:
            reg.observe("step.total_s", float(v))
        for v in costs:
            reg.histogram("cost.decode.hbm_bytes",
                          cost_buckets()).observe(float(v))
    ours, theirs = (r.snapshot() for r in regs)
    assert ours == theirs
    assert format_report(ours) == jm.format_report(theirs)
    for reg in regs:
        reg.reset()
    assert regs[0].snapshot() == regs[1].snapshot()


# ---------------------------------------------------------------------------
# Scheduler gauges (incremental vs recount)
# ---------------------------------------------------------------------------


def _submit(sched, n_tokens=2):
    return sched.submit(np.arange(4, dtype=np.int32), n_tokens, 0.0,
                        key=None)


def test_scheduler_gauges_track_lifecycle():
    sched = RequestScheduler(2)
    for _ in range(3):
        _submit(sched)
    assert sched.gauges()["queue_depth"] == 3
    assert sched.gauges() | sched.recount() == sched.gauges()

    admitted = sched.admit()
    assert len(admitted) == 2
    g = sched.gauges()
    assert (g["queue_depth"], g["active_slots"], g["prefilling_slots"],
            g["decoding_slots"], g["free_slots"]) == (1, 2, 2, 0, 0)

    slot0, _ = admitted[0]
    sched.record_prefill(slot0, 11)  # PREFILLING -> DECODING
    g = sched.gauges()
    assert (g["prefilling_slots"], g["decoding_slots"]) == (1, 1)
    for k, v in sched.recount().items():
        assert g[k] == v, k

    # finish slot0: n_tokens=2 -> one decode token left
    toks = np.full(2, 5, np.int32)
    sched.decode_batch(dummy_key=None)
    sched.record_decode(toks)
    g = sched.gauges()
    assert g["finished"] == 1 and g["active_slots"] == 1
    for k, v in sched.recount().items():
        assert g[k] == v, k


def test_scheduler_unadmit_rolls_gauges_back_exactly():
    """The pool-starvation path: admit then unadmit must leave every
    incremental gauge exactly where a recount puts it — repeatedly, so
    drift would accumulate and show."""
    sched = RequestScheduler(2)
    for _ in range(2):
        _submit(sched)
    for _ in range(5):  # repeated starved admission rounds
        admitted = sched.admit()
        assert admitted
        for slot, _ in reversed(admitted):
            sched.unadmit(slot)
        g = sched.gauges()
        for k, v in sched.recount().items():
            assert g[k] == v, f"gauge {k} drifted: {g[k]} != {v}"
    assert sched.gauges()["unadmitted"] == 10
    assert sched.gauges()["queue_depth"] == 2
    # requeue preserved FIFO order
    assert [r.rid for r in sched.queue] == [0, 1]
