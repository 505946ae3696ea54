"""The port's per-dispatch cost model (``repro_torch.serve.costmodel``):
the cases of ``tests/test_costmodel.py`` that need no serve bench, run
against the port on the CPU, and its counters held equal to the JAX
engine's on the same traffic and bridged weights.

* every ``cost.*`` counter, each per-kind histogram's count,
  ``step.model_dispatches``, ``spec.proposed`` and ``spec.accepted``
  equal the JAX engine's exactly (decode, prefill, chunk, mixed, draft and
  verify launches; packed and unpacked weights), and
  ``step.model_dispatches`` equals the port's own ``model_calls()``;
* the GEMM inventory of the port's torch tree equals the reference's on
  the same weights: packed leaves costed by ``compression_ratio``, never
  by the bytes of their int32 views; tied embeddings counted once;
* gathered-K/V bytes per backend equal the bench's
  ``decode_gathered_bytes_per_step`` of the matching reference engine;
* packed traffic equals ``pack_tree``'s own accounting; SWIS cycles fall
  strictly as drafts keep fewer planes; every launch kind records its
  counters; the utilization gauges agree with the totals.
"""
import dataclasses
import functools
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs as TC
from repro_torch.core.packing import compression_ratio
from repro_torch.core.swis import QuantConfig
from repro_torch.models import params as pp
from repro_torch.models.model import Model
from repro_torch.serve import (ContinuousBatchingEngine, EngineConfig,
                               SamplingParams)
from repro_torch.serve.costmodel import CostModel, GemmSpec, gemm_inventory

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks"))
import check_bench  # noqa: E402

MAX_LEN = 48
BS = 8
N_SHIFTS = 4
KINDS = ("decode", "prefill", "chunk", "mixed", "draft", "verify")
FIELDS = ("flops", "hbm_bytes", "swis_cycles")


@functools.cache
def _setup():
    cfg = TC.get_smoke("smollm-135m").replace(compute_dtype="float32")
    params = pp.init_params(Model(cfg).build(),
                            torch.Generator().manual_seed(0), device="cpu")
    return cfg, params


def _engine(n_slots=2, **kw):
    cfg, params = _setup()
    kw.setdefault("prefix_cache", True)
    kw.setdefault("block_size", BS)
    return ContinuousBatchingEngine(
        cfg, params, config=EngineConfig(max_len=MAX_LEN, n_slots=n_slots,
                                         **kw), device="cpu")


def _packed_engine(**kw):
    qcfg = QuantConfig(method="swis", n_shifts=N_SHIFTS, group_size=4)
    return _engine(packed=True, quant_cfg=qcfg, **kw)


def _prompt(rng, n):
    cfg, _ = _setup()
    return rng.integers(0, cfg.vocab, (n,)).astype(np.int32)


def _drive(eng, rng, n_req=3, prompt_len=10, tokens=5, stagger=0):
    for i in range(n_req):
        eng.submit(_prompt(rng, prompt_len + i),
                   SamplingParams(max_tokens=tokens, seed=i))
        for _ in range(stagger):
            eng.step()
    eng.drain()


def _counters(eng):
    return eng.metrics_registry.snapshot()["counters"]


# ---------------------------------------------------------------------------
# Against the JAX engine, same traffic and weights
# ---------------------------------------------------------------------------

# engine options whose traffic issues every launch kind between them:
# prefill + decode (gather and paged), separate chunks, the fused mixed
# step, and speculative drafts + verify (which needs packed weights)
PARITY = {
    "decode-gather": dict(),
    "decode-paged": dict(use_paged_kernel=True),
    "chunk": dict(prefill_chunk=8),
    "mixed": dict(prefill_chunk=8, fused_step=True, use_paged_kernel=True),
    "spec": dict(spec_decode=True, spec_k=2, use_paged_kernel=True),
}


def _run_both(kw):
    pytest.importorskip("jax")  # the card's test environment has no JAX
    from repro.serve import SamplingParams as JSampling
    from torch_port import bridged_smoke, jax_engine, run_waves

    jcfg, tcfg, _, tparams = bridged_smoke()
    kw = dict(max_len=48, n_slots=2, block_size=8, **kw)
    jeng = jax_engine(**kw)
    teng = ContinuousBatchingEngine(tcfg, tparams, config=EngineConfig(**kw),
                                    device="cpu")
    rng = np.random.default_rng(4)
    shared = rng.integers(0, jcfg.vocab, 16)
    waves = [
        ([np.concatenate([shared, rng.integers(0, jcfg.vocab, 7)]),
          rng.integers(0, jcfg.vocab, 20)], 6, 2),
        ([np.concatenate([shared, rng.integers(0, jcfg.vocab, 10)])], 8, 5),
        ([rng.integers(0, jcfg.vocab, 5)], 4, 0),
    ]
    want = run_waves(jeng, lambda n, i: JSampling(max_tokens=n, seed=i),
                     waves)
    got = run_waves(teng, lambda n, i: SamplingParams(max_tokens=n, seed=i),
                    waves)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    return jeng, teng


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("name", sorted(PARITY))
def test_cost_counters_equal_jax_engine(name, packed):
    """Every counter (``cost.*``, ``step.*``, ``spec.*``), every per-kind
    cost histogram's count and sum, the cost-model summary and the
    scheduler gauges equal the JAX engine's exactly."""
    kw = dict(PARITY[name], packed=packed)
    if name == "spec" and packed:
        kw["draft_slices"] = 2  # truncated drafts need packed planes
    jeng, teng = _run_both(kw)
    jm, tm = jeng.metrics(), teng.metrics()
    jc, tc = jm["engine"]["counters"], tm["engine"]["counters"]
    assert tc == jc
    kinds = {k.split(".")[1] for k in jc if k.count(".") == 2
             and k.startswith("cost.")}
    want_kinds = {"decode-gather": {"prefill", "decode"},
                  "decode-paged": {"prefill", "decode"},
                  "chunk": {"chunk", "decode"},
                  "mixed": {"mixed", "decode"},
                  "spec": {"prefill", "draft", "verify"}}[name]
    assert want_kinds <= kinds <= set(KINDS), kinds
    for key, h in jm["engine"]["phases"].items():
        if key.startswith("cost."):
            th = tm["engine"]["phases"][key]
            assert (th["count"], th["sum"], th["buckets"]) == \
                (h["count"], h["sum"], h["buckets"]), key
    assert set(tm["engine"]["phases"]) == set(jm["engine"]["phases"])
    assert tm["engine"]["cost_model"] == jm["engine"]["cost_model"]
    assert tm["scheduler"] == jm["scheduler"]
    assert tm["prefix_cache"] == jm["prefix_cache"]
    assert tm["engine"]["paged_impl"] == jm["engine"]["paged_impl"]
    # the registry's counters agree with the port's own dispatch counters
    assert tc["step.model_dispatches"] == teng.model_calls()
    assert tc.get("spec.proposed", 0) == teng.spec_proposed
    assert tc.get("spec.accepted", 0) == teng.spec_accepted
    if name == "spec":
        assert teng.spec_proposed > 0


@pytest.mark.parametrize("packed", [False, True])
def test_gemm_inventory_equals_reference(packed):
    """The port's tree presents the reference's GEMM leaves: the same
    specs in the same order and the same non-GEMM bytes (the tied embed
    table once), packed leaves costed by ``compression_ratio``."""
    pytest.importorskip("jax")
    from repro.serve.costmodel import gemm_inventory as jinventory
    from repro.serve.quantized import pack_tree as jpack
    from repro_torch.serve.quantized import pack_tree
    from torch_port import bridged_smoke

    _, tcfg, jparams, tparams = bridged_smoke()
    assert tcfg.tie_embeddings
    if packed:
        qcfg = QuantConfig(method="swis", n_shifts=N_SHIFTS, group_size=4)
        from repro.core.swis import QuantConfig as JQuant
        jparams = jpack(jparams, JQuant(method="swis", n_shifts=N_SHIFTS,
                                        group_size=4))[0]
        tparams = pack_tree(tparams, qcfg)[0]
    tspecs, tother = gemm_inventory(tparams)
    jspecs, jother = jinventory(jparams)
    assert [dataclasses.astuple(s) for s in tspecs] == \
        [dataclasses.astuple(s) for s in jspecs]
    assert tother == jother
    # the tied table is read once as a non-GEMM leaf, never as a GEMM
    tok = tparams["embed"]["tok"]
    assert tother >= tok.numel() * tok.element_size()
    assert all(tcfg.padded_vocab not in (s.k, s.c) for s in tspecs)
    if packed:
        assert any(s.packed for s in tspecs)
        for s in tspecs:
            if s.packed:
                assert s.weight_bytes() == s.macs / compression_ratio(
                    s.group_size, s.n_shifts, s.method)


def test_gathered_bytes_match_bench_measurement():
    """Predicted gathered-K/V bytes per decode step equal the bench's
    ``decode_gathered_bytes_per_step`` of the reference engine with the
    matching backend: the gather path, the plain paged version on the
    CPU against the XLA scan, the CUDA kernel against the Pallas kernel
    (built without a card: the cost model only reads the geometry)."""
    pytest.importorskip("jax")
    import serve_bench
    from repro.serve import ContinuousBatchingEngine as JEngine
    from repro.serve import EngineConfig as JConfig
    from torch_port import bridged_smoke

    jcfg, tcfg, jparams, tparams = bridged_smoke()
    variants = [(dict(), dict()),
                (dict(use_paged_kernel=True),
                 dict(use_paged_kernel=True, paged_impl="xla")),
                (None, dict(use_paged_kernel=True,
                            paged_impl="pallas_interpret"))]
    for tkw, jkw in variants:
        jeng = JEngine(jcfg, jparams, config=JConfig(
            max_len=MAX_LEN, n_slots=2, block_size=BS, **jkw))
        want = serve_bench._decode_gathered_bytes(jeng, jcfg)
        if tkw is None:  # the card's kernel, costed from the geometry
            cm = CostModel(tcfg, tparams, kv_itemsize=4,
                           attended_len=jeng.cache.eff_len, block_size=BS,
                           paged_impl="cuda")
        else:
            cm = ContinuousBatchingEngine(
                tcfg, tparams, config=EngineConfig(
                    max_len=MAX_LEN, n_slots=2, block_size=BS, **tkw),
                device="cpu").cost_model
        cost = cm.decode(2)
        assert cost.gathered_bytes == want, (tkw, cost.gathered_bytes, want)
        # the gathered copy is part of (never exceeds) the HBM total
        assert cost.hbm_bytes >= cost.gathered_bytes
        assert cost.hbm_bytes > 0 and cost.flops > 0


def test_kv_itemsize_follows_torch_cache_dtype():
    """The cache dtype is a torch dtype: fp16 K/V count 2 bytes a value,
    so the gather path moves half the fp32 cache's gathered bytes."""
    full = _engine().cost_model
    half = _engine(cache_dtype=torch.float16).cost_model
    assert (full.geom.kv_itemsize, half.geom.kv_itemsize) == (4, 2)
    assert half.decode(2).gathered_bytes * 2 == full.decode(2).gathered_bytes


# ---------------------------------------------------------------------------
# The reference's own cases, against the port
# ---------------------------------------------------------------------------


def test_contiguous_cache_never_gathers():
    eng = _engine(prefix_cache=False)
    assert eng.cost_model.decode(eng.n_slots).gathered_bytes == 0.0


def test_packed_weight_bytes_match_pack_tree_accounting():
    """The cost model's per-dispatch packed weight traffic equals
    ``pack_tree``'s own stored-bits accounting: one compression formula,
    two consumers."""
    eng = _packed_engine()
    packed_specs = [sp for sp in eng.cost_model.specs if sp.packed]
    assert len(packed_specs) == eng.pack_stats["n_packed"] > 0
    got = sum(sp.weight_bytes() for sp in packed_specs)
    want = eng.pack_stats["packed_bits"] / 8.0
    assert abs(got - want) < 1e-6, (got, want)
    # the dense inventory sees the same MAC count: packing changes bytes,
    # never arithmetic
    cfg, params = _setup()
    dense_specs, _ = gemm_inventory(params)
    assert (sum(sp.macs for sp in dense_specs)
            == sum(sp.macs for sp in eng.cost_model.specs))


def test_swis_cycles_strictly_monotone_in_draft_slices():
    """Truncating bit-planes must strictly reduce predicted shift-pass
    cycles, and keep_slices == n_shifts must equal full precision."""
    eng = _packed_engine()
    cm = eng.cost_model
    cycles = [cm.draft(2, keep_slices=k).swis_cycles
              for k in range(1, N_SHIFTS + 1)]
    assert all(a < b for a, b in zip(cycles, cycles[1:])), cycles
    assert cycles[-1] == cm.draft(2, keep_slices=None).swis_cycles
    # HBM weight traffic shrinks with truncation too (fewer mask planes)
    hbm = [cm.draft(2, keep_slices=k).hbm_bytes
           for k in range(1, N_SHIFTS + 1)]
    assert all(a < b for a, b in zip(hbm, hbm[1:])), hbm


def test_gemm_spec_weight_bytes_honors_truncation():
    sp = GemmSpec(k=64, c=32, packed=True, n_shifts=4, group_size=4)
    full = sp.weight_bytes()
    assert sp.weight_bytes(keep_slices=2) < full
    # clamped: keep beyond n_shifts is full precision, floor at 1 slice
    assert sp.weight_bytes(keep_slices=9) == full
    assert sp.weight_bytes(keep_slices=0) == sp.weight_bytes(keep_slices=1)


def test_decode_and_prefill_kinds_recorded(rng):
    eng = _engine()
    _drive(eng, rng)
    c = _counters(eng)
    for kind in ("decode", "prefill"):
        for field in FIELDS:
            assert c.get(f"cost.{kind}.{field}", 0) > 0, (kind, field)
    # global totals are the sum of the per-kind totals
    for field in FIELDS:
        per_kind = sum(v for k, v in c.items()
                       if k.startswith("cost.") and k.endswith(f".{field}")
                       and k.count(".") == 2)
        assert abs(c[f"cost.{field}"] - per_kind) < 1e-6


def test_chunk_and_mixed_kinds_recorded(rng):
    sep = _engine(prefill_chunk=BS)
    _drive(sep, rng, prompt_len=2 * BS + 3)
    assert _counters(sep).get("cost.chunk.flops", 0) > 0
    fused = _engine(prefill_chunk=BS, fused_step=True)
    _drive(fused, rng, prompt_len=2 * BS + 3)
    assert _counters(fused).get("cost.mixed.flops", 0) > 0


def test_spec_kinds_recorded_and_draft_cheaper(rng):
    eng = _packed_engine(spec_decode=True, spec_k=2, draft_slices=1)
    _drive(eng, rng, tokens=8)
    c = _counters(eng)
    assert c.get("cost.draft.swis_cycles", 0) > 0
    assert c.get("cost.verify.flops", 0) > 0
    # a truncated S=1 draft launch costs fewer SWIS cycles than the
    # full-precision k+1-position verify launch
    cm = eng.cost_model
    assert (cm.draft(eng.n_slots, keep_slices=1).swis_cycles
            < cm.verify(eng.n_slots, 3).swis_cycles)


def test_utilization_gauges_consistent(rng):
    eng = _engine()
    _drive(eng, rng)
    snap = eng.metrics_registry.snapshot()
    total = snap["histograms"]["step.total_s"]["sum"]
    assert total > 0
    want = snap["counters"]["cost.hbm_bytes"] / total
    assert abs(snap["gauges"]["cost.hbm_bytes_per_s"] - want) < 1e-6
    assert snap["gauges"]["cost.flops_per_s"] > 0


def test_cost_model_summary_in_metrics(rng):
    eng = _packed_engine()
    cm = eng.metrics()["engine"]["cost_model"]
    assert cm["n_packed_leaves"] == eng.pack_stats["n_packed"]
    # N=4/group-4 SWIS stores exactly 8 bits/weight, so packed traffic
    # can match but never exceed the 8-bit dense reference...
    assert cm["weight_bytes_per_dispatch"] <= cm["weight_bytes_dense8"]
    # ...and is far below what the unpacked fp32 engine streams
    dense = _engine().metrics()["engine"]["cost_model"]
    assert (cm["weight_bytes_per_dispatch"]
            < dense["weight_bytes_per_dispatch"])
    assert cm["gemm_flops_per_token"] > 0


def test_costs_deterministic_across_reset(rng):
    """Same traffic -> bit-identical cost counters after reset: the cost
    layer is a pure function of the dispatch pattern."""
    eng = _engine(prefill_chunk=BS, fused_step=True)
    state = rng.bit_generator.state
    _drive(eng, rng, prompt_len=2 * BS + 3)
    first = {k: v for k, v in _counters(eng).items()
             if k.startswith("cost.")}
    assert first
    eng.reset()
    rng.bit_generator.state = state
    _drive(eng, rng, prompt_len=2 * BS + 3)
    second = {k: v for k, v in _counters(eng).items()
              if k.startswith("cost.")}
    assert first == second


def test_chrome_trace_passes_schema_check_for_mixed_run(rng, tmp_path):
    """A fused mixed-load-style run exports a Chrome trace that passes the
    reference's CI schema check and holds nested step -> mixed_dispatch
    spans."""
    import json

    eng = _engine(prefill_chunk=BS, fused_step=True, n_slots=2)
    _drive(eng, rng, n_req=3, prompt_len=2 * BS + 3, tokens=6, stagger=1)
    path = str(tmp_path / "chrome_trace_mixed_load.json")
    eng.tracer.export_chrome_trace(path)
    assert check_bench.check_chrome_trace(path) == []
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    steps = [e for e in events if e["ph"] == "X" and e["name"] == "step"]
    mixed = [e for e in events if e["ph"] == "X"
             and e["name"] == "mixed_dispatch"]
    assert steps and mixed
    assert any(s["ts"] <= mx["ts"] and mx["ts"] + mx["dur"]
               <= s["ts"] + s["dur"] + 1e-6
               for mx in mixed for s in steps)


def test_cost_model_memoizes_launch_shapes():
    eng = _engine()
    cm = eng.cost_model
    a = cm.decode(2)
    assert cm.decode(2) is a  # memoized, no per-step allocation
    assert cm.decode(1) is not a
