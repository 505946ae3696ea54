"""Port parity: the serve engines on the VLM family (the llama-3.2-vision
smoke config, fp32, packed SWIS weights, every ``xgate`` 0.5 in both
packages' weights) against the JAX package on bridged params.

Mixed image and text traffic (a request's ``extra={"patches": ...}``) in
block mode with plain decode over paged attention, chunked prefill, the
fused mixed step and speculative decode: tokens, ``cost.*`` and ``step.*``
counters, ``spec.*`` counts, scheduler gauges and prefix stats equal to the
JAX engine's. Image requests never match or commit prefix blocks, and
their chunks take the separate path in fused mode, as in the reference.
``DecodeEngine.generate(..., extra)`` and the continuous engine's
``generate`` equal the JAX ``DecodeEngine``."""
import numpy as np
import pytest

from repro_torch.serve import ContinuousBatchingEngine as TEngine
from repro_torch.serve import DecodeEngine as TDecode
from repro_torch.serve import EngineConfig as TConfig
from repro_torch.serve import SamplingParams as TSampling
from repro_torch.serve import trace as ttrace

pytest.importorskip("jax")  # the card's test environment has no JAX
from repro.serve import SamplingParams as JSampling  # noqa: E402
from repro.serve.engine import DecodeEngine as JDecode  # noqa: E402
from torch_port import (assert_same_tokens, bridged_smoke,  # noqa: E402
                        jax_engine, run_waves)

ARCH = "llama-3.2-vision-11b"
BASE = dict(max_len=48, n_slots=2, block_size=8, packed=True)
MODES = {
    "block-paged": dict(use_paged_kernel=True),
    "chunked": dict(prefill_chunk=8),
    "fused": dict(prefill_chunk=8, fused_step=True, use_paged_kernel=True),
    "spec": dict(spec_decode=True, spec_k=2, draft_slices=2,
                 use_paged_kernel=True),
}


def _patches(cfg, b, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1, (b, cfg.vlm.n_patches,
                             cfg.vlm.vision_dim)).astype(np.float32)


def _traffic(cfg):
    """Staggered image and text requests: texts 0, 2 and 4 share a
    16-token prefix; image request 3 starts with it too, but a request
    with patches never matches or commits prefix blocks."""
    rng = np.random.default_rng(9)
    shared = rng.integers(0, cfg.vocab, 16)
    waves = [
        ([np.concatenate([shared, rng.integers(0, cfg.vocab, 7)]),
          rng.integers(0, cfg.vocab, 20)], 6, 2),
        ([np.concatenate([shared, rng.integers(0, cfg.vocab, 10)]),
          np.concatenate([shared, rng.integers(0, cfg.vocab, 5)])], 8, 5),
        ([np.concatenate([shared, rng.integers(0, cfg.vocab, 3)])], 4, 0),
    ]
    patches = _patches(cfg, 2, seed=10)
    extras = [None, {"patches": patches[0]}, None, {"patches": patches[1]},
              None]
    return waves, extras


@pytest.mark.parametrize("mode", list(MODES))
def test_vlm_engine_matches_jax(mode):
    kw = dict(BASE, **MODES[mode])
    jcfg, tcfg, _, tparams = bridged_smoke(arch=ARCH)
    jeng = jax_engine(arch=ARCH, **kw)
    teng = TEngine(tcfg, tparams, config=TConfig(**kw), device="cpu")
    waves, extras = _traffic(jcfg)
    want = run_waves(jeng, lambda n, i: JSampling(max_tokens=n), waves,
                     extras)
    got = run_waves(teng, lambda n, i: TSampling(max_tokens=n), waves,
                    extras)
    assert_same_tokens(got, want)
    jm, tm = jeng.metrics(), teng.metrics()
    tc = tm["engine"]["counters"]
    assert tc == jm["engine"]["counters"]  # cost.*, step.*, spec.*
    assert tc["step.model_dispatches"] == teng.model_calls()
    assert tm["engine"]["cost_model"] == jm["engine"]["cost_model"]
    assert tm["scheduler"] == jm["scheduler"]
    assert tm["prefix_cache"] == jm["prefix_cache"]
    # text requests 2 and 4 hit request 0's prefix; image request 3 never
    hits = {e.rid for e in teng.tracer.events()
            if e.kind == ttrace.PREFIX_HIT}
    assert hits and not hits & {1, 3}
    if mode == "fused":  # image chunks take the separate path
        assert teng.n_chunk_calls > 0 and teng.n_mixed_steps > 0
    if mode == "spec":
        assert teng.spec_proposed == tc["spec.proposed"] > 0


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_decode_engine_with_patches_matches_jax(temperature):
    """``DecodeEngine.generate(..., extra=)`` equals the JAX DecodeEngine's,
    and the continuous engine's ``generate`` (row r gets row r of each
    extra input) equals both."""
    jcfg, tcfg, jparams, tparams = bridged_smoke(arch=ARCH)
    prompt = np.random.default_rng(11).integers(0, jcfg.vocab, (2, 9)).astype(
        np.int32)
    extra = {"patches": _patches(jcfg, 2, seed=12)}
    want = JDecode(jcfg, jparams, max_len=24, batch=2).generate(
        prompt, 6, extra, temperature=temperature, seed=3)
    got = TDecode(tcfg, tparams, max_len=24, batch=2, device="cpu").generate(
        prompt, 6, extra, temperature=temperature, seed=3)
    np.testing.assert_array_equal(got, want)
    eng = TEngine(tcfg, tparams, config=TConfig(max_len=24, n_slots=2),
                  device="cpu")
    np.testing.assert_array_equal(
        eng.generate(prompt, 6, extra, temperature=temperature, seed=3), want)
