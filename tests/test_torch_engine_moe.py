"""Port parity: the serve engine on the MoE family. On the qwen2-moe smoke
config (shared experts, fp32, packed SWIS weights, the expert stacks
through the expert-axis op), the port's ``ContinuousBatchingEngine`` gives
the JAX engine's tokens on bridged params in every mode — block mode with
paged attention and prefix hits, chunked prefill, the fused mixed step,
speculative decode, the contiguous mode and seeded sampling at T 0.8 — with
equal ``cost.*`` and ``step.*`` counters, ``spec.*`` counts, and prefix
stats. Multi-token launches take the capacity path, where pad and idle
rows are routed and take capacity as in the reference, so each mode is held
to the same mode of the JAX engine."""
import numpy as np
import pytest

from repro_torch.serve import ContinuousBatchingEngine as TEngine
from repro_torch.serve import EngineConfig as TConfig
from repro_torch.serve import SamplingParams as TSampling

pytest.importorskip("jax")  # the card's test environment has no JAX
from repro.serve import SamplingParams as JSampling  # noqa: E402
from torch_port import (assert_same_tokens, bridged_smoke,  # noqa: E402
                        jax_engine, run_waves)

ARCH = "qwen2-moe-a2.7b"
BASE = dict(max_len=48, n_slots=2, block_size=8, packed=True)
# (engine options, temperature)
MODES = {
    "block-paged": (dict(use_paged_kernel=True), 0.0),
    "chunked": (dict(prefill_chunk=8), 0.0),
    "fused": (dict(prefill_chunk=8, fused_step=True, use_paged_kernel=True),
              0.0),
    "spec": (dict(spec_decode=True, spec_k=2, draft_slices=2,
                  use_paged_kernel=True), 0.0),
    "contiguous": (dict(prefix_cache=False), 0.0),
    "sampled": (dict(use_paged_kernel=True), 0.8),
}


def _waves(vocab):
    """Staggered arrivals; requests 0, 2 and 3 share a 16-token prefix."""
    rng = np.random.default_rng(4)
    shared = rng.integers(0, vocab, 16)
    return [
        ([np.concatenate([shared, rng.integers(0, vocab, 7)]),
          rng.integers(0, vocab, 20)], 6, 2),
        ([np.concatenate([shared, rng.integers(0, vocab, 10)])], 8, 5),
        ([np.concatenate([shared, rng.integers(0, vocab, 3)])], 4, 0),
    ]


@pytest.mark.parametrize("mode", list(MODES))
def test_moe_engine_matches_jax(mode):
    opts, temp = MODES[mode]
    kw = dict(BASE, **opts)
    jcfg, tcfg, _, tparams = bridged_smoke(arch=ARCH)
    jeng = jax_engine(arch=ARCH, **kw)
    teng = TEngine(tcfg, tparams, config=TConfig(**kw), device="cpu")
    waves = _waves(jcfg.vocab)

    def sampling(cls):
        return lambda n, i: cls(max_tokens=n, temperature=temp,
                                seed=i if temp else None)

    want = run_waves(jeng, sampling(JSampling), waves)
    got = run_waves(teng, sampling(TSampling), waves)
    assert_same_tokens(got, want)
    jm, tm = jeng.metrics(), teng.metrics()
    jc, tc = jm["engine"]["counters"], tm["engine"]["counters"]
    assert tc == jc  # cost.*, step.model_dispatches, spec.*
    assert any(k.startswith("cost.") for k in tc)
    assert tc["step.model_dispatches"] == teng.model_calls()
    assert tm["engine"]["cost_model"] == jm["engine"]["cost_model"]
    assert tm["scheduler"] == jm["scheduler"]
    assert teng.block_mode == (mode != "contiguous")
    if teng.block_mode:
        assert tm["prefix_cache"] == jm["prefix_cache"]
        if mode != "chunked":
            assert teng.prefix_stats()["hits"] > 0
    if mode == "spec":
        assert teng.spec_proposed == tc["spec.proposed"] > 0
        assert teng.spec_accepted == tc["spec.accepted"]
