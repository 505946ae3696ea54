"""Port parity: the port's ``ContinuousBatchingEngine`` (block mode, packed
SWIS weights, paged attention) emits the same greedy tokens as the JAX
engine on bridged params — staggered arrivals, and a shared prompt prefix
that hits the radix cache once the first request has committed it."""
import numpy as np
import pytest

from repro_torch.serve import ContinuousBatchingEngine as TEngine
from repro_torch.serve import EngineConfig as TConfig
from repro_torch.serve import SamplingParams as TSampling

pytest.importorskip("jax")  # the card's test environment has no JAX
from repro.serve import SamplingParams as JSampling  # noqa: E402
from torch_port import bridged_smoke, jax_engine, run_waves  # noqa: E402


def test_engine_token_exact_with_prefix_hits():
    jcfg, tcfg, jparams, tparams = bridged_smoke()
    kw = dict(max_len=48, n_slots=2, block_size=8, packed=True,
              use_paged_kernel=True)
    jeng = jax_engine(**kw)
    teng = TEngine(tcfg, tparams, config=TConfig(**kw), device="cpu")
    rng = np.random.default_rng(2)
    shared = rng.integers(0, jcfg.vocab, 16)
    waves = [
        ([np.concatenate([shared, rng.integers(0, jcfg.vocab, 5)]),
          rng.integers(0, jcfg.vocab, 11)], 6, 3),
        ([rng.integers(0, jcfg.vocab, 7)], 5, 6),  # arrives mid-flight
        ([np.concatenate([shared, rng.integers(0, jcfg.vocab, 9)]),
          np.concatenate([shared, rng.integers(0, jcfg.vocab, 3)])], 7, 0),
    ]
    want = run_waves(jeng, lambda n, _: JSampling(max_tokens=n), waves)
    got = run_waves(teng, lambda n, _: TSampling(max_tokens=n), waves)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    tstats, jstats = teng.prefix_stats(), jeng.prefix_stats()
    assert tstats["hits"] > 0
    for key in ("hits", "lookups", "saved_tokens", "prefill_tokens",
                "commits"):
        assert tstats[key] == jstats[key], key
    assert teng.n_prefill_calls > 0 and teng.n_decode_steps > 0
