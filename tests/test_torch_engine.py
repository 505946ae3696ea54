"""Port parity: the port's ``ContinuousBatchingEngine`` (block mode, packed
SWIS weights, paged attention) emits the same greedy tokens as the JAX
engine on bridged params — staggered arrivals, and a shared prompt prefix
that hits the radix cache once the first request has committed it. Also
pins the options the port does not serve yet: they raise."""
import numpy as np
import pytest

from repro_torch import configs as TC
from repro_torch.bridge import from_jax_params
from repro_torch.serve import ContinuousBatchingEngine as TEngine
from repro_torch.serve import EngineConfig as TConfig
from repro_torch.serve import SamplingParams as TSampling

pytest.importorskip("jax")  # the card's test environment has no JAX
import jax  # noqa: E402
import repro.configs as C  # noqa: E402
from repro.models import params as jpp  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serve import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serve import EngineConfig as JConfig  # noqa: E402
from repro.serve import SamplingParams as JSampling  # noqa: E402

FIELDS = dict(compute_dtype="float32", d_model=64, n_heads=4, n_kv_heads=2,
              d_ff=128)


def _setup():
    jcfg = C.get_smoke("smollm-135m").replace(**FIELDS)
    tcfg = TC.get_smoke("smollm-135m").replace(**FIELDS)
    jparams = jpp.init_params(JModel(jcfg).build(), jax.random.key(5))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, tcfg, jparams, tparams


def _run(engine, sampling, waves):
    """Submit each wave, then step ``gap`` times; drain at the end."""
    out, rids = {}, []
    for prompts, n_tok, gap in waves:
        rids += [engine.submit(p, sampling(n_tok)) for p in prompts]
        for _ in range(gap):
            out.update({f.rid: f.tokens for f in engine.step()})
    while engine.scheduler.pending():
        out.update({f.rid: f.tokens for f in engine.step()})
    return [out[r] for r in rids]


def test_engine_token_exact_with_prefix_hits():
    jcfg, tcfg, jparams, tparams = _setup()
    kw = dict(max_len=48, n_slots=2, block_size=8, packed=True,
              use_paged_kernel=True)
    jeng = JEngine(jcfg, jparams, config=JConfig(paged_impl="xla", **kw))
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
    want = _run(jeng, lambda n: JSampling(max_tokens=n), waves)
    got = _run(teng, lambda n: TSampling(max_tokens=n), waves)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    tstats, jstats = teng.prefix_stats(), jeng.prefix_stats()
    assert tstats["hits"] > 0
    for key in ("hits", "lookups", "saved_tokens", "prefill_tokens",
                "commits"):
        assert tstats[key] == jstats[key], key
    assert teng.n_prefill_calls > 0 and teng.n_decode_steps > 0


def test_unported_options_raise():
    _, tcfg, _, tparams = _setup()
    for bad in (dict(prefill_chunk=8), dict(spec_decode=True),
                dict(enable_metrics=True), dict(prefix_cache=False)):
        with pytest.raises(NotImplementedError):
            TEngine(tcfg, tparams, config=TConfig(max_len=32, **bad),
                    device="cpu")
    eng = TEngine(tcfg, tparams, config=TConfig(max_len=32), device="cpu")
    with pytest.raises(NotImplementedError, match="threefry"):
        eng.submit(np.arange(4), TSampling(max_tokens=2, temperature=0.7))
