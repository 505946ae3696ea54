"""Port parity: the contiguous cache mode and ``DecodeEngine`` against the
JAX package on bridged params (smoke size, packed SWIS weights, fp32).

The continuous engine with ``prefix_cache=False`` keeps one contiguous row
per slot (bucketed prefill into a fresh tree, pad positions masked, rows
copied in, per-slot decode wrapping at each row's ring position) and gives
the JAX engine's tokens, greedy and seeded. ``DecodeEngine.generate``
(prefill, then lockstep decode over a shared position plane) gives the JAX
``DecodeEngine``'s tokens, greedy and at temperature 0.8, and the
continuous engine's ``generate`` the same. At model level, a prompt longer
than its ring cache keeps the tail in ring order, and decode steps that
wrap around it give the JAX logits within 1e-5."""
import numpy as np
import pytest
import torch

from repro_torch.bridge import from_jax_params
from repro_torch.models import params as tpp
from repro_torch.models.model import Model as TModel
from repro_torch.serve import ContinuousBatchingEngine as TEngine
from repro_torch.serve import DecodeEngine as TDecode
from repro_torch.serve import EngineConfig as TConfig
from repro_torch.serve import SamplingParams as TSampling

pytest.importorskip("jax")  # the card's test environment has no JAX
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.models import params as jpp  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serve import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serve import EngineConfig as JConfig  # noqa: E402
from repro.serve import SamplingParams as JSampling  # noqa: E402
from repro.serve.engine import DecodeEngine as JDecode  # noqa: E402
from torch_port import assert_same_tokens, bridged_smoke, run_waves  # noqa: E402


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_contiguous_engine_matches_jax(temperature):
    jcfg, tcfg, jparams, tparams = bridged_smoke()
    kw = dict(max_len=40, n_slots=2, packed=True, prefix_cache=False)
    rng = np.random.default_rng(9)
    # a 33-token prompt buckets to the whole 40-token row
    waves = [([rng.integers(0, jcfg.vocab, 33), rng.integers(0, jcfg.vocab, 6)],
              5, 2),
             ([rng.integers(0, jcfg.vocab, 11)], 7, 1),
             ([rng.integers(0, jcfg.vocab, 3), rng.integers(0, jcfg.vocab, 14)],
              4, 0)]

    def sampling(cls):
        return lambda n, i: cls(max_tokens=n, temperature=temperature,
                                seed=i if temperature else None)

    jeng = JEngine(jcfg, jparams, config=JConfig(**kw))
    teng = TEngine(tcfg, tparams, config=TConfig(**kw), device="cpu")
    assert teng.prefix_cache is None and teng.cache.block_size is None
    assert_same_tokens(run_waves(teng, sampling(TSampling), waves),
                       run_waves(jeng, sampling(JSampling), waves))
    assert teng.arena_calls() == 0 < teng.n_decode_steps
    assert teng.prefix_stats() == jeng.prefix_stats()


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_decode_engine_matches_jax(temperature):
    jcfg, tcfg, jparams, tparams = bridged_smoke()
    prompt = np.random.default_rng(10).integers(
        0, jcfg.vocab, (3, 9)).astype(np.int32)
    want = JDecode(jcfg, jparams, max_len=24, batch=3, packed=True).generate(
        prompt, 10, temperature=temperature, seed=4)
    teng = TDecode(tcfg, tparams, max_len=24, batch=3, packed=True,
                   device="cpu")
    got = teng.generate(prompt, 10, temperature=temperature, seed=4)
    np.testing.assert_array_equal(got, want)
    # the continuous engine's static-batch wrapper draws the same keys
    ceng = TEngine(tcfg, tparams, config=TConfig(
        max_len=24, n_slots=2, packed=True, prefix_cache=False), device="cpu")
    np.testing.assert_array_equal(
        ceng.generate(prompt, 10, temperature=temperature, seed=4), want)


def test_ring_tail_prefill_and_wrapping_decode_match_jax():
    jcfg, tcfg, jparams, tparams = bridged_smoke()
    jm, tm = JModel(jcfg), TModel(tcfg)
    cache_len, s0 = 16, 21  # the prompt overflows the ring by 5
    jc = jpp.init_params(jm.build_cache(2, cache_len, jnp.float32),
                         jax.random.key(0))
    tc = tpp.init_params(tm.build_cache(2, cache_len, torch.float32),
                         device="cpu")
    toks = np.random.default_rng(11).integers(0, jcfg.vocab, (2, s0))
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks, jnp.int32)}, jc)
    tl, tc = tm.prefill(tparams, {"tokens": torch.from_numpy(toks).long()}, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    for i in range(4):  # lockstep decode writes wrap around the ring
        tok = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
        jl, jc = jm.decode_step(jparams, jnp.asarray(tok), jc,
                                jnp.int32(s0 + i))
        tl, tc = tm.decode_step(tparams, torch.from_numpy(tok).long(), tc,
                                s0 + i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                                   atol=1e-5)
    tn = from_jax_params(jax.tree.map(np.asarray, jc), device="cpu")
    for leaf in ("pos", "k"):
        np.testing.assert_allclose(
            tc["blocks"]["sub0_attn"][leaf].numpy(),
            tn["blocks"]["sub0_attn"][leaf].numpy(), rtol=1e-5, atol=1e-5)
