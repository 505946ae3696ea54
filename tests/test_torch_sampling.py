"""Port parity: the port's threefry sampler (``repro_torch.serve.prng`` and
``sample_step``) against ``jax.random`` and ``repro.serve.engine.
sample_step``. Keys, fold-ins, random bits and uniforms are integer or
bit-level work and must be equal; the gumbel noise passes through ``log``,
whose last bit may differ between torch and XLA, so it is held within 4
float32 ulps of its magnitude plus 4 ulps of 1 (the inner log's error,
carried through the outer one); the sampled tokens must be equal. Then the
block engine at temperature 0.8 with per-request seeds gives the JAX
engine's tokens, and a second run the same tokens."""
import numpy as np
import pytest
import torch

from repro_torch.serve import ContinuousBatchingEngine as TEngine
from repro_torch.serve import EngineConfig as TConfig
from repro_torch.serve import SamplingParams as TSampling
from repro_torch.serve import prng
from repro_torch.serve import sample_step as t_sample_step

pytest.importorskip("jax")  # the card's test environment has no JAX
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.serve import SamplingParams as JSampling  # noqa: E402
from repro.serve.engine import sample_step as j_sample_step  # noqa: E402
from torch_port import (assert_same_tokens, bridged_smoke,  # noqa: E402
                        jax_engine, run_waves)

SEEDS = [0, 1, 7, 12345, 2**31 - 1, -1, -12345]
TINY = np.finfo(np.float32).tiny


def _jkey(seed, *data):
    k = jax.random.key(seed)
    for d in data:
        k = jax.random.fold_in(k, np.uint32(d))
    return k


def _tkey(seed, *data):
    k = prng.key(seed)
    for d in data:
        k = prng.fold_in(k, d)
    return k


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_fold_in_match_jax(seed):
    want = np.asarray(jax.random.key_data(_jkey(seed)), np.int64)
    np.testing.assert_array_equal(prng.key(seed).numpy(), want)
    for data in ([0], [1], [5, 3], [2**31 + 3], [2**32 - 1, 17]):
        want = np.asarray(jax.random.key_data(_jkey(seed, *data)), np.int64)
        np.testing.assert_array_equal(_tkey(seed, *data).numpy(), want)
    # a batch of keys folds in per-row data in one call
    keys = torch.stack([prng.key(seed)] * 3)
    got = prng.fold_in(keys, torch.tensor([4, 9, 0]))
    for r, d in enumerate((4, 9, 0)):
        np.testing.assert_array_equal(got[r].numpy(), _tkey(seed, d).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_bits_uniforms_and_gumbel_match_jax(seed):
    for step, n in ((0, 1), (3, 1000), (11, 4099)):
        jk, tk = _jkey(seed, step), _tkey(seed, step)[None]
        want = np.asarray(jax.random.bits(jk, (n,), jnp.uint32), np.int64)
        np.testing.assert_array_equal(prng.random_bits(tk, n)[0].numpy(), want)
        want = np.asarray(jax.random.uniform(jk, (n,), jnp.float32,
                                             minval=TINY, maxval=1.0))
        np.testing.assert_array_equal(prng.uniform(tk, n)[0].numpy(), want)
        want = np.asarray(jax.random.gumbel(jk, (n,), jnp.float32))
        got = prng.gumbel(tk, n)[0].numpy()
        # an ulp of the inner log (about 1) becomes an absolute error of
        # about 2**-23 in the outer one, whatever the noise's magnitude
        ulp = np.spacing(np.abs(want)) + np.spacing(np.float32(1))
        assert np.all(np.abs(got - want) <= 4 * ulp)


@pytest.mark.parametrize("vocab", [512, 49152])
def test_sample_step_tokens_match_jax(vocab):
    rng = np.random.default_rng(vocab)
    b = 6
    logits = rng.normal(0, 3, (b, vocab)).astype(np.float32)
    temps = np.array([0.8, 1.0, 0.0, 2.0, 0.3, 0.8], np.float32)  # row 2 greedy
    jkeys = jnp.stack([_jkey(s, r) for r, s in enumerate((0, 0, 3, 9, -4, 77))])
    tkeys = torch.stack([_tkey(s, r)
                         for r, s in enumerate((0, 0, 3, 9, -4, 77))])
    for step in range(12):
        steps = (step + np.arange(b) * 5).astype(np.int32)
        want = np.asarray(j_sample_step(jnp.asarray(logits), jkeys,
                                        jnp.asarray(steps), jnp.asarray(temps)))
        got = t_sample_step(torch.from_numpy(logits), tkeys, steps, temps)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    # an all-greedy batch is the argmax, noise or not
    zeros = np.zeros(b, np.float32)
    np.testing.assert_array_equal(
        t_sample_step(torch.from_numpy(logits), tkeys, steps, zeros).numpy(),
        logits.argmax(-1))


def test_engine_seeded_sampling_matches_jax():
    jcfg, tcfg, jparams, tparams = bridged_smoke()
    kw = dict(max_len=48, n_slots=2, block_size=8, packed=True,
              use_paged_kernel=True)
    rng = np.random.default_rng(6)
    shared = rng.integers(0, jcfg.vocab, 16)
    waves = [([np.concatenate([shared, rng.integers(0, jcfg.vocab, 5)]),
               rng.integers(0, jcfg.vocab, 11)], 6, 2),
             ([np.concatenate([shared, rng.integers(0, jcfg.vocab, 9)]),
               rng.integers(0, jcfg.vocab, 4)], 7, 0)]

    def sampling(cls):
        # request 1 has no seed: it samples with its auto-key
        return lambda n, i: cls(max_tokens=n, temperature=0.8,
                                seed=None if i == 1 else 100 + i)

    jeng = jax_engine(**kw)
    want = run_waves(jeng, sampling(JSampling), waves)
    teng = TEngine(tcfg, tparams, config=TConfig(**kw), device="cpu")
    got = run_waves(teng, sampling(TSampling), waves)
    assert_same_tokens(got, want)
    teng.reset()
    assert_same_tokens(run_waves(teng, sampling(TSampling), waves), got)
    # explicit keys: the reference's key data, as two uint32 words
    key = np.asarray(jax.random.key_data(_jkey(3, 8)))
    prompt = rng.integers(0, jcfg.vocab, 10)
    jeng.reset()
    jr = jeng.submit(prompt, JSampling(max_tokens=6, temperature=1.2,
                                       key=_jkey(3, 8)))
    tr = teng.submit(prompt, TSampling(max_tokens=6, temperature=1.2, key=key))
    np.testing.assert_array_equal(teng.drain()[tr], jeng.drain()[jr])
