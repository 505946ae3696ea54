"""Port parity: chunked prefill and the fused mixed step against the JAX
package on bridged params (smoke size, packed SWIS weights, fp32).

``Model.mixed_step`` — decode rows, a chunk's rows and idle rows in one
launch, each committing its valid K/V through its own block table — gives
the JAX logits within 1e-5 on the rows with ``q_lens > 0`` (masked rows are
discarded by the engine and read a trash block whose duplicate writes have
no fixed winner), paged and gathered, and the same arena positions. The
engines then give the JAX engine's tokens: chunked prefill with staggered
arrivals and prefix hits that end inside a chunk, greedy and seeded at
temperature 0.8; and the fused step at ``prefill_chunk`` 8 and 16."""
import functools

import numpy as np
import pytest
import torch

from repro_torch.bridge import from_jax_params
from repro_torch.models.model import Model as TModel
from repro_torch.serve import ContinuousBatchingEngine as TEngine
from repro_torch.serve import EngineConfig as TConfig
from repro_torch.serve import SamplingParams as TSampling

pytest.importorskip("jax")  # the card's test environment has no JAX
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serve import SamplingParams as JSampling  # noqa: E402
from repro.serve.quantized import pack_tree as jpack_tree  # noqa: E402
from torch_port import (assert_same_tokens, bridged_smoke,  # noqa: E402
                        jax_engine, run_waves)

BS = 8


def _arena(rng, jcfg, n_blocks, live):
    """A random arena with garbage in the trash block and ``live`` =
    {physical block: (first position, n tokens)}."""
    shape = (jcfg.n_layers, n_blocks, BS, jcfg.n_kv_heads, jcfg.head_dim)
    kv = rng.normal(0, 1, (2,) + shape).astype(np.float32)
    pos = np.full((jcfg.n_layers, n_blocks, BS), -1, np.int32)
    pos[:, 0] = 3
    for blk, (base, n) in live.items():
        pos[:, blk, :n] = base + np.arange(n)
    return {"blocks": {"sub0_attn": {"k": kv[0], "v": kv[1], "pos": pos}}}


@functools.lru_cache(maxsize=None)
def _packed_models():
    jcfg, tcfg, jparams, _ = bridged_smoke()
    jparams, _ = jpack_tree(jparams, jcfg.quant.cfg)
    from repro.configs.base import QuantPolicy as JPolicy
    from repro_torch.configs.base import QuantPolicy as TPolicy

    jcfg = jcfg.replace(quant=JPolicy(cfg=jcfg.quant.cfg, mode="off"))
    tcfg = tcfg.replace(quant=TPolicy(cfg=tcfg.quant.cfg, mode="off"))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.mark.parametrize("paged", [True, False])
def test_mixed_step_logits_match_jax(paged):
    jcfg, tcfg, jparams, tparams = _packed_models()
    rng = np.random.default_rng(1)
    # rows 0-2 decode at depths 13 and 9 (row 2 idle, on the trash block);
    # row 3 carries a 6-token chunk past a committed 16-token prefix
    arena = _arena(rng, jcfg, 12, {3: (0, 8), 5: (8, 5), 6: (0, 8),
                                   2: (8, 1), 7: (0, 8), 8: (8, 8)})
    tables = np.zeros((4, 6), np.int32)
    tables[0, :2], tables[1, :2] = [3, 5], [6, 2]
    tables[3, :4] = [7, 8, 9, 10]  # blocks 9, 10: the chunk's owned blocks
    toks = rng.integers(0, jcfg.vocab, (4, 8)).astype(np.int32)
    start = np.array([13, 9, 0, 16], np.int32)
    q_lens = np.array([1, 1, 0, 6], np.int32)
    last = np.array([0, 0, 0, 5], np.int32)
    ja = jax.tree.map(jnp.asarray, arena)
    ta = from_jax_params(arena, device="cpu")
    jl, jnew = JModel(jcfg).mixed_step(
        jparams, {"tokens": jnp.asarray(toks)}, ja, jnp.asarray(start),
        jnp.asarray(q_lens), jnp.asarray(last), jnp.asarray(tables),
        paged="xla" if paged else None)
    tl, tnew = TModel(tcfg).mixed_step(
        tparams, {"tokens": torch.from_numpy(toks).long()}, ta, start, q_lens,
        torch.from_numpy(last), torch.from_numpy(tables), paged=paged)
    live = q_lens > 0
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                               rtol=1e-5, atol=1e-5)
    jn, tn = jnew["blocks"]["sub0_attn"], tnew["blocks"]["sub0_attn"]
    # the trash block takes every invalid write: compare the live blocks
    np.testing.assert_array_equal(tn["pos"][:, 1:].numpy(),
                                  np.asarray(jn["pos"])[:, 1:])
    np.testing.assert_allclose(tn["k"][:, 1:].numpy(),
                               np.asarray(jn["k"])[:, 1:], rtol=1e-5,
                               atol=1e-5)


def _waves(vocab, seed):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, 24)  # prefix hits end mid-chunk
    return [
        ([np.concatenate([shared, rng.integers(0, vocab, 13)]),
          rng.integers(0, vocab, 11)], 5, 3),
        ([rng.integers(0, vocab, 30)], 4, 2),  # arrives mid-flight
        ([np.concatenate([shared, rng.integers(0, vocab, 9)]),
          np.concatenate([shared[:16], rng.integers(0, vocab, 3)])], 6, 0),
    ]


def _both(kw, temperature, seed=3):
    jcfg, tcfg, jparams, tparams = bridged_smoke()
    kw = dict(max_len=64, n_slots=2, block_size=BS, packed=True,
              use_paged_kernel=True, **kw)
    waves = _waves(jcfg.vocab, seed)

    def sampling(cls):
        return lambda n, i: cls(max_tokens=n, temperature=temperature,
                                seed=i if temperature else None)

    jeng = jax_engine(**kw)
    teng = TEngine(tcfg, tparams, config=TConfig(**kw), device="cpu")
    want = run_waves(jeng, sampling(JSampling), waves)
    got = run_waves(teng, sampling(TSampling), waves)
    assert_same_tokens(got, want)
    return jeng, teng


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_chunked_engine_matches_jax(temperature):
    jeng, teng = _both(dict(prefill_chunk=8), temperature)
    jstats, tstats = jeng.prefix_stats(), teng.prefix_stats()
    assert tstats["hits"] > 0 and tstats["prefill_chunk_steps"] > 0
    for key in ("hits", "saved_tokens", "prefill_tokens",
                "prefill_chunk_steps"):
        assert tstats[key] == jstats[key], key
    assert teng.n_chunk_calls == tstats["prefill_chunk_steps"]
    assert teng.n_mixed_steps == 0


@pytest.mark.parametrize("chunk", [8, 16])
def test_fused_engine_matches_jax(chunk):
    jeng, teng = _both(dict(prefill_chunk=chunk, fused_step=True), 0.0,
                       seed=chunk)
    counters = jeng.metrics_registry.snapshot()["counters"]
    assert teng.n_mixed_steps == teng.prefix_stats()["prefill_chunk_steps"] > 0
    assert teng.n_chunk_calls == 0
    assert teng.model_calls() == counters["step.model_dispatches"]
