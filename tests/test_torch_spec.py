"""Port parity: self-speculative decode against the JAX package on bridged
params (smoke size, packed SWIS weights, fp32).

``Model.verify_step`` scores every fed position of every row in one
launch: its logits on the positions with ``i < q_lens`` are within 1e-5
of the JAX ones. The speculative engine, with drafts cut to 1 and to 2
bit-planes and the 0.8-temperature seeded sampler, gives the JAX engine's
tokens with the same numbers of proposed and accepted drafts, and leaves
the block pool quiescent (every block free or committed and unreferenced,
the trash block pinned), as ``tests/test_rollback_invariants.py`` holds the
JAX engine to."""
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
from torch_port import (assert_same_tokens, bridged_smoke,  # noqa: E402
                        jax_engine, run_waves)

BS = 8


@pytest.mark.parametrize("paged", [True, False])
def test_verify_step_logits_match_jax(paged):
    jcfg, tcfg, jparams, tparams = bridged_smoke()
    rng = np.random.default_rng(4)
    n_blocks, sv = 8, 4
    shape = (jcfg.n_layers, n_blocks, BS, jcfg.n_kv_heads, jcfg.head_dim)
    kv = rng.normal(0, 1, (2,) + shape).astype(np.float32)
    pos = np.full((jcfg.n_layers, n_blocks, BS), -1, np.int32)
    pos[:, 0] = 5  # garbage in the trash block
    for blk, base, n in ((3, 0, 8), (5, 8, 6), (6, 0, 8), (2, 8, 8), (4, 16, 2)):
        pos[:, blk, :n] = base + np.arange(n)
    # stale entries of rejected drafts beyond row 0's feed window
    pos[:, 5, 6:] = [30, 31]
    arena = {"blocks": {"sub0_attn": {"k": kv[0], "v": kv[1], "pos": pos}}}
    tables = np.zeros((3, 4), np.int32)
    tables[0, :2], tables[1, :3] = [3, 5], [6, 2, 4]
    toks = rng.integers(0, jcfg.vocab, (3, sv)).astype(np.int32)
    start = np.array([13, 18, 0], np.int32)
    q_lens = np.array([2, 4, 0], np.int32)  # row 2 sits the launch out
    jl, _ = JModel(jcfg).verify_step(
        jparams, {"tokens": jnp.asarray(toks)},
        jax.tree.map(jnp.asarray, arena), jnp.asarray(start),
        jnp.asarray(q_lens), jnp.asarray(tables),
        paged="xla" if paged else None)
    tl, _ = TModel(tcfg).verify_step(
        tparams, {"tokens": torch.from_numpy(toks).long()},
        from_jax_params(arena, device="cpu"), start, q_lens,
        torch.from_numpy(tables), paged=paged)
    assert tl.shape == (3, sv, jcfg.padded_vocab)
    live = np.arange(sv)[None, :] < q_lens[:, None]
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                               rtol=1e-5, atol=1e-5)


def _waves(vocab):
    rng = np.random.default_rng(8)
    shared = rng.integers(0, vocab, 2 * BS)
    # mixed budgets: full spec_k drafts, clamped tails, and rows one token
    # from their budget (plain decode)
    return [([np.concatenate([shared, rng.integers(0, vocab, 5)]),
              rng.integers(0, vocab, 9)], 8, 2),
            ([rng.integers(0, vocab, 4)], 2, 1),
            ([np.concatenate([shared, rng.integers(0, vocab, 11)]),
              rng.integers(0, vocab, 7)], 6, 0)]


@pytest.mark.parametrize("draft_slices", [1, 2])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_spec_engine_matches_jax(draft_slices, temperature):
    jcfg, tcfg, jparams, tparams = bridged_smoke()
    kw = dict(max_len=64, n_slots=2, block_size=BS, n_cache_blocks=4,
              packed=True, use_paged_kernel=True, spec_decode=True, spec_k=3,
              draft_slices=draft_slices)
    waves = _waves(jcfg.vocab)

    def sampling(cls):
        return lambda n, i: cls(max_tokens=n, temperature=temperature,
                                seed=i if temperature else None)

    jeng = jax_engine(**kw)
    want = run_waves(jeng, sampling(JSampling), waves)
    teng = TEngine(tcfg, tparams, config=TConfig(**kw), device="cpu")
    got = run_waves(teng, sampling(TSampling), waves)
    assert_same_tokens(got, want)
    counters = jeng.metrics_registry.snapshot()["counters"]
    assert teng.spec_proposed == counters["spec.proposed"] > 0
    assert teng.spec_accepted == counters["spec.accepted"]
    assert teng.model_calls() == counters["step.model_dispatches"]
    assert teng.n_verify_steps == counters["spec.steps"]
    pool = teng.prefix_cache.pool
    assert pool.refcount[0] == 1  # the trash block stays pinned
    np.testing.assert_array_equal(pool.refcount[1:], 0)
    committed = {b for b in range(1, pool.n_blocks)
                 if teng.prefix_cache.is_committed(b)}
    free = set(pool._free)
    assert free.isdisjoint(committed)
    assert free | committed == set(range(1, pool.n_blocks))
