"""Port parity: the serve engines on the recurrent families (the Griffin and
Mamba2 smoke configs, fp32, packed SWIS weights) against the JAX package on
bridged params.

Neither family's cache is a full-length attention cache (recurrent state
without a position plane; Griffin's local attention is a ring of its
window), so both serve through the contiguous fallback: no prefix cache, no
bucket padding, prefill grouped by exact prompt length, and the options
that need the block arena raise as the reference's do. Tokens (greedy and
seeded) over staggered waves of unequal prompt lengths, counters, the cost
model and scheduler gauges equal the JAX engine's; ``DecodeEngine`` gives
the continuous engine's tokens; ``pack_tree`` of the smoke trees (tail
included) is bit-identical to the reference's, and packing layer by layer
equals packing the whole tree."""
import numpy as np
import pytest
import torch

from repro_torch import configs as TC
from repro_torch.core.swis import QuantConfig as TQuant
from repro_torch.models import params as tpp
from repro_torch.models.model import Model as TModel
from repro_torch.serve import ContinuousBatchingEngine as TEngine
from repro_torch.serve import DecodeEngine as TDecode
from repro_torch.serve import EngineConfig as TConfig
from repro_torch.serve import SamplingParams as TSampling
from repro_torch.serve import SlotKVCache
from repro_torch.serve import quantized as tquantized

pytest.importorskip("jax")  # the card's test environment has no JAX
import jax  # noqa: E402
from repro.core.swis import QuantConfig as JQuant  # noqa: E402
from repro.serve import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serve import EngineConfig as JConfig  # noqa: E402
from repro.serve import SamplingParams as JSampling  # noqa: E402
from repro.serve.engine import DecodeEngine as JDecode  # noqa: E402
from repro.serve.quantized import pack_tree as jpack_tree  # noqa: E402
from torch_port import (assert_same_tokens, bridged_smoke,  # noqa: E402
                        jax_engine, run_waves)

ARCHS = ["recurrentgemma-2b", "mamba2-2.7b"]
BASE = dict(max_len=48, n_slots=2, packed=True)


def _waves(vocab):
    """Staggered arrivals of unequal prompt lengths: 23 (past Griffin's
    smoke window of 8, and past Mamba2's smoke chunk of 16), 5, 11, 11 and
    1 token; two of a length are prefilled in one group."""
    rng = np.random.default_rng(8)
    p = [rng.integers(0, vocab, n) for n in (23, 5, 11, 11, 1)]
    return [([p[0], p[1]], 6, 2), ([p[2]], 8, 4), ([p[3], p[4]], 4, 0)]


@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_family_falls_back_contiguous(arch):
    """The port of ``tests/test_prefix_cache.py``'s test of the same name:
    with ``prefix_cache=True`` asked for, the engine keeps no prefix cache,
    no bucket padding and contiguous rows, and its ``generate`` equals
    ``DecodeEngine``'s (and the JAX DecodeEngine's) at T 0.7, seed 3."""
    jcfg, tcfg, jparams, tparams = bridged_smoke(arch=arch)
    eng = TEngine(tcfg, tparams, config=TConfig(max_len=32, n_slots=2,
                                                prefix_cache=True),
                  device="cpu")
    assert eng.prefix_cache is None and not eng.bucket_prompts
    assert not eng.block_mode and eng.cache.block_size is None
    assert not SlotKVCache.supports_blocks(eng.model, 32)
    prompt = np.random.default_rng(3).integers(0, tcfg.vocab, (2, 7)).astype(
        np.int32)
    want = TDecode(tcfg, tparams, max_len=32, batch=2, device="cpu").generate(
        prompt, 6, temperature=0.7, seed=3)
    np.testing.assert_array_equal(
        eng.generate(prompt, 6, temperature=0.7, seed=3), want)
    np.testing.assert_array_equal(
        want, JDecode(jcfg, jparams, max_len=32, batch=2).generate(
            prompt, 6, temperature=0.7, seed=3))
    # prefill groups prompts by exact length (no row sees a pad token):
    # prompts of 7, 9 and 7 tokens admitted together take two calls
    eng = TEngine(tcfg, tparams, config=TConfig(max_len=32, n_slots=3),
                  device="cpu")
    for n in (7, 9, 7):
        eng.submit(np.arange(n) % tcfg.vocab, TSampling(max_tokens=2))
    eng.step()
    assert eng.n_prefill_calls == 2


def test_block_mode_needs_full_length_attention_caches():
    """``supports_blocks`` is False for recurrent state, a window-truncated
    ring or a tail subtree, and True for the dense family's caches."""
    assert SlotKVCache.supports_blocks(TModel(TC.get_smoke("smollm-135m")), 32)
    griffin = TModel(TC.get_smoke("recurrentgemma-2b"))
    assert not SlotKVCache.supports_blocks(griffin, 32)
    assert not SlotKVCache.supports_blocks(TModel(TC.get_smoke("mamba2-2.7b")),
                                           32)
    # the local ring alone (max_len within the window, no rec state) still
    # carries a tail: no block mode
    local = TModel(TC.get_smoke("recurrentgemma-2b").replace(
        n_layers=1, griffin=TC.GriffinConfig(
            lru_width=64, conv_width=4, window=8, pattern=("attn_local",))))
    assert SlotKVCache.supports_blocks(local, 8)
    assert not SlotKVCache.supports_blocks(local, 32)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_engine_matches_jax(arch, temperature):
    jcfg, tcfg, _, tparams = bridged_smoke(arch=arch)
    jeng = jax_engine(arch=arch, **BASE)
    teng = TEngine(tcfg, tparams, config=TConfig(**BASE), device="cpu")
    assert teng.prefix_cache is None and jeng.prefix_cache is None
    waves = _waves(jcfg.vocab)

    def sampling(cls):
        return lambda n, i: cls(max_tokens=n, temperature=temperature,
                                seed=i if temperature else None)

    want = run_waves(jeng, sampling(JSampling), waves)
    got = run_waves(teng, sampling(TSampling), waves)
    assert_same_tokens(got, want)
    jm, tm = jeng.metrics(), teng.metrics()
    tc = tm["engine"]["counters"]
    assert tc == jm["engine"]["counters"]  # cost.*, step.model_dispatches
    assert any(k.startswith("cost.") for k in tc)
    assert tc["step.model_dispatches"] == teng.model_calls()
    assert teng.arena_calls() == 0 < teng.n_decode_steps
    assert tm["engine"]["cost_model"] == jm["engine"]["cost_model"]
    assert tm["scheduler"] == jm["scheduler"]
    assert tm["prefix_cache"] == jm["prefix_cache"]


@pytest.mark.parametrize("arch", ARCHS)
def test_options_without_block_mode_raise_as_the_reference(arch):
    jcfg, tcfg, jparams, tparams = bridged_smoke(arch=arch)
    for opts in (dict(prefill_chunk=8), dict(use_paged_kernel=True),
                 dict(spec_decode=True)):
        with pytest.raises(ValueError) as want:
            JEngine(jcfg, jparams, config=JConfig(**BASE, **opts))
        with pytest.raises(ValueError) as got:
            TEngine(tcfg, tparams, config=TConfig(**BASE, **opts),
                    device="cpu")
        assert str(got.value) == str(want.value)
        assert "block-mode prefix cache" in str(got.value)


@pytest.mark.parametrize("arch", ARCHS)
def test_pack_tree_bit_identical_to_reference(arch):
    """Every stacked and tail GEMM weight is packed, and the gates, the
    conv, the decay and dt leaves and the norms are left as they are, as
    the reference's eligibility does, bit for bit (uint32 words as int32
    views)."""
    _, _, jparams, tparams = bridged_smoke(arch=arch)
    q = dict(n_shifts=3)
    want, jstats = jpack_tree(jparams, JQuant(**q))
    got, tstats = tquantized.pack_tree(tparams, TQuant(**q))
    assert tstats == jstats
    flat_w, flat_g, tparams_flat = _flat(want), _flat(got), _flat(tparams)
    assert sorted(flat_g) == sorted(flat_w)
    for path, w in flat_w.items():
        w, g = np.asarray(w), flat_g[path].numpy()
        np.testing.assert_array_equal(
            g.view(np.uint32) if w.dtype == np.uint32 else g, w, path)
    packed = [p for p in flat_w if p.endswith("/mask_planes")]
    if arch == "recurrentgemma-2b":
        assert "tail/tail0_rec/rec/in_x/w/mask_planes" in packed
        names = ("gate_a", "gate_x", "conv_w", "lambda_raw")
    else:
        names = ("conv_w", "A_log", "D", "dt_bias")
    kept = [p for p in flat_w if p.split("/")[-1] in names
            or "norm" in p or "/ln" in p]
    assert len(kept) >= len(names) + 2
    for path in kept:  # left unpacked, as stored
        assert "mask_planes" not in _get(got, path), path
        assert flat_g[path].shape == tparams_flat[path].shape, path


def _flat(tree, prefix=""):
    """{'a/b/c': leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _get(tree, path):
    for k in path.split("/")[:-1]:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("arch", ARCHS)
def test_layerwise_packing_equals_pack_tree(arch):
    """Packing one layer at a time (the tail at once) gives exactly
    pack_tree of the same float32 weights, stats included."""
    cfg = TC.get_smoke(arch).replace(compute_dtype="float32")
    tree = TModel(cfg).build()
    qcfg = TQuant(n_shifts=3)
    dense = tpp.init_params_layerwise(tree, torch.Generator().manual_seed(7),
                                      device="cpu")
    want, want_stats = tquantized.pack_tree(dense, qcfg)
    got, stats = tquantized.init_packed_params(
        tree, qcfg, torch.Generator().manual_seed(7), device="cpu")
    assert stats == want_stats and stats["n_packed"] >= 2
    assert set(got) == set(want) == set(tree)
    flat_w, flat_g = [], []
    tpp.tree_map(flat_w.append, want)
    tpp.tree_map(flat_g.append, got)
    assert len(flat_g) == len(flat_w)
    for a, b in zip(flat_g, flat_w):
        assert a.dtype == b.dtype and torch.equal(a, b)
