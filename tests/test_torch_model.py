"""Port parity: smoke-config logits of the port's ``Model`` against the JAX
``Model`` on bridged params, for ``prefill_bucketed``, ``prefill_chunk``
(suffix prefill past a cached prefix) and ``decode_step`` over a block
arena, paged and gathered — packed and unpacked weights, ``keep_slices``
set and unset, fp32 compute, rtol 1e-4 and atol 1e-4 * max|logits|.

The smoke config's d_model (60) leaves only the MLP's down projection
packable (K must be a multiple of 32), so a second variant widens it to 64
with GQA (4 heads over 2 KV heads) so that every GEMM runs packed."""
import functools
import zlib
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch import configs as TC
from repro_torch.bridge import from_jax_params
from repro_torch.configs.base import QuantPolicy as TPolicy
from repro_torch.core.swis import QuantConfig as TQuant
from repro_torch.models import params as tpp
from repro_torch.models.model import Model as TModel

pytest.importorskip("jax")  # the card's test environment has no JAX
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import repro.configs as C  # noqa: E402
from repro.configs.base import QuantPolicy as JPolicy  # noqa: E402
from repro.core.swis import QuantConfig as JQuant  # noqa: E402
from repro.models import params as jpp  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serve.quantized import pack_tree as jpack_tree  # noqa: E402

BS = 8
L = 32  # working-tree / per-slot length (4 logical blocks)


def _cfgs(variant, packed, keep_slices):
    fields = dict(compute_dtype="float32")
    if variant == "gqa64":
        fields.update(d_model=64, n_heads=4, n_kv_heads=2, d_ff=128)
    jcfg = C.get_smoke("smollm-135m").replace(**fields)
    tcfg = TC.get_smoke("smollm-135m").replace(**fields)
    if packed:
        jcfg = jcfg.replace(quant=JPolicy(cfg=JQuant(n_shifts=3), mode="off",
                                          keep_slices=keep_slices))
        tcfg = tcfg.replace(quant=TPolicy(cfg=TQuant(n_shifts=3), mode="off",
                                          keep_slices=keep_slices))
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _params(variant, packed):
    jcfg, _ = _cfgs(variant, False, None)
    jparams = jpp.init_params(JModel(jcfg).build(), jax.random.key(3))
    if packed:
        jparams, stats = jpack_tree(jparams, JQuant(n_shifts=3))
        assert stats["n_packed"] == (7 if variant == "gqa64" else 1)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    return jparams, tparams


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def _cache_pair(jm, tm, batch, length):
    jc = jpp.init_params(jm.build_cache(batch, length, jnp.float32,
                                        per_slot=True), jax.random.key(0))
    tc = tpp.init_params(tm.build_cache(batch, length, torch.float32,
                                        per_slot=True), device="cpu")
    return jc, tc


@pytest.mark.parametrize("variant", ["smoke", "gqa64"])
@pytest.mark.parametrize("packed,keep_slices", [(False, None), (True, None),
                                                (True, 2)])
def test_logits_match_reference(variant, packed, keep_slices):
    jcfg, tcfg = _cfgs(variant, packed, keep_slices)
    jparams, tparams = _params(variant, packed)
    jm, tm = JModel(jcfg), TModel(tcfg)
    rng = np.random.default_rng(11)
    vocab = jcfg.vocab

    # whole-prompt prefill, bucket-padded: rows of 13 and 9 real tokens
    toks = rng.integers(0, vocab, (2, 16)).astype(np.int32)
    last = np.array([12, 8], np.int32)
    jc, tc = _cache_pair(jm, tm, 2, L)
    jl, jc = jax.jit(jm.prefill_bucketed)(jparams, {"tokens": jnp.asarray(toks)},
                                          jc, jnp.asarray(last))
    tl, tc = tm.prefill_bucketed(tparams, {"tokens": torch.from_numpy(toks).long()},
                                 tc, torch.from_numpy(last).long())
    _close(tl, jl)
    _close(tc["blocks"]["sub0_attn"]["k"], jc["blocks"]["sub0_attn"]["k"])

    # suffix prefill past a committed 8-token prefix (cache rows [0, 8))
    sfx = rng.integers(0, vocab, (2, 8)).astype(np.int32)
    slast = np.array([7, 4], np.int32)
    jl, _ = jax.jit(jm.prefill_chunk)(jparams, {"tokens": jnp.asarray(sfx)}, jc,
                                      jnp.int32(8), jnp.asarray(slast))
    tl, _ = tm.prefill_chunk(tparams, {"tokens": torch.from_numpy(sfx).long()},
                             tc, 8, torch.from_numpy(slast).long())
    _close(tl, jl)

    # block-table decode over an arena: rows at depths 13, 9 and a free
    # slot parked on the trash block
    n_blocks = 8
    ja, ta = _cache_pair(jm, tm, n_blocks, BS)
    arena_kv = rng.normal(0, 1, np.shape(ja["blocks"]["sub0_attn"]["k"]))
    pos = np.full((jcfg.n_layers, n_blocks, BS), -1, np.int32)
    tables = np.zeros((3, L // BS), np.int32)
    tables[0, :2], tables[1, :2] = [3, 5], [6, 2]
    for blk, n_tok, base in ((3, 8, 0), (5, 5, 8), (6, 8, 0), (2, 1, 8)):
        pos[:, blk, :n_tok] = base + np.arange(n_tok)
    pos[:, 0] = 4  # garbage in the trash block
    ja = {"blocks": {"sub0_attn": {
        "k": jnp.asarray(arena_kv, jnp.float32),
        "v": jnp.asarray(arena_kv[..., ::-1], jnp.float32),
        "pos": jnp.asarray(pos)}}}
    tok = rng.integers(0, vocab, (3, 1)).astype(np.int32)
    idx = np.array([13, 9, 0], np.int32)
    for paged in (True, False):
        ta = from_jax_params(jax.tree.map(np.asarray, ja), device="cpu")
        jl, jnew = jm.decode_step(jparams, jnp.asarray(tok), ja,
                                  jnp.asarray(idx), jnp.asarray(tables),
                                  paged="xla" if paged else None)
        tl, tnew = tm.decode_step(tparams, torch.from_numpy(tok).long(), ta,
                                  torch.from_numpy(idx), torch.from_numpy(tables),
                                  paged=paged)
        _close(tl[:2], jl[:2])  # row 2 is a free slot: its logits are garbage
        jn, tn = jnew["blocks"]["sub0_attn"], tnew["blocks"]["sub0_attn"]
        np.testing.assert_array_equal(tn["pos"].numpy(), np.asarray(jn["pos"]))
        _close(tn["k"][:, 1:], jn["k"][:, 1:])


def test_configs_match_reference():
    """The port's config dataclasses keep the reference's fields and
    defaults (``MoEConfig.e_total`` included), its registry holds every
    arch of the reference's, and each arch its published widths (the
    dense family, the MoE family, the recurrent families, the VLM and the
    encoder)."""
    import dataclasses

    import repro.configs.base as jbase
    from repro_torch.configs import base as tbase

    for name in ("ArchConfig", "QuantPolicy", "ParallelConfig", "MoEConfig",
                 "GriffinConfig", "Mamba2Config", "VLMConfig"):
        jf = {f.name: f.default for f in dataclasses.fields(getattr(jbase, name))}
        tf = {f.name: f.default for f in dataclasses.fields(getattr(tbase, name))}
        assert jf == tf, name
    assert dataclasses.asdict(TQuant()) == dataclasses.asdict(JQuant())
    for t in (2.5, 3, 0.5):
        for ds in (False, True):
            assert (TQuant(n_shifts=t, double_shift=ds).shift_levels()
                    == JQuant(n_shifts=t, double_shift=ds).shift_levels())
    assert TC.ARCH_IDS == C.ARCH_IDS and len(set(TC.ARCH_IDS)) == 10
    for arch in TC.ARCH_IDS:
        for getter in ("get_config", "get_smoke"):
            jc = getattr(C, getter)(arch)
            tc = getattr(TC, getter)(arch)
            assert dataclasses.asdict(tc) == dataclasses.asdict(jc), arch
            assert ((tc.head_dim, tc.padded_vocab)
                    == (jc.head_dim, jc.padded_vocab)), arch
            if jc.moe is not None:
                assert tc.moe.e_total == jc.moe.e_total, arch
    for n, padded in ((8, 0), (60, 64), (16, 8)):
        assert (TC.MoEConfig(n_experts=n, n_experts_padded=padded).e_total
                == C.MoEConfig(n_experts=n, n_experts_padded=padded).e_total)


@pytest.mark.parametrize("arch", list(C.ARCH_IDS))
def test_full_config_param_counts_match_reference(arch):
    """``count_params`` of each published config's placeholder tree (no
    weight is drawn) equals the reference's, and so do the leaves' paths
    and shapes."""
    tree_t = TModel(TC.get_config(arch)).build()
    tree_j = JModel(C.get_config(arch)).build()
    assert tpp.count_params(tree_t) == jpp.count_params(tree_j)
    shapes_j = {jax.tree_util.keystr(path): leaf.shape for path, leaf in
                jax.tree_util.tree_flatten_with_path(
                    tree_j, is_leaf=jpp.is_placeholder)[0]}
    shapes_t = {}

    def walk(path, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(path + f"[{k!r}]", v)
        else:
            shapes_t[path] = node.shape

    walk("", tree_t)
    assert shapes_t == shapes_j


@pytest.mark.parametrize("packed", [False, True])
def test_mistral_large_logits_match_reference(packed):
    """mistral-large-123b's smoke config (3 layers, 6 heads over 2 KV heads
    with ``d_head`` given, as the published config gives 128): ``apply``
    logits, unpacked and packed."""
    fields = dict(compute_dtype="float32")
    jcfg = C.get_smoke("mistral-large-123b").replace(**fields)
    tcfg = TC.get_smoke("mistral-large-123b").replace(**fields)
    jparams = jpp.init_params(JModel(jcfg).build(), jax.random.key(8))
    if packed:
        jparams, stats = jpack_tree(jparams, JQuant(n_shifts=3))
        # q/k/v/o and the MLP's three (K 96 and 192); not the unembedding
        assert stats["n_packed"] == 7
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    toks = np.random.default_rng(9).integers(0, jcfg.vocab, (2, 11))
    want = JModel(jcfg).apply(jparams, {"tokens": jnp.asarray(toks,
                                                              jnp.int32)})[0]
    got = TModel(tcfg).apply(tparams, {"tokens": torch.from_numpy(toks)})[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * float(jnp.abs(want).max()))


@functools.lru_cache(maxsize=None)
def _moe_params(packed):
    jcfg = C.get_smoke("qwen2-moe-a2.7b").replace(compute_dtype="float32")
    jparams = jpp.init_params(JModel(jcfg).build(), jax.random.key(6))
    if packed:
        jparams, stats = jpack_tree(jparams, JQuant(n_shifts=3))
        # q/k/v/o, the routed wi and wg stacks, and the three shared
        # experts; the 48-wide expert wo is too narrow to pack
        assert stats["n_packed"] == 9
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    return jparams, tparams


@pytest.mark.parametrize("packed,keep_slices", [(False, None), (True, None),
                                                (True, 2)])
def test_moe_logits_match_reference(packed, keep_slices):
    """The qwen2-moe smoke model (2 layers, shared experts): ``apply``
    logits and the layers' summed ``moe_aux`` (the capacity path), then a
    paged ``decode_step`` over a block arena (the dropless decode path).
    ``keep_slices`` truncates the attention GEMMs only, as in the
    reference."""
    fields = dict(compute_dtype="float32")
    jcfg = C.get_smoke("qwen2-moe-a2.7b").replace(**fields)
    tcfg = TC.get_smoke("qwen2-moe-a2.7b").replace(**fields)
    if packed:
        jcfg = jcfg.replace(quant=JPolicy(cfg=JQuant(n_shifts=3), mode="off",
                                          keep_slices=keep_slices))
        tcfg = tcfg.replace(quant=TPolicy(cfg=TQuant(n_shifts=3), mode="off",
                                          keep_slices=keep_slices))
    jparams, tparams = _moe_params(packed)
    jm, tm = JModel(jcfg), TModel(tcfg)
    rng = np.random.default_rng(12)
    toks = rng.integers(0, jcfg.vocab, (2, 12)).astype(np.int32)
    jl, _, jaux = jax.jit(jm.apply)(jparams, {"tokens": jnp.asarray(toks)})
    tl, _, taux = tm.apply(tparams, {"tokens": torch.from_numpy(toks).long()})
    _close(tl, jl)
    assert float(jaux) > 0
    np.testing.assert_allclose(taux.numpy(), np.asarray(jaux), rtol=1e-5)

    n_blocks = 6
    shape = (jcfg.n_layers, n_blocks, BS, jcfg.n_kv_heads, jcfg.head_dim)
    kv = rng.normal(0, 1, (2,) + shape).astype(np.float32)
    pos = np.full(shape[:3], -1, np.int32)
    pos[:, 0] = 4  # garbage in the trash block
    pos[:, 3, :8], pos[:, 5, :3], pos[:, 2, :6] = (
        np.arange(8), np.arange(8, 11), np.arange(6))
    arena = {"blocks": {"sub0_moe": {"k": kv[0], "v": kv[1], "pos": pos}}}
    tables = np.zeros((3, L // BS), np.int32)
    tables[0, :2], tables[1, :1] = [3, 5], [2]  # row 2: a free slot
    tok = rng.integers(0, jcfg.vocab, (3, 1)).astype(np.int32)
    idx = np.array([11, 6, 0], np.int32)
    jl, _ = jm.decode_step(jparams, jnp.asarray(tok),
                           jax.tree.map(jnp.asarray, arena), jnp.asarray(idx),
                           jnp.asarray(tables), paged="xla")
    tl, _ = tm.decode_step(tparams, torch.from_numpy(tok).long(),
                           from_jax_params(arena, device="cpu"),
                           torch.from_numpy(idx), torch.from_numpy(tables),
                           paged=True)
    _close(tl[:2], jl[:2])



def _crc_leaf_rng(root, path):
    """The reference's per-leaf key with ``zlib.crc32`` of each path token
    in place of Python's salted ``hash``: the same weights in every
    process."""
    key = root
    for part in path:
        token = getattr(part, "key", None) or str(getattr(part, "idx", part))
        key = jax.random.fold_in(key, np.uint32(zlib.crc32(token.encode()) % (2 ** 31)))
    return key


@functools.lru_cache(maxsize=None)
def _bf16_params(arch, fields, seed, packed):
    """Reference params of ``arch``'s smoke config (``fields`` over it),
    drawn with :func:`_crc_leaf_rng` from ``jax.random.key(seed)``, packed
    at 3 shifts if asked, and their bridge into the port."""
    jcfg = C.get_smoke(arch).replace(**dict(fields))
    with mock.patch.object(jpp, "_leaf_rng", _crc_leaf_rng):
        jparams = jpp.init_params(JModel(jcfg).build(), jax.random.key(seed))
    if packed:
        jparams, _ = jpack_tree(jparams, JQuant(n_shifts=3))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    return jparams, tparams


def _bf16_prefill(jcfg, tcfg, jparams, tparams, seed):
    """Bucketed prefill of two rows (13 and 9 real tokens) at bf16 compute
    into a bf16 cache, as the engines serve by default: the logits of both
    packages as float32 numpy arrays."""
    jm, tm = JModel(jcfg), TModel(tcfg)
    toks = np.random.default_rng(seed).integers(0, jcfg.vocab, (2, 16))
    last = np.array([12, 8])
    jc = jpp.init_params(jm.build_cache(2, L, jnp.bfloat16, per_slot=True),
                         jax.random.key(0))
    tc = tpp.init_params(tm.build_cache(2, L, torch.bfloat16, per_slot=True),
                         device="cpu")
    jl, _ = jax.jit(jm.prefill_bucketed)(
        jparams, {"tokens": jnp.asarray(toks, jnp.int32)}, jc,
        jnp.asarray(last, jnp.int32))
    tl, _ = tm.prefill_bucketed(tparams, {"tokens": torch.from_numpy(toks)},
                                tc, torch.from_numpy(last))
    return tl.float().numpy(), np.asarray(jl.astype(jnp.float32))


def _bf16_close(got, want):
    """Within 2 % of max|logit| (bf16 rounds activations at other places in
    the two frameworks), with the same greedy token at every position."""
    top = np.abs(want).max()
    assert np.abs(got - want).max() <= 0.02 * top, np.abs(got - want).max() / top
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("variant", ["smoke", "gqa64"])
@pytest.mark.parametrize("packed", [False, True])
def test_bf16_prefill_matches_reference(variant, packed):
    """The dense smoke configs at ``compute_dtype="bfloat16"`` (the configs'
    default), packed and unpacked. The weights are the same in every
    process (:func:`_crc_leaf_rng`): the reference's own salted draws move
    the bf16 gap between the packages by a factor of 2 or more from one
    process to the next, as much as each package's bf16 logits move from
    its fp32 ones."""
    jcfg, tcfg = _cfgs(variant, packed, None)
    fields = (("compute_dtype", "float32"),) + (
        (("d_model", 64), ("n_heads", 4), ("n_kv_heads", 2), ("d_ff", 128))
        if variant == "gqa64" else ())
    jparams, tparams = _bf16_params("smollm-135m", fields, 3, packed)
    _bf16_close(*_bf16_prefill(jcfg.replace(compute_dtype="bfloat16"),
                               tcfg.replace(compute_dtype="bfloat16"),
                               jparams, tparams, seed=21))


@pytest.mark.parametrize("packed", [False, True])
def test_moe_bf16_prefill_matches_reference(packed):
    """The qwen2-moe smoke model at ``compute_dtype="bfloat16"``, packed and
    unpacked, on weights that are the same in every process: the capacity
    path's expert GEMMs take bf16 rows, as they do when the model serves.
    Packed, the reference dequantizes each expert stack to bf16 (weights
    times scale, rounded) and rounds the einsum's output to bf16, which puts
    its bf16 logits 4.9 % of max|logit| from its fp32 ones here; the port's
    expert op adds in fp32 and scales after the sum. So the packed port is
    held to the reference's fp32 logits within the same 2 %, and its greedy
    tokens to the reference's bf16 ones."""
    jcfg = C.get_smoke("qwen2-moe-a2.7b")
    tcfg = TC.get_smoke("qwen2-moe-a2.7b")
    if packed:
        jcfg = jcfg.replace(quant=JPolicy(cfg=JQuant(n_shifts=3), mode="off"))
        tcfg = tcfg.replace(quant=TPolicy(cfg=TQuant(n_shifts=3), mode="off"))
    jparams, tparams = _bf16_params("qwen2-moe-a2.7b",
                                    (("compute_dtype", "float32"),), 6, packed)
    got, want = _bf16_prefill(jcfg.replace(compute_dtype="bfloat16"),
                              tcfg.replace(compute_dtype="bfloat16"),
                              jparams, tparams, seed=22)
    if not packed:
        _bf16_close(got, want)
        return
    _, want32 = _bf16_prefill(jcfg.replace(compute_dtype="float32"),
                              tcfg.replace(compute_dtype="float32"),
                              jparams, tparams, seed=22)
    _bf16_close(got, want32)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
