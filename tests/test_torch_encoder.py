"""Port parity: the encoder family (hubert) against the JAX package, on the
same numpy frames and bridged params in one process, float32.

The smoke model's ``Model.apply`` logits (two ``enc`` layers after the
frame projection ``frontend``), unpacked and SWIS-packed, within rtol 1e-5
and atol 1e-5 * max|logit|; ``pack_tree`` packing the same 6 stacked GEMM
leaves as the reference (the frontend stays dense) and
``init_packed_params`` reporting ``pack_tree``'s stats; attention that
sees both ways whatever ``cfg.causal`` says; and the serve engines and the
launcher refusing the encoder, which the reference's engine cannot serve
either."""
import numpy as np
import pytest
import torch

from repro_torch import configs as TC
from repro_torch.core.swis import QuantConfig as TQuant
from repro_torch.launch import serve as tlaunch
from repro_torch.models import params as tpp
from repro_torch.models.model import Model as TModel
from repro_torch.serve import ContinuousBatchingEngine as TEngine
from repro_torch.serve import DecodeEngine as TDecode
from repro_torch.serve import EngineConfig as TConfig
from repro_torch.serve import quantized as tquantized

pytest.importorskip("jax")  # the card's test environment has no JAX
import jax.numpy as jnp  # noqa: E402
from repro.core.swis import QuantConfig as JQuant  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serve import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serve import EngineConfig as JConfig  # noqa: E402
from repro.serve import SamplingParams as JSampling  # noqa: E402
from repro.serve.quantized import pack_tree as jpack_tree  # noqa: E402
from torch_port import bridged_smoke  # noqa: E402

ARCH = "hubert-xlarge"
QCFG = dict(n_shifts=3)


def _frames(cfg, b=2, s=12, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1, (b, s, cfg.d_model)).astype(np.float32)


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=tol,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("packed", [False, True])
def test_encoder_logits_match_reference(packed):
    jcfg, tcfg, jparams, tparams = bridged_smoke(arch=ARCH)
    if packed:
        jparams, jstats = jpack_tree(jparams, JQuant(**QCFG))
        tparams, tstats = tquantized.pack_tree(tparams, TQuant(**QCFG))
        # q/k/v/o and the MLP's wi/wo, stacked over the layers; the
        # frontend and the unembedding stay dense
        assert tstats == jstats and tstats["n_packed"] == 6
        assert not tquantized.is_packed(tparams["frontend"]["w"])
        np.testing.assert_array_equal(
            tparams["blocks"]["sub0_enc"]["attn"]["wq"]["w"]["mask_planes"]
            .numpy(),
            np.asarray(jparams["blocks"]["sub0_enc"]["attn"]["wq"]["w"]
                       ["mask_planes"]).view(np.int32))
    frames = _frames(jcfg)
    want, _, _ = JModel(jcfg).apply(jparams, {"frames": jnp.asarray(frames)})
    got, _, _ = TModel(tcfg).apply(tparams,
                                   {"frames": torch.from_numpy(frames)})
    assert got.shape == (2, 12, tcfg.padded_vocab)
    _close(got, want)


@pytest.mark.parametrize("causal", [False, True])
def test_encoder_attends_both_ways(causal):
    """Changing the last frame changes position 0's logits, in both
    packages, even under ``causal=True``: ``enc`` blocks ignore it."""
    jcfg, tcfg, jparams, tparams = bridged_smoke(arch=ARCH)
    jcfg, tcfg = jcfg.replace(causal=causal), tcfg.replace(causal=causal)
    frames = _frames(jcfg, seed=1)
    moved = frames.copy()
    moved[:, -1] += 1.0
    tm, jm = TModel(tcfg), JModel(jcfg)
    got = [tm.apply(tparams, {"frames": torch.from_numpy(f)})[0]
           for f in (frames, moved)]
    want = [jm.apply(jparams, {"frames": jnp.asarray(f)})[0]
            for f in (frames, moved)]
    for g, w in zip(got, want):
        _close(g, w)
    assert (got[0][:, 0] - got[1][:, 0]).abs().max() > 1e-3
    assert float(jnp.abs(want[0][:, 0] - want[1][:, 0]).max()) > 1e-3


def test_init_packed_params_stats_equal_pack_tree():
    """Drawn and packed layer by layer, the encoder (its ``frontend`` a
    top-level subtree, like the embeddings) reports ``pack_tree``'s stats
    of the same generator's weights, and the frontend stays dense."""
    tcfg = TC.get_smoke(ARCH).replace(compute_dtype="float32")
    tree = TModel(tcfg).build()
    qcfg = TQuant(**QCFG)
    packed, stats = tquantized.init_packed_params(
        tree, qcfg, torch.Generator().manual_seed(2), device="cpu")
    whole = tpp.init_params_layerwise(tree, torch.Generator().manual_seed(2),
                                      device="cpu")
    want_tree, want = tquantized.pack_tree(whole, qcfg)
    assert stats == want and stats["n_packed"] == 6
    np.testing.assert_array_equal(packed["frontend"]["w"].numpy(),
                                  want_tree["frontend"]["w"].numpy())


def test_engines_refuse_the_encoder():
    """The port's engines and launcher raise ``ValueError`` for a config
    with no decoder; the reference's engine cannot serve it either (its
    prefill feeds tokens to a model that reads frames)."""
    jcfg, tcfg, jparams, tparams = bridged_smoke(arch=ARCH)
    assert not tcfg.has_decoder
    with pytest.raises(ValueError, match="encoder-only"):
        TEngine(tcfg, tparams, config=TConfig(max_len=32), device="cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        TDecode(tcfg, tparams, max_len=32, device="cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        tlaunch.run(tlaunch.parse_args(["--arch", ARCH, "--smoke",
                                        "--device", "cpu"]))
    jeng = JEngine(jcfg, jparams, config=JConfig(max_len=32, n_slots=1))
    jeng.submit(np.arange(5, dtype=np.int32), JSampling(max_tokens=2))
    with pytest.raises(KeyError, match="frames"):
        jeng.step()


def test_frontend_is_one_projection():
    """``Model.apply`` of the encoder projects the frames through the
    frontend before the first layer: at zero depth the logits are
    ``norm(frames @ w) @ unembed``."""
    _, tcfg, _, tparams = bridged_smoke(arch=ARCH)
    cfg0 = tcfg.replace(n_layers=0)
    params0 = dict(tparams, blocks=tpp.tree_map(lambda a: a[:0],
                                                tparams["blocks"]))
    frames = torch.from_numpy(_frames(tcfg, seed=3))
    got = TModel(cfg0).apply(params0, {"frames": frames})[0]
    x = frames @ tparams["frontend"]["w"]
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    x = (x - mu) * torch.rsqrt(var + 1e-6) * tparams["final_norm"]["scale"]
    want = x @ tparams["embed"]["unembed"]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
