"""The port's engine keeps the reference's deprecated loose-kwarg shims
(``tests/test_engine_config.py``'s engine cases, one counterpart each):
``ContinuousBatchingEngine(cfg, params, **legacy)`` and ``submit(prompt,
n_tokens, temperature=..., key=..., seed=...)`` warn and work, and reject
a mix, an unknown name, a missing budget and a wrong type as the reference
does. ``paged_impl`` is not a field of the port's ``EngineConfig``, so it
is an unknown name here. A legacy submit gives the same tokens as a
``SamplingParams`` submit, and as the JAX engine's legacy submit on
bridged weights."""
import functools
import warnings

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.models import params as pp
from repro_torch.models.model import Model
from repro_torch.serve import (ContinuousBatchingEngine, EngineConfig,
                               SamplingParams)


@functools.lru_cache(maxsize=1)
def _setup():
    cfg = configs.get_smoke("smollm-135m").replace(compute_dtype="float32")
    params = pp.init_params(Model(cfg).build(),
                            torch.Generator().manual_seed(0), device="cpu")
    return cfg, params


def _prompt(seed=0):
    cfg, _ = _setup()
    return np.random.default_rng(seed).integers(0, cfg.vocab, 6).astype(
        np.int32)


# -- engine construction shims -----------------------------------------

def test_legacy_kwargs_warn_and_work():
    cfg, params = _setup()
    with pytest.warns(DeprecationWarning, match="EngineConfig"):
        eng = ContinuousBatchingEngine(cfg, params, max_len=32, n_slots=2,
                                       device="cpu")
    assert eng.max_len == 32 and eng.n_slots == 2
    assert eng.config == EngineConfig(max_len=32, n_slots=2)


def test_config_and_legacy_kwargs_conflict():
    cfg, params = _setup()
    with pytest.raises(TypeError, match="not both"):
        ContinuousBatchingEngine(cfg, params, config=EngineConfig(),
                                 max_len=32, device="cpu")


def test_unknown_legacy_kwarg_lists_fields():
    cfg, params = _setup()
    with pytest.raises(TypeError) as exc:
        ContinuousBatchingEngine(cfg, params, maxlen=32, device="cpu")
    msg = str(exc.value)
    assert "maxlen" in msg and "max_len" in msg


def test_legacy_kwargs_still_validated():
    cfg, params = _setup()
    with pytest.raises(ValueError, match="fused_step"), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ContinuousBatchingEngine(cfg, params, fused_step=True, device="cpu")


def test_non_config_positional_rejected():
    cfg, params = _setup()
    with pytest.raises(TypeError, match="EngineConfig"):
        ContinuousBatchingEngine(cfg, params, config=32, device="cpu")


def test_paged_impl_is_an_unknown_legacy_kwarg():
    """The reference's ``paged_impl`` picks its paged backend; in the port
    the tensors' device does, so the name is refused with the fields."""
    cfg, params = _setup()
    with pytest.raises(TypeError) as exc:
        ContinuousBatchingEngine(cfg, params, use_paged_kernel=True,
                                 paged_impl="xla", device="cpu")
    msg = str(exc.value)
    assert "paged_impl" in msg and "use_paged_kernel" in msg


# -- submit shims ------------------------------------------------------

def _engine():
    cfg, params = _setup()
    return ContinuousBatchingEngine(
        cfg, params, config=EngineConfig(max_len=32, n_slots=2), device="cpu")


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_submit_legacy_matches_params(temperature):
    p = _prompt()
    eng = _engine()
    r0 = eng.submit(p, SamplingParams(max_tokens=4, seed=7,
                                      temperature=temperature))
    with pytest.warns(DeprecationWarning, match="SamplingParams"):
        r1 = eng.submit(p, 4, seed=7, temperature=temperature)
    with pytest.warns(DeprecationWarning, match="SamplingParams"):
        r2 = eng.submit(p, n_tokens=4, key=[0, 7], seed=3,
                        temperature=temperature)
    r3 = eng.submit(p, SamplingParams(max_tokens=4, key=[0, 7],
                                      temperature=temperature))
    out = eng.drain()
    np.testing.assert_array_equal(out[r0], out[r1])
    np.testing.assert_array_equal(out[r2], out[r3])


def test_submit_params_plus_legacy_kwargs_conflict():
    with pytest.raises(TypeError, match="cannot be combined"):
        _engine().submit(_prompt(), SamplingParams(max_tokens=4), seed=1)


def test_submit_requires_budget():
    with pytest.raises(TypeError, match="SamplingParams"):
        _engine().submit(_prompt())


def test_submit_rejects_wrong_params_type():
    with pytest.raises(TypeError, match="SamplingParams"):
        _engine().submit(_prompt(), "four")


def test_submit_positional_budget_and_n_tokens_conflict():
    with pytest.raises(TypeError, match="n_tokens"):
        _engine().submit(_prompt(), 4, n_tokens=4)


def test_legacy_submit_matches_the_jax_engine():
    """The same legacy calls (seed, then an explicit key, at T 0.8) on the
    JAX engine and the port's, on bridged weights: equal tokens."""
    pytest.importorskip("jax")
    import jax

    from torch_port import bridged_smoke, jax_engine

    jcfg, tcfg, _, tparams = bridged_smoke()
    jeng = jax_engine(max_len=32, n_slots=2)
    teng = ContinuousBatchingEngine(
        tcfg, tparams, config=EngineConfig(max_len=32, n_slots=2),
        device="cpu")
    prompts = [np.random.default_rng(i).integers(0, jcfg.vocab, 6 + i)
               .astype(np.int32) for i in range(3)]
    jkey = jax.random.key(3)
    tkey = np.asarray(jax.random.key_data(jkey))
    outs = []
    for eng, key in ((jeng, jkey), (teng, tkey)):
        with pytest.warns(DeprecationWarning):
            rids = [eng.submit(prompts[0], 5, temperature=0.8, seed=11),
                    eng.submit(prompts[1], 4, temperature=0.8, key=key),
                    eng.submit(prompts[2], n_tokens=3)]
        out = eng.drain()
        outs.append([out[r] for r in rids])
    for got, want in zip(outs[1], outs[0]):
        np.testing.assert_array_equal(got, want)
