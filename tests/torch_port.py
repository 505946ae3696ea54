"""Shared fixtures of the PyTorch port's tests (``tests/test_torch_*.py``).

Tests that need the card carry the ``gpu`` marker and take the
``cuda_device`` fixture, which skips when no CUDA device is present. The
decision is made when the test runs, never at import or collection, so
every worker collects the same tests. On the card:
``python -m pytest -q -m gpu tests/test_torch_*.py``.

The helpers below build the same smoke-size model in the JAX package and
the port and drive engines through staggered request waves.
"""
import functools

import numpy as np
import pytest
import torch

# The suite runs in several worker processes at once; with torch's default
# intra-op pool in each, idle OpenMP threads spin and starve the other
# workers (the port's parity files ran ~6x slower in 6 workers). The
# tests' tensors are small: one thread each is enough.
torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with "
                    "`python -m pytest -m gpu tests/test_torch_*.py`")
    # plain float32 products in the plain versions, as the kernels compute
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# -- shared by the parity files (JAX is imported inside, never at import:
# the card's test environment has no JAX) ------------------------------------

# the smoke config widened so that every GEMM is packable (K a multiple
# of 32), with GQA (4 heads over 2 KV heads)
SMOKE_FIELDS = dict(compute_dtype="float32", d_model=64, n_heads=4,
                    n_kv_heads=2, d_ff=128)


# the VLM's gate is set to this in both packages' weights: the reference
# inits xgate to 0, and tanh(0) = 0 keeps the patches from every logit, so
# a parity test at the initial weights would pass with cross-attention
# wrong
XGATE = 0.5


def with_xgate(tree, value: float):
    """A copy of a parameter tree (the JAX package's or the port's) whose
    every ``xgate`` leaf (one a ``self_cross`` layer) holds ``value``."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k != "xgate":
            out[k] = with_xgate(v, value)
        elif isinstance(v, torch.Tensor):
            out[k] = torch.full_like(v, value)
        else:
            import jax.numpy as jnp

            out[k] = jnp.full_like(v, value)
    return out


@functools.lru_cache(maxsize=None)
def bridged_smoke(seed: int = 5, arch: str = "smollm-135m"):
    """(jcfg, tcfg, jparams, tparams): the smoke-size config of ``arch`` in
    both packages (smollm-135m's widened by ``SMOKE_FIELDS``; the others
    as published, in float32) and the JAX package's random params, bridged
    into the port in this process. A VLM's ``xgate`` is ``XGATE`` in
    both."""
    import jax

    import repro.configs as C
    from repro.models import params as jpp
    from repro.models.model import Model as JModel
    from repro_torch import configs as TC
    from repro_torch.bridge import from_jax_params

    fields = (SMOKE_FIELDS if arch == "smollm-135m"
              else dict(compute_dtype="float32"))
    jcfg = C.get_smoke(arch).replace(**fields)
    tcfg = TC.get_smoke(arch).replace(**fields)
    jparams = jpp.init_params(JModel(jcfg).build(), jax.random.key(seed))
    if jcfg.family == "vlm":
        jparams = with_xgate(jparams, XGATE)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, tcfg, jparams, tparams


def jax_engine(arch: str = "smollm-135m", **kw):
    """The JAX engine for EngineConfig(**kw) on ``bridged_smoke(arch=
    arch)``, with paged_impl="xla" where use_paged_kernel is set; one per
    configuration and process, reset: its jit caches carry over between
    tests, so the traffic's shapes compile once."""
    eng = _jax_engine(arch, tuple(sorted(kw.items())))
    eng.reset()
    return eng


@functools.lru_cache(maxsize=None)
def _jax_engine(arch, items):
    from repro.serve import ContinuousBatchingEngine, EngineConfig

    jcfg, _, jparams, _ = bridged_smoke(arch=arch)
    kw = dict(items)
    if kw.get("use_paged_kernel"):
        kw["paged_impl"] = "xla"
    return ContinuousBatchingEngine(jcfg, jparams,
                                    config=EngineConfig(**kw))


def run_waves(engine, sampling, waves, extras=None):
    """Submit each wave ``(prompts, n_tokens, gap)``, then step ``gap``
    times; drain at the end. ``sampling(n_tokens, i)`` gives the i-th
    request's SamplingParams, ``extras[i]`` (if given) its extra inputs.
    Returns the tokens of each request, in submission order."""
    out, rids = {}, []
    for prompts, n_tok, gap in waves:
        rids += [engine.submit(p, sampling(n_tok, len(rids) + i),
                               extra=extras[len(rids) + i] if extras
                               else None)
                 for i, p in enumerate(prompts)]
        for _ in range(gap):
            out.update({f.rid: f.tokens for f in engine.step()})
    while engine.scheduler.pending():
        out.update({f.rid: f.tokens for f in engine.step()})
    return [out[r] for r in rids]


def assert_same_tokens(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
