"""Helpers shared by the port's training parity files
(``test_torch_loss*.py``, ``test_torch_train.py``,
``test_torch_checkpoint.py``). JAX is imported inside, never at import."""
import dataclasses

import numpy as np
import torch

from repro_torch.models.params import tree_map

LR = 3e-3  # the train-step tests' peak learning rate


def smoke_batch(cfg, seed=0, b=2, s=16):
    """The reference's ``tests/test_models.py`` batch: tokens (or the
    encoder's frames), labels with a few masked, and the VLM's patches."""
    rng = np.random.default_rng(seed)
    batch = {}
    if cfg.family == "encoder":
        batch["frames"] = rng.normal(0, 1, (b, s, cfg.d_model)).astype(
            np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels[0, :3] = -1  # masked positions
    batch["labels"] = labels
    if cfg.family == "vlm":
        batch["patches"] = rng.normal(
            0, 1, (b, cfg.vlm.n_patches, cfg.vlm.vision_dim)).astype(
                np.float32)
    return batch


def leaves_by_path(tree, prefix=()):
    """{path tuple: leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(leaves_by_path(v, prefix + (k,)))
        return out
    return {prefix: tree}


def assert_tree_close(got, want, rtol_of_max, label=""):
    """Every leaf of ``got`` (tensors; ``None`` stands for zeros) within
    ``rtol_of_max`` x the leaf's max |want| of ``want`` (numpy or JAX
    arrays), with the same paths."""
    g, w = leaves_by_path(got), leaves_by_path(want)
    assert set(g) == set(w), (label, set(g) ^ set(w))
    for path, ref in w.items():
        ref = np.asarray(ref, dtype=np.float32)
        t = g[path]
        t = np.zeros_like(ref) if t is None else t.detach().float().numpy()
        tol = rtol_of_max * max(float(np.abs(ref).max()), 1e-30)
        np.testing.assert_allclose(t, ref, rtol=0, atol=tol,
                                   err_msg=f"{label} {'/'.join(path)}")


def requires_grad(tree):
    return tree_map(lambda a: a.clone().requires_grad_(True), tree)


def grads_of(tree):
    return tree_map(lambda a: a.grad, tree)


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def check_loss_and_grads(arch):
    """``Model.loss`` of ``arch``'s smoke config (float32, the JAX
    params bridged): loss parts within rtol 1e-5, every gradient leaf within
    1e-4 x its max |g|."""
    import jax
    import jax.numpy as jnp

    from repro.models.model import Model as JModel
    from repro_torch.models.model import Model
    from torch_port import bridged_smoke

    jcfg, tcfg, jparams, tparams = bridged_smoke(seed=1, arch=arch)
    batch = smoke_batch(jcfg)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JModel(jcfg).loss(p, jax.tree.map(jnp.asarray, batch)),
        has_aux=True)(jparams)
    leaves = requires_grad(tparams)
    tl, tm = Model(tcfg).loss(leaves, to_torch(batch))
    tl.backward()
    tm = {k: v.detach() for k, v in tm.items()}
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert np.isfinite(float(tl.detach()))
    assert_tree_close(grads_of(leaves), jg, 1e-4, arch)


def qat_configs(dtype, n_shifts, arch="smollm-135m", **parallel):
    """``bridged_smoke(arch)`` under SWIS QAT at ``n_shifts`` in both
    packages, at compute ``dtype``, with ``parallel`` fields set."""
    from repro.configs.base import ParallelConfig as JParallel
    from repro.configs.base import QuantPolicy as JPolicy
    from repro.core.swis import QuantConfig as JQuant
    from repro_torch.configs.base import ParallelConfig, QuantPolicy
    from repro_torch.core.swis import QuantConfig
    from torch_port import bridged_smoke

    jcfg, tcfg, jparams, tparams = bridged_smoke(arch=arch)
    q = dict(method="swis", n_shifts=n_shifts)
    jcfg = jcfg.replace(compute_dtype=dtype, quant=JPolicy(
        cfg=JQuant(**q), mode="qat"),
        parallel=dataclasses.replace(JParallel(), **parallel))
    tcfg = tcfg.replace(compute_dtype=dtype, quant=QuantPolicy(
        cfg=QuantConfig(**q), mode="qat"),
        parallel=dataclasses.replace(ParallelConfig(), **parallel))
    return jcfg, tcfg, jparams, tparams
