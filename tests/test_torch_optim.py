"""Port parity of the optimizer substrate and the data pipeline on
identical inputs: AdamW (fp32 moments, ``sqrt(v/c2) + eps``, decay only
on leaves of ndim >= 2, a ``None`` gradient as zeros) within rtol 1e-6 of
the reference over several steps; global-norm clipping within rtol 1e-6;
the learning-rate schedules within rtol 1e-6; int8 gradient compression
bit-identical; the synthetic pipeline's batches equal for every family."""
import numpy as np
import pytest
import torch

from repro_torch import configs as TC
from repro_torch.data import SyntheticPipeline
from repro_torch.optim import (AdamW, clip_by_global_norm, compressed_allreduce,
                               dequantize_grads, global_norm,
                               quantize_grads_int8, warmup_cosine,
                               warmup_linear)

pytest.importorskip("jax")  # the card's test environment has no JAX
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import repro.configs as C  # noqa: E402
import repro.optim as jopt  # noqa: E402
from repro.data import SyntheticPipeline as JPipeline  # noqa: E402


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(0, 0.1, (8, 6)).astype(np.float32),
            "blk": {"scale": rng.normal(1, 0.1, (6,)).astype(np.float32),
                    "stack": rng.normal(0, 0.1, (2, 4, 6)).astype(np.float32)},
            "unused": rng.normal(0, 0.1, (5, 6)).astype(np.float32)}


def _t(tree):
    return jax.tree.map(torch.from_numpy, tree)


def test_adamw_matches_reference_with_a_missing_gradient():
    params = _tree()
    jparams, tparams = jax.tree.map(jnp.asarray, params), _t(params)
    jo, to = jopt.AdamW(), AdamW()
    jstate, tstate = jo.init(jparams), to.init(tparams)
    for step in range(4):
        g = _tree(seed=10 + step)
        g["unused"] = np.zeros_like(g["unused"])  # jax.grad's zeros
        tg = _t(g)
        tg["unused"] = None  # the port's autograd leaves it None
        lr = 1e-2 * (step + 1)
        jparams, jstate = jo.update(jax.tree.map(jnp.asarray, g), jstate,
                                    jparams, lr=jnp.float32(lr),
                                    step=jnp.int32(step))
        tparams, tstate = to.update(tg, tstate, tparams,
                                    lr=np.float32(lr), step=step)
    for got, want in ((tparams, jparams), (tstate["m"], jstate["m"]),
                      (tstate["v"], jstate["v"])):
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-9), got, want)
    # the unused leaf still decays (ndim 2); the 1-D scale does not
    assert not np.array_equal(tparams["unused"].numpy(), params["unused"])


def test_adamw_converges_quadratic():
    opt = AdamW(weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = opt.init(params)
    target = torch.tensor([1.0, 2.0])
    for step in range(300):
        g = {"w": 2 * (params["w"] - target)}
        params, state = opt.update(g, state, params, lr=0.05, step=step)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(), atol=1e-2)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    tree = _tree(seed=3)
    jc, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, tree),
                                      max_norm)
    tc, tn = clip_by_global_norm(_t(tree), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a.numpy(), np.asarray(b), rtol=1e-6), tc, jc)
    np.testing.assert_allclose(float(global_norm(tc)),
                               float(jopt.global_norm(jc)), rtol=1e-6)
    # a None leaf is a zero gradient
    with_none = dict(_t(tree), unused=None)
    no_leaf = {k: v for k, v in _t(tree).items() if k != "unused"}
    assert float(global_norm(with_none)) == float(global_norm(no_leaf))


@pytest.mark.parametrize("sched", ["warmup_cosine", "warmup_linear"])
def test_schedules_match_reference(sched):
    jf = getattr(jopt, sched)(3e-3, 20, 200, floor=1e-5)
    tf = {"warmup_cosine": warmup_cosine,
          "warmup_linear": warmup_linear}[sched](3e-3, 20, 200, floor=1e-5)
    for step in (0, 1, 7, 19, 20, 21, 57, 150, 199, 200, 260):
        np.testing.assert_allclose(float(tf(step)), float(jf(step)),
                                   rtol=1e-6, err_msg=str(step))
    assert float(tf(0)) < float(tf(19)) and float(tf(199)) < float(tf(20))


def test_int8_compression_bit_identical():
    rng = np.random.default_rng(4)
    g = {"w": rng.normal(0, 1e-3, (64, 64)).astype(np.float32),
         "b": {"s": rng.normal(0, 5.0, (33,)).astype(np.float32)}}
    jq, js = jopt.quantize_grads_int8(jax.tree.map(jnp.asarray, g))
    tq, ts = quantize_grads_int8(_t(g))
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        a.numpy(), np.asarray(b)), tq, jq)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        a.numpy(), np.asarray(b)), ts, js)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        a.numpy(), np.asarray(b)), dequantize_grads(tq, ts),
        jopt.dequantize_grads(jq, js))
    assert tq["w"].dtype == torch.int8


def test_compressed_allreduce_on_one_rank(tmp_path):
    """One rank of a gloo group: the mean over one rank is the int8
    round trip of the reference's compression."""
    import torch.distributed as dist

    x = torch.from_numpy(np.random.default_rng(5).normal(
        0, 1, (16, 8)).astype(np.float32))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}",
                            rank=0, world_size=1)
    try:
        got = compressed_allreduce(x)
    finally:
        dist.destroy_process_group()
    q, s = jopt.quantize_grads_int8({"x": jnp.asarray(x.numpy())})
    want = np.asarray(jopt.dequantize_grads(q, s)["x"])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ["smollm-135m", "hubert-xlarge",
                                  "llama-3.2-vision-11b"])
def test_pipeline_batches_equal_reference(arch):
    jcfg, tcfg = C.get_smoke(arch), TC.get_smoke(arch)
    for step in (0, 3, 100000):
        want = JPipeline(jcfg, 16, 4, seed=2).batch_at(step)
        got = SyntheticPipeline(tcfg, 16, 4, seed=2).batch_at(step)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], k)
    full = SyntheticPipeline(tcfg, 16, 8, seed=1)
    parts = [SyntheticPipeline(tcfg, 16, 8, seed=1, n_hosts=4, host_id=h)
             for h in range(4)]
    key = "frames" if tcfg.family == "encoder" else "tokens"
    np.testing.assert_array_equal(
        np.concatenate([p.host_slice(p.batch_at(3))[key] for p in parts]),
        full.batch_at(3)[key])
    assert SyntheticPipeline.resume_step(full.state(7)) == 7
