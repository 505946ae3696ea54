"""The port's sharded training on 4 gloo ranks (CPU processes, file
rendezvous), against the JAX package's unsharded trainer in this process.
The JAX package's own multi-device tests (``tests/test_distributed.py``)
fail in this environment, so the sharded port is held to its unsharded
trainer. One run of ``tests/torch_dist_port.py`` per rank does every
check; the tests below read its results."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
from torch.distributed.tensor import Replicate, Shard

pytest.importorskip("jax")  # the card's test environment has no JAX
import jax  # noqa: E402
import repro.configs as JC  # noqa: E402
from repro.models import params as jpp  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.train import loop as jloop  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
WORLD = 4
TIMEOUT_S = 240  # each rank's own limit


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """(rank 0's results, the JAX trainer's losses on the same params)."""
    work = tmp_path_factory.mktemp("gloo")
    cfg = JC.get_smoke("qwen2-moe-a2.7b").replace(compute_dtype="float32")
    jparams = jpp.init_params(JModel(cfg).build(), jax.random.key(7))
    np.savez(work / "params.npz", **_flat(jax.tree.map(np.asarray, jparams)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(HERE), "src"), HERE]),
        OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_dist_port.py"), str(r),
         str(WORLD), str(work / "rdv"), str(work)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    want = jloop.Trainer(cfg, seq_len=32, global_batch=8, total_steps=6,
                         warmup=2, peak_lr=5e-3,
                         init_params=jparams).run(6)["losses"]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r][-4000:]}"
    with open(work / "result.json") as f:
        return json.load(f), want


def test_sharded_trainer_follows_reference_trainer(gloo):
    """(i) qwen2-moe smoke on a (2, 2) mesh, float32, from the JAX params:
    the JAX unsharded trainer's 6 losses within rtol 2e-5 (sums split
    over the model axis add in another order), ``wq`` split over model."""
    got, want = gloo
    res = got["moe_trainer"]
    np.testing.assert_allclose(res["losses"], want, rtol=2e-5)
    assert res["wq"] == [str(Replicate()), str(Shard(2))]


def test_elastic_resume_matches_unbroken_run(gloo):
    """(ii) a step-2 checkpoint of a (2, 2) run, resumed on (4, 1): the
    four later losses of an unbroken (2, 2) run within rtol 2e-5."""
    res = gloo[0]["elastic"]
    assert len(res["resumed"]) == 4
    np.testing.assert_allclose(res["resumed"], res["unbroken"][2:],
                               rtol=2e-5)
    # on (4, 1): the layer stack's wq split over a model axis of one rank
    assert res["wq"] == [str(Replicate()), str(Shard(2))]


def test_fsdp_masters_are_2d_sharded(gloo):
    """(iii) fsdp_params with grad_accum 2: masters and moments split over
    data and model; the loss stays finite."""
    res = gloo[0]["fsdp"]
    assert res["wi"] == [str(Shard(1)), str(Shard(2))]
    assert res["m"] == [str(Shard(1)), str(Shard(2))]
    assert len(res["losses"]) == 4 and np.isfinite(res["losses"]).all()


def test_packed_weight_split_over_n_and_k(gloo):
    """(iv) a packed (128, 64) weight split over N (columns gathered) and
    over K (partial products all-reduced) through the local kernels' plain
    versions: the whole product within fp32 order."""
    res = gloo[0]["packed_split"]
    assert res["N"]["split"] == -1 and res["K"]["split"] == -2
    for r in res.values():
        assert r["err"] <= 1e-5 * r["scale"], r


def test_sharded_qat_copy_is_bit_identical(gloo):
    """(v) the hoisted fake-quant of the sharded compute copy equals the
    whole tree's bit for bit, at 4 shifts (on the shards, the amax
    all-reduced) and at 2.5 (column schedule: gathered)."""
    res = gloo[0]["qat_bits"]
    for n in ("4", "2.5"):
        assert res[n]["bad"] == [], (n, res[n])
        assert res[n]["sharded"] > 0


def test_sharded_decode_matches_unsharded(gloo):
    """(vi) prefill and 3 decode steps on (2, 2) with the cache split over
    its positions: each rank's logits equal the unsharded model's rows
    within fp32 order (rtol 1e-5 of the largest logit), for a dense arch,
    the MoE and Griffin; a MoE prefill whose dispatch groups would span
    ranks raises."""
    res = gloo[0]["sharded_decode"]
    assert set(res) == {"smollm-135m", "qwen2-moe-a2.7b",
                        "recurrentgemma-2b"}
    for arch, r in res.items():
        assert len(r["errs"]) == 4
        assert max(r["errs"]) <= 1e-5 * r["scale"], (arch, r)
        # K (layers, batch, kv_seq, kv_heads, head_dim): kv_seq over model
        assert r["k"] == [str(Shard(1)), str(Shard(2))], (arch, r)
    # a rank's 8 tokens cannot make a dispatch group of 64 of its own
    assert "a group would span ranks" in \
        res["qwen2-moe-a2.7b"]["spanning_groups"]


def test_launcher_one_rank_mesh_on_cpu(capsys):
    """``--mesh-data 1 --mesh-model 1 --device cpu``: a one-rank gloo group
    of the launcher's own in this process, the unsharded run's losses."""
    import torch.distributed as dist

    from repro_torch.launch import train

    argv = ["--arch", "smollm-135m", "--smoke", "--device", "cpu",
            "--steps", "3", "--seq", "16", "--batch", "4", "--warmup", "1"]
    want = train.run(train.parse_args(argv))["losses"]
    got = train.run(train.parse_args(argv + ["--mesh-data", "1",
                                             "--mesh-model", "1"]))
    assert not dist.is_initialized()
    np.testing.assert_allclose(got["losses"], want, rtol=1e-6)
    assert type(got["state"].params["embed"]["tok"]).__name__ == "DTensor"
    with pytest.raises(ValueError, match="needs 2 ranks"):
        train.run(train.parse_args(argv + ["--mesh-data", "2"]))
    assert not dist.is_initialized()
