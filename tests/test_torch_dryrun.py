"""The port's dry-run (``repro_torch.launch.dryrun``) as rank 0 of a fake
256-rank group: its records carry the reference's keys, its per-device
argument bytes equal the bytes the JAX package's rules give the same
placeholders, its FLOPs are per device, and the report's tables are the
reference's on the same records. Every value computed under the fake group
is undefined; only shapes, counts and bytes are checked."""
import json
import math

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the card's test environment has no JAX
import jax.numpy as jnp  # noqa: E402

import repro.configs as C  # noqa: E402
from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.core.swis import QuantConfig as JQuantConfig  # noqa: E402
from repro.launch import report as jreport  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.parallel.sharding import Rules as JRules  # noqa: E402
from repro.serve.quantized import pack_placeholders as jpack  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.launch import dryrun, report  # noqa: E402

# the keys of the reference's lower_cell record (and run_cells' mesh_kind)
REFERENCE_KEYS = {
    "arch", "shape", "kind", "mesh", "chips", "quant", "lower_s",
    "compile_s", "memory", "cost_raw_scan", "cost", "cost_per_unit",
    "n_units", "collectives", "collective_counts", "roofline",
    "model_flops_per_chip", "useful_flops_fraction", "n_params",
    "n_active_params"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes"}
COST_KEYS = {"flops", "bytes_accessed", "collective_wire",
             "collective_operand"}
AXES = dict(data=16, model=16)


class FakeMesh:
    def __init__(self, **axes):
        self.shape = dict(axes)


@pytest.fixture(scope="module")
def mesh():
    import torch.distributed as dist

    m = dryrun.production_mesh("single")
    yield m
    dist.destroy_process_group()


def _jax_local_bytes(tree, specs, default_itemsize):
    """Bytes of every leaf's local shard under the reference's specs."""
    if isinstance(tree, dict):
        return sum(_jax_local_bytes(tree[k], specs[k], default_itemsize)
                   for k in tree)
    n = 1
    for dim, entry in zip(tree.shape, tuple(specs) + (None,) * 8):
        names = () if entry is None else (
            (entry,) if isinstance(entry, str) else entry)
        div = math.prod(AXES[a] for a in names)
        assert dim % div == 0
        n *= dim // div
    size = (jnp.dtype(tree.dtype).itemsize if tree.dtype is not None
            else default_itemsize)
    return n * size


def _jax_decode_argument_bytes(jcfg, shape):
    """Params (packed, bf16 elsewhere), the bf16 cache and the tokens of a
    decode step, per device, from the reference's rules and placeholders."""
    rules = JRules.for_arch(FakeMesh(**AXES), jcfg)
    model = JModel(jcfg)
    tree = jpack(model.build(),
                 JQuantConfig(method="swis", n_shifts=4, group_size=4))
    ctree = model.build_cache(shape.global_batch, shape.seq_len, jnp.bfloat16)
    tok = rules.spec_for(("batch", None), (shape.global_batch, 1))
    b_local = shape.global_batch // math.prod(
        AXES[a] for a in ((tok[0],) if isinstance(tok[0], str) else tok[0]))
    return (_jax_local_bytes(tree, rules.param_specs(tree), 2)
            + _jax_local_bytes(ctree, rules.param_specs(ctree), 2)
            + b_local * 4)


def _check_record(rec, mesh):
    assert REFERENCE_KEYS <= set(rec)
    assert set(rec["memory"]) == MEMORY_KEYS
    assert set(rec["cost"]) == COST_KEYS
    assert rec["chips"] == 256 and rec["mesh"] == AXES
    t = rec["roofline"]
    assert t["bottleneck"] in ("compute", "memory", "collective")
    assert t["roofline_bound_s"] >= max(t["compute_s"], t["memory_s"],
                                        t["collective_s"]) - 1e-12
    assert rec["cost"]["flops"] > 0 and rec["compile_s"] == 0.0
    assert set(rec["collectives"]) == set(rec["collective_counts"])
    json.dumps(rec)


def test_smollm_decode_record(mesh):
    """smollm-135m decode_32k on (16, 16): the reference's keys, argument
    bytes exact against the JAX rules, FLOPs per device: model_flops /
    chips plus the split-softmax attention over this rank's 2048 of 32768
    cached positions, 210 SWIS launches (7 a layer)."""
    cfg = TC.get_config("smollm-135m")
    shape = SHAPES["decode_32k"]
    rec = dryrun.lower_cell(cfg, shape, mesh)
    _check_record(rec, mesh)
    want = _jax_decode_argument_bytes(C.get_config("smollm-135m"),
                                      JSHAPES["decode_32k"])
    assert rec["memory"]["argument_bytes"] == want
    # the cache is updated in place: 30 layers of bf16 K/V and int32 pos
    b_l, s_l = 128 // 16, 32768 // 16
    kv = 30 * 2 * b_l * s_l * cfg.n_kv_heads * cfg.head_dim * 2
    assert rec["memory"]["alias_bytes"] == kv + 30 * s_l * 4
    attn = 30 * 2 * 2 * b_l * cfg.n_heads * s_l * cfg.head_dim
    norms = 2 * (2 * 30 + 1) * cfg.d_model * 128 / 256  # no GEMM there
    # the packed attention wo (K 576: 18 plane words) cannot split 16 ways
    # while its shifts can, so it runs whole on every rank
    wo = 30 * 2 * b_l * 576 * 576 * (1 - 1 / 16)
    np.testing.assert_allclose(rec["cost"]["flops"],
                               rec["model_flops_per_chip"] - norms + attn
                               + wo, rtol=1e-9)
    assert rec["kernel_launches"] == {"swis_matmul": 210}
    # linear in depth: 30 equal units and the unembedding
    per_unit = rec["cost_per_unit"]["flops"]
    np.testing.assert_allclose(
        per_unit, (rec["cost"]["flops"] - 2 * b_l * 576 * 49152 / 16) / 30,
        rtol=1e-9)
    # the model axis carries the collectives: every group is of 16 ranks
    assert rec["collective_counts"]["all-reduce"] > 0
    assert rec["cost"]["collective_wire"] > 0


def test_moe_smoke_decode_record(mesh):
    """The qwen2-moe smoke config (8 experts: each expert's hidden units
    split over model) at decode_32k on (16, 16)."""
    cfg = TC.get_smoke("qwen2-moe-a2.7b")
    rec = dryrun.lower_cell(cfg, SHAPES["decode_32k"], mesh)
    _check_record(rec, mesh)
    want = _jax_decode_argument_bytes(C.get_smoke("qwen2-moe-a2.7b"),
                                      JSHAPES["decode_32k"])
    assert rec["memory"]["argument_bytes"] == want
    # per layer: 4 attention GEMMs, the wi and wg expert stacks (the wo
    # stack's K of 48 is not a packable 32-multiple) and 3 shared GEMMs
    assert rec["kernel_launches"] == {"swis_matmul": 9 * cfg.n_layers}


def test_run_cells_skips_and_report_tables(mesh, tmp_path):
    """``run_cells`` writes skipped records where ``shape_applicable``
    says no, and ``report``'s tables on the port's records are the
    reference report's."""
    cells = [("hubert-xlarge", "decode_32k", "single"),
             ("smollm-135m", "long_500k", "single"),
             ("smollm-135m", "decode_32k", "single")]
    out = dryrun.run_cells(cells, str(tmp_path))
    assert [r.get("skipped") is not None for r in out] == [True, True, False]
    assert out[0]["skipped"] == "encoder-only arch has no decode step"
    recs = report.load(str(tmp_path))
    assert recs == jreport.load(str(tmp_path)) and len(recs) == 3
    for kind in ("single", "multi"):
        assert report.roofline_table(recs, kind) == jreport.roofline_table(
            recs, kind)
    assert report.skipped_table(recs) == jreport.skipped_table(recs)
    done = [r for r in recs if "roofline" in r]
    assert report.summary(recs) == jreport.summary(recs) == {
        "cells_compiled": 1, "cells_skipped": 2,
        "bottlenecks": {done[0]["roofline"]["bottleneck"]: 1}}


def test_placements_and_constrain(mesh):
    """A spec over two mesh axes shards one tensor dim on both; constrain
    redistributes a DTensor to the rules' placements."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.parallel.sharding import Rules, placements

    assert placements((("data", "model"), None), mesh) == (Shard(0), Shard(0))
    assert placements((None, "model"), mesh) == (Replicate(), Shard(1))
    rules = Rules.for_arch(mesh, TC.get_config("smollm-135m"))
    x = dryrun.local_dtensor((256, 4096, 576), torch.bfloat16, mesh,
                             (Replicate(), Replicate()))
    y = rules.constrain(x, ("batch", "seq", "embed"))
    assert tuple(y.placements) == (Shard(0), Shard(1))
    assert tuple(y.to_local().shape) == (16, 256, 576)
    assert rules.constrain(y, ("batch", "seq", "embed")) is y
