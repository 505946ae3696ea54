"""The port's sharding rules, packed placeholders, input specs, parameter
counts and roofline accounting, against the JAX package's in one process
(no process group: the rules read ``FakeMesh.shape``). Specs are tuples in
the port and ``PartitionSpec``s in the reference; they compare entry for
entry."""
import os

import pytest
import torch

pytest.importorskip("jax")  # the card's test environment has no JAX
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as PS  # noqa: E402

import repro.configs as C  # noqa: E402
from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.configs.base import shape_applicable as jshape_applicable  # noqa: E402,E501
from repro.core.swis import QuantConfig as JQuantConfig  # noqa: E402
from repro.launch import roofline as JRL  # noqa: E402
from repro.models import params as jpp  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.parallel.sharding import Rules as JRules  # noqa: E402
from repro.serve.quantized import pack_placeholders as jpack  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.configs.base import SHAPES, shape_applicable  # noqa: E402
from repro_torch.core.swis import QuantConfig  # noqa: E402
from repro_torch.launch import dryrun, mesh as tmesh  # noqa: E402
from repro_torch.launch import roofline as RL  # noqa: E402
from repro_torch.models import params as pp  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.parallel.sharding import DEFAULT_MAPPING, Rules  # noqa: E402
from repro_torch.serve.quantized import pack_placeholders  # noqa: E402


def _jax_active_params(cfg, tree):
    """The reference's ``_active_params``. Its module sets XLA_FLAGS to 512
    host devices when imported; the flag is put back at once, so no later
    JAX backend in this process sees it."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdryrun
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return jdryrun._active_params(cfg, tree)


MESHES = [dict(data=16, model=16), dict(pod=2, data=16, model=16),
          dict(data=2, model=4), dict(data=4, model=2)]
_DTYPES = {jnp.dtype(jnp.uint32): torch.int32, jnp.dtype(jnp.uint8): torch.uint8,
           jnp.dtype(jnp.float32): torch.float32, jnp.dtype(jnp.int32):
           torch.int32, jnp.dtype(jnp.bfloat16): torch.bfloat16}


class FakeMesh:
    """Duck-typed mesh exposing .shape for Rules' divisibility logic."""

    def __init__(self, **axes):
        self.shape = dict(axes)


def _rules(**axes):
    return Rules(mesh=FakeMesh(**axes), mapping=dict(DEFAULT_MAPPING))


def _pairs(jtree, ttree, prefix=()):
    """[(path, JAX leaf, port leaf)] of two congruent trees."""
    if isinstance(ttree, dict):
        assert set(jtree) == set(ttree), (prefix, set(jtree) ^ set(ttree))
        out = []
        for k in ttree:
            out += _pairs(jtree[k], ttree[k], prefix + (k,))
        return out
    return [(prefix, jtree, ttree)]


def _qcfgs():
    return (JQuantConfig(method="swis", n_shifts=4, group_size=4),
            QuantConfig(method="swis", n_shifts=4, group_size=4))


# -- the reference's tests/test_sharding.py cases ------------------------


def test_divisibility_fallback():
    r = _rules(data=16, model=16)
    assert r.spec_for(("embed", "kv_proj"), (12288, 1024)) == (None, "model")
    assert r.spec_for(("batch", "heads", None), (256, 9, 64))[1] is None
    assert r.spec_for(("batch", None), (256, 4096)) == ("data", None)


def test_multipod_batch_sharding():
    r = _rules(pod=2, data=16, model=16)
    assert r.spec_for(("batch", None), (256, 10))[0] == ("pod", "data")
    assert r.spec_for(("batch", None), (1, 10)) == (None, None)


def test_no_axis_reuse_within_spec():
    r = _rules(data=2, model=4)
    spec = r.spec_for(("expert", "embed", "mlp"), (8, 64, 64))
    used = [s for s in spec if s is not None]
    assert used.count("model") <= 1


def test_fsdp_spec_adds_data_axis():
    r = _rules(data=16, model=16)
    tree = {"w": pp.P((1024, 512), ("embed", "mlp"))}
    assert r.param_specs(tree)["w"] == (None, "model")
    assert r.param_specs(tree, fsdp=True)["w"] == ("data", "model")


def test_param_and_spec_trees_congruent():
    r = _rules(data=16, model=16)
    for arch in TC.ARCH_IDS:
        tree = Model(TC.get_config(arch)).build()
        specs = r.param_specs(tree)
        assert [p for p, _, _ in _pairs(specs, tree)] == \
            [p for p, _, _ in _pairs(tree, tree)]


# -- specs of every arch against the reference --------------------------


@pytest.mark.parametrize("arch", list(C.ARCH_IDS))
def test_specs_equal_reference(arch):
    """Dense and packed trees, FSDP on and off, batch specs of every shape,
    on the four meshes: every spec equals the reference's."""
    jq, tq = _qcfgs()
    jtree = JModel(C.get_config(arch)).build()
    ttree = Model(TC.get_config(arch)).build()
    trees = [(jtree, ttree), (jpack(jtree, jq), pack_placeholders(ttree, tq))]
    for axes in MESHES:
        jr = JRules.for_arch(FakeMesh(**axes), C.get_config(arch))
        tr = Rules.for_arch(FakeMesh(**axes), TC.get_config(arch))
        for jt, tt in trees:
            for fsdp in (False, True):
                pairs = _pairs(jr.param_specs(jt, fsdp=fsdp),
                               tr.param_specs(tt, fsdp=fsdp))
                assert pairs
                for path, js, ts in pairs:
                    assert isinstance(js, PS)
                    assert tuple(js) == ts, (axes, fsdp, path, js, ts)
        for name, shape in SHAPES.items():
            jb = JModel(C.get_config(arch)).input_specs(JSHAPES[name])
            tb = Model(TC.get_config(arch)).input_specs(shape)
            tbs = tr.batch_specs(tb)
            for k in jb:
                # the reference's batch_specs wraps this spec in a
                # NamedSharding, which needs a real mesh
                nd = len(jb[k].shape)
                want = jr.spec_for(("batch",) + (None,) * (nd - 1),
                                   jb[k].shape)
                assert tuple(want) == tbs[k], (axes, name, k)


@pytest.mark.parametrize("arch", list(C.ARCH_IDS))
def test_placeholders_specs_counts_equal_reference(arch):
    """pack_placeholders (shapes, axes, dtypes: the port's planes are int32
    where the reference's are uint32), input_specs of every shape,
    count_params, _active_params and model_flops."""
    jq, tq = _qcfgs()
    jcfg, tcfg = C.get_config(arch), TC.get_config(arch)
    jtree, ttree = JModel(jcfg).build(), Model(tcfg).build()
    jpacked, tpacked = jpack(jtree, jq), pack_placeholders(ttree, tq)
    for path, jp, tp in _pairs(jpacked, tpacked):
        assert tp.shape == jp.shape and tp.axes == jp.axes, path
        if jp.dtype is not None:
            assert _DTYPES[jnp.dtype(jp.dtype)] == tp.dtype, path
        else:
            assert tp.dtype is None, path
    # abstract_params: meta tensors with the reference's stand-ins' shapes
    # and dtypes (serving's bf16 default)
    for path, js, ts in _pairs(jpp.abstract_params(jpacked, jnp.bfloat16),
                               pp.abstract_params(tpacked, torch.bfloat16)):
        assert tuple(ts.shape) == tuple(js.shape), path
        assert ts.device.type == "meta", path
        assert _DTYPES[jnp.dtype(js.dtype)] == ts.dtype, path
    assert pp.map_placeholders(lambda p: p.shape, ttree)["embed"]["tok"] == \
        jpp.map_placeholders(lambda p: p.shape, jtree)["embed"]["tok"]
    for name, shape in SHAPES.items():
        jb = JModel(jcfg).input_specs(JSHAPES[name])
        tb = Model(tcfg).input_specs(shape)
        assert set(jb) == set(tb), name
        for k in jb:
            assert tuple(jb[k].shape) == tuple(tb[k].shape), (name, k)
            assert _DTYPES[jnp.dtype(jb[k].dtype)] == tb[k].dtype, (name, k)
            assert tb[k].device.type == "meta"
        assert shape_applicable(tcfg, shape) == jshape_applicable(
            jcfg, JSHAPES[name])
    n = pp.count_params(ttree)
    assert n == jpp.count_params(jtree)
    na = dryrun._active_params(tcfg, ttree)
    assert na == _jax_active_params(jcfg, jtree)
    for kind in ("train", "fwd"):
        assert RL.model_flops(n, na, 4096, kind) == JRL.model_flops(
            n, na, 4096, kind)


# -- roofline accounting ---------------------------------------------------

HLO_SAMPLE = """
  %all-reduce.1 = f32[1024,512]{1,0} all-reduce(%dot.1), channel_id=1, replica_groups={{0,1,2,3},{4,5,6,7}}, use_global_device_ids=true, to_apply=%add
  %all-gather.2 = bf16[64,2048]{1,0} all-gather(%p0), channel_id=2, replica_groups=[32,16]<=[512], dimensions={0}
  %rs = f32[16,16]{1,0} reduce-scatter(%x), channel_id=3, replica_groups={{0,1}}, to_apply=%add
  %cp = f32[8,8]{1,0} collective-permute(%y), channel_id=4, source_target_pairs={{0,1}}
"""
# the same four collectives as the port's tracer records them
RECORDS = [("all-reduce", 1024 * 512 * 4, 4), ("all-gather", 64 * 2048 * 2, 16),
           ("reduce-scatter", 16 * 16 * 4, 2),
           ("collective-permute", 8 * 8 * 4, 2)]


def test_collective_accounting_equals_reference_parser():
    want = JRL.collective_bytes(HLO_SAMPLE)
    got = RL.collective_bytes(RECORDS)
    assert got == want
    assert RL.COLLECTIVES == JRL.COLLECTIVES


def test_group_of_one_moves_nothing():
    got = RL.collective_bytes([("all-reduce", 1024.0, 1),
                               ("all-gather", 64.0, 1)])
    assert got["total"] == 0.0 and got["counts"]["all-reduce"] == 1
    with pytest.raises(ValueError):
        RL.collective_bytes([("broadcast", 1.0, 2)])


def test_roofline_terms_on_h100_constants():
    assert (tmesh.PEAK_FLOPS_BF16, tmesh.HBM_BW, tmesh.LINK_BW) == (
        989e12, 3.35e12, 450e9)
    t = RL.roofline_terms(989e12, 3.35e12 * 2, 450e9 * 0.5)
    assert t["bottleneck"] == "memory"
    assert abs(t["compute_s"] - 1.0) < 1e-9
    assert abs(t["memory_s"] - 2.0) < 1e-9
    assert abs(t["roofline_bound_s"] - 2.0) < 1e-9
    t2 = RL.roofline_terms(989e12 * 3, 3.35e12, 450e9)
    assert t2["bottleneck"] == "compute"
    t3 = RL.roofline_terms(1.0, 1.0, 450e9 * 4)
    assert t3["bottleneck"] == "collective" and t3["compute_fraction"] < 1e-9
