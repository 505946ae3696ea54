"""Port parity: the SWIS matmul's plain PyTorch version (what the port's
wrapper runs on CPU tensors) against the JAX oracle
``repro.kernels.ref.swis_matmul_ref`` and the Pallas kernel in interpret
mode, on the same packed planes, over the ``tests/test_kernels.py`` sweep
with its tolerances; plus SWIS-C, ``keep_slices``, higher-rank inputs, the
autograd backward against JAX's custom VJP, and the argument checks."""
import numpy as np
import pytest
import torch

from repro_torch.bridge import from_jax_params
from repro_torch.core.packing import PackedWeight
from repro_torch.kernels import ops, ref
from repro_torch.kernels import swis_matmul as tsm

pytest.importorskip("jax")  # the card's test environment has no JAX
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.core import packing as jpacking  # noqa: E402
from repro.core import swis as jswis  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from test_kernels import SWEEP  # noqa: E402

def _packed(k, n, group, n_shifts, method="swis", seed=0):
    w = np.random.default_rng(seed).normal(0, 0.05, (k, n)).astype(np.float32)
    qw = jswis.quantize(jnp.asarray(w), jswis.QuantConfig(
        method=method, n_shifts=n_shifts, group_size=group))
    jpw = jpacking.pack(qw)
    t = from_jax_params({k_: np.asarray(v) for k_, v in jpw.tree().items()},
                        device="cpu")
    tpw = PackedWeight(t["sign_plane"], t["mask_planes"], t["shifts"],
                       t["scale"].reshape(1, -1), group, jpw.n_shifts, k, n,
                       method)
    return jpw, tpw


def _x(shape, dtype, seed=1):
    x = np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    return jnp.asarray(x, dtype), torch.from_numpy(x).to(tdt)


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=tol,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("m,k,n,group,n_shifts,dtype", SWEEP)
def test_plain_matches_oracle_and_pallas(m, k, n, group, n_shifts, dtype):
    jpw, tpw = _packed(k, n, group, n_shifts)
    jx, tx = _x((m, k), dtype)
    tol = 2e-2 if dtype == jnp.bfloat16 else 1e-5
    got = ops.swis_matmul(tx, tpw)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    want = jref.swis_matmul_ref(jx, jpw.sign_plane, jpw.mask_planes,
                                jpw.shifts, jpw.scale, group=group)
    _close(got.numpy(), want, tol)
    pallas = jops.swis_matmul(jx, jpw, use_pallas=True, interpret=True)
    _close(got.numpy(), pallas, tol)


@pytest.mark.parametrize("n_shifts", [2, 3])
def test_swis_c_and_keep_slices(n_shifts):
    for method in ("swis", "swis_c"):
        jpw, tpw = _packed(128, 128, 4, n_shifts, method)
        jx, tx = _x((8, 128), jnp.float32)
        for keep in (None,) + tuple(range(1, n_shifts + 1)):
            got = ops.swis_matmul(tx, tpw, keep_slices=keep).numpy()
            want = jref.swis_matmul_ref(
                jx, jpw.sign_plane, jpw.mask_planes, jpw.shifts, jpw.scale,
                group=4, consecutive=method == "swis_c", keep_slices=keep)
            _close(got, want, 1e-5)
        pallas = jops.swis_matmul(jx, jpw, use_pallas=True, interpret=True,
                                  keep_slices=1)
        _close(ops.swis_matmul(tx, tpw, keep_slices=1).numpy(), pallas, 1e-5)


def test_higher_rank_input_and_backward():
    jpw, tpw = _packed(128, 64, 4, 3)
    jx, tx = _x((2, 5, 128), jnp.float32)
    y = ops.swis_matmul(tx, tpw)
    assert y.shape == (2, 5, 64)
    _close(y.numpy(), jops.swis_matmul(jx, jpw), 1e-5)
    for keep in (None, 2):
        txg = tx.clone().requires_grad_(True)
        (ops.swis_matmul(txg, tpw, keep_slices=keep) ** 2).sum().backward()
        want = jax.grad(lambda xx: (jops.swis_matmul(
            xx, jpw, keep_slices=keep) ** 2).sum())(jx)
        _close(txg.grad.numpy(), want, 1e-4)


def test_argument_errors():
    _, tpw = _packed(128, 64, 4, 3)
    x = torch.ones(4, 128)
    for keep in (0, 4):
        with pytest.raises(ValueError, match="keep_slices"):
            ops.swis_matmul(x, tpw, keep_slices=keep)
        with pytest.raises(ValueError, match="keep_slices"):
            ref.dequant_ref(tpw.sign_plane, tpw.mask_planes, tpw.shifts,
                            tpw.scale, group=4, keep_slices=keep)
    with pytest.raises(ValueError, match="multiple of 32"):
        tsm.swis_matmul_packed(torch.ones(4, 96), tpw.sign_plane,
                               tpw.mask_planes, tpw.shifts, tpw.scale,
                               n_shifts=3, group=4)
    with pytest.raises(ValueError, match="multiple of the group"):
        tsm.swis_matmul_packed(x, tpw.sign_plane, tpw.mask_planes,
                               tpw.shifts, tpw.scale, n_shifts=3, group=3)
