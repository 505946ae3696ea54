"""The port's paper tables (``repro_torch.benchmarks``) that need no
trained model, against the reference's (``benchmarks/paper_tables.py``) on
the CPU (the trained-model tables are in ``test_torch_paper_tables.py``):

- Host-only tables and Table 1: rows equal by name and ``derived`` string.
- ``kernel_bench`` on the CPU: plain rows, no kernel row, and plain
  products equal to the reference's ``ops.swis_matmul(use_pallas=False)``
  (rtol 1e-5 of max|ref|).
- ``run.main``: the filter, ``ERROR`` rows and exit code 1, and no run
  without a card unless ``--device cpu``.
"""
import numpy as np
import pytest
import torch

import torch_port  # noqa: F401  (one torch thread under xdist)
from repro_torch.benchmarks import paper_tables as tpt
from repro_torch.benchmarks import run as trun

pytest.importorskip("jax")  # the card's test environment has no JAX
import jax.numpy as jnp  # noqa: E402
from benchmarks import paper_tables as jpt  # noqa: E402

HOST_TABLES = ["fig2_lossless_probability", "table1_rmse", "fig5_compression",
               "fig3_pe", "fig1_dram_ratio", "table4_performance"]


@pytest.mark.parametrize("name", HOST_TABLES)
def test_host_tables_equal_the_reference(name):
    want = [(r[0], r[2]) for r in getattr(jpt, name)()]
    got = [(r[0], r[2]) for r in getattr(tpt, name)(device="cpu")]
    assert got == want


def test_kernel_bench_on_the_cpu_is_the_plain_version():
    from repro.core import packing, swis
    from repro.kernels import ops

    rows = tpt.kernel_bench(device="cpu")
    assert [(r[0], r[2]) for r in rows] == [
        ("kernel/swis_matmul_ref/64x512x256/g4N3", "torch"),
        ("kernel/quantize/512x256/g4N3", "ptq"),
        ("kernel/swis_matmul_ref/128x1024x512/g8N2", "torch"),
        ("kernel/quantize/1024x512/g8N2", "ptq")]
    rng = np.random.default_rng(0)  # the reference's kernel_bench draws
    for (mm, kk, nn, g, ns), x, w, pw in tpt.kernel_cases("cpu"):
        jw = rng.normal(0, 0.05, (kk, nn)).astype(np.float32)
        jx = rng.normal(0, 1, (mm, kk)).astype(np.float32)
        np.testing.assert_array_equal(w.numpy(), jw)
        np.testing.assert_array_equal(x.numpy(), jx)
        jpw = packing.pack(swis.quantize(jnp.asarray(jw), swis.QuantConfig(
            n_shifts=ns, group_size=g)))
        want = np.asarray(ops.swis_matmul(jnp.asarray(jx), jpw,
                                          use_pallas=False))
        got = tpt.plain_swis_matmul(x, pw).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_run_filters_and_reports_errors(monkeypatch, capsys):
    assert trun.main(["fig5", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived"
    assert len(out) == 45 and all(o.startswith("fig5/") for o in out[1:])

    def table9_broken(device):
        raise ValueError("broken table")

    monkeypatch.setattr(tpt, "ALL", [table9_broken, tpt.fig3_pe])
    assert trun.main(["--device", "cpu"]) == 1
    cap = capsys.readouterr()
    out = cap.out.splitlines()
    assert out[1] == "table9_broken,0.0,ERROR"
    assert len(out) == 16 and all(o.startswith("fig3/") for o in out[2:])
    assert "ValueError: broken table" in cap.err


def test_run_needs_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trun.main(["fig2"])
