"""One function per paper table/figure (port of the reference's
``benchmarks/paper_tables.py``). Each returns rows (name, us_per_call,
derived) for the CSV printed by ``repro_torch.benchmarks.run``.

Every function takes ``device`` (the card unless the caller asks for the
CPU); the host-only ones (Figs. 2, 5, 3 and 1, Table 4) accept it and
compute in Python. The trained-model tables (3, 2, 5 and Fig. 6) take
``model``, a ``(cfg, params, eval_acc)`` triple as
:func:`~repro_torch.benchmarks.common.trained_smoke_model` returns; None
trains that model at its defaults on ``device``.

``kernel_bench`` times the plain PyTorch SWIS product
(``kernel/swis_matmul_ref/...``) and, on the card only, the CUDA kernel
(``kernel/swis_matmul_cuda/...``), held against the plain product first
(rtol 1e-5 of the largest |value|). The reference's Pallas interpret row
has no counterpart: on the CPU there is no kernel row, and the plain
version never stands in under the kernel's name.
"""
from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.benchmarks.common import (quant_policy, time_us,
                                           trained_smoke_model)
from repro_torch.models import params as pp
from repro_torch.train.loop import Trainer

Row = Tuple[str, float, str]


def _model(model, device):
    return model if model is not None else trained_smoke_model(device=device)


# ---------------------------------------------------------------------------
# Fig. 2 — P(lossless quantization), Eqs. 8-10
# ---------------------------------------------------------------------------

def fig2_lossless_probability(device="cuda") -> List[Row]:
    from repro_torch.core import probability as P

    rows: List[Row] = []
    us = time_us(lambda: P.lossless_table(), n=10)
    for n in range(1, 9):
        rows.append((f"fig2/swis/N{n}", us, f"{P.p_lossless_swis(n):.6f}"))
        rows.append((f"fig2/swis_c/N{n}", us, f"{P.p_lossless_swis_c(n):.6f}"))
        rows.append((f"fig2/layerwise/N{n}", us,
                     f"{P.p_lossless_layerwise(n):.6f}"))
    return rows


# ---------------------------------------------------------------------------
# Table 1 — RMSE of SWIS / SWIS-C / layer-wise truncation
# ---------------------------------------------------------------------------

def table1_rmse(device="cuda") -> List[Row]:
    from repro_torch.core.swis import QuantConfig, fake_quant, rmse

    dev = _device.resolve(device)
    rows: List[Row] = []
    rng = np.random.default_rng(0)
    # resnet18-conv1-like (K=7*7*3 -> 148 padded; bell-shaped) and
    # mobilenet-pw1-like (K=32; heavier tails) weight matrices
    layers = {
        "resnet_conv": rng.normal(0, 0.05, (148, 64)).astype(np.float32),
        "mobilenet_pw": (rng.standard_t(4, (32, 96)) * 0.04).astype(np.float32),
    }
    for lname, w in layers.items():
        wt = torch.from_numpy(w).to(dev)
        for g in (1, 4):
            for n in (2, 3, 4, 5):
                for m in ("swis", "swis_c", "trunc"):
                    cfg = QuantConfig(method=m, n_shifts=n, group_size=g)

                    def f(cfg=cfg):
                        return rmse(wt, fake_quant(wt, cfg))
                    us = time_us(f, n=1)
                    rows.append((f"table1/{lname}/g{g}/N{n}/{m}", us,
                                 f"{float(f()):.5f}"))
    return rows


# ---------------------------------------------------------------------------
# Fig. 5 — weight storage compression ratios (+ DPRed)
# ---------------------------------------------------------------------------

def fig5_compression(device="cuda") -> List[Row]:
    from repro_torch.core.packing import compression_ratio, dpred_compression

    rows: List[Row] = []
    rng = np.random.default_rng(0)
    mags = np.abs(rng.normal(0, 24, (4096, 64))).clip(0, 255).round()
    for g in (2, 4, 8, 16):
        for n in (2, 3, 4, 5, 6):
            rows.append((f"fig5/swis/g{g}/N{n}", 0.0,
                         f"{compression_ratio(g, n, 'swis'):.3f}"))
            rows.append((f"fig5/swis_c/g{g}/N{n}", 0.0,
                         f"{compression_ratio(g, n, 'swis_c'):.3f}"))
        rows.append((f"fig5/dpred/g{g}", 0.0,
                     f"{dpred_compression(mags, g):.3f}"))
    return rows


# ---------------------------------------------------------------------------
# Fig. 3 — PE area / energy / throughput-per-area
# ---------------------------------------------------------------------------

def fig3_pe(device="cuda") -> List[Row]:
    from repro_torch.perfmodel.pe import PE_LIBRARY

    rows: List[Row] = []
    for name in ("swis_ss", "swis_ds"):
        pe = PE_LIBRARY[name]
        for n in (2, 4, 6):
            e = pe.energy_per_mac_pj(n)
            rows.append((f"fig3/{name}/energy_pj/N{n}", 0.0, f"{e:.4f}"))
            tpa = pe.macs_per_cycle(n) / pe.area_mm2()
            rows.append((f"fig3/{name}/macs_per_cyc_mm2/N{n}", 0.0,
                         f"{tpa:.1f}"))
        rows.append((f"fig3/{name}/area_mm2", 0.0, f"{pe.area_mm2():.5f}"))
    return rows


# ---------------------------------------------------------------------------
# Fig. 1 — DRAM weight/activation access ratio (ResNet-18)
# ---------------------------------------------------------------------------

def fig1_dram_ratio(device="cuda") -> List[Row]:
    from repro_torch.perfmodel.evaluate import fig1_dram_ratio as f1

    rows = []
    for name, ratio in f1():
        rows.append((f"fig1/resnet18/{name}", 0.0, f"{ratio:.2f}"))
    return rows


# ---------------------------------------------------------------------------
# Table 4 — F/J and F/s for all accelerator configs (the paper's 28 nm
# accelerator, modelled)
# ---------------------------------------------------------------------------

def table4_performance(device="cuda") -> List[Row]:
    from repro_torch.perfmodel.evaluate import evaluate_table4, headline_ratios

    rows: List[Row] = []
    t0 = time.perf_counter()
    table = evaluate_table4()
    us = (time.perf_counter() - t0) * 1e6 / max(len(table), 1)
    for r in table:
        key = f"table4/{r['network']}/{r['point']}/{r['config']}/S{r['n_shifts']}"
        rows.append((key + "/fps", us, f"{r['frames_per_s']:.2f}"))
        rows.append((key + "/fpj", us, f"{r['frames_per_j']:.2f}"))
    for k, v in headline_ratios().items():
        rows.append((f"table4/headline/{k}", 0.0, f"{v:.3f}"))
    return rows


# ---------------------------------------------------------------------------
# Table 3 — post-training quantization accuracy (synthetic task; orderings)
# ---------------------------------------------------------------------------

def table3_ptq(device="cuda", model=None) -> List[Row]:
    cfg, params, eval_acc = _model(model, device)
    rows: List[Row] = []
    base = eval_acc(cfg)
    rows.append(("table3/baseline_fp32", 0.0, f"{base:.4f}"))
    for n in (2, 2.5, 3, 4):
        for m, ds in (("swis", False), ("swis", True), ("swis_c", False),
                      ("swis_c", True)):
            qcfg = cfg.replace(quant=quant_policy(m, n, ds=ds))
            t0 = time.perf_counter()
            acc = eval_acc(qcfg)
            us = (time.perf_counter() - t0) * 1e6
            tag = "ds" if ds else "ss"
            rows.append((f"table3/{m}_{tag}/N{n}", us, f"{acc:.4f}"))
        if float(n).is_integer():
            qcfg = cfg.replace(quant=quant_policy("trunc", n))
            rows.append((f"table3/wgt_trunc/N{n}", 0.0,
                         f"{eval_acc(qcfg):.4f}"))
            qcfg = cfg.replace(quant=quant_policy("act_trunc", n))
            rows.append((f"table3/act_trunc/N{n}", 0.0,
                         f"{eval_acc(qcfg):.4f}"))
    return rows


# ---------------------------------------------------------------------------
# Table 2 / §4.3 — filter scheduling benefit
# ---------------------------------------------------------------------------

def table2_scheduling(device="cuda", model=None) -> List[Row]:
    cfg, params, eval_acc = _model(model, device)
    rows: List[Row] = []
    for n in (2, 2.5, 3):
        for ds in (False, True):
            qcfg = cfg.replace(quant=quant_policy("swis", n, ds=ds,
                                                  schedule=True))
            tag = "double" if ds else "single"
            rows.append((f"table2/sched_{tag}/N{n}", 0.0,
                         f"{eval_acc(qcfg):.4f}"))
        if float(n).is_integer():
            qcfg = cfg.replace(quant=quant_policy("swis", n, schedule=False))
            rows.append((f"table2/none/N{n}", 0.0, f"{eval_acc(qcfg):.4f}"))
    w = params["blocks"]["sub0_attn"]["mlp"]["wi"]["w"][0]
    return rows + offline_schedule_rows(w)


def offline_schedule_rows(w: torch.Tensor) -> List[Row]:
    """Table 2's offline rows: the exact §4.3 two-phase scheduler on the
    weight matrix ``w`` (the trained model's first MLP ``wi``), with the
    per-column costs computed on ``w``'s device."""
    from repro_torch.core import scheduling
    from repro_torch.core.swis import QuantConfig, _column_costs, _to_int_domain

    rows: List[Row] = []
    qc = QuantConfig(n_shifts=3, group_size=4)
    mags, signs, _ = _to_int_domain(w.float(), 8, False)

    def cost_fn(n):
        _, c = _column_costs(mags, signs, n, qc)
        return c.cpu().numpy()

    sched25 = scheduling.schedule_layer(cost_fn, 2.5, levels=[1, 2, 3, 4],
                                        sa_cols=8)
    rows.append(("table2/offline/effective_shifts", 0.0,
                 f"{sched25.effective_shifts:.3f}"))
    # iso-budget: scheduled average-3 must never cost more than uniform 3
    sched3 = scheduling.schedule_layer(cost_fn, 3.0, levels=[2, 3, 4],
                                       sa_cols=8)
    uniform3 = float(cost_fn(3).sum())
    rows.append(("table2/offline/cost_sched3_vs_uniform3", 0.0,
                 f"{sched3.total_cost / uniform3:.3f}"))
    # the fractional point sits strictly between its integer neighbours
    uniform2 = float(cost_fn(2).sum())
    rows.append(("table2/offline/cost_sched2.5_vs_uniform2", 0.0,
                 f"{sched25.total_cost / uniform2:.3f}"))
    return rows


# ---------------------------------------------------------------------------
# Table 5 — quantization-aware retraining recovers accuracy
# ---------------------------------------------------------------------------

def table5_retraining(device="cuda", model=None,
                      qat_steps: int = 150) -> List[Row]:
    rows: List[Row] = []
    cfg, params, eval_acc = _model(model, device)
    n = 2
    ptq = cfg.replace(quant=quant_policy("swis", n))
    acc_ptq = eval_acc(ptq)
    rows.append((f"table5/ptq_swis/N{n}", 0.0, f"{acc_ptq:.4f}"))
    # QAT: continue training WITH swis fake-quant in the graph (STE)
    qat_cfg = ptq.replace(quant=ptq.quant.__class__(cfg=ptq.quant.cfg,
                                                    mode="qat"))
    # Table 5 = RETRAINING: warm-start from a COPY of the fp32-trained
    # weights (the trainer updates its state in place; the shared cached
    # params must stay as trained)
    tr = Trainer(qat_cfg, seq_len=64, global_batch=16, total_steps=qat_steps,
                 warmup=10, peak_lr=5e-4,
                 init_params=pp.tree_map(torch.clone, params), device=device)
    t0 = time.perf_counter()
    out = tr.run(qat_steps)
    us = (time.perf_counter() - t0) * 1e6 / qat_steps
    acc_qat = eval_acc(ptq, eval_params=out["state"].params)
    rows.append((f"table5/qat_swis/N{n}", us, f"{acc_qat:.4f}"))
    trunc = cfg.replace(quant=quant_policy("trunc", n))
    rows.append((f"table5/ptq_trunc/N{n}", 0.0, f"{eval_acc(trunc):.4f}"))
    return rows


# ---------------------------------------------------------------------------
# Fig. 6 — accuracy (RMSE proxy + task accuracy) vs group size
# ---------------------------------------------------------------------------

def fig6_groupsize(device="cuda", model=None) -> List[Row]:
    from repro_torch.core.swis import QuantConfig, fake_quant, rmse

    cfg, params, eval_acc = _model(model, device)
    dev = _device.resolve(device)
    rows: List[Row] = []
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.normal(0, 0.04, (256, 128)).astype(
        np.float32)).to(dev)
    for g in (1, 2, 4, 8, 16):
        for n in (2, 3, 4):
            for m in ("swis", "swis_c"):
                q = fake_quant(w, QuantConfig(method=m, n_shifts=n,
                                              group_size=g))
                rows.append((f"fig6/rmse/{m}/g{g}/N{n}", 0.0,
                             f"{float(rmse(w, q)):.5f}"))
    for g in (2, 4, 8):
        qcfg = cfg.replace(quant=quant_policy("swis", 3, group=g))
        rows.append((f"fig6/acc/swis/g{g}/N3", 0.0, f"{eval_acc(qcfg):.4f}"))
    return rows


# ---------------------------------------------------------------------------
# Kernel microbenchmark (the CUDA kernel, on the card, vs the plain version)
# ---------------------------------------------------------------------------

KERNEL_SHAPES = [(64, 512, 256, 4, 3), (128, 1024, 512, 8, 2)]  # M K N g N


def kernel_cases(device="cuda"):
    """``kernel_bench``'s inputs, drawn as the reference draws them: for
    each of :data:`KERNEL_SHAPES`, ``(shape, x, w, pw)`` with ``w`` the
    float32 weight and ``pw`` its SWIS packing, on ``device``."""
    from repro_torch.core import packing, swis

    dev = _device.resolve(device)
    rng = np.random.default_rng(0)
    for (mm, kk, nn, g, ns) in KERNEL_SHAPES:
        w = torch.from_numpy(rng.normal(0, 0.05, (kk, nn)).astype(
            np.float32)).to(dev)
        x = torch.from_numpy(rng.normal(0, 1, (mm, kk)).astype(
            np.float32)).to(dev)
        pw = packing.pack(swis.quantize(w, swis.QuantConfig(
            n_shifts=ns, group_size=g)))
        yield (mm, kk, nn, g, ns), x, w, pw


def plain_swis_matmul(x, pw):
    """``x @ dequant(pw)`` by the plain PyTorch version, on ``x``'s
    device (the product ``ops.swis_matmul`` computes)."""
    from repro_torch.kernels import ref

    scale = pw.scale.reshape(-1).expand(pw.sign_plane.shape[1])
    return ref.swis_matmul_ref(x, pw.sign_plane, pw.mask_planes, pw.shifts,
                               scale, group=pw.group_size,
                               consecutive=pw.method == "swis_c")


def kernel_bench(device="cuda") -> List[Row]:
    from repro_torch.core import swis
    from repro_torch.kernels import ops

    rows: List[Row] = []
    for (mm, kk, nn, g, ns), x, w, pw in kernel_cases(device):
        shape = f"{mm}x{kk}x{nn}/g{g}N{ns}"
        us_ref = time_us(lambda: plain_swis_matmul(x, pw))
        rows.append((f"kernel/swis_matmul_ref/{shape}", us_ref, "torch"))
        if x.is_cuda:
            got, want = ops.swis_matmul(x, pw), plain_swis_matmul(x, pw)
            top = float(want.abs().max())
            if not torch.allclose(got, want, rtol=1e-5, atol=1e-5 * top):
                raise RuntimeError(
                    f"swis_matmul kernel at {shape}: max|err| "
                    f"{float((got - want).abs().max()):.3g} vs max|ref| "
                    f"{top:.3g}")
            us_cuda = time_us(lambda: ops.swis_matmul(x, pw))
            rows.append((f"kernel/swis_matmul_cuda/{shape}", us_cuda, "cuda"))
        us_q = time_us(lambda: swis.fake_quant(
            w, swis.QuantConfig(n_shifts=ns, group_size=g)))
        rows.append((f"kernel/quantize/{kk}x{nn}/g{g}N{ns}", us_q, "ptq"))
    return rows


ALL = [
    fig2_lossless_probability,
    table1_rmse,
    fig5_compression,
    fig3_pe,
    fig1_dram_ratio,
    table4_performance,
    table2_scheduling,
    table3_ptq,
    table5_retraining,
    fig6_groupsize,
    kernel_bench,
]
