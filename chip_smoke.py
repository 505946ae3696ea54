#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (Hopper: the kernels are built for sm_90a) and ``nvcc``.
Phases, each fatal on failure (exit code 1, and no result line):

1. device: the card's name and power limit; TF32 off for plain float32
   products.
2. build: ``nvcc`` for every kernel source, all started together; build
   seconds and the ``-Xptxas -v`` register and shared-memory lines.
3. kernels against their plain PyTorch versions on the card, at the
   slice's shapes and the reference's test sweep, and each run twice on
   the same inputs for bit-identical outputs; then each kernel's time at
   the decode shapes beside its bound, the plain version's time and a
   library call's time (a yardstick only: the port never calls it), and
   on lines of their own the SWIS kernel at the prefill row count (M =
   256) and paged attention over 128 logical blocks.
4. the slice at full width: SWIS-packed smollm-135m (random weights from a
   seed) serves 8 requests through ``ContinuousBatchingEngine``, with the
   kernels' launch counts checked against the model calls made, a prefix
   hit, and greedy tokens equal to the port's CPU path on the same packed
   weights.

The line before the last is one JSON object ``{"kernels": [...]}``; the
last is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
FP32_FLOPS_PER_S = 67e12  # H100 SXM float32 peak outside the tensor cores
N_SHIFTS, GROUP = 4, 4
# tests/test_kernels.py SWEEP: (M, K, N, group, n_shifts, x dtype name)
KERNEL_SWEEP = [(8, 128, 128, 4, 2, "float32"), (16, 256, 256, 8, 3, "float32"),
                (32, 512, 128, 4, 4, "float32"), (8, 64, 256, 16, 5, "float32"),
                (8, 128, 128, 4, 3, "bfloat16"), (4, 96, 128, 4, 3, "float32")]
# one smollm-135m layer's GEMMs (K, N): wq, wk, wv, wo, mlp wi, wg, wo
LAYER_GEMMS = [(576, 576), (576, 192), (576, 192), (576, 576), (576, 1536),
               (576, 1536), (1536, 576)]


TIMING_SOURCE = set()  # which clock cuda_ms read: "profiler" and/or "events"


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters=100, warmup=10):
    """Mean time of one ``fn()`` in ms after a warm-up: the device time of
    the kernels it launches, summed from a ``torch.profiler`` trace of
    ``iters`` calls. Where the trace shows no device time, the CUDA-event
    time of ``iters`` back-to-back calls (which includes any gap the host
    leaves between launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(end) / iters
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        us += getattr(e, "self_device_time_total",
                      getattr(e, "self_cuda_time_total", 0.0))
    TIMING_SOURCE.add("profiler" if us > 0 else "events")
    return us / 1e3 / iters if us > 0 else event_ms


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 3: SWIS matmul ----------------------------------------------------


def packed_weight(k, n, group, n_shifts, method, seed, dev):
    import torch
    from repro_torch.core import packing, swis

    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn((k, n), generator=g, device=dev) * 0.05
    return packing.pack(swis.quantize(w, swis.QuantConfig(
        method=method, n_shifts=n_shifts, group_size=group)))


def swis_phase(dev):
    import torch
    from repro_torch.kernels import ops, ref

    cases = []  # (M, K, N, group, n_shifts, dtype, method, keeps)
    for m in (4, 64):
        for k, n in sorted(set(LAYER_GEMMS)):
            for dt in ("float32", "bfloat16"):
                cases.append((m, k, n, GROUP, N_SHIFTS, dt, "swis", (None,)))
    cases += [(m, k, n, g, s, dt, "swis", (None,))
              for m, k, n, g, s, dt in KERNEL_SWEEP]
    cases.append((37, 1536, 576, GROUP, N_SHIFTS, "float32", "swis", (None,)))
    keeps = (None,) + tuple(range(1, N_SHIFTS + 1))
    cases.append((37, 576, 1536, GROUP, N_SHIFTS, "float32", "swis", keeps))
    cases.append((37, 576, 1536, GROUP, N_SHIFTS, "float32", "swis_c", keeps))
    cases.append((8, 128, 128, 4, 3, "bfloat16", "swis_c", keeps[:4]))

    errs = {"float32": 0.0, "bfloat16": 0.0}
    packed = {}
    for i, (m, k, n, group, n_shifts, dt, method, keep_list) in enumerate(cases):
        key = (k, n, group, n_shifts, method)
        if key not in packed:
            packed[key] = packed_weight(k, n, group, n_shifts, method,
                                        len(packed), dev)
        pw = packed[key]
        gx = torch.Generator(device=dev).manual_seed(100 + i)
        x = torch.randn((m, k), generator=gx, device=dev).to(getattr(torch, dt))
        tol = 1e-5 if dt == "float32" else 2e-2
        for keep in keep_list:
            got = ops.swis_matmul(x, pw, keep_slices=keep)
            want = ref.swis_matmul_ref(
                x, pw.sign_plane, pw.mask_planes, pw.shifts,
                pw.scale.reshape(-1).expand(n), group=group,
                consecutive=method == "swis_c", keep_slices=keep)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            ok = torch.allclose(got, want, rtol=tol, atol=tol * scale)
            errs[dt] = max(errs[dt], err)
            check(ok, f"swis_matmul M={m} K={k} N={n} group={group} "
                      f"n_shifts={n_shifts} {dt} {method} keep={keep}: "
                      f"max|err|={err:.3g} vs max|ref|={scale:.3g}")
    print(f"swis_matmul: {len(cases)} shape cases against the plain version "
          f"on the card; max|err| fp32 {errs['float32']:.3g} (rtol 1e-5, "
          f"atol 1e-5*max|ref|), bf16 {errs['bfloat16']:.3g} (2e-2)")

    # the same inputs twice through the kernel give the same bits
    for m, (k, n) in ((4, LAYER_GEMMS[6]), (256, LAYER_GEMMS[4])):
        pw = packed[(k, n, GROUP, N_SHIFTS, "swis")]
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn((m, k), device=dev).to(dt)
            check(torch.equal(ops.swis_matmul(x, pw), ops.swis_matmul(x, pw)),
                  f"swis_matmul M={m} K={k} N={n} {dt}: repeat run differs")
    print("swis_matmul: repeat runs bit-identical (M 4 and 256, fp32 and bf16)")

    perf = swis_layer_timing(dev, 4)
    perf["max_abs_err"] = errs["float32"]
    perf["timed"] = ("one smollm-135m decode layer: 7 GEMMs at M=4 "
                     "(sum of per-GEMM means), fp32 x, 4 planes, group 4")
    return perf


def swis_layer_timing(dev, m):
    """One smollm-135m layer's 7 GEMMs at ``m`` rows of fp32 x: the kernel,
    the plain version and ``torch.matmul`` on the dense fp32 weight (sums
    of per-GEMM means), and the bound."""
    import torch
    from repro_torch.core.packing import PackedWeight
    from repro_torch.kernels import ops, ref

    ms = plain_ms = lib_ms = bound_ms = 0.0
    by = set()
    per_gemm = []  # "KxN kernel/torch.matmul" in us
    for i, (k, n) in enumerate(LAYER_GEMMS):
        pw = packed_weight(k, n, GROUP, N_SHIFTS, "swis", 50 + i, dev)
        scale = pw.scale.reshape(-1).expand(n).contiguous()
        pwn = PackedWeight(pw.sign_plane, pw.mask_planes, pw.shifts, scale,
                           GROUP, N_SHIFTS, k, n)
        x = torch.randn((m, k), device=dev)
        w = ref.dequant_ref(pw.sign_plane, pw.mask_planes, pw.shifts, scale,
                            group=GROUP)
        t = cuda_ms(lambda: ops.swis_matmul(x, pwn))
        plain_ms += cuda_ms(lambda: ref.swis_matmul_ref(
            x, pw.sign_plane, pw.mask_planes, pw.shifts, scale, group=GROUP),
            iters=20)
        t_lib = cuda_ms(lambda: torch.matmul(x, w))
        ms += t
        lib_ms += t_lib
        per_gemm.append(f"{k}x{n} {t * 1e3:.2f}/{t_lib * 1e3:.2f}")
        nbytes = (x.numel() * 4 + pw.sign_plane.numel() * 4
                  + pw.mask_planes.numel() * 4 + pw.shifts.numel()
                  + scale.numel() * 4 + m * n * 4)
        b, which = bound(nbytes, 2 * m * k * n)
        bound_ms += b
        by.add(which)
    print(f"  swis_matmul per GEMM at M={m}, KxN kernel/torch.matmul us: "
          + ", ".join(per_gemm))
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if by == {"bytes"} else "operations"}


# -- phase 3: paged attention ------------------------------------------------


def arena(dev, *, b=4, hkv=3, g=3, dh=64, bs=8, nb=16, n_blocks=97, sq=1,
          live=(12, 9, 5, 1), seed=0, all_trash=False):
    """Random arena with the engine's invariants: trash block 0 with garbage
    positions, trash-padded table tails, a partly filled last live block.
    Row r holds ``live[r]`` blocks (0 = all trash)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (b, sq, hkv * g, dh)).astype(np.float32)
    k = rng.normal(0, 1, (n_blocks, bs, hkv, dh)).astype(np.float32)
    v = rng.normal(0, 1, (n_blocks, bs, hkv, dh)).astype(np.float32)
    pos = np.full((n_blocks, bs), -1, np.int32)
    pos[0] = rng.integers(0, bs, (bs,))
    tables = np.zeros((b, nb), np.int32)
    q_pos = np.zeros((b,), np.int32)
    free = list(rng.permutation(np.arange(1, n_blocks)))
    for r in range(b):
        n_live = 0 if all_trash else live[r % len(live)]
        if n_live == 0:
            q_pos[r] = 3
            continue
        n_tok = (n_live - 1) * bs + int(rng.integers(1, bs + 1))
        for j in range(n_live):
            blk = int(free.pop())
            tables[r, j] = blk
            filled = min(bs, n_tok - j * bs)
            pos[blk, :filled] = np.arange(j * bs, j * bs + filled)
        q_pos[r] = max(n_tok - sq, 0)
    return [torch.from_numpy(a).to(dev) for a in (q, k, v, pos, tables, q_pos)]


def plain_paged(q, k, v, pos, tables, q_pos, q_lens, window):
    """The plain version on the card, with the decode wrapper's head
    folding: q (B, S, H, Dh) -> (B, S, H, Dh) float32."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import mask_value

    b, s, h, dh = q.shape
    hkv = k.shape[2]
    g = h // hkv
    if q_lens is None:
        q_lens = torch.full((b,), s, dtype=torch.int32, device=q.device)
    q4 = q.reshape(b, s, hkv, g, dh).permute(0, 2, 1, 3, 4).reshape(
        b, hkv, s * g, dh)
    out = ref.paged_attention_ref(q4, k, v, pos, tables, q_pos, q_lens, sq=s,
                                  causal=True, window=window,
                                  neg=mask_value(torch.float32))
    return out.reshape(b, hkv, s, g, dh).permute(0, 2, 1, 3, 4).reshape(
        b, s, h, dh)


def paged_phase(dev):
    import torch
    from repro_torch.kernels.paged_attention import paged_attention_decode

    cases = [  # (label, arena kwargs, q_lens, window)
        ("decode Sq=1", {}, None, None),
        ("Sq=4, q_lens with 0", {"sq": 4}, [4, 0, 2, 1], None),
        ("window 12", {}, None, 12),
        ("Sq=4, window 6", {"sq": 4}, [1, 4, 0, 3], 6),
        ("all-trash tables", {"all_trash": True}, None, None),
        ("a trash row", {"live": (12, 0, 3, 7)}, None, None),
    ]
    err_max = 0.0
    for label, kw, q_lens, window in cases:
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            q, k, v, pos, tables, q_pos = arena(dev, **kw)
            ql = None if q_lens is None else torch.tensor(
                q_lens, dtype=torch.int32, device=dev)
            got = paged_attention_decode(q, k.to(dt), v.to(dt), pos, tables,
                                         q_pos, q_lens=ql, window=window)
            again = paged_attention_decode(q, k.to(dt), v.to(dt), pos, tables,
                                           q_pos, q_lens=ql, window=window)
            check(torch.equal(got, again),
                  f"paged_attention {label} {dt}: repeat run differs")
            want = plain_paged(q, k.to(dt), v.to(dt), pos, tables, q_pos, ql,
                               window)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), f"paged {label} {dt}: non-finite")
            err = (got - want).abs().max().item()
            err_max = max(err_max, err)
            check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
                  f"paged_attention {label} {dt}: max|err|={err:.3g} (1e-5)")
    print(f"paged_attention: {len(cases)} cases x 3 cache dtypes against the "
          f"plain version, all rows compared; max|err| {err_max:.3g} "
          f"(rtol = atol = 1e-5); repeat runs bit-identical")

    perf = paged_timing(dev, nb=16, n_blocks=97, live=(12, 12, 11, 12))
    perf["max_abs_err"] = err_max
    perf["timed"] = ("one decode launch: B=4, H=9 over Hkv=3, Dh=64, "
                     "block_size 8, 16 logical blocks, fp32 cache")
    return perf


def paged_timing(dev, *, nb, n_blocks, live):
    """One decode launch (B 4, 9 heads over 3 KV heads, Dh 64, block size
    8, fp32 cache, ``nb`` logical blocks with ``live`` of them filled per
    row): the kernel, the plain version, one SDPA call over the gathered
    K/V, and the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import mask_value, paged_attention

    q, k, v, pos, tables, q_pos = arena(dev, nb=nb, n_blocks=n_blocks,
                                        live=live, seed=9)
    b, _, h, dh = q.shape
    hkv, g = 3, 3
    q4 = q.reshape(b, 1, hkv, g, dh).permute(0, 2, 1, 3, 4).reshape(
        b, hkv, g, dh).contiguous()
    ql = torch.ones(b, dtype=torch.int32, device=dev)
    kern = lambda: paged_attention(q4, k, v, pos, tables, q_pos, ql, sq=1,  # noqa: E731
                                   causal=True, window=None)
    plain = lambda: ref.paged_attention_ref(  # noqa: E731
        q4, k, v, pos, tables, q_pos, ql, sq=1, causal=True, window=None,
        neg=mask_value(torch.float32))
    ms = cuda_ms(kern)
    plain_ms = cuda_ms(plain, iters=20 if nb <= 16 else 3, warmup=2)
    # yardstick: one SDPA call over the gathered, head-expanded K/V
    tl = tables.long()
    bs = k.shape[1]
    gk = k[tl].reshape(b, nb * bs, hkv, dh).repeat_interleave(g, 2).transpose(1, 2)
    gv = v[tl].reshape(b, nb * bs, hkv, dh).repeat_interleave(g, 2).transpose(1, 2)
    gp = torch.where((tl == 0)[:, :, None], -1, pos[tl]).reshape(b, nb * bs)
    mask = ((gp >= 0) & (gp <= q_pos[:, None]))[:, None, None, :]
    qs = q.transpose(1, 2).contiguous()
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qs, gk, gv,
                                                            attn_mask=mask))
    live_blocks = torch.unique(tl[tl != 0]).numel()
    n_valid = int(mask.sum().item())
    nbytes = (q.numel() * 4 + 2 * live_blocks * bs * hkv * dh * 4
              + live_blocks * bs * 4 + tables.numel() * 4 + 2 * b * 4
              + q.numel() * 4)
    bound_ms, by = bound(nbytes, 4 * n_valid * h * dh)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": by}


def extra_timings(dev, card):
    """The shapes beside the kernels line: SWIS at the prefill row count
    and paged attention over a long context, each on its own line."""
    p = swis_layer_timing(dev, 256)
    print(f"swis_matmul prefill layer (7 GEMMs at M=256, fp32 x) on {card}: "
          f"kernel {p['ms']:.4f} ms, torch.matmul {p['library_ms']:.4f} ms, "
          f"plain {p['plain_ms']:.4f} ms, bound {p['bound_ms']:.5f} ms "
          f"({p['bound_by']})")
    p = paged_timing(dev, nb=128, n_blocks=505,
                     live=(125, 125, 124, 125))
    print(f"paged_attention long context (B=4, 128 logical blocks, ~1000 "
          f"tokens a row, fp32 cache) on {card}: kernel {p['ms']:.4f} ms, "
          f"SDPA {p['library_ms']:.4f} ms, plain {p['plain_ms']:.4f} ms, "
          f"bound {p['bound_ms']:.6f} ms ({p['bound_by']})")


# -- phase 4: the slice at full width ------------------------------------------


def prompts(vocab, seed=0):
    import numpy as np

    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, 32)
    out = []
    for r in range(8):
        p = rng.integers(0, vocab, 64).astype(np.int32)
        if r in (0, 4, 5, 6):  # requests 4-6 hit request 0's committed prefix
            p[:32] = shared
        out.append(p)
    return out


def serve(engine, reqs, n_tokens):
    """Submit every request, step to idle; per-step wall times split into
    steps that prefilled and decode-only steps."""
    import torch
    from repro_torch.serve import SamplingParams
    from repro_torch.serve.scheduler import DECODING

    rids = [engine.submit(p, SamplingParams(max_tokens=n_tokens)) for p in reqs]
    out, pre, dec = {}, [], []
    while engine.scheduler.pending():
        live = sum(st is not None and st.phase == DECODING
                   for st in engine.scheduler.slots)
        n_pre = engine.n_prefill_calls
        t0 = time.perf_counter()
        finished = engine.step()
        if engine.device.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if engine.n_prefill_calls > n_pre:
            pre.append(dt)
        else:
            dec.append((dt, live))
        out.update({f.rid: f.tokens for f in finished})
    return [out[r] for r in rids], pre, dec


def top2(model, params, seq, dev):
    import torch

    logits, _, _ = model.apply(params, {"tokens": torch.as_tensor(
        seq, device=dev).long()[None]})
    v, i = logits[0, -1].float().topk(2)
    return [(int(a), round(float(b), 6)) for a, b in zip(i.tolist(), v.tolist())]


def breakdown(engine, reqs, n_steps=8):
    """Where a decode step's time goes: wall time of ``n_steps`` decode-only
    steps next to the device time of the kernels they ran, by kernel, from
    a ``torch.profiler`` trace of the card alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import SamplingParams

    engine.reset()
    for p in reqs:
        engine.submit(p, SamplingParams(max_tokens=n_steps + 4))
    engine.step()  # admission + prefill + the first decode
    engine.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            engine.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n_steps * 1e3
    by = {"swis_matmul": 0.0, "paged_attention": 0.0, "other": 0.0}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        key = next((k for k in by if k in e.key), "other")
        by[key] += us / 1e3 / n_steps
    busy = sum(by.values())
    print(f"decode step breakdown ({len(reqs)} live slots, {n_steps} steps "
          f"under the profiler): wall {wall:.2f} ms/step, device busy "
          f"{busy:.3f} ms/step (swis_matmul {by['swis_matmul']:.3f}, "
          f"paged_attention {by['paged_attention']:.3f}, other torch "
          f"{by['other']:.3f}); device idle share {1 - busy / wall:.3f}")
    engine.drain()


def slice_phase(dev, card, kernels):
    import torch
    from repro_torch import configs
    from repro_torch.core.swis import QuantConfig
    from repro_torch.models import params as pp
    from repro_torch.models.model import Model
    from repro_torch.serve import ContinuousBatchingEngine, EngineConfig

    cfg = configs.get_config("smollm-135m").replace(compute_dtype="float32")
    params = pp.init_params(Model(cfg).build(),
                            torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    ecfg = EngineConfig(n_slots=4, block_size=8, packed=True,
                        use_paged_kernel=True, max_len=128,
                        quant_cfg=QuantConfig(method="swis", n_shifts=N_SHIFTS,
                                              group_size=GROUP))
    t0 = time.perf_counter()
    gpu = ContinuousBatchingEngine(cfg, params, ecfg, device=dev)
    torch.cuda.synchronize()
    print(f"pack: {gpu.pack_stats['n_packed']} stacked GEMM leaves "
          f"({cfg.n_layers} layers each) packed on the card in "
          f"{time.perf_counter() - t0:.1f} s, compression "
          f"{gpu.pack_stats['compression']:.3f}x vs int8")
    del params
    reqs = prompts(cfg.vocab)

    for kern in kernels:  # count only the main path's launches
        kern.launches = 0
    toks_gpu, pre, dec = serve(gpu, reqs, 32)
    counts = {kern.name: kern.launches for kern in kernels}
    calls = gpu.n_prefill_calls + gpu.n_decode_steps
    per_call = 7 * cfg.n_layers
    print(f"main path: {gpu.n_prefill_calls} prefill calls, "
          f"{gpu.n_decode_steps} decode steps; launches {counts}")
    check(counts["swis_matmul"] == per_call * calls,
          f"swis_matmul launches {counts['swis_matmul']} != {per_call} x {calls}")
    check(counts["paged_attention"] == cfg.n_layers * gpu.n_decode_steps,
          f"paged_attention launches {counts['paged_attention']} != "
          f"{cfg.n_layers} x {gpu.n_decode_steps}")
    stats = gpu.prefix_stats()
    print(f"prefix cache: {stats['hits']} hits of {stats['lookups']} lookups, "
          f"{stats['saved_tokens']} prompt tokens reused")
    check(stats["hits"] >= 1, "no admission hit the prefix cache")
    for t in toks_gpu:
        check(len(t) == 32 and int(t.min()) >= 0 and int(t.max()) < cfg.vocab,
              f"bad token output {t}")
    pre_ms = 1e3 * sum(pre) / len(pre)
    dec_ms = 1e3 * sum(d for d, _ in dec) / len(dec)
    dec_tps = sum(n for _, n in dec) / sum(d for d, _ in dec)
    pre_tps = len(reqs) * 64 / sum(pre)
    print(f"serve on {card}: prefill steps {len(pre)} at {pre_ms:.1f} ms/step "
          f"({pre_tps:.0f} prompt tokens/s, each step also decodes); "
          f"decode-only steps {len(dec)} at {dec_ms:.2f} ms/step "
          f"({dec_tps:.0f} tokens/s over the live slots)")

    breakdown(gpu, reqs[:4])

    # the same requests on the same packed weights, through the CPU path
    t0 = time.perf_counter()
    cpu_params = pp.tree_map(lambda t: t.cpu(), gpu.params)
    cpu = ContinuousBatchingEngine(cfg, cpu_params, ecfg, device="cpu")
    toks_cpu, _, _ = serve(cpu, reqs, 32)
    print(f"cpu plain path served the same requests in "
          f"{time.perf_counter() - t0:.1f} s")
    for r, (a, b) in enumerate(zip(toks_gpu, toks_cpu)):
        if (a != b).any():
            step = int((a != b).argmax())
            seq = list(reqs[r]) + [int(t) for t in a[:step]]
            print(f"MISMATCH request {r} step {step}: gpu {a[step]} cpu {b[step]}; "
                  f"top-2 gpu {top2(gpu.model, gpu.params, seq, dev)} "
                  f"cpu {top2(cpu.model, cpu_params, seq, 'cpu')}")
            raise PhaseError(f"greedy tokens differ from the CPU path "
                             f"(request {r}, step {step})")
    print("greedy tokens: 8/8 requests identical to the CPU plain path")
    return counts


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} is missing; run "
              f"from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build, paged_attention, swis_matmul

    t_start = time.perf_counter()
    try:
        # 1. device
        card = card_line()
        print(card)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device("cuda")
        kernels = [swis_matmul.KERNEL, paged_attention.KERNEL]

        # 2. build
        t0 = time.perf_counter()
        build.build(kernels)
        print(f"build: {time.perf_counter() - t0:.1f} s wall")
        for kern in kernels:
            secs = ("cached" if kern.build_seconds is None
                    else f"{kern.build_seconds:.1f} s")
            print(f"  {kern.name} ({secs}):")
            for line in kern.build_log.splitlines():
                if "registers" in line or "smem" in line or "spill" in line:
                    print(f"    {line.strip()}")

        # 3. kernels against their plain versions, then timing
        perf = {"swis_matmul": swis_phase(dev), "paged_attention": paged_phase(dev)}
        extra_timings(dev, card)

        # 4. the slice at full width
        counts = slice_phase(dev, card, kernels)
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    meta = {
        "swis_matmul": ("src/repro_torch/csrc/swis_matmul.cu",
                        "src/repro/kernels/swis_matmul.py:100"),
        "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                            "src/repro/kernels/paged_attention.py:141"),
    }
    rows = []
    for name, (source, replaces) in meta.items():
        p = perf[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": counts[name],
                     "max_abs_err": p["max_abs_err"], "ms": p["ms"],
                     "plain_ms": p["plain_ms"], "bound_ms": p["bound_ms"],
                     "bound_by": p["bound_by"], "library_ms": p["library_ms"],
                     "timed": p["timed"]})
    print(f"kernel times from: {sorted(TIMING_SOURCE)}; "
          f"total {time.perf_counter() - t_start:.1f} s on {card}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
