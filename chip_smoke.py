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
   the same inputs for bit-identical outputs (SWIS at M = 4 also with the
   drafts' ``keep_slices=2``); then each kernel's time at
   the decode shapes beside its bound, the plain version's time and a
   library call's time (a yardstick only: the port never calls it), and
   on lines of their own the SWIS kernel at the prefill row count (M =
   256) and with drafts' ``keep_slices=2``, and paged attention over 128
   logical blocks and at the fused mixed step's Sq 32 and 64. Paged
   attention is also held against its plain version at 16 to 128 queries
   a row (up to 384 query rows). Both kernels are also held against their
   plain versions, and timed, at the published shapes of phi3-mini-3.8b
   and deepseek-7b: one layer's GEMMs at M = 4, and paged attention at Dh
   96 and 128 with one query head per KV head.
4. the first slice at full width: SWIS-packed smollm-135m (random weights
   from a seed) serves 8 requests through ``ContinuousBatchingEngine``,
   with the kernels' launch counts checked against the model calls made, a
   prefix hit, and greedy tokens, at a 4-layer cut of the same packed
   weights, equal on the card and on the port's CPU path.
5. the rest of the serve engine at full width, at the first 10 of the 30
   layers of phase 4's packed weights: (a) chunked
   prefill of two 448-token prompts beside four short ones, (b) the same
   traffic through the fused mixed step, (c) speculative decode with
   2-plane drafts, (d) seeded sampling at temperature 0.8, (e) the
   contiguous cache mode and ``DecodeEngine``. Each path's launches are
   counted from 0 and checked against its engine's dispatch counters; its
   tokens equal the plain decode path's on the card ((a)-(c)), a profiled
   repeat run's, and, at a 4-layer cut of the weights, the CPU plain
   path's (for (c), the proposed and accepted draft counts too). Each path
   prints its wall and device-busy time per step. In phases 4 and 5 the
   metrics registry's ``step.model_dispatches`` (and ``spec.*``) must
   equal the engine's own counters.
6. observability and the launcher at full width: ``repro_torch.launch.
   serve.run`` serves 8 requests of 64 prompt tokens, 32 tokens each, on 4
   slots with packed weights, continuous (with a Chrome trace, checked for
   nested step spans and one track per request, and a report with TTFT,
   TPOT and cost totals) and static, each with launches equal to 210 x the
   model dispatches; the phase-4 traffic runs with metrics off and on in
   turns (wall ms per step both ways, the p50 and p95 of every step phase,
   TTFT and TPOT), and at a 4-layer cut the card's counters, ``cost.*``
   values, scheduler gauges and prefix stats equal the CPU plain path's.
7. the MoE family at full width, once phases 4-6's tensors are freed:
   qwen2-moe-a2.7b (60 experts top-4 padded to 64, 4 shared) at the first
   9 of its 24 layers is (a) drawn and packed one layer at a time
   (seconds, packed GB, peak memory under the float32 tree's size); (b)
   the SWIS kernel's expert-axis launch is held against its plain version
   on layer 0's expert stacks at the decode shapes (rows shared by every
   expert, and each expert's own) and a capacity-path shape, rtol 1e-5,
   and one decode layer's 3 launches are timed beside their bound, the
   plain version and ``torch.bmm`` over the dequantized stack, as is the
   paged decode launch at qwen2-moe's heads beside SDPA; (c) phase 4's
   traffic, 16 greedy tokens each, in block mode with paged attention:
   10 SWIS launches a layer per model call (3 of them expert-axis), one
   paged launch a layer per arena call, a prefix hit, wall and
   device-busy ms per decode step; (d) greedy tokens at a 1-layer cut
   equal on the card and the CPU plain path; (e) the fused step and
   speculative decode on (c)'s traffic, launches checked, tokens equal on
   a fresh engine and, at the 1-layer cut, to the CPU plain path's (draft
   counts too). Their tokens are not held to (c)'s: multi-token launches
   take the capacity path, which routes pad rows and drops over-capacity
   choices.
8. the recurrent families at full width, one at a time, through the
   contiguous fallback (no block arena, so no paged launch):
   recurrentgemma-2b at 14 of its 26 layers (4 units of rec/rec/attn_local
   and its 2 tail rec layers) and mamba2-2.7b at 24 of its 64 layers are
   (a) drawn and packed one layer at a time; (b) the SWIS kernel is held
   against its plain version at a Griffin rec layer's, an attn_local
   layer's and a Mamba2 layer's GEMMs at M = 4 and Mamba2's in_proj at M =
   256, and each is timed beside its bound, the plain version and
   ``torch.matmul``; (c) Griffin serves phase 4's traffic (32 greedy tokens
   each, max_len 128) with ``prefix_cache=True`` asked for, and must fall
   back: 88 SWIS launches per model call, wall and device-busy ms per
   decode step, and ``DecodeEngine`` at T 0.7 equal to the continuous
   engine's ``generate``; (d) a 2100-token prompt, past the 2048-token
   window, wraps every local ring (checked on its position planes); a
   4-layer cut (the first unit and the first tail layer) gives the CPU
   plain path's tokens for two of (c)'s prompts and (d)'s; (e) Mamba2
   serves (c)'s traffic and a 600-token prompt (three 256-token SSD
   chunks, dt = 0 padding) at 48 SWIS launches per model call, with the
   same checks at a 2-layer cut; (f) the launcher serves ``--arch
   recurrentgemma-2b --packed`` in process at all 26 layers and prints its
   report.
9. the VLM and encoder families at full width and depth: (b) the SWIS
   kernel held against its plain version and timed (CUDA events) at one
   llama-3.2-vision-11b self layer's 7 GEMMs at M = 4, its cross
   attention's wk/wv at M = 4096 (4 images of 1024 patches) and one
   hubert-xlarge layer's 6 GEMMs at M = 2000 (4 clips of 500 frames), and
   paged attention at the VLM's heads (32 over 8 KV heads, Dh 128) beside
   SDPA; (a) llama-3.2-vision-11b (40 layers: 8 units of 4 attn and a
   self_cross layer) drawn and packed one layer at a time, ``xgate`` then
   set to 0.5 (the reference's 0 would shut the image out); (c) 8 requests
   on 4 slots, block mode with paged attention, max_len 128, 16 greedy
   tokens each, 4 of them with their own patches (1024 x 4096 fp32): 280
   SWIS launches a model call, 32 more for each call that carries patches
   (only prefill launches do), 40 paged an arena call; a prefix hit on
   the text requests and none on the image requests; the patches move an
   image request's first-token logits; wall and device-busy ms per decode
   step; (d) the fused step and speculative decode on (c)'s traffic,
   launches checked, and at the one-unit cut (2 requests, one with
   patches, 4 tokens) equal to the CPU plain path, draft counts too; (f)
   the launcher serves ``--arch llama-3.2-vision-11b --packed`` text
   requests in process on these weights; then hubert-xlarge (48 layers)
   is (a) drawn and packed, and (e) ``Model.apply`` on 4 clips of 500
   frames makes 288 SWIS launches and no paged one, gives finite logits
   that see both ways (the last frame moves position 0), bit-identical on
   a repeat and, at a 2-layer cut, the CPU plain path's within rtol 1e-4
   of max|logit|. Phase 3 also holds and times SWIS at mistral-large-123b's
   wq (12288 x 12288) and MLP wo (28672 x 12288), each packed alone.

10. SWIS QAT training at full width and depth, once phase 9's tensors are
   freed: smollm-135m (random seeded init, n_shifts 4, group 4, seq 256,
   batch 16, lr 3e-3, warmup 20, bf16 compute) (a) trains 8 steps through
   ``repro_torch.launch.train`` in process, checkpointing every 4 under
   ``build/``: each step's finite loss, wall ms, device ms of its parts
   (QAT selection, forward + backward, optimizer; CUDA events), tokens/s
   and peak memory, then a profiled step (device busy, and the kernels the
   selection launches); (b) a fresh trainer resumes from the step-4
   checkpoint and repeats steps 5-8's losses and the step-8 params bit
   for bit; (c) at a 2-layer cut of the same initial params, one QAT step
   (float32 compute) on the card and on the CPU plain path: fake-quantized
   weights bit-identical, loss, gradients and updated params within
   ``QAT_TOL``; (d) the serve launcher serves the step-8 checkpoint with
   ``--ckpt --packed`` (8 requests, 210 SWIS launches a model dispatch,
   the gather path), an engine with the paged kernel serves phase 4's
   traffic on the same packed weights (210 SWIS a model call, 30 paged an
   arena call), and at a 4-layer cut greedy tokens equal the CPU plain
   path's; (e) one QAT step of each family's smoke config (dense, MoE,
   Griffin, Mamba2, the VLM with patches, the encoder with frames) on the
   card against the CPU, with (c)'s checks.
11. the SWIS offline toolchain on smollm-135m at full width and depth
   (random weights from a seed, SWIS group 4), once phase 10's tensors are
   freed: (a) the cross-layer budget's sensitivity profile on the card
   over shift levels 1-5 for all 210 GEMM units (wall s, and layer 0's
   device-busy ms under the profiler), ``allocate`` at 2.0, 2.5 and 3.0,
   ``quantize_with_allocation`` on the card, and at a 2-layer cut the CPU
   plain path's profile, allocations and quantized leaves against the
   card's; (b) the exact §4.3 filter scheduler on layer 0's seven GEMMs
   (costs from the card, at the paper-table settings; seconds a schedule);
   (c) the model packed at 2.5 shifts (3 planes, half of each GEMM's
   columns scheduled at 2), phase 4's traffic through the paged engine
   (210 SWIS launches a model call, 30 paged an arena call), greedy tokens
   at a 4-layer cut equal to the CPU plain path's, and one decode layer's
   GEMMs timed at 3 and 4 planes; (d) the paper's analytical performance
   model (Table 4, the headline ratios, Fig. 1), printed as a model of the
   paper's 28 nm accelerator and held to the reference test's ranges.
12. parallel and the dry-run on ``torch.distributed``, once phase 11's
   tensors are freed: (a) phase 10's smollm-135m QAT settings, 4 steps,
   through ``repro_torch.launch.train`` unsharded and then with
   ``--mesh-data 1 --mesh-model 1`` on a one-rank NCCL group: the losses
   side by side (equal within 1e-3 of the first; their largest
   difference printed), the placements of ``wq``, and the sharded
   fake-quant of the trained ``wq`` bit-identical to the unsharded one;
   (b) the port's dry-run on the host as rank 0 of a fake 256-rank group
   on the (16, 16) mesh: mistral-large-123b and dbrx-132b ``decode_32k``
   and smollm-135m ``train_4k``, each record's per-device memory, FLOPs,
   collective wire bytes and counts and roofline terms on the H100's
   constants, printed as predictions of a trace; (c) rank 0 of
   mistral-large-123b's ``decode_32k`` on that mesh under the fake group,
   its shards on the card (packed, 4 planes, group 4: layer 0's local
   weights drawn from a seed and packed here, their planes in all 88
   layers; the bf16 cache's 2048 of 32768 positions for 8 rows):
   ``memory_allocated`` against (b)'s argument bytes, one decode step
   with 7 SWIS launches a layer (616) and none paged, its wall and
   device-busy ms, and the SWIS kernel held against its plain version and
   timed at rank 0's local GEMM shapes beside its byte bound and
   ``torch.matmul``; then the same for dbrx-132b's rank 0 (one expert of
   16 a rank: 7 SWIS launches a layer, 280, 3 of them expert-axis), but
   the timing. Every number of (c) is one rank of 256 with the
   collectives not executed; no value of it is compared or reported.

The CPU checks of phases 4-11 run inside ``plain_weights_once``: the plain
SWIS version expands each CPU weight once, not once a model call.

The line before the last is one JSON object ``{"kernels": [...]}`` (each
kernel's launches summed over the paths of phases 4 to 12, and by path; the
SWIS row also carries the expert-axis launch's own numbers, phase 8's
layers, phase 9's shapes, phase 11's 3-plane layer and phase 12's
rank-local mistral-large-123b layer, the paged row the qwen2-moe and VLM
decode launches); the last is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
FP32_FLOPS_PER_S = 67e12  # H100 SXM float32 peak outside the tensor cores
N_SHIFTS, GROUP = 4, 4
DRAFT_SLICES = 2  # planes the speculative draft keeps (path c)
PATHS_LAYERS = 10  # phase 5's depth: the first 10 of smollm-135m's 30 layers
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


def event_ms(fn, iters=20, warmup=3):
    """Mean device time of one ``fn()`` in ms from CUDA events around
    ``iters`` back-to-back calls, enqueued behind a kernel that spins for
    about 0.1 s: the host enqueues every launch before the first runs, so
    its time between launches does not count (``fn`` must not
    synchronize)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # clock cycles
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@contextlib.contextmanager
def plain_weights_once():
    """Within the block, the plain SWIS version expands each weight on the
    CPU from its bit-planes once: ``kernels.ref.dequant_ref`` of CPU planes
    is memoized (by the planes' and shifts' storage, shapes and strides,
    the group, dtype, layout and planes kept; the scale's values are
    compared on every hit, and the memo holds the planes, so no storage is
    reused under it). The same dequantized weights enter the same matmul,
    so the CPU plain path's results are unchanged; at full width the CPU
    checks pay the expansion once a weight instead of once a model call.
    Card tensors are never memoized: the plain version's times on the card
    stay its own. The memo is dropped on leaving the block."""
    import torch
    from repro_torch.kernels import ref

    orig = ref.dequant_ref
    memo = {}

    def dequant(sign_plane, mask_planes, shifts, scale, **kw):
        if sign_plane.device.type != "cpu":
            return orig(sign_plane, mask_planes, shifts, scale, **kw)
        key = tuple((t.data_ptr(), tuple(t.shape), t.stride())
                    for t in (sign_plane, mask_planes, shifts))
        key += tuple(sorted(kw.items(), key=lambda kv: kv[0]))
        hit = memo.get(key)
        if hit is not None and torch.equal(hit[1], scale):
            return hit[2]
        w = orig(sign_plane, mask_planes, shifts, scale, **kw)
        memo[key] = ((sign_plane, mask_planes, shifts), scale.clone(), w)
        return w

    ref.dequant_ref = dequant
    try:
        yield
    finally:
        ref.dequant_ref = orig
        memo.clear()


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
                # M = 4 is also the draft launches' shape (keep_slices)
                keep = (None, DRAFT_SLICES) if m == 4 else (None,)
                cases.append((m, k, n, GROUP, N_SHIFTS, dt, "swis", keep))
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
    perf["max_abs_err"] = max(perf["max_abs_err"], errs["float32"])
    perf["timed"] = ("one smollm-135m decode layer: 7 GEMMs at M=4 "
                     "(sum of per-GEMM means), fp32 x, 4 planes, group 4")
    return perf


def swis_layer_timing(dev, m, keep_slices=None, gemms=LAYER_GEMMS,
                      timer=None, n_shifts=N_SHIFTS):
    """One layer's GEMMs ``gemms`` (smollm-135m's 7 by default) at ``m``
    rows of fp32 x, packed at ``n_shifts`` (2.5 packs 3 planes, half the
    columns scheduled at 2 shifts), through the top ``keep_slices`` planes
    (None: all): the
    kernel held against the plain version (rtol 1e-5, atol 1e-5*max|ref|),
    then the kernel, the plain version and ``torch.matmul`` on the dense
    fp32 weight those planes give (sums of per-GEMM means; the kernel and
    ``torch.matmul`` by ``timer``, :func:`cuda_ms` by default), and the
    bound."""
    timer = timer or cuda_ms
    import torch
    from repro_torch.core.packing import PackedWeight
    from repro_torch.kernels import ops, ref

    ms = plain_ms = lib_ms = bound_ms = err = 0.0
    by = set()
    per_gemm = []  # "KxN kernel/torch.matmul" in us
    for i, (k, n) in enumerate(gemms):
        pw = packed_weight(k, n, GROUP, n_shifts, "swis", 50 + i, dev)
        scale = pw.scale.reshape(-1).expand(n).contiguous()
        pwn = PackedWeight(pw.sign_plane, pw.mask_planes, pw.shifts, scale,
                           GROUP, pw.n_shifts, k, n)
        x = torch.randn((m, k), device=dev)
        w = ref.dequant_ref(pw.sign_plane, pw.mask_planes, pw.shifts, scale,
                            group=GROUP, keep_slices=keep_slices)
        got = ops.swis_matmul(x, pwn, keep_slices=keep_slices)
        want = ref.swis_matmul_ref(x, pw.sign_plane, pw.mask_planes, pw.shifts,
                                   scale, group=GROUP, keep_slices=keep_slices)
        top = want.abs().max().item()
        err = max(err, (got - want).abs().max().item())
        check(torch.allclose(got, want, rtol=1e-5, atol=1e-5 * top),
              f"swis_matmul timed shape M={m} K={k} N={n} keep={keep_slices}: "
              f"max|err|={(got - want).abs().max().item():.3g} vs "
              f"max|ref|={top:.3g}")
        t = timer(lambda: ops.swis_matmul(x, pwn, keep_slices=keep_slices))
        plain_ms += cuda_ms(lambda: ref.swis_matmul_ref(
            x, pw.sign_plane, pw.mask_planes, pw.shifts, scale, group=GROUP,
            keep_slices=keep_slices), iters=20)
        t_lib = timer(lambda: torch.matmul(x, w))
        ms += t
        lib_ms += t_lib
        per_gemm.append(f"{k}x{n} {t * 1e3:.2f}/{t_lib * 1e3:.2f}")
        planes = pw.n_shifts if keep_slices is None else keep_slices
        nbytes = (x.numel() * 4 + pw.sign_plane.numel() * 4
                  + pw.mask_planes[0].numel() * 4 * planes + pw.shifts.numel()
                  + scale.numel() * 4 + m * n * 4)
        b, which = bound(nbytes, 2 * m * k * n)
        bound_ms += b
        by.add(which)
    print(f"  swis_matmul per GEMM at M={m}, keep_slices={keep_slices}, KxN "
          f"kernel/torch.matmul us: " + ", ".join(per_gemm))
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "max_abs_err": err,
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

    # many queries a row, as the fused mixed step (Sq = prefill_chunk) and
    # the verify launch give: q_lens 0, 1 and full; the kernel cuts the
    # Sq*G query rows into tiles of at most 32
    for sq in (16, 32, 64, 128):
        nb = sq // 8 + 8
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            q, k, v, pos, tables, q_pos = arena(
                dev, sq=sq, nb=nb, n_blocks=4 * nb + 1, seed=sq,
                live=(nb, nb - 2, 3, sq // 8 + 1))
            ql = torch.tensor([sq, 0, 1, sq], dtype=torch.int32, device=dev)
            k, v = k.to(dt), v.to(dt)
            got = paged_attention_decode(q, k, v, pos, tables, q_pos, q_lens=ql)
            again = paged_attention_decode(q, k, v, pos, tables, q_pos,
                                           q_lens=ql)
            check(torch.equal(got, again),
                  f"paged_attention Sq={sq} {dt}: repeat run differs")
            want = plain_paged(q, k, v, pos, tables, q_pos, ql, None)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            err_max = max(err_max, err)
            check(bool(torch.isfinite(got).all()) and torch.allclose(
                got, want, rtol=1e-5, atol=1e-5),
                f"paged_attention Sq={sq} x G=3 {dt}: max|err|={err:.3g} (1e-5)")
    print(f"paged_attention: Sq 16/32/64/128 x G=3 (q_lens full, 0, 1, full) "
          f"x 3 cache dtypes against the plain version, every row within "
          f"1e-5, repeat runs bit-identical")

    perf = paged_timing(dev, nb=16, n_blocks=97, live=(12, 12, 11, 12))
    perf["max_abs_err"] = err_max
    perf["timed"] = ("one decode launch: B=4, H=9 over Hkv=3, Dh=64, "
                     "block_size 8, 16 logical blocks, fp32 cache")
    return perf


def paged_timing(dev, *, nb, n_blocks, live, sq=1, q_lens=None, hkv=3, g=3,
                 dh=64, timer=None):
    """One launch (``hkv * g`` heads over ``hkv`` KV heads of ``dh``, by
    default smollm-135m's 9 over 3 of 64; block size 8, fp32 cache, ``nb``
    logical blocks with ``live`` of them filled per row, ``sq`` queries a
    row of which ``q_lens`` are real; a row with ``q_lens`` 1 decodes at its
    last position), held against the plain version (1e-5): the kernel, the
    plain version, one SDPA call over the gathered K/V (the kernel and SDPA
    by ``timer``, :func:`cuda_ms` by default), and the bound."""
    timer = timer or cuda_ms
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import mask_value, paged_attention

    b = len(live)
    q, k, v, pos, tables, q_pos = arena(dev, b=b, hkv=hkv, g=g, dh=dh, nb=nb,
                                        n_blocks=n_blocks, live=live, sq=sq,
                                        seed=9)
    h = hkv * g
    ql = torch.tensor(q_lens or [sq] * b, dtype=torch.int32, device=dev)
    tl = tables.long()
    bs = k.shape[1]
    gp = torch.where((tl == 0)[:, :, None], -1, pos[tl]).reshape(b, nb * bs)
    q_pos = torch.where(ql == 1, gp.amax(dim=1), q_pos).to(torch.int32)
    q4 = q.reshape(b, sq, hkv, g, dh).permute(0, 2, 1, 3, 4).reshape(
        b, hkv, sq * g, dh).contiguous()
    kern = lambda: paged_attention(q4, k, v, pos, tables, q_pos, ql, sq=sq,  # noqa: E731
                                   causal=True, window=None)
    plain = lambda: ref.paged_attention_ref(  # noqa: E731
        q4, k, v, pos, tables, q_pos, ql, sq=sq, causal=True, window=None,
        neg=mask_value(torch.float32))
    got, want = kern(), plain()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
          f"paged_attention timed shape (B {b}, Hkv {hkv}, G {g}, Dh {dh}, "
          f"nb {nb}, Sq {sq}): max|err|={err:.3g} (1e-5)")
    ms = timer(kern)
    plain_ms = cuda_ms(plain, iters=20 if nb <= 16 else 3, warmup=2)
    # yardstick: one SDPA call over the gathered, head-expanded K/V
    gk = k[tl].reshape(b, nb * bs, hkv, dh).repeat_interleave(g, 2).transpose(1, 2)
    gv = v[tl].reshape(b, nb * bs, hkv, dh).repeat_interleave(g, 2).transpose(1, 2)
    qi = torch.arange(sq, device=dev)
    qp = q_pos[:, None] + qi[None, :]  # (B, Sq)
    mask = ((gp[:, None, :] >= 0) & (gp[:, None, :] <= qp[:, :, None])
            & (qi[None, :, None] < ql[:, None, None]))[:, None]
    qs = q.transpose(1, 2).contiguous()
    lib_ms = timer(lambda: F.scaled_dot_product_attention(qs, gk, gv,
                                                          attn_mask=mask))
    live_blocks = torch.unique(tl[tl != 0]).numel()
    n_valid = int(mask.sum().item())
    nbytes = (q.numel() * 4 + 2 * live_blocks * bs * hkv * dh * 4
              + live_blocks * bs * 4 + tables.numel() * 4 + 2 * b * 4
              + q.numel() * 4)
    bound_ms, by = bound(nbytes, 4 * n_valid * h * dh)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": by, "max_abs_err": err}


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
    # the fused mixed step of the serve bench's long_prompt shape: 4 decode
    # rows and 2 rows of a 32-token chunk over 64 logical blocks (max_len 512)
    p = paged_timing(dev, nb=64, n_blocks=161, sq=32,
                     live=(9, 10, 9, 8, 30, 30), q_lens=[1, 1, 1, 1, 32, 32])
    print(f"paged_attention mixed launch (B=6: 4 decode rows + 2 rows of a "
          f"32-token chunk, Sq 32 x G 3 = 96 query rows, 64 logical blocks, "
          f"fp32 cache) on {card}: kernel {p['ms']:.4f} ms, SDPA "
          f"{p['library_ms']:.4f} ms, plain {p['plain_ms']:.4f} ms, bound "
          f"{p['bound_ms']:.6f} ms ({p['bound_by']})")
    p = paged_timing(dev, nb=64, n_blocks=161, sq=64,
                     live=(9, 10, 9, 8, 30, 30), q_lens=[1, 1, 1, 1, 64, 64])
    print(f"paged_attention mixed launch at Sq 64 (192 query rows, same "
          f"arena) on {card}: kernel {p['ms']:.4f} ms, SDPA "
          f"{p['library_ms']:.4f} ms, plain {p['plain_ms']:.4f} ms, bound "
          f"{p['bound_ms']:.6f} ms ({p['bound_by']})")
    p = swis_layer_timing(dev, 4, keep_slices=DRAFT_SLICES)
    print(f"swis_matmul draft layer (7 GEMMs at M=4, keep_slices="
          f"{DRAFT_SLICES}, fp32 x) on {card}: kernel {p['ms']:.4f} ms, "
          f"torch.matmul {p['library_ms']:.4f} ms, plain {p['plain_ms']:.4f} "
          f"ms, bound {p['bound_ms']:.5f} ms ({p['bound_by']}); max|err| "
          f"{p['max_abs_err']:.3g} against the plain version")


def dense_family_phase(dev, card):
    """Both kernels at the published shapes of the other one-card dense
    configs, phi3-mini-3.8b (Dh 96) and deepseek-7b (Dh 128), both MHA
    (G 1): one layer's 7 SWIS GEMMs at M = 4 (the decode rows) held
    against the plain version and timed; paged attention at decode (Sq 1)
    and verify-like (Sq 4, q_lens with 0) shapes in three cache dtypes,
    every row against the plain version and repeat runs bit-identical, and
    the decode launch timed. Then SWIS alone at mistral-large-123b's
    widest GEMMs, wq (12288 x 12288) and the MLP's wo (28672 x 12288, the
    largest K yet), at M = 4, each matrix packed alone (the model, ~143 GB
    packed, does not fit one card), by CUDA events. Returns (the largest
    |err| of each kernel, the mistral-large timing)."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels.paged_attention import paged_attention_decode

    errs = {"swis_matmul": 0.0, "paged_attention": 0.0}
    for arch in ("phi3-mini-3.8b", "deepseek-7b"):
        cfg = configs.get_config(arch)
        d, ff = cfg.d_model, cfg.d_ff
        kv = cfg.n_kv_heads * cfg.head_dim
        hkv, g, dh = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
        gemms = [(d, d), (d, kv), (d, kv), (d, d), (d, ff), (d, ff), (ff, d)]
        p = swis_layer_timing(dev, 4, gemms=gemms)
        errs["swis_matmul"] = max(errs["swis_matmul"], p["max_abs_err"])
        print(f"swis_matmul {arch} decode layer (7 GEMMs at M=4, K {d} and "
              f"{ff}, fp32 x) on {card}: kernel {p['ms']:.4f} ms, "
              f"torch.matmul {p['library_ms']:.4f} ms, plain "
              f"{p['plain_ms']:.4f} ms, bound {p['bound_ms']:.5f} ms "
              f"({p['bound_by']}); max|err| {p['max_abs_err']:.3g} against "
              f"the plain version (rtol 1e-5, atol 1e-5*max|ref|)")
        for sq, q_lens in ((1, None), (4, [4, 0, 2, 1])):
            for dt in (torch.float32, torch.bfloat16, torch.float16):
                q, k, v, pos, tables, q_pos = arena(dev, hkv=hkv, g=g, dh=dh,
                                                    sq=sq, seed=dh + sq)
                k, v = k.to(dt), v.to(dt)
                ql = None if q_lens is None else torch.tensor(
                    q_lens, dtype=torch.int32, device=dev)
                got = paged_attention_decode(q, k, v, pos, tables, q_pos,
                                             q_lens=ql)
                again = paged_attention_decode(q, k, v, pos, tables, q_pos,
                                               q_lens=ql)
                check(torch.equal(got, again), f"paged_attention {arch} "
                      f"Sq={sq} {dt}: repeat run differs")
                want = plain_paged(q, k, v, pos, tables, q_pos, ql, None)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                errs["paged_attention"] = max(errs["paged_attention"], err)
                check(bool(torch.isfinite(got).all()) and torch.allclose(
                    got, want, rtol=1e-5, atol=1e-5),
                    f"paged_attention {arch} (Hkv {hkv}, G {g}, Dh {dh}) "
                    f"Sq={sq} {dt}: max|err|={err:.3g} (1e-5)")
        p = paged_timing(dev, nb=16, n_blocks=97, live=(12, 12, 11, 12),
                         hkv=hkv, g=g, dh=dh)
        print(f"paged_attention {arch} decode launch (B=4, {hkv} heads, G "
              f"{g}, Dh {dh}, 16 logical blocks, fp32 cache) on {card}: "
              f"kernel {p['ms']:.4f} ms, SDPA {p['library_ms']:.4f} ms, "
              f"plain {p['plain_ms']:.4f} ms, bound {p['bound_ms']:.6f} ms "
              f"({p['bound_by']}); Sq 1 and 4 x 3 cache dtypes within 1e-5 "
              f"of the plain version on every row, repeats bit-identical")
    cfg = configs.get_config("mistral-large-123b")
    gemms = [(cfg.d_model, cfg.n_heads * cfg.head_dim),
             (cfg.d_ff, cfg.d_model)]
    mistral = swis_layer_timing(dev, 4, gemms=gemms, timer=event_ms)
    errs["swis_matmul"] = max(errs["swis_matmul"], mistral["max_abs_err"])
    print(f"swis_matmul mistral-large-123b wq {gemms[0][0]}x{gemms[0][1]} and "
          f"MLP wo {gemms[1][0]}x{gemms[1][1]} at M=4, fp32 x, on {card} "
          f"(CUDA events behind a spin kernel): kernel {mistral['ms']:.4f} "
          f"ms, torch.matmul {mistral['library_ms']:.4f} ms, plain "
          f"{mistral['plain_ms']:.4f} ms, bound {mistral['bound_ms']:.5f} ms "
          f"({mistral['bound_by']}); max|err| {mistral['max_abs_err']:.3g} "
          f"against the plain version (rtol 1e-5, atol 1e-5*max|ref|)")
    return errs, mistral


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


def layer_cut(cfg, params, n_layers=4):
    """(config, weights on the card, the same weights on the CPU) of a
    ``n_layers``-layer model: the first stacked units it holds and, where
    its depth leaves a tail, the first tail layers of ``params`` (Griffin
    at 4 layers: the first (rec, rec, attn_local) unit and the first tail
    rec layer). The depth at which the CPU plain path runs a path's
    traffic in seconds."""
    from repro_torch.models import params as pp
    from repro_torch.models.model import Model

    cut_cfg = cfg.replace(n_layers=n_layers)
    model = Model(cut_cfg)
    cut = {k: v for k, v in params.items() if k != "tail"}
    cut["blocks"] = pp.tree_map(lambda a: a[:model.n_units].contiguous(),
                                params["blocks"])
    if model.tail:
        cut["tail"] = {f"tail{i}_{kind}": params["tail"][f"tail{i}_{kind}"]
                       for i, kind in enumerate(model.tail)}
    return cut_cfg, cut, pp.tree_map(lambda a: a.cpu(), cut)


def check_dispatches(label, engine):
    """The metrics registry counted the engine's model calls (and, when it
    speculates, its proposed and accepted drafts) as its own counters did."""
    c = engine.metrics()["engine"]["counters"]
    got = (c["step.model_dispatches"], c.get("spec.proposed", 0),
           c.get("spec.accepted", 0))
    want = (engine.model_calls(), engine.spec_proposed, engine.spec_accepted)
    check(got == want, f"{label}: (step.model_dispatches, spec.proposed, "
          f"spec.accepted) {got} != the engine's own counters {want}")


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
    check_dispatches("phase 4", gpu)
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

    # the same requests on the same packed weights cut to 4 layers, on the
    # card and through the CPU plain path
    t0 = time.perf_counter()
    cfg4, cut, cut_cpu = layer_cut(cfg, gpu.params)
    toks_card4, _, _ = serve(ContinuousBatchingEngine(cfg4, cut, ecfg,
                                                      device=dev), reqs, 32)
    cpu = ContinuousBatchingEngine(cfg4, cut_cpu, ecfg, device="cpu")
    toks_cpu, _, _ = serve(cpu, reqs, 32)
    same_tokens("phase 4 (4-layer cut) vs the CPU plain path", toks_card4,
                toks_cpu, [(p, 32) for p in reqs],
                [("card", cpu.model, cut, dev),
                 ("cpu", cpu.model, cut_cpu, "cpu")])
    print(f"greedy tokens at a 4-layer cut: 8/8 requests identical on the "
          f"card and the CPU plain path (CPU "
          f"{time.perf_counter() - t0:.1f} s)")
    return counts, gpu


# -- phase 5: the rest of the serve engine at full width ------------------------


def long_traffic(vocab):
    """The serve bench's long_prompt shape: two 448-token prompts (14
    chunks of 32) arrive beside four 64-token prompts; 16 tokens each."""
    import numpy as np

    rng = np.random.default_rng(1)
    short = [rng.integers(0, vocab, 64).astype(np.int32) for _ in range(4)]
    long = [rng.integers(0, vocab, 448).astype(np.int32) for _ in range(2)]
    return [(p, 16) for p in (short[0], short[1], long[0], short[2], short[3],
                              long[1])]


def drive(engine, traffic, temperature=0.0, profiled=False):
    """Submit ``traffic`` [(prompt, n_tokens)] or [(prompt, n_tokens,
    extra)] (seed i for request i when sampling) and step to idle; request
    i gets rid i. Returns (tokens per request, steps, wall ms per step,
    device-busy ms per step or None). ``profiled`` runs it under
    ``torch.profiler`` for the device time, whose wall time is then not
    the engine's own."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import SamplingParams

    engine.reset()
    rids = [engine.submit(p, SamplingParams(
                max_tokens=n, temperature=temperature,
                seed=i if temperature else None),
                extra=extra[0] if extra else None)
            for i, (p, n, *extra) in enumerate(traffic)]
    out, steps = {}, 0
    sync = (torch.cuda.synchronize if engine.device.type == "cuda"
            else (lambda: None))
    prof = profile(activities=[ProfilerActivity.CUDA]) if profiled else None
    if prof:
        prof.__enter__()
    sync()
    t0 = time.perf_counter()
    while engine.scheduler.pending():
        out.update({f.rid: f.tokens for f in engine.step()})
        steps += 1
    sync()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    busy = None
    if prof:
        prof.__exit__(None, None, None)
        busy = device_ms(prof) / steps
    return [out[r] for r in rids], steps, wall, busy


def device_ms(prof):
    """Device time (ms) of every kernel a finished profiler saw."""
    return sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
               for e in prof.key_averages()) / 1e3


def same_tokens(label, got, want, traffic, models):
    """Token lists equal, or print the first mismatch with the top-2 logits
    of each side (``models``: [(name, model, params, device)]) and fail."""
    for r, (a, b) in enumerate(zip(got, want)):
        if len(a) != len(b) or (a != b).any():
            step = int((a != b).argmax()) if len(a) == len(b) else 0
            seq = list(traffic[r][0]) + [int(t) for t in a[:step]]
            tops = "; ".join(f"top-2 {name} {top2(m, p, seq, d)}"
                             for name, m, p, d in models)
            print(f"MISMATCH {label}: request {r} step {step}: "
                  f"{a[step]} vs {b[step]}; {tops}")
            raise PhaseError(f"{label}: tokens differ (request {r}, step {step})")


def paths_phase(dev, card, kernels, cfg, params):
    """Paths (a) chunked prefill, (b) the fused mixed step, (c) speculative
    decode, (d) seeded sampling and (e) the contiguous mode and
    ``DecodeEngine``, at full smollm-135m width on the card (``params``:
    phase 4's packed weights, at the depth ``cfg`` gives). Each path's launches are
    counted from 0 and held against its engine's model calls; (a)-(c)
    against the plain decode path's tokens on the card; a profiled repeat
    run gives the device time and the same tokens; and every path at a
    4-layer cut of the same weights against the CPU plain path (for (c),
    the draft counts too)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.swis import QuantConfig
    from repro_torch.serve import (ContinuousBatchingEngine, DecodeEngine,
                                   EngineConfig)

    qcfg = QuantConfig(method="swis", n_shifts=N_SHIFTS, group_size=GROUP)
    base = dict(n_slots=4, block_size=8, packed=True, quant_cfg=qcfg,
                use_paged_kernel=True)
    long = long_traffic(cfg.vocab)
    short = [(p, 32) for p in prompts(cfg.vocab, seed=2)[:4]]
    sampled = [(p, 16) for p in prompts(cfg.vocab, seed=3)]
    paths = [  # (label, engine options, traffic, temperature, plain options)
        ("a chunked", dict(max_len=512, prefill_chunk=32), long, 0.0,
         dict(max_len=512)),
        ("b fused", dict(max_len=512, prefill_chunk=64, fused_step=True),
         long, 0.0, dict(max_len=512)),
        ("c spec", dict(max_len=128, spec_decode=True, spec_k=3,
                        draft_slices=DRAFT_SLICES), short, 0.0,
         dict(max_len=128)),
        ("d sampled", dict(max_len=128), sampled, 0.8, None),
        ("e contiguous", dict(max_len=128, prefix_cache=False,
                              use_paged_kernel=False), sampled[:4], 0.0, None),
    ]
    per_layer = 7  # SWIS GEMMs per layer
    by_path = {}
    plain_cache = {}
    cfg4, cut, cut_cpu = layer_cut(cfg, params)
    for label, opts, traffic, temp, plain_opts in paths:
        eng = ContinuousBatchingEngine(cfg, params, EngineConfig(**{**base, **opts}),
                                       device=dev)
        for kern in kernels:
            kern.launches = 0
        toks, steps, wall, _ = drive(eng, traffic, temp)
        counts = {kern.name: kern.launches for kern in kernels}
        calls, arena_calls = eng.model_calls(), eng.arena_calls()
        check_dispatches(label, eng)
        check(counts["swis_matmul"] == per_layer * cfg.n_layers * calls,
              f"{label}: swis_matmul launches {counts['swis_matmul']} != "
              f"{per_layer * cfg.n_layers} x {calls} model calls")
        check(counts["paged_attention"] == cfg.n_layers * arena_calls,
              f"{label}: paged_attention launches {counts['paged_attention']} "
              f"!= {cfg.n_layers} x {arena_calls} arena calls")
        by_path[label] = counts
        again, _, _, busy = drive(eng, traffic, temp, profiled=True)
        same_tokens(f"{label} repeat run", again, toks, traffic, [])
        extra = ""
        if eng.spec_decode:
            extra = (f"; spec accepted {eng.spec_accepted} of "
                     f"{eng.spec_proposed} drafts (accept rate "
                     f"{eng.spec_accepted / max(eng.spec_proposed, 1):.3f})")
        print(f"path {label} on {card}: {steps} steps, {wall:.2f} ms/step "
              f"wall, device busy {busy:.3f} ms/step (profiled run); "
              f"dispatches prefill {eng.n_prefill_calls}, chunk "
              f"{eng.n_chunk_calls}, mixed {eng.n_mixed_steps}, decode "
              f"{eng.n_decode_steps}, draft {eng.n_draft_steps}, verify "
              f"{eng.n_verify_steps}; launches {counts}{extra}")
        if plain_opts is not None:
            key = tuple(sorted(plain_opts.items())) + (id(traffic),)
            if key not in plain_cache:
                plain = ContinuousBatchingEngine(
                    cfg, params, EngineConfig(**{**base, **plain_opts}), device=dev)
                plain_cache[key] = (drive(plain, traffic)[0], plain)
            want, plain = plain_cache[key]
            same_tokens(f"{label} vs plain decode on the card", toks, want,
                        traffic, [("card", eng.model, eng.params, dev)])
        # the same path at a 4-layer cut, on the card and on the CPU
        note = ""
        card4 = ContinuousBatchingEngine(cfg4, cut, EngineConfig(**{**base, **opts}),
                                         device=dev)
        got = drive(card4, traffic, temp)[0]
        cpu = ContinuousBatchingEngine(cfg4, cut_cpu, EngineConfig(**{**base, **opts}),
                                       device="cpu")
        t0 = time.perf_counter()
        want = drive(cpu, traffic, temp)[0]
        same_tokens(f"{label} (4-layer cut) vs the CPU plain path", got, want,
                    traffic, [("card", cpu.model, cut, dev),
                              ("cpu", cpu.model, cut_cpu, "cpu")])
        if eng.spec_decode:
            # the verify launch fixes every token, so only the accept counts
            # show a wrong draft
            spec = ((card4.spec_proposed, card4.spec_accepted),
                    (cpu.spec_proposed, cpu.spec_accepted))
            check(spec[0] == spec[1], f"{label} (4-layer cut): drafts "
                  f"(proposed, accepted) {spec[0]} on the card, {spec[1]} on "
                  f"the CPU plain path")
            note = f"; drafts (proposed, accepted) {spec[0]} as on the CPU"
        held = ("the plain decode path on the card, " if plain_opts else "")
        print(f"  {label}: {len(traffic)} requests; tokens equal to {held}"
              f"the profiled repeat run, and at the 4-layer cut to the CPU "
              f"plain path (CPU {time.perf_counter() - t0:.1f} s)"
              f"{note}")
        del eng

    # DecodeEngine, greedy and sampled, against the contiguous engine's
    # generate() on the card and the CPU plain path at the 4-layer cut
    import numpy as np

    batch = np.stack([p for p, _ in sampled[:4]])
    for temp in (0.0, 0.8):
        dec = DecodeEngine(cfg, params, max_len=128, batch=4, packed=True,
                           quant_cfg=qcfg, device=dev)
        for kern in kernels:
            kern.launches = 0
        t0 = time.perf_counter()
        out = dec.generate(batch, 16, temperature=temp, seed=5)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / 16
        counts = {kern.name: kern.launches for kern in kernels}
        check(counts == {"swis_matmul": per_layer * cfg.n_layers * 16,
                         "paged_attention": 0},
              f"DecodeEngine launches {counts} (16 model calls)")
        by_path[f"e DecodeEngine T={temp}"] = counts
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            again = dec.generate(batch, 16, temperature=temp, seed=5)
            torch.cuda.synchronize()
        busy = device_ms(prof) / 16
        same_tokens(f"DecodeEngine T={temp} repeat run", list(again[:, 64:]),
                    list(out[:, 64:]), [(p, 16) for p in batch], [])
        cbe = ContinuousBatchingEngine(
            cfg, params, EngineConfig(**{**base, "max_len": 128,
                                         "prefix_cache": False,
                                         "use_paged_kernel": False}), device=dev)
        traffic = [(p, 16) for p in batch]
        same_tokens(f"DecodeEngine T={temp} vs ContinuousBatchingEngine."
                    f"generate", list(out[:, 64:]),
                    list(cbe.generate(batch, 16, temperature=temp,
                                      seed=5)[:, 64:]), traffic, [])
        got = DecodeEngine(cfg4, cut, max_len=128, batch=4, packed=True,
                           quant_cfg=qcfg, device=dev).generate(
            batch, 16, temperature=temp, seed=5)
        want = DecodeEngine(cfg4, cut_cpu, max_len=128, batch=4, packed=True,
                            quant_cfg=qcfg, device="cpu").generate(
            batch, 16, temperature=temp, seed=5)
        same_tokens(f"DecodeEngine T={temp} (4-layer cut) vs the CPU plain "
                    f"path", list(got[:, 64:]), list(want[:, 64:]), traffic,
                    [("card", dec.model, cut, dev)])
        print(f"path e DecodeEngine T={temp} on {card}: 16 lockstep steps at "
              f"{wall:.2f} ms/step wall, device busy {busy:.3f} ms/step "
              f"(profiled run); launches {counts}; tokens equal to the "
              f"profiled repeat run, ContinuousBatchingEngine.generate "
              f"(contiguous) and, at the 4-layer cut, to the CPU plain path")
    return by_path


# -- phase 6: observability and the launcher at full width --------------------


def chrome_trace_check(path, n_steps, n_requests):
    """The launcher's Chrome trace loads; every phase span of the engine
    track nests in a step span, one step span per engine step; one track
    per request."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    check(all("ph" in e and "ts" in e and "pid" in e for e in events),
          f"{path}: an event lacks ph, ts or pid")
    spans = [e for e in events if e["ph"] == "X" and e["pid"] == 1]
    steps = [e for e in spans if e["name"] == "step"]
    check(len(steps) == n_steps, f"{path}: {len(steps)} step spans for "
          f"{n_steps} engine steps")
    phases = [e for e in spans if e["name"] != "step"]
    check(phases and all(
        any(s["ts"] <= e["ts"] and e["ts"] + e["dur"]
            <= s["ts"] + s["dur"] + 1e-3 for s in steps) for e in phases),
        f"{path}: a phase span lies outside every step span")
    tracks = {e["tid"] for e in events if e["pid"] == 2 and e["ph"] != "M"}
    check(len(tracks) == n_requests, f"{path}: {len(tracks)} request "
          f"tracks for {n_requests} requests")
    return len(events), len(phases)


def instrument_us(engine, reps=2000):
    """Host microseconds a decode step of ``engine`` spends in its
    instruments, replayed ``reps`` times without the model: the step's
    phase timers and spans, its cost record, a decode-step trace event per
    slot, the step counter and the utilization gauges. The wall time of a
    step varies between runs by far more than this, so the replay is how
    the instruments' cost is read."""
    m, tracer = engine.metrics_registry, engine.tracer
    cost = engine.cost_model.decode(engine.n_slots)
    t0 = time.perf_counter()
    for i in range(reps):
        with engine._phase("step.total_s", "step"):
            with engine._phase("step.admit_s", "admit"):
                pass
            engine._record_cost(cost)
            for name in ("decode_dispatch", "device_sync", "sample_host"):
                with engine._phase(f"step.{name}_s", name):
                    pass
        for slot in range(engine.n_slots):
            tracer.event("decode_step", slot, slot=slot, step=i)
        m.counter("step.count").inc()
        if m.enabled:
            total = m.histogram("step.total_s").total
            m.gauge("cost.hbm_bytes_per_s").set(
                m.counter("cost.hbm_bytes").value / total)
            m.gauge("cost.flops_per_s").set(
                m.counter("cost.flops").value / total)
    return (time.perf_counter() - t0) / reps * 1e6


def observability_phase(dev, card, kernels, cfg, params):
    """The serve launcher in this process at full smollm-135m width and
    depth (packed weights, 8 requests of 64 prompt tokens, 32 tokens each,
    4 slots), continuous with a Chrome trace and then static; the phase-4
    traffic with metrics off and on (wall time per step both ways, the
    phase timers, TTFT and TPOT); and at a 4-layer cut of ``params`` the
    card's counters, ``cost.*`` values, scheduler gauges and prefix stats
    against the CPU plain path's."""
    from repro_torch.core.swis import QuantConfig
    from repro_torch.launch import serve as launcher
    from repro_torch.serve import ContinuousBatchingEngine, EngineConfig

    per_call = 7 * cfg.n_layers
    by_path = {}
    trace_path = ROOT / "build" / "serve_trace.json"
    trace_path.parent.mkdir(exist_ok=True)
    argv = ["--arch", "smollm-135m", "--packed", "--requests", "8",
            "--prompt-len", "64", "--tokens", "32", "--n-slots", "4"]
    for engine in ("continuous", "static"):
        extra = (["--trace-out", str(trace_path)] if engine == "continuous"
                 else ["--engine", "static"])
        for kern in kernels:
            kern.launches = 0
        t0 = time.perf_counter()
        # the continuous run draws and packs its own weights, as a user's
        # does; the static run serves the same weights, packed in phase 4
        report, eng = launcher.run(launcher.parse_args(argv + extra),
                                   params=params if engine == "static"
                                   else None)
        secs = time.perf_counter() - t0
        counts = {kern.name: kern.launches for kern in kernels}
        by_path[f"6 launcher {engine}"] = counts
        if engine == "static":
            calls = 32  # one prefill and 31 lockstep decode calls
        else:
            calls = eng.metrics()["engine"]["counters"]["step.model_dispatches"]
            check_dispatches("launcher", eng)
        check(counts == {"swis_matmul": per_call * calls,
                         "paged_attention": 0},
              f"launcher {engine}: launches {counts} != {per_call} SWIS x "
              f"{calls} model dispatches and no paged launch (the launcher "
              f"serves the gather path)")
        print(f"launcher --engine {engine} on {card}: {secs:.1f} s in all, "
              f"wall_s {report['wall_s']}, "
              f"{report['tok_per_s']} tokens/s; {calls} model dispatches, "
              f"launches {counts}")
        if engine == "continuous":
            want = {"ttft_p50_s", "ttft_p95_s", "tpot_p50_s", "cost_hbm_mib",
                    "cost_gflops", "cost_hbm_bytes_per_s", "prefix_hit_rate"}
            check(want <= set(report), f"launcher report lacks "
                  f"{sorted(want - set(report))}")
            n_steps = eng.metrics()["engine"]["counters"]["step.count"]
            n_events, n_phases = chrome_trace_check(trace_path, n_steps, 8)
            print(f"  Chrome trace {trace_path.relative_to(ROOT)}: "
                  f"{n_events} events, {n_steps} step spans with {n_phases} "
                  f"phase spans nested inside, 8 request tracks; report "
                  f"TTFT p50 {report['ttft_p50_s']} s, TPOT p50 "
                  f"{report['tpot_p50_s']} s, cost {report['cost_hbm_mib']} "
                  f"MiB and {report['cost_gflops']} GFLOP")
        del eng

    # the phase-4 traffic with metrics off and on, in turns
    qcfg = QuantConfig(method="swis", n_shifts=N_SHIFTS, group_size=GROUP)
    opts = dict(n_slots=4, block_size=8, packed=True, use_paged_kernel=True,
                max_len=128, quant_cfg=qcfg)
    traffic = [(p, 32) for p in prompts(cfg.vocab)]
    engines = {on: ContinuousBatchingEngine(
        cfg, params, EngineConfig(enable_metrics=on, **opts), device=dev)
        for on in (False, True)}
    walls = {False: [], True: []}
    toks = {}
    # in turns, each side first as often: the host's wall time per step
    # drifts between runs by more than the instruments cost (read apart
    # by instrument_us below)
    for on in (False, True, True, False):
        toks[on], steps, wall, _ = drive(engines[on], traffic)
        walls[on].append(wall)
    same_tokens("phase-4 traffic, metrics on vs off", toks[True], toks[False],
                traffic, [])
    on = engines[True]
    check_dispatches("phase-4 traffic, metrics on", on)
    m = on.metrics()
    counters = m["engine"]["counters"]
    check("cost.gathered_bytes" not in counters and on.paged_impl == "cuda",
          f"the paged kernel gathers nothing, but the cost model counted "
          f"{counters.get('cost.gathered_bytes')} gathered bytes "
          f"(paged_impl {on.paged_impl})")
    med = {k: sorted(v)[len(v) // 2 - 1:len(v) // 2 + 1] for k, v in
           walls.items()}
    print(f"phase-4 traffic on {card}: {steps} steps a run; wall ms/step "
          + "; ".join(f"metrics {'on' if k else 'off'} "
                      + ", ".join(f"{w:.2f}" for w in v)
                      + f" (median {sum(med[k]) / 2:.2f}, range "
                      f"{max(v) - min(v):.2f})" for k, v in walls.items())
          + "; tokens equal")
    phases = m["engine"]["phases"]
    print("  step phases, p50 / p95 ms (metrics on, last run): " + ", ".join(
        f"{k[len('step.'):-2]} {v['p50'] * 1e3:.3f} / {v['p95'] * 1e3:.3f} "
        f"(n {v['count']})" for k, v in sorted(phases.items())
        if k.startswith("step.")))
    tsum = on.tracer.summary()
    print(f"  TTFT p50 {tsum['ttft_s']['p50'] * 1e3:.2f} ms, p95 "
          f"{tsum['ttft_s']['p95'] * 1e3:.2f} ms; TPOT p50 "
          f"{tsum['tpot_s']['p50'] * 1e3:.2f} ms; queue wait p50 "
          f"{tsum['queue_wait_s']['p50'] * 1e3:.2f} ms ({tsum['requests']} "
          f"requests)")
    print("  cost totals: " + ", ".join(
        f"{k} {v:.6g}" for k, v in sorted(counters.items())
        if k.startswith("cost.") and k.count(".") == 1) + "; gauges "
        + ", ".join(f"{k} {v:.6g}" for k, v in sorted(
            m["engine"]["gauges"].items())))
    us = {k: instrument_us(e) for k, e in engines.items()}
    print(f"  instruments of one decode step, replayed without the model on "
          f"this host: {us[True]:.1f} us with metrics on, {us[False]:.1f} us "
          f"off")
    del engines, on

    # 4-layer cut on the launcher's gather path: card against CPU, exactly
    cfg4, cut, cut_cpu = layer_cut(cfg, params)
    gather = EngineConfig(**{**opts, "use_paged_kernel": False})
    runs = []
    for d, tree in ((dev, cut), ("cpu", cut_cpu)):
        eng = ContinuousBatchingEngine(cfg4, tree, gather, device=d)
        got = drive(eng, traffic)[0]
        m = eng.metrics()
        runs.append((got, m["engine"]["counters"], m["scheduler"],
                     m["prefix_cache"], m["engine"]["cost_model"]))
    (tc, *card4), (tp, *cpu4) = runs
    same_tokens("phase-4 traffic (4-layer cut, gather path) vs the CPU plain "
                "path", tc, tp, traffic, [])
    for name, a, b in zip(("counters", "scheduler gauges", "prefix stats",
                           "cost model"), card4, cpu4):
        check(a == b, f"4-layer cut: {name} on the card differ from the CPU "
              f"plain path's: " + str({k: (a.get(k), b.get(k))
                                       for k in set(a) | set(b)
                                       if a.get(k) != b.get(k)}))
    print(f"  4-layer cut, gather path: tokens, {len(card4[0])} counters "
          f"(cost.* included), scheduler gauges, prefix stats and the cost "
          f"model summary equal on the card and the CPU plain path")
    return by_path


# -- phase 7: the MoE family at full width --------------------------------------

MOE_ARCH = "qwen2-moe-a2.7b"
# phase 7's depth: the first 9 of qwen2-moe's 24 layers (below 9 the
# per-layer packing scratch outgrows the float32 tree packed_init's peak
# check compares it with)
MOE_LAYERS = 9
MOE_PER_LAYER = 10  # SWIS launches a layer: q/k/v/o, 3 shared, 3 expert stacks


def tree_bytes(tree):
    from repro_torch.models import params as pp

    sizes = []
    pp.tree_map(lambda a: sizes.append(a.numel() * a.element_size()), tree)
    return sum(sizes)


def packed_init(dev, arch, n_layers=None):
    """``arch`` at its published widths (and depth, unless ``n_layers``
    cuts it), random weights from seed 0, drawn and SWIS-packed one layer
    at a time on the card (``init_packed_params``, as the launcher's
    ``--packed`` does): the float32 tree never exists whole. Returns (cfg,
    qcfg, params, line): ``line`` reads the seconds, the packed layers' and
    the whole tree's GB, the float32 tree's and ``max_memory_allocated``;
    fails if the peak reaches the float32 tree's size."""
    import torch
    from repro_torch import configs
    from repro_torch.core.swis import QuantConfig
    from repro_torch.models import params as pp
    from repro_torch.models.model import Model
    from repro_torch.serve.quantized import init_packed_params

    cfg = configs.get_config(arch).replace(compute_dtype="float32")
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    qcfg = QuantConfig(method="swis", n_shifts=N_SHIFTS, group_size=GROUP)
    tree = Model(cfg).build()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, stats = init_packed_params(
        tree, qcfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    fp32 = pp.count_params(tree) * 4
    layers = tree_bytes({k: v for k, v in params.items()
                         if k in ("blocks", "tail")})
    total = tree_bytes(params)
    check(peak < fp32, f"{arch}: peak memory {peak / 1e9:.1f} GB: the "
          f"float32 tree ({fp32 / 1e9:.1f} GB) must never be built whole")
    line = (f"drawn and packed layer by layer in {secs:.1f} s: "
            f"{stats['n_packed']} GEMM leaves, layers {layers / 1e9:.3f} GB "
            f"packed, {total / 1e9:.3f} GB with the float32 embeddings "
            f"(float32 tree {fp32 / 1e9:.3f} GB); max_memory_allocated "
            f"{peak / 1e9:.3f} GB")
    return cfg, qcfg, params, line


def moe_init(dev, card):
    """(a) qwen2-moe-a2.7b at its published widths and the first
    ``MOE_LAYERS`` of its layers, random weights from a seed, drawn and
    SWIS-packed one layer at a time on the card: the float32 tree never
    exists whole."""
    cfg, qcfg, params, line = packed_init(dev, MOE_ARCH, MOE_LAYERS)
    print(f"phase 7 (a): {MOE_ARCH} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.moe.n_experts} experts top-{cfg.moe.top_k} "
          f"padded to {cfg.moe.e_total}, expert d_ff {cfg.moe.d_ff_expert}, "
          f"{cfg.moe.n_shared} shared) on {card}: {line}")
    return cfg, qcfg, params


def expert_phase(dev, card, params, cfg):
    """(b) The expert-axis launch against its plain version (dequant then
    einsum) on layer 0's packed expert stacks: decode (M = 4, the rows
    shared by every expert for wi and wg, each expert's own rows for wo)
    and the capacity path's per-expert rows (M = g * cap of the phase-(c)
    prefill: 256 tokens, cap 21), within rtol 1e-5 and atol 1e-5*max|ref|;
    then one decode layer's 3 launches timed beside their bound, the plain
    version and ``torch.bmm`` over the dequantized float32 stack (a
    yardstick: the port never calls it), by CUDA events with the launches
    queued behind a spin kernel and, for comparison, from a profiler
    trace; and the layer's 7 other SWIS GEMMs, to hold the layer's sum
    against the in-engine breakdown of (c)."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.models.layers import packed_weight as packed_weight_of
    from repro_torch.serve.quantized import dequant_leaf

    moe = params["blocks"]["sub0_moe"]["moe"]
    e = cfg.moe.e_total
    d, f = cfg.d_model, cfg.moe.d_ff_expert
    cap = max(int(4 * 64 * cfg.moe.top_k * cfg.moe.capacity_factor
                  / cfg.moe.n_experts), 1)
    g = torch.Generator(device=dev).manual_seed(7)
    cases = [  # (label, leaf, x: (M, K) shared or (E, M, K))
        ("decode wi", "wi", torch.randn((4, d), generator=g, device=dev)),
        ("decode wg", "wg", torch.randn((4, d), generator=g, device=dev)),
        ("decode wo", "wo", torch.randn((e, 4, f), generator=g, device=dev)),
        (f"capacity wi (M {cap})", "wi",
         torch.randn((e, cap, d), generator=g, device=dev)),
    ]
    err = 0.0
    ms = plain_ms = lib_ms = bound_ms = 0.0
    per, profiled = [], []
    for label, name, x in cases:
        leaf = {k: v[0] for k, v in moe[name].items()}  # layer 0's stack
        xe = x if x.ndim == 3 else x[None].expand(e, *x.shape)
        got = ops.swis_matmul_experts(x, leaf)
        want = ref.swis_matmul_experts_ref(
            xe, leaf["sign_plane"], leaf["mask_planes"], leaf["shifts"],
            leaf["scale"], group=GROUP)
        torch.cuda.synchronize()
        top = want.abs().max().item()
        e_max = (got - want).abs().max().item()
        err = max(err, e_max)
        check(torch.allclose(got, want, rtol=1e-5, atol=1e-5 * top),
              f"expert launch {label}: max|err|={e_max:.3g} vs "
              f"max|ref|={top:.3g}")
        if not label.startswith("decode"):
            continue
        w = dequant_leaf(leaf)  # the dense float32 stack
        profiled.append((cuda_ms(lambda: ops.swis_matmul_experts(x, leaf),
                                 iters=50),
                         cuda_ms(lambda: torch.bmm(xe, w), iters=50)))
        t = event_ms(lambda: ops.swis_matmul_experts(x, leaf))
        t_lib = event_ms(lambda: torch.bmm(xe, w))
        del w
        plain_ms += cuda_ms(lambda: ref.swis_matmul_experts_ref(
            xe, leaf["sign_plane"], leaf["mask_planes"], leaf["shifts"],
            leaf["scale"], group=GROUP), iters=3, warmup=1)
        m, k = xe.shape[1:]
        n = leaf["sign_plane"].shape[-1]
        nbytes = (x.numel() * 4 + tree_bytes(leaf) + e * m * n * 4)
        b, by = bound(nbytes, 2 * e * m * k * n)
        ms += t
        lib_ms += t_lib
        bound_ms += b
        per.append(f"{label} {t * 1e3:.1f}/{t_lib * 1e3:.1f}/{b * 1e3:.1f}")
    print(f"phase 7 (b): expert launch against its plain version on layer "
          f"0's stacks (E {e}): decode wi/wg (M 4, shared rows), wo (M 4, "
          f"rows per expert), capacity wi (M {cap}, rows per expert); "
          f"max|err| {err:.3g} (rtol 1e-5, atol 1e-5*max|ref|)")
    print(f"expert launch, one decode layer's 3 stacks on {card} (CUDA "
          f"events, launches queued behind a spin kernel): kernel "
          f"{ms:.4f} ms, torch.bmm over the dequantized float32 stack "
          f"{lib_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms "
          f"({by}); per stack kernel/bmm/bound us: " + ", ".join(per))
    # the same launches summed from a profiler trace, the card's copy rate
    # over the bytes of one stack, and the layer's other 7 SWIS GEMMs (the
    # attention's 4, the shared experts' 3) at M = 4
    src = torch.empty(tree_bytes({k: v[0] for k, v in moe["wi"].items()}),
                      dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    copy = event_ms(lambda: dst.copy_(src))
    print(f"  from the profiler's trace instead, us per stack kernel/bmm: "
          + ", ".join(f"{a * 1e3:.1f}/{b * 1e3:.1f}" for a, b in profiled)
          + f"; a device copy of one stack's {src.numel() / 1e6:.1f} MB "
          f"takes {copy * 1e3:.1f} us ({2 * src.numel() / copy / 1e6:.0f} "
          f"GB/s read + write)")
    del src, dst
    blk = params["blocks"]["sub0_moe"]
    dense2d = [blk["attn"][n]["w"] for n in ("wq", "wk", "wv", "wo")] + [
        moe[n] for n in ("shared_wi", "shared_wg", "shared_wo")]
    t2d = []
    for leaf in dense2d:
        pw = packed_weight_of({k: v[0] for k, v in leaf.items()}, cfg)
        x = torch.randn((4, pw.k), generator=g, device=dev)
        t2d.append(event_ms(lambda: ops.swis_matmul(x, pw)))
    print(f"  the layer's 7 other SWIS GEMMs at M=4 (q/k/v/o 2048x2048, "
          f"shared 2048x5632 x2, 5632x2048), us: "
          + ", ".join(f"{t * 1e3:.1f}" for t in t2d) + f"; a decode "
          f"layer's 10 SWIS launches {(ms + sum(t2d)):.4f} ms, x "
          f"{cfg.n_layers} layers {(ms + sum(t2d)) * cfg.n_layers:.3f} ms")
    # the paged decode launch at qwen2-moe's heads (16 of Dh 128, G 1) over
    # (c)'s arena: 4 rows of 9-10 live blocks of 8 (64 prompt tokens and up
    # to 16 more) of the 12 logical blocks max_len 96 gives
    pg = paged_timing(dev, nb=12, n_blocks=97, live=(10, 10, 9, 10),
                      hkv=cfg.n_kv_heads, g=cfg.n_heads // cfg.n_kv_heads,
                      dh=cfg.head_dim, timer=event_ms)
    print(f"paged_attention {MOE_ARCH} decode launch (B=4, {cfg.n_heads} "
          f"heads of Dh {cfg.head_dim}, G 1, 12 logical blocks, fp32 cache) "
          f"on {card} (CUDA events behind a spin kernel): kernel "
          f"{pg['ms']:.5f} ms, SDPA {pg['library_ms']:.5f} ms, plain "
          f"{pg['plain_ms']:.4f} ms, bound {pg['bound_ms']:.6f} ms "
          f"({pg['bound_by']}); max|err| {pg['max_abs_err']:.3g} (1e-5)")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": by, "max_abs_err": err,
            "paged_decode": pg}


def moe_counts(label, engine, kernels, cfg, experts0):
    """Launches since the last reset against the engine's model calls:
    10 SWIS a layer per model call, 3 of them expert-axis launches (the
    entry's count was ``experts0`` at the reset), and one paged launch a
    layer per arena call. Returns (launches by kernel, model calls,
    expert-axis launches)."""
    counts = {kern.name: kern.launches for kern in kernels}
    n_exp = (kernels[0].entry_launches["swis_matmul_experts_launch"]
             - experts0)
    calls, arena_calls = engine.model_calls(), engine.arena_calls()
    check_dispatches(label, engine)
    per_call = MOE_PER_LAYER * cfg.n_layers
    check(counts["swis_matmul"] == per_call * calls,
          f"{label}: swis_matmul launches {counts['swis_matmul']} != "
          f"{per_call} x {calls} model calls")
    check(n_exp == 3 * cfg.n_layers * calls, f"{label}: {n_exp} expert-axis "
          f"launches != 3 x {cfg.n_layers} x {calls} model calls")
    check(counts["paged_attention"] == cfg.n_layers * arena_calls,
          f"{label}: paged_attention launches {counts['paged_attention']} != "
          f"{cfg.n_layers} x {arena_calls} arena calls")
    return counts, calls, n_exp


def moe_phase(dev, card, kernels):
    """Phase 7: qwen2-moe-a2.7b at full width and ``MOE_LAYERS`` layers on
    the card. (a) init and pack layer by layer; (b) the expert-axis launch against
    its plain version and timed; (c) 8 requests of 64 prompt tokens (4
    sharing a 32-token prefix), 16 greedy tokens each, on 4 slots, block
    mode with paged attention, launches checked per model call, a prefix
    hit, wall and device-busy ms per decode step; (d) greedy tokens at a
    1-layer cut of the same packed weights equal on the card and the CPU
    plain path (2 requests, 8 tokens); (e) the fused step (chunk 32) and
    speculative decode (spec_k 3, 2 of 4 planes) on (c)'s traffic with
    their launches checked, each held to the same path on the CPU plain
    path at the 1-layer cut (tokens, and the draft counts). Returns (the
    launches by path, the expert launch's timing)."""
    import torch
    from repro_torch.serve import ContinuousBatchingEngine, EngineConfig

    cfg, qcfg, params = moe_init(dev, card)
    perf = expert_phase(dev, card, params, cfg)

    # (c) serving at full width
    base = dict(n_slots=4, block_size=8, packed=True, quant_cfg=qcfg,
                use_paged_kernel=True, max_len=96)
    eng = ContinuousBatchingEngine(cfg, params, EngineConfig(**base),
                                   device=dev)
    reqs = prompts(cfg.vocab)
    for kern in kernels:
        kern.launches = 0
    experts0 = kernels[0].entry_launches["swis_matmul_experts_launch"]
    toks, pre, dec = serve(eng, reqs, 16)
    counts, calls, n_exp = moe_counts("7 (c)", eng, kernels, cfg, experts0)
    perf["launches"] = {"7 (c)": n_exp}
    by_path = {"7 (c) qwen2-moe block engine": counts}
    stats = eng.prefix_stats()
    check(stats["hits"] >= 1, "7 (c): no admission hit the prefix cache")
    for t in toks:
        check(len(t) == 16 and int(t.min()) >= 0 and int(t.max()) < cfg.vocab,
              f"7 (c): bad token output {t}")
    dec_ms = 1e3 * sum(dt for dt, _ in dec) / len(dec)
    print(f"phase 7 (c) on {card}: {eng.n_prefill_calls} prefill calls, "
          f"{eng.n_decode_steps} decode steps; launches {counts} ({n_exp} of "
          f"them expert-axis) = {MOE_PER_LAYER} x {cfg.n_layers} SWIS per "
          f"model call and {cfg.n_layers} paged per arena call; prefix "
          f"cache {stats['hits']} hits of {stats['lookups']} lookups; "
          f"prefill steps {len(pre)} at {1e3 * sum(pre) / len(pre):.1f} "
          f"ms/step, decode-only steps {len(dec)} at {dec_ms:.2f} ms/step")
    breakdown(eng, reqs[:4])
    del eng

    # (d) and (e)'s CPU checks: a 1-layer cut, 2 requests of 8 tokens
    cfg1, cut, cut_cpu = layer_cut(cfg, params, n_layers=1)
    short = [(p, 8) for p in reqs[:2]]
    t0 = time.perf_counter()
    got = drive(ContinuousBatchingEngine(cfg1, cut, EngineConfig(**base),
                                         device=dev), short)[0]
    cpu = ContinuousBatchingEngine(cfg1, cut_cpu, EngineConfig(**base),
                                   device="cpu")
    want = drive(cpu, short)[0]
    same_tokens("7 (d) 1-layer cut vs the CPU plain path", got, want, short,
                [("card", cpu.model, cut, dev),
                 ("cpu", cpu.model, cut_cpu, "cpu")])
    print(f"phase 7 (d): greedy tokens at a 1-layer cut (2 requests, 8 "
          f"tokens) equal on the card and the CPU plain path (CPU "
          f"{time.perf_counter() - t0:.1f} s)")

    # (e) the fused step and speculative decode at full width; their CPU
    # checks at the 1-layer cut take 4 tokens
    traffic = [(p, 16) for p in reqs]
    short = [(p, 4) for p in reqs[:2]]
    paths = [("7 (e) fused", dict(prefill_chunk=32, fused_step=True)),
             ("7 (e) spec", dict(spec_decode=True, spec_k=3,
                                 draft_slices=DRAFT_SLICES))]
    for label, opts in paths:
        ecfg = EngineConfig(**{**base, **opts})
        eng = ContinuousBatchingEngine(cfg, params, ecfg, device=dev)
        for kern in kernels:
            kern.launches = 0
        experts0 = kernels[0].entry_launches["swis_matmul_experts_launch"]
        got, steps, wall, _ = drive(eng, traffic)
        counts, calls, n_exp = moe_counts(label, eng, kernels, cfg, experts0)
        perf["launches"][label] = n_exp
        # a fresh engine repeats the tokens: repeated arena writes carry
        # their last values, so pad and idle rows, which read the trash
        # block and are routed, route alike (after reset() the stale trash
        # block, left in place as in the reference, would route them anew)
        again = ContinuousBatchingEngine(cfg, params, ecfg, device=dev)
        same_tokens(f"{label} on a fresh engine", drive(again, traffic)[0],
                    got, traffic, [])
        del again
        by_path[label] = counts
        same = sum(bool((a == b).all()) for a, b in zip(got, toks))
        extra = ""
        if eng.spec_decode:
            extra = (f"; spec accepted {eng.spec_accepted} of "
                     f"{eng.spec_proposed} drafts")
        # the same path at the 1-layer cut, on the card and the CPU
        t0 = time.perf_counter()
        card1 = ContinuousBatchingEngine(cfg1, cut, ecfg, device=dev)
        got1 = drive(card1, short)[0]
        cpu1 = ContinuousBatchingEngine(cfg1, cut_cpu, ecfg, device="cpu")
        want1 = drive(cpu1, short)[0]
        same_tokens(f"{label} (1-layer cut) vs the CPU plain path", got1,
                    want1, short, [("card", cpu1.model, cut, dev),
                                   ("cpu", cpu1.model, cut_cpu, "cpu")])
        spec = ((card1.spec_proposed, card1.spec_accepted),
                (cpu1.spec_proposed, cpu1.spec_accepted))
        check(spec[0] == spec[1], f"{label} (1-layer cut): drafts (proposed, "
              f"accepted) {spec[0]} on the card, {spec[1]} on the CPU")
        print(f"phase {label} on {card}: {steps} steps at {wall:.2f} ms/step "
              f"wall, {calls} model calls (mixed {eng.n_mixed_steps}, draft "
              f"{eng.n_draft_steps}, verify {eng.n_verify_steps}); launches "
              f"{counts}{extra}; tokens equal on a fresh engine; {same} of "
              f"{len(toks)} requests' tokens equal to (c)'s plain decode path "
              f"(multi-token launches take the capacity path); at the "
              f"1-layer cut (2 requests, 4 tokens) tokens"
              f"{' and drafts ' + str(spec[0]) if eng.spec_decode else ''} "
              f"equal to the CPU plain path's (CPU "
              f"{time.perf_counter() - t0:.1f} s)")
        del eng, card1
    del cut, cut_cpu, params
    return by_path, perf


# -- phase 8: the recurrent families at full width -------------------------------

GRIFFIN_ARCH, MAMBA_ARCH = "recurrentgemma-2b", "mamba2-2.7b"
# SWIS launches a layer, by block kind: rec's in_x, in_gate and out and its
# MLP's wi, wg and wo; attn_local's q, k, v and o and its MLP's three;
# mamba's in_proj and out_proj
SWIS_PER_KIND = {"rec": 6, "attn_local": 7, "mamba": 2}
# phase 8's depths (cut to make room for phase 9, as far as packed_init's
# peak check stays meaningful): Griffin's first 4 units and its 2 tail
# layers, Mamba2's first 24 layers
RECURRENT_DEPTH = {GRIFFIN_ARCH: 14, MAMBA_ARCH: 24}
# per model call, by (arch, depth): Griffin at 14 layers has 10 rec and 4
# attn_local layers, at its full 26 (the launcher's) 18 and 8; Mamba2 at
# 24 layers 24 mamba layers
SWIS_PER_CALL = {(GRIFFIN_ARCH, 14): 10 * 6 + 4 * 7,
                 (GRIFFIN_ARCH, 26): 18 * 6 + 8 * 7, (MAMBA_ARCH, 24): 24 * 2}
# (K, N) of one decode layer's GEMMs at the published widths, in launch order
RECURRENT_LAYERS = {
    "recurrentgemma-2b rec": [(2560, 2560)] * 3 + [(2560, 7680)] * 2
    + [(7680, 2560)],
    "recurrentgemma-2b attn_local": [(2560, 2560), (2560, 256), (2560, 256),
                                     (2560, 2560), (2560, 7680), (2560, 7680),
                                     (7680, 2560)],
    "mamba2-2.7b mamba": [(2560, 10576), (5120, 2560)],
}
WINDOW_PROMPT = 2100  # past recurrentgemma-2b's 2048-token window
MAMBA_LONG_PROMPT = 600  # three 256-token SSD chunks, the last padded


def swis_per_call(model):
    """SWIS launches of one model call, counted from the model's layers."""
    kinds = list(model.unit) * model.n_units + list(model.tail)
    return sum(SWIS_PER_KIND[k] for k in kinds)


def recurrent_kernel_phase(dev, card):
    """(b) The SWIS kernel at the recurrent families' decode layers (M = 4)
    and at Mamba2's in_proj at the prefill row count (M = 256): each GEMM
    held against the plain version (rtol 1e-5, atol 1e-5*max|ref|), and
    each layer timed by CUDA events behind a spin kernel beside its bound,
    the plain version and ``torch.matmul`` on the dense fp32 weights.
    Returns {label: timing}."""
    out = {}
    shapes = [(label, 4, gemms) for label, gemms in RECURRENT_LAYERS.items()]
    shapes.append(("mamba2-2.7b in_proj prefill", 256, [(2560, 10576)]))
    for label, m, gemms in shapes:
        p = swis_layer_timing(dev, m, gemms=gemms, timer=event_ms)
        out[f"{label} M={m}"] = p
        print(f"phase 8 (b): swis_matmul {label} ({len(gemms)} GEMMs at "
              f"M={m}, fp32 x) on {card} (CUDA events behind a spin kernel): "
              f"kernel {p['ms']:.4f} ms, torch.matmul {p['library_ms']:.4f} "
              f"ms, plain {p['plain_ms']:.4f} ms, bound {p['bound_ms']:.5f} "
              f"ms ({p['bound_by']}); max|err| {p['max_abs_err']:.3g} against "
              f"the plain version (rtol 1e-5, atol 1e-5*max|ref|)")
    return out


def recurrent_counts(label, engine, kernels, per_call, calls=None):
    """Launches since the last reset: ``per_call`` SWIS a model call (the
    engine's, or ``calls``) and no paged launch (no block arena)."""
    counts = {kern.name: kern.launches for kern in kernels}
    if calls is None:
        check_dispatches(label, engine)
        calls = engine.model_calls()
    check(counts == {"swis_matmul": per_call * calls, "paged_attention": 0},
          f"{label}: launches {counts} != {per_call} SWIS x {calls} model "
          f"calls and no paged launch")
    return counts


def recurrent_serve(dev, card, kernels, label, cfg, qcfg, params, traffic,
                    max_len):
    """The contiguous fallback at full width: ``traffic``
    [(prompt, n_tokens)] through ``ContinuousBatchingEngine`` on 4 slots
    with ``prefix_cache=True`` asked for (the engine must fall back:
    no prefix cache, contiguous rows, no bucket padding), launches per
    model call checked, wall ms per step and a profiled decode window;
    then ``DecodeEngine`` at T 0.7 against the continuous engine's
    ``generate`` on 4 of the 64-token prompts. Returns (engine config,
    launches by path)."""
    import numpy as np
    import torch
    from repro_torch.serve import (ContinuousBatchingEngine, DecodeEngine,
                                   EngineConfig)

    ecfg = EngineConfig(n_slots=4, max_len=max_len, packed=True,
                        quant_cfg=qcfg, prefix_cache=True)
    eng = ContinuousBatchingEngine(cfg, params, ecfg, device=dev)
    check(eng.prefix_cache is None and eng.cache.block_size is None
          and not eng.bucket_prompts, f"{label}: the engine did not fall "
          f"back to contiguous rows without bucket padding")
    per_call = swis_per_call(eng.model)
    want = SWIS_PER_CALL[(cfg.name, cfg.n_layers)]
    check(per_call == want, f"{label}: {per_call} SWIS GEMMs a model call, "
          f"expected {want}")
    for kern in kernels:
        kern.launches = 0
    toks, steps, wall, _ = drive(eng, traffic)
    counts = recurrent_counts(label, eng, kernels, per_call)
    by_path = {f"{label} contiguous engine": counts}
    for t, (_, n) in zip(toks, traffic):
        check(len(t) == n and int(t.min()) >= 0 and int(t.max()) < cfg.vocab,
              f"{label}: bad token output {t}")
    print(f"phase {label} on {card}: {len(traffic)} requests, {steps} steps "
          f"at {wall:.2f} ms/step wall; dispatches prefill "
          f"{eng.n_prefill_calls}, decode {eng.n_decode_steps}; launches "
          f"{counts} = {per_call} SWIS per model call, no paged launch; "
          f"prefix cache off, contiguous rows, no bucket padding")
    four = [p for p, _ in traffic if len(p) == 64][:4]
    breakdown(eng, four)

    batch = np.stack(four)
    dec = DecodeEngine(cfg, params, max_len=max_len, batch=4, packed=True,
                       quant_cfg=qcfg, device=dev)
    for kern in kernels:
        kern.launches = 0
    t0 = time.perf_counter()
    out = dec.generate(batch, 16, temperature=0.7, seed=5)
    torch.cuda.synchronize()
    dec_wall = (time.perf_counter() - t0) * 1e3 / 16
    by_path[f"{label} DecodeEngine T=0.7"] = recurrent_counts(
        f"{label} DecodeEngine", dec, kernels, per_call, calls=16)
    same_tokens(f"{label} DecodeEngine T=0.7 vs ContinuousBatchingEngine."
                f"generate", list(out[:, 64:]),
                list(eng.generate(batch, 16, temperature=0.7,
                                  seed=5)[:, 64:]),
                [(p, 16) for p in batch], [])
    print(f"  {label} DecodeEngine T=0.7: 16 lockstep steps at {dec_wall:.2f} "
          f"ms/step wall, tokens equal to ContinuousBatchingEngine.generate")
    return ecfg, by_path


def cpu_cut_check(dev, label, cfg, params, ecfg, traffic, n_layers):
    """``traffic`` at an ``n_layers`` cut of ``params``: greedy tokens on
    the card equal the CPU plain path's."""
    from repro_torch.serve import ContinuousBatchingEngine

    t0 = time.perf_counter()
    cfgc, cut, cut_cpu = layer_cut(cfg, params, n_layers)
    got = drive(ContinuousBatchingEngine(cfgc, cut, ecfg, device=dev),
                traffic)[0]
    cpu = ContinuousBatchingEngine(cfgc, cut_cpu, ecfg, device="cpu")
    want = drive(cpu, traffic)[0]
    same_tokens(f"{label} ({n_layers}-layer cut) vs the CPU plain path", got,
                want, traffic, [("card", cpu.model, cut, dev),
                                ("cpu", cpu.model, cut_cpu, "cpu")])
    print(f"  {label}: {len(traffic)} requests (prompts of "
          f"{sorted({len(p) for p, _ in traffic})} tokens) at a {n_layers}-"
          f"layer cut ({cfgc.n_layers} layers: {depth_desc(cfgc)}): greedy "
          f"tokens equal on the card and the CPU plain path (CPU "
          f"{time.perf_counter() - t0:.1f} s)")


def depth_desc(cfg):
    """'8 x rec/rec/attn_local + tail rec/rec': a config's layers."""
    from repro_torch.models.model import Model

    m = Model(cfg)
    return (f"{m.n_units} x {'/'.join(m.unit)}"
            + (f" + tail {'/'.join(m.tail)}" if m.tail else ""))


def griffin_phase(dev, card, kernels):
    """Phase 8 (a)-(d) and (f) on recurrentgemma-2b at its published widths,
    at its first ``RECURRENT_DEPTH`` layers (4 units and the 2 tail layers;
    the launcher (f) draws its own weights at the full 26). Returns
    (launches by path, (b)'s kernel timings)."""
    import numpy as np
    import torch
    from repro_torch.launch import serve as launcher
    from repro_torch.serve import ContinuousBatchingEngine, EngineConfig

    cfg, qcfg, params, line = packed_init(dev, GRIFFIN_ARCH,
                                          RECURRENT_DEPTH[GRIFFIN_ARCH])
    gc_ = cfg.griffin
    print(f"phase 8 (a): {GRIFFIN_ARCH} ({cfg.n_layers} layers: "
          f"{depth_desc(cfg)}; d_model {cfg.d_model}, lru_width "
          f"{gc_.lru_width}, {cfg.n_heads} heads over {cfg.n_kv_heads} KV "
          f"head of {cfg.head_dim}, window {gc_.window}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab}, tied embeddings) on {card}: {line}")
    perf = recurrent_kernel_phase(dev, card)

    # (c) phase 4's traffic through the contiguous fallback
    reqs = prompts(cfg.vocab)
    _, by_path = recurrent_serve(dev, card, kernels, "8 (c)", cfg, qcfg,
                                 params, [(p, 32) for p in reqs], max_len=128)

    # (d) one prompt past the local-attention window: the ring wraps
    long = np.random.default_rng(4).integers(
        0, cfg.vocab, WINDOW_PROMPT).astype(np.int32)
    wcfg = EngineConfig(n_slots=1, max_len=2176, packed=True, quant_cfg=qcfg)
    eng = ContinuousBatchingEngine(cfg, params, wcfg, device=dev)
    for kern in kernels:
        kern.launches = 0
    toks, pre, dec = serve(eng, [long], 16)
    by_path["8 (d) past the window"] = recurrent_counts(
        "8 (d)", eng, kernels, SWIS_PER_CALL[(GRIFFIN_ARCH, cfg.n_layers)])
    pos = eng.cache.tree["blocks"]["sub2_attn_local"]["pos"][:, 0].cpu()
    w = gc_.window
    last = WINDOW_PROMPT + 16 - 2  # the last fed token's position
    check(pos.shape[-1] == w and int(pos.max()) == last
          and int(pos.min()) == last - w + 1
          and bool((pos % w == torch.arange(w)).all()),
          f"8 (d): the local ring does not hold the last {w} positions in "
          f"ring order (pos {int(pos.min())}..{int(pos.max())})")
    check(len(toks[0]) == 16, f"8 (d): {len(toks[0])} tokens")
    print(f"phase 8 (d) on {card}: a {WINDOW_PROMPT}-token prompt, 16 "
          f"tokens, max_len 2176: {eng.n_prefill_calls} prefill and "
          f"{eng.n_decode_steps} decode calls; the prefill step (which also "
          f"decodes) {1e3 * sum(pre):.1f} ms, {len(dec)} decode-only steps "
          f"at {1e3 * sum(d for d, _ in dec) / len(dec):.2f} ms/step; "
          f"every attn_local ring ({w} slots) holds positions "
          f"{last - w + 1}..{last} with slot == pos % {w}")
    del eng

    # the CPU plain path at a 4-layer cut: two of (c)'s prompts and (d)'s
    cpu_cut_check(dev, "8 (c) and (d)", cfg, params,
                  EngineConfig(n_slots=3, max_len=2176, packed=True,
                               quant_cfg=qcfg),
                  [(reqs[0], 6), (reqs[1], 6), (long, 6)], 4)

    # (f) the launcher, in this process: it draws and packs its own
    # weights one layer at a time, as a user's run does
    del params
    gc.collect()
    argv = ["--arch", GRIFFIN_ARCH, "--packed", "--requests", "4",
            "--prompt-len", "64", "--tokens", "16", "--n-slots", "4",
            "--metrics-every", "0"]
    for kern in kernels:
        kern.launches = 0
    t0 = time.perf_counter()
    report, eng = launcher.run(launcher.parse_args(argv))
    by_path["8 (f) launcher"] = recurrent_counts(
        "8 (f) launcher", eng, kernels, SWIS_PER_CALL[(GRIFFIN_ARCH, 26)])
    # 19 stacked GEMM leaves (6 + 6 + 7 a unit) and 12 in the 2 tail layers
    check(report["packed_weights"] == 31, f"8 (f): the launcher packed "
          f"{report['packed_weights']} GEMM leaves, expected 31")
    print(f"phase 8 (f) on {card}: python -m repro_torch.launch.serve "
          f"{' '.join(argv)} in {time.perf_counter() - t0:.1f} s (its own "
          f"init and pack included); report {json.dumps(report)}")
    del eng
    return by_path, perf


def mamba_phase(dev, card, kernels):
    """Phase 8 (a) and (e) on mamba2-2.7b at its published widths, at its
    first ``RECURRENT_DEPTH`` layers. Returns the launches by path."""
    import numpy as np
    from repro_torch.serve import EngineConfig

    cfg, qcfg, params, line = packed_init(dev, MAMBA_ARCH,
                                          RECURRENT_DEPTH[MAMBA_ARCH])
    mc = cfg.mamba2
    print(f"phase 8 (a): {MAMBA_ARCH} ({cfg.n_layers} layers: "
          f"{depth_desc(cfg)}; d_model {cfg.d_model}, d_inner "
          f"{mc.expand * cfg.d_model}, {mc.expand * cfg.d_model // mc.head_dim}"
          f" heads of {mc.head_dim}, d_state {mc.d_state}, chunk {mc.chunk}, "
          f"vocab {cfg.padded_vocab}) on {card}: {line}")
    reqs = prompts(cfg.vocab)
    long = np.random.default_rng(5).integers(
        0, cfg.vocab, MAMBA_LONG_PROMPT).astype(np.int32)
    pad = -MAMBA_LONG_PROMPT % mc.chunk
    print(f"  the {MAMBA_LONG_PROMPT}-token prompt prefills as "
          f"{(MAMBA_LONG_PROMPT + pad) // mc.chunk} chunks of {mc.chunk}, "
          f"the last with {pad} dt = 0 padding steps")
    _, by_path = recurrent_serve(
        dev, card, kernels, "8 (e)", cfg, qcfg, params,
        [(p, 32) for p in reqs] + [(long, 16)], max_len=640)
    cpu_cut_check(dev, "8 (e)", cfg, params,
                  EngineConfig(n_slots=3, max_len=640, packed=True,
                               quant_cfg=qcfg),
                  [(reqs[0], 6), (reqs[1], 6), (long, 6)], 2)
    del params
    return by_path


# -- phase 9: the VLM and encoder families at full width --------------------------

VLM_ARCH, ENC_ARCH = "llama-3.2-vision-11b", "hubert-xlarge"
# SWIS launches of one model call: 7 a layer (q/k/v/o, MLP in/gate/out) for
# the VLM's 40 layers; a call whose batch carries patches adds xattn's 4 in
# each of its 8 self_cross layers; hubert's 48 enc layers have 6 (no GLU)
VLM_PER_CALL, VLM_PATCH_EXTRA, ENC_PER_APPLY = 40 * 7, 8 * 4, 48 * 6
XGATE = 0.5  # the reference inits xgate to 0: tanh(0) shuts the image out
VLM_CUT = 5  # the CPU checks' depth: one (attn x 4, self_cross) unit
# (K, N) of the shapes phase 9 (b) holds and times, in launch order
VLM_SELF_LAYER = [(4096, 4096), (4096, 1024), (4096, 1024), (4096, 4096),
                  (4096, 14336), (4096, 14336), (14336, 4096)]
VLM_XATTN_KV = [(4096, 1024), (4096, 1024)]  # wk, wv over 4 x 1024 patches
ENC_LAYER = [(1280, 1280)] * 4 + [(1280, 5120), (5120, 1280)]


def vlm_traffic(cfg, dev, seed=6):
    """(c)'s 8 requests of 64 prompt tokens, 16 tokens each: 4 with their
    own patches (1024 x 4096 fp32 from the seed, on the card) and 4
    text-only. Text 0 and text 3 share a 32-token prefix, and so does image
    3, which must not hit it; text 3 arrives last, after text 0 has
    committed. Returns [(prompt, 16, extra or None)]."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    shared = rng.integers(0, cfg.vocab, 32)
    out = []
    for kind in ("text", "image", "image", "text", "image", "image", "text",
                 "text"):
        p = rng.integers(0, cfg.vocab, 64).astype(np.int32)
        n_img = sum(e is not None for _, _, e in out)
        if len(out) in (0, 7) or n_img == 3 and kind == "image":
            p[:32] = shared
        extra = None
        if kind == "image":
            extra = {"patches": torch.randn(
                (cfg.vlm.n_patches, cfg.vlm.vision_dim), generator=g,
                device=dev)}
        out.append((p, 16, extra))
    return out


def patch_calls(engine):
    """Count the engine's prefill launches whose batch carries patches (the
    only launches that run cross-attention): wraps the model's two prefill
    entry points; returns the live counter."""
    seen = {"calls": 0}
    model = engine.model
    for name in ("prefill_bucketed", "prefill_chunk"):
        fn = getattr(model, name)

        def counted(params, batch, *a, _fn=fn, **kw):
            seen["calls"] += "patches" in batch
            return _fn(params, batch, *a, **kw)

        setattr(model, name, counted)
    return seen


def vlm_counts(label, engine, kernels, seen):
    """Launches since the last reset against the engine's model calls: 280
    SWIS a call plus 32 for each call that carried patches, every one
    through the 2-D entry point, and 40 paged a call over the arena."""
    counts = {kern.name: kern.launches for kern in kernels}
    calls, arena_calls = engine.model_calls(), engine.arena_calls()
    check_dispatches(label, engine)
    want = VLM_PER_CALL * calls + VLM_PATCH_EXTRA * seen["calls"]
    check(counts["swis_matmul"] == want, f"{label}: swis_matmul launches "
          f"{counts['swis_matmul']} != {VLM_PER_CALL} x {calls} model calls "
          f"+ {VLM_PATCH_EXTRA} x {seen['calls']} calls with patches")
    check(counts["paged_attention"] == 40 * arena_calls, f"{label}: "
          f"paged_attention launches {counts['paged_attention']} != 40 x "
          f"{arena_calls} arena calls")
    return counts


def paged_vlm_phase(dev, card):
    """(b) Paged attention at the VLM's heads (32 over 8 KV heads, G 4, Dh
    128): B 4 over 16 logical blocks, decode (Sq 1) and Sq 4 with a zero
    q_lens, 3 cache dtypes, every row against the plain version (1e-5) and
    repeat runs bit-identical; the decode launch timed beside SDPA. The
    kernel is one template a cache dtype (phase 2's ``-Xptxas -v`` lines);
    the shape sets only its shared memory, printed here."""
    import torch
    from repro_torch.kernels import paged_attention as pa

    err = 0.0
    for sq, q_lens in ((1, None), (4, [4, 0, 2, 1])):
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            q, k, v, pos, tables, q_pos = arena(dev, hkv=8, g=4, dh=128,
                                                sq=sq, seed=128 + sq)
            k, v = k.to(dt), v.to(dt)
            ql = None if q_lens is None else torch.tensor(
                q_lens, dtype=torch.int32, device=dev)
            got = pa.paged_attention_decode(q, k, v, pos, tables, q_pos,
                                            q_lens=ql)
            again = pa.paged_attention_decode(q, k, v, pos, tables, q_pos,
                                              q_lens=ql)
            check(torch.equal(got, again), f"paged_attention {VLM_ARCH} "
                  f"heads Sq={sq} {dt}: repeat run differs")
            want = plain_paged(q, k, v, pos, tables, q_pos, ql, None)
            torch.cuda.synchronize()
            e = (got - want).abs().max().item()
            err = max(err, e)
            check(bool(torch.isfinite(got).all()) and torch.allclose(
                got, want, rtol=1e-5, atol=1e-5), f"paged_attention "
                f"{VLM_ARCH} heads (Hkv 8, G 4, Dh 128) Sq={sq} {dt}: "
                f"max|err|={e:.3g} (1e-5)")
    lib = pa.KERNEL.lib()
    smem = {sq: lib.paged_attention_smem_bytes(0, sq * 4, 128, 8, 16)
            for sq in (1, 4, 32)}
    p = paged_timing(dev, nb=16, n_blocks=97, live=(12, 12, 11, 12), hkv=8,
                     g=4, dh=128, timer=event_ms)
    p["max_abs_err"] = max(p["max_abs_err"], err)
    ptxas = [ln.strip() for ln in pa.KERNEL.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"phase 9 (b): paged_attention {VLM_ARCH} decode launch (B=4, 32 "
          f"heads over 8, G 4, Dh 128, 16 logical blocks, fp32 cache) on "
          f"{card} (CUDA events behind a spin kernel): kernel "
          f"{p['ms']:.5f} ms, SDPA {p['library_ms']:.5f} ms, plain "
          f"{p['plain_ms']:.4f} ms, bound {p['bound_ms']:.6f} ms "
          f"({p['bound_by']}); Sq 1 and 4 x 3 cache dtypes within 1e-5 of the "
          f"plain version on every row (max|err| {err:.3g}), repeats "
          f"bit-identical; dynamic shared memory at 16 logical blocks, fp32 "
          f"cache: " + ", ".join(f"Sq {k} {v} B" for k, v in smem.items())
          + "; the kernel's -Xptxas -v lines (one template per cache dtype): "
          + " | ".join(ptxas))
    return p


def vlm_kernel_phase(dev, card):
    """(b) The SWIS kernel at the new families' shapes, each held against
    the plain version (rtol 1e-5, atol 1e-5*max|ref|) and timed by CUDA
    events behind a spin kernel beside its bound, the plain version and
    ``torch.matmul``: one VLM self layer's 7 GEMMs at M = 4 (decode),
    xattn's wk/wv at M = 4096 (4 images of 1024 patches) and one hubert
    layer's 6 GEMMs at M = 2000 (4 clips of 500 frames); then paged
    attention at the VLM's heads. Returns {label: timing}."""
    out = {}
    for label, m, gemms in ((f"{VLM_ARCH} self layer", 4, VLM_SELF_LAYER),
                            (f"{VLM_ARCH} xattn wk/wv", 4096, VLM_XATTN_KV),
                            (f"{ENC_ARCH} layer", 2000, ENC_LAYER)):
        t0 = time.perf_counter()
        p = swis_layer_timing(dev, m, gemms=gemms, timer=event_ms)
        out[f"{label} M={m}"] = p
        print(f"phase 9 (b): swis_matmul {label} ({len(gemms)} GEMMs at "
              f"M={m}, fp32 x) on {card} (CUDA events behind a spin kernel): "
              f"kernel {p['ms']:.4f} ms, torch.matmul {p['library_ms']:.4f} "
              f"ms, plain {p['plain_ms']:.4f} ms, bound {p['bound_ms']:.5f} "
              f"ms ({p['bound_by']}); max|err| {p['max_abs_err']:.3g} against "
              f"the plain version (rtol 1e-5, atol 1e-5*max|ref|) "
              f"[{time.perf_counter() - t0:.1f} s]")
    out["paged"] = paged_vlm_phase(dev, card)
    return out


def vlm_phase(dev, card, kernels):
    """Phase 9 (a)-(d) and (f) on llama-3.2-vision-11b at its published
    widths and depth (40 layers: 8 units of attn x 4 and self_cross), with
    ``xgate`` set to 0.5 after packing (a scalar, never packed). (c) 8
    requests on 4 slots, block mode with paged attention, max_len 128, 16
    greedy tokens each: launches per model call, a prefix hit on the text
    requests and none on the image requests, an image request's first
    logits moved by its patches, wall and device-busy ms per decode step;
    (d) the fused step (chunk 32) and speculative decode (2-plane drafts)
    on the same traffic, launches checked, and each at the one-unit cut
    (2 requests, one with patches, 4 tokens) equal to the CPU plain path,
    draft counts too; (f) the launcher serving text requests on these
    weights. Returns (launches by path, phase 9's seconds by step)."""
    import numpy as np
    import torch
    from repro_torch.launch import serve as launcher
    from repro_torch.serve import ContinuousBatchingEngine, EngineConfig
    from repro_torch.serve import trace as tr

    secs = {}
    t0 = time.perf_counter()
    cfg, qcfg, params, line = packed_init(dev, VLM_ARCH)
    for key, blk in params["blocks"].items():
        if "xgate" in blk:
            blk["xgate"].fill_(XGATE)
    secs["9 (a) VLM"] = time.perf_counter() - t0
    print(f"phase 9 (a): {VLM_ARCH} ({cfg.n_layers} layers: "
          f"{depth_desc(cfg)}; d_model {cfg.d_model}, {cfg.n_heads} heads "
          f"over {cfg.n_kv_heads} of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}, {cfg.vlm.n_patches} patches of "
          f"{cfg.vlm.vision_dim}) on {card}: {line}; xgate set to {XGATE}")

    # (c) serving at full width and depth
    t0 = time.perf_counter()
    base = dict(n_slots=4, block_size=8, packed=True, quant_cfg=qcfg,
                use_paged_kernel=True, max_len=128)
    eng = ContinuousBatchingEngine(cfg, params, EngineConfig(**base),
                                   device=dev)
    traffic = vlm_traffic(cfg, dev)
    images = [i for i, (_, _, ex) in enumerate(traffic) if ex is not None]
    seen = patch_calls(eng)
    for kern in kernels:
        kern.launches = 0
    toks, steps, wall, _ = drive(eng, traffic)
    counts = vlm_counts("9 (c)", eng, kernels, seen)
    by_path = {"9 (c) VLM block engine": counts}
    hit = {e.rid for e in eng.tracer.events() if e.kind == tr.PREFIX_HIT}
    stats = eng.prefix_stats()
    check(hit and not hit & set(images), f"9 (c): prefix hits "
          f"on requests {sorted(hit)}; the image requests {images} must "
          f"never hit and a text request must")
    for t in toks:
        check(len(t) == 16 and int(t.min()) >= 0 and int(t.max()) < cfg.vocab,
              f"9 (c): bad token output {t}")
    # the image moves an image request's first-token logits
    p0, _, ex0 = traffic[images[0]]
    batch = {"tokens": torch.as_tensor(p0, device=dev).long()[None]}
    plain = eng.model.apply(eng.params, batch, last_only=True)[0][0, -1]
    with_p = eng.model.apply(eng.params, dict(batch, patches=ex0["patches"][
        None]), last_only=True)[0][0, -1]
    moved = (with_p - plain).abs().max().item()
    check(moved > 1e-3 * plain.abs().max().item(), f"9 (c): the patches moved "
          f"the first-token logits by only {moved:.3g}")
    # the engine's first token is the patched forward's argmax (up to float
    # noise between a batch of 2 image rows and this one row)
    first = int(toks[images[0]][0])
    top = with_p.max().item()
    check(with_p[first].item() >= top - 1e-4 * with_p.abs().max().item(),
          f"9 (c): the engine's first token {first} is not the patched "
          f"forward's argmax {int(with_p.argmax())}")
    flips = int(with_p.argmax()) != int(plain.argmax())
    print(f"phase 9 (c) on {card}: {len(traffic)} requests ({len(images)} "
          f"with patches), {steps} steps at {wall:.2f} ms/step wall; "
          f"dispatches prefill {eng.n_prefill_calls} ({seen['calls']} with "
          f"patches), decode {eng.n_decode_steps}; launches {counts} = "
          f"{VLM_PER_CALL} SWIS a model call + {VLM_PATCH_EXTRA} a call with "
          f"patches, 40 paged an arena call; prefix cache {stats['hits']} "
          f"hits of {stats['lookups']} lookups, on requests {sorted(hit)} "
          f"(the images {images} never hit); the patches move an image "
          f"request's first-token logits by {moved:.4g} (max|logit| "
          f"{plain.abs().max().item():.4g}; argmax "
          f"{'changed' if flips else 'unchanged'}), and the engine's first "
          f"token {first} is the patched forward's")
    breakdown(eng, [p for p, _, ex in traffic if ex is None])
    del eng
    secs["9 (c)"] = time.perf_counter() - t0

    # (d) the fused step and speculative decode at full width and depth,
    # then at the one-unit cut on the card and the CPU plain path
    t0 = time.perf_counter()
    cfgc, cut, cut_cpu = layer_cut(cfg, params, n_layers=VLM_CUT)
    short = [(p, 4, ex) for p, _, ex in (traffic[images[0]], traffic[0])]
    short_cpu = [(p, n, ex and {"patches": ex["patches"].cpu()})
                 for p, n, ex in short]
    paths = [("9 (d) fused", dict(prefill_chunk=32, fused_step=True)),
             ("9 (d) spec", dict(spec_decode=True, spec_k=3,
                                 draft_slices=DRAFT_SLICES))]
    cpu_secs = 0.0
    for label, opts in paths:
        ecfg = EngineConfig(**{**base, **opts})
        eng = ContinuousBatchingEngine(cfg, params, ecfg, device=dev)
        seen = patch_calls(eng)
        for kern in kernels:
            kern.launches = 0
        got, steps, wall, _ = drive(eng, traffic)
        counts = vlm_counts(label, eng, kernels, seen)
        by_path[label] = counts
        same = sum(bool((a == b).all()) for a, b in zip(got, toks))
        extra = (f"; spec accepted {eng.spec_accepted} of "
                 f"{eng.spec_proposed} drafts" if eng.spec_decode else "")
        print(f"phase {label} on {card}: {steps} steps at {wall:.2f} ms/step "
              f"wall, {eng.model_calls()} model calls (prefill "
              f"{eng.n_prefill_calls}, chunk {eng.n_chunk_calls}, mixed "
              f"{eng.n_mixed_steps}, decode {eng.n_decode_steps}, draft "
              f"{eng.n_draft_steps}, verify {eng.n_verify_steps}; "
              f"{seen['calls']} with patches); launches {counts}{extra}; "
              f"{same} of {len(toks)} requests' tokens equal to (c)'s")
        del eng
        card1 = ContinuousBatchingEngine(cfgc, cut, ecfg, device=dev)
        got1 = drive(card1, short)[0]
        t1 = time.perf_counter()
        cpu1 = ContinuousBatchingEngine(cfgc, cut_cpu, ecfg, device="cpu")
        want1 = drive(cpu1, short_cpu)[0]
        cpu_secs += time.perf_counter() - t1
        same_tokens(f"{label} ({VLM_CUT}-layer cut) vs the CPU plain path",
                    got1, want1, short, [])
        spec = ((card1.spec_proposed, card1.spec_accepted),
                (cpu1.spec_proposed, cpu1.spec_accepted))
        check(spec[0] == spec[1], f"{label} ({VLM_CUT}-layer cut): drafts "
              f"(proposed, accepted) {spec[0]} on the card, {spec[1]} on the "
              f"CPU")
        drafts = (f" and drafts {spec[0]}" if opts.get("spec_decode")
                  else "")
        print(f"  {label} at a {VLM_CUT}-layer cut ({depth_desc(cfgc)}), 2 "
              f"requests (one with patches), 4 tokens: tokens{drafts} "
              f"equal on the card and the CPU plain path (CPU "
              f"{time.perf_counter() - t1:.1f} s)")
        del card1, cpu1
    del cut, cut_cpu
    secs["9 (d)"] = time.perf_counter() - t0
    secs["9 (d) CPU"] = cpu_secs

    # (f) the launcher in this process, on these packed weights: text
    # requests, the gather path
    t0 = time.perf_counter()
    argv = ["--arch", VLM_ARCH, "--packed", "--requests", "4",
            "--prompt-len", "64", "--tokens", "16", "--n-slots", "4",
            "--metrics-every", "0"]
    for kern in kernels:
        kern.launches = 0
    report, eng = launcher.run(launcher.parse_args(argv), params=params)
    calls = eng.model_calls()
    counts = {kern.name: kern.launches for kern in kernels}
    check_dispatches("9 (f) launcher", eng)
    check(counts == {"swis_matmul": VLM_PER_CALL * calls,
                     "paged_attention": 0}, f"9 (f) launcher: launches "
          f"{counts} != {VLM_PER_CALL} SWIS x {calls} model calls and no "
          f"paged launch (text requests, the gather path)")
    by_path["9 (f) launcher"] = counts
    secs["9 (f)"] = time.perf_counter() - t0
    print(f"phase 9 (f) on {card}: python -m repro_torch.launch.serve "
          f"{' '.join(argv)} with phase 9's packed weights, in "
          f"{secs['9 (f)']:.1f} s; {calls} model calls, launches {counts}; "
          f"report {json.dumps(report)}")
    del eng, params
    return by_path, secs


def encoder_phase(dev, card, kernels):
    """Phase 9 (a) and (e) on hubert-xlarge at its published widths and
    depth (48 enc layers): drawn and packed layer by layer, then
    ``Model.apply`` on 4 clips of 500 frames from the seed: 288 SWIS
    launches and no paged one, finite logits, attention both ways (the last
    frame moves position 0's logits), bit-identical on a repeat, and at a
    2-layer cut the CPU plain path's logits within rtol 1e-4 of
    max|logit|. Returns (launches, seconds)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.model import Model

    t0 = time.perf_counter()
    cfg, _, params, line = packed_init(dev, ENC_ARCH)
    print(f"phase 9 (a): {ENC_ARCH} ({cfg.n_layers} layers: "
          f"{depth_desc(cfg)}; d_model {cfg.d_model}, {cfg.n_heads} heads of "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, no GLU, LayerNorm, vocab "
          f"{cfg.vocab}) on {card}: {line}")
    model = Model(cfg)
    g = torch.Generator(device=dev).manual_seed(9)
    frames = torch.randn((4, 500, cfg.d_model), generator=g, device=dev)
    for kern in kernels:
        kern.launches = 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    logits = model.apply(params, {"frames": frames})[0]
    torch.cuda.synchronize()
    apply_ms = (time.perf_counter() - t1) * 1e3
    counts = {kern.name: kern.launches for kern in kernels}
    check(counts == {"swis_matmul": ENC_PER_APPLY, "paged_attention": 0},
          f"9 (e): launches {counts} != {ENC_PER_APPLY} SWIS and no paged "
          f"launch for one apply")
    check(tuple(logits.shape) == (4, 500, cfg.padded_vocab)
          and bool(torch.isfinite(logits).all()),
          f"9 (e): logits {tuple(logits.shape)} not finite or misshapen")
    check(torch.equal(model.apply(params, {"frames": frames})[0], logits),
          "9 (e): a repeat apply is not bit-identical")
    moved_frames = frames.clone()
    moved_frames[:, -1] += 1.0
    moved = (model.apply(params, {"frames": moved_frames})[0][:, 0]
             - logits[:, 0]).abs().max().item()
    check(moved > 1e-4, f"9 (e): the last frame moved position 0's logits "
          f"by {moved:.3g}: attention is not bidirectional")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        model.apply(params, {"frames": frames})
        torch.cuda.synchronize()
    busy = device_ms(prof)
    cfg2, cut, cut_cpu = layer_cut(cfg, params, n_layers=2)
    t1 = time.perf_counter()
    got = Model(cfg2).apply(cut, {"frames": frames})[0].cpu()
    want = Model(cfg2).apply(cut_cpu, {"frames": frames.cpu()})[0]
    top = want.abs().max().item()
    err = (got - want).abs().max().item()
    check(torch.allclose(got, want, rtol=1e-4, atol=1e-4 * top),
          f"9 (e) 2-layer cut: max|err| {err:.3g} vs max|logit| {top:.3g}")
    print(f"phase 9 (e) on {card}: Model.apply on frames (4, 500, "
          f"{cfg.d_model}): {apply_ms:.1f} ms wall, device busy {busy:.1f} "
          f"ms (profiled repeat); launches {counts}; logits finite, "
          f"bit-identical on a repeat; the last frame moves position 0's "
          f"logits by {moved:.4g}; at a 2-layer cut max|err| {err:.3g} "
          f"against the CPU plain path (max|logit| {top:.4g}, rtol 1e-4; "
          f"CPU {time.perf_counter() - t1:.1f} s)")
    del params, cut, cut_cpu
    return {"9 (e) encoder apply": counts}, time.perf_counter() - t0


# -- phase 10: SWIS QAT training at full width ------------------------------------

QAT_ARGV = ["--arch", "smollm-135m", "--quant", "swis", "--n-shifts", "4",
            "--group-size", "4", "--seq", "256", "--batch", "16", "--lr",
            "3e-3", "--warmup", "20", "--steps", "8", "--ckpt-every", "4"]
QAT_CUT = 2  # (c)'s depth: the card against the CPU plain path
# (e)'s families: (arch, what its batch carries)
QAT_FAMILIES = [("smollm-135m", "tokens"), ("qwen2-moe-a2.7b", "tokens"),
                ("recurrentgemma-2b", "tokens"), ("mamba2-2.7b", "tokens"),
                ("llama-3.2-vision-11b", "tokens and patches"),
                ("hubert-xlarge", "frames")]
# tolerances of the card against the CPU plain path (float32 compute): the
# loss within rtol 1e-5; each gradient leaf within 1e-4 x its max |g|; the
# updated weights: AdamW's first step moves a weight by lr x g / (|g| +
# 1e-8) (plus decay), so where a gradient is within its rounding of 0 the
# move can differ by up to 2 x lr; at most 1e-4 of the weights may differ
# by more than 0.01 x lr, and none by more than 2.05 x lr
QAT_TOL = {"loss": 1e-5, "grad": 1e-4, "param": 2.05, "param_frac": 1e-4}


def qat_step_both(label, cfg, params_cpu, batch_cpu, dev, lr=3e-3):
    """One QAT train step (grads, then the AdamW update) on the card and on
    the CPU plain path from the same float32 params and batch: the
    fake-quantized weights must be bit-identical, the loss, gradients and
    updated params within ``QAT_TOL``. Returns a summary line."""
    import torch
    from repro_torch.core.qat import quantize_tree
    from repro_torch.models import params as pp
    from repro_torch.models.model import Model
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.train.steps import (init_state, make_grad_fn,
                                         make_train_step)

    model = Model(cfg)
    lr_fn = warmup_cosine(lr, 1, 10)  # the full lr at step 0
    out = []
    for d in (dev, torch.device("cpu")):
        params = pp.tree_map(lambda a: a.to(d), params_cpu)
        batch = {k: v.to(d) for k, v in batch_cpu.items()}
        with torch.no_grad():
            q = quantize_tree(params, cfg.quant.cfg)
        grads, metrics = make_grad_fn(model)(params, batch)
        state, _ = make_train_step(model, AdamW(), lr_fn)(
            init_state(params), batch)
        out.append([pp.tree_map(lambda a: None if a is None else a.cpu(), t)
                    for t in (q, grads, state.params)]
                   + [float(metrics["loss"])])
    (qc, gc_, pc, lc), (qh, gh, ph, lh) = out
    n_q = [0]

    def same_q(a, b):
        n_q[0] += 1
        check(torch.equal(a, b), f"{label}: a fake-quantized leaf differs "
              f"on the card (max |diff| {(a - b).abs().max().item():.3g})")
    _zip(same_q, qc, qh)
    check(abs(lc - lh) <= QAT_TOL["loss"] * abs(lh),
          f"{label}: loss {lc} on the card against {lh} on the CPU")
    gerr = [0.0]

    def close_g(a, b):
        if a is None or b is None:
            check(a is None and b is None, f"{label}: a gradient is None on "
                  f"one side only")
            return
        scale = max(b.abs().max().item(), 1e-30)
        e = (a - b).abs().max().item() / scale
        gerr[0] = max(gerr[0], e)
        check(e <= QAT_TOL["grad"], f"{label}: gradient leaf differs by "
              f"{e:.3g} x its max |g|")
    _zip(close_g, gc_, gh)
    perr, far, total = [0.0], [0], [0]

    def close_p(a, b):
        d = (a - b).abs() / lr
        perr[0] = max(perr[0], d.max().item())
        far[0] += int((d > 0.01).sum())
        total[0] += d.numel()
    _zip(close_p, pc, ph)
    check(perr[0] <= QAT_TOL["param"] and far[0] <= QAT_TOL["param_frac"]
          * total[0], f"{label}: updated params differ by up to "
          f"{perr[0]:.3g} x lr, {far[0]} of {total[0]} beyond 0.01 x lr")
    return (f"{label}: {n_q[0]} leaves fake-quantized bit-identically; loss "
            f"{lc:.6f} (CPU {lh:.6f}); gradients within {gerr[0]:.3g} x max"
            f"|g|; updated params within {perr[0]:.3g} x lr ({far[0]} of "
            f"{total[0]} beyond 0.01 x lr)")


def _zip(fn, a, b):
    if isinstance(a, dict):
        for k in a:
            _zip(fn, a[k], b[k])
    else:
        fn(a, b)


def qat_phase(dev, card, kernels):
    """SWIS QAT at smollm-135m's full width and depth (random seeded init,
    n_shifts 4, group 4, seq 256, batch 16, lr 3e-3, warmup 20, bf16
    compute): (a) ``repro_torch.launch.train`` in process for 8 steps,
    checkpointing every 4 under ``build/``, with each step's loss, wall ms,
    device ms by part, tokens/s and peak memory, then one step under the
    profiler (device busy, and the kernels the QAT selection launches);
    (b) a fresh trainer resumes from the step-4 checkpoint and repeats
    steps 5-8 bit for bit; (c) at a 2-layer cut of the same initial
    params, one QAT step (float32 compute) on the card against the CPU
    plain path; (d) the serve launcher serves the step-8 checkpoint with
    ``--ckpt --packed`` (210 SWIS launches a model dispatch, the gather
    path), an engine with the paged kernel serves the same packed weights
    (210 SWIS a model call, 30 paged an arena call), and at a 4-layer cut
    greedy tokens equal the CPU plain path's; (e) one QAT step of each
    family's smoke config on the card against the CPU. Returns (launches
    by path, seconds by part)."""
    import shutil

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.core import swis
    from repro_torch.core.qat import quantize_tree
    from repro_torch.data import SyntheticPipeline
    from repro_torch.data.pipeline import to_device
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.launch import train as train_launcher
    from repro_torch.models import params as pp
    from repro_torch.models.model import Model
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.serve import ContinuousBatchingEngine, EngineConfig
    from repro_torch.train.steps import make_train_step

    secs = {}
    work = ROOT / "build" / "qat_phase"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        # (a) train through the launcher
        t0 = time.perf_counter()
        args = train_launcher.parse_args(QAT_ARGV + ["--workdir",
                                                     str(work / "a")])
        cfg = configs.get_config("smollm-135m")
        torch.cuda.reset_peak_memory_stats()
        out = train_launcher.run(args)
        recs = out["records"]
        check(len(recs) == 8 and all(np.isfinite(r["loss"]) for r in recs),
              f"QAT training: losses {[r['loss'] for r in recs]}")
        for r in recs:
            d = r["part_ms"]
            print(f"phase 10 (a) on {card}: step {r['step']}: loss "
                  f"{r['loss']:.6f}, wall {r['wall_ms']:.1f} ms, "
                  f"{r['clock']} ms between events: QAT selection "
                  f"{d['select']:.2f}, forward + backward "
                  f"{d['fwd_bwd']:.2f}, optimizer "
                  f"{d['optim']:.2f}; {r['tokens_per_s']:.0f} tokens/s; "
                  f"peak {r.get('peak_gb', 0):.3f} GB; selection "
                  f"{r['selection_passes']} passes over "
                  f"{r['selection_combos']} combos")
        state = out["state"]
        # one more step under the profiler: device busy, and the kernels
        # of the selection alone
        tr_cfg = cfg.replace(quant=qat_policy())
        pipe = SyntheticPipeline(tr_cfg, 256, 16, seed=0)
        step_fn = make_train_step(Model(tr_cfg), AdamW(),
                                  warmup_cosine(3e-3, 20, 8))
        batch = to_device(pipe.batch_at(8), dev)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            _, m = step_fn(state, batch)
            float(m["loss"])
            wall = (time.perf_counter() - t1) * 1e3
        busy = device_ms(prof)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with torch.no_grad():
                quantize_tree(state.params, tr_cfg.quant.cfg)
            torch.cuda.synchronize()
        n_sel = sum(e.count for e in prof.key_averages()
                    if getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0)) > 0)
        sel_ms = device_ms(prof)
        print(f"phase 10 (a): a profiled step (step 9): wall {wall:.1f} ms, "
              f"device busy {busy:.2f} ms (idle share "
              f"{max(0.0, 1 - busy / wall):.3f}); the QAT selection alone: "
              f"{n_sel} kernel launches, {sel_ms:.2f} ms busy, chunk "
              f"{swis.FAKE_QUANT_CHUNK_ELEMS} magnitudes a pass")
        secs["10 (a)"] = time.perf_counter() - t0

        # (b) resume from step 4 in a fresh trainer
        t0 = time.perf_counter()
        shutil.copytree(work / "a" / "step_00000004",
                        work / "b" / "step_00000004")
        args_b = train_launcher.parse_args(QAT_ARGV + ["--workdir",
                                                       str(work / "b")])
        out_b = train_launcher.run(args_b)
        want = [r["loss"] for r in recs[4:]]
        got = [r["loss"] for r in out_b["records"]]
        check(got == want, f"resume from step 4: losses {got} != {want}")
        diff = []
        _zip(lambda a, b: diff.append(not torch.equal(a, b)),
             out_b["state"].params, state.params)
        check(not any(diff), f"resume from step 4: {sum(diff)} param leaves "
              f"differ after step 8")
        print(f"phase 10 (b): resumed at step 4 in a fresh trainer; steps 5-8 "
              f"losses {got} equal (a)'s bit for bit, and so do the step-8 "
              f"params")
        del out_b
        secs["10 (b)"] = time.perf_counter() - t0

        # (c) the same initial params cut to 2 layers: card against CPU
        t0 = time.perf_counter()
        init = pp.init_params(Model(cfg).build(),
                              torch.Generator(device=dev).manual_seed(0),
                              device=dev)
        cut_cfg = tr_cfg.replace(n_layers=QAT_CUT, compute_dtype="float32")
        cut = {k: v for k, v in init.items() if k != "blocks"}
        cut["blocks"] = pp.tree_map(lambda a: a[:QAT_CUT].contiguous(),
                                    init["blocks"])
        cut_cpu = pp.tree_map(lambda a: a.cpu(), cut)
        del init, cut
        cbatch = {k: torch.from_numpy(v[:2]) for k, v in
                  SyntheticPipeline(cut_cfg, 256, 16, seed=0).batch_at(0)
                  .items()}
        print("phase 10 (c) on " + card + ": " + qat_step_both(
            f"smollm-135m at {QAT_CUT} layers, 2 x 256 tokens", cut_cfg,
            cut_cpu, cbatch, dev))
        del cut_cpu
        secs["10 (c)"] = time.perf_counter() - t0

        # (d) serve the step-8 checkpoint
        t0 = time.perf_counter()
        del state, out
        gc.collect()
        torch.cuda.empty_cache()
        by_path = {}
        for kern in kernels:
            kern.launches = 0
        report, eng = serve_launcher.run(serve_launcher.parse_args(
            ["--arch", "smollm-135m", "--ckpt", str(work / "a"), "--packed",
             "--requests", "8", "--prompt-len", "64", "--tokens", "32",
             "--n-slots", "4"]))
        counts = {kern.name: kern.launches for kern in kernels}
        by_path["10 (d) launcher --ckpt --packed"] = counts
        calls = eng.metrics()["engine"]["counters"]["step.model_dispatches"]
        per_call = 7 * cfg.n_layers
        check(counts == {"swis_matmul": per_call * calls,
                         "paged_attention": 0},
              f"launcher --ckpt: launches {counts} != {per_call} SWIS x "
              f"{calls} model dispatches and no paged launch")
        print(f"phase 10 (d) on {card}: launcher --ckpt --packed served the "
              f"step-8 checkpoint: {calls} model dispatches, launches "
              f"{counts}, {report['tok_per_s']} tokens/s, compression "
              f"{report['compression']}x")
        packed = eng.params
        serve_cfg = eng.cfg
        del eng
        ecfg = EngineConfig(n_slots=4, block_size=8, packed=True,
                            use_paged_kernel=True, max_len=128,
                            quant_cfg=tr_cfg.quant.cfg)
        reqs = prompts(cfg.vocab)
        paged = ContinuousBatchingEngine(serve_cfg, packed, ecfg, device=dev)
        for kern in kernels:
            kern.launches = 0
        toks, _, _ = serve(paged, reqs, 32)
        counts = {kern.name: kern.launches for kern in kernels}
        by_path["10 (d) paged engine"] = counts
        want = {"swis_matmul": per_call * paged.model_calls(),
                "paged_attention": cfg.n_layers * paged.arena_calls()}
        check(counts == want, f"trained weights, paged engine: launches "
              f"{counts} != {want}")
        for t in toks:
            check(len(t) == 32 and int(t.min()) >= 0
                  and int(t.max()) < cfg.vocab, f"bad token output {t}")
        cfg4, cut4, cut4_cpu = layer_cut(serve_cfg, packed)
        toks_card, _, _ = serve(ContinuousBatchingEngine(
            cfg4, cut4, ecfg, device=dev), reqs, 32)
        cpu = ContinuousBatchingEngine(cfg4, cut4_cpu, ecfg, device="cpu")
        toks_cpu, _, _ = serve(cpu, reqs, 32)
        same_tokens("phase 10 (d) (4-layer cut of the trained weights) vs "
                    "the CPU plain path", toks_card, toks_cpu,
                    [(p, 32) for p in reqs],
                    [("card", cpu.model, cut4, dev),
                     ("cpu", cpu.model, cut4_cpu, "cpu")])
        print(f"phase 10 (d): a paged engine on the trained packed weights: "
              f"{paged.model_calls()} model calls, {paged.arena_calls()} "
              f"arena calls, launches {counts}; greedy tokens at a 4-layer "
              f"cut: 8/8 requests identical on the card and the CPU plain "
              f"path")
        del paged, packed, cut4, cut4_cpu, cpu
        secs["10 (d)"] = time.perf_counter() - t0

        # (e) one QAT step of every family's smoke config
        t0 = time.perf_counter()
        for arch, carries in QAT_FAMILIES:
            fcfg = configs.get_smoke(arch).replace(
                compute_dtype="float32", quant=qat_policy())
            params = pp.init_params(Model(fcfg).build(),
                                    torch.Generator().manual_seed(1),
                                    device="cpu")
            params = _set_xgate(params, XGATE)
            fb = {k: torch.from_numpy(v) for k, v in
                  SyntheticPipeline(fcfg, 32, 4, seed=0).batch_at(0).items()}
            print(f"phase 10 (e) on {card}: " + qat_step_both(
                f"{fcfg.name} ({carries})", fcfg, params, fb, dev))
        secs["10 (e)"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return by_path, secs


def qat_policy():
    """``QAT_ARGV``'s policy: SWIS QAT at n_shifts 4, group 4."""
    from repro_torch.configs.base import QuantPolicy
    from repro_torch.core.swis import QuantConfig

    return QuantPolicy(cfg=QuantConfig(method="swis", n_shifts=N_SHIFTS,
                                       group_size=GROUP), mode="qat")


def _set_xgate(tree, value):
    import torch

    if not isinstance(tree, dict):
        return tree
    return {k: (torch.full_like(v, value) if k == "xgate"
                else _set_xgate(v, value)) for k, v in tree.items()}


# -- phase 11: the offline toolchain, and serving at a fractional shift count --

BUDGET_LEVELS = (1, 2, 3, 4, 5)
BUDGET_TARGETS = (2.0, 2.5, 3.0)
BUDGET_CUT = 2  # (a)'s depth: the card against the CPU plain path
FRACTIONAL_SHIFTS = 2.5  # the paper's Table-2 point: 3 planes, half at 2
# (b): benchmarks/paper_tables.py's table2_scheduling settings (target,
# levels), over costs at levels 1-4, sa_cols 8
SCHEDULES = ((2.5, [1, 2, 3, 4]), (3.0, [2, 3, 4]))
SCHED_GEMMS = (("attn", "wq"), ("attn", "wk"), ("attn", "wv"),
               ("attn", "wo"), ("mlp", "wi"), ("mlp", "wg"), ("mlp", "wo"))


def toolchain_phase(dev, card, kernels):
    """The SWIS offline toolchain on smollm-135m at full width and depth
    (random weights from seed 0, ``QuantConfig(method="swis",
    group_size=4)``): (a) ``core.budget``'s sensitivity profile on the card
    over levels 1-5 across all 210 GEMM units (each unit's cost must not
    grow with the shift count), ``allocate`` at 2.0, 2.5 and 3.0 (within 0.5
    of each target; at 2.5 between the uniform-3 and uniform-2 costs),
    ``quantize_with_allocation`` on the card, and at a 2-layer cut the CPU
    plain path's profile within rtol 1e-5, identical allocations and
    bit-identical quantized leaves; (b) ``core.scheduling.schedule_layer``
    on layer 0's seven GEMMs with per-column costs from the card (equal to
    the CPU's for the four attention GEMMs), at 2.5 over levels 1-4 and 3.0
    over 2-4: averages equal to the targets, scheduled-3 cost at most the
    uniform-3 cost; (c) ``pack_tree`` at 2.5 shifts (3 planes; at most half
    of each GEMM's columns use the third), phase 4's traffic through the
    paged engine (210 SWIS launches a model call, 30 paged an arena call),
    greedy tokens at a 4-layer cut equal to the CPU plain path's, and one
    decode layer's 7 GEMMs at M = 4 timed at 3 and at 4 planes (CUDA
    events); (d) the paper's analytical performance model on the host,
    held to the reference test's ranges. Returns (launches by path, the
    3-plane layer's timing, seconds by part)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.core import budget, scheduling, swis
    from repro_torch.models import params as pp
    from repro_torch.models.model import Model
    from repro_torch.perfmodel import evaluate
    from repro_torch.serve import ContinuousBatchingEngine, EngineConfig
    from repro_torch.serve.quantized import pack_tree

    secs = {}
    cfg = configs.get_config("smollm-135m").replace(compute_dtype="float32")
    params = pp.init_params(Model(cfg).build(),
                            torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    qcfg = swis.QuantConfig(method="swis", group_size=GROUP)

    # (a) the cross-layer budget at full width
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    prof = budget.sensitivity_profile(params, qcfg, BUDGET_LEVELS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    n_units = 7 * cfg.n_layers
    check(len(prof) == n_units, f"profile: {len(prof)} units != {n_units}")
    for unit, costs in prof.items():
        vals = [costs[n] for n in BUDGET_LEVELS]
        check(all(np.isfinite(vals)) and all(
            b <= a + 1e-9 for a, b in zip(vals, vals[1:])),
            f"profile: {unit} cost grows with the shift count: {vals}")
    layer0 = {"blocks": pp.tree_map(lambda a: a[:1], params["blocks"])}
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        t1 = time.perf_counter()
        budget.sensitivity_profile(layer0, qcfg, BUDGET_LEVELS)
        torch.cuda.synchronize()
        wall0 = (time.perf_counter() - t1) * 1e3
    busy0 = device_ms(p)
    n_launch0 = sum(e.count for e in p.key_averages()
                    if getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0)) > 0)
    print(f"phase 11 (a) on {card}: sensitivity profile of {len(prof)} "
          f"units (7 GEMMs x {cfg.n_layers} layers, embedding excluded) over "
          f"levels {list(BUDGET_LEVELS)}: {wall:.2f} s wall; layer 0's 7 "
          f"units under the profiler: {wall0:.1f} ms wall, {busy0:.2f} ms "
          f"device busy in {n_launch0} kernel launches (plain torch "
          f"selection); every unit's cost non-increasing in the shift count")
    sizes = budget.leaf_sizes(params)
    uniform = {n: sum(c[n] for c in prof.values()) for n in BUDGET_LEVELS}
    allocs = {}
    for target in BUDGET_TARGETS:
        a = budget.allocate(prof, sizes, target, BUDGET_LEVELS)
        allocs[target] = a
        check(abs(a.effective_shifts - target) < 0.5,
              f"allocate({target}): effective {a.effective_shifts}")
        hist = {n: sum(v == n for v in a.shifts.values())
                for n in BUDGET_LEVELS}
        by_gemm = {}
        for unit, n in a.shifts.items():
            by_gemm.setdefault("/".join(unit[-3:-1]), []).append(n)
        print(f"phase 11 (a): allocate({target}): effective shifts "
              f"{a.effective_shifts:.6f}, total cost {a.total_cost:.6g} "
              f"(uniform 2: {uniform[2]:.6g}, uniform 3: {uniform[3]:.6g}); "
              f"units by level {hist}; mean level by GEMM " + ", ".join(
                  f"{k} {sum(v) / len(v):.2f}" for k, v in by_gemm.items()))
    a25 = allocs[2.5]
    check(uniform[3] - 1e-9 <= a25.total_cost <= uniform[2] + 1e-9,
          f"allocate(2.5): cost {a25.total_cost} not between uniform 3 "
          f"({uniform[3]}) and uniform 2 ({uniform[2]})")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    qparams = budget.quantize_with_allocation(params, qcfg, a25)
    torch.cuda.synchronize()
    qsecs = time.perf_counter() - t1
    changed = []
    for path, w in budget._eligible_leaves(params):
        q = qparams
        for k in path:
            q = q[k]
        changed.append(bool(torch.isfinite(q).all())
                       and not torch.equal(q, w))
    check(all(changed) and len(changed) == 7,
          f"quantize_with_allocation: leaves changed and finite: {changed}")
    check(torch.equal(qparams["embed"]["tok"], params["embed"]["tok"]),
          "quantize_with_allocation changed the embedding")
    print(f"phase 11 (a): quantize_with_allocation at 2.5 on the card: "
          f"{qsecs:.2f} s, all 7 stacked GEMM leaves fake-quantized unit by "
          f"unit, the embedding untouched")
    del qparams
    # the 2-layer cut on the CPU plain path against the card's units
    t1 = time.perf_counter()
    cut_cpu = {"blocks": pp.tree_map(lambda a: a[:BUDGET_CUT].cpu(),
                                     params["blocks"])}
    prof_cpu = budget.sensitivity_profile(cut_cpu, qcfg, BUDGET_LEVELS)
    cpu_secs = time.perf_counter() - t1
    prof_cut = {u: prof[u] for u in prof_cpu}
    check(list(prof_cpu) == [u for u in prof if u[-1] < BUDGET_CUT],
          "2-layer cut: the CPU profile's units differ from the card's")
    worst = max(abs(prof_cut[u][n] - prof_cpu[u][n]) / abs(prof_cpu[u][n])
                for u in prof_cpu for n in BUDGET_LEVELS)
    n_equal = sum(prof_cut[u][n] == prof_cpu[u][n]
                  for u in prof_cpu for n in BUDGET_LEVELS)
    check(worst <= 1e-5, f"2-layer cut: profile rel diff {worst:.3g} > 1e-5")
    cut_sizes = budget.leaf_sizes(cut_cpu)
    cut_card = {"blocks": pp.tree_map(lambda a: a[:BUDGET_CUT],
                                      params["blocks"])}
    for target in BUDGET_TARGETS:
        a_card = budget.allocate(prof_cut, cut_sizes, target, BUDGET_LEVELS)
        a_cpu = budget.allocate(prof_cpu, cut_sizes, target, BUDGET_LEVELS)
        check(a_card.shifts == a_cpu.shifts,
              f"2-layer cut: allocate({target}) differs on the card")
    q_card = budget.quantize_with_allocation(cut_card, qcfg, a_cpu)
    q_cpu = budget.quantize_with_allocation(cut_cpu, qcfg, a_cpu)
    for path, w in budget._eligible_leaves(q_cpu):
        q = q_card
        for k in path:
            q = q[k]
        check(torch.equal(q.cpu(), w),
              f"2-layer cut: quantized {path} differs on the card")
    print(f"phase 11 (a): at a {BUDGET_CUT}-layer cut the CPU plain path "
          f"({cpu_secs:.1f} s) gives profile values within rel "
          f"{worst:.3g} of the card's ({n_equal} of "
          f"{len(prof_cpu) * len(BUDGET_LEVELS)} equal), identical "
          f"allocations at {list(BUDGET_TARGETS)} and bit-identical "
          f"fake-quantized leaves")
    del cut_cpu, cut_card, q_card, q_cpu
    secs["11 (a)"] = time.perf_counter() - t0

    # (b) the exact scheduler on layer 0's GEMMs
    t0 = time.perf_counter()
    for sub, name in SCHED_GEMMS:
        w = params["blocks"]["sub0_attn"][sub][name]["w"][0]
        mags, signs, _ = swis._to_int_domain(w, qcfg.bits, qcfg.per_channel)
        costs = {n: swis._column_costs(mags, signs, n, qcfg)[1].cpu().numpy()
                 for n in (1, 2, 3, 4)}
        if sub == "attn":
            m_c, s_c, _ = swis._to_int_domain(w.cpu(), qcfg.bits,
                                              qcfg.per_channel)
            for n in costs:
                c_cpu = swis._column_costs(m_c, s_c, n, qcfg)[1].numpy()
                check(np.array_equal(costs[n], c_cpu),
                      f"scheduler costs of {sub}/{name} at {n} shifts "
                      f"differ on the card")
        uniform3 = float(costs[3].astype(np.float64).sum())
        line = []
        for target, levels in SCHEDULES:
            t1 = time.perf_counter()
            sched = scheduling.schedule_layer(lambda n: costs[n], target,
                                              levels=levels, sa_cols=8)
            dt = time.perf_counter() - t1
            check(sched.effective_shifts == target,
                  f"schedule {sub}/{name} at {target}: average "
                  f"{sched.effective_shifts}")
            if target == 3.0:
                check(sched.total_cost <= uniform3,
                      f"schedule {sub}/{name} at 3.0: cost "
                      f"{sched.total_cost} > uniform 3 {uniform3}")
            n_groups = w.shape[1] // 8
            lv, cnt = np.unique(sched.group_shifts, return_counts=True)
            line.append(
                f"{target} over {levels}: {dt:.3f} s, groups by level "
                f"{dict(zip(lv.tolist(), cnt.tolist()))}, cost "
                f"{sched.total_cost:.6g} ("
                f"{scheduling.n_sequences(n_groups, len(levels))} "
                f"sequences enumerated)")
        print(f"phase 11 (b): schedule_layer {sub}/{name} ({w.shape[0]}x"
              f"{w.shape[1]}, {w.shape[1] // 8} groups of 8; uniform 3 cost "
              f"{uniform3:.6g}): " + "; ".join(line))
    print("phase 11 (b): every schedule's average equals its target; "
          "scheduled-3 costs at most uniform-3; the attention GEMMs' costs "
          "equal on the card and the CPU")
    secs["11 (b)"] = time.perf_counter() - t0

    # (c) serving at 2.5 shifts: 3 planes, half the columns at 2
    t0 = time.perf_counter()
    q25 = swis.QuantConfig(method="swis", n_shifts=FRACTIONAL_SHIFTS,
                           group_size=GROUP)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    packed, stats = pack_tree(params, q25)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t1
    del params
    for sub, name in SCHED_GEMMS:
        planes = packed["blocks"]["sub0_attn"][sub][name]["w"][
            "mask_planes"]
        check(planes.shape[-3] == 3, f"{sub}/{name}: {planes.shape[-3]} "
              f"planes packed at {FRACTIONAL_SHIFTS} shifts")
        hi = (planes[:, 2] != 0).any(dim=1).sum(dim=-1)  # columns using 3
        c = planes.shape[-1]
        check(bool((hi <= c // 2).all()) and bool((hi >= 0.45 * c).all()),
              f"{sub}/{name}: columns with a third plane by layer "
              f"{hi.tolist()} of {c}")
    layers_gb = tree_bytes(packed["blocks"]) / 1e9
    print(f"phase 11 (c) on {card}: pack_tree at n_shifts "
          f"{FRACTIONAL_SHIFTS}: {stats['n_packed']} stacked GEMM leaves "
          f"in {pack_s:.1f} s, 3 planes (half of each GEMM's columns "
          f"scheduled at 2 shifts, the others at 3), layers "
          f"{layers_gb:.4f} GB packed, {tree_bytes(packed) / 1e9:.4f} GB "
          f"with the float32 embedding, compression "
          f"{stats['compression']:.3f}x vs int8")
    ecfg = EngineConfig(n_slots=4, block_size=8, packed=True,
                        use_paged_kernel=True, max_len=128, quant_cfg=q25)
    eng = ContinuousBatchingEngine(cfg, packed, ecfg, device=dev)
    reqs = prompts(cfg.vocab)
    for kern in kernels:  # count only this path's launches
        kern.launches = 0
    toks, pre, dec = serve(eng, reqs, 32)
    counts = {kern.name: kern.launches for kern in kernels}
    check_dispatches("phase 11 (c)", eng)
    want = {"swis_matmul": n_units * eng.model_calls(),
            "paged_attention": cfg.n_layers * eng.arena_calls()}
    check(counts == want, f"phase 11 (c): launches {counts} != {want}")
    for t in toks:
        check(len(t) == 32 and int(t.min()) >= 0 and int(t.max()) < cfg.vocab,
              f"bad token output {t}")
    dec_ms = 1e3 * sum(d for d, _ in dec) / len(dec)
    print(f"phase 11 (c): {eng.model_calls()} model calls, "
          f"{eng.arena_calls()} arena calls, launches {counts}; decode-only "
          f"steps {len(dec)} at {dec_ms:.2f} ms/step wall")
    breakdown(eng, reqs[:4])
    cfg4, cut4, cut4_cpu = layer_cut(cfg, eng.params)
    toks_card, _, _ = serve(ContinuousBatchingEngine(cfg4, cut4, ecfg,
                                                     device=dev), reqs, 32)
    cpu = ContinuousBatchingEngine(cfg4, cut4_cpu, ecfg, device="cpu")
    toks_cpu, _, _ = serve(cpu, reqs, 32)
    same_tokens("phase 11 (c) (4-layer cut at 2.5 shifts) vs the CPU plain "
                "path", toks_card, toks_cpu, [(p, 32) for p in reqs],
                [("card", cpu.model, cut4, dev),
                 ("cpu", cpu.model, cut4_cpu, "cpu")])
    print("phase 11 (c): greedy tokens at a 4-layer cut: 8/8 requests "
          "identical on the card and the CPU plain path")
    del eng, packed, cut4, cut4_cpu, cpu
    gc.collect()
    torch.cuda.empty_cache()
    perf3 = swis_layer_timing(dev, 4, timer=event_ms,
                              n_shifts=FRACTIONAL_SHIFTS)
    perf4 = swis_layer_timing(dev, 4, timer=event_ms)
    for label, p in (("3 planes (n_shifts 2.5)", perf3),
                     ("4 planes (n_shifts 4)", perf4)):
        print(f"phase 11 (c): swis_matmul decode layer (7 GEMMs at M=4, fp32 "
              f"x), {label}, by CUDA events on {card}: kernel "
              f"{p['ms']:.5f} ms, torch.matmul {p['library_ms']:.5f} ms, "
              f"plain {p['plain_ms']:.4f} ms, bound {p['bound_ms']:.6f} ms "
              f"({p['bound_by']}); max|err| {p['max_abs_err']:.3g}")
    secs["11 (c)"] = time.perf_counter() - t0

    # (d) the paper's analytical performance model, on the host
    t0 = time.perf_counter()
    label = ("analytical model of the paper's 28 nm accelerator, not "
             "measured")
    rows = evaluate.evaluate_table4()
    for net, points in evaluate.TABLE4_POINTS.items():
        for point in points:
            print(f"phase 11 (d) ({label}): Table 4 {net} {point}, "
                  f"config N frames/s frames/J: " + "; ".join(
                      f"{r['config']} {r['n_shifts']} "
                      f"{r['frames_per_s']:.2f} {r['frames_per_j']:.2f}"
                      for r in rows
                      if (r["network"], r["point"]) == (net, point)))
    h = evaluate.headline_ratios()
    fig1 = [r for _, r in evaluate.fig1_dram_ratio()]
    print(f"phase 11 (d) ({label}): {len(rows)} Table-4 rows; headline "
          + ", ".join(f"{k} {v:.4f}" for k, v in h.items())
          + f"; Fig. 1 weight/activation DRAM ratio over ResNet-18's "
          f"{len(fig1)} conv layers {min(fig1):.4f} to {max(fig1):.2f}")
    check(4.5 <= h["max_speedup_vs_act_trunc"] <= 6.5
          and 1.5 <= h["max_energy_ratio_vs_act_trunc"] <= 2.1
          and 1.8 <= h["dram_reduction_vs_fixed8"] <= 2.6
          and max(fig1) > 50 and min(fig1) < 1,
          f"perf model outside the reference test's ranges: {h}")
    secs["11 (d)"] = time.perf_counter() - t0
    return {"11 (c) 2.5 shifts, 3 planes": counts}, perf3, secs


# -- phase 12: parallel and the dry-run ----------------------------------------

# (a): phase 10's QAT settings, 4 steps, no checkpoints
SHARDED_ARGV = ["--arch", "smollm-135m", "--quant", "swis", "--n-shifts",
                "4", "--group-size", "4", "--seq", "256", "--batch", "16",
                "--lr", "3e-3", "--warmup", "20", "--steps", "4"]
# (b): the dry-run's cells on the single (16, 16) mesh
DRYRUN_CELLS = (("mistral-large-123b", "decode_32k"),
                ("dbrx-132b", "decode_32k"), ("smollm-135m", "train_4k"))
RANK0_ARCHS, RANK0_SHAPE = ("mistral-large-123b", "dbrx-132b"), "decode_32k"
# SWIS launches a layer: wq, wk, wv, attention wo, and MLP wi, wg, wo
# (mistral-large) or the wi, wg, wo expert stacks (dbrx)
RANK0_SWIS_PER_LAYER = 7
# (c): rank 0's local GEMMs (K, N) of one mistral-large-123b layer on the
# (16, 16) mesh: q_proj, kv_proj and mlp split 16 ways over model
RANK0_GEMMS = [(12288, 768), (12288, 64), (12288, 64), (768, 12288),
               (12288, 1792), (12288, 1792), (1792, 12288)]
RANK0_LABEL = "one rank of 256; collectives not executed; values not checked"


def _one_rank_group(backend):
    """This process as the only rank of a ``backend`` group at
    ``tcp://localhost`` (a free port)."""
    import socket

    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)


def _fill_rank0(tree, qcfg, dev, seed):
    """Fill rank 0's local shards of a packed serving tree in place, on the
    card: every stacked packed leaf gets the planes of one random weight
    of its local shape, drawn from ``seed`` and packed here (every layer
    the same planes: nothing of the values is read), float leaves random
    normals (norm scales ones), integer leaves zeros."""
    import torch
    from repro_torch.serve.quantized import _pack_matrix, is_packed

    g = torch.Generator(device=dev).manual_seed(seed)
    for key, node in tree.items():
        if is_packed(node):
            loc = {k: v.to_local() for k, v in node.items()}
            k = loc["sign_plane"].shape[-2] * 32
            n = loc["sign_plane"].shape[-1]
            w = torch.randn((k, n), generator=g, device=dev) * 0.05
            packed = _pack_matrix(w, qcfg)
            for name, t in loc.items():
                t.copy_(packed[name].expand_as(t))
        elif isinstance(node, dict):
            _fill_rank0(node, qcfg, dev, seed + 1)
        else:
            t = node.to_local()
            if not t.dtype.is_floating_point:
                t.zero_()
            elif key == "scale":
                t.fill_(1.0)
            else:
                t.copy_(torch.randn(t.shape, generator=g, device=dev) * 0.02)


def _hold_rank0_gemms(block, cfg, dev, m=8):
    """Every packed leaf of rank 0's layer 0 (``block``: its sharded
    subtree) through the wrapper that the decode step launches on its local
    shard, at ``m`` rows, held against the plain version on the same
    inputs: x in float32 within rtol 1e-5, atol 1e-5*max|ref| (the weights
    of both are exact there), and in the step's compute dtype within
    phase 1's bf16 tolerance (2e-2: the plain version rounds each scaled
    weight to x's dtype, the kernel scales after its K loop). 2-D weights
    go through ``ops.swis_matmul``, expert stacks through
    ``ops.swis_matmul_experts``: ``wi`` and ``wg`` on rows that every
    expert shares, ``wo`` on each expert's own rows. Returns
    ([(name, local shape)], max|err| in float32, in the compute dtype)."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.models.layers import is_packed
    from repro_torch.models.layers import packed_weight as packed_weight_of

    g = torch.Generator(device=dev).manual_seed(13)
    swis_c = cfg.quant.cfg.method == "swis_c"
    dtypes = (torch.float32, getattr(torch, cfg.compute_dtype))
    shapes, errs = [], [0.0, 0.0]

    def one(name, node):
        leaf = {k: v.to_local()[0] for k, v in node.items()}
        sign = leaf["sign_plane"]
        k, n = sign.shape[-2] * 32, sign.shape[-1]
        group = k // leaf["shifts"].shape[-3]
        e = sign.shape[0] if sign.ndim == 3 else None
        shapes.append((name, (e, k, n) if e else (k, n)))
        for i, dt in enumerate(dtypes):
            if e is None:
                x = torch.randn((m, k), generator=g, device=dev).to(dt)
                got = ops.swis_matmul(x, packed_weight_of(leaf, cfg),
                                      keep_slices=cfg.quant.keep_slices)
                want = ref.swis_matmul_ref(
                    x, sign, leaf["mask_planes"], leaf["shifts"],
                    leaf["scale"].reshape(-1).expand(n), group=group,
                    consecutive=swis_c, keep_slices=cfg.quant.keep_slices)
            else:
                own = name.endswith("wo")
                x = torch.randn((e, m, k) if own else (m, k), generator=g,
                                device=dev).to(dt)
                got = ops.swis_matmul_experts(x, leaf, consecutive=swis_c)
                want = ref.swis_matmul_experts_ref(
                    x if own else x[None].expand(e, m, k), sign,
                    leaf["mask_planes"], leaf["shifts"], leaf["scale"],
                    group=group, consecutive=swis_c)
            tol = 1e-5 if dt == torch.float32 else 2e-2
            top = want.abs().max().item()
            err = (got - want).abs().max().item()
            errs[i] = max(errs[i], err)
            check(torch.allclose(got, want, rtol=tol, atol=tol * top),
                  f"rank 0's {name} {shapes[-1][1]} at M={m} {dt}: "
                  f"max|err|={err:.3g} vs max|ref|={top:.3g}")

    def walk(path, node):
        if is_packed(node):
            one("/".join(path), node)
        elif isinstance(node, dict):
            for key, v in node.items():
                walk(path + (key,), v)

    walk((), block)
    return shapes, tuple(errs)


def _rank0_step(arch, dev, card, kernels, card_mesh, want):
    """Rank 0 of ``arch``'s decode_32k on ``card_mesh`` (16, 16) under the
    fake group: its shards built and filled on the card (against ``want``,
    the record's argument bytes), one decode step's SWIS launches (7 a
    layer), wall and device-busy ms and its heaviest kernels. Returns the
    step's launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.parallel import ctx as par_ctx

    qcfg = qat_policy().cfg
    cfg = dryrun.cell_cfg(configs.get_config(arch), SHAPES[RANK0_SHAPE],
                          "qat", qcfg)
    base = torch.cuda.memory_allocated()
    fn, args, _, rules = dryrun.build_step(
        cfg, SHAPES[RANK0_SHAPE], card_mesh, quant="qat", qcfg=qcfg,
        device=dev.type)
    params, batch, cache = args
    _fill_rank0(params, qcfg, dev, 12)
    for block in cache["blocks"].values():
        for t in block.values():
            loc = t.to_local()
            if loc.dtype.is_floating_point:
                loc.normal_()
            else:  # rank 0's slots hold positions [0, 2048)
                loc.copy_(torch.arange(loc.shape[-1], device=dev,
                                       dtype=loc.dtype).expand_as(loc))
    batch["tokens"].to_local().random_(0, cfg.vocab)
    torch.cuda.synchronize()
    alloc = torch.cuda.memory_allocated() - base
    print(f"phase 12 (c) ({RANK0_LABEL}) on {card}: {arch} {RANK0_SHAPE} "
          f"rank 0's shards drawn from seed 12 and packed on the card (4 "
          f"planes, group 4; layer 0's planes in all {cfg.n_layers} "
          f"layers): memory_allocated {alloc} B ({alloc / 1e9:.3f} GB) "
          f"against (b)'s argument bytes {want} ({want / 1e9:.3f} GB): "
          f"{alloc - want:+d} B ({(alloc - want) / want:+.2e})")
    check(abs(alloc - want) <= 1e-3 * want,
          f"{arch} rank 0's shards take {alloc} B, the record says {want}")

    def step():
        with par_ctx.use_rules(rules), torch.no_grad():
            return fn()

    step()  # warm-up
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    t1 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t1) * 1e3
    counts = {k.name: k.launches for k in kernels}
    want_swis = RANK0_SWIS_PER_LAYER * cfg.n_layers
    check(counts == {"swis_matmul": want_swis, "paged_attention": 0},
          f"{arch} rank 0's decode step launched {counts}, expected "
          f"{want_swis} SWIS")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    busy = device_ms(prof)
    by_kernel = sorted(
        ((getattr(e, "self_device_time_total", 0.0) / 1e3, e.key, e.count)
         for e in prof.key_averages()), reverse=True)
    swis_busy = sum(ms for ms, key, _ in by_kernel if "swis" in key)
    print(f"phase 12 (c) ({RANK0_LABEL}) on {card}: {arch}: one decode step "
          f"of 8 rows over rank 0's 2048 of 32768 cached positions: "
          f"{counts['swis_matmul']} SWIS launches ({RANK0_SWIS_PER_LAYER} a "
          f"layer x {cfg.n_layers}), 0 paged; wall {wall:.2f} ms, device "
          f"busy {busy:.3f} ms (SWIS {swis_busy:.3f} ms); heaviest kernels "
          f"(ms, launches): " + "; ".join(
              f"{key[:60]} {ms:.3f} x{n}" for ms, key, n in by_kernel[:6]))
    (block,) = params["blocks"].values()
    shapes, (err32, err_dt) = _hold_rank0_gemms(block, cfg, dev)
    check(len(shapes) == RANK0_SWIS_PER_LAYER,
          f"{arch} layer 0 holds {len(shapes)} packed leaves: {shapes}")
    check(arch != "mistral-large-123b"
          or sorted(s for _, s in shapes) == sorted(RANK0_GEMMS),
          f"mistral-large-123b's rank-0 shapes {shapes} are not the timed "
          f"{RANK0_GEMMS}")
    print(f"phase 12 (c) on {card}: {arch}: the SWIS wrappers at rank 0's "
          f"layer-0 local shapes, on its shards, against the plain version "
          f"at M=8: " + ", ".join(f"{n} {s}" for n, s in shapes)
          + f"; max|err| fp32 x {err32:.3g} (rtol 1e-5, atol "
          f"1e-5*max|ref|), {cfg.compute_dtype} x {err_dt:.3g} (2e-2)")
    return counts


def parallel_phase(dev, card, kernels):
    """(a) the sharded trainer on a one-rank NCCL group and a (1, 1) mesh
    on the card against the unsharded trainer on the same seed and
    batches; (b) the dry-run's three cells on the host, under a fake group
    of 256 ranks; (c) rank 0 of mistral-large-123b's and then dbrx-132b's
    decode_32k on the (16, 16) mesh under that fake group, its shards on
    the card: memory against (b)'s record, one decode step through the
    SWIS kernel (launches and device-busy ms), and the SWIS wrappers at
    each arch's rank-0 local GEMM shapes, on its shards, held against the
    plain version; mistral-large's layer is timed too. Returns (launches by path,
    (c)'s layer timing, seconds by part)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import configs
    from repro_torch.configs.base import SHAPES
    from repro_torch.core.qat import quantize_tree
    from repro_torch.launch import dryrun
    from repro_torch.launch import train as train_launcher
    from repro_torch.parallel import quant as pquant

    secs = {}
    # (a) the sharded trainer on a one-rank NCCL group
    t0 = time.perf_counter()
    unsharded = train_launcher.run(train_launcher.parse_args(
        SHARDED_ARGV + ["--device", dev.type]))
    _one_rank_group("nccl" if dev.type == "cuda" else "gloo")
    try:
        sharded = train_launcher.run(train_launcher.parse_args(
            SHARDED_ARGV + ["--device", dev.type, "--mesh-data", "1",
                            "--mesh-model", "1"]))
        params = sharded["state"].params
        wq = params["blocks"]["sub0_attn"]["attn"]["wq"]["w"]
        qcfg = qat_policy().cfg
        with torch.no_grad():
            want = quantize_tree({"w": wq.to_local()}, qcfg)["w"]
            got = quantize_tree({"w": wq}, qcfg,
                                quant=pquant.fake_quant_dtensor)["w"]
            got = got.to_local()
        same_fq = torch.equal(got, want)
        placements = tuple(wq.placements)
        mesh_shape = tuple(wq.device_mesh.shape)
    finally:
        dist.destroy_process_group()
    a, b = unsharded["losses"], sharded["losses"]
    diff = max(abs(x - y) for x, y in zip(a, b))
    print(f"phase 12 (a) on {card}: smollm-135m QAT (4 shifts, seq 256 x "
          f"batch 16, bf16) through the train launcher, 4 steps: unsharded "
          f"losses {', '.join(f'{x:.6f}' for x in a)}; --mesh-data 1 "
          f"--mesh-model 1 (a one-rank NCCL group, mesh {mesh_shape}) "
          f"{', '.join(f'{x:.6f}' for x in b)}; largest difference "
          f"{diff:.3g}; wq placements {placements}; wall ms a step "
          + ", ".join(f"{r['wall_ms']:.1f}/{q['wall_ms']:.1f}"
                      for r, q in zip(unsharded["records"],
                                      sharded["records"]))
          + " (unsharded/sharded)")
    check(len(b) == 4 and np.isfinite(b).all(), f"sharded losses {b}")
    check(all(abs(x - y) <= 1e-6 * abs(x) for x, y in zip(a, b)),
          f"sharded losses {b} vs unsharded {a} (rtol 1e-6)")
    check(same_fq, "the sharded QAT fake-quant of wq differs from the "
          "unsharded one")
    print("phase 12 (a): the sharded fake-quant of the trained wq is "
          "bit-identical to the unsharded quantize_tree's")
    del unsharded, sharded, params, wq
    gc.collect()
    torch.cuda.empty_cache()
    secs["12 (a)"] = time.perf_counter() - t0

    # (b) the dry-run on the host, under a fake group of 256 ranks
    t0 = time.perf_counter()
    dryrun.fake_world(256)
    recs = {}
    try:
        host_mesh = init_device_mesh("cpu", (16, 16),
                                     mesh_dim_names=("data", "model"))
        for arch, shape in DRYRUN_CELLS:
            t1 = time.perf_counter()
            rec = dryrun.lower_cell(configs.get_config(arch), SHAPES[shape],
                                    host_mesh)
            recs[arch, shape] = rec
            m, c, r = rec["memory"], rec["cost"], rec["roofline"]
            print(f"phase 12 (b) (a prediction of the dry-run, not a "
                  f"measurement; H100 constants): {arch} {shape} on "
                  f"(16, 16): traced in {time.perf_counter() - t1:.1f} s "
                  f"wall; per device: argument bytes "
                  f"{m['argument_bytes']} ({m['argument_bytes'] / 1e9:.3f} "
                  f"GB), temp {m['temp_bytes'] / 1e9:.3f} GB, FLOPs "
                  f"{c['flops']:.4g} (model_flops/chip "
                  f"{rec['model_flops_per_chip']:.4g}), bytes accessed "
                  f"{c['bytes_accessed']:.4g}, collective wire bytes "
                  f"{c['collective_wire']:.4g}, counts "
                  f"{rec['collective_counts']}; roofline compute "
                  f"{r['compute_s']:.4g} s, memory {r['memory_s']:.4g} s, "
                  f"collective {r['collective_s']:.4g} s -> "
                  f"{r['bottleneck']}; SWIS launches "
                  f"{rec['kernel_launches'].get('swis_matmul', 0)}")
            check(rec["cost"]["flops"] > 0
                  and rec["memory"]["argument_bytes"] > 0,
                  f"dry-run record of {arch} {shape}: {rec}")
        secs["12 (b)"] = time.perf_counter() - t0

        # (c) rank 0 of mistral-large-123b's and dbrx-132b's decode_32k on
        # the card, one at a time
        t0 = time.perf_counter()
        card_mesh = init_device_mesh(dev.type, (16, 16),
                                     mesh_dim_names=("data", "model"))
        counts = {}
        for arch in RANK0_ARCHS:
            gc.collect()
            torch.cuda.empty_cache()
            counts[f"12 (c) {arch} rank 0 decode"] = _rank0_step(
                arch, dev, card, kernels, card_mesh,
                recs[arch, RANK0_SHAPE]["memory"]["argument_bytes"])
        gc.collect()
        torch.cuda.empty_cache()
        layer = swis_layer_timing(dev, 8, gemms=RANK0_GEMMS, timer=event_ms)
        print(f"phase 12 (c) ({RANK0_LABEL}) on {card}: swis_matmul at rank "
              f"0's local layer GEMMs ({RANK0_GEMMS}, M=8, fp32 x), by CUDA "
              f"events: kernel {layer['ms']:.5f} ms, torch.matmul "
              f"{layer['library_ms']:.5f} ms, plain {layer['plain_ms']:.4f} "
              f"ms, bound {layer['bound_ms']:.6f} ms ({layer['bound_by']}); "
              f"max|err| {layer['max_abs_err']:.3g}")
        secs["12 (c)"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    return counts, layer, secs


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
        t0 = time.perf_counter()
        perf = {"swis_matmul": swis_phase(dev), "paged_attention": paged_phase(dev)}
        extra_timings(dev, card)
        t1 = time.perf_counter()
        errs, mistral = dense_family_phase(dev, card)
        for name, err in errs.items():
            perf[name]["max_abs_err"] = max(perf[name]["max_abs_err"], err)
        elapsed = {"3": t1 - t0, "3 dense shapes": time.perf_counter() - t1}
        print(f"[phase 3 done: {elapsed['3']:.1f} + {elapsed['3 dense shapes']:.1f} s]")

        # 4. the first slice's path at full width
        t0 = time.perf_counter()
        with plain_weights_once():
            counts, gpu = slice_phase(dev, card, kernels)
        elapsed["4"] = time.perf_counter() - t0
        print(f"[phase 4 done: {elapsed['4']:.1f} s]")

        # 5. the rest of the serve engine at full width, at 10 of the 30
        # layers (the host's time per model call follows the depth, and
        # phase 7 needs the room)
        t0 = time.perf_counter()
        by_path = {"phase 4 greedy block engine": counts}
        cfg10, params10, _ = layer_cut(gpu.cfg, gpu.params, PATHS_LAYERS)
        with plain_weights_once():
            by_path.update(paths_phase(dev, card, kernels, cfg10, params10))
        del params10
        elapsed["5"] = time.perf_counter() - t0
        print(f"[phase 5 done: {elapsed['5']:.1f} s]")

        # 6. observability and the launcher at full width
        t0 = time.perf_counter()
        with plain_weights_once():
            by_path.update(observability_phase(dev, card, kernels, gpu.cfg,
                                               gpu.params))
        elapsed["6"] = time.perf_counter() - t0
        print(f"[phase 6 done: {elapsed['6']:.1f} s]")

        # 7. the MoE family at full width, once phases 4-6's tensors are freed
        del gpu
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        with plain_weights_once():
            moe_paths, experts = moe_phase(dev, card, kernels)
        by_path.update(moe_paths)
        elapsed["7"] = time.perf_counter() - t0
        print(f"[phase 7 done: {elapsed['7']:.1f} s]")

        # 8. the recurrent families at full width, one at a time
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        with plain_weights_once():
            griffin_paths, recurrent = griffin_phase(dev, card, kernels)
        by_path.update(griffin_paths)
        gc.collect()
        torch.cuda.empty_cache()
        with plain_weights_once():
            by_path.update(mamba_phase(dev, card, kernels))
        perf["swis_matmul"]["max_abs_err"] = max(
            [perf["swis_matmul"]["max_abs_err"]]
            + [p["max_abs_err"] for p in recurrent.values()])
        elapsed["8"] = time.perf_counter() - t0
        print(f"[phase 8 done: {elapsed['8']:.1f} s]")

        # 9. the VLM and encoder families at full width and depth, one at a
        # time; the kernels at their shapes first
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        new_shapes = vlm_kernel_phase(dev, card)
        secs9 = {"9 (b)": time.perf_counter() - t0}
        with plain_weights_once():
            vlm_paths, secs = vlm_phase(dev, card, kernels)
        by_path.update(vlm_paths)
        secs9.update(secs)
        gc.collect()
        torch.cuda.empty_cache()
        with plain_weights_once():
            enc_paths, secs9["9 (a, e) encoder"] = encoder_phase(
                dev, card, kernels)
        by_path.update(enc_paths)
        new_shapes["mistral-large-123b wq and MLP wo M=4"] = mistral
        paged_vlm = new_shapes.pop("paged")
        perf["swis_matmul"]["max_abs_err"] = max(
            [perf["swis_matmul"]["max_abs_err"]]
            + [p["max_abs_err"] for p in new_shapes.values()])
        perf["paged_attention"]["max_abs_err"] = max(
            perf["paged_attention"]["max_abs_err"], paged_vlm["max_abs_err"])
        elapsed["9"] = time.perf_counter() - t0
        print(f"[phase 9 done: {elapsed['9']:.1f} s: " + ", ".join(
            f"{k} {v:.1f} s" for k, v in secs9.items()) + "]")

        # 10. SWIS QAT training at full width, once phase 9's tensors are
        # freed, and its checkpoint served
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        with plain_weights_once():
            qat_paths, secs10 = qat_phase(dev, card, kernels)
        by_path.update(qat_paths)
        elapsed["10"] = time.perf_counter() - t0
        print(f"[phase 10 done: {elapsed['10']:.1f} s: " + ", ".join(
            f"{k} {v:.1f} s" for k, v in secs10.items()) + "]")

        # 11. the offline toolchain (budget, scheduler, perf model) and
        # serving at 2.5 shifts, once phase 10's tensors are freed
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        with plain_weights_once():
            tool_paths, three_planes, secs11 = toolchain_phase(dev, card,
                                                               kernels)
        by_path.update(tool_paths)
        perf["swis_matmul"]["max_abs_err"] = max(
            perf["swis_matmul"]["max_abs_err"], three_planes["max_abs_err"])
        elapsed["11"] = time.perf_counter() - t0
        print(f"[phase 11 done: {elapsed['11']:.1f} s: " + ", ".join(
            f"{k} {v:.1f} s" for k, v in secs11.items()) + "]")

        # 12. parallel and the dry-run, once phase 11's tensors are freed
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        par_paths, rank0_layer, secs12 = parallel_phase(dev, card, kernels)
        by_path.update(par_paths)
        perf["swis_matmul"]["max_abs_err"] = max(
            perf["swis_matmul"]["max_abs_err"], rank0_layer["max_abs_err"])
        elapsed["12"] = time.perf_counter() - t0
        print(f"[phase 12 done: {elapsed['12']:.1f} s: " + ", ".join(
            f"{k} {v:.1f} s" for k, v in secs12.items()) + "]")
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
                     "replaces": replaces,
                     "launches": sum(c[name] for c in by_path.values()),
                     "launches_by_path": {k: c[name] for k, c in by_path.items()},
                     "max_abs_err": p["max_abs_err"], "ms": p["ms"],
                     "plain_ms": p["plain_ms"], "bound_ms": p["bound_ms"],
                     "bound_by": p["bound_by"], "library_ms": p["library_ms"],
                     "timed": p["timed"]})
    rows[0]["expert_launch"] = {
        **{k: experts[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "max_abs_err")},
        "launches": sum(experts["launches"].values()),
        "launches_by_path": experts["launches"],
        "timed": (f"one {MOE_ARCH} decode layer's 3 expert stacks (E 64) at "
                  f"M=4, fp32 x, by CUDA events behind a spin kernel; "
                  f"library: torch.bmm over the dequantized float32 stack")}
    # the recurrent families' layers (phase 8 (b)), by CUDA events behind a
    # spin kernel; library: torch.matmul on the dense fp32 weights
    rows[0]["recurrent_layers"] = {
        label: {k: p[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms", "max_abs_err")}
        for label, p in recurrent.items()}
    # the VLM's, the encoder's and mistral-large-123b's shapes (phases 3
    # and 9 (b)), by CUDA events behind a spin kernel
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err")
    rows[0]["vlm_encoder_shapes"] = {
        label: {k: p[k] for k in keys} for label, p in new_shapes.items()}
    rows[0]["three_planes"] = {
        **{k: three_planes[k] for k in keys},
        "timed": ("one smollm-135m decode layer's 7 GEMMs at M=4 packed at "
                  "n_shifts 2.5 (3 planes, half the columns at 2 shifts), "
                  "fp32 x, by CUDA events behind a spin kernel; library: "
                  "torch.matmul on the dense fp32 weight")}
    rows[0]["rank0_mistral_layer"] = {
        **{k: rank0_layer[k] for k in keys},
        "timed": (f"rank 0's local GEMMs of one {RANK0_ARCHS[0]} layer on the "
                  f"(16, 16) mesh {RANK0_GEMMS} at M=8, fp32 x, by CUDA "
                  f"events behind a spin kernel; library: torch.matmul on "
                  f"the dense fp32 weight ({RANK0_LABEL})")}
    rows[1]["vlm_decode"] = {
        **{k: paged_vlm[k] for k in keys},
        "timed": (f"one {VLM_ARCH} decode launch (B 4, 32 heads over 8 of "
                  f"Dh 128, 16 logical blocks, fp32 cache) by CUDA events "
                  f"behind a spin kernel; library: SDPA over the gathered "
                  f"K/V")}
    rows[1]["qwen2_moe_decode"] = {
        **{k: experts["paged_decode"][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                     "max_abs_err")},
        "timed": (f"one {MOE_ARCH} decode launch (B 4, 16 heads of Dh 128, "
                  f"12 logical blocks, fp32 cache) by CUDA events behind a "
                  f"spin kernel; library: SDPA over the gathered K/V")}
    print(f"kernel times from: {sorted(TIMING_SOURCE)}; "
          f"total {time.perf_counter() - t_start:.1f} s on {card} (phases "
          + ", ".join(f"{k} {v:.1f} s" for k, v in elapsed.items()) + ")")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
