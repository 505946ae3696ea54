"""Serving launcher of the port: continuous-batching decode with optional
SWIS-packed weights, on the card unless asked for the CPU.

  python -m repro_torch.launch.serve --arch smollm-135m --packed \
      --requests 8 --prompt-len 64 --tokens 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
      --smoke --device cpu --packed

``--engine static`` runs the lockstep ``DecodeEngine`` instead (equal
prompt lengths only), to A/B the two hot paths.

The flags, the periodic metrics line on stderr every ``--metrics-every``
steps, the final phase and cost report, ``--trace-out`` (a ``.json`` path
gets Chrome trace-event JSON, open in Perfetto; anything else the
request-lifecycle JSONL), the JSON report and the ``sample:`` line are
those of ``repro.launch.serve``. Weights are random, from a seeded
``torch.Generator``; with ``--packed`` they are drawn and packed one layer
at a time (``serve.quantized.init_packed_params``), so a model too large
in float32 for the card (qwen2-moe-a2.7b: ~60 GB) is served packed
(~19 GB). ``--ckpt`` is not served yet. Compute is float32.

  python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b --packed
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b \
      --smoke --device cpu --packed

``--arch`` takes every arch of the registry. The VLM
(llama-3.2-vision-11b) serves text-only requests, as the reference
launcher does; the encoder (hubert-xlarge) has no decoder, and the run
raises the engines' ``ValueError`` before any weight is drawn.
"""
from __future__ import annotations

import argparse
import functools
import json
import sys
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import configs as C
from repro_torch import device as _device
from repro_torch.core.swis import QuantConfig
from repro_torch.models import params as pp
from repro_torch.models.model import Model
from repro_torch.serve import (ContinuousBatchingEngine, DecodeEngine,
                               EngineConfig, SamplingParams)
from repro_torch.serve.engine import require_decoder
from repro_torch.serve.metrics import format_report
from repro_torch.serve.quantized import init_packed_params


def _metrics_line(step: int, m: dict) -> str:
    """One compact periodic report line from an ``engine.metrics()``
    snapshot."""
    sched = m["scheduler"]
    parts = [f"[step {step}]",
             f"queue={sched['queue_depth']}",
             f"active={sched['active_slots']}",
             f"prefilling={sched['prefilling_slots']}",
             f"finished={sched['finished']}"]
    if "block_pool" in m:
        parts.append(f"pool_occ={m['block_pool']['occupancy']:.2f}")
        parts.append(f"hit_rate={m['prefix_cache']['hit_rate']:.2f}")
    total = m["engine"]["phases"].get("step.total_s")
    if total and total["count"]:
        parts.append(f"p50_step={total['p50'] * 1e3:.2f}ms")
        parts.append(f"p95_step={total['p95'] * 1e3:.2f}ms")
    return " ".join(parts)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="Serve random-weight requests through the port's engine.")
    ap.add_argument("--arch", required=True, choices=list(C.ARCH_IDS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; there is "
                         "no fallback: pass cpu for the plain version)")
    ap.add_argument("--engine", choices=("continuous", "static"),
                    default="continuous")
    ap.add_argument("--requests", type=int, default=8,
                    help="number of requests to serve")
    ap.add_argument("--n-slots", type=int, default=4,
                    help="concurrent decode slots (continuous engine)")
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked prefill: at most this many prompt tokens "
                         "per engine step (continuous engine, block mode)")
    ap.add_argument("--fused", action="store_true",
                    help="fused mixed step: the per-step prefill chunk and "
                         "the decode batch share ONE dispatch (requires "
                         "--prefill-chunk)")
    ap.add_argument("--spec", action="store_true",
                    help="self-speculative decode: draft --spec-k tokens "
                         "with the model truncated to --draft-slices SWIS "
                         "bit-planes, verify in one full-precision launch "
                         "(continuous engine; token-exact vs plain decode)")
    ap.add_argument("--spec-k", type=int, default=3,
                    help="max draft tokens per speculative round")
    ap.add_argument("--draft-slices", type=int, default=None,
                    help="bit-slices kept for the draft pass (requires "
                         "--packed; default: full precision)")
    ap.add_argument("--packed", action="store_true")
    ap.add_argument("--n-shifts", type=int, default=4)
    ap.add_argument("--group-size", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--ckpt", default=None, help="checkpoint dir to serve "
                    "(not ported yet)")
    ap.add_argument("--metrics-every", type=int, default=25,
                    help="print a metrics line every N engine steps "
                         "(continuous engine; 0 disables)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="export the trace: *.json -> Chrome trace-event "
                         "JSON (load in Perfetto), else lifecycle JSONL")
    return ap.parse_args(argv)


def run(args: argparse.Namespace,
        params: Any = None) -> Tuple[Dict[str, Any], Any]:
    """Serve ``args.requests`` random prompts and print the report, as the
    reference launcher's ``main``. ``params`` (a parameter tree on any
    device) replaces the seeded random weights, so a caller can serve
    weights it holds. Returns (the report, the engine that served it)."""
    if args.ckpt:
        raise NotImplementedError(
            "--ckpt: the checkpoint manager is not ported yet (ROADMAP A10)")
    dev = _device.resolve(args.device)
    cfg = C.get_smoke(args.arch) if args.smoke else C.get_config(args.arch)
    cfg = cfg.replace(compute_dtype="float32")
    require_decoder(cfg)
    qcfg = QuantConfig(method="swis", n_shifts=args.n_shifts,
                       group_size=args.group_size)
    pack_stats = None
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(0)
        if args.packed:
            params, pack_stats = init_packed_params(Model(cfg).build(), qcfg,
                                                    gen, device=dev)
        else:
            params = pp.init_params(Model(cfg).build(), gen, device=dev)

    max_len = args.prompt_len + args.tokens + 1
    rng = np.random.default_rng(0)
    prompts = rng.integers(
        0, cfg.vocab, (args.requests, args.prompt_len)).astype(np.int32)

    if args.engine == "static":
        eng = DecodeEngine(cfg, params, max_len=max_len, batch=args.requests,
                           packed=args.packed, quant_cfg=qcfg, device=dev)
        t0 = time.perf_counter()
        out = eng.generate(prompts, args.tokens,
                           temperature=args.temperature)
        dt = time.perf_counter() - t0
        sample = out[0]
    else:
        eng = ContinuousBatchingEngine(
            cfg, params, config=EngineConfig(
                max_len=max_len, n_slots=args.n_slots, packed=args.packed,
                quant_cfg=qcfg, prefill_chunk=args.prefill_chunk,
                fused_step=args.fused, spec_decode=args.spec,
                spec_k=args.spec_k, draft_slices=args.draft_slices),
            device=dev)
        sp = functools.partial(SamplingParams, max_tokens=args.tokens,
                               temperature=args.temperature)
        rids = [eng.submit(p, sp(seed=i)) for i, p in enumerate(prompts)]
        t0 = time.perf_counter()
        results = {}
        step = 0
        while eng.scheduler.pending():
            for f in eng.step():
                results[f.rid] = np.concatenate([f.prompt, f.tokens])
            step += 1
            if args.metrics_every and step % args.metrics_every == 0:
                print(_metrics_line(step, eng.metrics()), file=sys.stderr)
        dt = time.perf_counter() - t0
        sample = results[rids[0]]
        print(format_report(eng.metrics_registry.snapshot(),
                            title="serve metrics"), file=sys.stderr)
        if args.trace_out:
            if args.trace_out.endswith(".json"):
                n = eng.tracer.export_chrome_trace(args.trace_out)
                print(f"trace: {n} Chrome trace events -> "
                      f"{args.trace_out} (open at https://ui.perfetto.dev)",
                      file=sys.stderr)
            else:
                n = eng.tracer.export_jsonl(args.trace_out)
                print(f"trace: {n} events -> {args.trace_out}",
                      file=sys.stderr)

    report = {"arch": cfg.name, "engine": args.engine,
              "requests": args.requests, "n_slots": args.n_slots,
              "tokens": args.tokens, "wall_s": round(dt, 2),
              "tok_per_s": round(args.requests * args.tokens / dt, 1)}
    pack_stats = pack_stats or eng.pack_stats
    if pack_stats:
        report["packed_weights"] = pack_stats["n_packed"]
        report["compression"] = round(pack_stats["compression"], 2)
    if args.engine != "static":
        stats = eng.prefix_stats()
        if stats.get("enabled"):
            report["prefix_hit_rate"] = round(stats["hit_rate"], 3)
            report["prefill_tokens_saved"] = stats["saved_tokens"]
        snap = eng.metrics_registry.snapshot()
        if "cost.hbm_bytes" in snap["counters"]:
            # cost-model totals: predicted traffic of the issued
            # dispatches, and the model-implied bandwidth over the run
            report["cost_hbm_mib"] = round(
                snap["counters"]["cost.hbm_bytes"] / 2**20, 2)
            report["cost_gflops"] = round(
                snap["counters"]["cost.flops"] / 1e9, 3)
            report["cost_hbm_bytes_per_s"] = round(
                snap["gauges"].get("cost.hbm_bytes_per_s", 0.0), 1)
        tsum = eng.tracer.summary()
        if tsum["ttft_s"]:
            report["ttft_p50_s"] = round(tsum["ttft_s"]["p50"], 5)
            report["ttft_p95_s"] = round(tsum["ttft_s"]["p95"], 5)
        if tsum["tpot_s"]:
            report["tpot_p50_s"] = round(tsum["tpot_s"]["p50"], 6)
        if args.spec:
            c = snap["counters"]
            report["spec_proposed"] = c.get("spec.proposed", 0)
            report["spec_accepted"] = c.get("spec.accepted", 0)
            report["spec_accept_rate"] = round(
                c.get("spec.accepted", 0)
                / max(c.get("spec.proposed", 0), 1), 3)
    print(json.dumps(report, indent=1))
    print("sample:", sample.tolist())
    return report, eng


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
