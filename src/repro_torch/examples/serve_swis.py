"""Serve a small model with SWIS-compressed (bit-plane packed) weights
through the port's continuous-batching engine: requests with different
prompt lengths and token budgets join mid-flight, prefilling into free
slots while earlier requests keep decoding. Each request is then checked
token for token against its own run through the static-batch
``DecodeEngine``, and the engine's metrics, cost model and trace summary
are printed.

Run:  python -m repro_torch.examples.serve_swis [--n-slots 2 --tokens 16]
      (on the card; add ``--device cpu`` for the plain PyTorch path)
"""
import argparse

import numpy as np
import torch

from repro_torch import configs as C
from repro_torch import device as _device
from repro_torch.core.swis import QuantConfig
from repro_torch.models import params as pp
from repro_torch.models.model import Model
from repro_torch.serve import (ContinuousBatchingEngine, DecodeEngine,
                               EngineConfig, SamplingParams)
from repro_torch.serve.metrics import format_report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=list(C.ARCH_IDS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-slots", type=int, default=2)
    ap.add_argument("--requests", type=int, default=5)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--n-shifts", type=int, default=4)
    args = ap.parse_args(argv)

    dev = _device.resolve(args.device)
    cfg = C.get_smoke(args.arch).replace(compute_dtype="float32")
    params = pp.init_params(Model(cfg).build(),
                            torch.Generator(device=dev).manual_seed(0),
                            device=dev)

    qcfg = QuantConfig(method="swis", n_shifts=args.n_shifts, group_size=4)
    eng = ContinuousBatchingEngine(cfg, params, config=EngineConfig(
        max_len=64, n_slots=args.n_slots, packed=True, quant_cfg=qcfg),
        device=dev)
    print(f"packed {eng.pack_stats['n_packed']} GEMM weights, "
          f"compression {eng.pack_stats['compression']:.2f}x "
          f"(N={args.n_shifts} shifts, group 4); "
          f"{args.n_slots} decode slots on {dev}")

    # mixed prompt lengths, staggered arrival: half the requests are
    # submitted only after the engine has already been decoding for a while
    rng = np.random.default_rng(0)
    lens = rng.integers(4, 17, args.requests)
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
               for n in lens]
    results = {}

    def collect(finished):
        for f in finished:
            results[f.rid] = np.concatenate([f.prompt, f.tokens])

    rids = [eng.submit(p, SamplingParams(max_tokens=args.tokens, seed=i))
            for i, p in enumerate(prompts[: len(prompts) // 2 + 1])]
    for _ in range(4):  # decode a few steps before the late arrivals
        collect(eng.step())
    rids += [eng.submit(p, SamplingParams(max_tokens=args.tokens,
                                          seed=len(rids) + i))
             for i, p in enumerate(prompts[len(prompts) // 2 + 1:])]
    results.update(eng.drain())

    # parity spot-check: each request must match its solo static-batch run
    legacy = DecodeEngine(cfg, params, max_len=64, batch=1, packed=True,
                          quant_cfg=qcfg, device=dev)
    legacy_ok = 0
    for p, rid in zip(prompts, rids):
        want = legacy.generate(p[None], args.tokens)[0]
        legacy_ok += int(np.array_equal(results[rid][len(p):],
                                        want[len(p):]))
    print(f"served {len(rids)} mixed-length requests "
          f"({lens.min()}-{lens.max()} prompt tokens) x {args.tokens} "
          f"generated; {legacy_ok}/{len(rids)} match the static-batch "
          f"engine token-for-token")
    print("sample:", results[rids[0]].tolist())

    # one snapshot: cache health, arena occupancy, scheduler counters,
    # per-phase step latency
    m = eng.metrics()
    if "block_pool" in m:
        print(f"prefix cache: hit_rate="
              f"{m['prefix_cache']['hit_rate']:.2f} "
              f"saved_tokens={m['prefix_cache']['saved_tokens']} "
              f"pool_occupancy={m['block_pool']['occupancy']:.2f} "
              f"({m['block_pool']['used_blocks']}/"
              f"{m['block_pool']['usable_blocks']} blocks)")
    print(f"scheduler: finished={m['scheduler']['finished']} "
          f"admitted={m['scheduler']['admitted']} "
          f"unadmitted={m['scheduler']['unadmitted']}")
    snap = eng.metrics_registry.snapshot()
    print(format_report(snap, title="step-phase timing + dispatch costs"))
    # analytical per-dispatch cost model: predicted HBM traffic of the
    # packed weights vs what 8-bit dense would have streamed
    cm = m["engine"]["cost_model"]
    print(f"cost model: {cm['n_packed_leaves']}/{cm['n_gemm_leaves']} "
          f"GEMMs packed, {cm['weight_bytes_per_dispatch'] / 2**20:.2f}"
          f"MiB weight traffic/dispatch "
          f"(8-bit dense: {cm['weight_bytes_dense8'] / 2**20:.2f}MiB); "
          f"predicted total "
          f"{snap['counters'].get('cost.hbm_bytes', 0) / 2**20:.1f}MiB "
          f"moved at "
          f"{snap['gauges'].get('cost.hbm_bytes_per_s', 0) / 2**20:.1f}"
          f"MiB/s model-implied bandwidth")
    tsum = eng.tracer.summary()
    if tsum["ttft_s"]:
        print(f"ttft: p50={tsum['ttft_s']['p50'] * 1e3:.1f}ms "
              f"p95={tsum['ttft_s']['p95'] * 1e3:.1f}ms  "
              f"tpot: p50={tsum['tpot_s']['p50'] * 1e3:.2f}ms "
              f"(from {tsum['events']} trace events)")
    return legacy_ok == len(rids)


if __name__ == "__main__":
    raise SystemExit(0 if main() else 1)
