"""Run one cell of the port's benchmark once and print its result line.

    python portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

``--trace 0`` measures the cell's end-to-end metrics with the engine's
metrics off; ``--trace 1`` turns the engine's metrics and a device trace
on and reports the per-layer metrics instead. Either way, once the window
has closed the plain reference judges a sample of the served tokens
(``reference/``), and the last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (and with
``--trace 1`` ``breakdown``), then ``checks``, each compared number beside
its limit. Everything the cell needs is found by name from BENCHMARK.json:
``configs/<config>.json``, ``traffic/<mix>.json``, ``limits/<cell>.json``
and ``metrics/<metric>.py``.
"""
from __future__ import annotations

import os
import time


def _process_age() -> float:
    """Seconds since this process started (Linux /proc)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


T_START = time.perf_counter() - _process_age()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
THREADS = 2  # host threads for torch and OpenMP: one process, few threads
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def environment() -> None:
    """Fixed host threads, and every cache inside the checkout."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(THREADS)
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    here = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != here]
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def card_state() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.mem,"
             "power.draw,power.limit,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def main(argv=None, smoke: bool = False) -> int:
    """One run. ``smoke`` (the CPU tests) skips the look for a card and
    runs the configuration's smoke sizes on the CPU."""
    args = parse(argv)
    environment()
    import torch

    torch.set_num_threads(THREADS)
    from portbench import harness
    from portbench.metrics import reader

    _, cell, _, _, _ = harness.load_cell(args.workload)
    if not smoke:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < cell["chips"]:
            log(f"portbench: the cell needs {cell['chips']} CUDA device(s), "
                f"this machine has {n}")
            return 2
    dev = "cpu" if smoke else "cuda"
    run = harness.Run(args.workload, args.seed, dev, smoke=smoke,
                      trace=bool(args.trace), t_start=T_START)
    with torch.no_grad():
        run.setup()
        run.window(args.seconds)
    e2e = run.end_to_end()
    log(f"portbench: host cpus {os.cpu_count()}, torch threads "
        f"{torch.get_num_threads()}; card {card_state()}")
    log(f"portbench: set-up {e2e['setup_s']:.3f} s = " + ", ".join(
        f"{k} {v:.3f}" for k, v in run.split.items()) + f" + imports "
        f"{e2e['setup_s'] - sum(run.split.values()):.3f}")
    log(f"portbench: window {run.t1 - run.t0:.3f} s, {len(run.window_steps())}"
        f" steps, {run.counts['tokens']} tokens, {run.counts['gaps']} token "
        f"gaps, {run.counts['first_tokens']} first tokens, "
        f"{run.attempted()} requests attempted; generator "
        f"{run.gen_s * 1e3:.1f} ms")
    bench = run.bench
    wanted = [m for m in bench["end_to_end"]
              if "workloads" not in m or args.workload in m["workloads"]]
    metrics, breakdown, device = {}, None, {}
    if args.trace:
        spans = [(s.name, s.ts, s.dur) for s in run.engine.tracer.spans()]
        tr = run.engine.metrics()["trace"]
        if tr["dropped"] or tr["dropped_spans"]:
            log(f"portbench: the trace ring dropped events: {tr}")
            return 3
        run.devtrace_result = (run.devtrace.reduce(spans)
                               if run.devtrace.done else None)
        for m in bench["per_layer"]:
            scope = m.get("workloads")
            if scope is None:
                scope = [w["name"] for w in bench["workloads"]
                         if any(e["name"] == m["moves"] and (
                             "workloads" not in e
                             or w["name"] in e["workloads"])
                             for e in bench["end_to_end"])]
            if args.workload not in scope:
                continue
            value = reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        t = run.devtrace_result
        if t is not None:
            device.update(busy_s=t["busy_s"], window_s=t["window_s"])
            breakdown = {"device_ops": t["device_ops"],
                         "idle_gaps": t["idle_gaps"]}
    else:
        for m in wanted:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    if smoke:
        device = {"platform": "cpu", "kind": "cpu", "count": 0,
                  "memory_peak_bytes": 0, **device}
    else:
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                  "count": cell["chips"],
                  "memory_peak_bytes": int(torch.cuda.max_memory_allocated()),
                  **device}
    attempted = run.attempted()
    numbers = run.judge()
    log(f"portbench: judged {numbers['requests']} requests, "
        f"{numbers['tokens']} served tokens in {numbers['launches']} "
        f"prefill launches; {numbers['not_first']} not the reference's "
        f"first choice; widest gap {numbers['max_gap']!r}, widest logit "
        f"distance {numbers['logit_err']!r}; reference "
        f"{numbers['reference_s']:.1f} s")
    found = forbidden_modules()
    if found:
        log(f"portbench: forbidden modules loaded: {found}")
        return 4
    for name, c in run.checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    result = {"correct": run.correct, "attempted": attempted, "failed": 0,
              "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = run.checks
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
