"""One run of one cell: set-up, the measured window, and the judged sample.

The window drives ``repro_torch.serve.engine.ContinuousBatchingEngine``
through ``submit`` and ``step`` exactly as a serving front end would: a
closed loop of clients (``traffic.py``), each sending its next request as
soon as ``step()`` hands back its last one. Every token is time-stamped on
the host clock when the ``step()`` that produced it returns (its tokens
are on the host by then). Each step is logged with the work it did, read
off the tokens it produced: the prompts it prefilled and its decode rows
with their context lengths. Which rows each prefill launch held, at what
padded length, and the logit of every served token are read where the
program hands them on (``Run._tap``), without a sync.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import traffic, weights, work
from portbench.reference.decoder import Job

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
TRACE_CAPACITY = 1 << 22  # trace ring events; a run fails if it drops any
WAVE = 8  # clients whose first requests are sent together in set-up


def load_cell(workload: str):
    """(BENCHMARK.json, cell, config, traffic mix, limits) of a workload
    named in BENCHMARK.json; each part found by name under ``portbench/``."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / conf["file"]).read_text())
    mix = traffic.load(BENCH / "traffic" / f"{cell['traffic']}.json")
    limits = json.loads((BENCH / "limits" / f"{workload}.json").read_text())
    return bench, cell, config, mix, limits


def arch_of(config: dict, smoke: bool = False) -> dict:
    """The port's model fields from a configuration file: the published
    sizes (Hugging Face keys) and the port's own block; the ``smoke``
    block overrides sizes for the CPU tests."""
    c = {**config, **(config["smoke"] if smoke else {})}
    arch = {"n_layers": c["num_hidden_layers"], "d_model": c["hidden_size"],
            "n_heads": c["num_attention_heads"],
            "n_kv_heads": c["num_key_value_heads"], "vocab": c["vocab_size"],
            "rope_theta": float(c["rope_theta"]),
            "d_ff": c["intermediate_size"]}
    arch["head_dim"] = arch["d_model"] // arch["n_heads"]
    if "num_experts" in c:
        arch["d_ff"] = c["moe_intermediate_size"]
        arch["moe"] = {
            "n_experts": c["num_experts"], "top_k": c["num_experts_per_tok"],
            "d_ff_expert": c["moe_intermediate_size"],
            "d_ff_shared": c["shared_expert_intermediate_size"],
            "n_shared": (c["shared_expert_intermediate_size"]
                         // c["moe_intermediate_size"]),
            **c["port"]["moe"]}
    return arch


def port_config(arch: dict, config: dict):
    """(ArchConfig, QuantConfig) of the port for ``arch``."""
    from repro_torch.configs.base import ArchConfig, MoEConfig
    from repro_torch.core.swis import QuantConfig

    serve = config["serve"]
    moe = None
    if "moe" in arch:
        m = arch["moe"]
        moe = MoEConfig(n_experts=m["n_experts"], top_k=m["top_k"],
                        n_shared=m["n_shared"], d_ff_expert=m["d_ff_expert"],
                        capacity_factor=m["capacity_factor"],
                        group_tokens=m["group_tokens"],
                        n_experts_padded=m["n_experts_padded"])
    cfg = ArchConfig(
        name=config["name"], family="moe" if moe else "dense",
        n_layers=arch["n_layers"], d_model=arch["d_model"],
        n_heads=arch["n_heads"], n_kv_heads=arch["n_kv_heads"],
        d_ff=arch["d_ff"], vocab=arch["vocab"], rope_theta=arch["rope_theta"],
        vocab_pad_multiple=config["port"]["vocab_pad_multiple"], moe=moe,
        compute_dtype=serve["compute_dtype"])
    q = serve["quant"]
    return cfg, QuantConfig(method=q["method"], n_shifts=q["n_shifts"],
                            group_size=q["group_size"], bits=q["bits"])


def warm_lengths(lo: int, hi: int) -> List[int]:
    """Prompt lengths that cover [lo, hi] in doubling steps: lo, every
    power of two between, and hi."""
    out, n = [lo], 1 << lo.bit_length()
    while n < hi:
        out.append(n)
        n <<= 1
    return sorted(set(out + [hi]))


@dataclasses.dataclass
class Request:
    rid: int
    index: int  # position in the mix's sequence
    prompt: np.ndarray
    n_out: int
    sent: float
    times: List[float] = dataclasses.field(default_factory=list)
    tokens: Optional[np.ndarray] = None  # when finished
    step_first: int = -1  # the step that prefilled it
    launch: int = -1  # the prefill launch that held it
    # per served token: (index of the model call in Run.maxima, its row)
    logit_rows: List[tuple] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Launch:
    """One prefill launch as the program made it: the step it ran in, its
    padded length, the cached prefix its rows reused, and its rows'
    requests in row order."""

    step: int
    s_pad: int
    p_len: int
    rids: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Step:
    end: float
    prefill: List[int]  # rids prefilled this step
    decode_ctx: List[int]  # positions each decode row attended
    traced: bool = False


class Run:
    """Everything one run needs and records (engine, requests, steps)."""

    def __init__(self, workload: str, seed: int, device="cuda",
                 smoke: bool = False, trace: bool = False,
                 t_start: Optional[float] = None):
        self.t_start = time.perf_counter() if t_start is None else t_start
        (self.bench, self.cell, self.config, self.mix,
         self.limits) = load_cell(workload)
        if smoke:
            self.mix = {**self.mix, **self.mix["smoke"]}
        self.workload, self.seed, self.smoke = workload, seed, smoke
        self.dev = torch.device(device)
        self.trace = trace
        self.arch = arch_of(self.config, smoke)
        self.cfg, self.qcfg = port_config(self.arch, self.config)
        self.work = work.Model(self.arch, self.qcfg.n_shifts,
                               self.qcfg.group_size)
        self.max_len = traffic.max_len(self.mix)
        self.split: Dict[str, float] = {}
        self.reqs: Dict[int, Request] = {}
        self.steps: List[Step] = []
        self.gen_s = 0.0

    # -- set-up ------------------------------------------------------------

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def make_weights(self) -> dict:
        tree = weights.placeholders(self.cfg, self.qcfg)
        w = weights.make(tree, self.seed, self.dev)
        self._sync()
        return w

    def setup(self) -> None:
        """Weights from the seed, the engine, warm-up of the shapes the
        mix reaches, then every client's first request prefilled."""
        from repro_torch.serve import ContinuousBatchingEngine, EngineConfig

        t = time.perf_counter()
        params = self.make_weights()
        self.split["weights_s"] = time.perf_counter() - t
        serve = self.config["serve"]
        self.engine = ContinuousBatchingEngine(
            self.cfg, params, EngineConfig(
                max_len=self.max_len, n_slots=self.mix["clients"],
                block_size=serve["block_size"],
                cache_dtype=getattr(torch, serve["cache_dtype"]),
                packed=True, quant_cfg=self.qcfg, use_paged_kernel=True,
                prefix_cache=True, enable_metrics=self.trace,
                trace_capacity=TRACE_CAPACITY), device=self.dev)
        del params
        self._warm()
        self.engine.reset()
        self._tap()
        self.loop = traffic.ClosedLoop(self.mix, self.seed, self.arch["vocab"])
        # clients arrive in waves, so that no prefill launch is larger
        # than the ones the loop makes later (a launch's working cache is
        # as long as a slot's, whatever its prompts)
        for c in range(self.mix["clients"]):
            self._send(*self.loop.first(c))
            if (c + 1) % WAVE and c + 1 < self.mix["clients"]:
                continue
            while any(r.step_first < 0 for r in self.reqs.values()
                      if r.index < 0):
                self._step()
        self.t0 = time.perf_counter()
        self.split["engine_and_first_prefill_s"] = (
            self.t0 - t - sum(self.split.values()))

    def _warm(self) -> None:
        """One request at each of ``warm_lengths`` of the mix's prompts
        (the first also builds and loads the kernels), two tokens each:
        prefill launches over the prompt range in doubling steps, and the
        decode step over every slot."""
        p = self.mix["prompt"]
        rng = np.random.default_rng([self.seed % (1 << 63), 3])
        from repro_torch.serve import SamplingParams

        for i, n in enumerate(warm_lengths(p["lo"], p["hi"])):
            t = time.perf_counter()
            self.engine.submit(rng.integers(0, self.arch["vocab"], n),
                               SamplingParams(max_tokens=2))
            self.engine.drain()
            self._sync()
            key = "kernels_s" if i == 0 else "warm_s"
            self.split[key] = self.split.get(key, 0.0) + (
                time.perf_counter() - t)
        self.split.setdefault("warm_s", 0.0)

    def _tap(self) -> None:
        """Read what the program hands on, with no sync: each model call's
        logits, kept on the device as their row maxima (the greedy tokens'
        logits), and from the scheduler which request each row of a call
        serves and which rows each prefill launch held. A model call that
        comes through another entry leaves the next record without logits,
        and the run fails there."""
        model, sch = self.engine.model, self.engine.scheduler
        self.launches: List[Launch] = []
        self.maxima: List[torch.Tensor] = []
        fresh = {"kind": None}

        def keep(logits, kind):
            self.maxima.append(logits.detach().amax(-1))
            fresh["kind"] = kind

        def taken(kind):
            if fresh["kind"] != kind:
                raise RuntimeError(
                    f"a {kind} record came without the logits of a {kind} "
                    f"call: the harness reads prefill_bucketed, "
                    f"prefill_chunk and decode_step")
            if kind == "decode":
                fresh["kind"] = None
            return len(self.maxima) - 1

        def prefill(real, prefix):
            def call(params, batch, cache, *rest):
                logits, cache = real(params, batch, cache, *rest)
                keep(logits, "prefill")
                self.launches.append(Launch(
                    len(self.steps), int(batch["tokens"].shape[1]),
                    prefix(rest)))
                return logits, cache
            return call

        def decode(*a, **kw):
            logits, cache = real_decode(*a, **kw)
            keep(logits, "decode")
            return logits, cache

        def record_prefill(slot, tok):
            i, launch = taken("prefill"), self.launches[-1]
            r = self.reqs[sch.slots[slot].req.rid]
            r.launch = len(self.launches) - 1
            r.logit_rows.append((i, len(launch.rids)))
            launch.rids.append(r.rid)
            real_rp(slot, tok)

        def record_decode(toks):
            i = taken("decode")
            for slot in sch.decoding_slots():
                self.reqs[sch.slots[slot].req.rid].logit_rows.append(
                    (i, slot))
            real_rd(toks)

        real_decode = model.decode_step
        model.prefill_bucketed = prefill(model.prefill_bucketed,
                                         lambda rest: 0)
        model.prefill_chunk = prefill(model.prefill_chunk,
                                      lambda rest: int(rest[0]))
        model.decode_step = decode
        real_rp, real_rd = sch.record_prefill, sch.record_decode
        sch.record_prefill, sch.record_decode = record_prefill, record_decode

    # -- the loop ------------------------------------------------------------

    def _send(self, prompt, n_out, index) -> None:
        from repro_torch.serve import SamplingParams

        t = time.perf_counter()
        rid = self.engine.submit(prompt, SamplingParams(max_tokens=n_out))
        self.reqs[rid] = Request(rid, index, prompt, n_out, t)

    def _step(self) -> Step:
        eng = self.engine
        before = {st.req.rid: len(st.tokens) for st in eng.scheduler.slots
                  if st is not None}
        done = eng.step()
        end = time.perf_counter()
        counts = {st.req.rid: len(st.tokens) for st in eng.scheduler.slots
                  if st is not None}
        for f in done:
            counts[f.rid] = len(f.tokens)
            self.reqs[f.rid].tokens = np.asarray(f.tokens)
        step = Step(end, [], [])
        for rid, n in counts.items():
            r = self.reqs[rid]
            old = before.get(rid, 0)
            if n <= old:
                continue
            if old == 0:
                r.step_first = len(self.steps)
                step.prefill.append(rid)
            # a decode that found j tokens fed the one at position s0 + j - 1
            # and attended s0 + j positions
            step.decode_ctx += [len(r.prompt) + j
                                for j in range(max(old, 1), n)]
            r.times += [end] * (n - old)
        self.steps.append(step)
        t = time.perf_counter()
        for f in done:
            self._send(*self.loop.next())
        self.gen_s += time.perf_counter() - t
        return step

    def window(self, seconds: float) -> None:
        """Step until ``seconds`` have passed; with ``trace``, profile whole
        steps from a third of the window to two thirds (at most 8 s)."""
        from portbench.devtrace import DeviceTrace

        self.first_step = len(self.steps)
        deadline = self.t0 + seconds
        on = self.t0 + seconds / 3
        off = min(self.t0 + 2 * seconds / 3, on + 8.0)
        # the profiler is readied before the window: starting it cold
        # stalls the host for seconds
        self.devtrace = DeviceTrace(self.dev) if self.trace else None
        snap0 = self.snapshot()
        tracing = False
        while True:
            if self.devtrace is not None and not self.devtrace.done \
                    and not tracing and time.perf_counter() >= on:
                self.devtrace.start()
                tracing = True
            step = self._step()
            step.traced = tracing
            if tracing and step.end >= off:
                self.devtrace.stop()
                tracing = False
            if step.end >= deadline:
                break
        if tracing:
            self.devtrace.stop()
        self.t1 = self.steps[-1].end
        self.snap = (snap0, self.snapshot())

    def snapshot(self) -> dict:
        """The engine's counters and phase spans, to difference over the
        window."""
        eng = self.engine
        snap = {"n_decode_steps": eng.n_decode_steps,
                "n_prefill_calls": eng.n_prefill_calls}
        if self.trace:
            for name, h in eng.metrics()["engine"]["phases"].items():
                snap[name] = (h["count"], h["sum"])
        return snap

    def phase(self, name: str):
        """(count, seconds) of an engine phase over the window."""
        a, b = self.snap
        c0, s0 = a.get(name, (0, 0.0))
        c1, s1 = b.get(name, (0, 0.0))
        return c1 - c0, s1 - s0

    def counter(self, name: str) -> int:
        a, b = self.snap
        return b[name] - a[name]

    # -- what the window did -----------------------------------------------

    def window_steps(self) -> List[Step]:
        return self.steps[self.first_step:]

    def end_to_end(self) -> Dict[str, float]:
        t0, t1 = self.t0, self.t1
        n_tok, gaps, ttft = 0, [], []
        for r in self.reqs.values():
            inside = [t for t in r.times if t0 < t <= t1]
            n_tok += len(inside)
            gaps += list(np.diff(inside))
            if r.times and t0 < r.times[0] <= t1:
                ttft.append(r.times[0] - r.sent)
        self.counts = {"tokens": n_tok, "gaps": len(gaps),
                       "first_tokens": len(ttft)}
        out = {"output_tok_s": n_tok / (t1 - t0),
               "setup_s": t0 - self.t_start}
        if gaps:
            out["itl_p95_ms"] = 1e3 * float(np.percentile(gaps, 95))
        if ttft:
            out["ttft_p90_s"] = float(np.percentile(ttft, 90))
        return out

    def attempted(self) -> int:
        """Requests with a token due in the window: in flight when it
        opened, or sent inside it."""
        return sum(1 for r in self.reqs.values()
                   if r.sent <= self.t1 and (r.tokens is None or any(
                       t > self.t0 for t in r.times)))

    # -- the judged sample -------------------------------------------------

    def sample(self) -> List[Job]:
        """The requests the window finished, the longest first, then others
        drawn from the seed until the mix's ``check`` budget of served
        tokens or requests is met; the longest judged whole, the others
        on their first ``check["prefix"]`` tokens where the mix gives one
        (the reference is teacher-forced, so a prefix stands alone);
        grouped into the prefill launches the program made, each served
        token with the logit the program gave it."""
        done = [r for r in self.reqs.values() if r.tokens is not None
                and self.t0 < r.times[-1] <= self.t1]
        if not done:
            raise RuntimeError("the window finished no request to judge")
        check = self.mix["check"]
        prefix = check.get("prefix")
        done.sort(key=lambda r: (-(len(r.prompt) + len(r.tokens)), r.rid))
        rng = np.random.default_rng([self.seed % (1 << 63), 4])
        order = [done[0]] + [done[1:][i] for i in rng.permutation(
            len(done) - 1)]
        picked, n = [], 0
        for r in order:
            if n >= check["tokens"] or len(picked) >= check["requests"]:
                break
            served = r.tokens if not picked or prefix is None \
                else r.tokens[:prefix]
            picked.append((r, served))
            n += len(served)
        maxima = torch.cat(self.maxima).cpu().numpy()
        starts = np.cumsum([0] + [len(m) for m in self.maxima])
        jobs: Dict[int, Job] = {}
        for r, served in picked:
            if len(r.logit_rows) != len(r.tokens):
                raise RuntimeError(
                    f"request {r.rid}: {len(r.tokens)} tokens served, the "
                    f"logits of {len(r.logit_rows)} read")
            launch = self.launches[r.launch]
            if launch.p_len:
                raise RuntimeError(
                    f"request {r.rid} reused a cached prefix of "
                    f"{launch.p_len} tokens: the reference cannot rebuild "
                    f"its launch")
            if r.launch not in jobs:
                jobs[r.launch] = Job(
                    [self.reqs[x].prompt for x in launch.rids],
                    launch.s_pad, {}, {})
            row = launch.rids.index(r.rid)
            jobs[r.launch].served[row] = served
            jobs[r.launch].logits[row] = np.array(
                [maxima[starts[i] + j]
                 for i, j in r.logit_rows[:len(served)]])
        self.judged = (len(picked), n)
        return list(jobs.values())

    def judge(self, control: bool = False) -> dict:
        """Once the window has closed and the device's peak is read: the
        judged sample, the program's state freed, the weights drawn again
        from the seed, and the reference over the sample. Returns the
        numbers (``reference/check.py``; with ``control`` the control's
        too) and sets ``checks``, each number a limit names beside it."""
        from portbench.reference.check import compare

        jobs = self.sample()
        self.release()
        t = time.perf_counter()
        with torch.no_grad():
            numbers = compare(self.arch, self.make_weights(), jobs, control)
        numbers.update(requests=self.judged[0],
                       reference_s=time.perf_counter() - t)
        self.checks = {name: {"value": numbers[name], "limit": lim["limit"]}
                       for name, lim in self.limits.items()}
        return numbers

    @property
    def correct(self) -> bool:
        return all(c["value"] <= c["limit"] for c in self.checks.values())

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.engine = None
        self.maxima = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

