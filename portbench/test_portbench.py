"""CPU tests of the port's benchmark: the traffic generator, the frozen work
counts and dequantization, each cell end to end at its smoke sizes, and the
comparison that decides ``correct`` failing on planted faults. The test
that needs the card carries the ``gpu`` marker and skips in its fixture."""
from __future__ import annotations

import itertools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

from portbench import harness, run, traffic, work  # noqa: E402
from portbench.reference.swis import dequant  # noqa: E402

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]
CONTRACT = {"correct", "attempted", "failed", "metrics", "device",
            "breakdown", "checks"}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _mix(**kw):
    return {"clients": 4, "prompt": {"lo": 16, "hi": 128},
            "output": {"lo": 1, "hi": 8}, "strata": 16, **kw}


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 7])
def test_every_seed_offers_the_same_lengths(seed):
    spec = _mix()
    ref = traffic.ClosedLoop(spec, 1, 1000)
    got = traffic.ClosedLoop(spec, seed, 1000)
    firsts = [(len(a[0]), a[1], len(b[0]), b[1]) for a, b in (
        (ref.first(c), got.first(c)) for c in range(spec["clients"]))]
    assert all(x[:2] == x[2:] for x in firsts)
    a = [ref.next() for _ in range(32)]
    b = [got.next() for _ in range(32)]
    assert [(len(p), n) for p, n, _ in a] == [(len(p), n) for p, n, _ in b]
    assert not np.array_equal(a[0][0], b[0][0])  # the seed draws the ids
    # every aligned run of 4 requests holds one length from each quarter
    lengths = sorted(set(traffic.loguniform_quantiles(16, 128, 16)))
    quarter = {v: lengths.index(v) * 4 // len(lengths) for v in lengths}
    outs = sorted(set(traffic.loguniform_quantiles(1, 8, 16)))
    for i in range(0, 32, 4):
        assert sorted(quarter[len(p)] for p, _, _ in b[i:i + 4]) == [0, 1, 2, 3]
    # and the multiset of a pass is the quantiles, outputs too
    assert sorted(len(p) for p, _, _ in b[:16]) == sorted(
        traffic.loguniform_quantiles(16, 128, 16))
    assert sorted(n for _, n, _ in b[:16]) == sorted(
        traffic.loguniform_quantiles(1, 8, 16))


def test_same_seed_same_tokens():
    a = traffic.ClosedLoop(_mix(), 5, 1000)
    b = traffic.ClosedLoop(_mix(), 5, 1000)
    for _ in range(8):
        (pa, na, _), (pb, nb, _) = a.next(), b.next()
        assert na == nb and np.array_equal(pa, pb)


def test_residual_quantiles_are_the_equilibrium_residual():
    r = traffic.residual_quantiles(128, 1024, 4096)
    # E[R] = E[L^2] / (2 E[L]) for log-uniform L
    lo, hi = 128.0, 1024.0
    mean_l = (hi - lo) / np.log(hi / lo)
    mean_l2 = (hi ** 2 - lo ** 2) / (2 * np.log(hi / lo))
    assert abs(r.mean() - mean_l2 / (2 * mean_l)) < 2.0


def test_work_counts_by_hand():
    assert work.packed_bytes(64, 32, 4, 4) == 64 * 32 * 5 // 8 + 16 * 32 * 2 \
        + 32 * 4
    flops, nbytes = work.gemm(3, 64, 32, 4, 4)
    assert flops == 2 * 3 * 64 * 32
    assert nbytes == 2432 + 3 * 64 * 4 + 3 * 32 * 4
    arch = {"d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
            "d_ff": 96, "vocab": 100, "n_layers": 2,
            "moe": {"d_ff_shared": 64, "d_ff_expert": 32, "n_experts": 6,
                    "top_k": 2}}
    m = work.Model(arch, 4, 4)
    up, _, down = m.experts(5)
    assert up[0] == 2 * 10 * 64 * 32 and down[0] == 2 * 10 * 32 * 64
    assert up[1] == 6 * work.packed_bytes(64, 32, 4, 4) + 5 * 64 * 4 \
        + 10 * 32 * 4
    assert m.paged([3, 5]) == (4 * 4 * 16 * 8, 2 * 8 * 2 * 16 * 4
                               + 2 * 2 * 4 * 16 * 4)
    per_layer = (64 * 64 + 2 * 64 * 32 + 64 * 64 + 3 * 64 * 64
                 + 2 * 3 * 64 * 32 + 64 * 6)
    assert m.model_flops(3, 10, 1) == 2 * 3 * 2 * per_layer \
        + 4 * 64 * 2 * 10 + 2 * 64 * 100
    assert m.bound_s([(989e12, 0)]) == pytest.approx(2.0)


def test_dequant_by_definition():
    g = torch.Generator().manual_seed(0)
    k, n, planes, group = 64, 8, 4, 4
    bits = torch.randint(0, 2, (planes + 1, k, n), generator=g)
    shifts = torch.stack([torch.randperm(8, generator=g)[:planes].sort().values
                          for _ in range(k // group * n)]).reshape(
                              k // group, n, planes)

    def words(b):  # (K, N) bits -> (K/32, N) int32, bit i = row 32w + i
        w = (b.reshape(k // 32, 32, n).long()
             << torch.arange(32).reshape(1, 32, 1)).sum(1)
        return (w - (w >= 2 ** 31).long() * 2 ** 32).to(torch.int32)

    leaf = {"sign_plane": words(bits[0]),
            "mask_planes": torch.stack([words(bits[j + 1])
                                        for j in range(planes)]),
            "shifts": (shifts[..., 0::2] | (shifts[..., 1::2] << 4)).to(
                torch.uint8),
            "scale": torch.full((1, n), 0.5)}
    want = torch.zeros(k, n)
    for r, c, j in itertools.product(range(k), range(n), range(planes)):
        if bits[j + 1, r, c]:
            want[r, c] += 2.0 ** int(shifts[r // group, c, j])
    want = want * (1 - 2 * bits[0]) * 0.5
    assert torch.equal(dequant(leaf), want)


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    monkeypatch.setattr(sys, "modules", {"repro_torch": 1, "repro_torch.x": 1,
                                         "jaxtyping": 1, "os": 1})
    assert run.forbidden_modules() == []
    monkeypatch.setattr(sys, "modules", {"repro.serve": 1, "jax": 1})
    assert run.forbidden_modules() == ["jax", "repro"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_end_to_end_at_smoke_size(cell, trace):
    """The whole run in a process of its own (the harness exits non-zero if
    JAX or the JAX package got loaded), its last line the contract's."""
    code = ("import sys; sys.path.insert(0, %r); from portbench import run; "
            "sys.exit(run.main(%r, smoke=True))" % (
                str(ROOT), ["--workload", cell, "--seed", "2147483999",
                            "--seconds", "1", "--trace", str(trace)]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(line) <= CONTRACT and list(line)[-1] == "checks"
    assert line["correct"] is True
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    e2e = {m["name"] for m in bench["end_to_end"]}
    got = set(line["metrics"])
    assert got and (got <= e2e if not trace else not got & e2e)
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert "decode_rows_per_step" in got


def _judge(cell, seed, patch=None):
    """A smoke run with an optional fault planted in the program, judged as
    the benchmark judges it: whether it comes out not correct."""
    r = harness.Run(cell, seed, "cpu", smoke=True)
    with torch.no_grad():
        if patch:
            patch()
        r.setup()
        r.window(1.0)
    r.judge()
    return not r.correct


@pytest.mark.parametrize("cell", CELLS)
def test_altered_token_is_not_correct(cell, monkeypatch):
    """A token altered where it is produced: the sampler's pick moved to
    the next id on every fourth call."""
    from repro_torch.serve import engine

    calls = [0]
    real = engine._sample

    def altered(*a, **kw):
        out = real(*a, **kw)
        calls[0] += 1
        if calls[0] % 4 == 0:
            out = (out + 1) % 512
        return out

    assert _judge(cell, 11, lambda: monkeypatch.setattr(
        engine, "_sample", altered))


def test_half_the_decode_batch_left_out_is_not_correct(monkeypatch):
    """Half of a decode batch left out: its rows get the other half's
    logits."""
    from repro_torch.models.model import Model

    real = Model.decode_step

    def half(self, params, token, cache, index, *a, **kw):
        logits, cache = real(self, params, token, cache, index, *a, **kw)
        b = logits.shape[0] // 2
        return torch.cat([logits[:b], logits[:logits.shape[0] - b]]), cache

    assert _judge("qwen2moe-decode", 12, lambda: monkeypatch.setattr(
        Model, "decode_step", half))


def test_one_slot_left_wrong_is_not_correct(monkeypatch):
    """One slot of a decode batch of 8 wrong: its row gets the next row's
    logits."""
    from repro_torch.models.model import Model

    real = Model.decode_step

    def one(self, params, token, cache, index, *a, **kw):
        logits, cache = real(self, params, token, cache, index, *a, **kw)
        logits = logits.clone()
        logits[5] = logits[6]
        return logits, cache

    assert _judge("qwen2moe-decode", 14, lambda: monkeypatch.setattr(
        Model, "decode_step", one))


def test_launches_are_read_from_the_program():
    """Every prefill launch the window judged is the program's: rows in
    the order it took them, its padded length, and a launch that reused a
    cached prefix stops the judging (the reference cannot rebuild it)."""
    r = harness.Run("deepseek7b-prefill", 15, "cpu", smoke=True)
    with torch.no_grad():
        r.setup()
        r.window(0.5)
        assert r.launches and all(
            len(r.reqs[x].prompt) <= L.s_pad and r.reqs[x].launch == i
            for i, L in enumerate(r.launches) for x in L.rids)
        old = max((q for q in r.reqs.values() if q.tokens is not None
                   and len(q.prompt) > 16), key=lambda q: q.times[-1])
        r._send(np.concatenate([old.prompt, old.prompt[:3]]), 2, -1)
        new = r.reqs[max(r.reqs)]
        while new.tokens is None:
            r._step()
        r.t1 = r.steps[-1].end
    assert r.launches[new.launch].p_len > 0
    with pytest.raises(RuntimeError, match="cached prefix"):
        r.sample()


def test_warm_lengths_cover_the_range_in_doubling_steps():
    assert harness.warm_lengths(16, 128) == [16, 32, 64, 128]
    assert harness.warm_lengths(64, 512) == [64, 128, 256, 512]
    assert harness.warm_lengths(8, 24) == [8, 16, 24]
    assert harness.warm_lengths(100, 1000) == [100, 128, 256, 512, 1000]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_the_card(cell, cuda_device):
    """The control (the reference in TF32 in the program's place) at the
    cell's own size and load fails the cell's limits on every seed."""
    from portbench.calibrate import reading

    limits = json.loads((ROOT / "portbench" / "limits" /
                         f"{cell}.json").read_text())
    for seed in (2147484001, 2147484002, 2147484003):
        got = reading(cell, seed, 51.0, True, str(cuda_device))
        assert any(got[f"control_{k}"] > v["limit"]
                   for k, v in limits.items()), (seed, got)
