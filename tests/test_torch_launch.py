"""The port's serve launcher (``python -m repro_torch.launch.serve``) and
serve example (``python -m repro_torch.examples.serve_swis``), on the CPU
at smoke size: the report has the JAX launcher's keys and counts and the
same greedy ``sample:`` tokens on the same weights (bridged in this
process), ``--trace-out`` exports a Chrome trace or JSONL, and the
launcher asks for a card unless given ``--device cpu``."""
import json
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.examples import serve_swis
from repro_torch.launch import serve as tserve
from repro_torch.serve.trace import read_jsonl

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks"))
import check_bench  # noqa: E402

BASE = ["--arch", "smollm-135m", "--smoke", "--requests", "4",
        "--n-slots", "2", "--prompt-len", "12", "--tokens", "6", "--packed",
        "--metrics-every", "3"]
VARIANTS = {
    "continuous": [],
    "static": ["--engine", "static"],
    "chunked-fused": ["--prefill-chunk", "8", "--fused"],
    "spec": ["--spec", "--spec-k", "2", "--draft-slices", "2"],
}
# report fields that are counts or shape arithmetic (the rest are times)
EXACT = ("arch", "engine", "requests", "n_slots", "tokens", "packed_weights",
         "compression", "prefix_hit_rate", "prefill_tokens_saved",
         "cost_hbm_mib", "cost_gflops", "spec_proposed", "spec_accepted",
         "spec_accept_rate")


def _parse(stdout):
    """(report dict, sample tokens) from a launcher's standard output."""
    text, sample = stdout.rsplit("sample:", 1)
    return json.loads(text[text.index("{"):]), json.loads(sample)


def _run_both(argv, arch, capsys, monkeypatch):
    """The JAX launcher, then the port's on the JAX launcher's weights:
    (JAX report, JAX sample, port report, port sample, port output, the
    port's returned report and engine)."""
    pytest.importorskip("jax")  # the card's test environment has no JAX
    import jax

    import repro.configs as C
    from repro.launch import serve as jserve
    from repro.models import params as jpp
    from repro.models.model import Model as JModel
    from repro_torch.bridge import from_jax_params

    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jserve.main()
    want, want_sample = _parse(capsys.readouterr().out)
    # the JAX launcher's weights, drawn again in this process (its per-leaf
    # keys depend on the process's string hash, the same here)
    jcfg = C.get_smoke(arch).replace(compute_dtype="float32")
    jparams = jpp.init_params(JModel(jcfg).build(), jax.random.key(0))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")

    report, eng = tserve.run(tserve.parse_args(argv + ["--device", "cpu"]),
                             params=params)
    out = capsys.readouterr()
    got, got_sample = _parse(out.out)
    return want, want_sample, got, got_sample, out, report, eng


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_report_and_sample_match_jax_launcher(variant, capsys, monkeypatch):
    argv = BASE + VARIANTS[variant]
    want, want_sample, got, got_sample, out, report, eng = _run_both(
        argv, "smollm-135m", capsys, monkeypatch)
    assert got == report
    assert set(got) == set(want)
    assert got_sample == want_sample
    for key in EXACT:
        assert got.get(key) == want.get(key), key
    if variant == "static":
        return
    assert "== serve metrics ==" in out.err and "[step 3]" in out.err
    assert {"ttft_p50_s", "tpot_p50_s", "cost_hbm_mib"} <= set(got)
    assert eng.metrics()["engine"]["counters"]["step.model_dispatches"] \
        == eng.model_calls()


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b",
                                  "mistral-large-123b"])
def test_other_archs_match_jax_launcher(arch, capsys, monkeypatch):
    """The VLM serves text-only requests (no patches: its cross-attention
    is skipped, as in the JAX launcher), and mistral-large-123b's smoke
    config serves as a dense model: reports and samples equal."""
    argv = ["--arch", arch] + BASE[2:]
    want, want_sample, got, got_sample, _, _, eng = _run_both(
        argv, arch, capsys, monkeypatch)
    assert set(got) == set(want) and got_sample == want_sample
    for key in EXACT:
        assert got.get(key) == want.get(key), key
    assert eng.prefix_stats()["enabled"]


@pytest.mark.parametrize("suffix", [".json", ".jsonl"])
def test_trace_out_exports(suffix, tmp_path, capsys):
    path = str(tmp_path / f"trace{suffix}")
    _, eng = tserve.run(tserve.parse_args(
        BASE + ["--device", "cpu", "--trace-out", path]))
    assert path in capsys.readouterr().err
    if suffix == ".json":
        assert check_bench.check_chrome_trace(path) == []
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        # one track per request
        tracks = {e["args"]["name"] for e in events if e["ph"] == "M"
                  and e["name"] == "thread_name" and e["pid"] == 2}
        assert tracks == {f"req {rid}" for rid in range(4)}
    else:
        assert read_jsonl(path) == eng.tracer.events()


def test_device_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this test checks the refusal on a machine without a "
                    "card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.run(tserve.parse_args(BASE))


def test_ckpt_is_not_ported():
    with pytest.raises(NotImplementedError, match="A10"):
        tserve.run(tserve.parse_args(BASE + ["--device", "cpu", "--ckpt",
                                             "somewhere"]))


def test_serve_example_matches_static_engine(capsys):
    assert serve_swis.main(["--device", "cpu", "--requests", "3",
                            "--tokens", "6"])
    out = capsys.readouterr().out
    assert "3/3 match the static-batch engine token-for-token" in out
    assert "cost model:" in out and "ttft:" in out
