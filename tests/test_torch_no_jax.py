"""The port stands alone: ``repro_torch`` (every module) and
``chip_smoke.py`` import neither JAX nor the JAX reference package, nor
the reference's root ``benchmarks`` and ``examples`` packages (a bare
``benchmarks`` import inside the port would find the reference's)."""
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT_SOURCES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]

_PROBE = """
import importlib, json, pkgutil, sys
sys.path[:0] = [{src!r}, {root!r}]
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "repro", "benchmarks",
                                    "examples"))
print(json.dumps({{"modules": names, "bad": bad}}))
"""


def test_importing_the_port_loads_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(src=str(ROOT / "src"),
                                             root=str(ROOT))],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(got["modules"]) >= 20, got["modules"]
    # the observability modules, the launchers, the examples, the MoE
    # family, the recurrent families, the VLM, the encoder, every config,
    # the training path, the offline toolchain, the perf model, and the
    # sharding rules, the dry-run and the paper tables are walked
    for name in ("core.budget", "core.scheduling", "core.probability",
                 "perfmodel.networks", "perfmodel.systolic",
                 "perfmodel.evaluate", "core.qat", "optim.adamw", "optim.clip", "optim.schedule",
                 "optim.compress", "data.pipeline", "checkpoint.manager",
                 "train.steps", "train.loop", "launch.train",
                 "benchmarks.common", "benchmarks.paper_tables",
                 "benchmarks.run", "examples.train_swis_qat",
                 "examples.quickstart",
                 "serve.metrics", "serve.trace", "serve.costmodel",
                 "perfmodel.pe", "launch.serve", "examples.serve_swis",
                 "models.moe", "configs.qwen2_moe_a2_7b",
                 "configs.dbrx_132b", "models.rglru", "models.ssm",
                 "configs.recurrentgemma_2b", "configs.mamba2_2_7b",
                 "models.attention", "models.transformer", "models.model",
                 "configs.llama_3_2_vision_11b", "configs.hubert_xlarge",
                 "configs.mistral_large_123b", "parallel.ctx",
                 "parallel.sharding", "parallel.comm", "parallel.model",
                 "parallel.quant", "launch.mesh", "launch.dryrun",
                 "launch.roofline", "launch.hillclimb", "launch.report"):
        assert f"repro_torch.{name}" in got["modules"], name
    assert got["bad"] == [], f"port imported {got['bad']}"


def test_sources_name_no_jax_or_reference_import():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro|benchmarks|"
                         r"examples)(\.|\s|$)", re.MULTILINE)
    assert len(PORT_SOURCES) >= 20
    for path in PORT_SOURCES:
        hits = pattern.findall(path.read_text())
        assert not hits, f"{path.relative_to(ROOT)} imports {hits}"
