"""Per-layer metrics, one reader a file, found by the metric's name.

Each module ``<name>.py`` defines ``read(run) -> float | None`` over a
finished traced run (:class:`portbench.harness.Run`): None when the run
holds nothing to read, and the harness then leaves the metric out.
"""
from __future__ import annotations

import importlib


def reader(name: str):
    return importlib.import_module(f"portbench.metrics.{name}").read
