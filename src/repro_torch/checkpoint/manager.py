"""Fault-tolerant checkpointing (PyTorch port of
``repro.checkpoint.manager``), writing the files the reference writes, so
that each package restores the other's checkpoints.

* **Atomic**: leaves are written to ``step_XXXXXXXX.tmp/``, then the
  directory is renamed — a crash mid-write never corrupts the latest
  checkpoint.
* **Host arrays**: every leaf is copied to a full host array (``.npy``)
  on the caller's thread.
* **Retention**: keeps the newest ``keep`` checkpoints.
* **Async**: ``save(..., blocking=False)`` hands the host arrays to a
  writer thread, so the train loop overlaps checkpoint I/O with compute.
* **Manifest**: step, the data-pipeline cursor and the flattened key
  paths — enough to resume bit-exactly.

Key paths follow the reference's ``jax.tree_util`` paths: a dict key is
its name, a ``TrainState`` field is its name after a dot. So the leaf
``params["embed"]["tok"]`` of a train state is ``.params/embed/tok``, in
the file ``.params__embed__tok.npy``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.models.params import P


def _is_node(tree) -> bool:
    """A dataclass instance (a train state) whose fields are subtrees;
    parameter placeholders are leaves."""
    return (dataclasses.is_dataclass(tree) and not isinstance(tree, type)
            and not isinstance(tree, P))


def _items(tree, prefix=""):
    """(key path, leaf) of every leaf, depth first."""
    if _is_node(tree):
        for f in dataclasses.fields(tree):
            yield from _items(getattr(tree, f.name), f"{prefix}.{f.name}/")
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        # a copy: the caller may change the tensor while a writer thread
        # saves it
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {k: _host(v) for k, v in _items(tree)}


def _unflatten_into(template, flat: Dict[str, torch.Tensor], prefix=""):
    if _is_node(template):
        return dataclasses.replace(template, **{
            f.name: _unflatten_into(getattr(template, f.name), flat,
                                    f"{prefix}.{f.name}/")
            for f in dataclasses.fields(template)})
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{k}/")
                for k, v in template.items()}
    key = prefix[:-1]
    if key not in flat:
        raise KeyError(f"checkpoint missing leaf {key!r}")
    return flat[key]


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def all_steps(self):
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _write(self, step: int, flat: Dict[str, np.ndarray], meta: dict):
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for key, arr in flat.items():
            np.save(os.path.join(tmp, key.replace("/", "__") + ".npy"), arr)
        meta = dict(meta)
        meta["step"] = step
        meta["keys"] = sorted(flat.keys())
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def save(self, step: int, tree, meta: Optional[dict] = None,
             blocking: bool = True):
        flat = _flatten(tree)  # the host copy happens on the caller thread
        meta = meta or {}
        if blocking:
            self._write(step, flat, meta)
        else:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, flat, meta), daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore(self, template, step: Optional[int] = None, device="cpu"):
        """Restore into the structure of ``template`` (nested dicts and
        dataclasses; its leaves only name the keys, placeholders do). Only
        the template's leaves are read, as tensors on ``device``. Returns
        (tree, manifest)."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            meta = json.load(f)
        flat = {}
        for key, _ in _items(template):
            fn = os.path.join(d, key.replace("/", "__") + ".npy")
            if key not in meta["keys"] or not os.path.exists(fn):
                raise KeyError(f"checkpoint missing leaf {key!r}")
            flat[key] = torch.from_numpy(np.load(fn)).to(device)
        return _unflatten_into(template, flat), meta
