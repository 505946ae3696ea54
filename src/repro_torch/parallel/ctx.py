"""Active-sharding context (PyTorch port of ``repro.parallel.ctx``): model
code annotates activations with *logical* axes via :func:`constrain`; the
trainer and the dry-run install concrete rules (mesh + logical->mesh
mapping) around a step. With no active rules constraints are the identity,
so model code never depends on a mesh and the unsharded paths are
unchanged bit for bit.
"""
from __future__ import annotations

import contextlib

_ACTIVE: list = []


@contextlib.contextmanager
def use_rules(rules):
    _ACTIVE.append(rules)
    try:
        yield rules
    finally:
        _ACTIVE.pop()


def active_rules():
    return _ACTIVE[-1] if _ACTIVE else None


def constrain(x, logical_axes):
    """``x`` redistributed to the placements the active rules give
    ``logical_axes`` (the counterpart of ``with_sharding_constraint``); the
    identity with no active rules or for a tensor that is not a
    ``DTensor``."""
    rules = active_rules()
    if rules is None:
        return x
    return rules.constrain(x, logical_axes)
