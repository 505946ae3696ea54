"""Roofline terms of a dry-run record (PyTorch port of
``repro.launch.roofline``), on the H100's constants (``launch.mesh``):

  compute term    = FLOPs / 989 TFLOP/s bf16
  memory term     = bytes / 3.35 TB/s HBM
  collective term = collective wire bytes / 450 GB/s NVLink each way

All inputs are per device. The reference parses its collectives out of
XLA's compiled HLO text; the port has no HLO, so :func:`collective_bytes`
takes the records that the dry-run's tracer collects from the functional
collectives a traced step issues, one ``(kind, result_bytes,
group_size)`` a collective, and applies the reference's per-kind
accounting to them.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Tuple

from repro_torch.launch.mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def collective_bytes(records: Iterable[Tuple[str, float, int]]
                     ) -> Dict[str, Any]:
    """Per-device collective traffic of ``(kind, result_bytes, group_size)``
    records. Two accountings, as the reference's:

    * ``operand``: the summed operand sizes (all-gather operand =
      result/g, reduce-scatter operand = result*g, others = result).
    * ``wire``: per-device link bytes of bandwidth-optimal implementations
      (ring all-reduce 2P(g-1)/g, all-gather/all-to-all R(g-1)/g,
      reduce-scatter R(g-1), permute P) — the number the collective
      roofline term uses.

    A group of 1 moves nothing (it is counted); a permute names its peers
    in pairs, not a group, and always carries its payload.
    """
    wire = {k: 0.0 for k in COLLECTIVES}
    operand = {k: 0.0 for k in COLLECTIVES}
    counts = {k: 0 for k in COLLECTIVES}
    for kind, r, g in records:
        if kind not in COLLECTIVES:
            raise ValueError(f"unknown collective {kind!r}")
        g = max(int(g), 1)
        counts[kind] += 1
        if g == 1 and kind != "collective-permute":
            continue
        if kind == "all-gather":
            wire[kind] += r * (g - 1) / g
            operand[kind] += r / g
        elif kind == "all-reduce":
            wire[kind] += 2.0 * r * (g - 1) / g
            operand[kind] += r
        elif kind == "reduce-scatter":
            wire[kind] += r * (g - 1)
            operand[kind] += r * g
        elif kind == "all-to-all":
            wire[kind] += r * (g - 1) / g
            operand[kind] += r
        else:  # collective-permute
            wire[kind] += r
            operand[kind] += r
    out = {k: wire[k] for k in COLLECTIVES}
    out["total"] = sum(wire.values())
    out["operand_total"] = sum(operand.values())
    out["counts"] = counts
    return out


def roofline_terms(flops: float, bytes_accessed: float,
                   coll_bytes: float) -> Dict[str, float]:
    """All inputs are per-device. Returns seconds per step + bottleneck."""
    t_compute = flops / PEAK_FLOPS_BF16
    t_memory = bytes_accessed / HBM_BW
    t_coll = coll_bytes / LINK_BW
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dom = max(terms, key=terms.get)
    terms["bottleneck"] = dom.replace("_s", "")
    total = max(t_compute, t_memory, t_coll)
    terms["roofline_bound_s"] = total
    terms["compute_fraction"] = t_compute / total if total else 0.0
    return terms


def model_flops(n_params: float, n_active_params: float, tokens: float,
                kind: str) -> float:
    """MODEL_FLOPS = 6*N*D (train) or 2*N*D (fwd-only), N = active params."""
    n = n_active_params or n_params
    mult = 6.0 if kind == "train" else 2.0
    return mult * n * tokens
