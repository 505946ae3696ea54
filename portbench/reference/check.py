"""The comparison that decides ``correct``.

For every judged request, the reference runs once over its prompt and the
tokens the program served (with the prompts that shared its prefill launch),
and at each served position reads the served token's logit. Four numbers
come of it, and each cell's ``limits/<cell>.json`` names the ones it is held
to: ``max_gap``, the widest gap by which a served token's logit lies below
the reference's best; ``off_share``, the share of judged tokens that are not
the reference's first choice; and ``logit_err``, the widest distance
between the logit the program gave a served token and the reference's logit
of that token at that position (``not_first`` counts the tokens off).

In a mixture of experts a rounding difference can flip a near-tied routing
choice and move one token's logits by a tenth, so there the widest gap and
the widest logit distance swing from seed to seed and the share, which
stays near 0 for sound runs and not for a lower precision, is compared. In
a dense model a lower precision rarely reorders the top two of a hundred
thousand logits, so no served token tells it apart on every seed, but it
moves every logit by far more than float32's rounding does: there the
logit distance is compared.

The control (``control=True``) puts the reference, computed in TF32, in the
program's place: at each of the same positions it serves the token that TF32
puts first, with the logit TF32 gives it, and the same numbers are read for
it under ``control_<name>``.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from portbench.reference.decoder import Job, Reference


def _numbers(gaps: List[torch.Tensor], errs: List[torch.Tensor]) -> dict:
    g = torch.cat(gaps).double().cpu().numpy()
    e = torch.cat(errs).double().cpu().numpy()
    off = int((g > 0).sum())
    return {"max_gap": float(g.max()), "not_first": off,
            "off_share": off / len(g), "logit_err": float(e.max())}


def compare(arch: dict, weights: dict, jobs: List[Job],
            control: bool = False) -> dict:
    """The numbers of the program's served tokens against the float32
    reference (and with ``control``, the TF32 control's, prefixed
    ``control_``), with how many tokens and launches were judged."""
    ref = Reference(arch, weights).run(jobs)
    dev = weights["embed"]["tok"].device
    gaps, errs = [], []
    for job, res in zip(jobs, ref):
        for r, toks in job.served.items():
            t = torch.as_tensor(np.asarray(toks, np.int64), device=dev)
            picked = res[r].gather(1, t[:, None])[:, 0]
            gaps.append(res[r].max(1).values - picked)
            errs.append((torch.as_tensor(job.logits[r], dtype=torch.float32,
                                         device=dev) - picked).abs())
    out = {"tokens": sum(len(g) for g in gaps), "launches": len(jobs),
           **_numbers(gaps, errs)}
    if control:
        low = Reference(arch, weights, control=True).run(jobs)
        gaps, errs = [], []
        for job, a, b in zip(jobs, ref, low):
            for r in job.served:
                t = b[r].argmax(1)
                picked = a[r].gather(1, t[:, None])[:, 0]
                gaps.append(a[r].max(1).values - picked)
                errs.append((b[r].gather(1, t[:, None])[:, 0]
                             - picked).abs())
        out.update({f"control_{k}": v
                    for k, v in _numbers(gaps, errs).items()})
    return out
