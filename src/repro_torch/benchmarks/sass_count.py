"""SASS instructions per rebuilt weight in the built SWIS library.

    python -m repro_torch.benchmarks.sass_count

Builds ``csrc/swis_matmul.cu`` (needs ``nvcc``; no card), disassembles it
with ``cuobjdump -sass`` and counts, each kernel at 4 planes and 4 rows,
fp32 x:

* ``swis_experts_kernel`` (the expert-axis launch): its stage section, from
  the copies' LDGDEPBAR to the last HMMA, which a lane runs once a stage for
  its 64 weights (4 columns x 16);
* ``swis_matmul_kernel`` (the 2-D launch; the expert-axis launch's kernel
  before ``swis_experts_kernel``): the loop that holds the FFMAs, 8 weights
  an iteration, on the path SWIS takes at group 4. That path is estimated:
  the SWIS-C branches are left out, and of each half's four group-boundary
  blocks one is counted (one group in 4 weights).

Prints one JSON object ``{"experts": x, "matmul": y}``; exits 1 where
``cuobjdump`` is missing or a kernel is not found.
"""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path


def counts(text: str) -> dict:
    """The two counts from ``cuobjdump -sass`` output."""
    funcs = {}
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        name = part.split("\n", 1)[0]
        funcs[name] = [(int(a, 16), t.strip()) for a, t in re.findall(
            r"/\*([0-9a-f]{4,5})\*/\s+([^;]*);", part)]

    def find(pattern):
        hits = [v for k, v in funcs.items() if re.search(pattern, k)]
        if not hits:
            raise LookupError(f"no kernel matching {pattern} in the SASS")
        return hits[0]

    def op(t):
        return t.split()[1] if t.startswith("@") else t.split()[0]

    new = find(r"swis_experts_kernelILi4ELi4ELb0E")
    hmma = [i for i, (_, t) in enumerate(new) if op(t).startswith("HMMA")]
    start = max(i for i, (_, t) in enumerate(new[:hmma[0]])
                if op(t) == "LDGDEPBAR")
    experts = (hmma[-1] - start) / 64

    old = find(r"swis_matmul_kernelIfLi4ELi4E")
    index = {a: i for i, (a, _) in enumerate(old)}
    loops = []  # (body length, first, last) of each loop with FFMAs
    for i, (a, t) in enumerate(old):
        m = re.search(r"BRA (0x[0-9a-f]+)$", t)
        if m and int(m.group(1), 16) < a:
            j = index[int(m.group(1), 16)]
            if any(op(u) == "FFMA" for _, u in old[j:i + 1]):
                loops.append((i + 1 - j, j, i))
    n, lo, hi = min(loops)
    ffma = sum(op(t) == "FFMA" for _, t in old[lo:hi + 1])
    skipped = 0.0
    for i in range(lo, hi + 1):
        m = re.search(r"^BRA (0x[0-9a-f]+)$", old[i][1])  # a SWIS-C path ends
        if not m:
            continue
        swis_end = index[int(m.group(1), 16)]
        cond = max(k for k in range(lo, i) if re.search(
            r"^@!?P\d BRA 0x%x$" % old[i + 1][0], old[k][1]))
        skipped += i - cond  # the SWIS-C path, the jump at its end included
        blocks = 0  # group-boundary blocks on the SWIS path: one of 4 runs
        for k in range(i + 1, swis_end):
            mb = re.search(r"^BSSY B\d, (0x[0-9a-f]+)$", old[k][1])
            if mb:
                blocks += index[int(mb.group(1), 16)] - k
        skipped += 0.75 * blocks
    weights = ffma // 4  # 4 FFMAs a weight at 4 rows
    return {"experts": experts, "matmul": (n - skipped) / weights}


def main() -> int:
    from repro_torch.kernels.build import build
    from repro_torch.kernels.swis_matmul import KERNEL

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        print("cuobjdump not found", file=sys.stderr)
        return 1
    build([KERNEL])
    text = subprocess.run([tool, "-sass", str(KERNEL.lib_path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    try:
        print(json.dumps(counts(text)))
    except LookupError as e:
        print(e, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
