"""The one traffic generator: a closed loop of clients, read from a mix file.

A mix file (``traffic/<name>.json``) gives the number of clients and the
log-uniform ranges of prompt and output lengths. Every seed offers the same
work in the same order: the lengths are a fixed multiset of evenly spaced
quantiles of those ranges, sent in a van der Corput order (bit-reversed
index) over ``strata`` quantiles, so any run of 2**k consecutive requests
holds one length from each of 2**k equal strata and a window that ends
anywhere sees close to the mean lengths. Outputs follow the second Sobol
dimension, so that the (prompt, output) pairs of such a run are a (0, k, 2)
net: outputs are stratified the same way and their rank does not move with
the prompt's. The seed draws the token ids (and, elsewhere,
the weights). In a closed loop the lengths' order sets when requests
finish and which prompts prefill together, so a seed that reordered them
would change the window's work.

Each client's first request is drawn from the residual distribution of the
output length (what is left of a request caught in flight), so that
completions are already spread out when the window opens, as in a loop that
has run for a while.
"""
from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np


def load(path: Path) -> dict:
    spec = json.loads(Path(path).read_text())
    for key in ("clients", "prompt", "output", "strata"):
        if key not in spec:
            raise ValueError(f"{path}: traffic mix lacks {key!r}")
    if spec["strata"] & (spec["strata"] - 1):
        raise ValueError(f"{path}: strata must be a power of two")
    for key in ("prompt", "output"):
        if not 1 <= spec[key]["lo"] < spec[key]["hi"]:
            raise ValueError(f"{path}: {key} needs 1 <= lo < hi")
    return spec


def max_len(spec: dict) -> int:
    """Longest prompt plus longest output: the engine's ``max_len``."""
    return spec["prompt"]["hi"] + spec["output"]["hi"]


def loguniform_quantiles(lo: int, hi: int, n: int) -> np.ndarray:
    """``n`` evenly spaced quantiles of log-uniform [lo, hi], as ints."""
    u = (np.arange(n) + 0.5) / n
    return np.clip(np.rint(lo * (hi / lo) ** u), lo, hi).astype(np.int64)


def residual_quantiles(lo: int, hi: int, n: int) -> np.ndarray:
    """``n`` evenly spaced quantiles of the equilibrium residual of a
    log-uniform [lo, hi] length (density P(L > r) / E[L]), at least 1."""
    grid = np.linspace(0.0, hi, 4097)
    surv = np.where(grid < lo, 1.0,
                    np.log(hi / np.maximum(grid, lo)) / math.log(hi / lo))
    cdf = np.concatenate([[0.0], np.cumsum(
        0.5 * (surv[1:] + surv[:-1]) * np.diff(grid))])
    u = (np.arange(n) + 0.5) / n
    r = np.interp(u, cdf / cdf[-1], grid)
    return np.clip(np.ceil(r), 1, hi).astype(np.int64)


def _bitrev(j: int, bits: int) -> int:
    """The first Sobol (van der Corput) dimension, as a ``bits``-bit int."""
    return int(format(j, f"0{bits}b")[::-1], 2) if bits else 0


def _sobol2(j: int, bits: int) -> int:
    """The second Sobol dimension (direction numbers m_k = 2 m_(k-1) xor
    m_(k-1), m_1 = 1), as a ``bits``-bit int."""
    x, m = 0, 1
    for k in range(bits):
        if j >> k & 1:
            x ^= m << (bits - 1 - k)
        m = (m << 1) ^ m
    return x


class ClosedLoop:
    """Requests of one mix for one seed. ``first(c)`` is client c's first
    request, ``next()`` the next one of the shared sequence; each is
    (prompt token ids, output tokens, index: -1 - c for a first request,
    else the position in the sequence)."""

    def __init__(self, spec: dict, seed: int, vocab: int):
        self.spec = spec
        self.seed = int(seed) % (1 << 63)
        self.vocab = vocab
        q = spec["strata"]
        self.bits = q.bit_length() - 1
        p, o = spec["prompt"], spec["output"]
        self.prompts = loguniform_quantiles(p["lo"], p["hi"], q)
        self.outputs = loguniform_quantiles(o["lo"], o["hi"], q)
        c = spec["clients"]
        order = [_bitrev(i, max(c - 1, 0).bit_length()) for i in
                 range(1 << max(c - 1, 0).bit_length())]
        order = [i for i in order if i < c]
        self.first_prompts = loguniform_quantiles(p["lo"], p["hi"], c)[order]
        self.first_outputs = residual_quantiles(o["lo"], o["hi"], c)
        self.n_next = 0

    def _tokens(self, kind: int, index: int, n: int) -> np.ndarray:
        rng = np.random.default_rng([self.seed, 2, kind, index])
        return rng.integers(0, self.vocab, size=n, dtype=np.int64).astype(
            np.int32)

    def first(self, client: int):
        return (self._tokens(0, client, int(self.first_prompts[client])),
                int(self.first_outputs[client]), -1 - client)

    def next(self):
        j = self.n_next
        self.n_next += 1
        q = self.spec["strata"]
        return (self._tokens(1, j, int(self.prompts[_bitrev(j % q,
                                                             self.bits)])),
                int(self.outputs[_sobol2(j % q, self.bits)]), j)
