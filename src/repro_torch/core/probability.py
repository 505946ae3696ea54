"""Closed-form lossless-quantization probabilities (paper Eqs. 8-10, Fig. 2):
a copy of ``repro.core.probability`` (pure Python on ``math.comb``).

Probability that a uniformly random ``B``-bit integer is representable
exactly ("losslessly") by each quantization family using ``N`` shifts:

* SWIS (Eq. 8):        any sparse subset of N bit positions.
* SWIS-C (Eq. 9):      a consecutive window of N bit positions.
* layer-wise (Eq. 10): a single fixed subset of N positions.
"""
from __future__ import annotations

import math


def _comb(n: int, k: int) -> int:
    if k < 0 or n < 0 or k > n:
        return 0
    return math.comb(n, k)


def p_lossless_swis(n_shifts: int, bits: int = 8) -> float:
    """Eq. 8: P = sum_{n=0}^{N} C(B, n) * 0.5^B."""
    return sum(_comb(bits, n) for n in range(n_shifts + 1)) * 0.5 ** bits


def p_lossless_swis_c(n_shifts: int, bits: int = 8) -> float:
    """Eq. 9.

    For each popcount n <= N the fraction of bit patterns whose active bits
    fit inside *some* consecutive window of length N is
    ``(C(N, n) * (B - N + 1) - (B - N) * C(N - 1, n)) / C(B, n)``
    (windows overlap; the subtracted term removes double counting of
    patterns fitting in two adjacent windows, via inclusion-exclusion on
    patterns fitting in a window of length N-1).
    """
    N = n_shifts
    if N == 0:
        # Eq. 9 assumes N >= 1; with no shifts only the value 0 is exact.
        return 0.5 ** bits
    total = 0.0
    for n in range(N + 1):
        numer = _comb(N, n) * (bits - N + 1) - (bits - N) * _comb(N - 1, n)
        total += numer * 0.5 ** bits
    return total


def p_lossless_layerwise(n_shifts: int, bits: int = 8) -> float:
    """Eq. 10: the N active positions are fixed for the whole layer."""
    N = n_shifts
    total = 0.0
    for n in range(N + 1):
        total += _comb(N, n) * 0.5 ** bits
    return total


def lossless_table(bits: int = 8) -> dict[str, list[float]]:
    """Fig. 2 data: probability for every N in [0, bits]."""
    ns = range(bits + 1)
    return {
        "n_shifts": list(ns),
        "swis": [p_lossless_swis(n, bits) for n in ns],
        "swis_c": [p_lossless_swis_c(n, bits) for n in ns],
        "layerwise": [p_lossless_layerwise(n, bits) for n in ns],
    }
