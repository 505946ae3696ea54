"""The yardstick's frozen arithmetic: the card's peaks, and the operations
and bytes that the window's tokens need, kernel by kernel and for the whole
model step.

Counts are of the work, not of an implementation: every input byte once,
as the SWIS packed format stores it, every output byte once, and the
algorithm's 2*M*K*N operations once. Rows are the real tokens (no bucket
padding, no idle slots); the expert layer's work is that of the routed
pairs (tokens x top-k) and its bytes those of the real experts, never the
padding ones. A later kernel that skips work is held to the same counts.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit: the
# tensor-core rate of the fp16 operands that any fp32-accurate route can
# use, and HBM3 bandwidth.
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
F32 = 4


def packed_bytes(k: int, n: int, planes: int, group: int) -> int:
    """Bytes of one packed (K, N) SWIS weight: sign and mask planes (a bit
    a weight each), nibble-packed shifts (ceil(planes / 2) bytes a group
    and column) and one float32 scale a column."""
    return (k * n * (1 + planes)) // 8 + (k // group) * n * (
        (planes + 1) // 2) + n * F32


def gemm(m: int, k: int, n: int, planes: int, group: int) -> tuple:
    """(flops, bytes) of M float32 rows through one packed (K, N) weight,
    float32 out."""
    return (2 * m * k * n,
            packed_bytes(k, n, planes, group) + m * k * F32 + m * n * F32)


def bound_s(flops: float, nbytes: float) -> float:
    """Least time the card can take: the larger of the two rooflines."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


class Model:
    """Counts for one configuration (a parsed ``configs/<name>.json``)."""

    def __init__(self, arch: dict, planes: int, group: int):
        self.d = arch["d_model"]
        self.h, self.hkv = arch["n_heads"], arch["n_kv_heads"]
        self.dh = arch["head_dim"]
        self.d_ff = arch["d_ff"]
        self.vocab = arch["vocab"]
        self.layers = arch["n_layers"]
        self.moe = arch.get("moe")
        self.planes, self.group = planes, group

    def _g(self, m, k, n):
        return gemm(m, k, n, self.planes, self.group)

    def swis_2d(self, m: int) -> list:
        """(flops, bytes) of each 2-D SWIS launch of one layer over m rows:
        q, k, v, o, and the MLP's or the shared experts' in, gate, out."""
        d, qd, kvd = self.d, self.h * self.dh, self.hkv * self.dh
        ff = self.moe["d_ff_shared"] if self.moe else self.d_ff
        return [self._g(m, d, qd), self._g(m, d, kvd), self._g(m, d, kvd),
                self._g(m, qd, d), self._g(m, d, ff), self._g(m, d, ff),
                self._g(m, ff, d)]

    def experts(self, m: int) -> list:
        """(flops, bytes) of each expert-stack launch of one layer (in,
        gate, out) over m tokens: the m * top_k routed pairs' work and the
        real experts' packed bytes."""
        mo = self.moe
        d, f, e, k = self.d, mo["d_ff_expert"], mo["n_experts"], mo["top_k"]
        pairs = m * k
        w_in = e * packed_bytes(d, f, self.planes, self.group)
        w_out = e * packed_bytes(f, d, self.planes, self.group)
        up = (2 * pairs * d * f, w_in + m * d * F32 + pairs * f * F32)
        down = (2 * pairs * f * d, w_out + pairs * f * F32 + pairs * d * F32)
        return [up, up, down]

    def paged(self, ctxs) -> tuple:
        """(flops, bytes) of one layer's paged-attention launch over decode
        rows that see ``ctxs`` positions each: scores and the weighted sum,
        each row's K/V read once (float32 cache), q in and out."""
        n, seen = len(ctxs), sum(ctxs)
        return (4 * self.h * self.dh * seen,
                2 * seen * self.hkv * self.dh * F32
                + 2 * n * self.h * self.dh * F32)

    def bound_s(self, launches) -> float:
        """Least time of a layer's launches, times the layers."""
        return self.layers * sum(bound_s(f, b) for f, b in launches)

    def model_flops(self, tokens: int, ctx_sum: int, logits: int) -> float:
        """The model FLOPs that ``tokens`` tokens need, whose attention
        spans sum to ``ctx_sum`` positions and of which ``logits`` rows are
        unembedded: 2 x the weights each token multiplies by (routed
        experts at top_k, the router), scores and weighted sums, and the
        unembedding."""
        d, qd, kvd = self.d, self.h * self.dh, self.hkv * self.dh
        per_layer = d * qd + 2 * d * kvd + qd * d
        if self.moe:
            mo = self.moe
            per_layer += 3 * d * mo["d_ff_shared"]
            per_layer += mo["top_k"] * 3 * d * mo["d_ff_expert"]
            per_layer += d * mo["n_experts"]
        else:
            per_layer += 3 * d * self.d_ff
        return (2.0 * tokens * self.layers * per_layer
                + 4.0 * self.h * self.dh * self.layers * ctx_sum
                + 2.0 * logits * d * self.vocab)
