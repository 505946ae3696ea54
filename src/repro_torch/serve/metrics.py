"""Lightweight metrics registry for the serve stack.

Zero-dependency (numpy-only) counters, gauges, and histograms behind a
single :class:`MetricsRegistry`, plus monotonic-clock timer contexts —
the measurement layer of the serve engine (port of
``repro.serve.metrics``, numpy only, as the reference).

Design constraints, in order:

* **Near-zero overhead when disabled.** A disabled registry hands out a
  shared no-op timer and every instrument mutation is a single attribute
  check away from returning. Nothing allocates per step.
* **Histogram percentiles must be trustworthy at bench scale.** Buckets
  alone interpolate; a bench gate wants the real p95. Histograms keep
  fixed log-spaced bucket counts (cheap, bounded, exportable) *and* a
  bounded ring of raw samples: ``percentile()`` is exact while the
  observation count fits the ring and falls back to log-linear bucket
  interpolation beyond it.
* **One snapshot API.** ``snapshot()`` returns a plain nested dict of
  python scalars/lists — JSON-ready, no live references, safe to diff
  across steps.

Timers use ``time.perf_counter`` (monotonic); wall-clock anchoring for
export lives in :mod:`repro_torch.serve.trace`, not here.
"""
from __future__ import annotations

import collections
import math
import time
from typing import Dict, List, Optional

import numpy as np

# default histogram domain: 1us .. 1024s in 4 log-spaced buckets per
# decade — wide enough for a device-sync phase and a whole bench pass
_DEFAULT_LO = 1e-6
_DEFAULT_HI = 1024.0
_BUCKETS_PER_DECADE = 4
_SAMPLE_RING = 4096  # raw-sample ring: exact percentiles at bench scale


def log_buckets(lo: float = _DEFAULT_LO, hi: float = _DEFAULT_HI,
                per_decade: int = _BUCKETS_PER_DECADE) -> np.ndarray:
    """Fixed log-spaced bucket upper edges covering [lo, hi]."""
    n = int(math.ceil(math.log10(hi / lo) * per_decade)) + 1
    return lo * np.power(10.0, np.arange(n) / per_decade)


def cost_buckets() -> np.ndarray:
    """Bucket edges for cost-model histograms (FLOPs / bytes / cycles per
    dispatch): 1 .. 1e15 at 2 buckets per decade — coarse on purpose, the
    raw-sample ring carries the exact percentiles at bench scale."""
    return log_buckets(1.0, 1e15, per_decade=2)


class Counter:
    """Monotonically increasing count."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Point-in-time value (set wins; ``inc`` for deltas)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Histogram:
    """Log-spaced-bucket histogram with a bounded raw-sample ring.

    ``observe`` is O(log n_buckets) (searchsorted) plus a deque append.
    ``percentile`` is exact while ``count <= ring capacity``; beyond that
    it interpolates log-linearly inside the bucket the rank falls in —
    the fixed edges mean the error is bounded by the bucket ratio
    (10^(1/per_decade), ~1.78x at the default 4/decade).
    """

    __slots__ = ("edges", "counts", "count", "total", "vmin", "vmax",
                 "_ring")

    def __init__(self, edges: Optional[np.ndarray] = None):
        self.edges = log_buckets() if edges is None else np.asarray(
            edges, np.float64)
        self.counts = np.zeros(len(self.edges) + 1, np.int64)
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self._ring: collections.deque = collections.deque(
            maxlen=_SAMPLE_RING)

    def observe(self, v: float) -> None:
        self.counts[int(np.searchsorted(self.edges, v))] += 1
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        self._ring.append(v)

    def percentile(self, q: float) -> float:
        """q in [0, 100]. Exact from the raw ring when nothing has been
        evicted from it; bucket-interpolated otherwise."""
        if self.count == 0:
            return 0.0
        if self.count <= self._ring.maxlen:
            return float(np.percentile(np.asarray(self._ring), q))
        rank = q / 100.0 * (self.count - 1)
        cum = np.cumsum(self.counts)
        b = int(np.searchsorted(cum, rank + 1))
        lo = self.edges[b - 1] if b > 0 else (
            self.vmin if self.vmin < self.edges[0] else self.edges[0] / 2)
        hi = self.edges[b] if b < len(self.edges) else self.vmax
        prev = cum[b - 1] if b > 0 else 0
        frac = (rank + 1 - prev) / max(self.counts[b], 1)
        # log-linear within the bucket (edges are log-spaced)
        lo = max(lo, 1e-12)
        return float(lo * (max(hi, lo) / lo) ** frac)

    def summary(self) -> Dict[str, float]:
        mean = self.total / self.count if self.count else 0.0
        return {"count": self.count, "sum": self.total, "mean": mean,
                "min": self.vmin if self.count else 0.0,
                "max": self.vmax if self.count else 0.0,
                "p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99)}


class _Timer:
    """``with registry.timer("name"):`` — observes elapsed seconds."""

    __slots__ = ("_hist", "_t0")

    def __init__(self, hist: Histogram):
        self._hist = hist

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._hist.observe(time.perf_counter() - self._t0)
        return False


class _NullTimer:
    """Shared no-op context: the disabled-registry fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_TIMER = _NullTimer()
_NULL_COUNTER = Counter()  # sink for disabled-registry mutations
_NULL_GAUGE = Gauge()


class MetricsRegistry:
    """Named counters/gauges/histograms with one ``snapshot()``.

    Instruments are created on first use and live for the registry's
    lifetime (``reset()`` zeroes them in place, so held references stay
    valid — the engine keeps phase timers across ``engine.reset()``).
    When ``enabled=False`` every accessor returns a shared no-op/sink
    instrument and ``timer()`` returns a shared null context — the hot
    path pays one attribute check, no allocation, no clock read.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}

    # -- instruments -----------------------------------------------------

    def counter(self, name: str) -> Counter:
        if not self.enabled:
            return _NULL_COUNTER
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        if not self.enabled:
            return _NULL_GAUGE
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge()
        return g

    def histogram(self, name: str,
                  edges: Optional[np.ndarray] = None) -> Histogram:
        if not self.enabled:
            return _DISABLED_HIST
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram(edges)
        return h

    def timer(self, name: str):
        if not self.enabled:
            return _NULL_TIMER
        return _Timer(self.histogram(name))

    def observe(self, name: str, v: float) -> None:
        if self.enabled:
            self.histogram(name).observe(v)

    # -- lifecycle -------------------------------------------------------

    def reset(self) -> None:
        """Zero every instrument in place (references stay valid)."""
        for c in self._counters.values():
            c.value = 0
        for g in self._gauges.values():
            g.value = 0.0
        for h in self._hists.values():
            h.counts[:] = 0
            h.count = 0
            h.total = 0.0
            h.vmin = math.inf
            h.vmax = -math.inf
            h._ring.clear()

    def snapshot(self) -> Dict[str, Dict]:
        """Plain nested dict of python scalars — JSON-ready, no live
        references. Histograms export their summary plus non-empty
        bucket (upper-edge, count) pairs."""
        out: Dict[str, Dict] = {
            "counters": {k: c.value for k, c in self._counters.items()},
            "gauges": {k: g.value for k, g in self._gauges.items()},
            "histograms": {},
        }
        for k, h in self._hists.items():
            s = h.summary()
            nz = np.nonzero(h.counts)[0]
            s["buckets"] = [
                [float(h.edges[i]) if i < len(h.edges) else math.inf,
                 int(h.counts[i])] for i in nz]
            out["histograms"][k] = s
        return out


class _DisabledHistogram(Histogram):
    """Sink histogram handed out by a disabled registry."""

    __slots__ = ()

    def observe(self, v: float) -> None:  # drop
        return


_DISABLED_HIST = _DisabledHistogram()


def _hist_unit(name: str):
    """(scale, suffix, format) for a histogram by name convention:
    ``*_s`` seconds → ms, ``*_bytes`` → MiB, anything else (FLOPs,
    cycles) raw with a compact general format."""
    if name.endswith("_s"):
        return 1e3, "ms", ".3f"
    if name.endswith("_bytes"):
        return 1.0 / 2**20, "MiB", ".3f"
    return 1.0, "", ".4g"


def format_report(snapshot: Dict[str, Dict], title: str = "metrics") -> str:
    """Human-readable multi-line report of a ``snapshot()`` dict —
    used by ``repro_torch.launch.serve`` and
    ``repro_torch.examples.serve_swis``. Each histogram is scaled by its
    name's unit convention (``_s`` → ms, ``_bytes`` → MiB, else raw), so
    step-phase timings and cost-model byte/FLOP/cycle histograms render
    side by side without mislabeling."""
    lines: List[str] = [f"== {title} =="]
    if snapshot.get("counters"):
        lines.append("  counters: " + "  ".join(
            f"{k}={v:g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in sorted(snapshot["counters"].items())))
    if snapshot.get("gauges"):
        lines.append("  gauges:   " + "  ".join(
            f"{k}={v:g}" for k, v in sorted(snapshot["gauges"].items())))
    for k in sorted(snapshot.get("histograms", {})):
        s = snapshot["histograms"][k]
        if not s["count"]:
            continue
        scale, unit, fmt = _hist_unit(k)
        lines.append(
            f"  {k}: n={s['count']} p50={s['p50'] * scale:{fmt}}{unit} "
            f"p95={s['p95'] * scale:{fmt}}{unit} "
            f"max={s['max'] * scale:{fmt}}{unit}")
    return "\n".join(lines)
