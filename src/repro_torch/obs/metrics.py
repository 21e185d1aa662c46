"""The metrics the compute ledger, the measured-cost pass and the serving
engine publish: a copy of the gauges, counter groups, fixed-bucket
histograms and bucket edges of the JAX package's ``obs/metrics.py``, in a
process-global registry.

Host-side pure Python. Plain counters, the Prometheus text and the rest of
observability are not ported.
"""
from __future__ import annotations

import bisect
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["CounterGroup", "Gauge", "Histogram", "REGISTRY",
           "counter_group", "gauge", "histogram", "MS_BUCKETS",
           "RATE_BUCKETS", "LOG10_BUCKETS"]

# Wall-time buckets in milliseconds.
MS_BUCKETS: Tuple[float, ...] = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
    500.0, 1000.0, 2500.0, 5000.0, 10_000.0, 30_000.0, 60_000.0,
    120_000.0, 300_000.0,
)
# Rates (tokens/s and friends).
RATE_BUCKETS: Tuple[float, ...] = (
    1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0,
    2500.0, 5000.0, 10_000.0, 25_000.0, 100_000.0,
)
# Half-decade edges for count-scale quantities (per-step FLOPs, tokens):
# 1 … ~3e18 at a constant relative resolution of sqrt(10) a bucket.
LOG10_BUCKETS: Tuple[float, ...] = tuple(
    round(10.0 ** (e / 2.0), 6) for e in range(0, 38))


class Gauge:
    """Last-write-wins scalar."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value: Optional[float] = None

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> Optional[float]:
        with self._lock:
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = None


class Histogram:
    """Fixed-bucket histogram; ``percentile(q)`` interpolates inside the
    bucket that holds the ``ceil(q/100 · n)``-th observation, clamped to
    the observed min and max."""

    def __init__(self, name: str, buckets: Sequence[float] = MS_BUCKETS):
        edges = tuple(float(b) for b in buckets)
        if list(edges) != sorted(set(edges)):
            raise ValueError(f"histogram buckets must be sorted and unique: "
                             f"{buckets}")
        if any(math.isinf(b) for b in edges):
            raise ValueError("omit +inf: the overflow bucket is implicit")
        self.name = name
        self._edges = edges
        self._lock = threading.Lock()
        self.reset()

    def observe(self, v: float) -> None:
        v = float(v)
        i = bisect.bisect_left(self._edges, v)
        with self._lock:
            self._counts[i] += 1
            self._n += 1
            self._sum += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)

    @property
    def count(self) -> int:
        with self._lock:
            return self._n

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, q: float) -> Optional[float]:
        with self._lock:
            n, counts = self._n, list(self._counts)
            vmin, vmax = self._min, self._max
        if n == 0:
            return None
        rank = max(1, min(n, math.ceil(q / 100.0 * n)))
        cum = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            lo = self._edges[i - 1] if i > 0 else min(vmin, self._edges[0])
            hi = self._edges[i] if i < len(self._edges) else vmax
            if cum + c >= rank:
                est = lo + (hi - lo) * (rank - cum) / c
                return min(max(est, vmin), vmax)
            cum += c
        return vmax

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self._edges) + 1)
            self._n = 0
            self._sum = 0.0
            self._min = math.inf
            self._max = -math.inf


class CounterGroup:
    """A locked family of named counters: ``inc(key)``, ``group[key]`` (a
    missing key reads 0), ``items()`` and ``clear()``. The lock keeps
    increments from a background thread (the hop's grow) and the engine
    thread apart."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._values: Dict[str, int] = {}

    def inc(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._values[key] = self._values.get(key, 0) + n

    def __getitem__(self, key: str) -> int:
        with self._lock:
            return self._values.get(key, 0)

    def items(self) -> List[Tuple[str, int]]:
        with self._lock:
            return list(self._values.items())

    def clear(self) -> None:
        with self._lock:
            self._values.clear()


class MetricsRegistry:
    """Get-or-create store of named metrics; asking for a name as another
    type raises ``TypeError``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get_or_create(self, name: str, cls, *args):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, *args)
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(m).__name__}, requested "
                                f"{cls.__name__}")
            return m

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge)

    def histogram(self, name: str,
                  buckets: Sequence[float] = MS_BUCKETS) -> Histogram:
        return self._get_or_create(name, Histogram, buckets)

    def counter_group(self, name: str) -> CounterGroup:
        return self._get_or_create(name, CounterGroup)


REGISTRY = MetricsRegistry()


def gauge(name: str) -> Gauge:
    return REGISTRY.gauge(name)


def histogram(name: str, buckets: Sequence[float] = MS_BUCKETS) -> Histogram:
    return REGISTRY.histogram(name, buckets)


def counter_group(name: str) -> CounterGroup:
    return REGISTRY.counter_group(name)
