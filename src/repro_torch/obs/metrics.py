"""Typed metrics in a process-global named registry: a copy of the JAX
package's ``obs/metrics.py``.

Three primitives, :class:`Counter`, :class:`Gauge` and :class:`Histogram`,
plus :class:`CounterGroup`, a locked mapping of related counters with a
``collections.Counter``-like API (``group.clear()``, ``group["k"]``,
``dict(group)``).

Histograms are fixed-bucket: ``observe`` is a bisect into a static edge
list, and percentiles are reconstructed from bucket counts (linear
interpolation inside the winning bucket, clamped to the observed min and
max), so a p99 over a long run costs O(buckets) memory. The estimate lies
within one bucket width of the true order statistic.

Host-side pure Python. Callers record at host boundaries only: never from
inside a kernel launch path that would need a device read to do so.
Counter, gauge and histogram writes return early while
:func:`repro_torch.obs.set_enabled` has switched the layer off; counter
groups keep counting.
"""
from __future__ import annotations

import bisect
import math
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from repro_torch.obs import _state

__all__ = [
    "Counter", "CounterGroup", "Gauge", "Histogram", "MetricsRegistry",
    "REGISTRY", "counter", "counter_group", "gauge", "histogram",
    "MS_BUCKETS", "S_BUCKETS", "RATE_BUCKETS", "LOG10_BUCKETS",
]

# Wall-time buckets in milliseconds: sub-0.1 ms host blips up through
# multi-minute LiGO phases.
MS_BUCKETS: Tuple[float, ...] = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
    500.0, 1000.0, 2500.0, 5000.0, 10_000.0, 30_000.0, 60_000.0,
    120_000.0, 300_000.0,
)
# Seconds variant for long walls (hop budgets, stage legs).
S_BUCKETS: Tuple[float, ...] = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
    60.0, 120.0, 300.0, 600.0,
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


class Counter:
    """Monotonic counter. ``inc`` is atomic under an internal lock."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        if not _state.enabled():
            return
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0

    def snapshot(self) -> dict:
        return {"kind": "counter", "value": self.value}

    def __repr__(self) -> str:
        return f"Counter({self.name}={self.value})"


class Gauge:
    """Last-write-wins scalar (pool occupancy, EMAs, watchdog budget)."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value: Optional[float] = None

    def set(self, v: float) -> None:
        if not _state.enabled():
            return
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> Optional[float]:
        with self._lock:
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = None

    def snapshot(self) -> dict:
        return {"kind": "gauge", "value": self.value}

    def __repr__(self) -> str:
        return f"Gauge({self.name}={self.value})"


class Histogram:
    """Fixed-bucket histogram with percentiles reconstructed from buckets.

    ``buckets`` are finite upper edges (sorted ascending); an implicit
    +inf bucket catches the tail. ``percentile(q)`` walks the cumulative
    counts to the bucket holding the ``ceil(q/100 · n)``-th observation and
    interpolates linearly inside it, clamped to the observed min and max.
    """

    __slots__ = ("name", "_edges", "_lock", "_counts", "_n", "_sum",
                 "_min", "_max")

    def __init__(self, name: str, buckets: Sequence[float] = MS_BUCKETS):
        edges = tuple(float(b) for b in buckets)
        if list(edges) != sorted(set(edges)):
            raise ValueError(f"histogram buckets must be sorted+unique: "
                             f"{buckets}")
        if any(math.isinf(b) for b in edges):
            raise ValueError("omit +inf: the overflow bucket is implicit")
        self.name = name
        self._edges = edges
        self._lock = threading.Lock()
        self._counts = [0] * (len(edges) + 1)
        self._n = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    @property
    def buckets(self) -> Tuple[float, ...]:
        return self._edges

    def observe(self, v: float) -> None:
        if not _state.enabled():
            return
        v = float(v)
        i = bisect.bisect_left(self._edges, v)
        with self._lock:
            self._counts[i] += 1
            self._n += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

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
                frac = (rank - cum) / c
                est = lo + (hi - lo) * frac
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

    def snapshot(self) -> dict:
        with self._lock:
            n, s = self._n, self._sum
            counts = list(self._counts)
            vmin = None if self._n == 0 else self._min
            vmax = None if self._n == 0 else self._max
        snap = {
            "kind": "histogram", "count": n, "sum": s,
            "min": vmin, "max": vmax,
            "buckets": list(self._edges), "counts": counts,
        }
        snap["p50"] = self.percentile(50)
        snap["p99"] = self.percentile(99)
        return snap

    def __repr__(self) -> str:
        return (f"Histogram({self.name}: n={self.count}, "
                f"p50={self.percentile(50)}, p99={self.percentile(99)})")


class CounterGroup:
    """A locked family of named counters with a ``collections.Counter``-ish
    API: ``inc(key)``, ``group[key]`` (a missing key reads 0),
    ``group[key] = v``, ``key in group``, ``dict(group)``, ``clear()``.
    The lock keeps increments from a background thread (the hop's grow)
    and the engine thread apart. Not gated by the on/off switch."""

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

    def __setitem__(self, key: str, v: int) -> None:
        with self._lock:
            self._values[key] = int(v)

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._values

    def __iter__(self) -> Iterator[str]:
        with self._lock:
            return iter(list(self._values))

    def __len__(self) -> int:
        with self._lock:
            return len(self._values)

    def keys(self) -> List[str]:
        with self._lock:
            return list(self._values)

    def items(self) -> List[Tuple[str, int]]:
        with self._lock:
            return list(self._values.items())

    def get(self, key: str, default: int = 0) -> int:
        with self._lock:
            return self._values.get(key, default)

    def clear(self) -> None:
        with self._lock:
            self._values.clear()

    reset = clear

    def snapshot(self) -> dict:
        with self._lock:
            return {"kind": "counters", "values": dict(self._values)}

    def __repr__(self) -> str:
        with self._lock:
            return f"CounterGroup({self.name}: {dict(self._values)})"


class MetricsRegistry:
    """Get-or-create store of named metrics.

    Re-requesting a name returns the same object; requesting it as another
    type raises ``TypeError``. ``reset()`` zeroes values in place, so held
    handles stay attached.
    """

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

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge)

    def histogram(self, name: str,
                  buckets: Sequence[float] = MS_BUCKETS) -> Histogram:
        return self._get_or_create(name, Histogram, buckets)

    def counter_group(self, name: str) -> CounterGroup:
        return self._get_or_create(name, CounterGroup)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            metrics = dict(self._metrics)
        return {name: m.snapshot() for name, m in sorted(metrics.items())}

    def reset(self) -> None:
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m.reset()


REGISTRY = MetricsRegistry()


def counter(name: str) -> Counter:
    return REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return REGISTRY.gauge(name)


def histogram(name: str, buckets: Sequence[float] = MS_BUCKETS) -> Histogram:
    return REGISTRY.histogram(name, buckets)


def counter_group(name: str) -> CounterGroup:
    return REGISTRY.counter_group(name)
