"""Counters, gauges and reservoir histograms behind a `MetricsRegistry`.

Design constraints, in order:

1. **Zero dependencies on the hot path.** Instruments are plain Python
   objects; one `Histogram.observe` is an attribute bump plus a list
   append (or an O(1) reservoir replacement). No numpy import is needed
   until someone asks for a quantile.
2. **Lock-free snapshots.** `snapshot()` copies instrument state without
   taking locks — under the GIL every read it performs is of a
   consistent single value, and the reservoir copy is a single
   ``list(...)``. Writers are never blocked by a reader; a snapshot
   racing a write may miss the very last observation, which is the
   correct trade for telemetry.
3. **Exact quantiles while bounded.** A histogram keeps every sample up
   to ``capacity`` (default 4096) and computes p50/p95/p99 by sorting
   the reservoir with numpy's ``linear`` interpolation — bit-identical
   to ``np.percentile`` until the reservoir overflows, then a seeded
   Algorithm-R reservoir keeps a uniform sample at fixed memory.

A registry constructed with ``enabled=False`` hands out shared no-op
instruments: ``SparseLinear.apply(x, metrics=obs.NULL)`` runs
uninstrumented.
"""

from __future__ import annotations

import math
import random

#: Default histogram reservoir size: exact quantiles for every workload
#: this repo benches (thousands of steps), bounded memory for servers.
DEFAULT_RESERVOIR = 4096

#: rel-IQR above which a timing histogram's sample is counted as noisy
#: (shared with `autotune.measure.TimingSample.noisy`).
NOISY_REL_IQR = 0.5


class Counter:
    """Monotonic counter. ``add`` accepts any non-negative increment so
    byte counters and call counters share one type."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value = 0

    def add(self, n: int | float = 1) -> None:
        self._value += n

    @property
    def value(self):
        return self._value

    def snapshot(self):
        return self._value


class Gauge:
    """Last-write-wins scalar (queue depth, tokens/sec of the last step)."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0

    def set(self, v: float) -> None:
        self._value = float(v)

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> float:
        return self._value


class Histogram:
    """Bounded-reservoir distribution with exact small-sample quantiles.

    ``observe`` is O(1); ``quantile(q)`` sorts a *copy* of the reservoir
    (telemetry reads are rare and must not perturb writers). While
    ``count <= capacity`` quantiles are exact and match
    ``np.percentile(samples, 100 q)``; beyond that the seeded reservoir
    (Algorithm R) keeps a uniform subsample, so quantiles stay unbiased
    at fixed memory. min/max/total/count are always exact.
    """

    __slots__ = ("name", "capacity", "_samples", "_count", "_total",
                 "_min", "_max", "_rng")

    def __init__(self, name: str, capacity: int = DEFAULT_RESERVOIR):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1; got {capacity}")
        self.name = name
        self.capacity = capacity
        self._samples: list[float] = []
        self._count = 0
        self._total = 0.0
        self._min = math.inf
        self._max = -math.inf
        # Deterministic per-instrument seed: two runs of the same
        # workload keep the same reservoir (reproducible BENCH deltas).
        self._rng = random.Random(0xC0FFEE ^ hash(name))

    def observe(self, v: float) -> None:
        v = float(v)
        self._count += 1
        self._total += v
        if v < self._min:
            self._min = v
        if v > self._max:
            self._max = v
        if len(self._samples) < self.capacity:
            self._samples.append(v)
        else:
            j = self._rng.randrange(self._count)
            if j < self.capacity:
                self._samples[j] = v

    @property
    def count(self) -> int:
        return self._count

    @property
    def total(self) -> float:
        return self._total

    @property
    def mean(self) -> float:
        return self._total / self._count if self._count else math.nan

    @property
    def min(self) -> float:
        return self._min if self._count else math.nan

    @property
    def max(self) -> float:
        return self._max if self._count else math.nan

    def quantile(self, q: float) -> float:
        """Exact-over-reservoir quantile, numpy ``linear`` method (so
        tests can pin equality against ``np.percentile``)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1]; got {q}")
        xs = sorted(self._samples)
        if not xs:
            return math.nan
        pos = q * (len(xs) - 1)
        lo = math.floor(pos)
        hi = math.ceil(pos)
        return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)

    def snapshot(self) -> dict:
        return {
            "count": self._count,
            "total": self._total,
            "mean": self.mean,
            "min": self.min,
            "max": self.max,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
        }


class _NullCounter(Counter):
    def add(self, n=1):
        pass


class _NullGauge(Gauge):
    def set(self, v):
        pass


class _NullHistogram(Histogram):
    def observe(self, v):
        pass


class MetricsRegistry:
    """name -> instrument, get-or-create. One registry per concern: the
    process default (`default_registry()`) backs the always-on
    instrumentation; benchmarks construct isolated registries so dense
    and compressed serving runs don't mix samples; ``enabled=False``
    (the shared `NULL` instance) turns every instrument into a no-op."""

    def __init__(self, *, enabled: bool = True,
                 reservoir: int = DEFAULT_RESERVOIR):
        self.enabled = enabled
        self.reservoir = reservoir
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}
        if not enabled:
            self._null_c = _NullCounter("null")
            self._null_g = _NullGauge("null")
            self._null_h = _NullHistogram("null")

    # -- get-or-create ---------------------------------------------------
    def counter(self, name: str) -> Counter:
        if not self.enabled:
            return self._null_c
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        if not self.enabled:
            return self._null_g
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str, capacity: int | None = None) -> Histogram:
        if not self.enabled:
            return self._null_h
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(
                name, capacity if capacity is not None else self.reservoir)
        return h

    # -- reads -----------------------------------------------------------
    def snapshot(self) -> dict:
        """Plain-dict copy of every instrument — safe to mutate, safe to
        ``json.dump``, detached from subsequent writes."""
        return {
            "counters": {k: c.snapshot()
                         for k, c in self._counters.items()},
            "gauges": {k: g.snapshot() for k, g in self._gauges.items()},
            "histograms": {k: h.snapshot()
                           for k, h in self._histograms.items()},
        }

    def reset(self) -> None:
        self._counters.clear()
        self._gauges.clear()
        self._histograms.clear()


#: Shared no-op registry: ``apply(x, metrics=obs.NULL)`` runs uninstrumented.
NULL = MetricsRegistry(enabled=False)

_default = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry behind the always-on instrumentation."""
    return _default
