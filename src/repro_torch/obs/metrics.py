"""Metric registry: counters, gauges, HDR-style histograms, JSONL sink.

One flat dotted namespace replaces the hand-rolled counter dicts that
grew in ``SGFService.counters()``, ``PlanCache``, ``ResultCache``, and
``FTStats`` (DESIGN.md §14):

* ``msj.*`` — engine-level work: ``msj.jobs``, ``msj.shuffle.bytes``
* ``svc.*`` — service layers: ``svc.plan_cache.hit``,
  ``svc.result_cache.query.hit``, ``svc.tick.latency`` (histogram),
  ``svc.request.latency`` (histogram), ``svc.req.failed``, …
* ``ft.*`` — fault tolerance: ``ft.fault.injected``, ``ft.taint.jobs``,
  ``ft.capacity.retries``, ``ft.shard.losses``, …

The legacy classes keep their public attributes (``cache.hits``,
``results.partial_skipped += 1``, ``stats.retries``) as *properties over
registry counters* (:func:`counter_attr`), so every existing call site,
test, and bench acceptance block keeps working while the values live in
one place.

Histograms are HDR-style: log₂ buckets with ``2**sub_bits`` linear
sub-buckets per octave — bounded relative error (< 2⁻ˢᵘᵇ per bucket,
~3% at the default 5 bits) over an unbounded dynamic range, constant
memory per decade, O(1) observe.  ``percentile`` reports the bucket's
upper edge, the HDR convention (pessimistic, never under-reports a
latency SLO).
"""
from __future__ import annotations

import json
import math
from typing import IO


class Counter:
    """Monotone-by-convention cumulative value (int or float)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n=1):
        self.value += n

    add = inc

    def snapshot(self):
        return self.value


class Gauge:
    """Point-in-time value (queue depth, cache size)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def set(self, v):
        self.value = v

    def snapshot(self):
        return self.value


class Histogram:
    """HDR-style log-bucketed histogram of non-negative values.

    Bucket key: ``(exponent, sub)`` from ``math.frexp`` — the value's
    binary octave plus a linear position among ``2**sub_bits`` sub-buckets
    within it.  Exact zero gets its own bucket.
    """

    __slots__ = ("name", "sub_bits", "count", "total", "min", "max", "_buckets")

    def __init__(self, name: str, sub_bits: int = 5):
        self.name = name
        self.sub_bits = sub_bits
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = 0.0
        self._buckets: dict[tuple[int, int], int] = {}

    def _key(self, v: float) -> tuple[int, int]:
        if v <= 0.0:
            return (-(2**30), 0)
        m, e = math.frexp(v)  # v = m * 2**e, m in [0.5, 1)
        return (e, int((m - 0.5) * (2 << self.sub_bits)))

    def _upper(self, key: tuple[int, int]) -> float:
        e, sub = key
        if e == -(2**30):
            return 0.0
        return math.ldexp(0.5 + (sub + 1) / (2 << self.sub_bits), e)

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        k = self._key(v)
        self._buckets[k] = self._buckets.get(k, 0) + 1

    def percentile(self, p: float) -> float:
        """Value at quantile ``p`` in [0, 1] (upper bucket edge; exact max
        for p=1).  0.0 on an empty histogram."""
        if self.count == 0:
            return 0.0
        if p >= 1.0:
            return self.max
        rank = p * self.count
        seen = 0
        for key in sorted(self._buckets):
            seen += self._buckets[key]
            if seen >= rank:
                return min(self._upper(key), self.max)
        return self.max

    def snapshot(self) -> dict:
        if self.count == 0:
            return {"count": 0, "sum": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0,
                    "min": 0.0, "max": 0.0}
        return {
            "count": self.count,
            "sum": self.total,
            "p50": self.percentile(0.50),
            "p95": self.percentile(0.95),
            "p99": self.percentile(0.99),
            "min": self.min,
            "max": self.max,
        }


class MetricRegistry:
    """Get-or-create registry; one instance per service/executor tree."""

    def __init__(self):
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}

    def _get(self, name: str, cls, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, **kw)
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {type(m).__name__}, "
                f"requested {cls.__name__}"
            )
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, sub_bits: int = 5) -> Histogram:
        return self._get(name, Histogram, sub_bits=sub_bits)

    def names(self) -> list[str]:
        return sorted(self._metrics)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def snapshot(self) -> dict:
        """Flat ``name -> value`` (histograms: a summary sub-dict)."""
        return {name: self._metrics[name].snapshot() for name in self.names()}


def counter_attr(metric_name: str) -> property:
    """A class attribute backed by a registry counter.

    The owning instance must expose ``self.metrics`` (a
    :class:`MetricRegistry`).  Reads return the counter value; writes
    translate assignment into a delta (`obj.attr += 1` keeps working at
    every legacy call site), so the registry stays the single source of
    truth while the old attribute API survives unchanged.
    """

    def fget(self):
        return self.metrics.counter(metric_name).value

    def fset(self, v):
        c = self.metrics.counter(metric_name)
        c.add(v - c.value)

    return property(fget, fset, doc=f"registry counter {metric_name!r}")


class JsonlSink:
    """Append metric snapshots as JSON lines (one object per write).

    Python's ``json`` emits shortest-roundtrip float reprs, so a reader
    recovers every value bit-exactly.
    """

    def __init__(self, path_or_file: str | IO):
        self._own = isinstance(path_or_file, str)
        self._f: IO = open(path_or_file, "a") if self._own else path_or_file

    def write(self, record: dict, **extra) -> None:
        self._f.write(json.dumps({**record, **extra}, sort_keys=True) + "\n")
        self._f.flush()

    def write_registry(self, registry: MetricRegistry, **extra) -> None:
        self.write({"metrics": registry.snapshot()}, **extra)

    def close(self) -> None:
        if self._own:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
