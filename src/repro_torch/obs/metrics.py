"""Metrics registry: counters, gauges, and log-bucketed latency
histograms, with a diffable ``snapshot()`` API and Prometheus text
exposition.  Stdlib-only.

Histograms never retain samples: an observation lands in a geometric
bucket (``growth`` ratio per bucket, default ``2**0.25`` ≈ 19% wide),
so p50/p99 estimates carry a bounded *relative* error of at most
``sqrt(growth) - 1`` ≈ 9% — plenty for latency attribution, constant
memory under any load (``tests/test_obs.py`` property-tests the bound
against exact sample percentiles).

``snapshot()`` returns plain JSON-able data (ints/floats/dicts) so
benchmark rows and CI artifacts can embed it directly;
:func:`diff_snapshots` subtracts two snapshots for interval readings.
``to_prometheus()`` renders the text exposition format (counters and
gauges as themselves, histograms as summaries with p50/p99 quantiles),
which :class:`repro_torch.core.scheduler.AsyncServer` serves over HTTP when
``metrics_port`` is set.
"""
from __future__ import annotations

import math
import re
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "diff_snapshots"]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    name = _NAME_RE.sub("_", name)
    if not name or not (name[0].isalpha() or name[0] in "_:"):
        name = "_" + name
    return name


class Counter:
    """Monotone event count."""

    __slots__ = ("name", "help", "value")

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def snapshot_value(self):
        return self.value


class Gauge:
    """Point-in-time level (in-flight slots, queue depth, ...)."""

    __slots__ = ("name", "help", "value")

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def snapshot_value(self):
        return self.value


class Histogram:
    """Log-bucketed latency histogram: p50/p99 without sample retention.

    Bucket ``i`` covers ``(min_value * growth**(i-1), min_value *
    growth**i]``; observations at or below ``min_value`` land in bucket
    0.  :meth:`quantile` walks the cumulative counts and returns the
    geometric midpoint of the bucket holding the ``ceil(q*count)``-th
    smallest observation, so the estimate is within a factor
    ``sqrt(growth)`` of the exact sample percentile."""

    __slots__ = ("name", "help", "growth", "min_value", "count", "sum",
                 "min", "max", "_log_g", "_buckets")

    kind = "histogram"

    def __init__(self, name: str, help: str = "", growth: float = 2 ** 0.25,
                 min_value: float = 1e-7):
        if growth <= 1.0:
            raise ValueError("growth must be > 1")
        self.name = name
        self.help = help
        self.growth = float(growth)
        self.min_value = float(min_value)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._log_g = math.log(self.growth)
        self._buckets: Dict[int, int] = {}

    def observe(self, x: float) -> None:
        x = float(x)
        if x <= self.min_value:
            idx = 0
        else:
            idx = max(1, math.ceil(math.log(x / self.min_value)
                                   / self._log_g - 1e-12))
        self._buckets[idx] = self._buckets.get(idx, 0) + 1
        self.count += 1
        self.sum += x
        self.min = min(self.min, x)
        self.max = max(self.max, x)

    def _representative(self, idx: int) -> float:
        if idx == 0:
            return self.min_value
        return self.min_value * self.growth ** (idx - 0.5)

    def quantile(self, q: float) -> float:
        """Estimated ``q``-quantile (0 < q <= 1); 0.0 when empty."""
        if self.count == 0:
            return 0.0
        rank = max(1, math.ceil(q * self.count))
        acc = 0
        for idx in sorted(self._buckets):
            acc += self._buckets[idx]
            if acc >= rank:
                return min(self.max,
                           max(self.min, self._representative(idx)))
        return self.max

    def snapshot_value(self) -> Dict[str, float]:
        if self.count == 0:
            return {"count": 0, "sum": 0.0}
        return {"count": self.count, "sum": self.sum,
                "min": self.min, "max": self.max,
                "mean": self.sum / self.count,
                "p50": self.quantile(0.50), "p90": self.quantile(0.90),
                "p99": self.quantile(0.99)}


class MetricsRegistry:
    """Named metrics, insertion-ordered (deterministic exposition).

    ``counter``/``gauge``/``histogram`` are get-or-create, so call
    sites never coordinate registration; asking for an existing name
    with a different kind is an error (one name, one meaning)."""

    def __init__(self):
        self._metrics: Dict[str, Any] = {}

    def _get_or_create(self, cls, name: str, help: str, **kwargs):
        m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{m.kind}, requested {cls.kind}")
            return m
        m = cls(name, help, **kwargs)
        self._metrics[name] = m
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  growth: float = 2 ** 0.25,
                  min_value: float = 1e-7) -> Histogram:
        return self._get_or_create(Histogram, name, help, growth=growth,
                                   min_value=min_value)

    def snapshot(self) -> Dict[str, Any]:
        """Plain JSON-able data: counter/gauge values, histogram stat
        dicts.  Diffable with :func:`diff_snapshots`."""
        return {name: m.snapshot_value()
                for name, m in self._metrics.items()}

    def to_prometheus(self) -> str:
        """Text exposition (version 0.0.4): counters and gauges as-is,
        histograms as summaries with p50/p99 quantile lines."""
        out: List[str] = []
        for name, m in self._metrics.items():
            pname = _prom_name(name)
            if m.help:
                out.append(f"# HELP {pname} {m.help}")
            if m.kind in ("counter", "gauge"):
                out.append(f"# TYPE {pname} {m.kind}")
                out.append(f"{pname} {_fmt(m.value)}")
                continue
            out.append(f"# TYPE {pname} summary")
            for q in (0.5, 0.99):
                out.append(f'{pname}{{quantile="{q}"}} '
                           f"{_fmt(m.quantile(q))}")
            out.append(f"{pname}_sum {_fmt(m.sum)}")
            out.append(f"{pname}_count {m.count}")
        return "\n".join(out) + "\n"


def _fmt(v) -> str:
    if isinstance(v, float) and (math.isinf(v) or math.isnan(v)):
        return "0"
    if isinstance(v, float):
        return repr(v)
    return str(v)


def diff_snapshots(cur: Dict[str, Any],
                   prev: Dict[str, Any]) -> Dict[str, Any]:
    """Per-metric delta of two :meth:`MetricsRegistry.snapshot` docs —
    counters/gauges subtract, histogram stat dicts subtract the
    monotone fields (``count``/``sum``) and keep the current quantiles
    (quantiles of an interval are not derivable from two cumulative
    snapshots without retained samples)."""
    out: Dict[str, Any] = {}
    for name, val in cur.items():
        base = prev.get(name)
        if isinstance(val, dict):
            d = dict(val)
            if isinstance(base, dict):
                d["count"] = val.get("count", 0) - base.get("count", 0)
                d["sum"] = val.get("sum", 0.0) - base.get("sum", 0.0)
            out[name] = d
        elif isinstance(base, (int, float)):
            out[name] = val - base
        else:
            out[name] = val
    return out
