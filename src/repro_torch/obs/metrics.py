"""Typed metrics registry with a single JSON-safe ``snapshot()`` schema.

A copy of the JAX package's ``obs/metrics.py`` (stdlib only).  Absorbs the
stack's ad-hoc stat dicts — ``CohortTrainer.last_round_stats``
staging/pool counters, async runtime task/drop tallies, comms byte
accounting, DP epsilon, per-round loss — into three primitive types:

- :class:`Counter` — monotone cumulative totals (bytes staged, uploads).
- :class:`Gauge` — last-written values (epsilon, resident bytes).
- :class:`Histogram` — count/sum/min/max/last over observations
  (round wall time, per-round loss, staleness).

``snapshot()`` returns plain ints/floats only, so it streams as one
``metrics.jsonl`` line per round next to ``records.jsonl`` and rides
inside federation snapshots (``load_snapshot`` restores it, letting a
resumed run continue the series instead of restarting counters at zero).
"""

from __future__ import annotations

import math
from typing import Any, Mapping


class Counter:
    """Monotone cumulative counter."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, amount: int | float = 1) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease (inc by {amount})")
        self.value += amount


class Gauge:
    """Last-written value."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)


class Histogram:
    """Running count/sum/min/max/last over observed values."""

    __slots__ = ("name", "count", "sum", "min", "max", "last")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.last = 0.0

    def observe(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.sum += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        self.last = value

    def snapshot(self) -> dict[str, float]:
        out = {"count": self.count, "sum": self.sum, "last": self.last}
        if self.count:
            out["min"] = self.min
            out["max"] = self.max
            out["mean"] = self.sum / self.count
        return out


class MetricsRegistry:
    """Get-or-create registry of named, typed metrics.

    Re-requesting a name with a different type raises — the schema is
    part of the contract ``metrics.jsonl`` consumers rely on.
    """

    def __init__(self) -> None:
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}

    def _get(self, name: str, kind: type) -> Any:
        metric = self._metrics.get(name)
        if metric is None:
            metric = kind(name)
            self._metrics[name] = metric
        elif type(metric) is not kind:
            raise TypeError(
                f"metric {name!r} already registered as {type(metric).__name__}, "
                f"requested {kind.__name__}"
            )
        return metric

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    # ---- snapshot / restore ---------------------------------------------
    def snapshot(self) -> dict[str, Any]:
        counters: dict[str, Any] = {}
        gauges: dict[str, Any] = {}
        histograms: dict[str, Any] = {}
        for name, metric in sorted(self._metrics.items()):
            if isinstance(metric, Counter):
                counters[name] = metric.value
            elif isinstance(metric, Gauge):
                gauges[name] = metric.value
            else:
                histograms[name] = metric.snapshot()
        return {"counters": counters, "gauges": gauges, "histograms": histograms}

    def load_snapshot(self, state: Mapping[str, Any] | None) -> None:
        """Restore a prior ``snapshot()`` so a resumed run continues it."""
        if not state:
            return
        for name, value in state.get("counters", {}).items():
            counter = self.counter(name)
            counter.value = value
        for name, value in state.get("gauges", {}).items():
            self.gauge(name).set(value)
        for name, row in state.get("histograms", {}).items():
            hist = self.histogram(name)
            hist.count = int(row.get("count", 0))
            hist.sum = float(row.get("sum", 0.0))
            hist.last = float(row.get("last", 0.0))
            hist.min = float(row.get("min", math.inf))
            hist.max = float(row.get("max", -math.inf))
