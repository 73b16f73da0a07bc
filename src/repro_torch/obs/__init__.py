"""Observability of the port: the metrics registry and the job spec's
``observability`` section.

- :mod:`repro_torch.obs.metrics` — typed counters/gauges/histograms behind a
  :class:`MetricsRegistry` with a single ``snapshot()`` schema, streamed as
  ``metrics.jsonl`` by the control plane and carried inside federation
  snapshots so resume continues the series (a copy of the reference's).
- :mod:`repro_torch.obs.profile` — the ``observability`` section's defaults
  and validation.

The reference's span tracer, round profiler, compile-event counters and
report CLI wait for ROADMAP Queue 1 item 8.
"""

from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.profile import (
    OBSERVABILITY_DEFAULTS,
    ObservabilityConfig,
    resolve_observability,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "OBSERVABILITY_DEFAULTS",
    "ObservabilityConfig",
    "resolve_observability",
]
