"""Observability of the port: spans, metrics, and profiling hooks.

The port of the JAX package's ``repro.obs``, threaded through the port's
federated stack:

- :mod:`repro_torch.obs.trace` — a bounded-ring span :class:`Tracer` with a
  Chrome/Perfetto ``trace.json`` exporter (a copy of the reference's);
  :data:`NULL_TRACER` is the default everywhere so the instrumented-off hot
  path stays free.  The port adds a ``device`` clock: on the card a
  ``capture.GraphCache`` given its owner's tracer (the cohort trainer's,
  ``make_serve_step(model, tracer=)``'s) times each replayed graph between
  two CUDA events, put on the host clock by one anchor taken after a
  synchronize; such a trace exports the tracer's birth as
  ``baseTimeNanoseconds``, the clock ``torch.profiler``'s export uses.  Its
  host spans beside the reference's: ``generators`` and ``readback`` in
  each round, ``cohort_step`` (each captured batched step's host work) and
  ``serve_step`` (each decode call).
- :mod:`repro_torch.obs.metrics` — typed counters/gauges/histograms behind a
  :class:`MetricsRegistry` with a single ``snapshot()`` schema, streamed as
  ``metrics.jsonl`` by the control plane and carried inside federation
  snapshots so resume continues the series (a copy of the reference's).
- :mod:`repro_torch.obs.profile` — the ``observability`` section's defaults
  and validation, optional ``torch.profiler`` capture around designated
  rounds (:class:`RoundProfiler`) and the kernel libraries' build and load
  events as ``jit.*`` metrics (:class:`CompileWatcher`).

``python -m repro_torch.obs report <run_dir>`` renders a per-phase time
breakdown and the top-k slowest clients from an exported trace, and, where
the run traced device spans and ``RoundProfiler`` wrote its profiles, the
device's idle time in the profiled rounds by the host span open at each
gap's start.

Under a data mesh (``launch/mesh.py``) every rank runs the same round
program; the control plane gives the facades of ranks other than 0 the
null tracer and no profiler, so a job's ``trace.json`` and profiles are
rank 0's, whole, and no rank writes a file of its own.
"""

from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.profile import (
    OBSERVABILITY_DEFAULTS,
    CompileWatcher,
    ObservabilityConfig,
    RoundProfiler,
    resolve_observability,
)
from repro_torch.obs.trace import NULL_TRACER, NullTracer, SpanEvent, Tracer, resolve_tracer

__all__ = [
    "CompileWatcher",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_TRACER",
    "NullTracer",
    "OBSERVABILITY_DEFAULTS",
    "ObservabilityConfig",
    "RoundProfiler",
    "SpanEvent",
    "Tracer",
    "resolve_observability",
    "resolve_tracer",
]
