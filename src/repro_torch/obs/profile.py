"""The job spec's ``observability`` section: defaults, config and validation.

A copy of the spec helpers of the JAX package's ``obs/profile.py``, so that
the control plane validates and hashes an ``observability`` section as the
reference does.  The reference's round profiler (``RoundProfiler``, a
``jax.profiler`` capture) and its compile-event watcher (``CompileWatcher``,
the ``jit.*`` counters from ``jax.monitoring``) have no port yet (ROADMAP
Queue 1 item 8): ``launch/federation_service.py`` refuses a section that asks
for a trace or for profiled rounds.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

# Defaults for the job spec's ``observability`` section.  ``None`` for the
# section itself means "observability off" (same tri-state contract as the
# ``privacy`` section).
OBSERVABILITY_DEFAULTS: dict[str, Any] = {
    "trace": True,
    "trace_capacity": 65536,
    "jax_profile_rounds": 0,
}


@dataclasses.dataclass(frozen=True)
class ObservabilityConfig:
    """Validated ``observability`` job-spec section."""

    trace: bool = True
    trace_capacity: int = 65536
    jax_profile_rounds: int = 0


def resolve_observability(section: Mapping[str, Any] | None) -> ObservabilityConfig | None:
    """Strictly validate an ``observability`` section (``None`` = off)."""
    if section is None:
        return None
    if not isinstance(section, Mapping):
        raise ValueError(f"observability section must be an object or null, got {section!r}")
    merged = dict(OBSERVABILITY_DEFAULTS)
    for key, value in section.items():
        if key not in OBSERVABILITY_DEFAULTS:
            raise ValueError(
                f"unknown observability key {key!r}; valid keys: "
                f"{sorted(OBSERVABILITY_DEFAULTS)}"
            )
        merged[key] = value
    if not isinstance(merged["trace"], bool):
        raise ValueError(f"observability.trace must be a bool, got {merged['trace']!r}")
    for key in ("trace_capacity", "jax_profile_rounds"):
        value = merged[key]
        if not isinstance(value, int) or isinstance(value, bool) or value < 0:
            raise ValueError(f"observability.{key} must be a non-negative int, got {value!r}")
    if merged["trace_capacity"] < 1:
        raise ValueError("observability.trace_capacity must be >= 1")
    return ObservabilityConfig(**merged)
