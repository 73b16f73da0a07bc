"""Profiling hooks: ``torch.profiler`` round capture and library-event metrics.

The port of the JAX package's ``obs/profile.py``.  Two optional instruments,
both wired through the job spec's strict ``observability`` section, whose
defaults, config and validation are the reference's (the key stays
``jax_profile_rounds``, so specs and their hashes equal the reference's):

- :class:`RoundProfiler` captures a ``torch.profiler`` trace around the
  first N rounds of a run (CPU activities, and CUDA activities when the run
  trains on the card) and exports it as a Chrome trace into its
  ``log_dir`` (``<run_dir>/torch_profile`` under the control plane).
- :class:`CompileWatcher` counts the port's compile events, the kernel
  libraries' ``nvcc`` builds and first loads in the process
  (``kernels/backend.py``), and surfaces them under the reference's names:
  ``jit.compiles`` / ``jit.compile_time_s`` counters and a per-round
  ``jit.round_compiles`` gauge.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Mapping

from repro_torch.device import resolve_device
from repro_torch.kernels import backend
from repro_torch.obs.metrics import MetricsRegistry

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


class RoundProfiler:
    """Capture a ``torch.profiler`` trace around the first ``rounds`` rounds.

    ``round_start``/``round_end`` are called by the round program with the
    global round index; capture begins at the first observed round and
    stops after ``rounds`` rounds have ended (so a resumed run profiles its
    own first rounds, where the kernel libraries load again).  The window is
    exported to ``<log_dir>/rounds_<first>.pt.trace.json`` (``trace_path``).

    A profiler failure never takes down a training run: the exception is
    kept on ``error`` and capture stops.  Callers that rely on the trace
    check ``error is None``.  ``device`` is the run's device (None is the
    card); CUDA activities are recorded only there.
    """

    def __init__(self, rounds: int, log_dir: str, device: Any = None):
        self.rounds = int(rounds)
        self.log_dir = str(log_dir)
        self.device = resolve_device(device)
        self.error: BaseException | None = None
        self.trace_path: str | None = None
        self._profile: Any = None
        self._first = 0
        self._seen = 0

    def round_start(self, round_index: int) -> None:
        if (self.error is not None or self.rounds <= 0 or self._profile is not None
                or self._seen >= self.rounds):
            return
        try:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities)
            prof.start()
            self._profile = prof
            self._first = int(round_index)
        except Exception as exc:
            self.error = exc

    def round_end(self, round_index: int) -> None:
        if self._profile is None:
            return
        self._seen += 1
        if self._seen >= self.rounds:
            self.stop()

    def stop(self) -> None:
        prof, self._profile = self._profile, None
        if prof is None:
            return
        try:
            prof.stop()
            os.makedirs(self.log_dir, exist_ok=True)
            path = os.path.join(self.log_dir, f"rounds_{self._first}.pt.trace.json")
            prof.export_chrome_trace(path)
            self.trace_path = path
        except Exception as exc:
            self.error = exc


# One process-wide listener on the kernel backend's library events fans out
# to the live watchers (the reference's jax.monitoring listener list).
_ACTIVE_WATCHERS: list["CompileWatcher"] = []
_LISTENER_STATE = {"installed": False}


def _install_listener() -> None:
    if _LISTENER_STATE["installed"]:
        return

    def on_event(seconds: float) -> None:
        for watcher in _ACTIVE_WATCHERS:
            watcher.compiles += 1
            watcher.compile_time_s += seconds

    backend.add_library_listener(on_event)
    _LISTENER_STATE["installed"] = True


class CompileWatcher:
    """Count kernel-library events and their seconds while active; feed a
    registry.

    Used as a context manager around a run's round loop; ``poll`` after
    each round folds deltas into ``jit.compiles`` / ``jit.compile_time_s``
    counters and sets the ``jit.round_compiles`` gauge, so a steady-state
    round that builds or loads a library shows up as a nonzero gauge.
    """

    def __init__(self, metrics: MetricsRegistry | None):
        self.metrics = metrics
        self.compiles = 0
        self.compile_time_s = 0.0
        self._polled_compiles = 0
        self._polled_time_s = 0.0
        self.available = False

    def __enter__(self) -> "CompileWatcher":
        _install_listener()
        self.available = True
        _ACTIVE_WATCHERS.append(self)
        return self

    def __exit__(self, *exc_info: object) -> None:
        if self in _ACTIVE_WATCHERS:
            _ACTIVE_WATCHERS.remove(self)

    def poll(self) -> int:
        """Fold deltas since the last poll into the registry; return delta."""
        delta = self.compiles - self._polled_compiles
        delta_t = self.compile_time_s - self._polled_time_s
        self._polled_compiles = self.compiles
        self._polled_time_s = self.compile_time_s
        if self.metrics is not None:
            if delta:
                self.metrics.counter("jit.compiles").inc(delta)
            if delta_t > 0:
                self.metrics.counter("jit.compile_time_s").inc(delta_t)
            self.metrics.gauge("jit.round_compiles").set(delta)
        return delta
