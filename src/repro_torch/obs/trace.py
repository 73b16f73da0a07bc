"""Span tracer with a bounded ring and a Chrome/Perfetto exporter.

A copy of the JAX package's ``obs/trace.py`` (stdlib only): the same event
fields, tracks, pids and flow ids, so a trace of the port and one of the
reference share one schema and one report.

The tracer records three flavours of event into a fixed-capacity deque:

- **complete spans** — a name, a start time, a duration, and a track.
  Host-clock spans (``clock="host"``) are measured with
  ``time.perf_counter`` relative to the tracer's birth; virtual-clock
  spans (``clock="virtual"``) carry the discrete-event scheduler's
  simulated seconds so straggler latencies render on their own timeline.
- **instants** — zero-duration markers (flush points, pool uploads).
- **flows** — ``s``/``f`` arrow pairs linking a dispatch on the server
  track to the task it spawned on a per-client track.

``export_chrome`` writes the ring in Chrome trace-event JSON, loadable in
Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``.  Host and
virtual clocks export as two separate processes so both timelines are
visible side by side; async tasks land on per-client tracks with flow
arrows from their dispatch, which makes straggler and dropout schedules
visually inspectable.

The default tracer everywhere is :data:`NULL_TRACER`, whose methods are
no-ops and whose ``span`` context manager is a shared singleton — the
instrumented-off overhead is a handful of attribute lookups per round.
"""

from __future__ import annotations

import dataclasses
import json
import time
from collections import deque
from typing import Any, Callable, Iterable

HOST_CLOCK = "host"
VIRTUAL_CLOCK = "virtual"

# Chrome trace-event phase codes used by the exporter.
_PH_COMPLETE = "X"
_PH_INSTANT = "i"
_PH_FLOW_START = "s"
_PH_FLOW_END = "f"
_PH_METADATA = "M"

# Stable pids for the two clock domains in the exported trace.
_PID_BY_CLOCK = {HOST_CLOCK: 1, VIRTUAL_CLOCK: 2}


@dataclasses.dataclass(frozen=True)
class SpanEvent:
    """One ring entry: a complete span, an instant, or a flow endpoint."""

    name: str
    phase: str
    ts: float
    dur: float
    track: str
    clock: str
    args: dict[str, Any] | None = None
    flow_id: int | None = None


class _SpanContext:
    """Context manager that records a host-clock complete span on exit."""

    __slots__ = ("_tracer", "_name", "_track", "_args", "_start")

    def __init__(self, tracer: "Tracer", name: str, track: str, args: dict[str, Any] | None):
        self._tracer = tracer
        self._name = name
        self._track = track
        self._args = args
        self._start = 0.0

    def __enter__(self) -> "_SpanContext":
        self._start = self._tracer.now()
        return self

    def __exit__(self, *exc_info: object) -> None:
        tracer = self._tracer
        tracer.complete(
            self._name,
            start=self._start,
            dur=tracer.now() - self._start,
            track=self._track,
            **(self._args or {}),
        )


class _NullContext:
    """Shared do-nothing context manager returned by the null tracer."""

    __slots__ = ()

    def __enter__(self) -> "_NullContext":
        return self

    def __exit__(self, *exc_info: object) -> None:
        return None


_NULL_CONTEXT = _NullContext()


class Tracer:
    """Bounded-ring span recorder.

    Appends are lock-free (``deque.append`` is atomic) so the staging
    producer thread may record spans concurrently with the round program.
    When the ring is full the oldest events are dropped and ``dropped``
    counts them (best effort under concurrency).
    """

    enabled = True

    def __init__(self, capacity: int = 65536):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._events: deque[SpanEvent] = deque(maxlen=self.capacity)
        self._birth = time.perf_counter()
        self.dropped = 0
        self._next_flow_id = 0

    # ---- clock ----------------------------------------------------------
    def now(self) -> float:
        """Seconds since tracer creation on the host clock."""
        return time.perf_counter() - self._birth

    def host_ts(self, perf_counter_value: float) -> float:
        """Convert a raw ``time.perf_counter()`` reading to tracer time."""
        return perf_counter_value - self._birth

    # ---- recording ------------------------------------------------------
    def _push(self, event: SpanEvent) -> None:
        if len(self._events) == self.capacity:
            self.dropped += 1
        self._events.append(event)

    def span(self, name: str, track: str = "server", **args: Any) -> _SpanContext:
        """Context manager recording a host-clock span around the body."""
        return _SpanContext(self, name, track, args or None)

    def wrap(self, name: str, track: str = "server") -> Callable:
        """Decorator form of :meth:`span`."""

        def decorate(fn: Callable) -> Callable:
            def wrapped(*a: Any, **kw: Any) -> Any:
                with self.span(name, track=track):
                    return fn(*a, **kw)

            wrapped.__name__ = getattr(fn, "__name__", name)
            wrapped.__doc__ = fn.__doc__
            return wrapped

        return decorate

    def complete(
        self,
        name: str,
        *,
        start: float,
        dur: float,
        track: str = "server",
        clock: str = HOST_CLOCK,
        **args: Any,
    ) -> None:
        """Record a complete span with explicit start/duration."""
        self._push(SpanEvent(name, _PH_COMPLETE, float(start), float(dur), track, clock, args or None))

    def instant(
        self,
        name: str,
        *,
        ts: float | None = None,
        track: str = "server",
        clock: str = HOST_CLOCK,
        **args: Any,
    ) -> None:
        """Record a zero-duration marker."""
        when = self.now() if ts is None else float(ts)
        self._push(SpanEvent(name, _PH_INSTANT, when, 0.0, track, clock, args or None))

    def new_flow_id(self) -> int:
        fid = self._next_flow_id
        self._next_flow_id = fid + 1
        return fid

    def flow_start(
        self, name: str, flow_id: int, *, ts: float, track: str = "server", clock: str = VIRTUAL_CLOCK
    ) -> None:
        self._push(SpanEvent(name, _PH_FLOW_START, float(ts), 0.0, track, clock, None, flow_id))

    def flow_end(
        self, name: str, flow_id: int, *, ts: float, track: str, clock: str = VIRTUAL_CLOCK
    ) -> None:
        self._push(SpanEvent(name, _PH_FLOW_END, float(ts), 0.0, track, clock, None, flow_id))

    # ---- inspection -----------------------------------------------------
    def events(self) -> list[SpanEvent]:
        return list(self._events)

    def spans(self, name: str | None = None, clock: str | None = None) -> list[SpanEvent]:
        """Complete spans, optionally filtered by name and clock."""
        out = []
        for ev in self._events:
            if ev.phase != _PH_COMPLETE:
                continue
            if name is not None and ev.name != name:
                continue
            if clock is not None and ev.clock != clock:
                continue
            out.append(ev)
        return out

    def summary(self) -> dict[str, dict[str, dict[str, float]]]:
        """Per-clock, per-name span counts and total seconds."""
        out: dict[str, dict[str, dict[str, float]]] = {}
        for ev in self._events:
            if ev.phase != _PH_COMPLETE:
                continue
            per_clock = out.setdefault(ev.clock, {})
            row = per_clock.setdefault(ev.name, {"count": 0, "total_s": 0.0})
            row["count"] += 1
            row["total_s"] += ev.dur
        return out

    # ---- export ---------------------------------------------------------
    def to_chrome(self) -> dict[str, Any]:
        """Render the ring as a Chrome trace-event document."""
        return events_to_chrome(self._events)

    def export_chrome(self, path: str) -> str:
        doc = self.to_chrome()
        with open(path, "w") as fh:
            json.dump(doc, fh)
            fh.write("\n")
        return path


class NullTracer(Tracer):
    """Do-nothing tracer: the default on every instrumented hot path."""

    enabled = False

    def __init__(self) -> None:
        super().__init__(capacity=1)

    def span(self, name: str, track: str = "server", **args: Any) -> _NullContext:  # type: ignore[override]
        return _NULL_CONTEXT

    def complete(self, name: str, **kw: Any) -> None:  # type: ignore[override]
        return None

    def instant(self, name: str, **kw: Any) -> None:  # type: ignore[override]
        return None

    def flow_start(self, name: str, flow_id: int, **kw: Any) -> None:  # type: ignore[override]
        return None

    def flow_end(self, name: str, flow_id: int, **kw: Any) -> None:  # type: ignore[override]
        return None

    def wrap(self, name: str, track: str = "server") -> Callable:  # type: ignore[override]
        def decorate(fn: Callable) -> Callable:
            return fn

        return decorate


NULL_TRACER = NullTracer()


def resolve_tracer(tracer: Tracer | None) -> Tracer:
    """``None`` means "not instrumented": substitute the shared null tracer."""
    return NULL_TRACER if tracer is None else tracer


def events_to_chrome(events: Iterable[SpanEvent]) -> dict[str, Any]:
    """Convert span events to the Chrome trace-event JSON document.

    Host-clock events export under pid 1 ("host clock"), virtual-clock
    events under pid 2 ("virtual clock"); each distinct track becomes a
    named thread so Perfetto renders per-client rows.  Timestamps are
    microseconds as the format requires.
    """
    trace_events: list[dict[str, Any]] = []
    tids: dict[tuple[int, str], int] = {}

    def tid_for(pid: int, track: str) -> int:
        key = (pid, track)
        if key not in tids:
            tid = len([k for k in tids if k[0] == pid]) + 1
            tids[key] = tid
            trace_events.append(
                {
                    "name": "thread_name",
                    "ph": _PH_METADATA,
                    "pid": pid,
                    "tid": tid,
                    "args": {"name": track},
                }
            )
        return tids[key]

    for pid, label in ((1, "host clock"), (2, "virtual clock")):
        trace_events.append(
            {"name": "process_name", "ph": _PH_METADATA, "pid": pid, "tid": 0, "args": {"name": label}}
        )

    for ev in events:
        pid = _PID_BY_CLOCK.get(ev.clock, 1)
        entry: dict[str, Any] = {
            "name": ev.name,
            "ph": ev.phase,
            "pid": pid,
            "tid": tid_for(pid, ev.track),
            "ts": ev.ts * 1e6,
            "cat": ev.clock,
        }
        if ev.phase == _PH_COMPLETE:
            entry["dur"] = ev.dur * 1e6
        if ev.phase == _PH_INSTANT:
            entry["s"] = "t"
        if ev.flow_id is not None:
            entry["id"] = ev.flow_id
            if ev.phase == _PH_FLOW_END:
                entry["bp"] = "e"
        if ev.args:
            entry["args"] = {k: _json_safe(v) for k, v in ev.args.items()}
        trace_events.append(entry)

    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}


def _json_safe(value: Any) -> Any:
    """Coerce numpy scalars/arrays in span args to plain JSON types."""
    if isinstance(value, (str, bool, int, float)) or value is None:
        return value
    if hasattr(value, "item") and not hasattr(value, "__len__"):
        return value.item()
    if isinstance(value, (list, tuple)) or hasattr(value, "tolist"):
        seq = value.tolist() if hasattr(value, "tolist") else list(value)
        return [_json_safe(v) for v in seq]
    return str(value)
