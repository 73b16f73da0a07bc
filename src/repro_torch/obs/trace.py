"""Span tracer with a bounded ring and a Chrome/Perfetto exporter.

A copy of the JAX package's ``obs/trace.py`` (stdlib only; torch is
imported only to time device work): the same event fields, tracks, pids and
flow ids, so a trace of the port and one of the reference share one schema
and one report.

The tracer records three flavours of event into a fixed-capacity deque:

- **complete spans** — a name, a start time, a duration, and a track.
  Host-clock spans (``clock="host"``) are measured with
  ``time.perf_counter`` relative to the tracer's birth; virtual-clock
  spans (``clock="virtual"``) carry the discrete-event scheduler's
  simulated seconds so straggler latencies render on their own timeline;
  device-clock spans (``clock="device"``, the port's own) time work on the
  card between two CUDA timing events (:meth:`Tracer.device_start`,
  :meth:`Tracer.device_end`), put on the host clock's time line.
- **instants** — zero-duration markers (flush points, pool uploads).
- **flows** — ``s``/``f`` arrow pairs linking a dispatch on the server
  track to the task it spawned on a per-client track.

``export_chrome`` writes the ring in Chrome trace-event JSON, loadable in
Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``.  Host and
virtual clocks export as two separate processes so both timelines are
visible side by side; async tasks land on per-client tracks with flow
arrows from their dispatch, which makes straggler and dropout schedules
visually inspectable.

Device clock.  A pair of timing events recorded on the current stream
around device work (a replayed graph, ``capture.py``) is resolved into a
span once its end event has completed: at a later :meth:`Tracer.device_end`
that finds it done (``query``; nothing waits), or when the ring is read
(``events``, ``spans``, ``summary``, the export), which waits for the
pending pairs.  The first device span anchors the clock: a synchronize, a
timing event recorded right after it, and the host time beside that event.
A span then starts at the anchor's host time plus the device time from the
anchor to its start event, and lasts the device time between its events.
Events come from a pool of resolved ones, so a steady loop creates none.

One clock with ``torch.profiler``.  The tracer keeps ``time.time_ns()`` read
at its birth beside its ``perf_counter`` origin.  A trace that holds device
spans exports it as ``baseTimeNanoseconds``, the field of the profiler's
own Chrome export, so ``baseTimeNanoseconds + ts * 1000`` is the wall-clock
nanosecond of an event in either document, and the device spans export as
a third process, "device (CUDA events)".  A trace without device spans
exports the reference's document exactly.

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
DEVICE_CLOCK = "device"

# Chrome trace-event phase codes used by the exporter.
_PH_COMPLETE = "X"
_PH_INSTANT = "i"
_PH_FLOW_START = "s"
_PH_FLOW_END = "f"
_PH_METADATA = "M"

# Stable pids for the clock domains in the exported trace.
_PID_BY_CLOCK = {HOST_CLOCK: 1, VIRTUAL_CLOCK: 2, DEVICE_CLOCK: 3}
_PROCESS_NAMES = ((1, "host clock"), (2, "virtual clock"))
_DEVICE_PROCESS = (3, "device (CUDA events)")


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
        self._birth_ns = time.time_ns()
        self.dropped = 0
        self._next_flow_id = 0
        self._device: _DeviceTimes | None = None

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

    def device_start(self) -> Any:
        """A timing event recorded now on the current CUDA stream: the start
        of a device span that :meth:`device_end` closes.  The first call
        anchors the device clock (one synchronize)."""
        if self._device is None:
            self._device = _DeviceTimes(self)
        return self._device.start()

    def device_end(self, start: Any, name: str, *, track: str = "device", **args: Any) -> None:
        """Close the device span opened by ``start`` with a timing event
        recorded now, and resolve the pairs whose work has finished."""
        self._device.close(start, name, track, args or None)

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
    def _settle(self) -> None:
        """Wait for the pending device spans and record them."""
        if self._device is not None:
            self._device.resolve(wait=True)

    def events(self) -> list[SpanEvent]:
        self._settle()
        return list(self._events)

    def spans(self, name: str | None = None, clock: str | None = None) -> list[SpanEvent]:
        """Complete spans, optionally filtered by name and clock."""
        self._settle()
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
        self._settle()
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
        """Render the ring as a Chrome trace-event document; with device
        spans, also the tracer's birth as ``baseTimeNanoseconds``."""
        self._settle()
        timed = any(ev.clock == DEVICE_CLOCK for ev in self._events)
        return events_to_chrome(self._events, base_time_ns=self._birth_ns if timed else None)

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

    def device_start(self) -> None:  # type: ignore[override]
        return None

    def device_end(self, start: Any, name: str, **kw: Any) -> None:  # type: ignore[override]
        return None


NULL_TRACER = NullTracer()


def _timing_event() -> Any:
    import torch

    return torch.cuda.Event(enable_timing=True)


def _synchronize() -> None:
    import torch

    torch.cuda.synchronize()


def _stream_key() -> tuple[int, int]:
    """The current device and the handle of its current stream."""
    import torch

    device = torch.cuda.current_device()
    return device, torch._C._cuda_getCurrentRawStream(device)


def _stream_object() -> Any:
    import torch

    return torch.cuda.current_stream()


class _DeviceTimes:
    """A tracer's device clock: its anchor, the pairs of timing events not
    yet resolved (in the order they were recorded, on one stream), and the
    pool of resolved events.  A pair's end is recorded on its start's
    stream.  Used from the thread that launches the work.

    The stream objects are kept by handle: ``torch.cuda.current_stream()``
    took ~8 µs of host time a call on an H100's host, the handle ~0.2 µs,
    and a pair's start is recorded before the launch of the work it times
    (mamba2-130m's decode loop at B=8 ran 2.1% slower with the tracer on
    through ``current_stream()``, 0.8% through the handle; ``PERF.md``)."""

    def __init__(self, tracer: Tracer):
        self.tracer = tracer
        self.free: list[Any] = []
        self.pending: deque[tuple[Any, Any, str, str, dict[str, Any] | None]] = deque()
        self.streams: dict[tuple[int, int], Any] = {}
        _synchronize()
        self.anchor = self.record(self.stream())
        self.anchor_ts = tracer.now()

    def stream(self) -> Any:
        key = _stream_key()
        stream = self.streams.get(key)
        if stream is None:
            stream = self.streams[key] = _stream_object()
        return stream

    def record(self, stream: Any) -> Any:
        event = self.free.pop() if self.free else _timing_event()
        event.record(stream)
        return event

    def start(self) -> tuple[Any, Any]:
        stream = self.stream()
        return self.record(stream), stream

    def close(self, start: tuple[Any, Any], name: str, track: str,
              args: dict[str, Any] | None) -> None:
        event, stream = start
        self.pending.append((event, self.record(stream), name, track, args))
        self.resolve(wait=False)

    def resolve(self, wait: bool) -> None:
        while self.pending:
            start, end, name, track, args = self.pending[0]
            if wait:
                end.synchronize()
            elif not end.query():
                return
            self.pending.popleft()
            ts = self.anchor_ts + self.anchor.elapsed_time(start) * 1e-3
            self.tracer._push(SpanEvent(name, _PH_COMPLETE, ts, start.elapsed_time(end) * 1e-3,
                                        track, DEVICE_CLOCK, args))
            self.free += (start, end)


def resolve_tracer(tracer: Tracer | None) -> Tracer:
    """``None`` means "not instrumented": substitute the shared null tracer."""
    return NULL_TRACER if tracer is None else tracer


def events_to_chrome(events: Iterable[SpanEvent],
                     base_time_ns: int | None = None) -> dict[str, Any]:
    """Convert span events to the Chrome trace-event JSON document.

    Host-clock events export under pid 1 ("host clock"), virtual-clock
    events under pid 2 ("virtual clock"), device-clock events, where there
    are any, under pid 3 ("device (CUDA events)"); each distinct track
    becomes a named thread so Perfetto renders per-client rows.  Timestamps
    are microseconds as the format requires.  ``base_time_ns``, when given,
    is written as ``baseTimeNanoseconds``: the wall-clock time of ``ts`` 0.
    """
    events = list(events)
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

    processes = _PROCESS_NAMES
    if any(ev.clock == DEVICE_CLOCK for ev in events):
        processes += (_DEVICE_PROCESS,)
    for pid, label in processes:
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

    doc: dict[str, Any] = {"traceEvents": trace_events, "displayTimeUnit": "ms"}
    if base_time_ns is not None:
        doc["baseTimeNanoseconds"] = int(base_time_ns)
    return doc


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
