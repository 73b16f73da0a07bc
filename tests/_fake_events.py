"""CUDA timing events on a made-up device clock, for the tracer's device
spans on the CPU (``obs/trace.py``'s ``_timing_event``, ``_synchronize``,
``_stream_key`` and ``_stream_object`` patched to these: one stream).

The device clock reads ``now`` seconds; an event's ``record`` stamps it;
work up to ``done`` seconds has finished, so ``query`` is true for events
stamped at or before it, and ``synchronize`` (an event's or the device's)
moves ``done`` up to the stamp or to ``now``.  ``elapsed_time`` is in ms,
as CUDA's."""

from __future__ import annotations


class FakeDevice:
    def __init__(self, now: float = 100.0):
        self.now = now
        self.done = now
        self.created = 0
        self.synchronizes = 0

    def event(self) -> "FakeEvent":
        self.created += 1
        return FakeEvent(self)

    def synchronize(self) -> None:
        self.synchronizes += 1
        self.done = self.now

    def install(self, monkeypatch, trace_module) -> "FakeDevice":
        monkeypatch.setattr(trace_module, "_timing_event", self.event)
        monkeypatch.setattr(trace_module, "_synchronize", self.synchronize)
        monkeypatch.setattr(trace_module, "_stream_key", lambda: (0, 0))
        monkeypatch.setattr(trace_module, "_stream_object", lambda: "stream")
        return self


class FakeEvent:
    def __init__(self, device: FakeDevice):
        self.device = device
        self.t: float | None = None

    def record(self, stream) -> None:
        assert stream == "stream"
        self.t = self.device.now

    def query(self) -> bool:
        return self.t is not None and self.t <= self.device.done

    def synchronize(self) -> None:
        self.device.done = max(self.device.done, self.t)

    def elapsed_time(self, end: "FakeEvent") -> float:
        if not (self.query() and end.query()):
            raise RuntimeError("elapsed_time of an event that has not completed")
        return (end.t - self.t) * 1e3
