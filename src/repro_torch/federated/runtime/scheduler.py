"""Deterministic virtual-clock discrete-event scheduler.

The port's copy of the JAX package's ``federated/runtime/scheduler.py``:
numpy and ``heapq`` only, the same seeded stream, so the virtual clock,
the event order and every latency and dropout draw equal the reference's,
and so do the per-event instant markers of ``tracer=``.

The async federation runtime replaces the synchronous round barrier with a
simulated timeline: client tasks, completions, and aggregator flushes are
*events* on a virtual clock, and the whole simulation is a single-threaded
walk over an event heap.  Two properties make the walk a reliable research
instrument:

* **Determinism** — the heap is keyed on ``(virtual_time, seq)`` where
  ``seq`` is the monotone insertion counter, so simultaneous events resolve
  in the order they were scheduled, never by payload identity or hash
  order.  Two runs that schedule the same events replay bit-identically.
* **Seeding** — the scheduler owns the run's stochastic stream
  (``self.rng``, derived from the seed): latency and dropout models draw
  from it at well-defined points (task dispatch), so the event *timeline*
  is a pure function of the seed even though the models are random.

The scheduler knows nothing about federated learning; it stores opaque
``(kind, payload)`` pairs and advances ``now`` as events pop.  The policy
of what each kind means lives in
:mod:`repro.federated.runtime.async_federation`.

Because the whole timeline is ``(clock, seq counter, heap, one seeded
stream)``, the scheduler is also trivially *checkpointable*:
``state_dict`` captures clock/counters/stream and ``restore`` reinstates
them together with a caller-provided pending-event list (original seqs
preserved), which is how a preempted async federation resumes with an
exact virtual clock — same ``now``, same event order, same future draws.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Any

import numpy as np

from repro_torch.obs.trace import resolve_tracer


@dataclasses.dataclass(frozen=True)
class Event:
    """One scheduled occurrence on the virtual timeline.

    Ordering is fully determined by ``(time, seq)`` — ``seq`` is unique per
    scheduler, so comparison never falls through to ``kind``/``payload``.
    """

    time: float
    seq: int
    kind: str
    payload: Any = None

    @property
    def key(self) -> tuple[float, int]:
        return (self.time, self.seq)


class VirtualScheduler:
    """Event heap + virtual clock + the run's seeded stochastic stream.

    ``schedule`` may only target the present or future (an event in the
    past would mean the simulation's causality is broken — fail loudly).
    ``pop`` returns events in ``(time, seq)`` order and advances ``now``
    to the popped event's time; virtual time therefore never runs
    backwards.
    """

    def __init__(self, seed: int = 0, tracer: Any = None) -> None:
        self._heap: list[tuple[float, int, Event]] = []
        self._next_seq = 0
        self.now = 0.0
        self.processed = 0
        # The run's latency/dropout stream, independent of the batch
        # scheduler's and the recruitment generator's streams.
        self.rng = np.random.default_rng([int(seed), 0x5EED])
        # Observability: each popped event becomes an instant marker on the
        # virtual-clock "scheduler" track (None = the shared no-op tracer).
        self.tracer = resolve_tracer(tracer)

    def __len__(self) -> int:
        return len(self._heap)

    @property
    def empty(self) -> bool:
        return not self._heap

    def schedule(self, at: float, kind: str, payload: Any = None) -> Event:
        """Insert an event at virtual time ``at`` (>= ``now``)."""
        at = float(at)
        if not np.isfinite(at):
            raise ValueError(f"event time must be finite, got {at}")
        if at < self.now:
            raise ValueError(
                f"cannot schedule {kind!r} at t={at} in the past (now={self.now})"
            )
        event = Event(time=at, seq=self._next_seq, kind=kind, payload=payload)
        self._next_seq += 1
        heapq.heappush(self._heap, (event.time, event.seq, event))
        return event

    def after(self, delay: float, kind: str, payload: Any = None) -> Event:
        """Insert an event ``delay`` virtual seconds from now."""
        if delay < 0:
            raise ValueError(f"delay must be >= 0, got {delay}")
        return self.schedule(self.now + float(delay), kind, payload)

    def peek_time(self) -> float | None:
        """Virtual time of the next event, or None when the heap is empty."""
        return self._heap[0][0] if self._heap else None

    def pop(self) -> Event:
        """Remove and return the earliest event, advancing the clock to it."""
        if not self._heap:
            raise IndexError("pop from an empty scheduler")
        _, _, event = heapq.heappop(self._heap)
        self.now = event.time
        self.processed += 1
        self.tracer.instant(
            event.kind, ts=event.time, track="scheduler", clock="virtual",
            seq=event.seq,
        )
        return event

    def pending(self) -> list[Event]:
        """The not-yet-popped events in ``(time, seq)`` order (a copy)."""
        return [event for _, _, event in sorted(self._heap, key=lambda e: e[:2])]

    def state_dict(self) -> dict:
        """Clock, counters, and stream state — JSON-serializable.

        Pending events are *not* included (their payloads are arbitrary
        objects); callers snapshot them via :meth:`pending` and hand them
        back to :meth:`restore`.
        """
        return {
            "now": self.now,
            "next_seq": self._next_seq,
            "processed": self.processed,
            "rng_state": self.rng.bit_generator.state,
        }

    def restore(self, state: dict, events: list[Event]) -> None:
        """Reinstate a snapshot: clock, counters, stream, pending events.

        Events keep their original ``seq`` values, so replayed simultaneity
        resolves exactly as it would have in the uninterrupted run.
        """
        self.now = float(state["now"])
        self._next_seq = int(state["next_seq"])
        self.processed = int(state["processed"])
        self.rng.bit_generator.state = state["rng_state"]
        self._heap = []
        for event in events:
            if event.time < self.now:
                raise ValueError(
                    f"restored event {event.kind!r} at t={event.time} is in "
                    f"the past (now={self.now})"
                )
            heapq.heappush(self._heap, (event.time, event.seq, event))
