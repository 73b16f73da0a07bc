"""Double-buffered staging: build and upload chunk k+1 while chunk k trains.

The port of the JAX package's ``federated/staging.py``, in plain Python
``threading``.  ``CohortTrainer`` consumes a round chunk by chunk; each
chunk needs host work (drawing the shuffle permutations into an index plan)
and a host-to-device copy before its steps can run.  Done inline, that work
serializes with the steps; here one producer thread stays one chunk ahead
of the consumer.

One producer thread, processing chunks strictly in order, is load-bearing:
plan building consumes the shared numpy generator, and the parity of the
engines and staging modes requires that stream to be drawn in exactly the
inline order.  ``StagingPipeline`` never reorders work; it only overlaps it
with the device.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Any, Callable, Iterator, Sequence

from repro_torch.obs.trace import resolve_tracer

_LOG = logging.getLogger(__name__)


class StagingPipeline:
    """Runs ``stage_fn`` over ``items`` one chunk ahead of iteration.

    ``stage_fn(item)`` is called on a background thread, strictly in item
    order, and results are handed out in the same order by ``__iter__``.
    ``depth`` bounds the staged-but-unconsumed run-ahead (depth 1: while
    the consumer works on chunk k, only chunk k+1 is staged).  An exception
    raised by ``stage_fn`` surfaces on the consuming thread at the position
    the failed item would have occupied.

    ``prefetched`` counts chunks that were already staged when the consumer
    asked for them (``last_round_stats["plans_prefetched"]``).

    ``tracer`` (a ``repro_torch.obs`` tracer; None = no-op) records a
    ``prefetch_wait`` span on the consumer whenever it blocks on a chunk
    that is not staged yet: the pipeline's stall time, beside the
    producer's ``stage`` spans in an exported trace.
    """

    def __init__(
        self,
        stage_fn: Callable[[Any], Any],
        items: Sequence[Any],
        *,
        depth: int = 1,
        join_timeout: float = 5.0,
        tracer: Any = None,
    ) -> None:
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._stage_fn = stage_fn
        self._tracer = resolve_tracer(tracer)
        self._items = list(items)
        self._join_timeout = join_timeout
        self._pending_exc: BaseException | None = None
        self.leaked = False
        self._queue: queue.Queue = queue.Queue()
        # The run-ahead bound: the producer takes a slot before staging an
        # item and the consumer returns it when the item is handed out, so at
        # most ``depth`` staged-but-unconsumed chunks exist at any time.
        self._slots = threading.Semaphore(depth)
        self._stop = threading.Event()
        self.prefetched = 0
        self._thread = threading.Thread(
            target=self._produce, name="cohort-staging", daemon=True
        )
        self._thread.start()

    def _produce(self) -> None:
        try:
            for item in self._items:
                if not self._acquire_slot():
                    return  # close() abandoned the pipeline mid-round
                self._queue.put((self._stage_fn(item), None))
        except BaseException as exc:  # handed to the consumer thread
            self._queue.put((None, exc))

    def _acquire_slot(self) -> bool:
        # A bounded wait that gives up once close() sets the stop flag, so the
        # producer can never hang on an abandoned pipeline.
        while not self._stop.is_set():
            if self._slots.acquire(timeout=0.1):
                return True
        return False

    def __iter__(self) -> Iterator[Any]:
        for _ in range(len(self._items)):
            try:
                staged, exc = self._queue.get_nowait()
                hit = True
            except queue.Empty:
                with self._tracer.span("prefetch_wait", track="staging"):
                    staged, exc = self._queue.get()
                hit = False
            self._slots.release()
            if exc is not None:
                # Delivered now: close() must not raise it a second time.
                self.close(raise_pending=False)
                raise exc
            if hit:
                self.prefetched += 1
            yield staged
        self.close()

    def close(self, raise_pending: bool = True) -> None:
        """Stop the producer and drain the queue; idempotent.

        A ``stage_fn`` exception the consumer never collected is re-raised
        here rather than dropped; pass ``raise_pending=False`` from paths
        that are already propagating another error.  A producer that does
        not join within ``join_timeout`` is logged and flagged on
        ``leaked``.
        """
        self._stop.set()
        while True:
            try:
                _, exc = self._queue.get_nowait()
            except queue.Empty:
                break
            if exc is not None and self._pending_exc is None:
                self._pending_exc = exc
        self._thread.join(timeout=self._join_timeout)
        if self._thread.is_alive():
            if not self.leaked:
                _LOG.warning(
                    "staging producer thread failed to join within %.1fs; "
                    "daemon thread leaked (stage_fn stuck?)",
                    self._join_timeout,
                )
            self.leaked = True
        if raise_pending and self._pending_exc is not None:
            exc, self._pending_exc = self._pending_exc, None
            raise exc
