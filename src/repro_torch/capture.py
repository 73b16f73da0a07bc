"""Steps captured as CUDA graphs and replayed: the port of ``jax.jit``.

The reference compiles every training step into one program (the local step
``federated/client.py``, the central step ``federated/central.py``, the
cohort round ``federated/cohort.py``, the LM train and decode steps
``launch/steps.py``, the paper's predict function ``experiments/paper.py``).
The port's steps are eager PyTorch, a few hundred to a few thousand
host-issued launches each; on the card a step is captured into a
``torch.cuda.CUDAGraph`` the first time its key is met and replayed after
that.  A replay gives the eager step's bits.

Routing follows the port's rule: a step on the card is captured (unless
:func:`disable_capture` is active, the counterpart of ``jax.disable_jit`` and
the only way to run the eager step on the card), a step on the CPU runs
eagerly.  A capture that fails raises; nothing falls back to the eager step.

What a graph bakes in is its key (:class:`GraphCache`): the shapes and
dtypes of the params and the batch, the number of clients, DP on or off,
the staging kind and the data pointers of every tensor it reads in place
(the resident cohort's arrays).  Everything else a step reads goes through
static buffers that the trainer allocates before capture and fills before
each replay: the batch or the index plan, the AdamW coefficients, the
step's validity mask.  Params and AdamW moments live in static buffers too
and are updated in place by the graph.

Generators.  A graph cannot take a generator object as an input, so each
graph owns slot generators (one a client), registered with it through
``CUDAGraph.register_generator_state``.  Before a client's first step the
host moves its slot to the client generator's position (seed and Philox
offset; :func:`position`, :func:`set_position`); a replay then draws what the
eager step draws and advances the slot by the step's whole increment.  The
cohort step has one graph a width over the same slots, and a graph of
width w registers only slots ``[0, w)``: every client inside the width
draws on every replay, the slots past it are not touched.  A client inside
the width whose step is not valid has its slot moved back after the
replay, so it draws nothing, as in the eager step.  At the end of a chunk
each client generator takes its slot's position.

Warm-up.  Capture needs the body run once eagerly first.  The trainers of
the federated path and the predict function run it on their freshly
allocated static buffers (scratch), and put the slots and counters back.
A step whose static buffers are the caller's own (the LM train step's
params and moments, the decode step's donated cache) cannot run on scratch
without a second copy of them, and cannot run twice on them: the warm-up
is then the caller's first step itself (``warmup_is_step``), whose effects
and launches stay, and whose output is the first call's result
(:attr:`StepGraph.first`); it runs on the caller's stream, as the eager
step would, so it reuses the memory the caller's stream holds cached.  The
capture records without running, so the first replay is the second step.

Memory.  All graphs of one cache share one pool
(``torch.cuda.graph_pool_handle``).  That is safe in any replay order
because (1) every output a later step reads (params, moments) is written in
place into a buffer allocated before capture, outside the pool, and (2) the
one output left in the pool, the step's loss, is cloned out by
:meth:`StepGraph.replay` before any other graph can run.

Bookkeeping.  The kernel wrappers count their launches where they launch,
which in a graph is once, at capture.  A capture records each counter's
delta over the captured step and puts the counters back as they were before
its warm-up; every replay then adds the deltas, so a captured run counts
what the eager run counts.  A capture is reported as the port's compile
(``kernels/backend.py::record_compile``), which ``obs/profile.py::
CompileWatcher`` turns into ``jit.compiles`` and ``jit.compile_time_s``.

Timing.  A cache on the card takes its owner's tracer (``obs/trace.py``).
When that tracer is enabled, :meth:`StepGraph.replay` records a CUDA timing
event on the current stream before the replay and another after it, and
the tracer turns the pair into a span of the cache's ``name`` on its
``device`` clock, with the replay's ``args``; no synchronize is added.
With the null tracer a replay checks one attribute and records nothing.

On a CPU device (tests only: a CPU trainer runs eagerly) :meth:`GraphCache.
capture` returns a stand-in that reruns the body at each replay, so the
static-buffer step can be held against the eager one bit for bit.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Any, Callable, Hashable, Iterator, Sequence

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.gru_scan import kernel as gru_kernel
from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro_torch.obs.trace import NULL_TRACER, Tracer, resolve_tracer

# The kernel wrappers whose ``launches`` a replay must add.
COUNTED = (
    gru_kernel.gru_scan,
    gru_kernel.gru_scan_bwd,
    ssd_kernel.ssd_chunk_scan,
    ssd_kernel.ssd_chunk_scan_bwd,
)

_capture_off: contextvars.ContextVar[bool] = contextvars.ContextVar("capture_off",
                                                                    default=False)


@contextlib.contextmanager
def disable_capture() -> Iterator[None]:
    """Run the trainers' steps eagerly inside the block, also on the card.

    Nests and restores; it holds for the thread (the context) that enters
    it."""
    token = _capture_off.set(True)
    try:
        yield
    finally:
        _capture_off.reset(token)


def capture_enabled(device: torch.device) -> bool:
    """True where a trainer captures its step: on the card, outside
    :func:`disable_capture`."""
    return device.type == "cuda" and not _capture_off.get()


def launch_counts() -> tuple[int, ...]:
    return tuple(fn.launches for fn in COUNTED)


def set_launch_counts(counts: Sequence[int]) -> None:
    for fn, n in zip(COUNTED, counts):
        fn.launches = n


def position(generator: torch.Generator) -> Any:
    """Where ``generator``'s stream stands: ``(seed, offset)`` on the card,
    the whole state on the CPU."""
    if generator.device.type == "cuda":
        return generator.initial_seed(), generator.get_offset()
    return generator.get_state()


def set_position(generator: torch.Generator, pos: Any) -> None:
    """Move ``generator`` to ``pos``, a :func:`position` of a generator on
    the same device."""
    if generator.device.type == "cuda":
        seed, offset = pos
        generator.manual_seed(seed)
        generator.set_offset(offset)
    else:
        generator.set_state(pos)


class _Rerun:
    """The CPU stand-in of a captured graph: its replay reruns the body."""

    def __init__(self, body: Callable[[], torch.Tensor]):
        self.body = body

    def replay(self) -> torch.Tensor:
        return self.body()


class StepGraph:
    """One captured step: ``replay`` runs it, adds the capture's launch
    deltas to the kernel counters and returns a clone of its loss.  With an
    enabled ``tracer`` each replay is a device span ``name``."""

    def __init__(self, graph: Any, output: torch.Tensor | None, launches: Sequence[int],
                 tracer: Tracer = NULL_TRACER, name: str = "replay"):
        self.graph = graph          # a torch.cuda.CUDAGraph, or anything with replay()
        self.output = output        # the loss the graph writes (in the pool)
        self.launches = tuple(launches)
        self.replays = 0
        self.first = None           # the warm-up's output, when the warm-up was a step
        self.tracer = tracer
        self.name = name

    def replay(self, **args: Any) -> torch.Tensor:
        """Run the step; ``args`` label its device span when timed."""
        if self.tracer.enabled:
            start = self.tracer.device_start()
            out = self.graph.replay()
            self.tracer.device_end(start, self.name, **args)
        else:
            out = self.graph.replay()
        out = self.output if out is None else out
        set_launch_counts([n + d for n, d in zip(launch_counts(), self.launches)])
        self.replays += 1
        return out.clone()


class GraphCache:
    """A trainer's captured steps by key, in one memory pool, with its
    capture and replay counts.  On the card its replays are device spans
    ``name`` of ``tracer`` (the owner's; None is the null tracer)."""

    def __init__(self, device: torch.device, tracer: Tracer | None = None,
                 name: str = "replay"):
        self.device = device
        self.tracer = resolve_tracer(tracer) if device.type == "cuda" else NULL_TRACER
        self.name = name
        self.entries: dict[Hashable, Any] = {}
        self.pool = None
        self.captures = 0
        self.capture_seconds = 0.0
        self.pool_bytes = 0
        self._graphs: list[StepGraph] = []
        # The warm-ups' stream, one a cache: the library's products keep a
        # workspace a stream for the process's life (64 MiB on an H100).
        self._side = None

    @property
    def replays(self) -> int:
        return sum(g.replays for g in self._graphs)

    def lookup(self, key: Hashable, build: Callable[[], Any]) -> Any:
        """The entry of ``key``, built (and captured) by ``build`` when new."""
        entry = self.entries.get(key)
        if entry is None:
            entry = self.entries[key] = build()
        return entry

    def counts(self) -> tuple[int, int, float]:
        return self.captures, self.replays, self.capture_seconds

    def round_stats(self, before: tuple[int, int, float]) -> dict[str, Any]:
        """``last_round_stats``' capture fields since ``before`` (a
        :meth:`counts`): captures, replays, capture seconds, and the pool's
        bytes."""
        captures, replays, seconds = self.counts()
        return {
            "captures": captures - before[0],
            "replays": replays - before[1],
            "capture_seconds": seconds - before[2],
            "graph_pool_bytes": self.pool_bytes,
        }

    def capture(self, body: Callable[[], torch.Tensor],
                slots: Sequence[torch.Generator] = (), *,
                warmup_is_step: bool = False) -> StepGraph:
        """Capture ``body`` (a step over static buffers, returning its loss
        or its output tensor) with ``slots`` registered as its generators.

        ``body`` runs once eagerly first, as capture needs (library loads,
        cuBLAS handles, autograd's state).  By default it must run on
        scratch buffers, as a trainer's freshly allocated static buffers
        are: it runs on the cache's side stream on the card (one for all
        its warm-ups, so they share one workspace), and the slots' positions
        and the launch counters are put back after it, so the warm-up
        consumes nothing.  With ``warmup_is_step`` the warm-up is the
        caller's first step on its real buffers, run on the caller's
        stream: its effects, draws and launch counts stay, and its output is
        kept as the step's ``first``."""
        t0 = time.perf_counter()
        before = launch_counts()
        saved = [position(g) for g in slots]
        if self.device.type == "cuda" and not warmup_is_step:
            current = torch.cuda.current_stream(self.device)
            if self._side is None:
                self._side = torch.cuda.Stream(self.device)
            side = self._side
            side.wait_stream(current)
            with torch.cuda.stream(side):
                first = body()
            current.wait_stream(side)
        else:
            first = body()
        if not warmup_is_step:
            for g, pos in zip(slots, saved):
                set_position(g, pos)
        warm = launch_counts()
        if self.device.type == "cuda":
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            for g in slots:
                graph.register_generator_state(g)
            with torch.cuda.graph(graph, pool=self.pool, capture_error_mode="global"):
                output = body()
            self.pool_bytes = _pool_bytes(self.pool)
            step = StepGraph(graph, output, [a - b for a, b in zip(launch_counts(), warm)],
                             self.tracer, self.name)
        else:
            step = StepGraph(_Rerun(body), None, [0] * len(COUNTED), self.tracer, self.name)
        set_launch_counts(warm if warmup_is_step else before)
        if warmup_is_step:
            step.first = first
        seconds = time.perf_counter() - t0
        self.captures += 1
        self.capture_seconds += seconds
        self._graphs.append(step)
        backend.record_compile(seconds)
        return step


def _pool_bytes(pool) -> int:
    """Bytes of device memory the graph pool ``pool`` holds."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))
