"""The port's kernel router, and the build of its CUDA kernels.

Routing is by the device of the tensors a wrapper is given, and by nothing
else: CUDA tensors go to the hand-written kernel (or the call raises — a
build failure, a refused launch or an unsupported shape is an error, never a
reason to compute elsewhere); CPU tensors go to the plain PyTorch version in
the kernel's ``ref.py``; meta tensors, which the dry run steps on, get empty
outputs and the call's work recorded (``kernels/work.py``).  There is no
environment switch.

Kernels are CUDA C++ sources under ``repro_torch/csrc/``, compiled at first
use with ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface and loaded with ``ctypes``.  The library's name carries a hash of
its source, so an edited source is rebuilt and a stale build never loads.

The port's compile events are these libraries' ``nvcc`` builds and first
loads in a process, and the trainers' CUDA graph captures (``capture.py``,
the port of ``jax.jit``, through ``record_compile``).  Each is counted with
its host seconds in ``LIBRARY_EVENTS`` and handed to the listeners of
``add_library_listener`` (``obs/profile.py::CompileWatcher`` turns them into
the ``jit.*`` metrics).  Counting costs no device work.

Each plain version whose loop is one sequential pass over the time (or
chunk) axis runs inside a ``recurrence`` profiler range;
``kernels/analysis.py`` counts them, with the kernels' launches, as a
backward's ``scans``.  The kernel wrappers enter no range.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
# <checkout>/build/repro_torch when the package runs from src/ of a checkout.
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()

# This process's library events (builds and first loads) and their seconds.
# Builds may run on several threads at once, so the counts and the
# listeners' own tallies are updated under one lock.
LIBRARY_EVENTS: dict[str, float] = {"count": 0, "seconds": 0.0}
_listeners: list[Callable[[float], None]] = []
_events_lock = threading.Lock()


def add_library_listener(listener: Callable[[float], None]) -> None:
    """Call ``listener(seconds)`` at every library event from now on."""
    with _events_lock:
        _listeners.append(listener)


def _library_event(seconds: float) -> None:
    with _events_lock:
        LIBRARY_EVENTS["count"] += 1
        LIBRARY_EVENTS["seconds"] += seconds
        for listener in _listeners:
            listener(seconds)


def record_compile(seconds: float) -> None:
    """Count a compile that is not a library's: a captured step's graph."""
    _library_event(seconds)


def route(*tensors: torch.Tensor) -> str:
    """``"cuda"``, ``"cpu"`` or ``"meta"``: where a wrapper must run for these
    tensors.

    All tensors must share one device type; anything else raises.  Only the
    four main-path wrappers (``gru_scan``, ``gru_scan_bwd``,
    ``ssd_chunk_scan``, ``ssd_chunk_scan_bwd``) take the meta route: they
    return empty meta outputs of the kernel's shapes and dtypes and record
    the call's work (``kernels/work.py``) for the dry run.
    """
    kinds = {t.device.type for t in tensors}
    if len(kinds) != 1:
        raise ValueError(f"tensors lie on more than one device: {sorted(kinds)}")
    kind = kinds.pop()
    if kind not in ("cuda", "cpu", "meta"):
        raise ValueError(f"the port's kernels take CUDA, CPU or meta tensors, got {kind}")
    return kind


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built on this machine")


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` into ``BUILD_DIR`` (once per source hash).

    The compiler's report (``-Xptxas -v``: registers, shared memory, spills
    per kernel) is kept beside the library as ``<lib>.log``.
    """
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"building {src} failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    _library_event(time.perf_counter() - t0)
    return lib


def load_library(name: str, signatures: dict[str, tuple[list, type]]) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built at first use.

    ``signatures`` maps each C entry point to ``(argtypes, restype)``; they
    are declared once, when the library is loaded.
    """
    with _lock:
        if name not in _libs:
            path = build(name)
            t0 = time.perf_counter()
            lib = ctypes.CDLL(str(path))
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[name] = lib
            _library_event(time.perf_counter() - t0)
        return _libs[name]


def check(err: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what} failed to launch: CUDA error {err}")


def stream_handle(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as a pointer-sized int."""
    return torch.cuda.current_stream(device).cuda_stream


RECURRENCE = "recurrence:"


def recurrence(name: str) -> torch.profiler.record_function:
    """A profiler range around one plain version's sequential pass over the
    time or chunk axis."""
    return torch.profiler.record_function(RECURRENCE + name)


def marks_recurrence(fn: Callable) -> Callable:
    """Run ``fn``, a plain version whose loop is one pass over time or
    chunks, inside a ``recurrence`` range named after it."""

    @functools.wraps(fn)
    def marked(*args, **kwargs):
        with recurrence(fn.__name__):
            return fn(*args, **kwargs)

    return marked

