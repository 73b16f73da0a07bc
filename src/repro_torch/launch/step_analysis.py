"""Roofline terms of one step, counted by running the step on meta tensors.

The port's counterpart of the JAX package's ``launch/hlo_analysis.py``.
The reference compiles each step with XLA and walks the compiled HLO: dot
FLOPs times loop trip counts, operand and result bytes of every top-level
instruction, collective bytes, against TPU v5e constants.  The port has no
compiled program to read, so it runs the step itself, eagerly, on ``meta``
tensors (shapes and dtypes, no storage: nothing is allocated and nothing is
computed) under :class:`StepCounter`, a ``TorchDispatchMode`` that sees
every aten op the step dispatches:

* ``flops_by_dtype``: the FLOPs of every matmul-family op (``mm``, ``bmm``,
  ``addmm``, ``baddbmm``, convolutions, attention), from the formulas
  ``torch.utils.flop_counter`` registers for them, keyed by the operands'
  dtype.  A Python loop runs once a trip, so trip counts need no parsing.
* ``bytes``: the bytes in and out of every op that is not a view, the HBM
  traffic of the step run eagerly, op by op (a fused program moves less).
* ``kernels``: the hand-written kernels' calls, FLOPs, bytes and seconds at
  the card's peaks, which their wrappers record on the meta route
  (``kernels/work.py``) instead of launching.
* ``peak_bytes``: the most bytes of tensor storage live at once over the
  step, the step's arguments included, from
  ``torch.distributed._tools.mem_tracker.MemTracker``.

The same counter runs around the step on the card (``chip_smoke.py``
phase 31), where the matmul FLOPs must come out the same.

:class:`RooflineTerms` has the reference's fields and properties against the
datasheet peaks of the card the runs name, an NVIDIA H100 80GB HBM3 (SXM5)
at 700 W: 989 TFLOP/s dense bf16/fp16, 495 TF32, 67 float32 (the port runs
float32 products with TF32 off, so they take the float32 rate), 3.35 TB/s
of HBM and NVLink's 450 GB/s a direction.  They are estimates from a
datasheet, not measurements.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.distribution.sharding import AbstractMesh
from repro_torch.kernels import work
from repro_torch.tree import PyTree, tree_leaves

PEAK_FLOPS = {                  # dense FLOP/s of one card, by operand dtype
    "bfloat16": work.PEAK_16BIT_FLOPS,
    "float16": work.PEAK_16BIT_FLOPS,
    "float32": work.PEAK_F32_FLOPS,
}
HBM_BW = work.PEAK_BYTES_PER_S  # bytes/s of one card
LINK_BW = 450e9                 # NVLink 4, bytes/s a direction of one card
CARD_BYTES = 80e9               # one card's HBM

_aten = torch.ops.aten
# Ops that allocate without writing: no traffic.
_NO_TRAFFIC = {_aten.empty.memory_format, _aten.empty_strided.default, _aten.empty_like.default}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepCounter(TorchDispatchMode):
    """Count what the ops dispatched inside the block do (module docstring).

    ``flops_by_dtype`` maps a dtype name to matmul-family FLOPs; ``bytes``
    is the eager op traffic; ``ops`` counts the ops but views; ``kernels``
    is the meta route's record by kernel name, which :func:`run_counted`
    fills (empty on the card, where the kernels launch and their wrappers
    count launches instead).
    """

    def __init__(self) -> None:
        super().__init__()
        self.flops_by_dtype: dict[str, int] = {}
        self.bytes = 0
        self.ops = 0
        self.kernels: dict[str, work.KernelWork] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        formula = flop_registry.get(func._overloadpacket)
        if formula is None:
            # Composite ops (``matmul``, ``einsum``, ``linear`` ...) reach the
            # mode whole under ``inference_mode`` and decomposed under
            # autograd: count their parts either way, as FlopCounterMode does.
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if func.namespace != "aten" or func.is_view or func in _NO_TRAFFIC:
            return out
        self.ops += 1
        tensors = [x for x in tree_flatten((args, kwargs, out))[0] if isinstance(x, torch.Tensor)]
        self.bytes += sum(_nbytes(t) for t in tensors)
        if formula is not None:
            dtype = str(tensors[0].dtype).removeprefix("torch.")
            flops = int(formula(*args, **kwargs, out_val=out))
            self.flops_by_dtype[dtype] = self.flops_by_dtype.get(dtype, 0) + flops
        return out

    @property
    def matmul_flops(self) -> int:
        return sum(self.flops_by_dtype.values())

    def summary(self) -> dict[str, Any]:
        """The counts as a record's ``hlo_analysis``: ``flops`` (matmul and
        kernel FLOPs), ``bytes`` (op traffic and kernel bytes), by part."""
        kernels = {k: v.as_dict() for k, v in sorted(self.kernels.items())}
        kernel_flops = sum(v["flops"] for v in kernels.values())
        kernel_bytes = sum(v["bytes"] for v in kernels.values())
        return {
            "flops": self.matmul_flops + kernel_flops,
            "bytes": self.bytes + kernel_bytes,
            "matmul_flops": self.matmul_flops,
            "flops_by_dtype": dict(sorted(self.flops_by_dtype.items())),
            "op_bytes": self.bytes,
            "ops": self.ops,
            "kernels": kernels,
            "kernel_compute_s": sum(v["compute_s"] for v in kernels.values()),
        }


def run_counted(step: Callable[..., Any], *args: Any, track_peak: bool = True
                ) -> tuple[Any, StepCounter, int | None]:
    """``step(*args)`` under a :class:`StepCounter` and, with
    ``track_peak``, a ``MemTracker``: ``(result, counter, peak bytes)``.
    The peak counts the storage of ``args`` (tracked before the step
    starts) and of every tensor the step makes while it lives."""
    counter = StepCounter()
    if not track_peak:
        with work.recording() as counter.kernels, counter:
            return step(*args), counter, None
    from torch.distributed._tools.mem_tracker import MemTracker

    tracker = MemTracker()
    tracker.track_external(*(t for t in tree_leaves(list(args)) if isinstance(t, torch.Tensor)))
    with work.recording() as counter.kernels, tracker, counter:
        out = step(*args)
    peak = sum(snap["Total"] for snap in tracker.get_tracker_snapshot("peak").values())
    return out, counter, int(peak)


@dataclasses.dataclass
class RooflineTerms:
    """Per-step roofline terms in seconds, for a given card count.

    ``hlo_flops`` / ``hlo_bytes`` / ``coll_bytes`` are GLOBAL: the whole
    step, matmuls and kernels (the name is the reference's).  ``coll_bytes``
    is None where the port makes no collective to count (``collective_note``
    says why); ``dominant`` is then taken over the other two terms.
    """

    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float | None
    chips: int
    model_flops: float | None = None
    flops_by_dtype: dict[str, float] = dataclasses.field(default_factory=dict)
    kernel_compute_s: float = 0.0   # the kernels' work at their peaks, on one card
    collective_note: str | None = None

    @property
    def compute_s(self) -> float:
        matmuls = sum(f / PEAK_FLOPS.get(d, work.PEAK_F32_FLOPS)
                      for d, f in self.flops_by_dtype.items())
        return (matmuls + self.kernel_compute_s) / self.chips

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / (self.chips * HBM_BW)

    @property
    def collective_s(self) -> float | None:
        if self.coll_bytes is None:
            return None
        return self.coll_bytes / (self.chips * LINK_BW)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max((k for k, v in terms.items() if v is not None), key=terms.get)

    @property
    def useful_flops_ratio(self) -> float | None:
        if self.model_flops is None or self.hlo_flops == 0:
            return None
        return self.model_flops / self.hlo_flops

    def as_dict(self) -> dict[str, Any]:
        return {
            "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes,
            "coll_bytes": self.coll_bytes,
            "chips": self.chips,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
            "collective_note": self.collective_note,
        }


def model_flops_estimate(cfg, shape, kind: str) -> float:
    """MODEL_FLOPS = 6 N D (train) / 2 N D (inference) with N = active params.

    D = processed tokens for the step: batch*seq for train/prefill,
    batch*1 for decode.
    """
    from repro_torch.models.zoo import count_params_config

    n_active = count_params_config(cfg, active_only=True)
    if kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch  # decode: one token per sequence
    return 2.0 * n_active * tokens


def device_bytes(tree: PyTree, shardings: PyTree) -> int:
    """Bytes of one device's shards of ``tree``'s tensors under
    ``shardings`` (a tree of ``NamedSharding`` of the same structure)."""
    return sum(math.prod(s.shard_shape(t.shape)) * t.element_size()
               for t, s in zip(tree_leaves(tree), tree_leaves(shardings), strict=True))


def memory_summary(mesh: AbstractMesh, arguments: dict[str, tuple[PyTree, PyTree]],
                   peak_bytes: int | None = None) -> dict[str, Any]:
    """Bytes per device of the step's arguments, from the sharding rules.

    ``arguments`` maps a part (params, the AdamW moments, the batch, the
    cache) to its tree and its shardings.  ``peak_memory_in_bytes`` is the
    step's peak live bytes (arguments included) where the mesh is one device
    and ``peak_bytes`` was measured, else None: the meta run is the whole
    step on one device, which a sharded layout does not split evenly.
    """
    parts = {f"{name}_bytes": device_bytes(tree, shardings)
             for name, (tree, shardings) in arguments.items()}
    argument = sum(parts.values())
    peak = peak_bytes if mesh.size == 1 else None
    return {
        "argument_size_in_bytes": float(argument),
        **{k: float(v) for k, v in parts.items()},
        "peak_memory_in_bytes": None if peak is None else float(peak),
        "temp_size_in_bytes": None if peak is None else float(peak - argument),
        "fits_one_card": (peak if peak is not None else argument) <= CARD_BYTES,
    }
