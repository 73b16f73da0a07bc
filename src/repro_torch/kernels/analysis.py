"""Op accounting of a backward, for the kernel tier.

The point of the residual backward is structural: the cotangent pass must
be a *single* reverse pass, not recompute-forward-then-transpose.  That
claim is checkable by counting what a backward runs: its recurrence passes,
its matmul FLOPs, its total op traffic and its kernel launches, for the
residual pairing (``GRUScan``, ``SSDChunkScan``) against the oracle pairing
(``gru_scan_oracle``, ``ssd_chunk_scan_oracle``).

``backward_stats`` runs ``fn`` forward, then counts only its backward
(``torch.autograd.grad`` with a cotangent of ones) under a
``TorchDispatchMode``.  ``recompute_elimination_report`` packages the
comparison, with the JAX package's result keys and claim.  On the card the
residual backward is one kernel launch and a few allocations.  On the CPU
both backwards are plain PyTorch, and the residual's per-step gate rebuild
dispatches about as many ops as the oracle's recompute: the claim holds
there at some shapes only (the JAX package's test shape among them).

The port measures a run, where the JAX package walks a jaxpr, so its counts
mean something else:

* ``scans`` counts the sequential passes over time or chunks that the
  backward makes: the ``backend.recurrence`` ranges it enters (``ref.py``'s
  plain loops, and the oracle's transpose of its recompute), by name in
  ``passes``, plus its kernel launches (a launch is one pass).  The
  oracle's second pass is a label: ``recompute_vjp`` marks its
  ``torch.autograd.grad`` through the unrolled recompute as one pass, the
  reverse sweep autograd makes over it.  What the oracle's count does
  measure is its first pass, the plain forward it reruns (``passes`` names
  it); the residual backward enters no forward's range.  The JAX package
  counts ``scan`` sites.
* ``weighted_eqns`` counts the aten ops the backward dispatches, less the
  views (``permute``, ``view``, ``select`` ...: metadata, no data moved;
  ``einsum`` alone dispatches several around each ``bmm``).  PyTorch runs
  a loop eagerly, so an op in a loop counts once a trip, as the JAX package
  weights a loop body by its trip count; the two totals are of different
  ops and are compared only within one package.
* ``dot_general_flops`` is ``2·m·n·k`` (times the batch) of every ``mm``,
  ``bmm``, ``addmm`` and ``baddbmm`` (``matmul`` and ``einsum`` reach
  those), where the JAX package sums its ``dot_general`` sites.
* ``launches`` takes the place of ``pallas_calls``: each CUDA kernel's
  wrapper count over the backward, by kernel (0 on the CPU, where the
  wrappers run the plain versions).  PyTorch has no ``while`` primitive, so
  ``while_loops`` has no counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import backend
from repro_torch.kernels.gru_scan import kernel as gru_kernel
from repro_torch.kernels.ssd import kernel as ssd_kernel

KERNELS = {
    "gru_scan": gru_kernel.gru_scan,
    "gru_scan_bwd": gru_kernel.gru_scan_bwd,
    "ssd_chunk_scan": ssd_kernel.ssd_chunk_scan,
    "ssd_chunk_scan_bwd": ssd_kernel.ssd_chunk_scan_bwd,
}
_aten = torch.ops.aten
_MATMULS = {_aten.mm.default, _aten.bmm.default, _aten.addmm.default, _aten.baddbmm.default}
_RECORD_ENTER = torch.ops.profiler._record_function_enter_new.default


@dataclasses.dataclass
class OpStats:
    """What one backward ran (see the module docstring for each count)."""

    scans: int = 0              # recurrence passes (a second one = a recompute pass)
    passes: dict[str, int] = dataclasses.field(default_factory=dict)  # ranges entered, by name
    launches: dict[str, int] = dataclasses.field(default_factory=dict)
    dot_general_flops: float = 0.0
    weighted_eqns: float = 0.0  # aten ops but views, loops unrolled: total op traffic

    def as_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


def _matmul_flops(func, args) -> float:
    a, b = (args[1], args[2]) if func in (_aten.addmm.default, _aten.baddbmm.default) else args[:2]
    *batch, m, k = a.shape
    n = b.shape[-1]
    return 2.0 * torch.Size(batch).numel() * m * n * k


class _Counter(TorchDispatchMode):
    def __init__(self, stats: OpStats) -> None:
        super().__init__()
        self.stats = stats

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is _RECORD_ENTER and args[0].startswith(backend.RECURRENCE):
            name = args[0][len(backend.RECURRENCE):]
            self.stats.passes[name] = self.stats.passes.get(name, 0) + 1
        elif func.namespace == "aten" and not func.is_view:
            self.stats.weighted_eqns += 1
            if func in _MATMULS:
                self.stats.dot_general_flops += _matmul_flops(func, args)
        return func(*args, **(kwargs or {}))


def _launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def backward_stats(fn: Callable, *args: torch.Tensor) -> OpStats:
    """Op stats of the *backward only* of ``fn`` at ``args`` (every argument
    gets a cotangent, as ``jax.vjp`` gives one to each)."""
    inputs = [a.detach().requires_grad_() for a in args]
    out = fn(*inputs)
    cotangent = torch.ones_like(out)
    before = _launch_counts()
    stats = OpStats()
    with _Counter(stats):
        torch.autograd.grad(out, inputs, cotangent)
    stats.launches = {k: v - before[k] for k, v in _launch_counts().items()}
    stats.scans = sum(stats.passes.values()) + sum(stats.launches.values())
    return stats


def recompute_vjp(plain, saved, dy: torch.Tensor, name: str) -> tuple[torch.Tensor, ...]:
    """The oracles' backward: rerun ``plain`` on ``saved`` under autograd and
    take the cotangents of all its inputs through it.  The transpose is
    marked as one pass, ``<name>_transpose`` (a label; see ``scans``)."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_() for t in saved]
        out = plain(*inputs)
        with backend.recurrence(f"{name}_transpose"):
            return torch.autograd.grad(out, inputs, dy)


def recompute_elimination_report(
    residual_fn: Callable, oracle_fn: Callable, *args: torch.Tensor
) -> dict[str, Any]:
    """Compare residual vs oracle backwards at the same inputs.

    ``recompute_eliminated`` is the structural claim: the residual backward
    has strictly fewer recurrence passes than the oracle (no second forward
    pass) and no more total op traffic.
    """
    residual = backward_stats(residual_fn, *args)
    oracle = backward_stats(oracle_fn, *args)
    eliminated = (
        residual.scans < oracle.scans
        and residual.weighted_eqns <= oracle.weighted_eqns
    )
    return {
        "residual_bwd": residual.as_dict(),
        "oracle_bwd": oracle.as_dict(),
        "recompute_eliminated": bool(eliminated),
    }
