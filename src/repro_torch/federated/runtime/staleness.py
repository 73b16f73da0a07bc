"""Staleness-aware buffered aggregation for the async runtime.

The port of the JAX package's ``federated/runtime/staleness.py``: the
weights are the reference's numpy code; ``AsyncUpdate`` holds torch param
trees on the federation's device, and a flush folds the buffered deltas
leaf by leaf in float32, in buffer order, as the reference does.

Under a synchronous barrier every update is computed against the current
global parameters.  Once the barrier is gone, an update arrives anchored at
whatever parameter *version* the client was dispatched with — its
**staleness** ``s = version_now - version_at_dispatch`` counts the flushes
that happened while it trained.  Stale gradients still carry signal but
point from an old iterate, so buffered-async FL discounts them smoothly:

    w(s) = (1 + s) ** -a        (polynomial decay, Nguyen et al. 2022)

``a = 0`` disables the discount, ``s = 0`` always weighs 1, and the weight
decays monotonically — the properties the tier-1 property tests pin down.

Two buffered aggregators register into the aggregator registry (they
resolve via ``resolve_aggregator`` like any policy, but carry
``mode = "buffered"`` so the synchronous ``Federation`` rejects them and
points at ``AsyncFederation``; the registry loads this module on its first
use):

* ``"fedbuff:K"`` — buffered async FedAvg: client completions accumulate
  in a buffer; every ``K`` completions the buffer flushes as one
  staleness-discounted, sample-weighted delta step.  With ``K`` = all
  participants and a zero-spread latency model every update has staleness
  0 and the flush *is* flat FedAvg — the parity gate.
* ``"hierarchical-async:R"`` — regional sub-federations: participants are
  partitioned into ``R`` contiguous regions, each region trains one
  synchronous engine round as a single task, and the cross-region combine
  happens whenever a region finishes, merging the region's delta scaled by
  its sample share and staleness discount: the sync two-level
  ``"hierarchical:R"`` with stale-tolerant combines.  ``R = 1`` degenerates
  to synchronous flat FedAvg (one region == the whole federation).

Buffered aggregators hold no hidden state between flushes: the buffer
lives in ``AsyncFederation.run`` and every :class:`AsyncUpdate` is a value
object (client ids, trained params, the anchor version they trained from).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.federated.api import Aggregator, register_aggregator
from repro_torch.tree import PyTree, tree_map

BUFFERED_MODE = "buffered"


def polynomial_staleness_weight(staleness, exponent: float = 0.5):
    """``(1 + s) ** -exponent`` — FedBuff's polynomial staleness discount.

    Accepts scalars or arrays; ``s = 0`` maps to exactly 1.0 and the weight
    is strictly positive and non-increasing in ``s``.
    """
    if float(exponent) < 0:
        raise ValueError(f"staleness exponent must be >= 0, got {exponent}")
    s = np.asarray(staleness, dtype=np.float64)
    if np.any(s < 0):
        raise ValueError(f"staleness must be >= 0, got {staleness}")
    out = (1.0 + s) ** (-float(exponent))
    return float(out) if np.isscalar(staleness) or out.ndim == 0 else out


def staleness_weights(
    sample_sizes: Sequence[float], staleness: Sequence[float], exponent: float = 0.5
) -> np.ndarray:
    """Normalized flush weights ``w_i ∝ n_i * (1 + s_i) ** -a`` (sum to 1)."""
    n = np.asarray(sample_sizes, dtype=np.float64)
    if n.size == 0:
        raise ValueError("nothing to weigh")
    if np.any(n < 0) or n.sum() <= 0:
        raise ValueError(f"invalid sample sizes: {sample_sizes}")
    w = n * polynomial_staleness_weight(np.asarray(staleness), exponent)
    return (w / w.sum()).astype(np.float64)


@dataclasses.dataclass
class AsyncUpdate:
    """One completed task, waiting in the server buffer for the next flush.

    ``params``/``anchor`` are torch param trees on the federation's device.
    Nothing updates them in place (a flush builds new tensors), so holding
    both costs no copies, and the flush computes the task's delta
    ``params - anchor`` (the local progress measured from the version it
    was dispatched with).
    """

    client_ids: np.ndarray   # sorted members that actually trained
    params: PyTree           # task result (group-FedAvg for region tasks)
    anchor: PyTree           # global params the task was dispatched with
    weight: float            # total local sample count of the members
    version: int             # server version at dispatch
    losses: np.ndarray       # per-member mean local losses
    local_steps: int         # real local steps the task executed


class AsyncAggregator(Aggregator):
    """Buffered aggregation driven by the event loop, not the round program.

    The synchronous ``Aggregator`` contract answers "how do one round's
    updates combine"; the async contract answers three event-loop
    questions instead — what the schedulable *task unit* is
    (``task_groups``), when the buffer flushes (``ready``), and how a
    flush folds buffered deltas into the global params (``combine``).
    ``mode = "buffered"`` keeps these out of the synchronous round program.
    """

    mode = BUFFERED_MODE
    staleness_exponent: float = 0.5

    def task_groups(self, federation_ids: np.ndarray) -> list[np.ndarray]:
        """Partition the federation into schedulable task units.

        Default: one task per client (fully async).  Region-structured
        aggregators return multi-client groups that train one synchronous
        engine round per task.
        """
        return [np.asarray([cid]) for cid in np.sort(np.asarray(federation_ids))]

    def prepare(self, num_tasks: int) -> None:
        """Called once per run, after the federation forms, with the task
        count — the hook where relative thresholds become absolute."""

    def ready(self, buffered: int) -> bool:
        """True when ``buffered`` pending updates should trigger a flush."""
        raise NotImplementedError

    def combine(
        self,
        params: PyTree,
        updates: Sequence[AsyncUpdate],
        version: int,
        total_weight: float,
    ) -> PyTree:
        """Fold the buffered updates into ``params`` at server ``version``."""
        raise NotImplementedError

    def staleness_of(self, updates: Sequence[AsyncUpdate], version: int) -> np.ndarray:
        return np.asarray([version - u.version for u in updates], dtype=np.float64)


def _apply_deltas(params: PyTree, updates: Sequence[AsyncUpdate], coeffs) -> PyTree:
    """``params + sum_i c_i * (update_i.params - update_i.anchor)`` per leaf.

    Each leaf is promoted to float32, the deltas accumulate in buffer order
    and the sum is cast back to the leaf's dtype.  The result is new
    tensors: ``anchor`` is the live global params of in-flight tasks.
    """
    cs = [float(c) for c in coeffs]

    def leafwise(p, *pairs):
        # pairs interleaves (new_0, anchor_0, new_1, anchor_1, ...)
        ct = torch.promote_types(p.dtype, torch.float32)
        out = p.to(ct)
        for c, (new, anchor) in zip(cs, zip(pairs[0::2], pairs[1::2])):
            out = out + c * (new.to(ct) - anchor.to(ct))
        return out.to(p.dtype)

    flat: list[PyTree] = []
    for u in updates:
        flat.extend((u.params, u.anchor))
    return tree_map(leafwise, params, *flat)


@register_aggregator("fedbuff")
class FedBuffAggregator(AsyncAggregator):
    """Buffered async FedAvg: flush every ``buffer_size`` completions.

    Spec forms: ``"fedbuff:K"`` or ``"fedbuff:K,a"`` (``a`` = staleness
    exponent).  An integer ``K`` is an absolute buffer size; a float in
    ``(0, 1]`` is a *fraction of the federation's tasks*, resolved when
    the run starts — ``"fedbuff:0.25"`` flushes every quarter-federation,
    ``"fedbuff:1.0"`` waits for everyone (the same int-count/float-
    fraction grammar as ``"uniform:K"`` vs ``"uniform:0.1"``).  Each flush
    applies the sample-weighted, staleness-discounted mean of the buffered
    deltas, scaled by ``server_lr``::

        params += server_lr * sum_i w~_i * (params_i - anchor_i),
        w~_i ∝ n_i * (1 + s_i) ** -a  (normalized over the buffer)

    With ``buffer_size`` = all participants, zero latency spread, and the
    default ``server_lr = 1``, every ``s_i`` is 0 and every anchor is the
    current params, so the flush telescopes to flat FedAvg — the 1e-5
    parity gate against the synchronous engines.  Federations smaller than
    ``buffer_size`` still make progress: the runtime force-flushes when
    every task has reported and the buffer cannot grow further.
    """

    def __init__(
        self,
        buffer_size: int | float = 8,
        staleness_exponent: float = 0.5,
        server_lr: float = 1.0,
    ) -> None:
        # The int/float distinction is textual, like the selection specs:
        # 8 is a count, 0.25 a fraction of the federation's tasks.
        if isinstance(buffer_size, float) and not buffer_size.is_integer():
            if not (0.0 < buffer_size <= 1.0):
                raise ValueError(
                    f"fedbuff fractional buffer_size must be in (0, 1], got {buffer_size}"
                )
            self.buffer_fraction: float | None = float(buffer_size)
            self.buffer_size = 1  # concrete once prepare() sees the task count
        elif isinstance(buffer_size, float) and buffer_size == 1.0:
            self.buffer_fraction = 1.0  # "fedbuff:1.0" = the whole federation
            self.buffer_size = 1
        else:
            if int(buffer_size) < 1:
                raise ValueError(f"fedbuff needs buffer_size >= 1, got {buffer_size}")
            self.buffer_fraction = None
            self.buffer_size = int(buffer_size)
        if float(staleness_exponent) < 0:
            raise ValueError(
                f"fedbuff needs staleness_exponent >= 0, got {staleness_exponent}"
            )
        if not (float(server_lr) > 0):
            raise ValueError(f"fedbuff needs server_lr > 0, got {server_lr}")
        self.staleness_exponent = float(staleness_exponent)
        self.server_lr = float(server_lr)

    def prepare(self, num_tasks: int) -> None:
        if self.buffer_fraction is not None:
            self.buffer_size = max(1, round(self.buffer_fraction * num_tasks))

    def ready(self, buffered: int) -> bool:
        return buffered >= self.buffer_size

    def combine(self, params, updates, version, total_weight):
        coeffs = self.server_lr * staleness_weights(
            [u.weight for u in updates],
            self.staleness_of(updates, version),
            self.staleness_exponent,
        )
        return _apply_deltas(params, updates, coeffs)


@register_aggregator("hierarchical-async")
class HierarchicalAsyncAggregator(AsyncAggregator):
    """Async two-level FedAvg: regions combine as they finish.

    Spec forms: ``"hierarchical-async:R"`` or ``"hierarchical-async:R,a"``.
    ``task_groups`` partitions the sorted federation into ``R`` contiguous
    regions (the same split as the sync ``"hierarchical:R"``); each task is
    one regional engine round.  The cross-region combine
    runs whenever a region reports (``ready`` at 1 buffered update),
    merging the region's delta scaled by its sample share of the
    federation and the staleness discount::

        params += (n_region / n_total) * (1 + s) ** -a * (params_r - anchor_r)

    No region ever waits for another — a straggling region delays only its own
    (discounted) contribution.  ``R = 1`` makes the whole federation one
    region, which reproduces synchronous flat FedAvg exactly (sample share
    1, staleness 0): the subsystem's second parity anchor.
    """

    def __init__(self, num_regions: int = 2, staleness_exponent: float = 0.5) -> None:
        if int(num_regions) < 1:
            raise ValueError(f"hierarchical-async needs >= 1 region, got {num_regions}")
        if float(staleness_exponent) < 0:
            raise ValueError(
                f"hierarchical-async needs staleness_exponent >= 0, "
                f"got {staleness_exponent}"
            )
        self.num_regions = int(num_regions)
        self.staleness_exponent = float(staleness_exponent)

    def task_groups(self, federation_ids) -> list[np.ndarray]:
        ids = np.sort(np.asarray(federation_ids))
        parts = np.array_split(ids, min(self.num_regions, len(ids)))
        return [p for p in parts if len(p)]

    def ready(self, buffered: int) -> bool:
        return buffered >= 1

    def combine(self, params, updates, version, total_weight):
        if not (float(total_weight) > 0):
            raise ValueError(f"total_weight must be > 0, got {total_weight}")
        discounts = polynomial_staleness_weight(
            self.staleness_of(updates, version), self.staleness_exponent
        )
        coeffs = np.atleast_1d(discounts) * np.asarray(
            [u.weight / float(total_weight) for u in updates]
        )
        return _apply_deltas(params, updates, coeffs)
