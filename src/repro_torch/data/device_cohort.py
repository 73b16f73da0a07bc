"""Client data resident on the training device, and per-round index plans.

The port of the JAX package's ``data/device_cohort.py``.  Rebuild staging
(``CohortTrainer(staging="rebuild")``) writes every round's whole
``(steps, clients, batch, *features)`` schedule on the host and uploads it.
Here a federation's train arrays are uploaded once and a round stages only
int32 sample indices:

* ``build_device_cohort`` pads every client's train split to a common
  sample axis and keeps ``x`` as ``(rows, max_n + 1, *features)`` and ``y``
  as ``(rows, max_n + 1)`` on the device.  Sample ``max_n`` of every row is
  all zero: the pad row.  The upload goes through pinned host memory: the
  clients' real samples are packed back to back, copied once, and scattered
  into their rows on the device (``index_copy_``).
* ``build_cohort_plan`` is the index twin of ``build_cohort_schedule``: it
  draws the same ``rng.permutation(n)`` calls in the same client-major
  order, so the generator is left in the same state, but records only
  ``(C, T, B)`` int32 sample indices.  Every padding slot points at the pad
  row, so a batch gathered through the plan is the schedule's zero-padded
  batch bit for bit, and the example mask is ``index < n_c``.
* With ``resident_budget_bytes`` below the whole federation's size the
  cohort is an LRU pool of rows, filled per round by ``ensure_resident``.
* Under a data mesh (``launch/mesh.py``) the rows are padded to a multiple
  of the axis size, as the reference pads them, and each rank uploads only
  its contiguous block of them; ``owner_of`` names the rank that holds a
  client's row, and the rows never move.  The pool is single-host, as in
  the reference: a pool under a mesh of more than one rank raises.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.data.pipeline import ClientDataset, cohort_steps_per_epoch
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import resolve_mesh
from repro_torch.obs.trace import resolve_tracer

_ALIGN = 64


def torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


class Layout:
    """Named arrays back to back in one byte buffer, each 64-byte aligned.

    One host buffer, one copy to the device, and each array a view of the
    copy: how the cohort engine stages a chunk and how a device cohort is
    uploaded.
    """

    def __init__(self, fields: dict[str, tuple[tuple[int, ...], Any]]) -> None:
        self.fields = {name: (tuple(shape), np.dtype(dt)) for name, (shape, dt) in fields.items()}
        self.offsets: dict[str, int] = {}
        total = 0
        for name, (shape, dtype) in self.fields.items():
            self.offsets[name] = total
            total += -(-int(np.prod(shape)) * dtype.itemsize // _ALIGN) * _ALIGN
        self.nbytes = total

    def _span(self, name: str) -> tuple[int, int]:
        shape, dtype = self.fields[name]
        return self.offsets[name], int(np.prod(shape)) * dtype.itemsize

    def host_views(self, buf: np.ndarray) -> dict[str, np.ndarray]:
        views = {}
        for name, (shape, dtype) in self.fields.items():
            start, n = self._span(name)
            views[name] = buf[start : start + n].view(dtype).reshape(shape)
        return views

    def device_views(self, staged: torch.Tensor) -> dict[str, torch.Tensor]:
        views = {}
        for name, (shape, dtype) in self.fields.items():
            start, n = self._span(name)
            views[name] = staged[start : start + n].view(torch_dtype(dtype)).view(shape)
        return views


def host_buffer(nbytes: int, device: torch.device) -> torch.Tensor:
    """A uint8 host tensor for a copy to ``device``: pinned when the device
    is the card, so the copy is a DMA that can run on a stream of its own."""
    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=device.type == "cuda")


def upload(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``host`` copied to a new tensor on ``device`` (asynchronous from a
    pinned buffer, on the current stream)."""
    return torch.empty(host.numel(), dtype=torch.uint8, device=device).copy_(
        host, non_blocking=True
    )


@dataclasses.dataclass(frozen=True)
class CohortPlan:
    """A fixed-shape index plan for one federated round across a cohort.

    The twin of ``CohortSchedule``: the same ``(C, T)`` step grid and
    generator stream, but ``(C, T, B)`` int32 indices into each client's
    sample axis instead of ``(C, T, B, *features)`` floats.  Every padding
    slot (batch tails and padding steps) holds ``pad_index``, which every
    client maps to an all-zero row.  ``client_rows`` maps each cohort
    position to its row in the ``DeviceCohort``.
    """

    sample_idx: np.ndarray  # (C, T, B) int32 into the client's sample axis
    step_valid: np.ndarray  # (C, T) bool — False on padding steps
    client_rows: np.ndarray  # (C,) int32 rows into the DeviceCohort
    weights: np.ndarray     # (C,) float32 local sample counts n_c
    pad_index: int          # the all-zero row every padding slot points at
    steps_per_epoch: int
    local_epochs: int

    @property
    def num_clients(self) -> int:
        return self.sample_idx.shape[0]

    @property
    def total_steps(self) -> int:
        return self.sample_idx.shape[1]

    @property
    def nbytes(self) -> int:
        """Host bytes this plan stages per round."""
        return (
            self.sample_idx.nbytes
            + self.step_valid.nbytes
            + self.client_rows.nbytes
            + self.weights.nbytes
        )


@dataclasses.dataclass
class DeviceCohort:
    """A federation's train arrays, resident on the device for its lifetime.

    ``x``/``y`` are uploaded once by ``build_device_cohort``; a round then
    stages only an index plan and gathers its batches on the device.
    Sample ``pad_index`` (``x.shape[1] - 1``) is all zero in every row.
    """

    x: torch.Tensor          # (rows, max_n + 1, *features)
    y: torch.Tensor          # (rows, max_n + 1)
    rows: dict[int, int]     # client_id -> row (current residency when pooled)
    nbytes: int              # resident device bytes (pool bytes when pooled)
    _sources: dict[int, Any] = dataclasses.field(default_factory=dict, repr=False)
    # -- memory-bounded (LRU pool) mode; None/unused when fully resident ----
    pool_rows: int | None = None
    uploads: int = 0
    evictions: int = 0
    hits: int = 0
    bytes_uploaded: int = 0
    _lru: OrderedDict = dataclasses.field(default_factory=OrderedDict, repr=False)
    _free: list = dataclasses.field(default_factory=list, repr=False)
    # Host seconds ``build_device_cohort`` took, the device's copies included.
    attach_seconds: float = 0.0
    # Observability: pool uploads record a "pool_upload" span (None = no-op).
    tracer: Any = dataclasses.field(default=None, repr=False)
    # Under a data mesh: client_id -> the rank holding its row (``rows``
    # then holds this rank's rows only).  Empty without a mesh.
    owners: dict[int, int] = dataclasses.field(default_factory=dict, repr=False)

    def __post_init__(self) -> None:
        self.tracer = resolve_tracer(self.tracer)

    @property
    def pad_index(self) -> int:
        return self.x.shape[1] - 1

    @property
    def num_rows(self) -> int:
        return self.x.shape[0]

    @property
    def is_pooled(self) -> bool:
        return self.pool_rows is not None

    def row_of(self, client: ClientDataset) -> int:
        try:
            return self.rows[client.client_id]
        except KeyError:
            if self.is_pooled:
                raise KeyError(
                    f"client {client.client_id} is not resident in the pool; "
                    "call ensure_resident(round_clients) before staging"
                ) from None
            if client.client_id in self.owners:
                raise KeyError(
                    f"client {client.client_id}'s row is held by rank "
                    f"{self.owners[client.client_id]}; a rank trains only the rows it holds"
                ) from None
            raise KeyError(
                f"client {client.client_id} is not part of this device cohort; "
                "attach the full federation before training"
            ) from None

    def owns(self, client: ClientDataset) -> bool:
        """True iff this resident copy was built from exactly this dataset."""
        return self._sources.get(client.client_id) is client.train

    def owner_of(self, client: ClientDataset) -> int:
        """The rank holding ``client``'s row: 0 without a mesh."""
        return self.owners.get(client.client_id, 0)

    def ensure_resident(self, clients: Sequence[ClientDataset]) -> int:
        """Make every client in ``clients`` resident; returns rows uploaded.

        Pool mode only (a fully resident cohort is a no-op).  Runs once per
        round, before any plan is staged, so rows stay put for the whole
        round and a plan built on the staging thread never races an
        eviction.  Eviction is LRU among clients not in this round; the pool
        must hold the round's whole cohort.
        """
        if not self.is_pooled:
            return 0
        if len(clients) > self.pool_rows:
            raise ValueError(
                f"round cohort of {len(clients)} clients exceeds the resident "
                f"pool ({self.pool_rows} rows); raise resident_budget_bytes or "
                "sample fewer clients per round"
            )
        wanted = {c.client_id for c in clients}
        missing: list[ClientDataset] = []
        for c in clients:
            if not self.owns(c):
                raise KeyError(
                    f"client {c.client_id} was not part of the federation this "
                    "pool was built for"
                )
            if c.client_id in self._lru:
                self._lru.move_to_end(c.client_id)
                self.hits += 1
            else:
                missing.append(c)
        if not missing:
            return 0

        with self.tracer.span("pool_upload", track="pool", missing=len(missing)):
            target_rows: list[int] = []
            for _ in missing:
                if self._free:
                    target_rows.append(self._free.pop())
                    continue
                victim = next(cid for cid in self._lru if cid not in wanted)
                row = self._lru.pop(victim)
                del self.rows[victim]
                self.evictions += 1
                target_rows.append(row)

            # Whole padded rows, so a reused row's stale tail is zeroed too.
            m, width = len(missing), self.pad_index + 1
            layout = Layout({
                "x": ((m, width, *self.x.shape[2:]), _np_dtype(self.x.dtype)),
                "y": ((m, width), _np_dtype(self.y.dtype)),
                "rows": ((m,), np.int64),
            })
            host = host_buffer(layout.nbytes, self.x.device)
            views = layout.host_views(host.numpy())
            views["x"][...] = 0
            views["y"][...] = 0
            for i, c in enumerate(missing):
                views["x"][i, : c.n_train] = c.train.x
                views["y"][i, : c.n_train] = c.train.y
                self._lru[c.client_id] = target_rows[i]
                self.rows[c.client_id] = target_rows[i]
            views["rows"][...] = target_rows
            staged = layout.device_views(upload(host, self.x.device))
            self.x.index_copy_(0, staged["rows"], staged["x"])
            self.y.index_copy_(0, staged["rows"], staged["y"])
            _finish_copies(self.x.device)
            self.uploads += m
            self.bytes_uploaded += views["x"].nbytes + views["y"].nbytes
        return m


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def _finish_copies(device: torch.device) -> None:
    """Wait for the current stream, so a pinned host buffer the caller still
    holds may be freed: its asynchronous copies are done."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def build_device_cohort(
    clients: Sequence[ClientDataset],
    mesh: Any = None,
    resident_budget_bytes: int | None = None,
    tracer: Any = None,
    device: str | torch.device | None = None,
) -> DeviceCohort:
    """Pad and upload every client's train arrays once.

    The sample axis is padded to ``max_n + 1`` so index ``max_n`` is an
    all-zero row in every client's row: the target of every padding slot
    of a ``CohortPlan``.  ``resident_budget_bytes`` bounds device memory:
    when the whole cohort would exceed it, only a pool of
    ``budget // row_bytes`` rows is allocated and rows are uploaded per
    round (LRU eviction) by ``ensure_resident``, each upload a
    ``pool_upload`` span of ``tracer`` (None = no-op).  ``device`` defaults
    to the card.

    ``mesh`` (a ``DataMesh``, ``"auto"`` or None): the rows are padded to a
    multiple of the axis size with all-zero rows and this rank uploads only
    its contiguous block of them (``num_rows`` is then the block's size).
    The pool is single-host: a budget too small for the whole federation
    under a mesh of more than one rank raises ``ValueError``.
    """
    if not clients:
        raise ValueError("empty cohort")
    dev = resolve_device(device)
    mesh = resolve_mesh(mesh)
    t0 = time.perf_counter()
    feat = clients[0].train.x.shape[1:]
    x_dtype = clients[0].train.x.dtype
    y_dtype = clients[0].train.y.dtype
    for client in clients:
        if client.train.x.shape[1:] != feat:
            raise ValueError("all cohort clients must share a feature shape")
    max_n = max(c.n_train for c in clients)
    sources = {c.client_id: c.train for c in clients}
    row_bytes = int(
        np.prod((max_n + 1, *feat)) * np.dtype(x_dtype).itemsize
        + (max_n + 1) * np.dtype(y_dtype).itemsize
    )
    shards = 1 if mesh is None else mesh.size
    num_rows = len(clients) + (-len(clients) % shards)
    full_bytes = num_rows * row_bytes

    def zeros(rows: int) -> tuple[torch.Tensor, torch.Tensor]:
        return (
            torch.zeros((rows, max_n + 1, *feat), dtype=torch_dtype(x_dtype), device=dev),
            torch.zeros((rows, max_n + 1), dtype=torch_dtype(y_dtype), device=dev),
        )

    if resident_budget_bytes is not None and full_bytes > resident_budget_bytes:
        if shards > 1:
            raise ValueError(
                "resident_budget_bytes pooling is single-host; drop the mesh "
                "or raise the budget to fit the full cohort"
            )
        pool_rows = int(resident_budget_bytes // row_bytes)
        if pool_rows < 1:
            raise ValueError(
                f"resident_budget_bytes={resident_budget_bytes} cannot hold "
                f"even one client row ({row_bytes} bytes)"
            )
        dx, dy = zeros(pool_rows)
        return DeviceCohort(
            x=dx,
            y=dy,
            rows={},
            nbytes=pool_rows * row_bytes,
            _sources=sources,
            pool_rows=pool_rows,
            _free=list(range(pool_rows - 1, -1, -1)),
            attach_seconds=time.perf_counter() - t0,
            tracer=tracer,
        )

    # This rank's block of the padded rows (every row without a mesh).
    per_rank = num_rows // shards
    first = 0 if mesh is None else mesh.rank * per_rank
    owners = {} if mesh is None else {
        c.client_id: r // per_rank for r, c in enumerate(clients)}
    block = clients[first : first + per_rank]
    # The real samples packed back to back: one pinned buffer, one copy, then
    # one scatter each for x and y into the zeroed rows on the device.
    total = sum(c.n_train for c in block)
    layout = Layout({
        "x": ((total, *feat), x_dtype),
        "y": ((total,), y_dtype),
        "dest": ((total,), np.int64),
    })
    host = host_buffer(layout.nbytes, dev)
    views = layout.host_views(host.numpy())
    rows: dict[int, int] = {}
    start = 0
    for r, client in enumerate(block):
        n = client.n_train
        views["x"][start : start + n] = client.train.x
        views["y"][start : start + n] = client.train.y
        views["dest"][start : start + n] = r * (max_n + 1) + np.arange(n)
        rows[client.client_id] = r
        start += n
    dx, dy = zeros(per_rank)
    staged = layout.device_views(upload(host, dev))
    dx.view(-1, *feat).index_copy_(0, staged["dest"], staged["x"])
    dy.view(-1).index_copy_(0, staged["dest"], staged["y"])
    del staged
    _finish_copies(dev)
    return DeviceCohort(
        x=dx, y=dy, rows=rows, nbytes=per_rank * row_bytes, _sources=sources,
        attach_seconds=time.perf_counter() - t0, tracer=tracer, owners=owners,
    )


def fill_cohort_plan(
    sizes: Sequence[int],
    batch_size: int,
    local_epochs: int,
    rng: np.random.Generator,
    steps_per_epoch: int,
    pad_index: int,
    sample_idx: np.ndarray,
    step_valid: np.ndarray,
    base: Sequence[int] | None = None,
) -> None:
    """Write ``build_cohort_plan``'s indices into ``(C, T, B)`` and ``(C, T)``
    arrays (any strides: the cohort engine passes views of its step-major
    staging buffer), consuming ``rng`` the same way.  ``base[c]`` is added
    to every index of client ``c`` (the engine's flat offset of its row);
    ``step_valid`` must start all False."""
    spe = steps_per_epoch
    for c, n in enumerate(sizes):
        steps = -(-n // batch_size)
        if steps > spe:
            raise ValueError(f"client {c} needs more than steps_per_epoch={spe} batches")
        offset = 0 if base is None else int(base[c])
        sample_idx[c] = offset + pad_index
        slots = np.full(steps * batch_size, offset + pad_index, dtype=np.int64)
        for epoch in range(local_epochs):
            slots[:n] = rng.permutation(n) + offset
            t = epoch * spe
            sample_idx[c, t : t + steps] = slots.reshape(steps, batch_size)
            step_valid[c, t : t + steps] = True


def build_cohort_plan(
    sizes: Sequence[int],
    batch_size: int,
    local_epochs: int,
    rng: np.random.Generator,
    steps_per_epoch: int | None = None,
    client_rows: Sequence[int] | None = None,
    pad_index: int | None = None,
) -> CohortPlan:
    """The index-plan twin of ``build_cohort_schedule``.

    Consumes ``rng`` in exactly the schedule builder's order (client-major,
    one ``rng.permutation(n_c)`` per epoch).  Slots the schedule would
    zero-pad (batch tails, padding steps) point at ``pad_index``.
    """
    sizes = [int(n) for n in sizes]
    if not sizes:
        raise ValueError("empty cohort")
    spe = steps_per_epoch or cohort_steps_per_epoch(sizes, batch_size)
    total = spe * local_epochs
    if pad_index is None:
        pad_index = max(sizes)
    if pad_index < max(sizes):
        raise ValueError(
            f"pad_index={pad_index} must be >= the largest client size {max(sizes)}"
        )
    sample_idx = np.empty((len(sizes), total, batch_size), dtype=np.int32)
    step_valid = np.zeros((len(sizes), total), dtype=bool)
    fill_cohort_plan(sizes, batch_size, local_epochs, rng, spe, pad_index, sample_idx, step_valid)
    if client_rows is None:
        client_rows = range(len(sizes))
    return CohortPlan(
        sample_idx=sample_idx,
        step_valid=step_valid,
        client_rows=np.asarray(list(client_rows), dtype=np.int32),
        weights=np.asarray(sizes, dtype=np.float32),
        pad_index=pad_index,
        steps_per_epoch=spe,
        local_epochs=local_epochs,
    )


def pad_cohort_plan(
    plan: CohortPlan, multiple: int, num_rows: int | None = None
) -> CohortPlan:
    """Pad the client axis with weight-0 dummy clients to a multiple.

    Dummy clients point every slot at the pad row, have no valid steps and
    zero weight, and borrow row 0; when ``num_rows`` is given and the real
    rows are a contiguous run with room after it, they borrow the rows that
    continue the run instead, so ``client_rows`` stays contiguous.
    """
    if multiple <= 1:
        return plan
    pad = -plan.num_clients % multiple
    if pad == 0:
        return plan
    dummy_rows = np.zeros(pad, np.int32)
    rows = plan.client_rows
    if num_rows is not None and rows.size:
        start = int(rows[0])
        contiguous = np.array_equal(
            rows, np.arange(start, start + rows.size, dtype=rows.dtype)
        )
        if contiguous and start + rows.size + pad <= num_rows:
            dummy_rows = np.arange(
                start + rows.size, start + rows.size + pad, dtype=np.int32
            )
    return CohortPlan(
        sample_idx=np.concatenate(
            [
                plan.sample_idx,
                np.full((pad, *plan.sample_idx.shape[1:]), plan.pad_index, np.int32),
            ]
        ),
        step_valid=np.concatenate(
            [plan.step_valid, np.zeros((pad, plan.total_steps), dtype=bool)]
        ),
        client_rows=np.concatenate([plan.client_rows, dummy_rows]),
        weights=np.concatenate([plan.weights, np.zeros(pad, np.float32)]),
        pad_index=plan.pad_index,
        steps_per_epoch=plan.steps_per_epoch,
        local_epochs=plan.local_epochs,
    )
