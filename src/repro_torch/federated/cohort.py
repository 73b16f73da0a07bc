"""Vectorized cohort training: one batched step trains a whole chunk of clients.

The port of the JAX package's ``federated/cohort.py``.  The sequential
engine (``federated/client.py``) runs one client at a time, so a round
costs one host-paced step per client per batch.  Here the global params are copied onto a leading client axis and
every local step of a round is one batched step for a whole chunk of
clients: one ``(C, B·T, F) @ (C, F, 3N)`` product per GRU layer, the CUDA
``gru_scan`` / ``gru_scan_bwd`` on their client axis, one AdamW update of
the stacked tree.  ``torch.func.vmap`` cannot trace the ctypes kernels, so
the model and AdamW are written over the client axis instead.

Parity with the sequential engine holds by construction:

* the round's batches come from ``build_cohort_schedule``'s fill, which
  consumes the shared numpy generator client-major, one permutation per
  epoch, exactly as the sequential loop does;
* each client has its own ``torch.Generator`` (``client_generators``, the
  port of ``chain_split_keys``) and draws its dropout masks only on its
  valid steps, in the shape and order of its one-client step;
* padding steps are exact no-ops: a client's params, moments and AdamW
  step count are kept bit for bit with ``torch.where`` where its step is not
  valid, and each client's bias corrections and learning rate follow its
  own step count (``AdamW.cohort_coefficients``, computed on the host);
* FedAvg: each client's weighted params go into one float32 accumulator,
  in client order, divided once by the total weight at the end of the
  round.  The order is the clients', not the chunk's (nor its slots'): a
  chunk's ``weighted_sum_stacked`` sums its clients in an order that on the
  card depends on the chunk's size, and local training amplifies that
  last-bit difference (3.3e-6 in params after two rounds of a 4-client
  federation on an H100).

A client's own training does not always keep its bits across step widths:
a batched step's products and reductions may sum in another order at
another batch count.  On an H100 a client's loss and gradients keep their
bits in a step of 2 to 16 clients, but in a step of 8 to 128 of the 189
hospitals they lie up to a few units in the last place from the 189-wide
step's (``tests/test_torch_cuda_kernels.py``); on the CPU some small shapes
differ too.  The eager and the captured step therefore run each step at the
same width, and a round's bits are those of its widths.

With ``dp`` (DP-SGD, ``privacy/dp.py``) a step's gradients come from
``dp_value_and_grad``: each client's batch of B becomes B per-example
clients of batch 1 on the GRU kernels' client axis (C·B of them, bounded
only by ``cohort_chunk`` and memory), clipped, summed and noised per
client; a client's
generator draws its shared dropout masks and then its noise, only on its
valid steps.  ``dp=None`` runs the unprotected step untouched.

A step on which no client of the chunk is valid is skipped on the host (the
reference computes it inside its scan, as a no-op): the results are the
same bits, and a chunk costs ``local_epochs × max_c ceil(n_c / B)`` steps.

A step runs only as wide as the clients still training.  A client's valid
steps are the first ``ceil(n_c / B)`` of each epoch, so staging puts a
chunk's clients in slots by that count, longest first (stable): the
clients with a batch at step t are then slots ``[0, a_t)``.  The step runs
at the smallest width of the chunk's ladder, the powers of two from 2 up to
C and C itself, at or above its last valid slot (``step_width``; a chunk of
one client runs at 1); slots past the width are not touched.  The staged
tensors, the stacked params and the losses are in slot order; the
accumulator takes the clients in client order.

On the card the batched step is captured as CUDA graphs and replayed
(``capture.py``, the port of the reference's jitted round): one set of
static buffers a key (the chunk's client count, the batch's shapes and
dtypes, DP, the staging kind and the resident cohort's data pointers), and
over them one graph a width the chunk's steps use (``step_widths``), each
captured over views ``[:w]`` of the same buffers with slot generators
``[:w]`` registered.  Every graph a round needs is captured at its start,
widest first (the narrower reuse its blocks of the pool), before any plan
is staged, so no staging thread runs during a capture.  A
graph's step (``_static_step``) reads the static buffers (``_CohortStep``):
a rebuilt chunk's ``(x, y, mask)`` at step t, or a plan's ``idx[t]`` with
the chunk's ``limit`` and its offset into the resident cohort (a sliced
chunk's start, so one graph serves every slice); the coefficients and the
validity of step t.  It always takes the ``torch.where`` path, which for a
valid client is the in-place add bit for bit, and every client inside the
width draws from its slot generator; an invalid client's slot is moved back
after the replay, so the participant generators end where the eager step
leaves them.  ``capture.disable_capture()`` runs the eager step on the
card, at the same widths.

Staging (``staging=``) controls how a round's batches reach the device:

* ``"rebuild"`` (the trainer's default, kept as the staging reference):
  each chunk's schedule (x, y, the example mask, step validity and the
  AdamW coefficients) is written step-major into one host buffer and
  uploaded with one pageable copy.
* ``"resident"`` (``Federation``'s default): the federation's train arrays
  are uploaded once (``data/device_cohort.py``) and a chunk stages only its
  plan, step-major in one pinned buffer: int32 flat indices ``(T, C, B)``
  into the resident arrays (``row * (max_n + 1) + sample``), step validity,
  the AdamW coefficients and each client's index limit.  A step gathers
  its batch on the device, one ``index_select`` for x and one for y, and
  its example mask is ``index < limit``: the rebuilt batch, bit for bit.
  With ``prefetch`` and more than one chunk, a ``StagingPipeline`` thread
  builds chunk k+1's plan and copies it on a side stream while chunk k
  trains; the step's stream waits on the copy's event.

With ``donate`` (the port of the reference's donated buffers) the
accumulator is added into in place and a chunk's staged tensors are
released before the next chunk is staged inline; without it the
accumulator is added out of place and the previous chunk's tensors stay
alive until the next is staged.

Several processes (``mesh=``, a ``launch/mesh.py::DataMesh`` or ``"auto"``):
the client axis is split over a ``torch.distributed`` group, SPMD as the
reference's ``shard_map``.  Every rank stages every chunk in order, so the
shared numpy generator moves as in one process, but builds only its own
participants' batches or plans (``skip_cohort_draws`` draws the others'),
and keeps only their dropout generators.  Which rank trains a participant:

* rebuild staging: the reference's layout, each chunk cut into contiguous
  blocks, block k to rank k (``block_of``);
* resident staging: the rank that holds the participant's row (a rank
  uploads only its block of the federation's rows, and a row never moves).
  Under full participation that is the same block of the round.

A rank adds its clients into its float32 accumulator in client order; the
round's one all-reduce then sums the ranks' partial sums, so a sharded round
equals the one-process round within rounding, not bit for bit (as in the
reference).  The per-client losses ride in the same all-reduce, each rank
adding zeros for the clients it did not train (exact), so every rank
returns the same params and losses.  ``cohort_chunk`` bounds a rank's
share of a chunk; DP runs a rank's share as per-example clients.  A rank
with no participant in a chunk (or a round) trains nothing there and adds
zeros to the all-reduce.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.capture import (
    GraphCache,
    StepGraph,
    capture_enabled,
    position,
    set_position,
)
from repro_torch.data.device_cohort import (
    DeviceCohort,
    Layout,
    build_device_cohort,
    fill_cohort_plan,
    host_buffer,
    upload,
)
from repro_torch.data.pipeline import (
    ClientDataset,
    cohort_steps_per_epoch,
    fill_cohort_schedule,
    local_round_steps,
    skip_cohort_draws,
)
from repro_torch.device import resolve_device
from repro_torch.federated.staging import StagingPipeline
from repro_torch.launch.mesh import all_reduce_sum_, block_of, resolve_mesh
from repro_torch.obs.trace import Tracer, resolve_tracer
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.privacy.dp import DPConfig, dp_value_and_grad, resolve_dp
from repro_torch.tree import PyTree, tree_leaves, tree_map

LossFn = Callable[..., Any]  # loss(params, batch, generators) -> (C,) tensor

STAGING_MODES = ("rebuild", "resident")


def client_generators(
    rng: np.random.Generator, n: int, device: torch.device
) -> list[torch.Generator]:
    """``n`` dropout generators on ``device``, seeded from ``rng`` in order.

    The port of ``chain_split_keys``: one seed per participant, in
    participant order, so both engines give client ``i`` of a round the
    same stream.
    """
    seeds = rng.integers(0, np.iinfo(np.int64).max, size=n, dtype=np.int64)
    return [torch.Generator(device=device).manual_seed(int(s)) for s in seeds]


def _ladder(c: int) -> list[int]:
    """The widths a chunk of ``c`` clients runs its steps at: the powers of
    two from 2 up to ``c``, and ``c``; ``[1]`` for one client."""
    if c == 1:
        return [1]
    return [2 ** k for k in range(1, c.bit_length()) if 2 ** k < c] + [c]


def step_width(valid: np.ndarray) -> int:
    """The width of a step whose clients' validity, in slot order, is
    ``valid``: the smallest of the chunk's ladder that holds its last valid
    slot."""
    last = int(np.flatnonzero(valid)[-1]) + 1
    return next(w for w in _ladder(len(valid)) if w >= last)


def _batches(sizes: Sequence[int], batch_size: int) -> np.ndarray:
    """Each client's batches an epoch: its valid steps lead every epoch."""
    return np.asarray([-(-int(n) // batch_size) for n in sizes])


def step_widths(sizes: Sequence[int], batch_size: int) -> list[int]:
    """Every width the steps of a chunk of clients of ``sizes`` run at: the
    ``step_width`` of each step's validity, the slots in order of batches."""
    steps = np.sort(_batches(sizes, batch_size))[::-1]
    return sorted({step_width(steps > j) for j in range(int(steps.max(initial=0)))})


def _slot_order(sizes: Sequence[int], batch_size: int) -> np.ndarray:
    """The clients (indices into ``sizes``) in slot order: by their batches
    an epoch, longest first, stable."""
    return np.argsort(-_batches(sizes, batch_size), kind="stable")


def _placed(part: Sequence[ClientDataset], mine: np.ndarray, order: np.ndarray):
    """The chunk's clients in client order, each with its slot, or None for
    another rank's client; ``order`` is this rank's clients in slot order."""
    slot = np.empty(len(order), dtype=np.int64)
    slot[order] = np.arange(len(order))
    own = iter(slot.tolist())
    for p, m in zip(part, mine):
        yield p, (next(own) if m else None)


@dataclasses.dataclass
class _Chunk:
    """One chunk's staged tensors on the training device, step-major."""

    valid: torch.Tensor         # (T, C) bool
    coefficients: torch.Tensor  # (T, 3, C): AdamW's 1/b1c, 1/b2c, -lr per client
    valid_host: np.ndarray      # (T, C) bool
    weights: np.ndarray         # (C,) float32 n_c
    members: np.ndarray         # (C,) the clients' positions in the round, in slot order
    nbytes: int                 # host bytes staged
    seconds: float              # host seconds staging took

    def batch(self, t: int, w: int | None = None
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Step ``t``'s ``(x, y, mask)`` of slots ``[0, w)`` (all by
        default), each with a leading client axis."""
        raise NotImplementedError


@dataclasses.dataclass
class _RebuiltChunk(_Chunk):
    """Rebuild staging: the whole schedule."""

    x: torch.Tensor     # (T, C, B, *features)
    y: torch.Tensor     # (T, C, B)
    mask: torch.Tensor  # (T, C, B)

    def batch(self, t, w=None):
        return self.x[t, :w], self.y[t, :w], self.mask[t, :w]


@dataclasses.dataclass
class _PlannedChunk(_Chunk):
    """Resident staging: an index plan into the resident cohort."""

    idx: torch.Tensor     # (T, C, B) int32 flat indices into x and y
    limit: torch.Tensor   # (C, 1) int32: a slot is a real example iff idx < limit
    x: torch.Tensor       # (rows * (max_n + 1), *features), a view of the cohort
    y: torch.Tensor       # (rows * (max_n + 1),)
    staged: torch.Tensor  # the plan's device buffer (every view above)
    ready: Any            # the side stream's copy event; None when copied inline
    sliced: bool          # the chunk's rows are a contiguous run, indexed from its start
    cohort: tuple[torch.Tensor, torch.Tensor]  # the whole cohort's x and y, flat
    origin: int           # the flat index in ``cohort`` of ``x[0]`` (0 unless sliced)

    def batch(self, t, w=None):
        ib = self.idx[t, :w]
        flat = ib.reshape(-1)
        x = torch.index_select(self.x, 0, flat).view(*ib.shape, *self.x.shape[1:])
        y = torch.index_select(self.y, 0, flat).view(ib.shape)
        return x, y, (ib < self.limit[:w]).to(torch.float32)


@dataclasses.dataclass
class _Buffers:
    """A captured step's static buffers: the stacked params and AdamW
    moments (updated in place), the step's inputs, coefficients and
    validity, and one slot generator a client; ``cohort`` is the resident
    cohort's flat ``(x, y)`` a plan gathers from (None for a rebuilt
    batch)."""

    params: PyTree
    mu: PyTree
    nu: PyTree
    inputs: dict[str, torch.Tensor]
    coefficients: torch.Tensor  # (3, C)
    keep: torch.Tensor          # (C,) bool
    slots: list[torch.Generator]
    cohort: tuple[torch.Tensor, torch.Tensor] | None

    def narrow(self, w: int) -> "_Buffers":
        """Views of slots ``[0, w)``, the params' views leaves of autograd."""
        return _Buffers(
            params=tree_map(lambda q: q[:w].requires_grad_(True), self.params),
            mu=tree_map(lambda q: q[:w], self.mu),
            nu=tree_map(lambda q: q[:w], self.nu),
            inputs={k: v if k == "origin" else v[:w] for k, v in self.inputs.items()},
            coefficients=self.coefficients[:, :w],
            keep=self.keep[:w],
            slots=self.slots[:w],
            cohort=self.cohort,
        )

    def batch(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The step's ``(x, y, mask)``, each with a leading client axis: the
        rebuilt batch, or the plan's gather from the resident cohort."""
        if self.cohort is None:
            return self.inputs["x"], self.inputs["y"], self.inputs["mask"]
        x, y = self.cohort
        idx = self.inputs["idx"]
        c, b = idx.shape
        flat = (idx + self.inputs["origin"]).view(-1)
        return (torch.index_select(x, 0, flat).view(c, b, *x.shape[1:]),
                torch.index_select(y, 0, flat).view(c, b),
                (idx < self.inputs["limit"]).to(torch.float32))


class _CohortStep:
    """The captured batched steps of a chunk of C clients: one set of static
    buffers (``full``; ``spec`` is ``_batch_spec``'s) and over it one graph a
    width, each over the buffers' views ``[:w]``."""

    def __init__(self, trainer: "CohortTrainer", c: int, params: PyTree, spec: tuple):
        dev, b = trainer.device, trainer.batch_size
        if spec[0] == "resident":
            cohort = spec[1]
            like = {"idx": ((c, b), torch.int32), "limit": ((c, 1), torch.int32),
                    "origin": ((1,), torch.int32)}
        else:
            cohort = None
            _, features, x_dtype, y_dtype = spec
            like = {"x": ((c, b, *features), x_dtype), "y": ((c, b), y_dtype),
                    "mask": ((c, b), torch.float32)}
        stacked = tree_map(lambda q: torch.zeros((c, *q.shape), dtype=q.dtype, device=dev),
                           params)
        self.full = _Buffers(
            params=stacked,
            mu=tree_map(torch.zeros_like, stacked),
            nu=tree_map(torch.zeros_like, stacked),
            inputs={k: torch.zeros(shape, dtype=dtype, device=dev)
                    for k, (shape, dtype) in like.items()},
            coefficients=torch.zeros((3, c), device=dev),
            keep=torch.zeros(c, dtype=torch.bool, device=dev),
            slots=[torch.Generator(device=dev) for _ in range(c)],
            cohort=cohort,
        )
        self.graphs: dict[int, StepGraph] = {}

    def start(self, params: PyTree, chunk: _Chunk) -> None:
        """A chunk's start: every client at ``params``, fresh moments."""
        full = self.full
        with torch.no_grad():
            for s, q in zip(tree_leaves(full.params), tree_leaves(params)):
                s.copy_(q.unsqueeze(0).expand_as(s))
            for m in tree_leaves((full.mu, full.nu)):
                m.zero_()
        if isinstance(chunk, _PlannedChunk):
            full.inputs["limit"].copy_(chunk.limit)
            full.inputs["origin"].fill_(chunk.origin)

    def load(self, chunk: _Chunk, t: int, w: int) -> None:
        """Step ``t``'s inputs of slots ``[0, w)`` into the static buffers."""
        inputs = self.full.inputs
        if isinstance(chunk, _PlannedChunk):
            inputs["idx"][:w].copy_(chunk.idx[t, :w])
        else:
            for k, v in zip(("x", "y", "mask"), chunk.batch(t, w)):
                inputs[k][:w].copy_(v)
        self.full.coefficients[:, :w].copy_(chunk.coefficients[t, :, :w])
        self.full.keep[:w].copy_(chunk.valid[t, :w])

    def result(self) -> PyTree:
        return tree_map(lambda q: q.clone(), self.full.params)


def _mean_last_losses(losses: list[torch.Tensor], valid: list[np.ndarray], c: int,
                      tracer: Tracer) -> np.ndarray:
    """Each client's mean loss over its valid steps of the last epoch (NaN
    without any), from one readback (a ``readback`` span of ``tracer``); a
    step's losses cover its width, the slots past it being invalid there."""
    per_client = np.full(c, np.nan)
    if losses:
        with tracer.span("readback"):
            flat = torch.cat(losses).double().cpu().numpy()
        stacked = np.zeros((len(losses), c))
        widths = [len(loss) for loss in losses]
        for row, part in zip(stacked, np.split(flat, np.cumsum(widths)[:-1])):
            row[: len(part)] = part
        valid_last = np.stack(valid)
        per_client = np.where(valid_last, stacked, 0.0).sum(axis=0) / np.maximum(
            valid_last.sum(axis=0), 1
        )
    return per_client.astype(np.float32)


@dataclasses.dataclass
class CohortTrainer:
    """Trains a whole cohort of clients per round in batched steps."""

    loss_fn: LossFn
    optimizer: AdamW
    batch_size: int
    local_epochs: int
    # Max clients per batched step; None = the whole cohort at once.
    cohort_chunk: int | None = None
    # The client axis over several processes: a launch/mesh.py DataMesh, or
    # "auto" (the default group's world when more than one rank is
    # initialized, else None).
    mesh: Any = None
    donate: bool = True
    # "rebuild" re-stages the whole schedule every round (the staging
    # reference); "resident" keeps the federation's train arrays on the
    # device and stages int32 index plans.  Federation defaults to "resident".
    staging: str = "rebuild"
    # Resident staging: build and copy chunk k+1's plan on a thread (and a
    # side stream on the card) while chunk k trains.  Engages only when a
    # round has more than one chunk; the same bits either way.
    prefetch: bool = True
    # Resident staging: bound the device cohort to this many bytes; above
    # it, client rows live in an LRU pool filled per round.  None = all.
    resident_budget_bytes: int | None = None
    # Resident staging: index a chunk whose rows are one contiguous run from
    # the run's start (counted in ``slice_chunks``).  The same bits either way.
    slice_fastpath: bool = True
    # Record the round's peak device memory (resets the card's peak counter).
    track_stats: bool = True
    # DP-SGD (privacy/dp.py): a DPConfig, a job-spec dict, or None, which
    # keeps the unprotected step untouched.  Under DP a chunk of C clients
    # at batch B runs the GRU kernels on C·B per-example clients.
    dp: DPConfig | dict | None = None
    # Observability: a repro_torch.obs Tracer records per-chunk "stage" spans
    # (on the staging thread when prefetching), the pipeline's
    # "prefetch_wait" stalls, the device cohort's "pool_upload" spans, each
    # chunk's "readback" of its losses and, on the captured path, a
    # "cohort_step" span of each step's host work (args t, its width and
    # held, the padding slots inside the width) and, on the card, a
    # "cohort_step" span of its replay on the device clock (t, width).
    # None resolves to the shared no-op tracer.
    tracer: Any = None
    # Where to train: None is the card; "cpu" runs the plain versions.
    device: str | torch.device | None = None
    # Staging accounting of the most recent train_cohort call.
    last_round_stats: dict[str, Any] | None = dataclasses.field(default=None, init=False)

    def __post_init__(self) -> None:
        if self.staging not in STAGING_MODES:
            raise ValueError(f"unknown staging {self.staging!r}; choose from {STAGING_MODES}")
        self.tracer = resolve_tracer(self.tracer)
        self.dp = resolve_dp(self.dp)
        self._dp_grad = None if self.dp is None else dp_value_and_grad(self.loss_fn, self.dp)
        self.device = resolve_device(self.device)
        self.mesh = resolve_mesh(self.mesh)
        self._device_cohort: DeviceCohort | None = None
        # Resident plans: two host buffers (pinned on the card), chunk k in
        # buffer k % 2, reused round after round; the event of each one's
        # last copy, which must finish before it is refilled.
        self._plan_buffers: list[torch.Tensor | None] = [None, None]
        self._plan_copied: list[Any] = [None, None]
        self._side_stream = None
        # The captured batched steps (on the card), one a key.
        self.graphs = GraphCache(self.device, self.tracer, "cohort_step")

    # ------------------------------------------------------------------
    # staging
    # ------------------------------------------------------------------

    @property
    def device_cohort(self) -> DeviceCohort | None:
        return self._device_cohort

    def attach_device_cohort(self, clients: Sequence[ClientDataset]) -> DeviceCohort:
        """Upload a federation's train arrays once for resident staging.

        Rounds over any subset of ``clients`` then stage only index plans.
        ``Federation.run`` calls this with the recruited federation before
        round one; a direct ``train_cohort`` caller may skip it, and the
        first resident round then attaches its own cohort.
        """
        self._device_cohort = build_device_cohort(
            clients,
            mesh=self.mesh,
            resident_budget_bytes=self.resident_budget_bytes,
            tracer=self.tracer,
            device=self.device,
        )
        return self._device_cohort

    def _ensure_device_cohort(self, clients: Sequence[ClientDataset]) -> DeviceCohort:
        dc = self._device_cohort
        if dc is not None and all(dc.owns(c) for c in clients):
            return dc
        return self.attach_device_cohort(clients)

    def _stage_rebuild(
        self, part: Sequence[ClientDataset], rng: np.random.Generator, spe: int,
        mine: np.ndarray | None = None,
    ) -> _RebuiltChunk:
        """Build the schedule of the chunk's clients marked ``mine`` (all by
        default) into one host buffer and upload it with one copy.  Consumes
        ``rng`` for the whole chunk: chunks must be staged in order."""
        t0 = time.perf_counter()
        mine = np.ones(len(part), dtype=bool) if mine is None else mine
        own = [p for p, m in zip(part, mine) if m]
        c, b, t = len(own), self.batch_size, spe * self.local_epochs
        order = _slot_order([p.n_train for p in own], b)
        x0, y0 = own[0].train.x, own[0].train.y
        layout = Layout({
            "x": ((t, c, b, *x0.shape[1:]), x0.dtype),
            "y": ((t, c, b), y0.dtype),
            "mask": ((t, c, b), np.float32),
            "valid": ((t, c), np.bool_),
            "coefficients": ((t, 3, c), np.float32),
        })
        buf = np.zeros(layout.nbytes, dtype=np.uint8)
        host = layout.host_views(buf)
        # The fill writes client-major (C, T, ...) views of the step-major buffer.
        views = [host[k].swapaxes(0, 1) for k in ("x", "y", "mask", "valid")]
        for p, at in _placed(part, mine, order):
            if at is None:
                skip_cohort_draws([p.n_train], self.local_epochs, rng)
                continue
            fill_cohort_schedule([p.train], b, self.local_epochs, rng, spe,
                                 *(v[at : at + 1] for v in views))
        valid_host = host["valid"].copy()
        host["coefficients"][...] = self.optimizer.cohort_coefficients(valid_host.T)
        staged = layout.device_views(torch.from_numpy(buf).to(self.device))
        return _RebuiltChunk(
            **staged,
            valid_host=valid_host,
            weights=np.asarray([own[i].n_train for i in order], dtype=np.float32),
            members=np.flatnonzero(mine)[order],
            nbytes=layout.nbytes,
            seconds=time.perf_counter() - t0,
        )

    def _stage_plan(
        self,
        part: Sequence[ClientDataset],
        rng: np.random.Generator,
        spe: int,
        dc: DeviceCohort,
        slot: int,
        side: Any,
        mine: np.ndarray | None = None,
    ) -> _PlannedChunk:
        """Build the index plan of the chunk's clients marked ``mine`` (all
        by default) into host buffer ``slot`` and copy it to the device (on
        ``side``, a stream, when given).  Consumes ``rng`` for the whole
        chunk: chunks must be staged in order."""
        t0 = time.perf_counter()
        mine = np.ones(len(part), dtype=bool) if mine is None else mine
        own = [p for p, m in zip(part, mine) if m]
        c, b, t = len(own), self.batch_size, spe * self.local_epochs
        width = dc.pad_index + 1
        if dc.num_rows * width > np.iinfo(np.int32).max:
            raise ValueError(
                f"a device cohort of {dc.num_rows} rows of {width} samples is above "
                "the int32 index range of a plan"
            )
        order = _slot_order([p.n_train for p in own], b)
        rows = np.asarray([dc.row_of(own[i]) for i in order], dtype=np.int64)
        first = int(rows.min())
        contiguous = np.array_equal(np.sort(rows), np.arange(first, first + c))
        full = c == dc.num_rows and contiguous and first == 0
        sliced = self.slice_fastpath and contiguous and not full
        r0 = first if sliced else 0
        base = (rows - r0) * width
        sizes = np.asarray([own[i].n_train for i in order], dtype=np.int64)
        layout = Layout({
            "idx": ((t, c, b), np.int32),
            "valid": ((t, c), np.bool_),
            "coefficients": ((t, 3, c), np.float32),
            "limit": ((c, 1), np.int32),
        })
        host = self._plan_buffer(slot, layout.nbytes)[: layout.nbytes]
        views = layout.host_views(host.numpy())
        views["valid"][...] = False
        idx, valid = views["idx"].swapaxes(0, 1), views["valid"].swapaxes(0, 1)
        for p, at in _placed(part, mine, order):
            if at is None:
                skip_cohort_draws([p.n_train], self.local_epochs, rng)
                continue
            one = slice(at, at + 1)
            fill_cohort_plan(sizes[one], b, self.local_epochs, rng, spe, dc.pad_index,
                             idx[one], valid[one], base=base[one])
        valid_host = views["valid"].copy()
        views["coefficients"][...] = self.optimizer.cohort_coefficients(valid_host.T)
        views["limit"][:, 0] = base + sizes
        staged, ready = self._copy_plan(host, slot, side)
        plan = layout.device_views(staged)
        x, y = (dc.x[r0 : r0 + c], dc.y[r0 : r0 + c]) if sliced else (dc.x, dc.y)
        return _PlannedChunk(
            valid=plan["valid"],
            coefficients=plan["coefficients"],
            valid_host=valid_host,
            weights=sizes.astype(np.float32),
            members=np.flatnonzero(mine)[order],
            nbytes=layout.nbytes,
            seconds=time.perf_counter() - t0,
            idx=plan["idx"],
            limit=plan["limit"],
            x=x.flatten(0, 1),
            y=y.flatten(0, 1),
            staged=staged,
            ready=ready,
            sliced=sliced,
            cohort=(dc.x.flatten(0, 1), dc.y.flatten(0, 1)),
            origin=r0 * width,
        )

    def _plan_buffer(self, slot: int, nbytes: int) -> torch.Tensor:
        """Host buffer ``slot``, at least ``nbytes`` long, once its last copy
        to the device has finished reading it."""
        copied = self._plan_copied[slot]
        if copied is not None:
            copied.synchronize()
        buf = self._plan_buffers[slot]
        if buf is None or buf.numel() < nbytes:
            buf = self._plan_buffers[slot] = host_buffer(nbytes, self.device)
        return buf

    def _copy_plan(self, host: torch.Tensor, slot: int, side: Any) -> tuple[torch.Tensor, Any]:
        """Copy a plan to the device: on the card asynchronously, on ``side``
        when given (then the returned event marks the copy's end for the
        consuming stream), else on the current stream."""
        if self.device.type != "cuda":
            return upload(host, self.device), None
        stream = side if side is not None else torch.cuda.current_stream(self.device)
        with torch.cuda.stream(stream):
            staged = upload(host, self.device)
            copied = torch.cuda.Event()
            copied.record(stream)
        self._plan_copied[slot] = copied
        return staged, copied if side is not None else None

    # ------------------------------------------------------------------
    # one chunk's local training
    # ------------------------------------------------------------------

    def _batch_spec(self, chunk: _Chunk | None = None,
                    clients: Sequence[ClientDataset] = (), dc: DeviceCohort | None = None) -> tuple:
        """What a step's graph reads of a chunk's batches: ``("resident",
        (x, y))``, the resident cohort's flat arrays it gathers from, or
        ``("rebuild", features, x dtype, y dtype)``; from a staged chunk or,
        before staging, from the round's clients and device cohort."""
        if isinstance(chunk, _PlannedChunk):
            return ("resident", chunk.cohort)
        if chunk is not None:
            return ("rebuild", tuple(chunk.x.shape[3:]), chunk.x.dtype, chunk.y.dtype)
        if dc is not None:
            return ("resident", (dc.x.flatten(0, 1), dc.y.flatten(0, 1)))
        x, y = clients[0].train.x, clients[0].train.y
        return ("rebuild", tuple(x.shape[1:]), torch.from_numpy(x[:0]).dtype,
                torch.from_numpy(y[:0]).dtype)

    def _cohort_step(self, c: int, params: PyTree, spec: tuple) -> _CohortStep:
        """The captured step of ``c`` clients for ``spec``, captured when new.

        Its key: the client count, the batch size, the params' and the
        batch's shapes and dtypes, DP on or off, the staging kind, and the
        data pointers of the resident arrays it gathers from."""
        if spec[0] == "resident":
            x, y = spec[1]
            batch_key = ("resident", tuple(x.shape), x.dtype, y.dtype, x.data_ptr(), y.data_ptr())
        else:
            batch_key = spec
        key = (c, self.batch_size, batch_key, self.dp is not None,
               tuple((tuple(q.shape), q.dtype) for q in tree_leaves(params)))
        return self.graphs.lookup(key, lambda: _CohortStep(self, c, params, spec))

    def _capture_width(self, s: _CohortStep, w: int) -> None:
        """``s``'s graph of width ``w`` over its buffers' views ``[:w]``,
        captured when new.  On the card ``s`` holds no reference back to
        the trainer (a CUDA graph keeps no body), so a trainer that goes
        frees its device memory at once."""
        if w not in s.graphs:
            view = s.full.narrow(w)
            s.graphs[w] = self.graphs.capture(lambda: self._static_step(view), view.slots)

    def _static_step(self, s: _Buffers) -> torch.Tensor:
        """The step a graph captures: one batched step over ``s``'s static
        buffers, every client drawing from its slot; the params and moments
        are updated in place where the step is valid (``torch.where`` for
        every client).  Returns the per-client losses."""
        leaves = tree_leaves(s.params)
        if self._dp_grad is None:
            loss = self.loss_fn(s.params, s.batch(), s.slots)
            grads_iter = iter(torch.autograd.grad(loss.sum(), leaves))
            grads = tree_map(lambda _: next(grads_iter), s.params)
        else:
            loss, grads = self._dp_grad(s.params, s.batch(), s.slots)
        updates, new_state = self.optimizer.update_stacked(
            grads, AdamWState(step=0, mu=s.mu, nu=s.nu), s.params, s.coefficients
        )
        with torch.no_grad():
            keep = s.keep

            def where(new, old):
                return torch.where(keep.view(len(keep), *([1] * (old.dim() - 1))), new, old)

            for q, u in zip(leaves, tree_leaves(updates)):
                q.copy_(where(q + u, q))
            for old, new in zip(tree_leaves((s.mu, s.nu)),
                                tree_leaves((new_state.mu, new_state.nu))):
                old.copy_(where(new, old))
        return loss.detach()

    def _train_chunk_captured(
        self, params: PyTree, chunk: _Chunk, generators: Sequence[torch.Generator]
    ) -> tuple[PyTree, np.ndarray, int, int]:
        """``_train_chunk`` through the chunk's captured steps."""
        t_total, c = chunk.valid_host.shape
        spe = t_total // self.local_epochs
        s = self._cohort_step(c, params, self._batch_spec(chunk))
        s.start(params, chunk)
        slots = s.full.slots
        for slot, g in zip(slots, generators):
            set_position(slot, position(g))
        last_losses: list[torch.Tensor] = []
        last_valid: list[np.ndarray] = []
        executed = slot_steps = 0
        for t in range(t_total):
            valid = chunk.valid_host[t]
            if not valid.any():
                continue  # every client pads here: a no-op for all of them
            w = step_width(valid)
            executed += 1
            slot_steps += w
            pads = [slot for slot, v in zip(slots[:w], valid[:w]) if not v]
            with self.tracer.span("cohort_step", t=t, width=w, held=len(pads)):
                s.load(chunk, t, w)
                # A client that pads here draws nothing: its slot goes back.
                held = [(slot, position(slot)) for slot in pads]
                loss = s.graphs[w].replay(t=t, width=w)
                for slot, pos in held:
                    set_position(slot, pos)
            if t >= t_total - spe:
                last_losses.append(loss)
                last_valid.append(valid)
        for slot, g in zip(slots, generators):
            set_position(g, position(slot))
        losses = _mean_last_losses(last_losses, last_valid, c, self.tracer)
        return s.result(), losses, executed, slot_steps

    def _train_chunk(
        self, params: PyTree, chunk: _Chunk, generators: Sequence[torch.Generator]
    ) -> tuple[PyTree, np.ndarray, int, int]:
        """All local epochs of a chunk's clients from broadcast copies of
        ``params``, each step at its ``step_width``.  Returns the stacked
        trained params and each client's mean loss over its last epoch's
        valid steps (both in slot order), the steps executed and the sum of
        their widths."""
        if capture_enabled(self.device):
            return self._train_chunk_captured(params, chunk, generators)
        t_total, c = chunk.valid_host.shape
        spe = t_total // self.local_epochs
        p = tree_map(lambda q: q.detach().unsqueeze(0).expand(c, *q.shape).clone(), params)
        mu, nu = tree_map(torch.zeros_like, p), tree_map(torch.zeros_like, p)
        last_losses: list[torch.Tensor] = []
        last_valid: list[np.ndarray] = []
        executed = slot_steps = 0
        for t in range(t_total):
            valid = chunk.valid_host[t]
            if not valid.any():
                continue  # every client pads here: a no-op for all of them
            w = step_width(valid)
            executed += 1
            slot_steps += w
            pw = tree_map(lambda q: q[:w].requires_grad_(True), p)
            leaves = tree_leaves(pw)
            gens = [g if v else None for g, v in zip(generators[:w], valid[:w])]
            if self._dp_grad is None:
                loss = self.loss_fn(pw, chunk.batch(t, w), gens)
                grads_flat = torch.autograd.grad(loss.sum(), leaves)
                grads_iter = iter(grads_flat)
                grads = tree_map(lambda _: next(grads_iter), pw)
            else:
                loss, grads = self._dp_grad(pw, chunk.batch(t, w), gens)
            mw, nw = (tree_map(lambda m: m[:w], m) for m in (mu, nu))
            updates, new_state = self.optimizer.update_stacked(
                grads, AdamWState(step=0, mu=mw, nu=nw), pw, chunk.coefficients[t, :, :w]
            )
            moments = tree_leaves((mw, nw))
            with torch.no_grad():
                new_moments = tree_leaves((new_state.mu, new_state.nu))
                if valid[:w].all():  # the common step: no client to hold back, no where()
                    for q, u in zip(leaves, tree_leaves(updates)):
                        q.add_(u)
                    for old, new in zip(moments, new_moments):
                        old.copy_(new)
                else:
                    keep = chunk.valid[t, :w]

                    def where(new, old):
                        return torch.where(keep.view(w, *([1] * (old.dim() - 1))), new, old)

                    for q, u in zip(leaves, tree_leaves(updates)):
                        q.copy_(where(q + u, q))
                    for old, new in zip(moments, new_moments):
                        old.copy_(where(new, old))
            if t >= t_total - spe:
                last_losses.append(loss.detach())
                last_valid.append(valid)
        losses = _mean_last_losses(last_losses, last_valid, c, self.tracer)
        return p, losses, executed, slot_steps

    # ------------------------------------------------------------------
    # the round
    # ------------------------------------------------------------------

    def train_cohort(
        self,
        params: PyTree,
        clients: Sequence[ClientDataset],
        rng: np.random.Generator,
        generators: Sequence[torch.Generator],
        steps_per_epoch: int | None = None,
    ) -> tuple[PyTree, np.ndarray, int]:
        """One FedAvg round over ``clients``.

        ``generators`` holds one dropout generator per client, in client
        order (``client_generators``).  Pass a federation-wide
        ``steps_per_epoch`` to fix the schedule's step axis across rounds.
        Returns the round's aggregated params, per-client mean local losses,
        and the number of *real* (unpadded) local steps.
        """
        if len(generators) != len(clients):
            raise ValueError("need exactly one generator per client")
        if self.cohort_chunk is not None and self.cohort_chunk <= 0:
            raise ValueError(f"cohort_chunk must be positive, got {self.cohort_chunk}")
        chunk = self.cohort_chunk or len(clients)
        sizes = [cl.n_train for cl in clients]
        spe = steps_per_epoch or cohort_steps_per_epoch(sizes, self.batch_size)
        cuda = self.device.type == "cuda"
        resident = self.staging == "resident"
        # Under a mesh, resident staging trains a client on the rank holding
        # its row, so the rows are attached before the owners are known.
        dcohort = self._ensure_device_cohort(clients) if resident else None
        starts = range(0, len(clients), chunk)
        owners = self._owners(clients, starts, chunk, dcohort)
        rank = 0 if self.mesh is None else self.mesh.rank
        # The largest share of a chunk any rank trains; under DP each of its
        # clients is batch_size per-example clients.
        share = max(int(np.bincount(owners[s : s + chunk]).max()) for s in starts)
        launched = share * (1 if self.dp is None else self.batch_size)
        pooled = resident and dcohort.is_pooled
        pool_before = (0, 0, 0, 0)
        if pooled:
            # One residency pass per round, before any plan is staged: rows
            # stay put for the whole round, so the staging thread's plans
            # never race an eviction.
            pool_before = (dcohort.uploads, dcohort.evictions, dcohort.bytes_uploaded,
                           dcohort.hits)
            dcohort.ensure_resident(clients)
        if cuda and self.track_stats:
            torch.cuda.reset_peak_memory_stats(self.device)
        graphs_before = self.graphs.counts()
        if capture_enabled(self.device):
            # Every capture the round needs happens here, before any plan is
            # staged: no staging thread may run during a capture.
            spec = self._batch_spec(clients=clients, dc=dcohort)
            for start in starts:
                own = [n for n, o in zip(sizes[start : start + chunk],
                                         owners[start : start + chunk]) if o == rank]
                if own:
                    # Widest first: the narrower graphs reuse its pool blocks.
                    s = self._cohort_step(len(own), params, spec)
                    for w in reversed(step_widths(own, self.batch_size)):
                        self._capture_width(s, w)

        prefetch = resident and self.prefetch and len(starts) > 1
        side = None
        if prefetch and cuda:
            if self._side_stream is None:
                self._side_stream = torch.cuda.Stream(self.device)
            side = self._side_stream

        def stage(item: tuple[int, int]) -> _Chunk | None:
            index, start = item
            part = clients[start : start + chunk]
            mine = owners[start : start + chunk] == rank
            # The span lands on whichever thread stages: inline here, or the
            # StagingPipeline's producer when prefetching.
            with self.tracer.span("stage", track="staging", chunk=int(start)):
                if not mine.any():  # none of the chunk's clients is this rank's
                    skip_cohort_draws([p.n_train for p in part], self.local_epochs, rng)
                    return None
                if resident:
                    return self._stage_plan(part, rng, spe, dcohort, index % 2, side, mine)
                return self._stage_rebuild(part, rng, spe, mine)

        pipeline: StagingPipeline | None = None
        if prefetch:
            pipeline = StagingPipeline(stage, list(enumerate(starts)), tracer=self.tracer)
            staged_chunks = iter(pipeline)
        else:
            staged_chunks = (stage(item) for item in enumerate(starts))

        acc = tree_map(
            lambda q: torch.zeros(q.shape, dtype=torch.promote_types(q.dtype, torch.float32),
                                  device=self.device),
            params,
        )
        # Every rank divides by the whole round's weight, summed as one
        # process sums it: chunk by chunk in float32.
        total_weight = 0.0
        for start in starts:
            total_weight += float(np.asarray(sizes[start : start + chunk], np.float32).sum())
        bytes_staged, num_chunks, executed, stage_s, slice_chunks, trained = 0, 0, 0, 0.0, 0, 0
        slot_steps = 0
        per_losses = np.full(len(clients), np.nan, dtype=np.float32)
        held: _Chunk | None = None
        try:
            for start, staged in zip(starts, staged_chunks):
                held = None  # without donation the previous chunk lived until here
                num_chunks += 1
                if staged is None:
                    continue
                if isinstance(staged, _PlannedChunk):
                    slice_chunks += staged.sliced
                    if staged.ready is not None:
                        current = torch.cuda.current_stream(self.device)
                        current.wait_event(staged.ready)
                        staged.staged.record_stream(current)
                members = start + staged.members
                stacked, losses, steps, widths = self._train_chunk(
                    params, staged, [generators[i] for i in members]
                )
                acc = self._accumulate(acc, stacked, staged.weights, staged.members)
                if not self.donate:
                    held = staged
                per_losses[members] = losses
                bytes_staged += staged.nbytes
                stage_s += staged.seconds
                executed += steps
                slot_steps += widths
                trained += len(members)
                del stacked, staged
        finally:
            if pipeline is not None:
                # Re-raise an uncollected staging error only when the round is
                # not already propagating another one.
                pipeline.close(raise_pending=sys.exc_info()[0] is None)
        del held
        if self.mesh is not None:
            per_losses[owners != rank] = 0.0  # the other ranks' clients
            acc, per_losses = self._all_reduce(acc, per_losses)

        new_params = tree_map(lambda a, q: (a / total_weight).to(q.dtype), acc, params)
        self.last_round_stats = {
            "chunks": num_chunks,
            "shards": 1 if self.mesh is None else self.mesh.size,
            # This rank and the participants it trained (all of them without a mesh).
            "rank": rank,
            "rank_clients": trained,
            "donated": self.donate,
            "staging": self.staging,
            "prefetch": pipeline is not None,
            "bytes_staged": bytes_staged,
            "bytes_resident": dcohort.nbytes if resident else 0,
            "plans_prefetched": pipeline.prefetched if pipeline is not None else 0,
            # Host seconds building and copying the chunks' schedules or plans
            # (on the staging thread when prefetching).
            "stage_seconds": stage_s,
            # The card's peak allocation over the round (the resident cohort
            # included); None on the CPU or without track_stats.
            "peak_device_bytes": (torch.cuda.max_memory_allocated(self.device)
                                  if cuda and self.track_stats else None),
            # This rank's batched steps, and the sum of their widths (the
            # client slots they ran).
            "cohort_steps": executed,
            "cohort_slot_steps": slot_steps,
            # Under DP, the largest share of a chunk's per-example clients on
            # the GRU kernels' client axis (share × batch); 0 without DP.
            "per_example_clients": 0 if self.dp is None else launched,
            "slice_chunks": slice_chunks,
            "pool": pooled,
            "pool_rows": dcohort.pool_rows if pooled else 0,
            "pool_uploads": dcohort.uploads - pool_before[0] if pooled else 0,
            "pool_evictions": dcohort.evictions - pool_before[1] if pooled else 0,
            "pool_bytes_uploaded": dcohort.bytes_uploaded - pool_before[2] if pooled else 0,
            "pool_hits": dcohort.hits - pool_before[3] if pooled else 0,
            # The round's captures and replays of its steps, the seconds its
            # captures took, and the bytes of the trainer's graph pool (all
            # 0 when the round ran eagerly).
            **self.graphs.round_stats(graphs_before),
        }
        real_steps = sum(local_round_steps(n, self.batch_size, self.local_epochs) for n in sizes)
        return new_params, per_losses, real_steps

    def _owners(
        self, clients: Sequence[ClientDataset], starts: range, chunk: int,
        dcohort: DeviceCohort | None,
    ) -> np.ndarray:
        """The rank that trains each participant: 0 without a mesh; under a
        mesh the rank holding its row (resident staging), else its chunk's
        block (``block_of``)."""
        owners = np.zeros(len(clients), dtype=np.int64)
        if self.mesh is None:
            return owners
        if dcohort is not None:
            return np.asarray([dcohort.owner_of(c) for c in clients], dtype=np.int64)
        for start in starts:
            n = min(chunk, len(clients) - start)
            for k in range(self.mesh.size):
                owners[start + np.asarray(block_of(n, self.mesh, k), dtype=np.int64)] = k
        return owners

    def _all_reduce(self, acc: PyTree, losses: np.ndarray) -> tuple[PyTree, np.ndarray]:
        """The round's one collective: every rank's accumulator and
        per-client losses (zeros where another rank trained the client)
        summed as one flat buffer."""
        leaves = tree_leaves(acc)
        flat = torch.cat([*(a.reshape(-1) for a in leaves),
                          torch.from_numpy(losses).to(self.device)])
        parts = torch.split(all_reduce_sum_(flat, self.mesh), [*(a.numel() for a in leaves),
                                                               len(losses)])
        it = iter(parts)
        summed = tree_map(lambda a: next(it).view(a.shape).to(a.dtype), acc)
        return summed, parts[-1].cpu().numpy().astype(np.float32)

    def _accumulate(self, acc: PyTree, stacked: PyTree, weights: np.ndarray,
                    members: np.ndarray) -> PyTree:
        """``acc + sum_c w_c * stacked[c]``, slot by slot in client order (by
        ``members``): in place with ``donate``, else out of place (the same
        bits either way)."""
        for c in np.argsort(members).tolist():
            w = float(weights[c])
            if self.donate:
                for a, q in zip(tree_leaves(acc), tree_leaves(stacked)):
                    a.add_(q[c], alpha=w)
            else:
                acc = tree_map(lambda a, q: torch.add(a, q[c], alpha=w), acc, stacked)
        return acc

    def steps_per_round(self, client: ClientDataset) -> int:
        return local_round_steps(client.n_train, self.batch_size, self.local_epochs)
