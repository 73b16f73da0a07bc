"""Vectorized cohort training: one batched step trains a whole chunk of clients.

The port of the JAX package's ``federated/cohort.py`` with
``staging="rebuild"``.  The sequential engine (``federated/client.py``) runs
one client at a time, so a round costs one host-paced step per client per
batch.  Here the global params are copied onto a leading client axis and
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
  round.  The order is the clients', not the chunk's: a chunk's
  ``weighted_sum_stacked`` sums its clients in an order that on the card
  depends on the chunk's size, and local training amplifies that last-bit
  difference (3.3e-6 in params after two rounds of a 4-client federation
  on an H100).  A client's own training gives the same bits in any chunk
  of two or more clients (``tests/test_torch_cuda_kernels.py``), so a
  chunked round gives the unchunked round's params.

A step on which no client of the chunk is valid is skipped on the host (the
reference computes it inside its scan, as a no-op): the results are the
same bits, and a chunk costs ``local_epochs × max_c ceil(n_c / B)`` steps.

Staging: each chunk's schedule (x, y, the example mask, step validity and
the AdamW coefficients) is written step-major into one host buffer and
uploaded with one copy.  With ``donate`` (the port of the reference's
donated buffers) the accumulator is added into in place and a chunk's
staged tensors are released before the next chunk is staged; without it
the accumulator is added out of place and the previous chunk's tensors
stay alive until the next is staged.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.data.pipeline import (
    ClientDataset,
    cohort_steps_per_epoch,
    fill_cohort_schedule,
    local_round_steps,
)
from repro_torch.device import resolve_device
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.tree import PyTree, tree_leaves, tree_map

LossFn = Callable[..., Any]  # loss(params, batch, generators) -> (C,) tensor

STAGING_MODES = ("rebuild", "resident")
# The GRU kernels put the client axis on the grid's y dimension.
MAX_CHUNK = 65535
_ALIGN = 64


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


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


@dataclasses.dataclass
class _Chunk:
    """One chunk's staged schedule on the training device, step-major."""

    x: torch.Tensor             # (T, C, B, *features)
    y: torch.Tensor             # (T, C, B)
    mask: torch.Tensor          # (T, C, B)
    valid: torch.Tensor         # (T, C) bool
    coefficients: torch.Tensor  # (T, 3, C): AdamW's 1/b1c, 1/b2c, -lr per client
    valid_host: np.ndarray      # (T, C) bool
    weights: np.ndarray         # (C,) float32 n_c
    nbytes: int


@dataclasses.dataclass
class CohortTrainer:
    """Trains a whole cohort of clients per round in batched steps."""

    loss_fn: LossFn
    optimizer: AdamW
    batch_size: int
    local_epochs: int
    # Max clients per batched step; None = the whole cohort at once.
    cohort_chunk: int | None = None
    # Options of the reference that later slices of the port bring.
    mesh: Any = None
    donate: bool = True
    staging: str = "rebuild"
    dp: Any = None
    tracer: Any = None
    # Where to train: None is the card; "cpu" runs the plain versions.
    device: str | torch.device | None = None
    # Staging accounting of the most recent train_cohort call.
    last_round_stats: dict[str, Any] | None = dataclasses.field(default=None, init=False)

    def __post_init__(self) -> None:
        if self.staging not in STAGING_MODES:
            raise ValueError(f"unknown staging {self.staging!r}; choose from {STAGING_MODES}")
        unported = (
            (self.staging == "resident", "staging='resident' (device-resident cohorts)", 2),
            (self.mesh is not None, "mesh= (the client axis over several GPUs)", 9),
            (self.dp is not None, "dp= (DP-SGD, repro.privacy)", 6),
            (self.tracer is not None, "tracer= (repro.obs)", 8),
        )
        for asked, what, item in unported:
            if asked:
                raise NotImplementedError(
                    f"CohortTrainer {what} is not ported yet (ROADMAP Queue 1 item {item})"
                )
        self.device = resolve_device(self.device)

    # ------------------------------------------------------------------
    # staging
    # ------------------------------------------------------------------

    def _stage(self, part: Sequence[ClientDataset], rng: np.random.Generator, spe: int) -> _Chunk:
        """Build one chunk's schedule into one host buffer and upload it with
        one copy.  Consumes ``rng``: chunks must be staged in order."""
        c, b, t = len(part), self.batch_size, spe * self.local_epochs
        x0, y0 = part[0].train.x, part[0].train.y
        layout = {
            "x": ((t, c, b, *x0.shape[1:]), x0.dtype),
            "y": ((t, c, b), y0.dtype),
            "mask": ((t, c, b), np.dtype(np.float32)),
            "valid": ((t, c), np.dtype(np.bool_)),
            "coefficients": ((t, 3, c), np.dtype(np.float32)),
        }
        offsets, total = {}, 0
        for name, (shape, dtype) in layout.items():
            offsets[name] = total
            total += -(-int(np.prod(shape)) * dtype.itemsize // _ALIGN) * _ALIGN
        buf = np.zeros(total, dtype=np.uint8)

        def host_view(name):
            shape, dtype = layout[name]
            n = int(np.prod(shape)) * dtype.itemsize
            return buf[offsets[name] : offsets[name] + n].view(dtype).reshape(shape)

        host = {name: host_view(name) for name in layout}
        # The fill writes client-major (C, T, ...) views of the step-major buffer.
        fill_cohort_schedule(
            [p.train for p in part], b, self.local_epochs, rng, spe,
            host["x"].swapaxes(0, 1), host["y"].swapaxes(0, 1),
            host["mask"].swapaxes(0, 1), host["valid"].swapaxes(0, 1),
        )
        valid_host = host["valid"].copy()
        host["coefficients"][...] = self.optimizer.cohort_coefficients(valid_host.T)
        staged = torch.from_numpy(buf).to(self.device)

        def device_view(name):
            shape, dtype = layout[name]
            n = int(np.prod(shape)) * dtype.itemsize
            flat = staged[offsets[name] : offsets[name] + n]
            return flat.view(_torch_dtype(dtype)).view(shape)

        return _Chunk(
            **{name: device_view(name) for name in layout},
            valid_host=valid_host,
            weights=np.asarray([p.n_train for p in part], dtype=np.float32),
            nbytes=total,
        )

    # ------------------------------------------------------------------
    # one chunk's local training
    # ------------------------------------------------------------------

    def _train_chunk(
        self, params: PyTree, chunk: _Chunk, generators: Sequence[torch.Generator]
    ) -> tuple[PyTree, np.ndarray, int]:
        """All local epochs of a chunk's clients from broadcast copies of
        ``params``.  Returns the stacked trained params, each client's mean
        loss over its last epoch's valid steps, and the steps executed."""
        t_total, c = chunk.valid_host.shape
        spe = t_total // self.local_epochs
        p = tree_map(
            lambda q: q.detach().unsqueeze(0).expand(c, *q.shape).clone().requires_grad_(True),
            params,
        )
        leaves = tree_leaves(p)
        state = self.optimizer.init(p)._replace(step=np.zeros(c, dtype=np.int64))
        last_losses: list[torch.Tensor] = []
        last_valid: list[np.ndarray] = []
        executed = 0
        for t in range(t_total):
            valid = chunk.valid_host[t]
            if not valid.any():
                continue  # every client pads here: a no-op for all of them
            executed += 1
            gens = [g if v else None for g, v in zip(generators, valid)]
            loss = self.loss_fn(p, (chunk.x[t], chunk.y[t], chunk.mask[t]), gens)
            grads_flat = torch.autograd.grad(loss.sum(), leaves)
            grads_iter = iter(grads_flat)
            grads = tree_map(lambda _: next(grads_iter), p)
            updates, new_state = self.optimizer.update_stacked(
                grads, state, p, chunk.coefficients[t]
            )
            with torch.no_grad():
                if valid.all():  # the common step: no client to hold back, no where()
                    for q, u in zip(leaves, tree_leaves(updates)):
                        q.add_(u)
                    state = new_state
                else:
                    keep = chunk.valid[t]

                    def where(new, old):
                        return torch.where(keep.view(c, *([1] * (old.dim() - 1))), new, old)

                    for q, u in zip(leaves, tree_leaves(updates)):
                        q.copy_(where(q + u, q))
                    state = AdamWState(
                        step=state.step + valid,
                        mu=tree_map(where, new_state.mu, state.mu),
                        nu=tree_map(where, new_state.nu, state.nu),
                    )
            if t >= t_total - spe:
                last_losses.append(loss.detach())
                last_valid.append(valid)
        per_client = np.full(c, np.nan)
        if last_losses:
            # One readback per chunk.
            losses = torch.stack(last_losses).double().cpu().numpy()
            valid_last = np.stack(last_valid)
            per_client = np.where(valid_last, losses, 0.0).sum(axis=0) / np.maximum(
                valid_last.sum(axis=0), 1
            )
        return tree_map(lambda q: q.detach(), p), per_client.astype(np.float32), executed

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
        if min(chunk, len(clients)) > MAX_CHUNK:
            raise ValueError(
                f"a chunk of {min(chunk, len(clients))} clients is above {MAX_CHUNK}, the "
                "GRU kernels' grid y dimension; set cohort_chunk"
            )
        sizes = [cl.n_train for cl in clients]
        spe = steps_per_epoch or cohort_steps_per_epoch(sizes, self.batch_size)
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)

        acc = tree_map(
            lambda q: torch.zeros(q.shape, dtype=torch.promote_types(q.dtype, torch.float32),
                                  device=self.device),
            params,
        )
        total_weight, bytes_staged, num_chunks, executed, stage_s = 0.0, 0, 0, 0, 0.0
        per_losses = np.full(len(clients), np.nan, dtype=np.float32)
        held: _Chunk | None = None
        for start in range(0, len(clients), chunk):
            part = clients[start : start + chunk]
            t0 = time.perf_counter()
            staged = self._stage(part, rng, spe)
            stage_s += time.perf_counter() - t0
            held = None  # without donation the previous chunk lived until here
            stacked, losses, steps = self._train_chunk(
                params, staged, generators[start : start + chunk]
            )
            acc = self._accumulate(acc, stacked, staged.weights)
            if not self.donate:
                held = staged
            per_losses[start : start + len(part)] = losses
            total_weight += float(staged.weights.sum())
            bytes_staged += staged.nbytes
            executed += steps
            num_chunks += 1
            del stacked, staged
        del held

        new_params = tree_map(lambda a, q: (a / total_weight).to(q.dtype), acc, params)
        self.last_round_stats = {
            "chunks": num_chunks,
            "shards": 1,
            "donated": self.donate,
            "staging": self.staging,
            "bytes_staged": bytes_staged,
            # Host seconds building and uploading the chunks' schedules.
            "stage_seconds": stage_s,
            "peak_device_bytes": torch.cuda.max_memory_allocated(self.device) if cuda else None,
            "cohort_steps": executed,
        }
        real_steps = sum(local_round_steps(n, self.batch_size, self.local_epochs) for n in sizes)
        return new_params, per_losses, real_steps

    def _accumulate(self, acc: PyTree, stacked: PyTree, weights: np.ndarray) -> PyTree:
        """``acc + sum_c w_c * stacked[c]``, client by client: in place with
        ``donate``, else out of place (the same bits either way)."""
        for c, w in enumerate(weights.tolist()):
            if self.donate:
                for a, q in zip(tree_leaves(acc), tree_leaves(stacked)):
                    a.add_(q[c], alpha=w)
            else:
                acc = tree_map(lambda a, q: torch.add(a, q[c], alpha=w), acc, stacked)
        return acc

    def steps_per_round(self, client: ClientDataset) -> int:
        return local_round_steps(client.n_train, self.batch_size, self.local_epochs)
