"""Batching / client-dataset plumbing shared by central and federated training.

A copy of the JAX package's ``data/pipeline.py`` (the parts both engines
and the LM trainer use): ``padded_batches``, the cohort schedule of the
vectorized engine and ``lm_token_batch`` consume the numpy generator exactly
as the reference does, so batch order and tokens match it by construction.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np

from repro_torch.core.histogram import LOS_BIN_EDGES, target_histogram
from repro_torch.core.recruitment import ClientStats
from repro_torch.data.synth_eicu import Cohort


@dataclasses.dataclass
class ArrayDataset:
    """In-memory (x, y) pair with shuffled minibatch iteration."""

    x: np.ndarray
    y: np.ndarray

    def __post_init__(self) -> None:
        assert len(self.x) == len(self.y)

    def __len__(self) -> int:
        return len(self.y)

    def batches(
        self, batch_size: int, rng: np.random.Generator
    ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        idx = rng.permutation(len(self))
        for start in range(0, len(self), batch_size):
            sel = idx[start : start + batch_size]
            yield self.x[sel], self.y[sel]

    def padded_batches(
        self, batch_size: int, rng: np.random.Generator
    ) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Fixed-shape batches (pad the tail) -> (x, y, valid_mask)."""
        for xb, yb in self.batches(batch_size, rng):
            k = len(yb)
            if k < batch_size:
                pad = batch_size - k
                xb = np.concatenate([xb, np.zeros((pad, *xb.shape[1:]), xb.dtype)])
                yb = np.concatenate([yb, np.zeros((pad,), yb.dtype)])
            mask = np.zeros(batch_size, dtype=np.float32)
            mask[:k] = 1.0
            yield xb, yb, mask


@dataclasses.dataclass(frozen=True)
class CohortSchedule:
    """A fixed-shape batch plan for one federated round across a client cohort.

    Every client's epoch is padded to ``steps_per_epoch`` with dummy batches
    whose ``step_valid`` flag is False (and whose example mask is all-zero),
    so the whole cohort shares one ``(clients, steps, batch, ...)`` shape.
    """

    x: np.ndarray           # (C, T, B, *feature_dims)
    y: np.ndarray           # (C, T, B)
    mask: np.ndarray        # (C, T, B) float32 per-example validity
    step_valid: np.ndarray  # (C, T) bool — False on dummy padding steps
    weights: np.ndarray     # (C,) float32 local sample counts n_c
    steps_per_epoch: int
    local_epochs: int

    @property
    def num_clients(self) -> int:
        return self.x.shape[0]

    @property
    def total_steps(self) -> int:
        return self.x.shape[1]

    @property
    def real_steps(self) -> int:
        return int(self.step_valid.sum())


def local_round_steps(n: int, batch_size: int, local_epochs: int) -> int:
    """Real local steps one client runs per round: ceil(n / B) * epochs.

    Both engines report their step totals through this, so their
    ``total_local_steps`` always agree.
    """
    return -(-int(n) // batch_size) * local_epochs


def cohort_steps_per_epoch(sizes: Sequence[int], batch_size: int) -> int:
    """Common per-epoch step count: the slowest client's ceil(n_c / B)."""
    if not sizes:
        raise ValueError("empty cohort")
    return max(local_round_steps(n, batch_size, 1) for n in sizes)


def build_cohort_schedule(
    datasets: Sequence[ArrayDataset],
    batch_size: int,
    local_epochs: int,
    rng: np.random.Generator,
    steps_per_epoch: int | None = None,
) -> CohortSchedule:
    """Stack every client's shuffled, padded epoch batches into one array.

    Consumes ``rng`` in exactly the order the sequential engine does
    (client-major, one permutation per epoch), so a vectorized round is fed
    bit for bit the same batches as the sequential one.
    """
    if not datasets:
        raise ValueError("empty cohort")
    spe = steps_per_epoch or cohort_steps_per_epoch([len(d) for d in datasets], batch_size)
    total = spe * local_epochs
    feat = datasets[0].x.shape[1:]
    n_clients = len(datasets)
    x = np.zeros((n_clients, total, batch_size, *feat), dtype=datasets[0].x.dtype)
    y = np.zeros((n_clients, total, batch_size), dtype=datasets[0].y.dtype)
    mask = np.zeros((n_clients, total, batch_size), dtype=np.float32)
    step_valid = np.zeros((n_clients, total), dtype=bool)
    fill_cohort_schedule(datasets, batch_size, local_epochs, rng, spe, x, y, mask, step_valid)
    return CohortSchedule(
        x=x,
        y=y,
        mask=mask,
        step_valid=step_valid,
        weights=np.asarray([len(d) for d in datasets], dtype=np.float32),
        steps_per_epoch=spe,
        local_epochs=local_epochs,
    )


def fill_cohort_schedule(
    datasets: Sequence[ArrayDataset],
    batch_size: int,
    local_epochs: int,
    rng: np.random.Generator,
    steps_per_epoch: int,
    x: np.ndarray,
    y: np.ndarray,
    mask: np.ndarray,
    step_valid: np.ndarray,
) -> None:
    """Write the schedule of ``build_cohort_schedule`` into zeroed arrays of
    shape ``(C, T, B, ...)`` (any strides: the cohort engine passes views of
    its step-major staging buffer), consuming ``rng`` the same way."""
    spe = steps_per_epoch
    feat = x.shape[3:]
    for c, dataset in enumerate(datasets):
        if dataset.x.shape[1:] != feat:
            raise ValueError("all cohort clients must share a feature shape")
        for epoch in range(local_epochs):
            t = epoch * spe
            for xb, yb, mb in dataset.padded_batches(batch_size, rng):
                if t >= (epoch + 1) * spe:
                    raise ValueError(
                        f"client {c} produced more than steps_per_epoch={spe} batches"
                    )
                x[c, t], y[c, t], mask[c, t] = xb, yb, mb
                step_valid[c, t] = True
                t += 1
            # remaining slots of this epoch stay dummy (zeros, step_valid False)


def skip_cohort_draws(sizes: Sequence[int], local_epochs: int, rng: np.random.Generator) -> None:
    """Consume ``rng`` as ``fill_cohort_schedule`` (and the plan twin,
    ``fill_cohort_plan``) would for clients of these ``sizes``, writing
    nothing: one permutation per client per epoch, client-major.  Under a
    data mesh a rank draws its block's batches and skips the others', so
    every rank leaves the shared generator where one process would."""
    for n in sizes:
        for _ in range(local_epochs):
            rng.permutation(int(n))


def pad_cohort_schedule(sched: CohortSchedule, multiple: int) -> CohortSchedule:
    """Pad the client axis with weight-0 dummy clients to a multiple.

    Dummy clients have every step masked invalid (exact no-ops) and zero
    aggregation weight, so they change nothing but the array shape.
    """
    if multiple <= 1:
        return sched
    pad = -sched.num_clients % multiple
    if pad == 0:
        return sched

    def pad_clients(a: np.ndarray) -> np.ndarray:
        return np.concatenate([a, np.zeros((pad, *a.shape[1:]), dtype=a.dtype)])

    return CohortSchedule(
        x=pad_clients(sched.x),
        y=pad_clients(sched.y),
        mask=pad_clients(sched.mask),
        step_valid=pad_clients(sched.step_valid),
        weights=pad_clients(sched.weights),
        steps_per_epoch=sched.steps_per_epoch,
        local_epochs=sched.local_epochs,
    )


@dataclasses.dataclass
class ClientDataset:
    """One hospital's local data (train + val splits)."""

    client_id: int
    train: ArrayDataset
    val: ArrayDataset

    @property
    def n_train(self) -> int:
        return len(self.train)

    def stats(self, edges=LOS_BIN_EDGES) -> ClientStats:
        """The recruitment disclosure tuple (P_co, n_c) — nothing else leaves."""
        return ClientStats(
            client_id=self.client_id,
            counts=target_histogram(self.train.y, edges),
            n=len(self.train),
        )


def build_client_datasets(cohort: Cohort, min_train: int = 2) -> list[ClientDataset]:
    """Split the cohort by originating hospital into per-client datasets.

    Hospitals whose local train split is degenerate (< min_train samples)
    are dropped, mirroring the paper's 208 -> 189 hospital preprocessing cut.
    """
    fused = cohort.fused_features()
    clients: list[ClientDataset] = []
    for h in range(cohort.num_hospitals):
        m_train = (cohort.hospital_id == h) & (cohort.split == Cohort.TRAIN)
        m_val = (cohort.hospital_id == h) & (cohort.split == Cohort.VAL)
        if int(m_train.sum()) < min_train:
            continue
        clients.append(
            ClientDataset(
                client_id=h,
                train=ArrayDataset(fused[m_train], cohort.y[m_train]),
                val=ArrayDataset(fused[m_val], cohort.y[m_val]),
            )
        )
    return clients


def global_dataset(cohort: Cohort, split: int) -> ArrayDataset:
    m = cohort.mask(split)
    return ArrayDataset(cohort.fused_features()[m], cohort.y[m])


def lm_token_batch(
    rng: np.random.Generator, batch: int, seq_len: int, vocab_size: int
) -> dict[str, np.ndarray]:
    """Synthetic LM batch for the assigned language-model architectures."""
    tokens = rng.integers(0, vocab_size, size=(batch, seq_len + 1), dtype=np.int32)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
