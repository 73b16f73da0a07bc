"""Batching / client-dataset plumbing shared by central and federated training.

A copy of the JAX package's ``data/pipeline.py`` (the parts the sequential
engine and the LM trainer use): ``padded_batches`` and ``lm_token_batch``
consume the numpy generator exactly as the reference does, so batch order
and tokens match it by construction.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

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


def local_round_steps(n: int, batch_size: int, local_epochs: int) -> int:
    """Real local steps one client runs per round: ceil(n / B) * epochs."""
    return -(-int(n) // batch_size) * local_epochs


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
