"""Per-round client selection primitives.

The paper uses the standard FedAvg procedure: each round, either all clients
in the federation participate or a random subset (10% in their experiments)
is sampled uniformly without replacement.  Policy classes live in
``repro_torch.federated.api``; this module holds the pure sampling functions.

All selectors return participant ids in **sorted order**.  The participant
list is the cohort stacking order (and lands verbatim in
``RoundRecord.participant_ids``), so an unsorted ``rng.choice`` draw would
leak the draw order into results and records; sorting makes the cohort
layout a function of *which* clients were picked, not of how the sampler
happened to emit them.
"""

from __future__ import annotations

import numpy as np


def select_clients(
    rng: np.random.Generator,
    client_ids: np.ndarray,
    fraction: float | None = None,
    count: int | None = None,
) -> np.ndarray:
    """Uniform random subset of ``client_ids`` for one training round.

    Exactly one of ``fraction`` / ``count`` may be given; neither means all
    clients participate.  Sampling matches the paper: at least one client,
    without replacement.  Returns sorted ids.
    """
    client_ids = np.asarray(client_ids)
    if fraction is not None and count is not None:
        raise ValueError("give fraction or count, not both")
    if fraction is None and count is None:
        return np.sort(client_ids)
    if fraction is not None:
        if not (0.0 < fraction <= 1.0):
            raise ValueError(f"fraction must be in (0, 1], got {fraction}")
        count = max(1, int(round(fraction * len(client_ids))))
    count = min(int(count), len(client_ids))
    return np.sort(rng.choice(client_ids, size=count, replace=False))


def round_robin_clients(
    round_index: int, client_ids: np.ndarray, count: int
) -> np.ndarray:
    """Deterministic rotation: round ``r`` takes the wrapped window of size
    ``count`` starting at ``(r * count) % N`` over the sorted ids.  Every
    client participates at least once per ``ceil(N / count)`` consecutive
    rounds — exactly once when ``count`` divides ``N``, otherwise the
    wrap-around window re-visits a few early ids each cycle.  No RNG is
    consumed.  Returns sorted ids.
    """
    ids = np.sort(np.asarray(client_ids))
    n = len(ids)
    if n == 0:
        raise ValueError("empty federation")
    count = max(1, min(int(count), n))
    start = (round_index * count) % n
    picked = np.take(ids, np.arange(start, start + count), mode="wrap")
    return np.sort(picked)
