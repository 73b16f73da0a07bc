"""Target-distribution histograms used by client recruitment.

The paper bins the continuous LoS target (fractional days) into ten buckets::

    [0,1), [1,2), ..., [7,8), [8,14), [14, +inf)

which converts the regression target into "class counts" over which the
distribution divergence in eq. (4) is computed.  For language-model targets
(the assigned LM architectures) we bin token ids into a fixed number of
equal-width vocabulary buckets — the recruitment math is identical.
"""

from __future__ import annotations

import numpy as np

# Paper's LoS bin edges (days).  Ten bins.
LOS_BIN_EDGES: tuple[float, ...] = (0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0, 14.0, np.inf)

NUM_LOS_BINS = len(LOS_BIN_EDGES) - 1


def target_histogram(y: np.ndarray, edges: tuple[float, ...] = LOS_BIN_EDGES) -> np.ndarray:
    """Counts of target values per bin.  ``y`` is 1-D, continuous, >= 0."""
    y = np.asarray(y, dtype=np.float64).ravel()
    counts, _ = np.histogram(y, bins=np.asarray(edges))
    return counts.astype(np.int64)


def token_histogram(tokens: np.ndarray, vocab_size: int, num_bins: int = 10) -> np.ndarray:
    """Equal-width vocabulary-bucket histogram for LM targets."""
    tokens = np.asarray(tokens).ravel()
    edges = np.linspace(0, vocab_size, num_bins + 1)
    counts, _ = np.histogram(tokens, bins=edges)
    return counts.astype(np.int64)


def normalize(counts: np.ndarray) -> np.ndarray:
    """Counts -> probability vector.  All-zero counts normalize to zeros."""
    counts = np.asarray(counts, dtype=np.float64)
    total = counts.sum()
    if total <= 0:
        return np.zeros_like(counts)
    return counts / total


def l1_divergence(p_counts: np.ndarray, q_counts: np.ndarray) -> float:
    """Sum of absolute differences between two *normalized* histograms.

    This is the paper's ``| P_go/n_g - P_co/n_c |`` term (twice the total
    variation distance).
    """
    return float(np.abs(normalize(p_counts) - normalize(q_counts)).sum())
