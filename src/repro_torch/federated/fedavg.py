"""FedAvg parameter aggregation (McMahan et al. 2017) over trees of tensors.

``aggregate`` is the server-side weighted average of client parameter
trees; weights default to uniform, and the engines pass local sample sizes
n_c (the original FedAvg weighting).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.tree import PyTree, tree_leaves, tree_map


def stack_trees(trees: Sequence[PyTree]) -> PyTree:
    """Client trees -> one tree whose leaves carry a leading client axis."""
    return tree_map(lambda *leaves: torch.stack(leaves), *trees)


def aggregate(params_list: Sequence[PyTree], weights: Sequence[float] | None = None) -> PyTree:
    """Weighted average of trees: sum_c w_c * params_c / sum_c w_c."""
    if not params_list:
        raise ValueError("nothing to aggregate")
    if weights is None:
        weights = [1.0] * len(params_list)
    w = np.asarray(weights, dtype=np.float64)
    if np.any(w < 0) or w.sum() <= 0:
        raise ValueError(f"invalid aggregation weights: {weights}")
    return aggregate_stacked(stack_trees(params_list), (w / w.sum()).astype(np.float32))


def _contract(weights, leaf: torch.Tensor) -> torch.Tensor:
    # Contract in the leaf's own precision, promoted to at least float32.
    ct = torch.promote_types(leaf.dtype, torch.float32)
    w = torch.as_tensor(weights, dtype=ct, device=leaf.device)
    return torch.tensordot(w, leaf.to(ct), dims=([0], [0]))


def aggregate_stacked(stacked: PyTree, weights) -> PyTree:
    """FedAvg over a client-stacked tree: one contraction per leaf.

    Weights are normalized here (in float32), so they need not sum to one.
    """
    w = np.asarray(weights, dtype=np.float32)
    w = w / np.sum(w, dtype=np.float32)
    return tree_map(lambda leaf: _contract(w, leaf).to(leaf.dtype), stacked)


def weighted_sum_stacked(stacked: PyTree, weights) -> PyTree:
    """Unnormalized ``sum_c w_c * leaf_c`` over the leading client axis."""
    w = np.asarray(weights, dtype=np.float32)
    return tree_map(lambda leaf: _contract(w, leaf), stacked)


def check_trim(trim: float) -> None:
    """``trim`` must leave clients: a fraction in [0, 0.5) from each tail."""
    if not (0.0 <= trim < 0.5):
        hint = (
            f" — did you mean trim={min(trim / 2, 0.45):g} "
            "(the fraction trimmed from *each* tail)?"
            if 0.5 <= trim < 1.0
            else (
                f" — to trim {trim:g} clients per tail out of C, pass "
                f"the fraction {trim:g}/C"
                if trim >= 1.0
                else ""
            )
        )
        raise ValueError(
            f"trim fraction must be in [0, 0.5), got {trim}: trimming half "
            f"or more from both tails leaves no clients{hint}"
        )


def trimmed_mean_stacked(stacked: PyTree, trim: float) -> PyTree:
    """Coordinate-wise trimmed mean over the leading client axis.

    For every scalar coordinate, drop the ``floor(trim * C)`` smallest and
    largest client values and average the rest (Yin et al. 2018).
    Unweighted by construction; ``trim = 0`` is the plain coordinate mean.
    """
    check_trim(trim)

    def _trim(leaf: torch.Tensor) -> torch.Tensor:
        c = leaf.shape[0]
        # trim < 0.5 guarantees 2k < c, so at least one client survives.
        k = int(np.floor(trim * c))
        ct = torch.promote_types(leaf.dtype, torch.float32)
        kept = torch.sort(leaf.to(ct), dim=0).values[k : c - k]
        return kept.mean(dim=0).to(leaf.dtype)

    return tree_map(_trim, stacked)


def delta(new: PyTree, old: PyTree) -> PyTree:
    return tree_map(lambda a, b: a - b, new, old)


def apply_delta(params: PyTree, d: PyTree, scale: float = 1.0) -> PyTree:
    return tree_map(lambda p, u: p + scale * u, params, d)


def tree_allclose(a: PyTree, b: PyTree, atol: float = 1e-6) -> bool:
    return all(
        torch.allclose(x.detach().cpu(), y.detach().cpu(), atol=atol)
        for x, y in zip(tree_leaves(a), tree_leaves(b))
    )


def params_nbytes(params: PyTree) -> int:
    return sum(int(p.numel()) * p.element_size() for p in tree_leaves(params))
