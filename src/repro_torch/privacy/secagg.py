"""Secure-aggregation-style masked sum: pairwise masks that cancel exactly.

The port of the JAX package's ``privacy/secagg.py``: the same fixed-point
int64 arithmetic and numpy mask streams, byte for byte (same seeds, same
survivors, same totals).  The clients' stacked params come off the device
once a round, as one float64 array.

``"secagg-fedavg"`` is a registry aggregator (``mode = "stacked"``) whose
server-side reduction never touches a plaintext client update.  Each
client quantizes its weighted parameters to fixed-point int64, then adds
pairwise *antisymmetric* PRG masks shared with its ring neighbors — for
the pair (i, j) client i adds ``+m_ij`` where j adds ``-m_ij`` — so the
masks cancel identically in the sum (Bonawitz et al. 2017; the k-regular
ring pair graph follows Bell et al. 2020).  The masked integer tensors
are the *only* per-client data the aggregation path consumes:
:meth:`SecAggFedAvg.aggregate` sums masked tensors and pair-mask
regenerations, never an unmasked update.

Exactness is the whole design: masking happens in the wrapping uint64
ring, where addition is associative and commutative with no rounding, so
the masked sum is **bitwise equal** to the sum of the quantized inputs
(floating-point masks could never cancel bitwise — per-client rounding
would contaminate the total before cancellation).  The only deviation
from plain ``fedavg`` is the fixed-point quantization itself, bounded by
``clients / 2^(fraction_bits + 1)`` per coordinate of the weighted mean.

Dropout: a dropout model from the runtime's registry
(``federated/runtime/latency.py``)
(``"secagg-fedavg:bernoulli:0.1"`` or a bare probability) decides, per
round and per client slot, whose masked update never arrives.  Survivors'
masks toward dropped clients no longer cancel, so the server runs the
mask-recovery path: regenerate exactly the orphaned pair masks (in a real
deployment the survivors reveal those pair seeds) and subtract them,
recovering the survivors-only sum bit-exactly.  All mask generation,
masking, and recovery is vectorized over the stacked client axis — one
``(clients, leaf_size)`` PRG draw per ring offset, no per-pair Python
loop.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.federated.api import Aggregator, register_aggregator
from repro_torch.federated.fedavg import aggregate_stacked
from repro_torch.federated.runtime.latency import NeverDropout, resolve_dropout
from repro_torch.tree import tree_leaves, tree_map

DEFAULT_FRACTION_BITS = 24
DEFAULT_NEIGHBORS = 8


def _host_float64(leaves, c: int) -> list[np.ndarray]:
    """Client-stacked leaves -> ``(c, leaf size)`` float64 arrays, with one
    copy off the device for all of them."""
    flat = torch.cat([leaf.detach().reshape(c, -1).to(torch.float64) for leaf in leaves], 1)
    host = flat.cpu().numpy()
    bounds = np.cumsum([0] + [leaf[0].numel() for leaf in leaves])
    return [host[:, a:b] for a, b in zip(bounds[:-1], bounds[1:])]


def quantize_leaf(values: np.ndarray, fraction_bits: int) -> np.ndarray:
    """Float -> fixed-point int64 viewed as uint64 (two's complement)."""
    scale = float(1 << fraction_bits)
    q = np.round(np.asarray(values, dtype=np.float64) * scale)
    return q.astype(np.int64).view(np.uint64)


def dequantize_total(total: np.ndarray, fraction_bits: int) -> np.ndarray:
    """uint64 modular total -> float64 (exact for sums within int64 range)."""
    return total.view(np.int64).astype(np.float64) / float(1 << fraction_bits)


def pair_masks(
    seed: int, round_index: int, offset: int, num_clients: int, size: int
) -> np.ndarray:
    """The ring-offset-``offset`` pair masks for one round, shape (C, size).

    Row ``i`` is the mask shared by the pair ``(i, (i + offset) % C)`` —
    client ``i`` adds it, its partner subtracts it.  Deterministic in
    ``(seed, round, offset)`` so the recovery path can regenerate any
    orphaned mask without having stored it.
    """
    rng = np.random.default_rng([seed, round_index, offset])
    return rng.integers(0, 1 << 64, size=(num_clients, size), dtype=np.uint64)


def ring_offsets(num_clients: int, neighbors: int) -> list[int]:
    """Ring pair-graph offsets: each client pairs with its next ``k`` peers."""
    return [d for d in range(1, min(neighbors, num_clients - 1) + 1)]


def masked_client_tensors(
    quantized: np.ndarray, seed: int, round_index: int, offsets: list[int]
) -> np.ndarray:
    """Apply every client's pairwise masks: the tensors a server would see.

    ``quantized`` is (C, size) uint64.  Client ``i`` adds ``+M_d[i]`` for
    each of its forward pairs and ``-M_d[(i - d) % C]`` for each backward
    pair; everything is one vectorized roll per offset.
    """
    c, size = quantized.shape
    masked = quantized.copy()
    for d in offsets:
        m = pair_masks(seed, round_index, d, c, size)
        masked += m
        masked -= np.roll(m, d, axis=0)
    return masked


def masked_sum(
    masked: np.ndarray,
    survivors: np.ndarray,
    seed: int,
    round_index: int,
    offsets: list[int],
) -> np.ndarray:
    """Sum survivors' masked tensors, recovering orphaned pair masks.

    With every client surviving, the pair masks cancel algebraically and
    no mask is ever regenerated.  When client ``i`` dropped, each pair
    straddling the survivor boundary leaves one orphaned ``±mask`` in the
    total; those — and only those — are regenerated and removed.  Returns
    the uint64 modular total, bitwise equal to
    ``quantized[survivors].sum(axis=0)`` (mod 2^64).
    """
    c, size = masked.shape
    surv = np.asarray(survivors, dtype=bool)
    if surv.shape != (c,):
        raise ValueError(f"survivors must have shape ({c},), got {surv.shape}")
    if not surv.any():
        raise RuntimeError(
            "secagg: every masked client dropped this round — the masked sum "
            "is unrecoverable (no survivor can reveal pair seeds)"
        )
    total = masked[surv].sum(axis=0, dtype=np.uint64)
    if surv.all():
        return total
    for d in offsets:
        # surv_fwd[r] == survivor status of r's forward partner (r + d) % C.
        surv_fwd = np.roll(surv, -d)
        plus_rows = surv & ~surv_fwd  # survivor added +M_d[r], partner gone
        minus_rows = ~surv & surv_fwd  # partner added -M_d[r], owner gone
        if not (plus_rows.any() or minus_rows.any()):
            continue
        m = pair_masks(seed, round_index, d, c, size)
        if plus_rows.any():
            total -= m[plus_rows].sum(axis=0, dtype=np.uint64)
        if minus_rows.any():
            total += m[minus_rows].sum(axis=0, dtype=np.uint64)
    return total


@register_aggregator("secagg-fedavg")
class SecAggFedAvg(Aggregator):
    """FedAvg computed from pairwise-masked fixed-point client tensors.

    Spec forms: ``"secagg-fedavg"``, ``"secagg-fedavg:0.1"`` (Bernoulli
    dropout probability), ``"secagg-fedavg:bernoulli:0.1"`` (any runtime
    dropout-model spec).  ``mode = "stacked"`` — per-client updates must
    materialize on the client side of the masking boundary, so the
    synchronous engine runs sequentially; the *server* reduction is the
    masked integer sum.

    The aggregator keeps an internal round counter for mask derivation;
    reusing one instance across federations (or resuming mid-run) reseeds
    the counter via ``reset_round``.
    """

    mode = "stacked"

    def __init__(
        self,
        dropout="never",
        neighbors: int = DEFAULT_NEIGHBORS,
        fraction_bits: int = DEFAULT_FRACTION_BITS,
        seed: int = 0,
    ) -> None:
        self.dropout_model = resolve_dropout(dropout)
        if int(neighbors) < 1:
            raise ValueError(f"secagg needs >= 1 ring neighbor, got {neighbors}")
        if not (1 <= int(fraction_bits) <= 52):
            raise ValueError(
                f"fraction_bits must be in [1, 52], got {fraction_bits}"
            )
        self.neighbors = int(neighbors)
        self.fraction_bits = int(fraction_bits)
        self.seed = int(seed)
        self._round = 0
        self.last_survivors: np.ndarray | None = None

    def reset_round(self, round_index: int = 0) -> None:
        """Reset the mask-derivation round counter (e.g. on resume)."""
        self._round = int(round_index)

    def _survivors(self, num_clients: int, round_index: int) -> np.ndarray:
        if isinstance(self.dropout_model, NeverDropout):
            return np.ones(num_clients, dtype=bool)
        rng = np.random.default_rng([self.seed, round_index, 0x5EC])
        return np.array(
            [not self.dropout_model.drops(i, rng) for i in range(num_clients)],
            dtype=bool,
        )

    def aggregate(self, stacked, weights):
        w = np.asarray(weights, dtype=np.float64)
        c = w.shape[0]
        if np.any(w < 0) or w.sum() <= 0:
            raise ValueError(f"invalid aggregation weights: {weights}")
        round_index = self._round
        self._round += 1
        survivors = self._survivors(c, round_index)
        self.last_survivors = survivors
        offsets = ring_offsets(c, self.neighbors)
        w_surv = float(w[survivors].sum())
        if w_surv <= 0:
            raise RuntimeError(
                "secagg: all surviving clients carry zero weight — nothing "
                "to average"
            )

        leaves = tree_leaves(stacked)
        # The clients' params leave the device once, in float64 (exact).
        host = _host_float64(leaves, c)
        out = []
        for leaf, arr in zip(leaves, host):
            flat = (arr * w[:, None]).reshape(c, -1)
            quantized = quantize_leaf(flat, self.fraction_bits)
            masked = masked_client_tensors(
                quantized, self.seed, round_index, offsets
            )
            total = masked_sum(masked, survivors, self.seed, round_index, offsets)
            mean = dequantize_total(total, self.fraction_bits) / w_surv
            out.append(
                torch.from_numpy(mean.reshape(leaf.shape[1:]))
                .to(leaf.dtype).to(leaf.device)
            )
        rebuilt = iter(out)
        return tree_map(lambda _: next(rebuilt), stacked)

    def reference_aggregate(self, stacked, weights):
        """The plain (unmasked) FedAvg of the same inputs — test oracle."""
        return aggregate_stacked(stacked, weights)
