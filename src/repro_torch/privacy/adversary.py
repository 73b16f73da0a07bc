"""Adversarial-client scenarios: attacks a robust aggregator must survive.

The port of the JAX package's ``privacy/adversary.py``: the same seeded
attacker sets, label flips and Krum choices (distances in float64 numpy on
the host, after one copy of the stacked params off the device).

``ScenarioConfig`` turns a seeded fraction of a federation's clients into
attackers and :func:`apply_scenario` wires the attack into an existing
``Federation`` without touching the engine:

* ``"label-flip"`` — data poisoning: attackers train on mirrored LoS
  targets (``y -> max + min - y`` over their local range), so their honest
  training procedure pushes the model the wrong way.  Works on every
  engine and aggregation mode, because only the client datasets change.
* ``"scaled-update"`` — model poisoning: attackers send
  ``params + scale * delta`` instead of ``params + delta``, the classic
  norm-amplification attack that a single client can use to dominate
  plain FedAvg.
* ``"sign-flip"`` — model poisoning: attackers send ``params - delta``,
  exactly undoing their local progress and dragging the average backward.

Model-poisoning attacks intercept updates in a trainer proxy, which
requires per-client updates to materialize: reduced-mode aggregators are
transparently re-wrapped to stacked delivery (numerically identical
FedAvg), and grouped-mode aggregators are rejected.

The robust side of the ledger: the registry's ``"trimmed-mean"`` and the
``"krum[:f]"`` aggregator added here (Blanchard et al. 2017) — Krum picks
the update whose nearest-neighbor distance mass is smallest, discarding
up to ``f`` Byzantine clients entirely, and ``"krum:f,m"`` (multi-Krum)
averages the ``m`` best-scored updates.
"""

from __future__ import annotations

import dataclasses
import difflib

import numpy as np
import torch

from repro_torch.data.pipeline import ArrayDataset, ClientDataset
from repro_torch.federated.api import Aggregator, register_aggregator
from repro_torch.federated.fedavg import aggregate_stacked
from repro_torch.tree import tree_leaves, tree_map

ATTACKS = ("label-flip", "scaled-update", "sign-flip")
_MODEL_POISON = ("scaled-update", "sign-flip")


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    """A seeded adversarial scenario over any federation.

    ``fraction`` of the clients (chosen by ``seed``, independent of the
    run seed) execute ``attack``; ``scale`` parameterizes
    ``"scaled-update"``.  ``fraction = 0`` is the clean run.
    """

    attack: str = "label-flip"
    fraction: float = 0.2
    scale: float = 10.0
    seed: int = 0

    def __post_init__(self) -> None:
        if self.attack not in ATTACKS:
            hint = difflib.get_close_matches(str(self.attack), ATTACKS, n=1)
            suggest = f" — did you mean {hint[0]!r}?" if hint else ""
            raise ValueError(
                f"unknown attack {self.attack!r} (choose from {list(ATTACKS)})"
                f"{suggest}"
            )
        if not (0.0 <= float(self.fraction) <= 1.0):
            raise ValueError(
                f"attacker fraction must be in [0, 1], got {self.fraction}"
            )
        if not np.isfinite(self.scale):
            raise ValueError(f"attack scale must be finite, got {self.scale}")


def attacker_ids(client_ids, scenario: ScenarioConfig) -> np.ndarray:
    """The sorted attacker subset — seeded, independent of the run's rng."""
    ids = np.sort(np.asarray(list(client_ids), dtype=np.int64))
    if scenario.fraction == 0.0 or ids.size == 0:
        return np.array([], dtype=np.int64)
    count = max(1, int(round(scenario.fraction * ids.size)))
    count = min(count, ids.size)
    rng = np.random.default_rng([scenario.seed, 0xAD5])
    return np.sort(rng.choice(ids, size=count, replace=False))


def flip_labels(dataset: ArrayDataset) -> ArrayDataset:
    """Mirror the regression targets across their local range."""
    y = np.asarray(dataset.y)
    flipped = (y.max() + y.min() - y).astype(y.dtype)
    return ArrayDataset(x=dataset.x, y=flipped)


def poison_clients(clients, attackers) -> list[ClientDataset]:
    """Label-flipped copies of the attacker clients (others untouched)."""
    bad = set(int(a) for a in np.asarray(attackers).tolist())
    out = []
    for c in clients:
        if int(c.client_id) in bad:
            out.append(
                ClientDataset(
                    client_id=c.client_id, train=flip_labels(c.train), val=c.val
                )
            )
        else:
            out.append(c)
    return out


class _AttackedTrainer:
    """Trainer proxy: honest local training, then a poisoned update."""

    def __init__(self, inner, attackers, attack: str, scale: float) -> None:
        self._inner = inner
        self._attackers = set(int(a) for a in np.asarray(attackers).tolist())
        self._attack = attack
        self._scale = float(scale)

    def train_client(self, params, client, rng, generator):
        new_params, loss, n_c = self._inner.train_client(
            params, client, rng, generator
        )
        if int(client.client_id) in self._attackers:
            if self._attack == "scaled-update":
                s = self._scale
                new_params = tree_map(
                    lambda p, q: (p + s * (q - p)).to(q.dtype),
                    params,
                    new_params,
                )
            elif self._attack == "sign-flip":
                new_params = tree_map(
                    lambda p, q: (p - (q - p)).to(q.dtype),
                    params,
                    new_params,
                )
        return new_params, loss, n_c

    def __getattr__(self, name):
        return getattr(self._inner, name)


class _StackedFedAvg(Aggregator):
    """FedAvg delivered stacked, so a trainer proxy sees every update."""

    mode = "stacked"

    def aggregate(self, stacked, weights):
        return aggregate_stacked(stacked, weights)


def apply_scenario(federation, scenario: ScenarioConfig):
    """Install the scenario on a built ``Federation`` (mutates in place).

    Call before ``run()``.  Returns the federation; the chosen attacker
    ids land on ``federation.scenario_attackers`` for inspection.
    """
    attackers = attacker_ids(federation.all_clients.keys(), scenario)
    federation.scenario_attackers = attackers
    if attackers.size == 0:
        return federation
    if scenario.attack == "label-flip":
        poisoned = poison_clients(federation.all_clients.values(), attackers)
        federation.all_clients = {c.client_id: c for c in poisoned}
        return federation
    # Model poisoning needs every client's update to pass through the
    # trainer proxy, which only stacked delivery materializes.
    if federation.aggregator.mode == "grouped":
        raise ValueError(
            f"attack {scenario.attack!r} poisons per-client updates; grouped "
            "aggregators reduce regions before updates materialize — use a "
            "reduced or stacked aggregator"
        )
    if federation.aggregator.mode == "reduced":
        federation.aggregator = _StackedFedAvg()
    federation.trainer = _AttackedTrainer(
        federation.trainer, attackers, scenario.attack, scenario.scale
    )
    return federation


@register_aggregator("krum")
class KrumAggregator(Aggregator):
    """Krum / multi-Krum (Blanchard et al. 2017) — Byzantine-robust.

    Spec forms: ``"krum"`` (f=1), ``"krum:f"``, ``"krum:f,m"`` (multi-Krum
    averages the ``m`` best-scored updates).  Each client's score is the
    sum of its ``C - f - 2`` smallest squared distances to other updates;
    the lowest-scoring update(s) win.  Requires ``C >= 2f + 3`` clients
    per round — fewer and the guarantee is vacuous, so we fail fast.
    """

    mode = "stacked"

    def __init__(self, f: int = 1, m: int = 1) -> None:
        if int(f) < 0:
            raise ValueError(f"krum needs f >= 0 Byzantine clients, got {f}")
        if int(m) < 1:
            raise ValueError(f"multi-krum needs m >= 1 selections, got {m}")
        self.f = int(f)
        self.m = int(m)
        self.last_chosen: np.ndarray | None = None

    def aggregate(self, stacked, weights):
        leaves = tree_leaves(stacked)
        c = leaves[0].shape[0]
        if c < 2 * self.f + 3:
            raise ValueError(
                f"krum:{self.f} needs at least 2f+3 = {2 * self.f + 3} "
                f"clients per round, got {c} — lower f or select more clients"
            )
        flat = (
            torch.cat([leaf.detach().reshape(c, -1).to(torch.float64) for leaf in leaves], 1)
            .cpu()
            .numpy()
        )
        sq_norms = np.sum(flat * flat, axis=1)
        d2 = sq_norms[:, None] + sq_norms[None, :] - 2.0 * (flat @ flat.T)
        np.fill_diagonal(d2, np.inf)
        d2 = np.maximum(d2, 0.0)
        neighbor_count = c - self.f - 2
        scores = np.sort(d2, axis=1)[:, :neighbor_count].sum(axis=1)
        chosen = np.argsort(scores, kind="stable")[: min(self.m, c)]
        self.last_chosen = np.sort(chosen)
        sel = torch.from_numpy(self.last_chosen).to(leaves[0].device)
        return tree_map(
            lambda leaf: torch.mean(
                torch.index_select(leaf, 0, sel), dim=0
            ).to(leaf.dtype),
            stacked,
        )
