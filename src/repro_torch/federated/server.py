"""Legacy server facade — thin deprecation shims over ``repro_torch.federated.api``.

``FederatedServer`` / ``FederatedConfig`` were the pre-policy orchestration
surface: one hard-wired pipeline of paper nu-greedy recruitment, uniform
per-round sampling, and FedAvg.  The runtime now lives in
:mod:`repro_torch.federated.api` as a :class:`~repro_torch.federated.api.Federation`
facade with pluggable ``RecruitmentPolicy`` / ``SelectionPolicy`` /
``Aggregator`` stages; the classes here only translate the old declarative
config onto those policies so every existing invocation keeps working::

    FederatedConfig(recruitment=RecruitmentConfig(...), participation_fraction=0.1)
        -> FederationConfig(recruitment=NuGreedyRecruitment(...),
                            selection=UniformSelection(fraction=0.1),
                            aggregator="fedavg")

New code should construct a ``Federation`` directly.

The port of the JAX package's ``federated/server.py``; ``FederatedServer``
takes the port's ``device`` (``None`` is the card).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.core.recruitment import RecruitmentConfig, RecruitmentResult
from repro_torch.data.pipeline import ClientDataset
from repro_torch.federated.api import (
    ENGINES,
    Federation,
    FederationConfig,
    FederatedRunResult,
    NuGreedyRecruitment,
    RoundRecord,
    UniformSelection,
)
from repro_torch.federated.cohort import STAGING_MODES
from repro_torch.optim.adamw import AdamW

__all__ = [
    "ENGINES",
    "FederatedConfig",
    "FederatedRunResult",
    "FederatedServer",
    "RoundRecord",
]

PyTree = Any


@dataclasses.dataclass(frozen=True)
class FederatedConfig:
    """Deprecated: the pre-policy config.  Use ``FederationConfig`` instead.

    Field semantics are unchanged; ``to_federation()`` is the mapping onto
    the policy API (``recruitment=None`` -> ``"all"``, a
    ``RecruitmentConfig`` -> nu-greedy, ``participation_fraction`` ->
    uniform selection, aggregation is always FedAvg).
    """

    rounds: int = 15
    local_epochs: int = 4
    batch_size: int = 128
    # Per-round participation: None = all federation clients each round,
    # otherwise the random fraction sampled each round (paper uses 0.1).
    participation_fraction: float | None = None
    # Pre-federation recruitment: None disables (standard FL).
    recruitment: RecruitmentConfig | None = None
    seed: int = 0
    # "vectorized" trains a round's cohort in batched steps; "sequential" is
    # the per-client loop (both produce matching aggregated params within 1e-5).
    engine: str = "vectorized"
    # Vectorized engine: max clients per batched step (None = all at once).
    cohort_chunk: int | None = None
    # Vectorized engine: the client axis over several processes (a
    # launch/mesh.py DataMesh, or "auto").
    mesh: Any = None
    # Vectorized engine: in-place accumulator, staged chunks released early.
    donate_buffers: bool = True
    # "resident" uploads client data once + stages int32 plans per round;
    # "rebuild" re-uploads the full schedule every round.
    staging: str = "resident"
    # Resident staging: double-buffer chunk plans on a background thread.
    prefetch: bool = True

    def __post_init__(self) -> None:
        if self.engine not in ENGINES:
            raise ValueError(f"unknown engine {self.engine!r}; choose from {ENGINES}")
        if self.staging not in STAGING_MODES:
            raise ValueError(
                f"unknown staging {self.staging!r}; choose from {STAGING_MODES}"
            )

    def to_federation(self) -> FederationConfig:
        """The policy-API equivalent of this legacy config."""
        recruitment = (
            "all" if self.recruitment is None else NuGreedyRecruitment(self.recruitment)
        )
        return FederationConfig(
            rounds=self.rounds,
            local_epochs=self.local_epochs,
            batch_size=self.batch_size,
            recruitment=recruitment,
            selection=UniformSelection(fraction=self.participation_fraction),
            aggregator="fedavg",
            seed=self.seed,
            engine=self.engine,
            cohort_chunk=self.cohort_chunk,
            mesh=self.mesh,
            donate_buffers=self.donate_buffers,
            staging=self.staging,
            prefetch=self.prefetch,
        )


class FederatedServer:
    """Deprecated: runs the FedAvg protocol via the ``Federation`` facade."""

    def __init__(
        self,
        config: FederatedConfig,
        clients: Sequence[ClientDataset],
        loss_fn: Callable[..., Any],
        optimizer: AdamW,
        device: str | torch.device | None = None,
    ) -> None:
        warnings.warn(
            "FederatedServer is deprecated; use repro_torch.federated.api.Federation "
            "with recruitment/selection/aggregator policies instead",
            DeprecationWarning,
            stacklevel=2,
        )
        self.config = config
        self.federation = Federation(
            config.to_federation(), clients, loss_fn, optimizer, device=device
        )

    @property
    def all_clients(self):
        return self.federation.all_clients

    @property
    def trainer(self):
        return self.federation.trainer

    @property
    def cohort_trainer(self):
        return self.federation.cohort_trainer

    def build_federation(self) -> tuple[np.ndarray, RecruitmentResult | None]:
        """Recruitment happens here — before the federation exists."""
        return self.federation.build_federation()

    def run(
        self,
        init_params: PyTree,
        progress: Callable[[RoundRecord], None] | None = None,
    ) -> FederatedRunResult:
        return self.federation.run(init_params, progress=progress)
