"""Composable federation API: pluggable recruitment / selection / aggregation.

The port of the JAX package's ``federated/api.py``, on both engines:
``"vectorized"`` (the default, ``federated/cohort.py::CohortTrainer``) and
``"sequential"`` (``federated/client.py::LocalTrainer``).  Three stages
are the extension points of the runtime:

* ``RecruitmentPolicy`` — who joins the federation, decided once before
  round one from the disclosure tuples ``(P_co, n_c)``.  Built-ins:
  ``"nu-greedy"`` (the paper's greedy threshold rule), ``"random-k"``,
  ``"top-n-samples"`` and ``"all"``.
* ``SelectionPolicy`` — which federation members train in a given round.
  Built-ins: ``"uniform"``, ``"round-robin"`` and ``"loss-weighted"``.
* ``Aggregator`` — how client updates become the new global params.
  Built-ins: ``"fedavg"``, ``"trimmed-mean"``, ``"secagg-fedavg"`` and
  ``"krum"`` (per-client params, so their rounds run the per-client
  trainer) and ``"hierarchical"`` (one engine round per regional group,
  then FedAvg over the groups).  The buffered ``"fedbuff"`` and
  ``"hierarchical-async"`` resolve here too, but run only under
  ``federated/runtime/async_federation.py::AsyncFederation``.

Several processes (``FederationConfig.mesh``, ``launch/mesh.py``): the
vectorized engine splits each round's participants over the process group's
ranks and sums their FedAvg accumulators with one all-reduce a
``train_cohort`` call, so a ``"grouped"`` aggregator (hierarchical) does
one all-reduce a group.  Rounds of a ``"stacked"`` aggregator
(trimmed-mean, krum, secagg-fedavg) run the per-client trainer on every
rank, as the reference ignores its mesh there: each rank computes the
whole round and none is faster.  The sequential engine ignores the mesh.

DP-SGD (``FederationConfig.privacy``) runs in both engines
(``privacy/dp.py``); one Rényi accountant a run turns each round's
sampling rate into the cumulative ``RoundRecord.epsilon``.

Every policy resolves from a string spec ``name`` or ``name:arg,...``, or an
instance can be passed directly.  The round program is::

    build_federation -> select -> train -> aggregate -> record

Seeded replay: a run is a function of ``FederationConfig.seed``.  The
recruitment generator is ``default_rng([seed, 1])``, the shared batch-plan
generator ``default_rng(seed)`` (consumed client-major by selection and
``padded_batches``, exactly as in the reference, so participants and batch
order match it), and the dropout generators come from
``default_rng([seed, 2])``: each round draws one seed per participant, in
participant order, and seeds a ``torch.Generator`` on the training device
with it (``cohort.client_generators``).  Both engines train client ``i`` of
a round with the same generator, so they draw identical masks.  A run
resumed from a :class:`FederationSnapshot` (params, round index, both
streams' states, the record history and the selection policy's adaptive
state) continues exactly where the interrupted one left off.

Observability: each run folds its records and the cohort engine's
``last_round_stats`` into a ``repro_torch.obs.MetricsRegistry``
(``Federation(metrics=)``; the final snapshot is
``FederatedRunResult.metrics``), with the kernel libraries' build and load
events as the ``jit.*`` metrics (``obs/profile.py::CompileWatcher``).
``tracer=`` (a ``repro_torch.obs.Tracer``) records the reference's
``select``, ``train``, ``aggregate``, ``checkpoint`` and ``round`` spans,
the port's ``generators`` span (the round's dropout generators, inside
``train``), the cohort engine's ``stage`` / ``prefetch_wait`` /
``pool_upload`` / ``readback`` / ``cohort_step`` spans below them, and on
the card the cohort steps' replays on the device clock; ``profiler=`` (an
``obs.profile.RoundProfiler``) brackets each round.  Both are off by
default, and off they add no device work.
"""

from __future__ import annotations

import dataclasses
import difflib
import importlib
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.core.recruitment import (
    BALANCED,
    ClientStats,
    RecruitmentConfig,
    RecruitmentResult,
    preset_recruitment,
    recruit,
)
from repro_torch.data.pipeline import ClientDataset, cohort_steps_per_epoch
from repro_torch.federated.client import LocalTrainer
from repro_torch.federated.cohort import STAGING_MODES, CohortTrainer, client_generators
from repro_torch.federated.fedavg import (
    aggregate_stacked,
    check_trim,
    params_nbytes,
    stack_trees,
    trimmed_mean_stacked,
)
from repro_torch.federated.selection import round_robin_clients, select_clients
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.profile import CompileWatcher
from repro_torch.obs.trace import Tracer, resolve_tracer
from repro_torch.optim.adamw import AdamW
from repro_torch.privacy.accountant import RdpAccountant
from repro_torch.privacy.dp import DPConfig, resolve_dp
from repro_torch.tree import PyTree, tree_leaves, tree_map

ENGINES = ("sequential", "vectorized")  # the reference's order, which its error messages print
AGGREGATION_MODES = ("reduced", "grouped", "stacked")


# ---------------------------------------------------------------------------
# policy protocols
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RecruitmentDecision:
    """What a recruitment policy returns: the federation, plus optional detail."""

    federation_ids: np.ndarray            # sorted client ids admitted to the federation
    detail: RecruitmentResult | None = None  # nu/iota accounting when the policy has it


class RecruitmentPolicy:
    """Decides, once, which candidate clients form the federation.

    Policies see only the disclosure tuples ``(P_co, n_c)``.  ``rng`` is a
    dedicated generator for stochastic policies.
    """

    def recruit(
        self, stats: Sequence[ClientStats], rng: np.random.Generator
    ) -> RecruitmentDecision:
        raise NotImplementedError


class SelectionPolicy:
    """Decides which federation members train in one round.

    ``rng`` is the run's shared numpy generator.  Implementations return
    participant ids in sorted order.  ``observe`` receives the participants
    and their mean local losses after every round.
    """

    def select(
        self, round_index: int, federation_ids: np.ndarray, rng: np.random.Generator
    ) -> np.ndarray:
        raise NotImplementedError

    def observe(self, participant_ids: np.ndarray, losses: np.ndarray) -> None:
        pass

    def state_dict(self) -> dict:
        """JSON-serializable adaptive state for checkpoint/resume.

        Stateless policies (the default) return ``{}``; adaptive ones
        (e.g. loss-weighted) must round-trip everything ``observe``
        accumulated, or a resumed run diverges from the uninterrupted one.
        """
        return {}

    def load_state_dict(self, state: dict) -> None:
        pass


class Aggregator:
    """Combines one round's client updates into the new global params.

    ``mode`` tells the round program how updates must be delivered:
    ``"reduced"`` — the engine's weighted FedAvg reduction is this
    aggregator's exact result; ``"grouped"`` — one engine round per
    ``groups(...)`` partition, then ``aggregate`` over the stacked group
    means weighted by the groups' sample counts; ``"stacked"`` — every
    client's params from the per-client trainer, then ``aggregate``.
    (``"buffered"`` is the async runtime's mode, ``runtime/staleness.py``;
    the synchronous ``Federation`` rejects it.)
    """

    mode: str = "stacked"

    def aggregate(self, stacked: PyTree, weights: np.ndarray) -> PyTree:
        """Reduce a client-stacked tree (leading client axis) to params."""
        raise NotImplementedError

    def groups(self, participant_ids: np.ndarray) -> list[np.ndarray]:
        """Partition participants for ``mode == "grouped"`` aggregators."""
        raise NotImplementedError


# ---------------------------------------------------------------------------
# string registries
# ---------------------------------------------------------------------------

_RECRUITMENTS: dict[str, Callable[..., RecruitmentPolicy]] = {}
_SELECTIONS: dict[str, Callable[..., SelectionPolicy]] = {}
_AGGREGATORS: dict[str, Callable[..., Aggregator]] = {}


def _register(registry: dict, name: str):
    def deco(factory):
        registry[name] = factory
        return factory
    return deco


def register_recruitment(name: str):
    """Register a recruitment factory under ``name`` (``@register_recruitment("x")``)."""
    return _register(_RECRUITMENTS, name)


def register_selection(name: str):
    return _register(_SELECTIONS, name)


def register_aggregator(name: str):
    return _register(_AGGREGATORS, name)


def _parse_arg(token: str):
    token = token.strip()
    try:
        return int(token)
    except ValueError:
        pass
    try:
        return float(token)
    except ValueError:
        return token


def _resolve(registry: dict, spec, kind: str, base: type):
    if isinstance(spec, base):
        return spec
    if not isinstance(spec, str):
        raise TypeError(f"{kind} must be a {base.__name__} or a spec string, got {type(spec).__name__}")
    name, _, rest = spec.partition(":")
    if name not in registry:
        known = ", ".join(sorted(registry))
        close = difflib.get_close_matches(name, registry, n=1)
        hint = f"; did you mean {close[0]!r}?" if close else ""
        raise ValueError(
            f"unknown {kind} policy {name!r}{hint}; choose from: {known}"
        )
    args = [_parse_arg(t) for t in rest.split(",")] if rest else []
    return registry[name](*args)


def resolve_recruitment(spec) -> RecruitmentPolicy:
    """``"nu-greedy"`` / ``"nu-greedy:0.5,0.5,0.1"`` / instance -> policy."""
    return _resolve(_RECRUITMENTS, spec, "recruitment", RecruitmentPolicy)


def resolve_selection(spec) -> SelectionPolicy:
    """``"uniform"`` / ``"uniform:0.1"`` / ``"round-robin:4"`` / instance -> policy."""
    return _resolve(_SELECTIONS, spec, "selection", SelectionPolicy)


# The privacy tier's aggregators ("secagg-fedavg", "krum") and the async
# runtime's buffered ones ("fedbuff", "hierarchical-async") register when
# their modules load.  Those modules import this one, so the registry loads
# them on first use rather than at import, which keeps the imports acyclic.
_AGGREGATOR_MODULES = (
    "repro_torch.privacy.secagg",
    "repro_torch.privacy.adversary",
    "repro_torch.federated.runtime.staleness",
)


def _load_aggregators() -> None:
    for name in _AGGREGATOR_MODULES:
        importlib.import_module(name)


def resolve_aggregator(spec) -> Aggregator:
    """``"fedavg"`` / ``"trimmed-mean:0.1"`` / ``"fedbuff:8"`` / instance -> policy."""
    _load_aggregators()
    return _resolve(_AGGREGATORS, spec, "aggregator", Aggregator)


def available_policies() -> dict[str, tuple[str, ...]]:
    """Registered spec names per stage — the discoverable policy surface."""
    _load_aggregators()
    return {
        "recruitment": tuple(sorted(_RECRUITMENTS)),
        "selection": tuple(sorted(_SELECTIONS)),
        "aggregator": tuple(sorted(_AGGREGATORS)),
    }


# ---------------------------------------------------------------------------
# recruitment policies
# ---------------------------------------------------------------------------


@register_recruitment("all")
class AllRecruitment(RecruitmentPolicy):
    """Everyone joins — standard FL (the paper's ac/sc baselines)."""

    def recruit(self, stats, rng) -> RecruitmentDecision:
        ids = np.array(sorted(s.client_id for s in stats), dtype=np.int64)
        return RecruitmentDecision(federation_ids=ids)


class NuGreedyRecruitment(RecruitmentPolicy):
    """The paper's greedy threshold rule (section 4.2) over nu_c.

    Spec forms: ``"nu-greedy"`` (BALANCED), ``"nu-greedy:quality-greedy"``
    (a section 6.2 preset), or ``"nu-greedy:gamma_dv,gamma_sa,gamma_th"``.
    """

    def __init__(self, config: RecruitmentConfig = BALANCED) -> None:
        self.config = config

    def recruit(self, stats, rng) -> RecruitmentDecision:
        result = recruit(stats, self.config)
        return RecruitmentDecision(
            federation_ids=np.sort(result.recruited_ids), detail=result
        )


@register_recruitment("nu-greedy")
def _nu_greedy(*args) -> NuGreedyRecruitment:
    if not args:
        return NuGreedyRecruitment(BALANCED)
    if len(args) == 1 and isinstance(args[0], str):
        return NuGreedyRecruitment(preset_recruitment(args[0]))
    if len(args) == 3:
        return NuGreedyRecruitment(RecruitmentConfig(*[float(a) for a in args]))
    raise ValueError(
        "nu-greedy spec takes no args, one preset name, or gamma_dv,gamma_sa,gamma_th"
    )


@register_recruitment("random-k")
class RandomKRecruitment(RecruitmentPolicy):
    """Recruit ``k`` clients uniformly at random — the recruitment control."""

    def __init__(self, k: int) -> None:
        if int(k) < 1:
            raise ValueError(f"random-k needs k >= 1, got {k}")
        self.k = int(k)

    def recruit(self, stats, rng) -> RecruitmentDecision:
        ids = np.array(sorted(s.client_id for s in stats), dtype=np.int64)
        k = min(self.k, len(ids))
        return RecruitmentDecision(np.sort(rng.choice(ids, size=k, replace=False)))


@register_recruitment("top-n-samples")
class TopNSamplesRecruitment(RecruitmentPolicy):
    """Recruit the ``n`` clients with the most local samples (ties: lower id)."""

    def __init__(self, n: int) -> None:
        if int(n) < 1:
            raise ValueError(f"top-n-samples needs n >= 1, got {n}")
        self.n = int(n)

    def recruit(self, stats, rng) -> RecruitmentDecision:
        ids = np.array([s.client_id for s in stats], dtype=np.int64)
        sizes = np.array([s.n for s in stats], dtype=np.int64)
        order = np.lexsort((ids, -sizes))
        return RecruitmentDecision(np.sort(ids[order[: min(self.n, len(ids))]]))


# ---------------------------------------------------------------------------
# selection policies
# ---------------------------------------------------------------------------


def _frac_or_count(arg) -> dict[str, Any]:
    """Spec arg -> kwargs: a float is a participation fraction, an int a count.

    ``"uniform:0.1"`` samples 10%, ``"uniform:12"`` samples 12 clients, so
    full participation by fraction is spelled ``"uniform:1.0"``.
    """
    if arg is None:
        return {}
    if isinstance(arg, float):
        return {"fraction": arg}
    if isinstance(arg, int):
        return {"count": arg}
    raise ValueError(f"selection arg must be a fraction or a count, got {arg!r}")


def _check_frac_count(fraction: float | None, count: int | None) -> None:
    """Fail at policy construction, not mid-run, on a bad participation spec."""
    if fraction is not None and count is not None:
        raise ValueError("give fraction or count, not both")
    if fraction is not None and not (0.0 < fraction <= 1.0):
        raise ValueError(f"fraction must be in (0, 1], got {fraction}")
    if count is not None and int(count) < 1:
        raise ValueError(f"count must be >= 1, got {count}")


def _round_count(fraction: float | None, count: int | None, n: int) -> int:
    if fraction is None and count is None:
        return n
    if count is not None:
        return min(int(count), n)
    return max(1, int(round(fraction * n)))


class UniformSelection(SelectionPolicy):
    """The paper's per-round sampling: uniform without replacement.

    ``fraction``/``count`` both ``None`` means every federation member
    participates every round (the ac/arc settings).
    """

    def __init__(self, fraction: float | None = None, count: int | None = None) -> None:
        _check_frac_count(fraction, count)
        self.fraction, self.count = fraction, count

    def select(self, round_index, federation_ids, rng) -> np.ndarray:
        return select_clients(rng, federation_ids, fraction=self.fraction, count=self.count)


@register_selection("uniform")
def _uniform(arg=None) -> UniformSelection:
    return UniformSelection(**_frac_or_count(arg))


class RoundRobinSelection(SelectionPolicy):
    """Deterministic rotation through the sorted federation — no RNG at all."""

    def __init__(self, fraction: float | None = None, count: int | None = None) -> None:
        _check_frac_count(fraction, count)
        self.fraction, self.count = fraction, count

    def select(self, round_index, federation_ids, rng) -> np.ndarray:
        count = _round_count(self.fraction, self.count, len(federation_ids))
        return round_robin_clients(round_index, federation_ids, count)


@register_selection("round-robin")
def _round_robin(arg=None) -> RoundRobinSelection:
    return RoundRobinSelection(**_frac_or_count(arg))


class LossWeightedSelection(SelectionPolicy):
    """Sample proportionally to each client's last observed local loss.

    Clients not yet observed weigh in at the mean observed loss (or
    uniformly before any observation).
    """

    def __init__(self, fraction: float | None = None, count: int | None = None) -> None:
        _check_frac_count(fraction, count)
        self.fraction, self.count = fraction, count
        self._loss: dict[int, float] = {}

    def observe(self, participant_ids, losses) -> None:
        for cid, loss in zip(np.asarray(participant_ids), np.asarray(losses)):
            if np.isfinite(loss):
                self._loss[int(cid)] = float(loss)

    def state_dict(self) -> dict:
        return {"loss": {str(cid): loss for cid, loss in self._loss.items()}}

    def load_state_dict(self, state: dict) -> None:
        self._loss = {int(cid): float(v) for cid, v in state.get("loss", {}).items()}

    def select(self, round_index, federation_ids, rng) -> np.ndarray:
        ids = np.asarray(federation_ids)
        count = _round_count(self.fraction, self.count, len(ids))
        default = float(np.mean(list(self._loss.values()))) if self._loss else 1.0
        w = np.array([self._loss.get(int(c), default) for c in ids], dtype=np.float64)
        w = np.maximum(w, 1e-12)
        chosen = rng.choice(ids, size=count, replace=False, p=w / w.sum())
        return np.sort(chosen)


@register_selection("loss-weighted")
def _loss_weighted(arg=None) -> LossWeightedSelection:
    return LossWeightedSelection(**_frac_or_count(arg))


# ---------------------------------------------------------------------------
# aggregators
# ---------------------------------------------------------------------------


@register_aggregator("fedavg")
class FedAvgAggregator(Aggregator):
    """Sample-size-weighted parameter averaging (McMahan et al. 2017)."""

    mode = "reduced"

    def aggregate(self, stacked, weights):
        return aggregate_stacked(stacked, weights)


@register_aggregator("trimmed-mean")
class TrimmedMeanAggregator(Aggregator):
    """Coordinate-wise trimmed mean (Yin et al. 2018) — outlier-robust.

    Drops the ``floor(trim * C)`` smallest and largest values of every
    coordinate across the client axis, then averages the rest (unweighted).
    ``trim = 0`` is the plain coordinate mean.
    """

    mode = "stacked"

    def __init__(self, trim: float = 0.1) -> None:
        check_trim(trim)
        self.trim = float(trim)

    def aggregate(self, stacked, weights):
        return trimmed_mean_stacked(stacked, self.trim)


@register_aggregator("hierarchical")
class HierarchicalFedAvg(Aggregator):
    """Two-level FedAvg: regional sub-federations reduce first.

    Participants are split into ``num_regions`` contiguous groups; each
    group runs one engine round, then the group means are FedAvg-ed with
    the groups' total sample weights.  Numerically this telescopes to flat
    FedAvg.
    """

    mode = "grouped"

    def __init__(self, num_regions: int = 2) -> None:
        if int(num_regions) < 1:
            raise ValueError(f"hierarchical needs >= 1 region, got {num_regions}")
        self.num_regions = int(num_regions)

    def groups(self, participant_ids) -> list[np.ndarray]:
        ids = np.asarray(participant_ids)
        parts = np.array_split(ids, min(self.num_regions, len(ids)))
        return [p for p in parts if len(p)]

    def aggregate(self, stacked, weights):
        return aggregate_stacked(stacked, weights)


# ---------------------------------------------------------------------------
# run records
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RoundRecord:
    round_index: int
    participant_ids: list[int]       # sorted — the cohort stacking order
    mean_local_loss: float
    local_steps: int
    params_down: int                 # parameter tensors broadcast server -> clients
    params_up: int                   # parameter tensors returned clients -> server
    bytes_transferred: int           # down + up, from the param tree's real sizes
    wall_time_s: float
    # Async runtime (federated/runtime/): the virtual clock at the flush and
    # the flush's mean update staleness in server versions; None on
    # synchronous rounds.
    virtual_time: float | None = None
    staleness: float | None = None
    # DP runs only: the cumulative (epsilon, delta)-DP budget through this
    # round; None on unprotected runs.
    epsilon: float | None = None

    @property
    def round_time_s(self) -> float:
        """Host wall-clock this round took, results on the host included."""
        return self.wall_time_s

    def to_state(self) -> dict:
        """JSON-serializable form — one JSONL line of the record stream,
        with the reference's field names."""
        state = dataclasses.asdict(self)
        state["round_time_s"] = state.pop("wall_time_s")
        return state

    @classmethod
    def from_state(cls, state: dict) -> "RoundRecord":
        """The inverse of :meth:`to_state`; the legacy ``wall_time_s`` key
        is accepted too."""
        state = dict(state)
        if "round_time_s" in state:
            state["wall_time_s"] = state.pop("round_time_s")
        return cls(**state)


@dataclasses.dataclass
class FederatedRunResult:
    params: PyTree
    history: list[RoundRecord]
    recruitment: RecruitmentResult | None
    federation_ids: np.ndarray
    total_wall_time_s: float
    total_local_steps: int
    # The run's final metrics snapshot (repro_torch.obs.MetricsRegistry):
    # staging/pool counters, comms bytes, DP epsilon, round times and losses.
    metrics: dict[str, Any] | None = None

    def summary(self) -> dict[str, Any]:
        # Async-runtime totals: the simulated clock at the last flush and
        # the mean update staleness — None on synchronous runs, where no
        # record carries a virtual time.
        async_records = [r for r in self.history if r.virtual_time is not None]
        return {
            "rounds": len(self.history),
            "federation_size": int(self.federation_ids.size),
            "recruited": None if self.recruitment is None else self.recruitment.num_recruited,
            "total_wall_time_s": self.total_wall_time_s,
            "total_round_time_s": sum(r.round_time_s for r in self.history),
            "total_local_steps": self.total_local_steps,
            "params_down": sum(r.params_down for r in self.history),
            "params_up": sum(r.params_up for r in self.history),
            "bytes_transferred": sum(r.bytes_transferred for r in self.history),
            "virtual_time": max(r.virtual_time for r in async_records)
            if async_records
            else None,
            # Weight each flush by its participant count so the figure
            # reads as mean staleness per *update*, not per flush — a
            # one-update forced flush must not count like a full buffer.
            "mean_staleness": float(
                np.average(
                    [r.staleness for r in async_records],
                    weights=[max(len(r.participant_ids), 1) for r in async_records],
                )
            )
            if async_records
            else None,
            # DP runs: the final cumulative privacy budget (the last
            # record's epsilon — the accountant only ever grows it).
            "epsilon": next(
                (r.epsilon for r in reversed(self.history) if r.epsilon is not None), None
            ),
            "metrics": self.metrics,
        }


# ---------------------------------------------------------------------------
# checkpoint / resume
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FederationSnapshot:
    """Everything ``Federation.run`` needs to continue from a round boundary.

    Captured by the ``snapshot_hook`` after each round's record lands (and
    after ``progress``) and fed back through ``Federation.run(...,
    resume=snapshot)``: the resumed run restores the params exactly (npz
    round trips are bit-exact), both numpy streams, the record history and
    any adaptive selection-policy state, so it consumes the batches and
    dropout generators the uninterrupted run would have.  Recruitment is not
    snapshotted: it derives from the seed and is re-run on resume.

    One field differs from the reference's snapshot: in place of
    ``jax_key_data`` (the raw data of the reference's jax key chain) it
    holds ``generator_rng_state``, the ``bit_generator.state`` of the
    dropout-generator stream ``default_rng([seed, 2])``, from which each
    round draws its participants' ``torch.Generator`` seeds.
    """

    round_index: int              # the next round to run
    params: PyTree
    np_rng_state: dict            # batch-plan generator bit_generator.state
    generator_rng_state: dict     # dropout-generator stream bit_generator.state
    history: list[RoundRecord]
    selection_state: dict

    def save(self, directory: str, extra_state: dict | None = None) -> None:
        """Persist atomically via ``repro_torch.checkpoint.store`` (overwrites)."""
        from repro_torch.checkpoint.store import save_federation_snapshot

        state = {
            "kind": "sync",
            "round_index": int(self.round_index),
            "np_rng_state": self.np_rng_state,
            "generator_rng_state": self.generator_rng_state,
            "history": [r.to_state() for r in self.history],
            "selection_state": self.selection_state,
        }
        state.update(extra_state or {})
        save_federation_snapshot(directory, trees={"params": self.params}, state=state)

    @classmethod
    def load(cls, directory: str, like_params: PyTree) -> "FederationSnapshot":
        """The snapshot in ``directory``; params take ``like_params``'s
        dtypes and devices."""
        from repro_torch.checkpoint.store import load_federation_snapshot

        trees, _, state = load_federation_snapshot(directory, like_params)
        if state.get("kind") != "sync":
            raise ValueError(
                f"snapshot in {directory} is {state.get('kind')!r}, not a "
                "synchronous federation snapshot"
            )
        return cls(
            round_index=int(state["round_index"]),
            params=trees["params"],
            np_rng_state=state["np_rng_state"],
            generator_rng_state=generator_rng_state(state, directory),
            history=[RoundRecord.from_state(r) for r in state["history"]],
            selection_state=state.get("selection_state", {}),
        )


def generator_rng_state(state: dict, directory: str) -> dict:
    """A snapshot's dropout-generator stream state; a snapshot of the JAX
    package carries its jax key data instead, and the port cannot continue
    that run (its dropout and noise streams are jax's)."""
    if "generator_rng_state" not in state:
        raise ValueError(
            f"snapshot in {directory} holds no generator_rng_state (a snapshot "
            "written by the JAX package holds jax key data instead); the port "
            "cannot resume it"
        )
    return state["generator_rng_state"]


# ---------------------------------------------------------------------------
# the facade
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FederationConfig:
    """Declarative federation: every stage is a policy spec or instance."""

    rounds: int = 15
    local_epochs: int = 4
    batch_size: int = 128
    recruitment: str | RecruitmentPolicy = "all"
    selection: str | SelectionPolicy = "uniform"
    aggregator: str | Aggregator = "fedavg"
    seed: int = 0
    # "vectorized" (batched steps over a chunk of clients) or "sequential"
    # (one client at a time).
    engine: str = "vectorized"
    # Vectorized engine: clients per batched step (None = the whole cohort).
    cohort_chunk: int | None = None
    # Vectorized engine: the client axis over several processes
    # (launch/mesh.py): a DataMesh, or "auto" for the default process
    # group's world when it has more than one rank (else no mesh).
    mesh: Any = None
    # Vectorized engine: in-place accumulator, staged chunks released early.
    donate_buffers: bool = True
    # Vectorized engine: "resident" uploads the federation's train arrays
    # once and stages int32 index plans per round; "rebuild" re-stages the
    # whole schedule every round (the staging reference).
    staging: str = "resident"
    # Resident staging: build and copy chunk k+1's plan while chunk k trains.
    prefetch: bool = True
    # Resident staging: bound the device cohort to this many bytes (an LRU
    # pool of client rows, filled per round).  None = the whole federation.
    resident_budget_bytes: int | None = None
    # DP-SGD (privacy/dp.py): a DPConfig, a job-spec dict ({"clip_norm": ...,
    # "noise_multiplier": ..., "delta": ...}), or None.  When set, every local
    # step clips per-example gradients and adds calibrated Gaussian noise,
    # and each RoundRecord carries the accountant's cumulative epsilon.
    privacy: DPConfig | dict | None = None

    def __post_init__(self) -> None:
        if self.engine not in ENGINES:
            raise ValueError(f"unknown engine {self.engine!r}; choose from {ENGINES}")
        if self.staging not in STAGING_MODES:
            raise ValueError(
                f"unknown staging {self.staging!r}; choose from {STAGING_MODES}"
            )


class Federation:
    """Runs the round program over in-process clients with pluggable policies.

    ``Federation(config, clients, loss_fn, optimizer, device=None)`` resolves
    the three policy stages up front (unknown spec strings fail here, not
    mid-run).  ``device`` defaults to the card.  ``metrics`` is the registry
    each round is folded into (a new one when ``None``); ``tracer`` records
    the round program's spans (``None`` is the no-op tracer) and
    ``profiler`` brackets each round (``RoundProfiler``, or ``None``).
    """

    def __init__(
        self,
        config: FederationConfig,
        clients: Sequence[ClientDataset],
        loss_fn: Callable[..., Any],
        optimizer: AdamW,
        device: str | torch.device | None = None,
        tracer: Tracer | None = None,
        metrics: MetricsRegistry | None = None,
        profiler: Any = None,
    ) -> None:
        self.config = config
        # Observability: the null tracer keeps the uninstrumented hot path
        # at a handful of no-op calls per round; the registry always exists
        # so run summaries carry the staging/comms counters either way.
        self.tracer = resolve_tracer(tracer)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.profiler = profiler
        self.recruitment_policy = resolve_recruitment(config.recruitment)
        self.selection_policy = resolve_selection(config.selection)
        self.aggregator = resolve_aggregator(config.aggregator)
        if self.aggregator.mode == "buffered":
            raise ValueError(
                f"aggregator {config.aggregator!r} is asynchronous "
                "(mode='buffered'); run it with "
                "repro_torch.federated.runtime.AsyncFederation instead of the "
                "synchronous Federation"
            )
        if self.aggregator.mode not in AGGREGATION_MODES:
            raise ValueError(
                f"aggregator mode {self.aggregator.mode!r} not in {AGGREGATION_MODES}"
            )
        self.all_clients = {c.client_id: c for c in clients}
        self.dp = resolve_dp(config.privacy)
        self.trainer = LocalTrainer(
            loss_fn=loss_fn,
            optimizer=optimizer,
            batch_size=config.batch_size,
            local_epochs=config.local_epochs,
            device=device,
            dp=self.dp,
        )
        self.device = self.trainer.device
        self.cohort_trainer = CohortTrainer(
            loss_fn=loss_fn,
            optimizer=optimizer,
            batch_size=config.batch_size,
            local_epochs=config.local_epochs,
            cohort_chunk=config.cohort_chunk,
            mesh=config.mesh,
            donate=config.donate_buffers,
            staging=config.staging,
            prefetch=config.prefetch,
            resident_budget_bytes=config.resident_budget_bytes,
            dp=self.dp,
            tracer=self.tracer,
            device=self.device,
        )

    @property
    def effective_engine(self) -> str:
        """The engine rounds actually run on: stacked-mode aggregators need
        every client's params, so they run the per-client trainer whatever
        ``config.engine`` says."""
        return "sequential" if self.aggregator.mode == "stacked" else self.config.engine

    # -- stage 1: build_federation ------------------------------------------

    def build_federation(
        self, rng: np.random.Generator | None = None
    ) -> tuple[np.ndarray, RecruitmentResult | None]:
        """Recruitment happens here — before the federation exists."""
        if rng is None:
            rng = np.random.default_rng([self.config.seed, 1])
        all_ids = sorted(self.all_clients)
        stats = [self.all_clients[i].stats() for i in all_ids]
        decision = self.recruitment_policy.recruit(stats, rng)
        ids = np.sort(np.asarray(decision.federation_ids, dtype=np.int64))
        unknown = set(ids.tolist()) - set(all_ids)
        if unknown:
            raise ValueError(f"recruitment returned unknown client ids: {sorted(unknown)}")
        if ids.size == 0:
            raise ValueError("recruitment returned an empty federation")
        return ids, decision.detail

    # -- stages 3+4: train + aggregate --------------------------------------

    def _train_group(
        self, params: PyTree, group: np.ndarray, rng, generators, spe: int
    ) -> tuple[PyTree, np.ndarray, int]:
        """One engine round over ``group``: FedAvg-reduced params, each
        client's mean local loss and the real local steps."""
        cohort = [self.all_clients[int(cid)] for cid in group]
        if self.config.engine == "vectorized":
            return self.cohort_trainer.train_cohort(
                params, cohort, rng, generators, steps_per_epoch=spe
            )
        client_params, weights, losses, steps = self._train_clients(
            params, cohort, rng, generators
        )
        return aggregate_stacked(stack_trees(client_params), weights), losses, steps

    def _train_clients(self, params: PyTree, cohort, rng, generators):
        """The per-client trainer over ``cohort``: each client's params,
        sample count and mean local loss, and the real local steps."""
        client_params, weights, losses, steps = [], [], [], 0
        for client, generator in zip(cohort, generators):
            new_params, loss, n_c = self.trainer.train_client(params, client, rng, generator)
            client_params.append(new_params)
            weights.append(n_c)
            losses.append(loss)
            steps += self.trainer.steps_per_round(client)
        return (client_params, np.asarray(weights, dtype=np.float32),
                np.asarray(losses, dtype=np.float32), steps)

    def _train_round(
        self, params: PyTree, participants: np.ndarray, rng, generators, spe: int
    ) -> tuple[PyTree, np.ndarray, int]:
        """train -> aggregate for one round, dispatched on the aggregator
        mode.  ``generators`` holds one per participant; grouped rounds hand
        them out in the order of the groups' concatenation."""
        mode = self.aggregator.mode
        if mode == "reduced":
            return self._train_group(params, participants, rng, generators, spe)

        if mode == "grouped":
            groups = self.aggregator.groups(participants)
            flat = np.concatenate([np.asarray(g) for g in groups]) if groups else np.array([])
            if sorted(flat.tolist()) != sorted(np.asarray(participants).tolist()):
                raise ValueError("aggregator groups must partition the participants")
            group_params, group_w, losses, steps, used = [], [], [], 0, 0
            for group in groups:
                p_g, losses_g, steps_g = self._train_group(
                    params, group, rng, generators[used : used + len(group)], spe
                )
                used += len(group)
                group_params.append(p_g)
                group_w.append(sum(self.all_clients[int(c)].n_train for c in group))
                losses.append(losses_g)
                steps += steps_g
            with self.tracer.span("aggregate", groups=len(groups)):
                new_params = self.aggregator.aggregate(
                    stack_trees(group_params), np.asarray(group_w, dtype=np.float32)
                )
            return new_params, np.concatenate(losses), steps

        # mode == "stacked": the aggregator needs every client's params, which
        # the vectorized engine's reduction never forms, so these rounds run
        # the per-client trainer whatever the engine setting.
        cohort = [self.all_clients[int(cid)] for cid in participants]
        client_params, weights, losses, steps = self._train_clients(
            params, cohort, rng, generators
        )
        with self.tracer.span("aggregate", clients=len(participants)):
            new_params = self.aggregator.aggregate(stack_trees(client_params), weights)
        return new_params, losses, steps

    # -- observability --------------------------------------------------------

    def _absorb_round_metrics(self, record: RoundRecord) -> None:
        """Fold a finished round into the metrics registry.

        The record's comms accounting and loss, and the cohort engine's
        ``last_round_stats`` (staged bytes, prefetched plans, pool uploads
        and evictions), become the typed counters, gauges and histograms
        the control plane streams as ``metrics.jsonl``, under the
        reference's names — except the engine's peak, which is the card's
        allocator peak here (``staging.peak_device_bytes``, set on the card
        only) where the reference estimates live bytes
        (``staging.peak_live_bytes``).
        """
        m = self.metrics
        m.counter("rounds.completed").inc()
        m.counter("comms.params_down").inc(record.params_down)
        m.counter("comms.params_up").inc(record.params_up)
        m.counter("comms.bytes_down").inc(record.bytes_transferred // 2)
        m.counter("comms.bytes_up").inc(
            record.bytes_transferred - record.bytes_transferred // 2
        )
        m.counter("train.local_steps").inc(record.local_steps)
        m.histogram("round.time_s").observe(record.wall_time_s)
        if np.isfinite(record.mean_local_loss):
            m.histogram("round.loss").observe(record.mean_local_loss)
        if record.epsilon is not None:
            m.gauge("privacy.epsilon").set(record.epsilon)
        if record.staleness is not None:
            m.histogram("async.staleness").observe(record.staleness)
        if record.virtual_time is not None:
            m.gauge("async.virtual_time").set(record.virtual_time)
        stats = self.cohort_trainer.last_round_stats
        if stats:
            m.counter("staging.bytes_staged").inc(stats.get("bytes_staged", 0))
            m.counter("staging.plans_prefetched").inc(stats.get("plans_prefetched", 0))
            m.counter("staging.chunks").inc(stats.get("chunks", 0))
            m.gauge("staging.bytes_resident").set(stats.get("bytes_resident", 0))
            if stats.get("peak_device_bytes") is not None:
                m.gauge("staging.peak_device_bytes").set(stats["peak_device_bytes"])
            if stats.get("pool"):
                m.counter("pool.uploads").inc(stats.get("pool_uploads", 0))
                m.counter("pool.evictions").inc(stats.get("pool_evictions", 0))
                m.counter("pool.hits").inc(stats.get("pool_hits", 0))
                m.counter("pool.bytes_uploaded").inc(stats.get("pool_bytes_uploaded", 0))

    # -- the round program ---------------------------------------------------

    def run(
        self,
        init_params: PyTree,
        progress: Callable[[RoundRecord], None] | None = None,
        snapshot_hook: Callable[[FederationSnapshot], None] | None = None,
        resume: FederationSnapshot | None = None,
    ) -> FederatedRunResult:
        """Run the round program (optionally resuming a snapshotted run).

        ``progress`` receives each :class:`RoundRecord` as it lands.
        ``snapshot_hook`` receives a :class:`FederationSnapshot` after every
        round, after ``progress``; the hook decides whether and where to
        persist it (it may also raise to preempt the run — nothing after
        the snapshot is lost).  ``resume`` continues a run from such a
        snapshot: recruitment runs again, resident staging attaches again
        (its time falls in no round), the restored streams make the
        continuation consume the batches and generators the uninterrupted
        run would have, and a DP run's accountant replays the completed
        rounds' sampling rates.  ``total_wall_time_s`` counts only the
        resumed segment; ``history`` and ``total_local_steps`` span the
        whole run.
        """
        cfg = self.config
        rng = np.random.default_rng(cfg.seed)
        generator_rng = np.random.default_rng([cfg.seed, 2])

        federation_ids, recruitment = self.build_federation()
        if self.effective_engine == "vectorized" and cfg.staging == "resident":
            # One upload of the recruited federation; every round after it
            # stages int32 index plans.  Its time is the device cohort's
            # ``attach_seconds``, in no round's time.
            self.cohort_trainer.attach_device_cohort(
                [self.all_clients[int(i)] for i in federation_ids]
            )
        # The vectorized schedule's step axis is the federation-wide max,
        # whatever mix a round samples.
        federation_spe = cohort_steps_per_epoch(
            [self.all_clients[int(i)].n_train for i in federation_ids], cfg.batch_size
        )
        # One Rényi accountant per run: stepped once per round at that round's
        # client sampling rate, read for every RoundRecord.
        accountant = (
            RdpAccountant(self.dp.noise_multiplier, delta=self.dp.delta)
            if self.dp is not None
            else None
        )
        params = tree_map(lambda p: p.detach().to(self.device), init_params)
        history: list[RoundRecord] = []
        start_round = 0
        if resume is not None:
            if not (0 <= int(resume.round_index) <= cfg.rounds):
                raise ValueError(
                    f"snapshot round_index {resume.round_index} outside the "
                    f"configured {cfg.rounds}-round budget"
                )
            params = tree_map(lambda p: p.detach().to(self.device), resume.params)
            start_round = int(resume.round_index)
            rng.bit_generator.state = resume.np_rng_state
            generator_rng.bit_generator.state = resume.generator_rng_state
            history = list(resume.history)
            self.selection_policy.load_state_dict(resume.selection_state)
            if accountant is not None:
                # Privacy loss composes over the whole run: replay the
                # completed rounds' sampling rates so the resumed segment's
                # epsilons continue the original accounting.
                for past in history:
                    accountant.step(len(past.participant_ids) / federation_ids.size)
        # Communication accounting: each participant receives the full param
        # tree and returns one of the same shape.
        n_tensors = len(tree_leaves(init_params))
        model_nbytes = params_nbytes(init_params)
        tracer = self.tracer
        t_start = time.perf_counter()

        with CompileWatcher(self.metrics) as watcher:
            for rnd in range(start_round, cfg.rounds):
                if self.profiler is not None:
                    self.profiler.round_start(rnd)
                t_round = time.perf_counter()
                with tracer.span("select", round=rnd):
                    participants = np.asarray(
                        self.selection_policy.select(rnd, federation_ids, rng)
                    )
                if not (
                    len(participants) > 0
                    and np.all(np.diff(participants) > 0)
                    and set(participants.tolist()) <= set(federation_ids.tolist())
                ):
                    raise ValueError(
                        "selection must return a non-empty, strictly sorted subset "
                        "of the federation"
                    )
                with tracer.span("train", round=rnd, participants=len(participants)):
                    with tracer.span("generators"):
                        generators = client_generators(
                            generator_rng, len(participants), self.device
                        )
                    # The per-client loss readbacks inside wait for the
                    # clients' steps.
                    params, losses, steps = self._train_round(
                        params, participants, rng, generators, federation_spe
                    )
                self.selection_policy.observe(participants, losses)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)  # the aggregate is done too
                epsilon = None
                if accountant is not None:
                    accountant.step(len(participants) / federation_ids.size)
                    epsilon = accountant.epsilon()
                wall = time.perf_counter() - t_round
                record = RoundRecord(
                    round_index=rnd,
                    participant_ids=[int(c) for c in participants],
                    mean_local_loss=float(np.nanmean(losses)) if len(losses) else float("nan"),
                    local_steps=steps,
                    params_down=len(participants) * n_tensors,
                    params_up=len(participants) * n_tensors,
                    bytes_transferred=2 * len(participants) * model_nbytes,
                    wall_time_s=wall,
                    epsilon=epsilon,
                )
                # The round span reuses the record's own start and duration,
                # so the trace reconciles exactly with round_time_s.
                tracer.complete(
                    "round",
                    start=tracer.host_ts(t_round),
                    dur=wall,
                    round=rnd,
                    participants=len(participants),
                )
                history.append(record)
                watcher.poll()
                self._absorb_round_metrics(record)
                if progress is not None:
                    progress(record)
                if snapshot_hook is not None:
                    with tracer.span("checkpoint", round=rnd):
                        snapshot_hook(
                            FederationSnapshot(
                                round_index=rnd + 1,
                                params=params,
                                np_rng_state=rng.bit_generator.state,
                                generator_rng_state=generator_rng.bit_generator.state,
                                history=list(history),
                                selection_state=self.selection_policy.state_dict(),
                            )
                        )
                if self.profiler is not None:
                    self.profiler.round_end(rnd)

        return FederatedRunResult(
            params=params,
            history=history,
            recruitment=recruitment,
            federation_ids=federation_ids,
            total_wall_time_s=time.perf_counter() - t_start,
            total_local_steps=sum(r.local_steps for r in history),
            metrics=self.metrics.snapshot(),
        )
