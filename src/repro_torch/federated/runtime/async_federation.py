"""``AsyncFederation`` — the event-driven twin of ``Federation``.

The port of the JAX package's ``federated/runtime/async_federation.py``.
The synchronous facade runs a fixed round program behind a barrier: select,
train everyone, aggregate, repeat.  This facade replaces the barrier with
the virtual-clock scheduler: every *task* (one client for ``fedbuff``, one
regional sub-federation for ``hierarchical-async``) is dispatched with the
current global params, takes its latency model's virtual time, and lands
in the server buffer when it completes; buffered aggregators decide when
the buffer flushes into a new parameter version.  Completed tasks wait for
the next flush before redispatching (dropped tasks retry immediately), so
a flush boundary is exactly a parameter-version boundary.

The engine hot path is untouched: each task executes through the same
``Federation._train_group`` primitive the synchronous round program uses —
one ``CohortTrainer.train_cohort`` call per task under the vectorized
engine (a one-client cohort for ``fedbuff``), the per-client trainer under
the sequential one.  The runtime only reorders *which* cohort chunks train
against *which* parameter version.  Under a mesh
(``AsyncFederationConfig.mesh``, the sync facade's field) every rank runs
the same event loop; a task's clients train on their ranks (a one-client
task on the rank that owns the client) and the others add zeros to the
task's all-reduce.

Seeded replay and the RNG contract
----------------------------------
An async run is a pure function of the seed.  Three streams advance in
*dispatch order*, which the deterministic scheduler fixes:

* the scheduler's own stream (``VirtualScheduler.rng``): every member's
  latency, then every member's dropout, at dispatch — byte for byte the
  reference's, so virtual times, event order and dropped tasks equal it;
* the batch-plan generator ``default_rng(seed)``, consumed by the task's
  schedule or plan, client-major;
* the dropout-generator stream ``default_rng([seed, 2])`` (the synchronous
  facade's): each dispatch draws one seed per *surviving* member
  (``cohort.client_generators``) and trains that member with a
  ``torch.Generator`` seeded with it.

So the degenerate configuration (``fedbuff:K`` with ``K`` = all
participants and a zero-spread latency model) consumes the same plans and
the same generator seeds as a synchronous flat FedAvg round — the 1e-5
parity gate — because ``client_generators`` drawn one at a time equals one
draw of ``n``.

Timeline bookkeeping lands where the synchronous records already live:
each flush appends a :class:`~repro_torch.federated.api.RoundRecord` whose
``virtual_time`` / ``staleness`` fields are populated, and
``FederatedRunResult.summary()`` totals them alongside the host wall clock,
so recruited-vs-all comparisons can quote *simulated time-to-target-loss*.

Checkpoint/resume: ``run(snapshot_hook=)`` receives an
:class:`AsyncFederationSnapshot` after every non-final flush and
``run(resume=)`` continues from one — the scheduler's clock and stream, the
pending events with their trained updates, the buffer and the task queues,
the latency model's drawn rates, both numpy streams, the stats and the
history — so the remaining timeline replays exactly.  Each flush is folded
into the shared ``repro_torch.obs.MetricsRegistry`` (``metrics=``).  The
tracer and profiler (``tracer=``, ``profiler=``) are the sync facade's: the
host ``dispatch``, ``flush`` and ``checkpoint`` spans, the virtual-clock
``task`` spans on per-client tracks with a flow from the server, the
virtual ``flush`` instants and the scheduler's per-event instants.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.data.pipeline import ClientDataset, cohort_steps_per_epoch
from repro_torch.federated.api import (
    Aggregator,
    FederatedRunResult,
    Federation,
    FederationConfig,
    RoundRecord,
    generator_rng_state,
    resolve_aggregator,
)
from repro_torch.federated.cohort import client_generators
from repro_torch.federated.fedavg import params_nbytes
from repro_torch.federated.runtime.latency import (
    DropoutModel,
    LatencyModel,
    resolve_dropout,
    resolve_latency,
)
from repro_torch.federated.runtime.scheduler import Event, VirtualScheduler
from repro_torch.federated.runtime.staleness import AsyncAggregator, AsyncUpdate
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.profile import CompileWatcher
from repro_torch.obs.trace import Tracer
from repro_torch.optim.adamw import AdamW
from repro_torch.privacy.accountant import RdpAccountant
from repro_torch.tree import PyTree, tree_leaves, tree_map

# Event kinds on the virtual timeline.
COMPLETE = "complete"   # a dispatched task finished (payload: _Completion)
FLUSH = "flush"         # the buffer crosses the aggregator's threshold


@dataclasses.dataclass(frozen=True)
class AsyncFederationConfig(FederationConfig):
    """Declarative async federation: ``FederationConfig`` + the time axis.

    Inherited fields keep their meaning, with two async readings:
    ``rounds`` budgets *flushes* (server parameter versions — the async
    unit of progress), and ``selection`` is unused (the dispatch model —
    every task retrains as soon as the version it waits for exists — takes
    the place of per-round sampling).  ``aggregator`` must resolve to a
    buffered aggregator (``"fedbuff:K"`` / ``"hierarchical-async:R"`` or
    an ``AsyncAggregator`` instance).
    """

    aggregator: str | Aggregator = "fedbuff"
    # Virtual-time models, resolvable from spec strings like the policies.
    latency: str | LatencyModel = "constant"
    dropout: str | float | DropoutModel = "never"
    # Max tasks training concurrently (FedBuff's M_max); None = no cap.
    concurrency: int | None = None
    # Early stops: flush-loss target and a virtual-clock ceiling.  Both
    # None means the run uses its full ``rounds`` flush budget.
    target_loss: float | None = None
    max_virtual_time: float | None = None

    def __post_init__(self) -> None:
        super().__post_init__()
        if int(self.rounds) < 1:
            raise ValueError(f"need rounds >= 1 flush budget, got {self.rounds}")
        if self.concurrency is not None and int(self.concurrency) < 1:
            raise ValueError(f"concurrency must be >= 1, got {self.concurrency}")
        if self.max_virtual_time is not None and not (self.max_virtual_time > 0):
            raise ValueError(
                f"max_virtual_time must be > 0, got {self.max_virtual_time}"
            )


@dataclasses.dataclass
class _Completion:
    """COMPLETE event payload: which task finished, and with what."""

    group_index: int
    update: AsyncUpdate | None  # None = the task dropped out (no result)


# ---------------------------------------------------------------------------
# checkpoint / resume
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PendingEvent:
    """A serializable image of one not-yet-popped scheduler event.

    ``group_index``/``update`` unpack the COMPLETE payload (``update`` is
    ``None`` for dropped tasks *and* for non-COMPLETE kinds); ``seq`` is
    preserved so restored simultaneity resolves exactly as scheduled.
    """

    time: float
    seq: int
    kind: str
    group_index: int | None
    update: AsyncUpdate | None


def _pack_update(
    prefix: str, update: AsyncUpdate, trees: dict, arrays: dict
) -> dict:
    """Split one AsyncUpdate into (scalar dict, named trees, named arrays)."""
    trees[f"{prefix}.params"] = update.params
    trees[f"{prefix}.anchor"] = update.anchor
    arrays[f"{prefix}.losses"] = np.asarray(update.losses, dtype=np.float32)
    arrays[f"{prefix}.client_ids"] = np.asarray(update.client_ids, dtype=np.int64)
    return {
        "ref": prefix,
        "weight": float(update.weight),
        "version": int(update.version),
        "local_steps": int(update.local_steps),
    }


def _unpack_update(entry: dict, trees: dict, arrays: dict) -> AsyncUpdate:
    prefix = entry["ref"]
    return AsyncUpdate(
        client_ids=np.asarray(arrays[f"{prefix}.client_ids"]),
        params=trees[f"{prefix}.params"],
        anchor=trees[f"{prefix}.anchor"],
        weight=float(entry["weight"]),
        version=int(entry["version"]),
        losses=np.asarray(arrays[f"{prefix}.losses"], dtype=np.float32),
        local_steps=int(entry["local_steps"]),
    )


@dataclasses.dataclass
class AsyncFederationSnapshot:
    """Everything ``AsyncFederation.run`` needs to continue from a flush.

    Captured by the ``snapshot_hook`` right after a flush's record lands
    and the idle tasks are requeued (the point where the loop's next action
    — dispatching ready tasks — is the same whether the run continues or
    resumes).  Pending completions on the event heap carry fully trained
    updates (their params/anchors are saved by value), so a resumed run
    never retrains work that was already in flight; it only replays the
    timeline forward from restored streams.

    As in :class:`~repro_torch.federated.api.FederationSnapshot`, the
    reference's ``jax_key_data`` is replaced by ``generator_rng_state``, the
    state of the dropout-generator stream ``default_rng([seed, 2])``.
    """

    version: int                  # server parameter versions flushed so far
    params: PyTree
    np_rng_state: dict            # batch-plan generator state
    generator_rng_state: dict     # dropout-generator stream state
    sched_state: dict             # virtual clock / seq / processed / stream
    events: list[PendingEvent]    # the un-popped event heap
    buffer: list[AsyncUpdate]     # completions awaiting the next flush
    ready: list[int]              # task groups waiting for a dispatch slot
    idle: list[int]               # task groups waiting for the next flush
    in_flight: int
    drought: int
    flush_pending: bool
    latency_state: dict           # drawn persistent per-client rates
    stats: dict
    history: list[RoundRecord]

    @property
    def round_index(self) -> int:
        """Flush count — the async analogue of the sync snapshot's field."""
        return self.version

    def save(self, directory: str, extra_state: dict | None = None) -> None:
        """Persist atomically via ``repro_torch.checkpoint.store`` (overwrites)."""
        from repro_torch.checkpoint.store import save_federation_snapshot

        trees: dict[str, Any] = {"params": self.params}
        arrays: dict[str, np.ndarray] = {}
        events_state = []
        for i, event in enumerate(self.events):
            entry: dict[str, Any] = {
                "time": event.time,
                "seq": event.seq,
                "kind": event.kind,
                "group_index": event.group_index,
                "update": None,
            }
            if event.update is not None:
                entry["update"] = _pack_update(f"event{i}", event.update, trees, arrays)
            events_state.append(entry)
        buffer_state = [
            _pack_update(f"buffer{i}", u, trees, arrays) for i, u in enumerate(self.buffer)
        ]
        state = {
            "kind": "async",
            "version": int(self.version),
            "np_rng_state": self.np_rng_state,
            "generator_rng_state": self.generator_rng_state,
            "sched": self.sched_state,
            "events": events_state,
            "buffer": buffer_state,
            "ready": [int(i) for i in self.ready],
            "idle": [int(i) for i in self.idle],
            "in_flight": int(self.in_flight),
            "drought": int(self.drought),
            "flush_pending": bool(self.flush_pending),
            "latency_state": self.latency_state,
            "stats": self.stats,
            "history": [r.to_state() for r in self.history],
        }
        state.update(extra_state or {})
        save_federation_snapshot(directory, trees=trees, arrays=arrays, state=state)

    @classmethod
    def load(cls, directory: str, like_params: PyTree) -> "AsyncFederationSnapshot":
        """The snapshot in ``directory``; every tree takes ``like_params``'s
        dtypes and devices."""
        from repro_torch.checkpoint.store import load_federation_snapshot

        trees, arrays, state = load_federation_snapshot(directory, like_params)
        if state.get("kind") != "async":
            raise ValueError(
                f"snapshot in {directory} is {state.get('kind')!r}, not an "
                "async federation snapshot"
            )
        generator_state = generator_rng_state(state, directory)
        events = []
        for entry in state["events"]:
            update = (
                _unpack_update(entry["update"], trees, arrays)
                if entry["update"] is not None
                else None
            )
            events.append(
                PendingEvent(
                    time=float(entry["time"]),
                    seq=int(entry["seq"]),
                    kind=entry["kind"],
                    group_index=entry["group_index"],
                    update=update,
                )
            )
        return cls(
            version=int(state["version"]),
            params=trees["params"],
            np_rng_state=state["np_rng_state"],
            generator_rng_state=generator_state,
            sched_state=state["sched"],
            events=events,
            buffer=[_unpack_update(e, trees, arrays) for e in state["buffer"]],
            ready=[int(i) for i in state["ready"]],
            idle=[int(i) for i in state["idle"]],
            in_flight=int(state["in_flight"]),
            drought=int(state["drought"]),
            flush_pending=bool(state["flush_pending"]),
            latency_state=state.get("latency_state", {}),
            stats=dict(state.get("stats", {})),
            history=[RoundRecord.from_state(r) for r in state["history"]],
        )


class AsyncFederation:
    """Runs buffered-async federated training on the virtual clock.

    ``AsyncFederation(config, clients, loss_fn, optimizer, device=None)``
    resolves the buffered aggregator and the latency/dropout models up front
    (unknown specs fail here, not mid-run) and delegates recruitment and all
    training to an inner synchronous :class:`Federation` so the two facades
    share one engine surface (and one metrics registry, tracer and
    profiler).  ``device`` defaults to the card.
    """

    def __init__(
        self,
        config: AsyncFederationConfig,
        clients: Sequence[ClientDataset],
        loss_fn: Callable[..., Any],
        optimizer: AdamW,
        device: str | torch.device | None = None,
        tracer: Tracer | None = None,
        metrics: MetricsRegistry | None = None,
        profiler: Any = None,
    ) -> None:
        if not isinstance(config, AsyncFederationConfig):
            raise TypeError(
                f"AsyncFederation needs an AsyncFederationConfig, "
                f"got {type(config).__name__}"
            )
        self.config = config
        self.aggregator = resolve_aggregator(config.aggregator)
        if not isinstance(self.aggregator, AsyncAggregator):
            raise ValueError(
                f"aggregator {config.aggregator!r} is synchronous; the async "
                "runtime needs a buffered aggregator ('fedbuff:K', "
                "'hierarchical-async:R', or an AsyncAggregator instance) — "
                "or run it with the synchronous Federation facade"
            )
        self.latency_model = resolve_latency(config.latency)
        self.dropout_model = resolve_dropout(config.dropout)
        # The inner facade carries recruitment + both engines; its own
        # aggregator stage is fixed to the reduced hot path because every
        # async task *is* one FedAvg-reduced engine group.
        self._fed = Federation(
            FederationConfig(
                rounds=config.rounds,
                local_epochs=config.local_epochs,
                batch_size=config.batch_size,
                recruitment=config.recruitment,
                selection="uniform",
                aggregator="fedavg",
                seed=config.seed,
                engine=config.engine,
                cohort_chunk=config.cohort_chunk,
                mesh=config.mesh,
                donate_buffers=config.donate_buffers,
                staging=config.staging,
                prefetch=config.prefetch,
                resident_budget_bytes=config.resident_budget_bytes,
                privacy=config.privacy,
            ),
            clients,
            loss_fn,
            optimizer,
            device=device,
            tracer=tracer,
            metrics=metrics,
            profiler=profiler,
        )
        self.device = self._fed.device
        # One observability surface for both facades: the inner Federation
        # resolved the null tracer and built the registry; share them.
        self.tracer = self._fed.tracer
        self.metrics = self._fed.metrics
        self.profiler = self._fed.profiler
        self.last_run_stats: dict[str, Any] | None = None

    @property
    def cohort_trainer(self):
        return self._fed.cohort_trainer

    @property
    def trainer(self):
        return self._fed.trainer

    def build_federation(self):
        return self._fed.build_federation()

    # ------------------------------------------------------------------
    # the event loop
    # ------------------------------------------------------------------

    def run(
        self,
        init_params: PyTree,
        progress: Callable[[RoundRecord], None] | None = None,
        snapshot_hook: Callable[[AsyncFederationSnapshot], None] | None = None,
        resume: AsyncFederationSnapshot | None = None,
    ) -> FederatedRunResult:
        """Run the event loop; optionally checkpoint at every flush.

        ``progress`` receives each flush's record.  ``snapshot_hook`` (if
        given) is called with a fresh :class:`AsyncFederationSnapshot` after
        each non-final flush, at the cut where resuming and continuing are
        indistinguishable.  ``resume`` restores such a snapshot: streams,
        clock, queues and in-flight completions are reinstated and the
        remaining timeline replays exactly.  Recruitment runs again and
        resident staging attaches again on resume.
        """
        cfg = self.config
        fed = self._fed
        device = self.device
        cuda = device.type == "cuda"
        rng = np.random.default_rng(cfg.seed)               # the batch-plan stream
        generator_rng = np.random.default_rng([cfg.seed, 2])  # dropout generators
        sched = VirtualScheduler(seed=cfg.seed, tracer=self.tracer)

        federation_ids, recruitment = fed.build_federation()
        members = {int(i): fed.all_clients[int(i)] for i in federation_ids}
        groups = self.aggregator.task_groups(federation_ids)
        flat = np.sort(np.concatenate([np.asarray(g) for g in groups]))
        if not np.array_equal(flat, np.sort(np.asarray(federation_ids))):
            raise ValueError("aggregator task groups must partition the federation")
        self.aggregator.prepare(len(groups))
        if fed.effective_engine == "vectorized" and cfg.staging == "resident":
            # One upload for the whole federation; every task then stages
            # only its int32 index plan against the resident arrays.
            fed.cohort_trainer.attach_device_cohort(list(members.values()))
        # Pin the step axis federation-wide so every task shares one
        # schedule length whatever group mix the timeline produces.
        spe = cohort_steps_per_epoch(
            [c.n_train for c in members.values()], cfg.batch_size
        )
        total_weight = float(sum(c.n_train for c in members.values()))
        n_tensors = len(tree_leaves(init_params))
        model_nbytes = params_nbytes(init_params)

        # DP runs carry one Rényi accountant across the whole event loop;
        # each flush composes its participant fraction and stamps the
        # record with the cumulative epsilon.
        accountant = (
            RdpAccountant(fed.dp.noise_multiplier, delta=fed.dp.delta)
            if fed.dp is not None
            else None
        )
        params = tree_map(lambda p: p.detach().to(device), init_params)
        version = 0
        buffer: list[AsyncUpdate] = []
        # Two waiting states: ``ready`` tasks have not yet trained against
        # the current parameter version and dispatch as soon as a
        # concurrency slot frees (FedBuff's M_max semantics — a completion
        # immediately funds the next dispatch, so a cap below the
        # federation size never starves the tail of the task list);
        # ``idle`` tasks have reported against the current version and
        # wait for the next flush.
        ready: collections.deque[int] = collections.deque(range(len(groups)))
        idle: list[int] = []
        in_flight = 0
        flush_pending = False
        history: list[RoundRecord] = []
        stats = {"tasks": 0, "dropped": 0, "forced_flushes": 0, "steps_trained": 0}
        # Consecutive fully-dropped completions since the last successful
        # one.  Under dropout=1.0 no update can ever reach the server, so
        # with no virtual-time ceiling the retry loop would spin forever;
        # the drought threshold turns that into a loud error.  (At any
        # p < 1 a run of this length has probability p**threshold —
        # vanishingly small for every non-degenerate model.)
        drought, drought_limit = 0, max(100, 20 * len(groups))
        if resume is not None:
            if not (0 <= int(resume.version) < int(cfg.rounds)):
                raise ValueError(
                    f"cannot resume at flush {resume.version} of a run with "
                    f"rounds={cfg.rounds} (already complete or corrupt)"
                )
            params = tree_map(lambda p: p.detach().to(device), resume.params)
            version = int(resume.version)
            rng.bit_generator.state = resume.np_rng_state
            generator_rng.bit_generator.state = resume.generator_rng_state
            sched.restore(
                resume.sched_state,
                [
                    Event(
                        time=pe.time,
                        seq=pe.seq,
                        kind=pe.kind,
                        payload=_Completion(pe.group_index, pe.update)
                        if pe.kind == COMPLETE
                        else None,
                    )
                    for pe in resume.events
                ],
            )
            buffer = list(resume.buffer)
            ready = collections.deque(int(i) for i in resume.ready)
            idle = [int(i) for i in resume.idle]
            in_flight = int(resume.in_flight)
            drought = int(resume.drought)
            flush_pending = bool(resume.flush_pending)
            self.latency_model.load_state_dict(resume.latency_state)
            stats = {**stats, **resume.stats}
            history = list(resume.history)
            if accountant is not None:
                # Privacy loss composes across the resume cut: replay the
                # completed flushes' sampling rates before continuing.
                for past in history:
                    accountant.step(len(past.participant_ids) / federation_ids.size)
        t_start = time.perf_counter()
        t_last_flush = t_start
        tracer = self.tracer
        # Per-flush metric deltas: the stats dict is cumulative (and resume
        # restores it alongside the registry, which already folded the
        # pre-preemption values), so only the change since the last flush
        # is incremented into the counters.
        prev_stats = dict(stats)

        def absorb_async_metrics() -> None:
            m = self.metrics
            for key in ("tasks", "dropped", "forced_flushes"):
                delta = stats[key] - prev_stats.get(key, 0)
                if delta:
                    m.counter(f"async.{key}").inc(delta)
                prev_stats[key] = stats[key]
            m.gauge("async.in_flight").set(in_flight)
            m.gauge("async.buffered_updates").set(len(buffer))

        def make_snapshot() -> AsyncFederationSnapshot:
            return AsyncFederationSnapshot(
                version=version,
                params=params,
                np_rng_state=rng.bit_generator.state,
                generator_rng_state=generator_rng.bit_generator.state,
                sched_state=sched.state_dict(),
                events=[
                    PendingEvent(
                        time=e.time,
                        seq=e.seq,
                        kind=e.kind,
                        group_index=e.payload.group_index if e.kind == COMPLETE else None,
                        update=e.payload.update if e.kind == COMPLETE else None,
                    )
                    for e in sched.pending()
                ],
                buffer=list(buffer),
                ready=list(ready),
                idle=list(idle),
                in_flight=in_flight,
                drought=drought,
                flush_pending=flush_pending,
                latency_state=self.latency_model.state_dict(),
                stats=dict(stats),
                history=list(history),
            )

        def dispatch(group_index: int) -> None:
            """Train one task eagerly and schedule its completion.

            Draw order is fixed per dispatch — every member's latency, then
            every member's dropout, then the survivors' generator seeds and
            training — so every stream advances identically on replay.
            """
            nonlocal in_flight
            group = groups[group_index]
            latency = max(
                self.latency_model.sample(int(cid), members[int(cid)].n_train, sched.rng)
                for cid in group
            )
            survivors = np.asarray(
                [cid for cid in group if not self.dropout_model.drops(int(cid), sched.rng)]
            )
            update = None
            with tracer.span("dispatch", group=group_index, latency=latency):
                if len(survivors):
                    generators = client_generators(generator_rng, len(survivors), device)
                    task_params, losses, steps = fed._train_group(
                        params, survivors, rng, generators, spe
                    )
                    stats["steps_trained"] += steps
                    update = AsyncUpdate(
                        client_ids=survivors,
                        params=task_params,
                        anchor=params,
                        weight=float(sum(members[int(c)].n_train for c in survivors)),
                        version=version,
                        losses=np.asarray(losses, dtype=np.float32),
                        local_steps=steps,
                    )
            stats["tasks"] += 1
            stats["dropped"] += len(group) - len(survivors)
            in_flight += 1
            sched.after(latency, COMPLETE, _Completion(group_index, update))
            if tracer.enabled:
                # The task on the virtual clock: dispatched now, completing
                # after its sampled latency, on its own per-client track,
                # with a flow arrow from the server's dispatch point so
                # straggler and dropout schedules read off the timeline.
                track = f"client:{int(group[0])}" if len(group) == 1 else f"group:{group_index}"
                fid = tracer.new_flow_id()
                tracer.flow_start("task", fid, ts=sched.now, track="server")
                tracer.complete(
                    "task",
                    start=sched.now,
                    dur=latency,
                    track=track,
                    clock="virtual",
                    group=group_index,
                    clients=[int(c) for c in group],
                    survivors=len(survivors),
                    version=version,
                    dropped=update is None,
                )
                tracer.flow_end("task", fid, ts=sched.now + latency, track=track)

        def dispatch_ready() -> None:
            """Dispatch ready tasks in queue order, respecting concurrency."""
            while ready and (cfg.concurrency is None or in_flight < cfg.concurrency):
                dispatch(ready.popleft())

        def flush() -> bool:
            """Fold the buffer into a new param version; True = keep going."""
            nonlocal params, version, buffer, t_last_flush
            updates, buffer = buffer, []
            staleness = self.aggregator.staleness_of(updates, version)
            params = self.aggregator.combine(params, updates, version, total_weight)
            version += 1
            participant_ids = sorted(
                {int(c) for u in updates for c in np.asarray(u.client_ids)}
            )
            losses = np.concatenate([u.losses for u in updates])
            k = sum(len(u.client_ids) for u in updates)
            epsilon = None
            if accountant is not None:
                accountant.step(len(participant_ids) / federation_ids.size)
                epsilon = accountant.epsilon()
            if cuda:
                torch.cuda.synchronize(device)  # the combine is done too
            now_host = time.perf_counter()
            record = RoundRecord(
                round_index=version - 1,
                participant_ids=participant_ids,
                mean_local_loss=float(np.nanmean(losses)) if len(losses) else float("nan"),
                local_steps=sum(u.local_steps for u in updates),
                params_down=k * n_tensors,
                params_up=k * n_tensors,
                bytes_transferred=2 * k * model_nbytes,
                wall_time_s=now_host - t_last_flush,
                virtual_time=sched.now,
                staleness=float(staleness.mean()) if len(staleness) else 0.0,
                epsilon=epsilon,
            )
            # The flush span covers the whole inter-flush interval on the
            # host clock (its duration is exactly round_time_s), plus an
            # instant on the virtual timeline at the flush's event time.
            tracer.complete(
                "flush",
                start=tracer.host_ts(t_last_flush),
                dur=record.wall_time_s,
                version=version - 1,
                updates=len(updates),
                virtual_time=sched.now,
            )
            tracer.instant(
                "flush", ts=sched.now, clock="virtual",
                version=version - 1, staleness=record.staleness,
            )
            t_last_flush = now_host
            history.append(record)
            watcher.poll()
            absorb_async_metrics()
            fed._absorb_round_metrics(record)
            if self.profiler is not None:
                self.profiler.round_end(version - 1)
                self.profiler.round_start(version)
            if progress is not None:
                progress(record)
            if version >= cfg.rounds:
                return False
            if cfg.target_loss is not None and record.mean_local_loss <= cfg.target_loss:
                return False
            return True

        with CompileWatcher(self.metrics) as watcher:
            dispatch_ready()
            while True:
                if sched.empty:
                    if buffer and version < cfg.rounds:
                        # Every task has reported but the buffer never crossed
                        # the threshold (e.g. fedbuff:K over a federation of
                        # fewer than K tasks): flush what there is rather than
                        # deadlock — the semi-synchronous degenerate case.
                        stats["forced_flushes"] += 1
                        sched.schedule(sched.now, FLUSH)
                        flush_pending = True
                        continue
                    break
                if (
                    cfg.max_virtual_time is not None
                    and sched.peek_time() > cfg.max_virtual_time
                ):
                    break
                event = sched.pop()
                if event.kind == COMPLETE:
                    in_flight -= 1
                    done: _Completion = event.payload
                    if done.update is None:
                        # Dropped: the client retries immediately — it never
                        # blocks the buffer, so it cannot deadlock a flush.
                        # (in_flight just fell below any concurrency cap, so the
                        # retry always has a slot.)
                        drought += 1
                        if drought > drought_limit and cfg.max_virtual_time is None:
                            raise RuntimeError(
                                f"{drought} consecutive tasks dropped with no "
                                "update reaching the server; the dropout model "
                                "admits no progress — lower the dropout "
                                "probability or set max_virtual_time to bound "
                                "the simulation"
                            )
                        dispatch(done.group_index)
                        continue
                    drought = 0
                    buffer.append(done.update)
                    idle.append(done.group_index)
                    # The completion freed a concurrency slot: fund the next
                    # not-yet-trained task with it right away.
                    dispatch_ready()
                    if self.aggregator.ready(len(buffer)) and not flush_pending:
                        # Flush at the next event boundary (same time, later
                        # seq): simultaneous completions land in one flush.
                        sched.schedule(sched.now, FLUSH)
                        flush_pending = True
                elif event.kind == FLUSH:
                    flush_pending = False
                    if not buffer:
                        continue
                    if not flush():
                        break
                    # The new version exists: everyone who reported against the
                    # old one becomes ready again, behind any task still waiting
                    # for its first slot.
                    idle.sort()
                    ready.extend(idle)
                    idle.clear()
                    if snapshot_hook is not None:
                        # The cut point: buffer just flushed, idle requeued,
                        # nothing dispatched yet — resuming from here and
                        # continuing are the same next action.
                        with tracer.span("checkpoint", version=version):
                            snapshot_hook(make_snapshot())
                    dispatch_ready()
                else:  # pragma: no cover - no other kinds are scheduled
                    raise RuntimeError(f"unknown event kind {event.kind!r}")

        if cuda:
            torch.cuda.synchronize(device)
        # Tail work since the last flush (dispatches that never flushed)
        # still lands in the counters before the final snapshot.
        absorb_async_metrics()
        self.metrics.gauge("async.virtual_time").set(sched.now)
        if self.profiler is not None:
            self.profiler.stop()
        self.last_run_stats = {
            **stats,
            "virtual_time": sched.now,
            "flushes": version,
            "events": sched.processed,
            "unflushed_updates": len(buffer),
            "groups": len(groups),
        }
        return FederatedRunResult(
            params=params,
            history=history,
            recruitment=recruitment,
            federation_ids=federation_ids,
            total_wall_time_s=time.perf_counter() - t_start,
            total_local_steps=sum(r.local_steps for r in history),
            metrics=self.metrics.snapshot(),
        )
