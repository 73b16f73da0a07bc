"""Snapshots of the port's two federation facades, and their metrics.

* ``RoundRecord.to_state``/``from_state`` and the selection policies'
  adaptive state against the reference's;
* ``Federation.run(snapshot_hook=, resume=)``: a run resumed from the
  snapshot of any round equals the uninterrupted one bit for bit (params,
  losses, participants), on both engines and both staging modes, with the
  loss-weighted selection's state and dropout 0.05 (the dropout-generator
  stream is part of the snapshot), through memory and through disk;
* DP: the resumed epsilons equal the uninterrupted ones (the accountant
  replays the completed rounds), and equal the reference's;
* ``AsyncFederation.run(snapshot_hook=, resume=)`` under lognormal latency,
  client dropout and a concurrency cap: a run resumed from the snapshot of
  any flush replays the timeline exactly (virtual times, staleness,
  participants, dropped tasks) and the params bit for bit;
  ``AsyncFederationSnapshot`` round-trips through ``checkpoint/store.py``
  bit for bit, pending updates included;
* the metrics registry: ``FederatedRunResult.metrics`` is filled, and a
  resumed run that loads the snapshot's registry ends with the
  uninterrupted run's counters.
"""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.federated import api as jax_api  # noqa: E402
from repro_torch.data.pipeline import ArrayDataset, ClientDataset  # noqa: E402
from repro_torch.federated import (  # noqa: E402
    AsyncFederation,
    AsyncFederationConfig,
    Federation,
    FederationConfig,
)
from repro_torch.federated.api import (  # noqa: E402
    FederationSnapshot,
    LossWeightedSelection,
    RoundRecord,
    UniformSelection,
)
from repro_torch.federated.runtime import AsyncFederationSnapshot, PendingEvent  # noqa: E402
from repro_torch.models import gru  # noqa: E402
from repro_torch.obs import MetricsRegistry, RoundProfiler, Tracer  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

torch.set_num_threads(1)

SEQ_LEN, FEAT = 3, 5
# Counters and gauges a resumed run must end with, as the uninterrupted one
# (histograms of host times differ by nature).
TIME_FREE = ("counters", "gauges")


def make_clients(count, seed=0, lo=2, hi=18):
    rng = np.random.default_rng(seed)
    clients = []
    for i, n in enumerate(rng.integers(lo, hi, count)):
        x = rng.normal(size=(int(n), SEQ_LEN, FEAT)).astype(np.float32)
        y = rng.uniform(0.5, 20.0, size=int(n)).astype(np.float32)
        clients.append(ClientDataset(i, ArrayDataset(x, y), ArrayDataset(x, y)))
    return clients


@pytest.fixture(scope="module")
def setup():
    cfg = gru.GRUConfig(input_dim=FEAT, hidden_dim=2, num_layers=2)  # dropout 0.05
    params0 = gru.init_gru(torch.Generator().manual_seed(1), cfg, "cpu")
    return make_clients(10), gru.make_loss_fn(cfg), params0


def opt():
    return AdamW(learning_rate=5e-3, weight_decay=5e-3)


def same_bits(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def without_time(history):
    out = []
    for r in history:
        state = r.to_state()
        state.pop("round_time_s")
        out.append(state)
    return out


def time_free(metrics):
    return {k: metrics[k] for k in TIME_FREE}


# --------------------------------------------------------------------------
# records and policy state
# --------------------------------------------------------------------------


@pytest.mark.parametrize("virtual", [False, True])
def test_round_record_state_round_trips_as_the_reference(virtual):
    rec = RoundRecord(2, [1, 4], 0.3, 7, 12, 12, 4096, 0.25,
                      virtual_time=3.5 if virtual else None,
                      staleness=0.5 if virtual else None, epsilon=1.25)
    state = rec.to_state()
    ref = jax_api.RoundRecord(**rec.__dict__)
    assert state == ref.to_state()
    assert RoundRecord.from_state(state) == rec
    legacy = dict(state)
    legacy["wall_time_s"] = legacy.pop("round_time_s")
    assert RoundRecord.from_state(legacy) == rec
    assert jax_api.RoundRecord.from_state(state).__dict__ == RoundRecord.from_state(state).__dict__


def test_selection_state_round_trips_as_the_reference():
    ours, ref = LossWeightedSelection(count=3), jax_api.LossWeightedSelection(count=3)
    for policy in (ours, ref):
        policy.observe(np.array([1, 4, 6]), np.array([0.5, np.nan, 2.0], np.float32))
    assert ours.state_dict() == ref.state_dict() == {"loss": {"1": 0.5, "6": 2.0}}
    fresh = LossWeightedSelection(count=3)
    fresh.load_state_dict(ours.state_dict())
    ids = np.arange(8)
    picks = [p.select(0, ids, np.random.default_rng(5)).tolist() for p in (fresh, ours, ref)]
    assert picks[0] == picks[1] == picks[2]
    assert UniformSelection().state_dict() == {}


# --------------------------------------------------------------------------
# the synchronous facade
# --------------------------------------------------------------------------


def sync_run(setup, snapshot_hook=None, resume=None, metrics=None, **config):
    clients, loss_fn, params0 = setup
    cfg = dict(rounds=4, local_epochs=1, batch_size=4, selection="loss-weighted:4", seed=2)
    cfg.update(config)
    fed = Federation(FederationConfig(**cfg), clients, loss_fn, opt(), device="cpu",
                     metrics=metrics)
    return fed.run(params0, snapshot_hook=snapshot_hook, resume=resume)


@pytest.mark.parametrize("engine,staging", [
    ("vectorized", "resident"), ("vectorized", "rebuild"), ("sequential", "resident"),
])
def test_sync_resume_from_any_round_is_the_uninterrupted_run(setup, engine, staging):
    snaps = []
    full = sync_run(setup, snapshot_hook=snaps.append, engine=engine, staging=staging)
    assert [s.round_index for s in snaps] == [1, 2, 3, 4]
    assert same_bits(snaps[-1].params, full.params)
    for snap in snaps[:-1]:
        resumed = sync_run(setup, resume=snap, engine=engine, staging=staging)
        assert same_bits(resumed.params, full.params)
        assert without_time(resumed.history) == without_time(full.history)
        assert resumed.total_local_steps == full.total_local_steps


def test_sync_snapshot_through_disk_is_bit_exact(setup, tmp_path):
    snaps = []
    full = sync_run(setup, snapshot_hook=snaps.append, rounds=3)
    snaps[0].save(str(tmp_path), extra_state={"spec_hash": "h"})
    loaded = FederationSnapshot.load(str(tmp_path), setup[2])
    assert loaded.round_index == 1 and same_bits(loaded.params, snaps[0].params)
    assert loaded.np_rng_state == snaps[0].np_rng_state
    assert loaded.generator_rng_state == snaps[0].generator_rng_state
    assert loaded.history == snaps[0].history
    assert loaded.selection_state == snaps[0].selection_state != {}
    resumed = sync_run(setup, resume=loaded, rounds=3)
    assert same_bits(resumed.params, full.params)
    assert without_time(resumed.history) == without_time(full.history)
    with pytest.raises(ValueError, match="not an async"):
        AsyncFederationSnapshot.load(str(tmp_path), setup[2])


@pytest.mark.parametrize("kind", ["sync", "async"])
def test_a_snapshot_of_the_jax_package_is_refused(setup, tmp_path, kind):
    """The reference's snapshot holds its jax key data, not the port's
    dropout-generator stream: the port refuses to resume it."""
    import jax

    from repro.checkpoint.store import save_federation_snapshot
    from repro.models import gru as jax_gru

    like = jax_gru.init_gru(jax.random.key(0), jax_gru.GRUConfig(input_dim=FEAT, hidden_dim=2))
    state = {"kind": kind, "round_index": 1, "version": 1,
             "np_rng_state": np.random.default_rng(0).bit_generator.state, "history": []}
    save_federation_snapshot(str(tmp_path), trees={"params": like}, state=state,
                             arrays={"jax_key_data": np.zeros(2, np.uint32)})
    cls = FederationSnapshot if kind == "sync" else AsyncFederationSnapshot
    with pytest.raises(ValueError, match="written by the JAX package"):
        cls.load(str(tmp_path), setup[2])


def test_sync_resume_rejects_a_snapshot_past_the_budget(setup):
    snaps = []
    sync_run(setup, snapshot_hook=snaps.append, rounds=2)
    with pytest.raises(ValueError, match="outside the configured 1-round budget"):
        sync_run(setup, resume=snaps[-1], rounds=1)


def test_a_raising_hook_preempts_after_the_snapshot(setup):
    """The control plane preempts by raising from the hook: the snapshot
    handed over is complete, and the run stops there."""
    seen, records = [], []

    def preempt(snap):
        seen.append(snap)
        raise KeyboardInterrupt

    clients, loss_fn, params0 = setup
    fed = Federation(FederationConfig(rounds=3, local_epochs=1, batch_size=4), clients,
                     loss_fn, opt(), device="cpu")
    with pytest.raises(KeyboardInterrupt):
        fed.run(params0, progress=records.append, snapshot_hook=preempt)
    assert len(seen) == 1 and len(records) == 1 and seen[0].history == records


def test_sync_dp_resume_replays_the_accountant(setup):
    privacy = {"clip_norm": 1.0, "noise_multiplier": 1.1, "delta": 1e-5}
    snaps = []
    full = sync_run(setup, snapshot_hook=snaps.append, privacy=privacy, selection="uniform:0.5")
    eps = [r.epsilon for r in full.history]
    assert all(e > 0 for e in eps) and eps == sorted(eps)
    resumed = sync_run(setup, resume=snaps[1], privacy=privacy, selection="uniform:0.5")
    assert [r.epsilon for r in resumed.history] == eps
    assert same_bits(resumed.params, full.params)
    # the same epsilons as the reference's accountant over the same rates
    from repro.privacy.accountant import RdpAccountant

    acc = RdpAccountant(1.1, delta=1e-5)
    ref = []
    for r in full.history:
        acc.step(len(r.participant_ids) / 10)
        ref.append(acc.epsilon())
    assert ref == eps


def test_sync_metrics_fill_the_result_and_continue_across_resume(setup):
    registry, cuts = MetricsRegistry(), []
    full = sync_run(setup, snapshot_hook=lambda s: cuts.append((s, registry.snapshot())),
                    rounds=3, metrics=registry)
    m = full.metrics
    assert m["counters"]["rounds.completed"] == 3
    assert m["counters"]["train.local_steps"] == full.total_local_steps
    assert m["counters"]["comms.bytes_down"] + m["counters"]["comms.bytes_up"] == sum(
        r.bytes_transferred for r in full.history)
    assert m["histograms"]["round.time_s"]["count"] == 3
    assert m["counters"]["staging.chunks"] == 3 and "staging.bytes_resident" in m["gauges"]
    assert full.summary()["metrics"] == m
    # a resumed run whose registry loads the metrics taken with its snapshot
    # (as the control plane does) ends with the uninterrupted run's
    for snap, taken in cuts[:-1]:
        carried = MetricsRegistry()
        carried.load_snapshot(taken)
        resumed = sync_run(setup, resume=snap, rounds=3, metrics=carried)
        assert time_free(resumed.metrics) == time_free(m)
        assert resumed.metrics["histograms"]["round.loss"]["count"] == 3


# --------------------------------------------------------------------------
# the async facade
# --------------------------------------------------------------------------


ASYNC = dict(rounds=5, local_epochs=1, batch_size=4, seed=3, aggregator="fedbuff:3",
             latency="lognormal:0.6", dropout=0.15, concurrency=4)


def async_run(setup, snapshot_hook=None, resume=None, metrics=None, **config):
    clients, loss_fn, params0 = setup
    fed = AsyncFederation(AsyncFederationConfig(**{**ASYNC, **config}), clients, loss_fn,
                          opt(), device="cpu", metrics=metrics)
    return fed, fed.run(params0, snapshot_hook=snapshot_hook, resume=resume)


def timeline(history):
    return [(r.round_index, r.virtual_time, r.participant_ids, r.staleness, r.local_steps)
            for r in history]


@pytest.mark.parametrize("config", [
    {}, {"aggregator": "hierarchical-async:3", "latency": "pareto:1.5"},
    {"engine": "sequential", "staging": "rebuild"},
], ids=["fedbuff", "hierarchical-async", "sequential"])
def test_async_resume_from_any_flush_replays_the_timeline(setup, config):
    snaps = []
    fed, full = async_run(setup, snapshot_hook=snaps.append, **config)
    assert [s.version for s in snaps] == list(range(1, len(full.history)))
    assert any(s.events and any(e.update is not None for e in s.events) for s in snaps)
    for snap in snaps:
        again, resumed = async_run(setup, resume=snap, **config)
        assert timeline(resumed.history) == timeline(full.history)
        assert without_time(resumed.history) == without_time(full.history)
        assert again.last_run_stats == fed.last_run_stats
        assert same_bits(resumed.params, full.params)
        assert resumed.summary()["virtual_time"] == full.summary()["virtual_time"]


def test_async_snapshot_round_trips_through_the_store(setup, tmp_path):
    snaps = []
    _, full = async_run(setup, snapshot_hook=snaps.append)
    snap = next(s for s in snaps if s.buffer or any(e.update for e in s.events))
    snap.save(str(tmp_path), extra_state={"spec_hash": "h"})
    got = AsyncFederationSnapshot.load(str(tmp_path), setup[2])
    assert got.round_index == got.version == snap.version
    for field in ("np_rng_state", "generator_rng_state", "sched_state", "ready", "idle",
                  "in_flight", "drought", "flush_pending", "latency_state", "stats",
                  "history"):
        assert getattr(got, field) == getattr(snap, field), field
    assert got.latency_state["rate"]
    assert same_bits(got.params, snap.params)
    pairs = list(zip(got.events, snap.events)) + [
        (PendingEvent(0.0, 0, "complete", None, a), PendingEvent(0.0, 0, "complete", None, b))
        for a, b in zip(got.buffer, snap.buffer)]
    assert len(got.events) == len(snap.events) and len(got.buffer) == len(snap.buffer)
    for a, b in pairs:
        assert (a.time, a.seq, a.kind, a.group_index) == (b.time, b.seq, b.kind, b.group_index)
        assert (a.update is None) == (b.update is None)
        if a.update is not None:
            assert a.update.client_ids.tolist() == b.update.client_ids.tolist()
            assert a.update.losses.tobytes() == b.update.losses.tobytes()
            assert (a.update.weight, a.update.version, a.update.local_steps) == (
                b.update.weight, b.update.version, b.update.local_steps)
            assert same_bits(a.update.params, b.update.params)
            assert same_bits(a.update.anchor, b.update.anchor)
    _, resumed = async_run(setup, resume=got)
    assert timeline(resumed.history) == timeline(full.history)
    assert same_bits(resumed.params, full.params)
    with pytest.raises(ValueError, match="not a synchronous"):
        FederationSnapshot.load(str(tmp_path), setup[2])


def test_async_resume_rejects_a_finished_run(setup):
    snaps = []
    async_run(setup, snapshot_hook=snaps.append, rounds=3)
    late = copy.copy(snaps[-1])
    late.version = 3
    with pytest.raises(ValueError, match="already complete or corrupt"):
        async_run(setup, resume=late, rounds=3)


def test_async_dp_resume_replays_the_accountant(setup):
    privacy = {"clip_norm": 1.0, "noise_multiplier": 1.1, "delta": 1e-5}
    snaps = []
    _, full = async_run(setup, snapshot_hook=snaps.append, privacy=privacy, rounds=4)
    _, resumed = async_run(setup, resume=snaps[1], privacy=privacy, rounds=4)
    eps = [r.epsilon for r in full.history]
    assert [r.epsilon for r in resumed.history] == eps and eps == sorted(eps)
    assert same_bits(resumed.params, full.params)


def test_async_metrics_count_tasks_and_continue_across_resume(setup):
    registry, cuts = MetricsRegistry(), []
    fed, full = async_run(setup, snapshot_hook=lambda s: cuts.append((s, registry.snapshot())),
                          metrics=registry)
    m = full.metrics
    stats = fed.last_run_stats
    assert m["counters"]["async.tasks"] == stats["tasks"]
    assert m["counters"].get("async.dropped", 0) == stats["dropped"]
    assert m["counters"]["rounds.completed"] == len(full.history)
    assert m["gauges"]["async.virtual_time"] == stats["virtual_time"]
    assert m["histograms"]["async.staleness"]["count"] == len(full.history)
    assert fed.metrics is fed._fed.metrics
    # the registry taken with each snapshot, carried into the resumed run
    for snap, taken in cuts:
        carried = MetricsRegistry()
        carried.load_snapshot(taken)
        _, resumed = async_run(setup, resume=snap, metrics=carried)
        assert time_free(resumed.metrics) == time_free(m)


def test_federation_tracer_and_profiler_raise(setup, tmp_path):
    """The sync facade's tracer and profiler are ported (the async facade's:
    ``test_torch_async_runtime.py``): with a snapshot hook and a resume the
    traced, profiled run is the untraced one bit for bit, its checkpoint
    spans follow the snapshots, and the resumed run traces and profiles
    only its own rounds."""
    clients, loss_fn, params0 = setup
    config = FederationConfig(rounds=3, local_epochs=1, batch_size=4, seed=0)
    plain = Federation(config, clients, loss_fn, opt(), device="cpu").run(params0)
    tracer = Tracer()
    profiler = RoundProfiler(1, str(tmp_path / "full"), device="cpu")
    snaps = []
    fed = Federation(config, clients, loss_fn, opt(), device="cpu", tracer=tracer,
                     profiler=profiler)
    assert (fed.tracer, fed.profiler, fed.cohort_trainer.tracer) == (tracer, profiler, tracer)
    full = fed.run(params0, snapshot_hook=snaps.append)
    assert same_bits(full.params, plain.params) and profiler.error is None
    assert [s.args["round"] for s in tracer.spans("checkpoint")] == [0, 1, 2]
    assert [s.dur for s in tracer.spans("round")] == [r.round_time_s for r in full.history]
    resumed_tracer = Tracer()
    resumed_profiler = RoundProfiler(1, str(tmp_path / "resumed"), device="cpu")
    resumed = Federation(config, clients, loss_fn, opt(), device="cpu", tracer=resumed_tracer,
                         profiler=resumed_profiler).run(params0, resume=snaps[0])
    assert same_bits(resumed.params, full.params)
    assert [s.args["round"] for s in resumed_tracer.spans("round")] == [1, 2]
    assert resumed_profiler.trace_path.endswith("rounds_1.pt.trace.json")
