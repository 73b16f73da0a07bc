"""The port's async federation runtime against the JAX package's.

The port of ``tests/test_async_runtime.py``, case by case, each held
against the reference on the same inputs where the reference can run them:

* the virtual-clock scheduler (order, the clock, replay, its state) and the
  staleness weights, equal to the reference's;
* the parity gate: ``"fedbuff:K"`` with K = all participants and a
  zero-spread latency model equals the port's synchronous FedAvg within
  1e-5 on both engines and both staging modes, and the JAX package's
  ``AsyncFederation`` from the same initial params at dropout 0 (virtual
  times, participants and staleness exact, losses 1e-5, params 1e-4, the
  AdamW drift of ROADMAP Queue 3); ``"hierarchical-async:1"`` likewise;
* seeded replay bit for bit, and the behaviours (staleness, stragglers,
  dropout, forced flushes, the concurrency cap, regions, validation), with
  the timeline equal to the reference's under lognormal and Pareto
  latencies with client dropout;
* DP: the flushes' epsilons equal the reference's;
* ``time_to_target``, ``shared_time_to_target`` and a small
  ``run_async_comparison`` against the reference's;
* the dropout-generator stream: ``client_generators`` drawn one at a time
  equals one draw of n (the port of
  ``test_chain_split_singletons_match_batched_chain``).

The reference's ``test_fedbuff_parity_under_auto_mesh`` runs in
``tests/test_torch_mesh.py``: ``fedbuff`` under a mesh of two gloo ranks
against sync FedAvg under the same mesh.
"""

import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro.experiments import paper as jax_paper  # noqa: E402
from repro.federated import api as jax_api  # noqa: E402
from repro.federated import runtime as jax_runtime  # noqa: E402
from repro.federated.runtime import staleness as jax_staleness  # noqa: E402
from repro.models import gru as jax_gru  # noqa: E402
from repro.optim.adamw import AdamW as JaxAdamW  # noqa: E402
from repro_torch.data.pipeline import ArrayDataset, ClientDataset  # noqa: E402
from repro_torch.experiments import paper  # noqa: E402
from repro_torch.federated import (  # noqa: E402
    AsyncFederation,
    AsyncFederationConfig,
    Federation,
    FederationConfig,
    polynomial_staleness_weight,
    resolve_aggregator,
    staleness_weights,
)
from repro_torch.federated.api import FederatedRunResult, RoundRecord  # noqa: E402
from repro_torch.federated.cohort import client_generators  # noqa: E402
from repro_torch.federated.runtime import (  # noqa: E402
    AsyncAggregator,
    FedBuffAggregator,
    HierarchicalAsyncAggregator,
    VirtualScheduler,
)
from repro_torch.federated.runtime import staleness  # noqa: E402
from repro_torch.models import gru  # noqa: E402
from repro_torch.obs import MetricsRegistry, RoundProfiler, Tracer  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

torch.set_num_threads(1)

SEQ_LEN, FEAT = 3, 5
TOL = 1e-5
PARAMS_TOL = 1e-4


def make_clients(count, rng, lo=2, hi=18):
    """Matching client lists for both packages (the same arrays)."""
    ours, theirs = [], []
    for i, n in enumerate(rng.integers(lo, hi, count)):
        x = rng.normal(size=(int(n), SEQ_LEN, FEAT)).astype(np.float32)
        y = rng.uniform(0.5, 20.0, size=int(n)).astype(np.float32)
        ours.append(ClientDataset(i, ArrayDataset(x, y), ArrayDataset(x, y)))
        ds = jax_pipeline.ArrayDataset(x, y)
        theirs.append(jax_pipeline.ClientDataset(client_id=i, train=ds, val=ds))
    return ours, theirs


@pytest.fixture(scope="module")
def setup():
    """The reference test's federation: 10 clients, GRU N=2 with the paper's
    dropout 0.05 (the port's own RNG contract), from the reference's init."""
    cfg = gru.GRUConfig(input_dim=FEAT, hidden_dim=2, num_layers=1)
    jcfg = jax_gru.GRUConfig(input_dim=FEAT, hidden_dim=2, num_layers=1)
    init = jax.tree.map(np.asarray, jax_gru.init_gru(jax.random.key(1), jcfg))
    clients, _ = make_clients(10, np.random.default_rng(0))
    return clients, gru.make_loss_fn(cfg), gru.params_from_jax(init, "cpu")


@pytest.fixture(scope="module")
def pair():
    """Both packages at dropout 0, from the reference's initial params."""
    cfg = gru.GRUConfig(input_dim=FEAT, hidden_dim=2, num_layers=2, dropout=0.0)
    jcfg = jax_gru.GRUConfig(input_dim=FEAT, hidden_dim=2, num_layers=2, dropout=0.0)
    init = jax.tree.map(np.asarray, jax_gru.init_gru(jax.random.key(1), jcfg))
    ours, theirs = make_clients(10, np.random.default_rng(0))
    return (ours, gru.make_loss_fn(cfg), gru.params_from_jax(init, "cpu"),
            theirs, jax_gru.make_loss_fn(jcfg), init)


def opt():
    return AdamW(learning_rate=5e-3, weight_decay=5e-3)


def host(leaf) -> np.ndarray:
    return leaf.float().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)


def max_gap(a, b) -> float:
    """Largest entry gap of two param trees, torch or JAX leaves (both
    packages walk dict keys sorted)."""
    return max(float(np.max(np.abs(host(x) - host(y))))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def same_bits(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def run_async(clients, loss_fn, params0, **config):
    fed = AsyncFederation(AsyncFederationConfig(**config), clients, loss_fn, opt(),
                          device="cpu")
    return fed, fed.run(params0)


def run_both(pair, **config):
    """The same async federation in the port (resident staging, its
    default) and in the reference.  The reference runs rebuild staging,
    which gives its resident runs' numbers: its resident path traces anew
    for every one-client task on the CPU (~1.6 s a task)."""
    ours, loss_fn, params0, theirs, jax_loss_fn, init = pair
    fed, got = run_async(ours, loss_fn, params0, **config)
    ref_fed = jax_runtime.AsyncFederation(
        jax_runtime.AsyncFederationConfig(**config, staging="rebuild"), theirs, jax_loss_fn,
        JaxAdamW(learning_rate=5e-3, weight_decay=5e-3))
    ref = ref_fed.run(init)
    return fed, got, ref_fed, ref


def timeline(history):
    return [(r.round_index, r.virtual_time, r.participant_ids, r.staleness, r.local_steps,
             r.params_down, r.params_up) for r in history]


def assert_matches_reference(fed, got, ref_fed, ref, params_tol=PARAMS_TOL):
    assert got.federation_ids.tolist() == ref.federation_ids.tolist()
    assert timeline(got.history) == timeline(ref.history)
    assert fed.last_run_stats == ref_fed.last_run_stats
    assert all(abs(g.mean_local_loss - r.mean_local_loss) <= TOL
               for g, r in zip(got.history, ref.history))
    assert max_gap(got.params, ref.params) <= params_tol
    s, r = got.summary(), ref.summary()
    assert (s["virtual_time"], s["mean_staleness"]) == (r["virtual_time"], r["mean_staleness"])


# --------------------------------------------------------------------------
# virtual-clock scheduler
# --------------------------------------------------------------------------


@pytest.mark.parametrize("scheduler", [VirtualScheduler, jax_runtime.VirtualScheduler],
                         ids=["port", "reference"])
def test_scheduler_orders_by_time_then_seq(scheduler):
    sched = scheduler(seed=0)
    sched.schedule(2.0, "b")
    sched.schedule(1.0, "a")
    sched.schedule(2.0, "c")       # same time as "b", scheduled later
    sched.schedule(1.0, "a2")
    assert [e.kind for e in sched.pending()] == ["a", "a2", "b", "c"]
    order = [sched.pop().kind for _ in range(4)]
    assert order == ["a", "a2", "b", "c"]  # time first, insertion seq on ties
    assert sched.now == 2.0 and sched.processed == 4 and sched.empty


def test_scheduler_clock_never_runs_backwards():
    for scheduler in (VirtualScheduler, jax_runtime.VirtualScheduler):
        sched = scheduler(seed=0)
        sched.schedule(5.0, "x")
        sched.pop()
        with pytest.raises(ValueError, match="past"):
            sched.schedule(4.0, "late")
        with pytest.raises(ValueError, match="delay"):
            sched.after(-1.0, "neg")
        with pytest.raises(ValueError, match="finite"):
            sched.schedule(float("nan"), "nan")
        with pytest.raises(IndexError):
            sched.pop()
        # scheduling exactly at "now" is allowed (flush-at-event-boundary)
        ev = sched.schedule(5.0, "now")
        assert ev.time == 5.0 and sched.pop().kind == "now"


def drive(scheduler, seed):
    sched = scheduler(seed=seed)
    trace = []
    for i in range(5):
        sched.after(float(sched.rng.exponential()), f"e{i}")
    while not sched.empty:
        ev = sched.pop()
        trace.append((ev.time, ev.seq, ev.kind))
    return trace, sched.state_dict()


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_scheduler_replays_identically(seed):
    """The same seed replays, and the port's stream is the reference's."""
    got, got_state = drive(VirtualScheduler, seed)
    assert drive(VirtualScheduler, seed)[0] == got
    assert drive(VirtualScheduler, seed + 1)[0] != got  # and the seed matters
    ref, ref_state = drive(jax_runtime.VirtualScheduler, seed)
    assert got == ref and got_state == ref_state


def test_scheduler_restore_matches_reference():
    states = []
    for scheduler in (VirtualScheduler, jax_runtime.VirtualScheduler):
        sched = scheduler(seed=3)
        for i in range(4):
            sched.after(float(sched.rng.uniform()), f"e{i}")
        sched.pop()
        state, pending = sched.state_dict(), sched.pending()
        fresh = scheduler(seed=99)
        fresh.restore(state, pending)
        trace = []
        while not fresh.empty:
            ev = fresh.pop()
            trace.append((ev.time, ev.seq, ev.kind))
        states.append((trace, float(fresh.rng.uniform())))
        with pytest.raises(ValueError, match="past"):
            scheduler(seed=0).restore({**state, "now": 1e9}, pending)
    assert states[0] == states[1]


# --------------------------------------------------------------------------
# staleness weights
# --------------------------------------------------------------------------


@pytest.mark.parametrize("s,a", [
    (0.0, 0.0), (0.0, 0.5), (1.0, 0.5), (3.0, 2.0), (49.5, 4.0), (0.25, 1.3), (17.0, 0.01),
])
def test_polynomial_weight_properties(s, a):
    w = polynomial_staleness_weight(s, a)
    assert w == jax_staleness.polynomial_staleness_weight(s, a)
    assert 0.0 < w <= 1.0
    assert polynomial_staleness_weight(0.0, a) == 1.0
    # monotone non-increasing in staleness
    assert polynomial_staleness_weight(s + 1.0, a) <= w
    # exponent 0 disables the discount entirely
    assert polynomial_staleness_weight(s, 0.0) == 1.0
    arr = polynomial_staleness_weight(np.array([0.0, s, s + 2.0]), a)
    np.testing.assert_array_equal(
        arr, jax_staleness.polynomial_staleness_weight(np.array([0.0, s, s + 2.0]), a))


@pytest.mark.parametrize("sizes,a", [
    ([1], 0.0), ([5, 5], 0.5), ([500, 1, 37, 2], 1.0), (list(range(1, 13)), 3.0),
    ([7, 300, 12, 12, 90], 0.75),
])
def test_staleness_weights_normalize(sizes, a):
    stale = [i % 5 for i in range(len(sizes))]
    w = staleness_weights(sizes, stale, a)
    assert w.tobytes() == jax_staleness.staleness_weights(sizes, stale, a).tobytes()
    assert w.shape == (len(sizes),) and np.all(w > 0) and np.isclose(w.sum(), 1.0)
    # zero staleness everywhere reduces to plain sample weighting
    flat = staleness_weights(sizes, np.zeros(len(sizes)), a)
    np.testing.assert_allclose(flat, np.asarray(sizes) / np.sum(sizes))


def test_staleness_validation():
    for module in (staleness, jax_staleness):
        with pytest.raises(ValueError, match="exponent"):
            module.polynomial_staleness_weight(1.0, -0.5)
        with pytest.raises(ValueError, match="staleness"):
            module.polynomial_staleness_weight(-1.0, 0.5)
        with pytest.raises(ValueError, match="sample sizes"):
            module.staleness_weights([0, 0], [0, 0], 0.5)
        with pytest.raises(ValueError, match="nothing"):
            module.staleness_weights([], [], 0.5)


def random_tree(rng):
    return {"w": rng.normal(size=(4, 3)).astype(np.float32),
            "layers": [{"b": rng.normal(size=(3,)).astype(np.float32)}]}


@pytest.mark.parametrize("aggregator", ["fedbuff:3,0.5", "fedbuff:2,1.5", "hierarchical-async:3"])
def test_combine_matches_reference(aggregator):
    """A flush folds the buffered deltas as the reference does, into new
    tensors: neither the params nor any anchor changes."""
    rng = np.random.default_rng(4)
    base = random_tree(rng)
    updates = [(random_tree(rng), random_tree(rng), 3.0 + 5 * i, i % 2) for i in range(3)]
    ours, theirs = resolve_aggregator(aggregator), jax_api.resolve_aggregator(aggregator)
    as_torch = lambda t: tree_map(torch.from_numpy, jax.tree.map(np.copy, t))  # noqa: E731
    ours_updates = [staleness.AsyncUpdate(np.array([i]), as_torch(p), as_torch(a), w, v,
                                          np.zeros(1, np.float32), 1)
                    for i, (p, a, w, v) in enumerate(updates)]
    ref_updates = [jax_staleness.AsyncUpdate(np.array([i]), jax.tree.map(jnp.asarray, p),
                                             jax.tree.map(jnp.asarray, a), w, v,
                                             np.zeros(1, np.float32), 1)
                   for i, (p, a, w, v) in enumerate(updates)]
    params = as_torch(base)
    before = [tree_map(torch.clone, t) for t in (params, *[u.anchor for u in ours_updates])]
    got = ours.combine(params, ours_updates, 2, 40.0)
    want = theirs.combine(jax.tree.map(jnp.asarray, base), ref_updates, 2, 40.0)
    assert max_gap(got, want) <= 1e-7
    assert ours.staleness_of(ours_updates, 2).tolist() == [2.0, 1.0, 2.0]
    for b, now in zip(before, (params, *[u.anchor for u in ours_updates])):
        assert same_bits(b, now)
    # bfloat16 leaves accumulate in float32 and come back as bfloat16
    half = tree_map(lambda t: t.to(torch.bfloat16), params)
    out = ours.combine(half, ours_updates, 2, 40.0)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(out))


# --------------------------------------------------------------------------
# the parity gate: fedbuff at full buffer + zero spread == sync FedAvg
# --------------------------------------------------------------------------


@pytest.mark.parametrize(
    "engine,staging",
    [
        ("vectorized", "resident"),
        ("vectorized", "rebuild"),
        ("sequential", "resident"),
        ("sequential", "rebuild"),
    ],
)
def test_fedbuff_full_buffer_matches_sync_fedavg(setup, engine, staging):
    """K = all participants + zero latency spread: every update has
    staleness 0 and anchors at the current params, so each flush *is* a
    flat FedAvg round — 1e-5 against the synchronous facade under the
    paper's dropout, both engines, both staging modes."""
    clients, loss_fn, params0 = setup
    base = dict(rounds=2, local_epochs=1, batch_size=4, seed=0, engine=engine, staging=staging)
    sync = Federation(
        FederationConfig(**base, recruitment="all", selection="uniform", aggregator="fedavg"),
        clients, loss_fn, opt(), device="cpu",
    ).run(params0)
    _, asyn = run_async(clients, loss_fn, params0, **base, recruitment="all",
                        aggregator=f"fedbuff:{len(clients)}", latency="constant")
    assert sync.federation_ids.tolist() == asyn.federation_ids.tolist()
    for rs, ra in zip(sync.history, asyn.history):
        assert rs.participant_ids == ra.participant_ids
        assert rs.local_steps == ra.local_steps
        assert ra.staleness == 0.0 and rs.staleness is None
    assert max_gap(sync.params, asyn.params) <= TOL
    np.testing.assert_allclose(
        [r.mean_local_loss for r in sync.history],
        [r.mean_local_loss for r in asyn.history],
        atol=TOL, rtol=0,
    )


@pytest.mark.parametrize("engine", ["vectorized", "sequential"])
def test_fedbuff_full_buffer_matches_reference(pair, engine):
    """The parity configuration in both packages from the reference's
    initial params, dropout 0: the same timeline exactly, losses within
    1e-5 and params within 1e-4."""
    fed, got, ref_fed, ref = run_both(
        pair, rounds=2, local_epochs=2, batch_size=4, seed=0, engine=engine,
        aggregator="fedbuff:10", latency="constant")
    assert [r.staleness for r in got.history] == [0.0, 0.0]
    assert_matches_reference(fed, got, ref_fed, ref)


def test_client_generators_singletons_match_batched_draw():
    """The generator-stream argument under the parity gate: n one-client
    draws give the n seeds one n-draw gives, so a flush of one-client tasks
    trains each client with the generator the sync round gives it."""
    batched = client_generators(np.random.default_rng([0, 2]), 6, torch.device("cpu"))
    rng = np.random.default_rng([0, 2])
    singles = [client_generators(rng, 1, torch.device("cpu"))[0] for _ in range(6)]
    assert [g.initial_seed() for g in singles] == [g.initial_seed() for g in batched]
    assert len({g.initial_seed() for g in batched}) == 6


@pytest.mark.parametrize("engine", ["vectorized", "sequential"])
def test_hierarchical_async_single_region_matches_sync(setup, engine):
    """R = 1: the whole federation is one region, each combine lands a
    full-weight, zero-staleness regional FedAvg — synchronous flat FedAvg
    on the event loop."""
    clients, loss_fn, params0 = setup
    base = dict(rounds=2, local_epochs=1, batch_size=4, seed=0, engine=engine)
    sync = Federation(
        FederationConfig(**base, aggregator="fedavg"), clients, loss_fn, opt(), device="cpu"
    ).run(params0)
    _, asyn = run_async(clients, loss_fn, params0, **base,
                        aggregator="hierarchical-async:1", latency="constant")
    assert max_gap(sync.params, asyn.params) <= TOL
    np.testing.assert_allclose(
        [r.mean_local_loss for r in sync.history],
        [r.mean_local_loss for r in asyn.history],
        atol=TOL, rtol=0,
    )


def test_hierarchical_async_single_region_matches_reference(pair):
    fed, got, ref_fed, ref = run_both(
        pair, rounds=2, local_epochs=1, batch_size=4, seed=0,
        aggregator="hierarchical-async:1", latency="constant")
    assert_matches_reference(fed, got, ref_fed, ref)


# --------------------------------------------------------------------------
# seeded replay determinism
# --------------------------------------------------------------------------


def test_seeded_replay_is_bit_identical(setup):
    """Same seed -> same timeline, same flushes, same parameters, bitwise —
    the property that makes the simulator a controlled instrument."""
    clients, loss_fn, params0 = setup
    config = dict(rounds=4, local_epochs=1, batch_size=4, seed=3,
                  aggregator="fedbuff:3,0.5", latency="pareto:1.2", dropout=0.2)
    fed1, out1 = run_async(clients, loss_fn, params0, **config)
    fed2, out2 = run_async(clients, loss_fn, params0, **config)
    key = lambda out: [(r.virtual_time, r.participant_ids, r.staleness, r.mean_local_loss)  # noqa: E731
                       for r in out.history]
    assert key(out1) == key(out2)
    assert same_bits(out1.params, out2.params)
    s1, s2 = fed1.last_run_stats, fed2.last_run_stats
    assert s1 == s2
    assert s1["dropped"] > 0  # the scenario actually exercised dropout
    # a different seed produces a genuinely different timeline
    _, out3 = run_async(clients, loss_fn, params0, **{**config, "seed": 4})
    assert [r.virtual_time for r in out3.history] != [r.virtual_time for r in out1.history]


# --------------------------------------------------------------------------
# async semantics: staleness, stragglers, dropout, degenerate buffers
# --------------------------------------------------------------------------


def test_partial_buffer_accrues_staleness(setup):
    """fedbuff with a small buffer under latency spread: in-flight tasks
    anchor at old versions, so later flushes carry staleness > 0 and the
    virtual clock advances monotonically."""
    clients, loss_fn, params0 = setup
    _, out = run_async(clients, loss_fn, params0, rounds=5, local_epochs=1, batch_size=4,
                       seed=0, aggregator="fedbuff:3", latency="lognormal:0.8")
    assert len(out.history) == 5
    times = [r.virtual_time for r in out.history]
    assert times == sorted(times) and times[0] > 0
    assert all(r.staleness >= 0 for r in out.history)
    assert max(r.staleness for r in out.history) > 0
    assert all(np.isfinite(r.mean_local_loss) for r in out.history)
    summary = out.summary()
    assert summary["virtual_time"] == times[-1]
    assert summary["mean_staleness"] > 0


@pytest.mark.parametrize("config", [
    dict(aggregator="fedbuff:3", latency="lognormal:0.8", dropout=0.2, rounds=5),
    dict(aggregator="fedbuff:2,1.0", latency="pareto:1.2", dropout=0.1, rounds=4,
         engine="sequential"),
    dict(aggregator="hierarchical-async:3", latency="lognormal:0.6", dropout=0.3, rounds=4),
    dict(aggregator="fedbuff:4", latency="lognormal:0.5", concurrency=3, rounds=3),
    dict(aggregator="fedbuff:0.3", latency="trace:0.2,1.0", dropout=0.1, rounds=3,
         recruitment="nu-greedy"),
])
def test_timeline_matches_reference_under_stragglers_and_dropout(pair, config):
    """Latency spread and client dropout: the port's run and the
    reference's give the same virtual times, participants and staleness
    (the scheduler's stream is the reference's), and the trained numbers
    agree at dropout 0 of the model."""
    fed, got, ref_fed, ref = run_both(pair, local_epochs=1, batch_size=4, seed=0, **config)
    assert len(got.history) == config["rounds"]
    assert_matches_reference(fed, got, ref_fed, ref)


def test_trace_latency_flushes_small_clients_first(setup):
    """Under size-proportional latency with a one-update buffer, the first
    flush must contain exactly the smallest client — the straggler effect
    the recruitment trade-off is about."""
    clients, loss_fn, params0 = setup
    _, out = run_async(clients, loss_fn, params0, rounds=3, local_epochs=1, batch_size=4,
                       seed=0, aggregator="fedbuff:1", latency="trace:1.0,0.0")
    # A flush lands at the next event boundary, so every client tied at the
    # minimum size completes into the first flush together.
    min_n = min(c.n_train for c in clients)
    smallest = sorted(c.client_id for c in clients if c.n_train == min_n)
    assert out.history[0].participant_ids == smallest
    assert out.history[0].virtual_time == pytest.approx(min_n)


def test_total_dropout_terminates_at_time_ceiling(setup):
    """dropout=1: no update ever reaches the server; the virtual-time
    ceiling stops the retry loop, and the params come back untouched."""
    clients, loss_fn, params0 = setup
    fed, out = run_async(clients, loss_fn, params0, rounds=3, local_epochs=1, batch_size=4,
                         seed=0, aggregator="fedbuff:2", latency="constant", dropout=1.0,
                         max_virtual_time=25.0)
    assert out.history == []
    assert fed.last_run_stats["flushes"] == 0
    assert fed.last_run_stats["dropped"] > 0
    assert fed.last_run_stats["virtual_time"] <= 25.0
    assert same_bits(out.params, params0)
    assert out.summary()["virtual_time"] is None


def test_total_dropout_without_ceiling_raises(setup):
    """dropout=1 and no virtual-time ceiling: the runtime must refuse to
    spin forever — a sustained drought of dropped tasks is a loud error."""
    clients, loss_fn, params0 = setup
    fed = AsyncFederation(
        AsyncFederationConfig(rounds=3, local_epochs=1, batch_size=4, seed=0,
                              aggregator="fedbuff:2", latency="constant", dropout=1.0),
        clients, loss_fn, opt(), device="cpu",
    )
    with pytest.raises(RuntimeError, match="dropped"):
        fed.run(params0)


def test_fractional_fedbuff_buffer_resolves_against_federation(setup):
    """'fedbuff:0.25' sizes the buffer as a fraction of the federation's
    tasks once recruitment has run — same int-count/float-fraction grammar
    as the selection specs, sized as the reference sizes it."""
    clients, loss_fn, params0 = setup
    for spec, tasks in (("fedbuff:0.5", 10), ("fedbuff:0.25", 189), ("fedbuff:0.3", 7),
                        ("fedbuff:1.0", 7), ("fedbuff:8", 3), ("fedbuff:0.01", 10)):
        ours, theirs = resolve_aggregator(spec), jax_api.resolve_aggregator(spec)
        assert ours.buffer_fraction == theirs.buffer_fraction
        ours.prepare(tasks)
        theirs.prepare(tasks)
        assert ours.buffer_size == theirs.buffer_size
    agg = resolve_aggregator("fedbuff:0.5")
    agg.prepare(10)
    assert agg.buffer_fraction == 0.5 and agg.buffer_size == 5
    assert resolve_aggregator("fedbuff:8").buffer_fraction is None
    with pytest.raises(ValueError, match="fractional"):
        resolve_aggregator("fedbuff:1.5")
    # "fedbuff:1.0" + zero spread is the parity configuration by spec alone
    sync = Federation(
        FederationConfig(rounds=1, local_epochs=1, batch_size=4, aggregator="fedavg"),
        clients, loss_fn, opt(), device="cpu",
    ).run(params0)
    _, asyn = run_async(clients, loss_fn, params0, rounds=1, local_epochs=1, batch_size=4,
                        aggregator="fedbuff:1.0", latency="constant")
    assert max_gap(sync.params, asyn.params) <= TOL


def test_oversized_buffer_force_flushes(setup):
    """fedbuff:K with K > federation size cannot fill its buffer; the
    runtime force-flushes once every task has reported instead of
    deadlocking — the semi-synchronous degenerate case."""
    clients, loss_fn, params0 = setup
    fed, out = run_async(clients, loss_fn, params0, rounds=2, local_epochs=1, batch_size=4,
                         seed=0, aggregator="fedbuff:99", latency="lognormal:0.5")
    assert len(out.history) == 2
    assert fed.last_run_stats["forced_flushes"] == 2
    # every member reported into each forced flush
    assert out.history[0].participant_ids == sorted(c.client_id for c in clients)


def test_concurrency_cap_refills_without_starvation(setup):
    """M_max semantics: a completion funds the next not-yet-trained task,
    so a cap below the federation size still cycles through every client
    and can fill a buffer larger than the cap without forced flushes."""
    clients, loss_fn, params0 = setup
    fed, out = run_async(clients, loss_fn, params0, rounds=3, local_epochs=1, batch_size=4,
                         seed=0, aggregator="fedbuff:4", latency="lognormal:0.5",
                         concurrency=3)
    assert len(out.history) == 3
    assert fed.last_run_stats["forced_flushes"] == 0
    assert all(len(r.participant_ids) >= 4 for r in out.history)
    seen = {c for r in out.history for c in r.participant_ids}
    assert len(seen) > 3


def test_hierarchical_async_regions(setup):
    clients, loss_fn, params0 = setup
    agg = HierarchicalAsyncAggregator(num_regions=3)
    groups = agg.task_groups(np.arange(10))
    ref_groups = jax_staleness.HierarchicalAsyncAggregator(num_regions=3).task_groups(
        np.arange(10))
    assert [g.tolist() for g in groups] == [g.tolist() for g in ref_groups]
    assert len(groups) == 3
    np.testing.assert_array_equal(np.concatenate(groups), np.arange(10))
    _, out = run_async(clients, loss_fn, params0, rounds=4, local_epochs=1, batch_size=4,
                       seed=0, aggregator="hierarchical-async:3", latency="lognormal:0.8")
    assert len(out.history) == 4
    # each flush is one region's completion: a strict subset of the federation
    assert all(0 < len(r.participant_ids) < len(clients) for r in out.history)
    assert max(r.staleness for r in out.history) > 0


# --------------------------------------------------------------------------
# facade wiring and validation
# --------------------------------------------------------------------------


def test_sync_federation_rejects_buffered_aggregators(setup):
    clients, loss_fn, _ = setup
    for spec in ("fedbuff:4", "hierarchical-async:2"):
        with pytest.raises(ValueError, match="AsyncFederation"):
            Federation(FederationConfig(aggregator=spec), clients, loss_fn, opt(), device="cpu")
    assert resolve_aggregator("fedbuff").mode == jax_api.resolve_aggregator("fedbuff").mode


def test_async_federation_rejects_sync_aggregators(setup):
    clients, loss_fn, _ = setup
    with pytest.raises(ValueError, match="buffered aggregator"):
        AsyncFederation(AsyncFederationConfig(aggregator="fedavg"), clients, loss_fn, opt(),
                        device="cpu")
    with pytest.raises(TypeError, match="AsyncFederationConfig"):
        AsyncFederation(FederationConfig(), clients, loss_fn, opt(), device="cpu")


def test_async_config_validation():
    for module in (None, jax_runtime):
        config = AsyncFederationConfig if module is None else module.AsyncFederationConfig
        fedbuff = FedBuffAggregator if module is None else module.FedBuffAggregator
        regions = (HierarchicalAsyncAggregator if module is None
                   else module.HierarchicalAsyncAggregator)
        with pytest.raises(ValueError, match="rounds"):
            config(rounds=0)
        with pytest.raises(ValueError, match="concurrency"):
            config(concurrency=0)
        with pytest.raises(ValueError, match="max_virtual_time"):
            config(max_virtual_time=-1.0)
        with pytest.raises(ValueError, match="unknown engine"):
            config(engine="warp-drive")
        with pytest.raises(ValueError, match="buffer_size"):
            fedbuff(buffer_size=0)
        with pytest.raises(ValueError, match="staleness_exponent"):
            fedbuff(staleness_exponent=-1.0)
        with pytest.raises(ValueError, match="server_lr"):
            fedbuff(server_lr=0.0)
        with pytest.raises(ValueError, match="region"):
            regions(num_regions=0)
    with pytest.raises(ValueError, match="total_weight"):
        HierarchicalAsyncAggregator(2).combine({}, [], 0, 0.0)


def test_unknown_spec_gets_did_you_mean_suggestion():
    with pytest.raises(ValueError, match="did you mean 'fedbuff'"):
        resolve_aggregator("fedbuf:8")
    with pytest.raises(ValueError, match="did you mean 'hierarchical-async'"):
        resolve_aggregator("hierarchical-asyn:2")


def test_bad_task_groups_rejected(setup):
    clients, loss_fn, params0 = setup

    class Lossy(FedBuffAggregator):
        def task_groups(self, federation_ids):
            return [np.asarray(federation_ids)[:-1]]  # drops one member

    fed = AsyncFederation(
        AsyncFederationConfig(rounds=1, local_epochs=1, batch_size=4, aggregator=Lossy(2)),
        clients, loss_fn, opt(), device="cpu",
    )
    with pytest.raises(ValueError, match="partition"):
        fed.run(params0)


def test_custom_async_aggregator_instance(setup):
    """A user-defined buffered aggregator passed as an instance: flush on
    every completion, plain unweighted delta averaging."""
    clients, loss_fn, params0 = setup

    class EveryCompletion(AsyncAggregator):
        def ready(self, buffered):
            return buffered >= 1

        def combine(self, params, updates, version, total_weight):
            coeff = 1.0 / max(len(updates), 1)
            new = params
            for u in updates:
                new = tree_map(lambda p, a, b: p + coeff * (a - b), new, u.params, u.anchor)
            return new

    _, out = run_async(clients, loss_fn, params0, rounds=3, local_epochs=1, batch_size=4,
                       aggregator=EveryCompletion(), latency="lognormal:0.4")
    assert len(out.history) == 3
    assert all(len(r.participant_ids) == 1 for r in out.history)


def test_round_record_timing_fields(setup):
    """round_time_s everywhere; virtual_time/staleness are async-only;
    summary() totals all three."""
    clients, loss_fn, params0 = setup
    sync = Federation(
        FederationConfig(rounds=2, local_epochs=1, batch_size=4), clients, loss_fn, opt(),
        device="cpu",
    ).run(params0)
    for r in sync.history:
        assert r.round_time_s == r.wall_time_s >= 0
        assert r.virtual_time is None and r.staleness is None
    s = sync.summary()
    assert s["total_round_time_s"] == pytest.approx(sum(r.wall_time_s for r in sync.history))
    assert s["virtual_time"] is None and s["mean_staleness"] is None

    _, asyn = run_async(clients, loss_fn, params0, rounds=2, local_epochs=1, batch_size=4,
                        aggregator="fedbuff:4", latency="lognormal:0.5")
    a = asyn.summary()
    assert a["virtual_time"] == asyn.history[-1].virtual_time > 0
    assert a["mean_staleness"] == pytest.approx(np.average(
        [r.staleness for r in asyn.history],
        weights=[len(r.participant_ids) for r in asyn.history]))
    assert a["total_round_time_s"] >= 0 and a["metrics"] == asyn.metrics
    assert a["metrics"]["counters"]["rounds.completed"] == 2
    n_tensors = len(tree_leaves(params0))
    for r in asyn.history:
        assert r.params_down == r.params_up == len(r.participant_ids) * n_tensors
        assert r.to_state()["virtual_time"] == r.virtual_time


def test_summary_weights_staleness_by_participants_as_the_reference_does():
    records = [RoundRecord(i, list(range(n)), 1.0, 1, 1, 1, 8, 0.1, virtual_time=t,
                           staleness=s)
               for i, (n, t, s) in enumerate(((4, 1.0, 0.0), (1, 2.5, 3.0), (0, 3.0, 1.0)))]
    ids = np.arange(5)
    got = FederatedRunResult(params=None, history=records, recruitment=None,
                             federation_ids=ids, total_wall_time_s=1.0,
                             total_local_steps=3).summary()
    ref = jax_api.FederatedRunResult(
        params=None, history=[jax_api.RoundRecord(**r.__dict__) for r in records],
        recruitment=None, federation_ids=ids, total_wall_time_s=1.0,
        total_local_steps=3).summary()
    for key in ("rounds", "virtual_time", "mean_staleness", "total_round_time_s",
                "bytes_transferred", "epsilon"):
        assert got[key] == ref[key], key


def test_recruitment_composes_with_async_runtime(setup):
    """nu-greedy recruitment runs before the event loop, identically to the
    sync facade: only recruited clients ever appear in any flush."""
    clients, loss_fn, params0 = setup
    sync_ids, _ = Federation(
        FederationConfig(recruitment="nu-greedy"), clients, loss_fn, opt(), device="cpu"
    ).build_federation()
    fed, out = run_async(clients, loss_fn, params0, rounds=3, local_epochs=1, batch_size=4,
                         recruitment="nu-greedy", aggregator="fedbuff:2", latency="pareto:1.5")
    assert out.federation_ids.tolist() == sync_ids.tolist()
    assert fed.build_federation()[0].tolist() == sync_ids.tolist()
    assert set(c for r in out.history for c in r.participant_ids) <= set(sync_ids.tolist())


def test_unported_hooks_raise(setup, tmp_path):
    """The hooks that once waited for a port now run: the flush snapshots
    (the snapshot hook runs after every non-final flush and a resume from
    its snapshot replays the run), ``metrics=`` (the registry the flushes
    fill), ``tracer=`` (shared with the inner facade and the scheduler,
    which marks every popped event) and ``profiler=`` (a ``RoundProfiler``
    bracketing the flushes).  Traced and profiled, the run is the same bits."""
    clients, loss_fn, params0 = setup
    cfg = AsyncFederationConfig(rounds=2, local_epochs=1, batch_size=4, aggregator="fedbuff:2")
    fed = AsyncFederation(cfg, clients, loss_fn, opt(), device="cpu")
    snaps = []
    full = fed.run(params0, snapshot_hook=snaps.append)
    assert [s.round_index for s in snaps] == [1]
    resumed = AsyncFederation(cfg, clients, loss_fn, opt(), device="cpu").run(
        params0, resume=snaps[0])
    assert timeline(resumed.history) == timeline(full.history)
    assert same_bits(resumed.params, full.params)
    registry = MetricsRegistry()
    out = AsyncFederation(cfg, clients, loss_fn, opt(), device="cpu", metrics=registry).run(
        params0)
    assert out.metrics == registry.snapshot() and out.metrics["counters"]["rounds.completed"] == 2
    tracer = Tracer()
    profiler = RoundProfiler(1, str(tmp_path / "profile"), device="cpu")
    hooked = AsyncFederation(cfg, clients, loss_fn, opt(), device="cpu", tracer=tracer,
                             profiler=profiler)
    assert (hooked.tracer, hooked._fed.tracer, hooked.profiler) == (tracer, tracer, profiler)
    traced = hooked.run(params0)
    assert same_bits(traced.params, full.params) and profiler.error is None
    assert [s.dur for s in tracer.spans("flush", clock="host")] == [
        r.round_time_s for r in traced.history]
    assert os.path.exists(profiler.trace_path)
    sched = VirtualScheduler(seed=0, tracer=tracer)
    sched.after(1.5, "complete")
    before = len(tracer.events())
    assert sched.pop().time == 1.5
    mark = tracer.events()[before]
    assert (mark.name, mark.ts, mark.track, mark.clock, mark.args) == (
        "complete", 1.5, "scheduler", "virtual", {"seq": 0})
    assert fed.device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            AsyncFederation(cfg, clients, loss_fn, opt())


# --------------------------------------------------------------------------
# DP: one accountant across the event loop
# --------------------------------------------------------------------------


def test_dp_epsilons_match_reference(pair):
    """Each flush composes its participant fraction: with the same timeline
    the epsilons are the reference's, flush by flush."""
    privacy = {"clip_norm": 1.0, "noise_multiplier": 1.1, "delta": 1e-5}
    fed, got, ref_fed, ref = run_both(
        pair, rounds=3, local_epochs=1, batch_size=4, seed=0, aggregator="fedbuff:2",
        latency="lognormal:0.6", dropout=0.1, concurrency=4, privacy=privacy)
    assert timeline(got.history) == timeline(ref.history)
    eps = [r.epsilon for r in got.history]
    assert eps == [r.epsilon for r in ref.history]
    assert all(e > 0 for e in eps) and eps == sorted(eps)
    assert got.summary()["epsilon"] == eps[-1]


# --------------------------------------------------------------------------
# time to target and the async comparison
# --------------------------------------------------------------------------


def records_of(points):
    return [RoundRecord(i, [0], loss, 1, 1, 1, 8, 0.1, virtual_time=t, staleness=0.0)
            for i, (t, loss) in enumerate(points)]


@pytest.mark.parametrize("histories", [
    {"a": [(1.0, 3.0), (2.0, 2.0), (3.0, 2.5), (4.0, 1.0)],
     "b": [(0.5, 2.8), (1.5, 1.9), (2.5, float("nan")), (3.5, 2.2)]},
    {"a": [(1.0, 1.0)], "b": [(2.0, 1.0)]},
    {"a": [(1.0, float("nan"))], "b": [(1.0, 2.0)]},
    {"a": [], "b": [(1.0, 2.0)]},
    {"only": [(0.3, 5.0), (0.9, float("inf")), (1.2, 4.0)]},
])
def test_time_to_target_matches_reference(histories):
    hist = {k: records_of(v) for k, v in histories.items()}
    got = paper.shared_time_to_target(hist)
    want = jax_paper.shared_time_to_target(hist)
    assert got[1] == want[1]
    assert (np.isnan(got[0]) and np.isnan(want[0])) or got[0] == want[0]
    for target in (0.5, 1.0, 2.0, 2.9, 10.0):
        for h in hist.values():
            assert paper.time_to_target(h, target) == jax_paper.time_to_target(h, target)


TIMELINE_FIELDS = ("federation_size", "recruited", "buffer_size", "flushes", "tasks",
                   "dropped", "virtual_time")


def test_run_async_comparison_timeline_matches_reference(monkeypatch):
    """A small comparison on the CPU: the timeline fields come from numpy
    streams alone, so they equal the reference's exactly; the losses come
    from another init (torch's generator) and are only held finite.  The
    reference runs with rebuild staging (see ``run_both``)."""
    monkeypatch.setattr(jax_paper, "AsyncFederationConfig", functools.partial(
        jax_runtime.AsyncFederationConfig, staging="rebuild"))
    kw = dict(flushes=2, latency_models=("pareto:1.2",), cohort_scale=0.02, verbose=False)
    got = paper.run_async_comparison(device="cpu", **kw)
    ref = jax_paper.run_async_comparison(**kw)
    assert {k: v for k, v in got.items() if k != "latency"} == {
        k: v for k, v in ref.items() if k != "latency"}
    row, ref_row = got["latency"]["pareto:1.2"], ref["latency"]["pareto:1.2"]
    for name, _ in paper.ASYNC_FEDERATIONS:
        assert {f: row[name][f] for f in TIMELINE_FIELDS} == {
            f: ref_row[name][f] for f in TIMELINE_FIELDS}
        assert [t for t, _ in row[name]["trajectory"]] == [
            t for t, _ in ref_row[name]["trajectory"]]
        assert row[name]["mean_staleness"] == ref_row[name]["mean_staleness"]
        assert all(np.isfinite(loss) for _, loss in row[name]["trajectory"])
    assert paper.ASYNC_LATENCY_MODELS == jax_paper.ASYNC_LATENCY_MODELS
    assert paper.ASYNC_FEDERATIONS == jax_paper.ASYNC_FEDERATIONS
