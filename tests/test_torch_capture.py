"""The captured training steps (``repro_torch/capture.py``) on the CPU.

On the card a trainer captures its step as a CUDA graph and replays it; on
the CPU it runs eagerly.  Here the captured path is forced on the CPU
(``capture_enabled`` patched to true), where ``GraphCache.capture`` returns
a stand-in that reruns the step's body at each replay.  So everything but
the graph itself runs: the static buffers, the per-step copies, the
``torch.where`` update for every client, every client drawing from its slot
generator with the slots of clients whose step is padding moved back
(through ``get_state`` / ``set_state``), the loss cloned out, the launch
bookkeeping and the compile events.

* The forced path equals the eager path bit for bit (``torch.equal``) on a
  6-client federation of mixed sizes (partially valid steps), dropout
  0.05, 2 rounds x 2 epochs, ``cohort_chunk=4``: with and without DP
  (noise on), resident and rebuild staging; params, every call's
  per-client losses and every participant generator's state.  The same
  for the sequential engine and the central trainer.
* The forced path against the JAX package's vectorized round (dropout 0,
  DP with noise 0): round losses within 1e-5, params within 1e-4.
* The width ladder: on a federation whose clients with a batch left fall
  through four widths, whole and chunked, both stagings, with and without
  DP, the forced path is the eager path bit for bit, with one graph a
  width and the expected slot-steps and span widths; at this shape it is
  also the round whose every step runs the whole chunk; clients with as
  many batches each take one full-width graph.
* Keys: a chunk's key holds across epochs and rounds (no capture after the
  first round); a chunked federation has one key a chunk size, and a graph
  a width its steps use; sliced resident chunks share one key.
* A replay adds the capture's launch deltas (a stand-in graph object); a
  capture restores the counters after its warm-up; a capture counts as a
  compile (``jit.compiles``), and a steady round as none.
* ``disable_capture()`` nests and restores; the CPU captures nothing.
* ``AdamW.update`` with the coefficients as a device tensor gives the host
  floats' bits, and the local and central trainers the parent's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.data.pipeline import build_client_datasets as jax_clients  # noqa: E402
from repro.data.synth_eicu import CohortConfig as JaxCohortConfig  # noqa: E402
from repro.data.synth_eicu import generate_cohort as jax_generate  # noqa: E402
from repro.federated.api import Federation as JaxFederation  # noqa: E402
from repro.federated.api import FederationConfig as JaxFederationConfig  # noqa: E402
from repro.models import gru as jax_gru  # noqa: E402
from repro.optim.adamw import AdamW as JaxAdamW  # noqa: E402
from repro_torch import capture  # noqa: E402
from repro_torch.data.pipeline import (  # noqa: E402
    ArrayDataset,
    ClientDataset,
    build_client_datasets,
)
from repro_torch.data.synth_eicu import CohortConfig, generate_cohort  # noqa: E402
from repro_torch.federated import client as client_module  # noqa: E402
from repro_torch.federated import cohort as cohort_module  # noqa: E402
from repro_torch.federated.api import Federation, FederationConfig  # noqa: E402
from repro_torch.federated.central import CentralConfig, train_central  # noqa: E402
from repro_torch.federated.client import (  # noqa: E402
    LocalTrainer,
    to_device,
    trainable_copy,
    train_step,
)
from repro_torch.federated.cohort import CohortTrainer, client_generators  # noqa: E402
from repro_torch.kernels.gru_scan import kernel as gru_kernel  # noqa: E402
from repro_torch.models import gru  # noqa: E402
from repro_torch.obs import MetricsRegistry, trace  # noqa: E402
from repro_torch.obs.trace import NULL_TRACER, Tracer  # noqa: E402
from repro_torch.obs.profile import CompileWatcher  # noqa: E402
from repro_torch.optim.adamw import AdamW, apply_updates, cosine_schedule  # noqa: E402
from repro_torch.privacy.dp import DPConfig  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from _fake_events import FakeDevice  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-5
PARAMS_TOL = 1e-4
SIZES = (3, 17, 40, 9, 25, 1)   # batches of 8: 1 to 5 a client, so steps are partly valid
SEQ_LEN, FEAT = 6, 38
COHORT = dict(num_hospitals=8, total_stays=320, min_hospital_size=10)
DP = DPConfig(clip_norm=1.0, noise_multiplier=1.0)


@pytest.fixture
def forced(monkeypatch):
    """The captured path on the CPU: the trainers take it, and capture
    builds the stand-in that reruns the body."""
    monkeypatch.setattr(cohort_module, "capture_enabled", lambda device: True)
    monkeypatch.setattr(client_module, "capture_enabled", lambda device: True)


def make_clients(sizes=SIZES, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(sizes):
        x = rng.normal(size=(n, SEQ_LEN, FEAT)).astype(np.float32)
        y = rng.uniform(0.5, 20.0, size=n).astype(np.float32)
        ds = ArrayDataset(x, y)
        out.append(ClientDataset(client_id=i, train=ds, val=ds))
    return out


def model(dropout=0.05):
    cfg = gru.GRUConfig(input_dim=FEAT, hidden_dim=8, num_layers=2, dropout=dropout)
    return cfg, gru.init_gru(torch.Generator().manual_seed(1), cfg, "cpu")


def record_calls(fed) -> list:
    """Each trainer call's per-client losses and its generators' states after it."""
    calls = []
    train_cohort = fed.cohort_trainer.train_cohort
    train_client = fed.trainer.train_client

    def cohort_call(params, clients, rng, generators, steps_per_epoch=None):
        out = train_cohort(params, clients, rng, generators, steps_per_epoch)
        calls.append((out[1], [g.get_state() for g in generators], dict(
            fed.cohort_trainer.last_round_stats)))
        return out

    def client_call(params, client, rng, generator):
        out = train_client(params, client, rng, generator)
        calls.append((np.float32(out[1]), [generator.get_state()], None))
        return out

    fed.cohort_trainer.train_cohort = cohort_call
    fed.trainer.train_client = client_call
    return calls


def run_federation(engine="vectorized", staging="rebuild", dp=None, rounds=2, dropout=0.05):
    cfg, params = model(dropout)
    fed = Federation(
        FederationConfig(rounds=rounds, local_epochs=2, batch_size=8, seed=3, engine=engine,
                         staging=staging, cohort_chunk=4, recruitment="all", privacy=dp),
        make_clients(), gru.make_loss_fn(cfg), AdamW(), device="cpu",
    )
    calls = record_calls(fed)
    return fed, fed.run(params), calls


def assert_same_run(a, b):
    (_, got, calls_got), (_, ref, calls_ref) = a, b
    assert [r.mean_local_loss for r in got.history] == [r.mean_local_loss for r in ref.history]
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(got.params), tree_leaves(ref.params)))
    assert len(calls_got) == len(calls_ref) > 0
    for (lg, sg, _), (lr, sr, _) in zip(calls_got, calls_ref):
        assert np.array_equal(lg, lr, equal_nan=True)
        assert all(torch.equal(x, y) for x, y in zip(sg, sr))


# --------------------------------------------------------------------------
# the step body on the CPU against the eager step
# --------------------------------------------------------------------------


@pytest.mark.parametrize("staging", ["rebuild", "resident"])
@pytest.mark.parametrize("dp", [None, DP], ids=["no-dp", "dp"])
def test_captured_cohort_step_is_the_eager_step(monkeypatch, staging, dp):
    eager = run_federation(staging=staging, dp=dp)
    monkeypatch.setattr(cohort_module, "capture_enabled", lambda device: True)
    got = run_federation(staging=staging, dp=dp)
    assert_same_run(got, eager)
    fed, _, calls = got
    # Chunks of 4 and 2: two keys, the first's steps at widths 4 and 2, the
    # second's at 2; three graphs, captured in round 1 and replayed after.
    assert [c[2]["captures"] for c in calls] == [3, 0]
    assert all(c[2]["replays"] == c[2]["cohort_steps"] > 0 for c in calls)
    entries = fed.cohort_trainer.graphs.entries
    assert len(entries) == 2
    assert [sorted(s.graphs) for s in entries.values()] == [[2, 4], [2]]
    assert [c[2]["captures"] for c in eager[2]] == [0, 0]


@pytest.mark.parametrize("dp", [None, DP], ids=["no-dp", "dp"])
def test_captured_local_step_is_the_eager_step(monkeypatch, dp):
    eager = run_federation(engine="sequential", dp=dp)
    monkeypatch.setattr(client_module, "capture_enabled", lambda device: True)
    got = run_federation(engine="sequential", dp=dp)
    assert_same_run(got, eager)
    graphs = got[0].trainer.graphs
    assert graphs.captures == 1 and len(graphs.entries) == 1
    assert graphs.replays == got[1].total_local_steps


def test_captured_central_step_is_the_eager_step(monkeypatch):
    cfg, params = model()
    data = make_clients()[2].train
    config = CentralConfig(epochs=2, batch_size=8, seed=0)
    eager = train_central(config, data, params, gru.make_loss_fn(cfg), AdamW(), device="cpu")
    monkeypatch.setattr(client_module, "capture_enabled", lambda device: True)
    got = train_central(config, data, params, gru.make_loss_fn(cfg), AdamW(), device="cpu")
    assert got.epoch_losses == eager.epoch_losses
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got.params),
                                                 tree_leaves(eager.params)))
    assert (got.captures, got.replays, eager.captures, eager.replays) == (1, 10, 0, 0)
    assert got.capture_seconds > 0.0 == eager.capture_seconds


# --------------------------------------------------------------------------
# the width ladder: each step only as wide as the clients still training
# --------------------------------------------------------------------------

# Batches of 8 an epoch: 1, 4, 1, 9, 2, 3, 1, 2, 1.  The clients with a batch
# left fall 9, 5, 3, 2, 1, 1, 1, 1, 1 over an epoch: the whole chunk's steps
# run at widths 9, 8, 4, 2, 2, 2, 2, 2, 2, so the 70-stay client trains alone
# for five steps an epoch.
LADDER_SIZES = (5, 30, 1, 70, 12, 20, 8, 9, 3)
# chunk -> (each key's widths, by its chunk size; the slots a round runs)
LADDER = {
    None: ({9: [2, 4, 8, 9]}, 2 * 33),
    # (5, 30, 1, 70, 12): 5, 4, 2, 2, 2, 2, 2, 2, 2; (20, 8, 9, 3): 4, 2, 2
    5: ({5: [2, 4, 5], 4: [2, 4]}, 2 * 31),
}


def run_ladder(staging, dp, chunk, sizes=LADDER_SIZES, tracer=None):
    cfg, params = model()
    fed = Federation(
        FederationConfig(rounds=2, local_epochs=2, batch_size=8, seed=5, staging=staging,
                         cohort_chunk=chunk, recruitment="all", privacy=dp),
        make_clients(sizes, seed=1), gru.make_loss_fn(cfg), AdamW(), device="cpu",
        tracer=tracer,
    )
    calls = record_calls(fed)
    return fed, fed.run(params), calls


@pytest.mark.parametrize("chunk", [None, 5], ids=["whole", "chunked"])
@pytest.mark.parametrize("staging", ["rebuild", "resident"])
@pytest.mark.parametrize("dp", [None, DP], ids=["no-dp", "dp"])
def test_the_ladder_round_is_the_eager_round(monkeypatch, staging, dp, chunk):
    """A federation whose clients with a batch left fall through four
    widths: the captured round (one graph a width over one set of buffers)
    is the eager round bit for bit, its slot-steps and its spans' widths
    the expected ladder."""
    eager = run_ladder(staging, dp, chunk)
    monkeypatch.setattr(cohort_module, "capture_enabled", lambda device: True)
    tracer = Tracer()
    got = run_ladder(staging, dp, chunk, tracer=tracer)
    assert_same_run(got, eager)
    widths, slot_steps = LADDER[chunk]
    fed, _, calls = got
    entries = fed.cohort_trainer.graphs.entries
    assert {key[0]: sorted(s.graphs) for key, s in entries.items()} == widths
    assert [c[2]["captures"] for c in calls] == [sum(map(len, widths.values())), 0]
    assert all(c[2]["cohort_slot_steps"] == slot_steps for c in calls + eager[2])
    spans = tracer.spans("cohort_step")
    assert len(spans) == sum(c[2]["cohort_steps"] for c in calls)
    assert sum(s.args["width"] for s in spans) == 2 * slot_steps
    assert {s.args["width"] for s in spans} == set().union(*widths.values())


@pytest.mark.parametrize("staging", ["rebuild", "resident"])
@pytest.mark.parametrize("dp", [None, DP], ids=["no-dp", "dp"])
def test_the_ladder_keeps_the_full_width_bits(monkeypatch, staging, dp):
    """On the CPU at this model's shape a client's step does not depend on
    how many clients share it, so the ladder's round is the round whose
    every step runs the whole chunk (each step's width forced to the chunk's
    size) bit for bit: the same work, fewer slots."""
    ladder = run_ladder(staging, dp, None)
    monkeypatch.setattr(cohort_module, "step_width", lambda valid: len(valid))
    full = run_ladder(staging, dp, None)
    assert_same_run(ladder, full)
    assert all(c[2]["cohort_slot_steps"] == 9 * c[2]["cohort_steps"] for c in full[2])
    assert all(c[2]["cohort_slot_steps"] == LADDER[None][1] for c in ladder[2])


@pytest.mark.parametrize("staging", ["rebuild", "resident"])
def test_equal_clients_take_one_full_width_graph(forced, staging):
    """Clients with as many batches each keep every step at the chunk's
    size: one graph, as many slots as steps times clients."""
    cfg, _ = model()
    trainer = CohortTrainer(gru.make_loss_fn(cfg), AdamW(), batch_size=8, local_epochs=2,
                            staging=staging, device="cpu")
    stats = train_rounds(trainer, make_clients((17, 20, 24, 22)))
    (step,) = trainer.graphs.entries.values()
    assert list(step.graphs) == [4]
    assert [s["captures"] for s in stats] == [1, 0]
    assert all(s["cohort_slot_steps"] == 4 * s["cohort_steps"] == 4 * 6 for s in stats)


# --------------------------------------------------------------------------
# against the JAX package's cohort round
# --------------------------------------------------------------------------


@pytest.mark.parametrize("staging", ["rebuild", "resident"])
@pytest.mark.parametrize("privacy", [None, {"clip_norm": 0.5, "noise_multiplier": 0.0}],
                         ids=["no-dp", "dp"])
def test_captured_federation_matches_jax(forced, staging, privacy):
    jcfg = jax_gru.GRUConfig(hidden_dim=8, num_layers=2, dropout=0.0)
    tcfg = gru.GRUConfig(hidden_dim=8, num_layers=2, dropout=0.0)
    init = jax.tree.map(np.asarray, jax_gru.init_gru(jax.random.key(0), jcfg))
    config = dict(rounds=2, local_epochs=2, batch_size=8, seed=1, recruitment="all",
                  privacy=privacy)
    ref = JaxFederation(
        JaxFederationConfig(**config, engine="vectorized", staging="rebuild"),
        jax_clients(jax_generate(JaxCohortConfig(**COHORT), seed=3)),
        jax_gru.make_loss_fn(jcfg), JaxAdamW(),
    ).run(init)
    fed = Federation(
        FederationConfig(**config, staging=staging, cohort_chunk=4),
        build_client_datasets(generate_cohort(CohortConfig(**COHORT), seed=3)),
        gru.make_loss_fn(tcfg), AdamW(), device="cpu",
    )
    got = fed.run(gru.params_from_jax(init, "cpu"))
    assert fed.cohort_trainer.graphs.captures > 0
    assert got.total_local_steps == ref.total_local_steps
    for g, r in zip(got.history, ref.history):
        assert g.participant_ids == r.participant_ids
        assert abs(g.mean_local_loss - r.mean_local_loss) <= TOL
    for a, b in zip(tree_leaves(got.params), jax.tree.leaves(ref.params)):
        assert float(np.max(np.abs(a.numpy() - np.asarray(b)))) <= PARAMS_TOL


# --------------------------------------------------------------------------
# keys
# --------------------------------------------------------------------------


def train_rounds(trainer, clients, rounds=2, seed=0):
    cfg, params = model()
    rng, gen_rng = np.random.default_rng(seed), np.random.default_rng([seed, 2])
    stats = []
    for _ in range(rounds):
        gens = client_generators(gen_rng, len(clients), torch.device("cpu"))
        params, _, _ = trainer.train_cohort(params, clients, rng, gens)
        stats.append(dict(trainer.last_round_stats))
    return stats


# The graphs of each chunk size's key: the widths its chunks' steps run at
# (SIZES at batch 8 are 1, 3, 5, 2, 4 and 1 batches an epoch).
GRAPHS = {None: 3, 4: 3, 3: 2, 2: 1, 5: 4}   # {2, 4, 6}; {2, 4} + {2}; {2, 3}; {2}; {2, 4, 5} + {1}


@pytest.mark.parametrize("chunk,staging,keys", [
    (None, "rebuild", 1), (4, "rebuild", 2), (3, "rebuild", 1), (2, "resident", 1),
    (4, "resident", 2), (5, "resident", 2),
])
def test_a_chunks_key_holds_across_epochs_and_rounds(forced, chunk, staging, keys):
    cfg, _ = model()
    trainer = CohortTrainer(gru.make_loss_fn(cfg), AdamW(), batch_size=8, local_epochs=2,
                            cohort_chunk=chunk, staging=staging, device="cpu")
    stats = train_rounds(trainer, make_clients())
    assert len(trainer.graphs.entries) == keys
    assert [s["captures"] for s in stats] == [GRAPHS[chunk], 0]
    assert all(s["replays"] == s["cohort_steps"] for s in stats)
    if staging == "resident" and chunk == 2:   # three slices from rows 0, 2, 4: one graph
        assert all(s["slice_chunks"] == 3 for s in stats)


def test_dp_and_a_new_device_cohort_are_other_keys(forced):
    cfg, _ = model()
    clients = make_clients()
    resident = CohortTrainer(gru.make_loss_fn(cfg), AdamW(), batch_size=8, local_epochs=1,
                             staging="resident", device="cpu")
    train_rounds(resident, clients, rounds=1)
    resident.attach_device_cohort(clients)   # new resident arrays: new pointers
    train_rounds(resident, clients, rounds=1)
    assert len(resident.graphs.entries) == 2
    keys = []
    for dp in (None, DP):
        trainer = CohortTrainer(gru.make_loss_fn(cfg), AdamW(), batch_size=8, local_epochs=1,
                                dp=dp, device="cpu")
        train_rounds(trainer, clients, rounds=1)
        keys.extend(trainer.graphs.entries)
    plain, private = keys
    assert plain != private
    assert [i for i, (a, b) in enumerate(zip(plain, private)) if a != b] == [3]   # DP on/off


# --------------------------------------------------------------------------
# bookkeeping, the switch, compile events
# --------------------------------------------------------------------------


class StandInGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_a_replay_adds_the_captures_launch_deltas():
    before = capture.launch_counts()
    output = torch.arange(3.0)
    step = capture.StepGraph(StandInGraph(), output, (2, 2, 0, 1))
    loss = step.replay()
    step.replay()
    after = capture.launch_counts()
    try:
        assert [a - b for a, b in zip(after, before)] == [4, 4, 0, 2]
        assert step.replays == 2 and step.graph.replays == 2
        assert torch.equal(loss, output) and loss.data_ptr() != output.data_ptr()
    finally:
        capture.set_launch_counts(before)


class TimedStandIn:
    """A graph whose replay takes ``seconds`` of a fake device's clock."""

    def __init__(self, device, seconds):
        self.device, self.seconds = device, seconds

    def replay(self):
        self.device.now += self.seconds


def test_a_replay_under_the_null_tracer_records_nothing(monkeypatch):
    device = FakeDevice().install(monkeypatch, trace)
    before = capture.launch_counts()
    step = capture.StepGraph(TimedStandIn(device, 1.0), torch.zeros(2), (0, 0, 0, 0))
    assert step.tracer is NULL_TRACER
    step.replay(t=0)
    assert (device.created, device.synchronizes, NULL_TRACER.events()) == (0, 0, [])
    # a cache on the CPU times nothing, whatever its owner's tracer
    cache = capture.GraphCache(torch.device("cpu"), Tracer(), "cohort_step")
    assert cache.tracer is NULL_TRACER
    cache.capture(lambda: torch.zeros(1)).replay()
    assert device.created == 0 and capture.launch_counts() == before


def test_a_timed_replay_is_a_device_span_around_the_graph(monkeypatch):
    device = FakeDevice(now=7.0).install(monkeypatch, trace)
    tracer = Tracer()
    step = capture.StepGraph(TimedStandIn(device, 0.003), torch.arange(2.0), (0, 0, 0, 0),
                             tracer, "cohort_step")
    for t in range(3):
        out = step.replay(t=t, held=1)
        device.done = device.now   # the replay finishes during
        device.now += 0.001        # the host's work before the next one
    assert torch.equal(out, torch.arange(2.0)) and step.replays == 3
    spans = tracer.spans("cohort_step", clock="device")
    assert [s.args for s in spans] == [{"t": t, "held": 1} for t in range(3)]
    assert [s.dur for s in spans] == pytest.approx([0.003] * 3)
    anchor = tracer._device.anchor_ts
    assert [s.ts - anchor for s in spans] == pytest.approx([0.0, 0.004, 0.008])
    # the anchor and two pairs: each pair is resolved at the next end, the third reuses the first's
    assert device.created == 5


def test_a_capture_puts_the_counters_back_after_its_warm_up():
    before = capture.launch_counts()
    cache = capture.GraphCache(torch.device("cpu"))
    slot = torch.Generator().manual_seed(5)
    state = slot.get_state()

    def body():
        gru_kernel.gru_scan.launches += 2   # as a launching step would
        torch.rand(4, generator=slot)
        return torch.zeros(2)

    step = cache.capture(body, [slot])
    assert capture.launch_counts() == before   # the warm-up counted nothing
    assert torch.equal(slot.get_state(), state)   # nor consumed its slot
    assert step.launches == (0, 0, 0, 0)   # the stand-in reruns the body instead
    assert (cache.captures, cache.replays) == (1, 0)
    step.replay()
    assert cache.replays == 1 and capture.launch_counts()[0] == before[0] + 2
    capture.set_launch_counts(before)


def test_disable_capture_nests_and_restores():
    cuda = torch.device("cuda")
    assert capture.capture_enabled(cuda)
    assert not capture.capture_enabled(torch.device("cpu"))
    with capture.disable_capture():
        assert not capture.capture_enabled(cuda)
        with capture.disable_capture():
            assert not capture.capture_enabled(cuda)
        assert not capture.capture_enabled(cuda)
    assert capture.capture_enabled(cuda)
    with pytest.raises(RuntimeError, match="inside"):
        with capture.disable_capture():
            raise RuntimeError("inside")
    assert capture.capture_enabled(cuda)


def test_the_cpu_captures_nothing():
    cfg, _ = model()
    trainer = CohortTrainer(gru.make_loss_fn(cfg), AdamW(), batch_size=8, local_epochs=1,
                            cohort_chunk=4, device="cpu")
    stats = train_rounds(trainer, make_clients())
    assert all((s["captures"], s["replays"], s["capture_seconds"], s["graph_pool_bytes"])
               == (0, 0, 0.0, 0) for s in stats)
    assert trainer.graphs.entries == {}


def test_a_capture_counts_as_a_compile(forced):
    with CompileWatcher(None) as watcher:
        capture.GraphCache(torch.device("cpu")).capture(lambda: torch.zeros(1))
    assert watcher.compiles == 1 and watcher.compile_time_s > 0.0
    metrics = MetricsRegistry()
    cfg, params = model()
    fed = Federation(
        FederationConfig(rounds=2, local_epochs=1, batch_size=8, seed=3, cohort_chunk=4,
                         recruitment="all"),
        make_clients(), gru.make_loss_fn(cfg), AdamW(), device="cpu", metrics=metrics,
    )
    fed.run(params)
    snap = metrics.snapshot()
    assert snap["counters"]["jit.compiles"] == 3   # two keys, three widths, in round 1
    assert snap["gauges"]["jit.round_compiles"] == 0   # round 2 replays


# --------------------------------------------------------------------------
# AdamW's coefficients from the device
# --------------------------------------------------------------------------


@pytest.mark.parametrize("options", [{}, {"clip_norm": 0.5},
                                     {"schedule": cosine_schedule(2, 6)}])
def test_adamw_coefficients_from_a_tensor_are_the_host_floats_bits(options):
    opt = AdamW(**options)
    rng = np.random.default_rng(0)
    shapes = {"a": (4, 6), "b": (6,)}
    params = {k: torch.tensor(rng.normal(size=s), dtype=torch.float32) for k, s in shapes.items()}
    by_host, by_tensor = trainable_copy(params), trainable_copy(params)
    host_state, tensor_state = opt.init(by_host), opt.init(by_tensor)
    table = torch.from_numpy(opt.coefficient_table(6))
    assert table.shape == (6, 3) and table[0].tolist() == list(opt.coefficients(1))
    for k in range(6):
        grads = {n: torch.tensor(rng.normal(size=s), dtype=torch.float32)
                 for n, s in shapes.items()}
        upd_h, host_state = opt.update(grads, host_state, by_host)
        upd_t, tensor_state = opt.update(grads, tensor_state, by_tensor, table[k])
        apply_updates(by_host, upd_h)
        apply_updates(by_tensor, upd_t)
        assert host_state.step == tensor_state.step == k + 1
        for a, b in zip(tree_leaves((by_host, host_state.mu, host_state.nu)),
                        tree_leaves((by_tensor, tensor_state.mu, tensor_state.nu))):
            assert torch.equal(a, b)


def parent_train_client(trainer, params, client, rng, generator):
    """The local round before the coefficients moved to the device."""
    params = trainable_copy(params)
    state = trainer.optimizer.init(params)
    last = []
    for _ in range(trainer.local_epochs):
        losses = []
        for batch in client.train.padded_batches(trainer.batch_size, rng):
            params, state, loss = train_step(trainer.loss_fn, trainer.optimizer, params, state,
                                             to_device(batch, trainer.device), generator)
            losses.append(loss)
        last = losses
    return params, float(torch.stack(last).double().mean())


def test_local_and_central_steps_keep_the_parents_bits():
    cfg, params = model()
    trainer = LocalTrainer(gru.make_loss_fn(cfg), AdamW(), batch_size=8, local_epochs=2,
                           device="cpu")
    client = make_clients()[2]
    got, loss, _ = trainer.train_client(params, client, np.random.default_rng(1),
                                        torch.Generator().manual_seed(2))
    ref, ref_loss = parent_train_client(trainer, params, client, np.random.default_rng(1),
                                        torch.Generator().manual_seed(2))
    assert loss == ref_loss
    assert all(torch.equal(a, b.detach()) for a, b in zip(tree_leaves(got), tree_leaves(ref)))
    # the central trainer is the same loop over one dataset with one generator
    central = train_central(CentralConfig(epochs=2, batch_size=8, seed=0), client.train, params,
                            gru.make_loss_fn(cfg), AdamW(), device="cpu")
    one = LocalTrainer(gru.make_loss_fn(cfg), AdamW(), batch_size=8, local_epochs=2,
                       device="cpu")
    ref, _ = parent_train_client(one, params, client, np.random.default_rng(0),
                                 torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b.detach()) for a, b in zip(tree_leaves(central.params),
                                                          tree_leaves(ref)))
    assert tree_map(lambda p: p.requires_grad, central.params) == tree_map(lambda p: False,
                                                                           params)
