"""The port's vectorized cohort engine on the CPU, against the JAX package's
and against the port's own sequential engine.

* ``build_cohort_schedule`` / ``pad_cohort_schedule`` give arrays bit-equal
  to the JAX package's on the same seed, and leave the numpy generator in
  the same state; the trainer's step-major staging holds the same bytes.
* The port's ``Federation`` (vectorized, the default; rebuild staging)
  against JAX's ``Federation(engine="vectorized", staging="rebuild")`` from
  the same params, dropout 0: each round's loss within 1e-5, params within 1e-4 (the
  near-zero-gradient drift of ``tests/test_torch_federation.py``).
* The port's two engines against each other with dropout 0.05 (both draw
  each client's masks from the same per-client generator): 16 uneven
  clients, several rounds with participation, recruitment, 189 clients;
  all within 1e-5.  Chunked against unchunked within 1e-6, donation on
  against off bit for bit.
* The stacked AdamW step is the one-client step, bit for bit, for each
  client at its own step count; the model over a client axis is the
  one-client model for each client.
* The errors and the default engine.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro.data.pipeline import build_client_datasets as jax_clients  # noqa: E402
from repro.data.synth_eicu import CohortConfig as JaxCohortConfig  # noqa: E402
from repro.data.synth_eicu import generate_cohort as jax_generate  # noqa: E402
from repro.federated.api import Federation as JaxFederation  # noqa: E402
from repro.federated.api import FederationConfig as JaxFederationConfig  # noqa: E402
from repro.models import gru as jax_gru  # noqa: E402
from repro.optim.adamw import AdamW as JaxAdamW  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.data.pipeline import ArrayDataset, ClientDataset, build_client_datasets  # noqa: E402
from repro_torch.data.synth_eicu import CohortConfig, generate_cohort  # noqa: E402
from repro_torch.experiments import paper  # noqa: E402
from repro_torch.federated import cohort as cohort_module  # noqa: E402
from repro_torch.federated.api import Federation, FederationConfig  # noqa: E402
from repro_torch.federated.cohort import CohortTrainer, client_generators  # noqa: E402
from repro_torch.models import gru  # noqa: E402
from repro_torch.obs import Tracer  # noqa: E402
from repro_torch.optim.adamw import AdamW, apply_updates  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-5
PARAMS_TOL = 1e-4
SEQ_LEN, FEAT = 6, 38
COHORT = dict(num_hospitals=8, total_stays=320, min_hospital_size=10)


def make_client(client_id: int, n: int, rng: np.random.Generator, t=SEQ_LEN, f=FEAT):
    x = rng.normal(size=(n, t, f)).astype(np.float32)
    y = rng.uniform(0.5, 20.0, size=n).astype(np.float32)
    ds = ArrayDataset(x, y)
    return ClientDataset(client_id=client_id, train=ds, val=ds)


def max_diff(a, b) -> float:
    return max(float((x - y).abs().max()) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def run_engines(clients, params0, cfg, **fed_kwargs):
    out = {}
    for engine in ("sequential", "vectorized"):
        fed = Federation(FederationConfig(engine=engine, **fed_kwargs), clients,
                         gru.make_loss_fn(cfg), AdamW(), device="cpu")
        out[engine] = fed.run(params0)
    return out["sequential"], out["vectorized"]


def assert_engines_agree(seq, vec, tol=TOL):
    assert seq.total_local_steps == vec.total_local_steps
    assert seq.federation_ids.tolist() == vec.federation_ids.tolist()
    for rs, rv in zip(seq.history, vec.history):
        assert rs.participant_ids == rv.participant_ids
        assert abs(rs.mean_local_loss - rv.mean_local_loss) <= tol
    assert max_diff(seq.params, vec.params) <= tol


@pytest.fixture(scope="module")
def model():
    cfg = gru.GRUConfig(input_dim=FEAT, hidden_dim=8, num_layers=2, dropout=0.05)
    return cfg, gru.init_gru(torch.Generator().manual_seed(1), cfg, "cpu")


# --------------------------------------------------------------------------
# schedules
# --------------------------------------------------------------------------


@pytest.mark.parametrize("epochs,spe", [(1, None), (2, None), (3, 5)])
def test_schedules_are_bit_equal_to_jax(epochs, spe):
    rng = np.random.default_rng(0)
    sizes = (5, 16, 33, 1)
    datasets = [ArrayDataset(rng.normal(size=(n, 3, 4)).astype(np.float32),
                             rng.uniform(1, 9, n).astype(np.float32)) for n in sizes]
    jax_datasets = [jax_pipeline.ArrayDataset(d.x, d.y) for d in datasets]
    assert pipeline.cohort_steps_per_epoch(sizes, 16) == jax_pipeline.cohort_steps_per_epoch(sizes, 16)
    rng_ref, rng_got = np.random.default_rng(9), np.random.default_rng(9)
    ref = jax_pipeline.build_cohort_schedule(jax_datasets, 16, epochs, rng_ref, steps_per_epoch=spe)
    got = pipeline.build_cohort_schedule(datasets, 16, epochs, rng_got, steps_per_epoch=spe)
    assert rng_got.bit_generator.state == rng_ref.bit_generator.state
    for field in ("x", "y", "mask", "step_valid", "weights"):
        a, b = getattr(ref, field), getattr(got, field)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    assert (got.steps_per_epoch, got.local_epochs, got.real_steps, got.total_steps) == (
        ref.steps_per_epoch, ref.local_epochs, ref.real_steps, ref.total_steps)
    for multiple in (1, 3, 4, 8):
        p_ref = jax_pipeline.pad_cohort_schedule(ref, multiple)
        p_got = pipeline.pad_cohort_schedule(got, multiple)
        assert p_got.num_clients == p_ref.num_clients
        for field in ("x", "y", "mask", "step_valid", "weights"):
            assert getattr(p_got, field).tobytes() == getattr(p_ref, field).tobytes()
    assert pipeline.pad_cohort_schedule(got, 1) is got


def test_staged_chunk_holds_the_schedule_step_major(model):
    """The trainer's one-buffer staging holds ``build_cohort_schedule``'s
    arrays step-major, the clients in slot order (by their batches an
    epoch, longest first), with each client's AdamW coefficients at its own
    step count, and consumes the generator the same way."""
    cfg, _ = model
    rng = np.random.default_rng(4)
    clients = [make_client(i, n, rng) for i, n in enumerate((3, 17, 40))]
    opt = AdamW()
    trainer = CohortTrainer(gru.make_loss_fn(cfg), opt, batch_size=8, local_epochs=2, device="cpu")
    rng_a, rng_b = np.random.default_rng(2), np.random.default_rng(2)
    chunk = trainer._stage_rebuild(clients, rng_a, spe=6)
    sched = pipeline.build_cohort_schedule([c.train for c in clients], 8, 2, rng_b, steps_per_epoch=6)
    assert rng_a.bit_generator.state == rng_b.bit_generator.state
    order = chunk.members   # slot s holds client order[s]
    assert order.tolist() == [2, 1, 0]   # 5, 3 and 1 batches an epoch
    assert np.array_equal(chunk.weights, sched.weights[order])
    assert np.array_equal(chunk.x.numpy().swapaxes(0, 1), sched.x[order])
    assert np.array_equal(chunk.y.numpy().swapaxes(0, 1), sched.y[order])
    assert np.array_equal(chunk.mask.numpy().swapaxes(0, 1), sched.mask[order])
    assert np.array_equal(chunk.valid.numpy().T, sched.step_valid[order])
    assert np.array_equal(chunk.valid_host.T, sched.step_valid[order])
    coef = chunk.coefficients.numpy()
    for s, c in enumerate(order):
        k = 0
        for t in range(12):
            if sched.step_valid[c, t]:
                k += 1
                assert tuple(coef[t, :, s]) == tuple(np.float32(v) for v in opt.coefficients(k))
            else:
                assert tuple(coef[t, :, s]) == (1.0, 1.0, 0.0)


def test_a_step_runs_as_wide_as_its_clients_still_training():
    """The ladder of widths, a step's width from its slots' validity, and
    the widths of the paper's whole federation: the 189 hospitals of the
    synthetic cohort at seed 0 (the benchmark's frozen structure), batch
    128, run 748 client-slots an epoch at seven widths where the full step
    ran 66 × 189."""
    assert cohort_module._ladder(1) == [1] and cohort_module._ladder(2) == [2]
    assert cohort_module._ladder(3) == [2, 3]
    assert cohort_module._ladder(8) == [2, 4, 8]
    assert cohort_module._ladder(189) == [2, 4, 8, 16, 32, 64, 128, 189]
    assert cohort_module.step_width(np.array([True])) == 1
    assert cohort_module.step_width(np.array([True, False, False, False, False])) == 2
    assert cohort_module.step_width(np.array([True, True, True, False, False])) == 4
    assert cohort_module.step_width(np.array([True, False, False, False, True])) == 5
    assert cohort_module.step_widths([3, 17, 40], 8) == [2, 3]
    assert cohort_module.step_widths([17, 20, 24], 8) == [3]
    assert cohort_module._slot_order([3, 17, 40, 9, 25, 1], 8).tolist() == [2, 4, 1, 3, 0, 5]
    structure = Path(__file__).parents[1] / "bench" / "configs" / "gru-eicu" / "cohort.json"
    sizes = [h["n_train"] for h in json.loads(structure.read_text())["hospitals"]]
    steps = np.asarray([-(-n // 128) for n in sizes])
    assert (len(sizes), int(steps.max()), int(steps.sum())) == (189, 66, 579)
    assert cohort_module.step_widths(sizes, 128) == [2, 4, 8, 16, 32, 64, 189]
    order = cohort_module._slot_order(sizes, 128)
    valid = steps[order][None, :] > np.arange(66)[:, None]   # (step, slot)
    assert sum(cohort_module.step_width(v) for v in valid) == 748


# --------------------------------------------------------------------------
# the building blocks over a client axis
# --------------------------------------------------------------------------


@pytest.mark.parametrize("clip_norm", [None, 0.5])
def test_stacked_adamw_is_the_one_client_step_bit_for_bit(clip_norm):
    rng = np.random.default_rng(3)
    shapes = {"a": (3, 6), "b": (6,), "c": (6, 1)}
    opt = AdamW(clip_norm=clip_norm)
    steps = np.array([0, 3, 7])  # each client's steps taken before this one
    params = [{k: torch.tensor(rng.normal(size=s).astype(np.float32)) for k, s in shapes.items()}
              for _ in steps]
    states, grads = [], []
    for i, k in enumerate(steps):
        state = opt.init(params[i])
        for _ in range(k):
            g = {n: torch.tensor(rng.normal(size=s).astype(np.float32)) for n, s in shapes.items()}
            upd, state = opt.update(g, state, params[i])
            apply_updates(params[i], upd)
        states.append(state)
        grads.append({n: torch.tensor(rng.normal(size=s).astype(np.float32))
                      for n, s in shapes.items()})
    stack = lambda trees: tree_map(lambda *ls: torch.stack(ls), *trees)  # noqa: E731
    coef = torch.tensor([opt.coefficients(int(k) + 1) for k in steps], dtype=torch.float32).T
    stacked_state = opt.init(stack(params))._replace(
        step=steps, mu=stack([s.mu for s in states]), nu=stack([s.nu for s in states]))
    upd_s, state_s = opt.update_stacked(stack(grads), stacked_state, stack(params), coef)
    assert state_s.step.tolist() == (steps + 1).tolist()
    for i in range(3):
        upd, state = opt.update(grads[i], states[i], params[i])
        for a, b in zip(tree_leaves(upd), tree_leaves(upd_s)):
            if clip_norm is None:
                assert torch.equal(a, b[i])
            else:  # the per-client norm sums in another order
                assert float((a - b[i]).abs().max()) <= 1e-7
        for a, b in zip(tree_leaves(state.mu), tree_leaves(state_s.mu)):
            assert torch.equal(a, b[i]) if clip_norm is None else torch.allclose(a, b[i])


def test_model_over_a_client_axis_is_the_one_client_model(model):
    cfg, params = model
    rng = np.random.default_rng(5)
    c, b = 3, 4
    stacked = tree_map(
        lambda p: torch.stack([p + 0.01 * i for i in range(c)]).contiguous(), params)
    x = torch.tensor(rng.normal(size=(c, b, SEQ_LEN, FEAT)).astype(np.float32))
    y = torch.tensor(rng.uniform(0.5, 20, size=(c, b)).astype(np.float32))
    mask = torch.tensor(np.array([[1, 1, 1, 0], [1, 0, 0, 0], [0, 0, 0, 0]], np.float32))
    loss_fn = gru.make_loss_fn(cfg)
    loss = loss_fn(stacked, (x, y, mask), [torch.Generator().manual_seed(11 + i) for i in range(c)])
    assert loss.shape == (c,)
    for i in range(c):
        one = tree_map(lambda p: p[i], stacked)
        y_hat = gru.gru_apply(one, cfg, x[i], train=True,
                              generator=torch.Generator().manual_seed(11 + i))
        assert abs(float(loss[i]) - float(gru.msle_loss(y[i], y_hat, mask[i]))) <= 1e-6
    assert float(loss[2]) == 0.0  # no valid example: 0 / max(0, 1)
    # A client without a generator draws nothing and changes no other client.
    gens = [torch.Generator().manual_seed(11), torch.Generator().manual_seed(12),
            torch.Generator().manual_seed(13)]
    state = gens[1].get_state()
    skipped = loss_fn(stacked, (x, y, mask), [gens[0], None, gens[2]])
    assert torch.equal(gens[1].get_state(), state)
    assert float(skipped[0]) == float(loss[0]) and float(skipped[2]) == float(loss[2])
    gens = [torch.Generator().manual_seed(11), None]
    with pytest.raises(ValueError, match="one generator per client"):
        gru.make_loss_fn(cfg)(stacked, (x, y, mask), gens[:2])


def test_client_generators_are_seeded_in_order():
    a = client_generators(np.random.default_rng([0, 2]), 4, torch.device("cpu"))
    b = client_generators(np.random.default_rng([0, 2]), 6, torch.device("cpu"))
    draws = [torch.rand(5, generator=g) for g in a]
    assert all(torch.equal(d, torch.rand(5, generator=g)) for d, g in zip(draws, b[:4]))
    assert not torch.equal(draws[0], draws[1])


# --------------------------------------------------------------------------
# against the JAX package's vectorized engine, dropout 0
# --------------------------------------------------------------------------


@pytest.mark.parametrize("setting", ["federated-ac", "federated-src"])
def test_vectorized_federation_matches_jax(setting):
    jcfg = jax_gru.GRUConfig(hidden_dim=8, num_layers=2, dropout=0.0)
    tcfg = gru.GRUConfig(hidden_dim=8, num_layers=2, dropout=0.0)
    init = jax.tree.map(np.asarray, jax_gru.init_gru(jax.random.key(0), jcfg))
    policies = paper.policies_for(setting, paper.ExperimentConfig())
    ref = JaxFederation(
        JaxFederationConfig(rounds=2, local_epochs=2, batch_size=8, seed=1, engine="vectorized",
                            staging="rebuild", **policies),
        jax_clients(jax_generate(JaxCohortConfig(**COHORT), seed=3)),
        jax_gru.make_loss_fn(jcfg), JaxAdamW(),
    ).run(init)
    fed = Federation(
        FederationConfig(rounds=2, local_epochs=2, batch_size=8, seed=1, staging="rebuild",
                         **policies),
        build_client_datasets(generate_cohort(CohortConfig(**COHORT), seed=3)),
        gru.make_loss_fn(tcfg), AdamW(), device="cpu",
    )
    assert fed.effective_engine == "vectorized"
    got = fed.run(gru.params_from_jax(init, "cpu"))
    assert got.federation_ids.tolist() == ref.federation_ids.tolist()
    assert got.total_local_steps == ref.total_local_steps
    for g, r in zip(got.history, ref.history):
        assert g.participant_ids == r.participant_ids
        assert g.local_steps == r.local_steps
        assert abs(g.mean_local_loss - r.mean_local_loss) <= TOL
    for a, b in zip(tree_leaves(got.params), jax.tree.leaves(ref.params)):
        assert float(np.max(np.abs(a.numpy() - np.asarray(b)))) <= PARAMS_TOL
    stats = fed.cohort_trainer.last_round_stats
    assert (stats["chunks"], stats["shards"], stats["donated"], stats["staging"]) == (
        1, 1, True, "rebuild")
    assert stats["bytes_staged"] > 0 and stats["peak_device_bytes"] is None


# --------------------------------------------------------------------------
# against the port's sequential engine, dropout 0.05
# --------------------------------------------------------------------------


def test_16_uneven_clients_match_the_sequential_engine(model):
    cfg, params0 = model
    rng = np.random.default_rng(0)
    sizes = [3, 5, 8, 13, 16, 21, 30, 33, 40, 47, 55, 64, 65, 90, 120, 130]
    clients = [make_client(i, n, rng) for i, n in enumerate(sizes)]
    seq, vec = run_engines(clients, params0, cfg, rounds=1, local_epochs=2, batch_size=32, seed=0)
    assert_engines_agree(seq, vec)


def test_multiround_participation_matches_the_sequential_engine(model):
    cfg, params0 = model
    rng = np.random.default_rng(1)
    clients = [make_client(i, int(n), rng) for i, n in enumerate(rng.integers(4, 70, 12))]
    seq, vec = run_engines(clients, params0, cfg, rounds=3, local_epochs=1, batch_size=16,
                           selection="uniform:0.5", seed=7)
    assert len({tuple(r.participant_ids) for r in vec.history}) > 1
    assert_engines_agree(seq, vec)


def test_recruitment_matches_the_sequential_engine():
    cfg = gru.GRUConfig(hidden_dim=8, dropout=0.05)  # the cohort's 38 features, 24 hours
    clients = build_client_datasets(generate_cohort(CohortConfig().scaled(0.02), seed=0))
    params0 = gru.init_gru(torch.Generator().manual_seed(0), cfg, "cpu")
    seq, vec = run_engines(clients, params0, cfg, rounds=1, local_epochs=1, batch_size=128,
                           recruitment="nu-greedy", seed=0)
    assert vec.recruitment is not None and 0 < len(vec.federation_ids) < len(clients)
    assert_engines_agree(seq, vec)


def test_chunked_matches_unchunked_and_donation_changes_no_bit(model):
    cfg, params0 = model
    rng = np.random.default_rng(2)
    clients = [make_client(i, int(n), rng) for i, n in enumerate(rng.integers(4, 50, 10))]
    runs = {}
    for key, chunk, donate in (("whole", None, True), ("chunked", 3, True),
                               ("plain", None, False), ("chunked-plain", 3, False)):
        fed = Federation(
            FederationConfig(rounds=2, local_epochs=2, batch_size=16, seed=0,
                             cohort_chunk=chunk, donate_buffers=donate),
            clients, gru.make_loss_fn(cfg), AdamW(), device="cpu")
        runs[key] = fed.run(params0)
        stats = fed.cohort_trainer.last_round_stats
        assert stats["chunks"] == (4 if chunk else 1) and stats["donated"] is donate
    assert max_diff(runs["whole"].params, runs["chunked"].params) <= 1e-6
    for a, b in (("whole", "plain"), ("chunked", "chunked-plain")):
        assert all(torch.equal(x, y) for x, y in zip(tree_leaves(runs[a].params),
                                                     tree_leaves(runs[b].params)))
        assert [r.mean_local_loss for r in runs[a].history] == [
            r.mean_local_loss for r in runs[b].history]


def test_189_clients_match_the_sequential_engine():
    """The paper's client count: every one of 189 small clients in one
    batched step, against 189 one-client rounds."""
    rng = np.random.default_rng(0)
    clients = [make_client(i, int(n), rng, t=4, f=6) for i, n in enumerate(rng.integers(2, 9, 189))]
    cfg = gru.GRUConfig(input_dim=6, hidden_dim=4, num_layers=2, dropout=0.05)
    params0 = gru.init_gru(torch.Generator().manual_seed(1), cfg, "cpu")
    seq, vec = run_engines(clients, params0, cfg, rounds=2, local_epochs=1, batch_size=8, seed=0)
    assert len(vec.history[0].participant_ids) == 189
    assert_engines_agree(seq, vec)


def test_run_paper_scale_runs_both_engines_on_the_cpu():
    out = paper.run_paper_scale(rounds=2, local_epochs=1, batch_size=8, total_stays=189 * 10,
                                settings=("central", "federated-arc"), verbose=False,
                                device="cpu")
    assert out["num_clients"] == 189 and out["device"] == "cpu"
    row = out["settings"]["federated-arc"]
    assert set(row) == {"vectorized", "sequential", "speedup"}
    v, s = row["vectorized"], row["sequential"]
    assert v["local_steps"] == s["local_steps"] > 0
    assert abs(v["metrics"]["msle"] - s["metrics"]["msle"]) <= 1e-4
    assert v["cohort_stats"]["cohort_steps"] > 0 and s["cohort_stats"] is None
    assert out["settings"]["central"]["n/a"]["time_unit"] == "epoch"
    memory = out["memory"]
    assert memory["donated"]["chunks"] == memory["plain"]["chunks"] == 2
    assert memory["donated"]["peak_device_bytes"] is None and memory["donated_peak_lower"] is None
    cfg = paper.paper_scale_cohort_config()
    assert (cfg.num_hospitals, cfg.split_mode) == (189, "stratified")
    assert paper._mean_round_time({"round_times_s": [5.0, 1.0, 3.0], "tau_s": 9.0}) == 2.0
    assert paper._mean_round_time({"round_times_s": None, "tau_s": 9.0}) == 9.0


def test_run_setting_reports_the_cohort_steps():
    cohort = generate_cohort(CohortConfig(**COHORT), seed=3)
    exp = paper.ExperimentConfig(rounds=2, local_epochs=2, batch_size=8, device="cpu")
    out = paper.run_setting("federated-ac", exp, cohort, seed=0)
    clients = build_client_datasets(cohort)
    # Every client participates: a round's batched steps are the largest
    # client's steps.
    longest = max(pipeline.local_round_steps(c.n_train, 8, 2) for c in clients)
    assert out["engine"] == "vectorized" and out["cohort_steps"] == 2 * longest
    assert out["local_steps"] == 2 * sum(pipeline.local_round_steps(c.n_train, 8, 2) for c in clients)
    seq = paper.run_setting("federated-ac", dataclasses.replace(exp, engine="sequential"),
                            cohort, seed=0)
    assert seq["engine"] == "sequential" and seq["cohort_steps"] is None


@pytest.mark.parametrize("chunk", [None, 3])
def test_a_traced_round_has_a_cohort_step_span_a_step(model, monkeypatch, chunk):
    """The captured path (forced on the CPU, where the stand-in graph reruns
    the body): one ``cohort_step`` span per executed batched step, its
    ``width`` the slots it runs and its ``held`` the clients padding inside
    that width; a ``readback`` a chunk and one ``generators`` span a round,
    inside its ``train`` span."""
    monkeypatch.setattr(cohort_module, "capture_enabled", lambda device: True)
    cfg, params0 = model
    rng = np.random.default_rng(4)
    sizes = (3, 17, 40, 9, 25, 1)
    clients = [make_client(i, n, rng) for i, n in enumerate(sizes)]
    tracer = Tracer()
    fed = Federation(FederationConfig(rounds=2, local_epochs=2, batch_size=8, seed=3,
                                      recruitment="all", cohort_chunk=chunk),
                     clients, gru.make_loss_fn(cfg), AdamW(), device="cpu", tracer=tracer)
    stats = []
    fed.run(params0, progress=lambda r: stats.append(dict(fed.cohort_trainer.last_round_stats)))
    steps = tracer.spans("cohort_step")
    assert len(steps) == sum(s["cohort_steps"] for s in stats) > 0
    assert all(s["replays"] == s["cohort_steps"] for s in stats[1:])
    assert {s.clock for s in steps} == {"host"}
    # Each client's batches lead its epoch of 5 steps (the largest client's):
    # step k of an epoch runs where some client of the chunk has a k-th batch,
    # as wide as the smallest of 2, 4, ... and the chunk's size that holds
    # the clients with a k-th batch (the longest first in the slots).
    size = chunk or len(sizes)
    chunks = [[-(-n // 8) for n in sizes[i:i + size]] for i in range(0, len(sizes), size)]

    def width(active, c):
        return min(c, max(2, 1 << (active - 1).bit_length()))

    want = [(e * 5 + k, width(a, len(per)), width(a, len(per)) - a)
            for _ in range(2) for per in chunks for e in range(2) for k in range(max(per))
            for a in [sum(m > k for m in per)]]
    assert [(s.args["t"], s.args["width"], s.args["held"]) for s in steps] == want
    assert sum(s["cohort_slot_steps"] for s in stats) == sum(w for _, w, _ in want)
    assert len(tracer.spans("readback")) == 2 * len(chunks)
    generators, trains = tracer.spans("generators"), tracer.spans("train")
    assert len(generators) == len(trains) == 2
    for g, t in zip(generators, trains):
        assert t.ts <= g.ts and g.ts + g.dur <= t.ts + t.dur


# --------------------------------------------------------------------------
# errors and defaults
# --------------------------------------------------------------------------


def test_errors(model):
    cfg, params0 = model
    rng = np.random.default_rng(6)
    clients = [make_client(0, 8, rng)]
    gens = client_generators(rng, 1, torch.device("cpu"))

    def trainer(**kw):
        return CohortTrainer(gru.make_loss_fn(cfg), AdamW(), 16, 1, device="cpu", **kw)

    with pytest.raises(ValueError, match="unknown engine"):
        FederationConfig(engine="warp-drive")
    with pytest.raises(ValueError, match="one generator per client"):
        trainer().train_cohort(params0, clients, rng, [])
    with pytest.raises(ValueError, match="cohort_chunk"):
        trainer(cohort_chunk=0).train_cohort(params0, clients, rng, gens)
    with pytest.raises(ValueError, match="unknown staging"):
        trainer(staging="lazy")
    # the client axis over several processes is ported: "auto" in one
    # process is no mesh, and its round is the round without one, bit for bit
    auto, plain = trainer(mesh="auto"), trainer()
    assert auto.mesh is None
    got, ref = (t.train_cohort(params0, clients, np.random.default_rng(6),
                               client_generators(np.random.default_rng(7), 1, torch.device("cpu")))
                for t in (auto, plain))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got[0]), tree_leaves(ref[0])))
    assert got[1].tobytes() == ref[1].tobytes() and auto.last_round_stats["shards"] == 1
    # the tracer is ported: a traced trainer stages under a "stage" span, and
    # reads the chunk's losses back under the port's "readback" span
    tracer = Tracer()
    traced = trainer(tracer=tracer)
    assert traced.tracer is tracer
    traced.train_cohort(params0, clients, np.random.default_rng(6), gens)
    assert [(s.name, s.track, s.args) for s in tracer.spans()] == [
        ("stage", "staging", {"chunk": 0}), ("readback", "server", None)]
    # DP-SGD is ported: the trainer takes a job-spec dict
    assert trainer(dp={"clip_norm": 1.0}).dp.clip_norm == 1.0


def test_the_default_engine_is_vectorized():
    assert FederationConfig().engine == "vectorized"
    assert paper.ExperimentConfig().engine == "vectorized"
    assert dataclasses.replace(FederationConfig(), engine="sequential").engine == "sequential"
