"""The port's resident staging on the CPU, against the JAX package's and
against the port's own rebuild staging.

* ``build_cohort_plan`` / ``pad_cohort_plan`` give arrays bit-equal to the
  JAX package's and leave the numpy generator in the same state;
  ``build_device_cohort`` holds the same ``x`` and ``y``; the LRU pool makes
  the same uploads, hits, evictions and errors for the same sequence.
* A resident chunk's gathered batches are the rebuilt chunk's, bit for bit.
* The port's resident ``Federation`` against JAX's resident ``Federation``
  from the same params at dropout 0: round losses within 1e-5, params within
  1e-4 (the near-zero-gradient drift of ``tests/test_torch_federation.py``).
* At dropout 0.05: resident against rebuild, prefetch on against off,
  pooled against fully resident and the slice path against the gather
  path, all bit for bit.
* ``StagingPipeline``: order, errors, close, run-ahead depth.
* ``run_staging_comparison`` at a small size.
"""

import logging
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.data import device_cohort as jax_dc  # noqa: E402
from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro.data.pipeline import build_client_datasets as jax_clients  # noqa: E402
from repro.data.synth_eicu import CohortConfig as JaxCohortConfig  # noqa: E402
from repro.data.synth_eicu import generate_cohort as jax_generate  # noqa: E402
from repro.federated.api import Federation as JaxFederation  # noqa: E402
from repro.federated.api import FederationConfig as JaxFederationConfig  # noqa: E402
from repro.models import gru as jax_gru  # noqa: E402
from repro.optim.adamw import AdamW as JaxAdamW  # noqa: E402
from repro_torch.data import device_cohort as dc_mod  # noqa: E402
from repro_torch.data.pipeline import ArrayDataset, ClientDataset, build_client_datasets  # noqa: E402
from repro_torch.data.synth_eicu import CohortConfig, generate_cohort  # noqa: E402
from repro_torch.experiments import paper  # noqa: E402
from repro_torch.federated.api import Federation, FederationConfig  # noqa: E402
from repro_torch.federated.cohort import CohortTrainer, client_generators  # noqa: E402
from repro_torch.federated.staging import StagingPipeline  # noqa: E402
from repro_torch.models import gru  # noqa: E402
from repro_torch.obs import Tracer  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-5
PARAMS_TOL = 1e-4
SEQ_LEN, FEAT = 4, 6
COHORT = dict(num_hospitals=8, total_stays=320, min_hospital_size=10)


def make_clients(count: int, rng: np.random.Generator, lo: int = 2, hi: int = 9):
    """Matching client lists for both packages (the same arrays)."""
    ours, theirs = [], []
    for i, n in enumerate(rng.integers(lo, hi, count)):
        x = rng.normal(size=(int(n), SEQ_LEN, FEAT)).astype(np.float32)
        y = rng.uniform(0.5, 20.0, size=int(n)).astype(np.float32)
        ours.append(ClientDataset(i, ArrayDataset(x, y), ArrayDataset(x, y)))
        ds = jax_pipeline.ArrayDataset(x, y)
        theirs.append(jax_pipeline.ClientDataset(client_id=i, train=ds, val=ds))
    return ours, theirs


def row_bytes_of(clients) -> int:
    max_n = max(c.n_train for c in clients)
    return (max_n + 1) * SEQ_LEN * FEAT * 4 + (max_n + 1) * 4


def same_bits(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


@pytest.fixture(scope="module")
def model():
    cfg = gru.GRUConfig(input_dim=FEAT, hidden_dim=4, num_layers=2, dropout=0.05)
    return cfg, gru.init_gru(torch.Generator().manual_seed(1), cfg, "cpu")


# --------------------------------------------------------------------------
# plans and the device cohort against the JAX package
# --------------------------------------------------------------------------


@pytest.mark.parametrize("sizes,batch,epochs,spe,rows,pad", [
    ((5, 9, 12), 4, 2, None, None, None),
    ((1, 33, 16, 8), 16, 3, 5, [7, 2, 0, 4], 40),
    ((64,), 8, 1, 9, None, 64),
])
def test_plans_are_bit_equal_to_jax(sizes, batch, epochs, spe, rows, pad):
    rng_ref, rng_got = np.random.default_rng(5), np.random.default_rng(5)
    kw = dict(steps_per_epoch=spe, client_rows=rows, pad_index=pad)
    ref = jax_dc.build_cohort_plan(sizes, batch, epochs, rng_ref, **kw)
    got = dc_mod.build_cohort_plan(sizes, batch, epochs, rng_got, **kw)
    assert rng_got.bit_generator.state == rng_ref.bit_generator.state
    for field in ("sample_idx", "step_valid", "client_rows", "weights"):
        a, b = getattr(ref, field), getattr(got, field)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    assert (got.pad_index, got.steps_per_epoch, got.local_epochs, got.nbytes) == (
        ref.pad_index, ref.steps_per_epoch, ref.local_epochs, ref.nbytes)
    for multiple, num_rows in ((1, None), (3, None), (4, 8), (4, None), (8, 9)):
        p_ref = jax_dc.pad_cohort_plan(ref, multiple, num_rows=num_rows)
        p_got = dc_mod.pad_cohort_plan(got, multiple, num_rows=num_rows)
        for field in ("sample_idx", "step_valid", "client_rows", "weights"):
            assert getattr(p_got, field).tobytes() == getattr(p_ref, field).tobytes()
    assert dc_mod.pad_cohort_plan(got, 1) is got


def test_plans_consume_the_generator_as_the_schedule_does():
    sizes = [int(n) for n in np.random.default_rng(11).integers(2, 40, 10)]
    datasets = [jax_pipeline.ArrayDataset(np.zeros((n, 2, 2), np.float32),
                                          np.zeros(n, np.float32)) for n in sizes]
    r_sched, r_plan = np.random.default_rng(5), np.random.default_rng(5)
    jax_pipeline.build_cohort_schedule(datasets, 8, 3, r_sched)
    dc_mod.build_cohort_plan(sizes, 8, 3, r_plan)
    assert r_sched.bit_generator.state == r_plan.bit_generator.state
    with pytest.raises(ValueError, match="pad_index"):
        dc_mod.build_cohort_plan([5, 9], 4, 1, np.random.default_rng(0), pad_index=7)
    with pytest.raises(ValueError, match="steps_per_epoch"):
        dc_mod.build_cohort_plan([9], 4, 1, np.random.default_rng(0), steps_per_epoch=2)


def test_device_cohort_holds_jax_arrays():
    ours, theirs = make_clients(5, np.random.default_rng(1), lo=3, hi=11)
    got = dc_mod.build_device_cohort(ours, device="cpu")
    ref = jax_dc.build_device_cohort(theirs)
    assert got.x.dtype == torch.float32 and got.x.shape == ref.x.shape
    assert got.x.numpy().tobytes() == np.asarray(ref.x).tobytes()
    assert got.y.numpy().tobytes() == np.asarray(ref.y).tobytes()
    assert (got.rows, got.nbytes, got.pad_index, got.num_rows) == (
        ref.rows, ref.nbytes, ref.pad_index, ref.num_rows)
    assert all(got.owns(c) for c in ours) and got.attach_seconds > 0
    stranger = make_clients(1, np.random.default_rng(2))[0][0]
    assert not got.owns(stranger)
    with pytest.raises(KeyError, match="not part of this device cohort"):
        got.row_of(ClientDataset(99, stranger.train, stranger.val))
    assert got.ensure_resident(ours) == 0  # fully resident: a no-op
    with pytest.raises(ValueError, match="empty cohort"):
        dc_mod.build_device_cohort([], device="cpu")
    # the rows over several processes are ported: "auto" in one process
    # is no mesh, the same cohort bit for bit
    auto = dc_mod.build_device_cohort(ours, device="cpu", mesh="auto")
    assert auto.x.numpy().tobytes() == got.x.numpy().tobytes()
    assert auto.y.numpy().tobytes() == got.y.numpy().tobytes()
    assert (auto.rows, auto.nbytes, auto.owners) == (got.rows, got.nbytes, {})
    # the tracer is ported: a pooled cohort's uploads are "pool_upload" spans
    tracer = Tracer()
    pooled = dc_mod.build_device_cohort(ours, device="cpu", tracer=tracer,
                                        resident_budget_bytes=2 * row_bytes_of(ours))
    assert pooled.is_pooled and pooled.tracer is tracer
    assert pooled.ensure_resident(ours[:2]) == 2 and pooled.ensure_resident(ours[:2]) == 0
    assert [(s.name, s.track, s.args) for s in tracer.spans()] == [
        ("pool_upload", "pool", {"missing": 2})]
    assert dc_mod.build_device_cohort(ours, device="cpu", tracer=tracer).tracer is tracer


def test_the_pool_uploads_hits_and_evicts_as_jax():
    ours, theirs = make_clients(8, np.random.default_rng(2), lo=3, hi=9)
    budget = 4 * row_bytes_of(ours)
    got = dc_mod.build_device_cohort(ours, resident_budget_bytes=budget, device="cpu")
    ref = jax_dc.build_device_cohort(theirs, resident_budget_bytes=budget)
    assert got.is_pooled and (got.pool_rows, got.nbytes) == (ref.pool_rows, ref.nbytes)
    for picks in ([0, 1, 2, 3], [0, 1], [4], [2], [5, 6, 7], [7, 0], [3, 4, 5, 6]):
        n_got = got.ensure_resident([ours[i] for i in picks])
        n_ref = ref.ensure_resident([theirs[i] for i in picks])
        assert n_got == n_ref
        assert (got.uploads, got.hits, got.evictions, got.bytes_uploaded) == (
            ref.uploads, ref.hits, ref.evictions, ref.bytes_uploaded)
        assert got.rows == ref.rows and list(got._lru) == list(ref._lru)
        assert got.x.numpy().tobytes() == np.asarray(ref.x).tobytes()
        assert got.y.numpy().tobytes() == np.asarray(ref.y).tobytes()
    with pytest.raises(ValueError, match="exceeds the resident pool"):
        got.ensure_resident(ours[:5])
    with pytest.raises(KeyError, match="not resident in the pool"):
        got.row_of(ours[1])
    with pytest.raises(ValueError, match="cannot hold even one client row"):
        dc_mod.build_device_cohort(ours, resident_budget_bytes=row_bytes_of(ours) - 1,
                                   device="cpu")
    small = dc_mod.build_device_cohort(ours[:3], resident_budget_bytes=2 * row_bytes_of(ours),
                                       device="cpu")
    with pytest.raises(KeyError, match="not part of the federation"):
        small.ensure_resident([ours[3]])


# --------------------------------------------------------------------------
# a resident chunk gathers the rebuilt chunk's batches
# --------------------------------------------------------------------------


@pytest.mark.parametrize("fast", [True, False])
def test_gathered_batches_are_the_rebuilt_chunk(model, fast):
    cfg, _ = model
    ours, _ = make_clients(7, np.random.default_rng(3), lo=2, hi=30)
    trainer = CohortTrainer(gru.make_loss_fn(cfg), AdamW(), batch_size=8, local_epochs=2,
                            staging="resident", slice_fastpath=fast, device="cpu")
    dc = trainer.attach_device_cohort(ours)
    part = ours[2:6]  # rows 2..5: a contiguous run, sliced on the fast path
    rng_a, rng_b = np.random.default_rng(4), np.random.default_rng(4)
    rebuilt = trainer._stage_rebuild(part, rng_a, spe=5)
    planned = trainer._stage_plan(part, rng_b, 5, dc, slot=0, side=None)
    assert rng_a.bit_generator.state == rng_b.bit_generator.state
    assert planned.sliced is fast and planned.ready is None
    assert np.array_equal(planned.valid_host, rebuilt.valid_host)
    assert torch.equal(planned.valid, rebuilt.valid)
    assert torch.equal(planned.coefficients, rebuilt.coefficients)
    assert np.array_equal(planned.weights, rebuilt.weights)
    assert planned.nbytes < rebuilt.nbytes
    for t in range(rebuilt.valid_host.shape[0]):
        for got, want in zip(planned.batch(t), rebuilt.batch(t)):
            assert got.dtype == want.dtype and got.shape == want.shape
            assert got.is_contiguous() and torch.equal(got, want)
    # A strided subset of rows takes the gather path and the same batches.
    strided = ours[::2]
    rebuilt = trainer._stage_rebuild(strided, np.random.default_rng(6), spe=5)
    planned = trainer._stage_plan(strided, np.random.default_rng(6), 5, dc, slot=1, side=None)
    assert not planned.sliced
    assert all(torch.equal(g, w) for t in range(10)
               for g, w in zip(planned.batch(t), rebuilt.batch(t)))


# --------------------------------------------------------------------------
# against the JAX package's resident Federation, dropout 0
# --------------------------------------------------------------------------


@pytest.mark.parametrize("setting,chunk", [("federated-ac", None), ("federated-src", 3)])
def test_resident_federation_matches_jax(setting, chunk):
    jcfg = jax_gru.GRUConfig(hidden_dim=8, num_layers=2, dropout=0.0)
    tcfg = gru.GRUConfig(hidden_dim=8, num_layers=2, dropout=0.0)
    init = jax.tree.map(np.asarray, jax_gru.init_gru(jax.random.key(0), jcfg))
    policies = paper.policies_for(setting, paper.ExperimentConfig())
    base = dict(rounds=2, local_epochs=2, batch_size=8, seed=1, cohort_chunk=chunk, **policies)
    ref = JaxFederation(
        JaxFederationConfig(engine="vectorized", staging="resident", **base),
        jax_clients(jax_generate(JaxCohortConfig(**COHORT), seed=3)),
        jax_gru.make_loss_fn(jcfg), JaxAdamW(),
    ).run(init)
    fed = Federation(
        FederationConfig(**base),
        build_client_datasets(generate_cohort(CohortConfig(**COHORT), seed=3)),
        gru.make_loss_fn(tcfg), AdamW(), device="cpu",
    )
    assert fed.config.staging == "resident" and fed.effective_engine == "vectorized"
    got = fed.run(gru.params_from_jax(init, "cpu"))
    assert got.federation_ids.tolist() == ref.federation_ids.tolist()
    assert got.total_local_steps == ref.total_local_steps
    for g, r in zip(got.history, ref.history):
        assert g.participant_ids == r.participant_ids
        assert abs(g.mean_local_loss - r.mean_local_loss) <= TOL
    for a, b in zip(tree_leaves(got.params), jax.tree.leaves(ref.params)):
        assert float(np.max(np.abs(a.numpy() - np.asarray(b)))) <= PARAMS_TOL
    stats = fed.cohort_trainer.last_round_stats
    dc = fed.cohort_trainer.device_cohort
    # Attached once, for the recruited federation only.
    assert dc is not None and dc.num_rows == got.federation_ids.size
    assert stats["staging"] == "resident" and stats["bytes_resident"] == dc.nbytes
    assert stats["peak_device_bytes"] is None and stats["pool"] is False


# --------------------------------------------------------------------------
# resident, rebuild, prefetch and the pool: the same bits, dropout 0.05
# --------------------------------------------------------------------------


def run(clients, params0, cfg, **kw):
    base = dict(rounds=2, local_epochs=2, batch_size=4, seed=0)
    base.update(kw)
    fed = Federation(FederationConfig(**base), clients, gru.make_loss_fn(cfg), AdamW(),
                     device="cpu")
    return fed.run(params0), fed.cohort_trainer


def test_resident_is_rebuild_bit_for_bit(model):
    cfg, params0 = model
    clients, _ = make_clients(12, np.random.default_rng(0), lo=2, hi=30)
    for kw in (dict(), dict(cohort_chunk=5), dict(selection="uniform:0.5", rounds=3)):
        reb, t_reb = run(clients, params0, cfg, staging="rebuild", **kw)
        res, t_res = run(clients, params0, cfg, staging="resident", **kw)
        assert same_bits(reb.params, res.params)
        assert [r.mean_local_loss for r in reb.history] == [r.mean_local_loss for r in res.history]
        assert [r.participant_ids for r in reb.history] == [r.participant_ids for r in res.history]
        s_reb, s_res = t_reb.last_round_stats, t_res.last_round_stats
        assert s_res["cohort_steps"] == s_reb["cohort_steps"] and s_res["chunks"] == s_reb["chunks"]
        assert s_reb["bytes_resident"] == 0 and s_res["bytes_resident"] > 0
        assert s_res["bytes_staged"] * 10 < s_reb["bytes_staged"]


def test_prefetch_changes_no_bit(model):
    cfg, params0 = model
    clients, _ = make_clients(12, np.random.default_rng(5), lo=2, hi=20)
    out, stats = {}, {}
    for prefetch in (True, False):
        out[prefetch], trainer = run(clients, params0, cfg, cohort_chunk=4, prefetch=prefetch)
        stats[prefetch] = trainer.last_round_stats
    assert same_bits(out[True].params, out[False].params)
    assert [r.mean_local_loss for r in out[True].history] == [
        r.mean_local_loss for r in out[False].history]
    assert stats[True]["prefetch"] and stats[True]["chunks"] == 3
    assert 0 <= stats[True]["plans_prefetched"] <= 3
    assert not stats[False]["prefetch"] and stats[False]["plans_prefetched"] == 0
    # One chunk never starts the pipeline.
    _, trainer = run(clients, params0, cfg, rounds=1)
    assert not trainer.last_round_stats["prefetch"]


def test_pooled_rounds_are_fully_resident_bit_for_bit(model):
    cfg, params0 = model
    clients, _ = make_clients(20, np.random.default_rng(6))
    kw = dict(rounds=4, selection="uniform:6", cohort_chunk=4)
    full, _ = run(clients, params0, cfg, **kw)
    pooled, trainer = run(clients, params0, cfg,
                          resident_budget_bytes=8 * row_bytes_of(clients), **kw)
    assert same_bits(full.params, pooled.params)
    dc = trainer.device_cohort
    assert dc.is_pooled and dc.pool_rows == 8 and dc.evictions > 0
    stats = trainer.last_round_stats
    assert stats["pool"] and stats["pool_rows"] == 8
    assert stats["pool_uploads"] + stats["pool_hits"] == 6
    assert stats["pool_bytes_uploaded"] == stats["pool_uploads"] * row_bytes_of(clients)


def test_the_slice_path_is_the_gather_path_bit_for_bit(model):
    cfg, params0 = model
    clients, _ = make_clients(12, np.random.default_rng(8))
    results = {}
    for fast in (True, False):
        trainer = CohortTrainer(gru.make_loss_fn(cfg), AdamW(), batch_size=4, local_epochs=1,
                                cohort_chunk=4, staging="resident", slice_fastpath=fast,
                                device="cpu")
        gens = client_generators(np.random.default_rng([0, 2]), len(clients), torch.device("cpu"))
        results[fast], _, _ = trainer.train_cohort(params0, clients, np.random.default_rng(1),
                                                   gens)
        assert trainer.last_round_stats["slice_chunks"] == (3 if fast else 0)
        # A strided subset has no contiguous run: the gather path.
        subset = clients[::2]
        gens = client_generators(np.random.default_rng([1, 2]), len(subset), torch.device("cpu"))
        trainer.train_cohort(params0, subset, np.random.default_rng(2), gens)
        assert trainer.last_round_stats["slice_chunks"] == 0
        assert trainer.device_cohort.num_rows == 12  # the subset reused the attached rows
    assert same_bits(results[True], results[False])


def test_a_staging_error_ends_the_round_and_the_trainer_recovers(model):
    cfg, params0 = model
    clients, _ = make_clients(12, np.random.default_rng(12))
    trainer = CohortTrainer(gru.make_loss_fn(cfg), AdamW(), batch_size=4, local_epochs=1,
                            cohort_chunk=4, staging="resident", device="cpu")
    gens = lambda: client_generators(np.random.default_rng(0), 12, torch.device("cpu"))  # noqa: E731
    trainer.train_cohort(params0, clients, np.random.default_rng(1), gens())
    real = trainer._copy_plan
    armed = {"left": 1}

    def failing(host, slot, side):
        if armed["left"]:
            armed["left"] -= 1
            raise RuntimeError("device lost")
        return real(host, slot, side)

    trainer._copy_plan = failing
    with pytest.raises(RuntimeError, match="device lost"):
        trainer.train_cohort(params0, clients, np.random.default_rng(3), gens())
    trainer._copy_plan = real
    trainer.train_cohort(params0, clients, np.random.default_rng(1), gens())
    assert trainer.last_round_stats["chunks"] == 3


def test_staging_defaults_and_errors(model):
    cfg, _ = model
    assert FederationConfig().staging == paper.ExperimentConfig().staging == "resident"
    assert FederationConfig().prefetch and paper.ExperimentConfig().prefetch
    trainer = CohortTrainer(gru.make_loss_fn(cfg), AdamW(), 4, 1, device="cpu")
    assert trainer.staging == "rebuild" and trainer.prefetch and trainer.slice_fastpath
    with pytest.raises(ValueError, match="staging"):
        FederationConfig(staging="teleport")
    with pytest.raises(ValueError, match="staging"):
        CohortTrainer(gru.make_loss_fn(cfg), AdamW(), 4, 1, staging="teleport", device="cpu")


# --------------------------------------------------------------------------
# StagingPipeline
# --------------------------------------------------------------------------


def wait_for(cond, timeout: float = 5.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "the staging thread made no progress"
        time.sleep(0.005)


def test_staging_pipeline_orders_and_runs_ahead():
    produced, times = [], {}

    def stage(k):
        produced.append(k)
        times[k] = time.perf_counter()
        return k * k

    assert list(StagingPipeline(stage, range(6))) == [k * k for k in range(6)]
    assert produced == list(range(6))  # strict order: the generator contract
    times.clear()
    pipe = StagingPipeline(stage, range(3))
    it = iter(pipe)
    assert next(it) == 0
    wait_for(lambda: 1 in times)  # "train" chunk 0 while chunk 1 stages
    t_request = time.perf_counter()
    assert next(it) == 1
    assert times[1] < t_request and pipe.prefetched >= 1
    pipe.close()


def test_staging_pipeline_runs_at_most_depth_ahead():
    staged = []

    def stage(k):
        staged.append(k)
        return k

    pipe = StagingPipeline(stage, range(4))
    it = iter(pipe)
    assert next(it) == 0
    wait_for(lambda: len(staged) >= 2)
    time.sleep(0.3)  # room to run further ahead, which it must not take
    assert staged == [0, 1], f"producer ran ahead: {staged}"
    assert next(it) == 1
    pipe.close()
    with pytest.raises(ValueError, match="depth"):
        StagingPipeline(stage, range(2), depth=0)


def test_staging_pipeline_raises_at_the_failed_item():
    def stage(k):
        if k == 2:
            raise RuntimeError("boom at chunk 2")
        return k

    got = []
    with pytest.raises(RuntimeError, match="boom at chunk 2"):
        for item in StagingPipeline(stage, range(5)):
            got.append(item)
    assert got == [0, 1]


def test_staging_pipeline_close_unblocks_and_reraises():
    release = threading.Event()

    def slow(k):
        if k > 0:
            release.wait(timeout=5.0)
        return k

    pipe = StagingPipeline(slow, range(4))
    it = iter(pipe)
    assert next(it) == 0
    release.set()
    pipe.close()  # must not hang with items unconsumed
    assert not pipe._thread.is_alive()

    def failing(k):
        raise RuntimeError("staging blew up")

    pipe = StagingPipeline(failing, range(3))
    deadline = time.monotonic() + 5.0
    while pipe._queue.qsize() == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    with pytest.raises(RuntimeError, match="staging blew up"):
        pipe.close()
    pipe.close()  # idempotent; the pending exception is delivered once


def test_staging_pipeline_flags_a_stuck_producer(caplog):
    release = threading.Event()

    def stage(k):
        release.wait(10.0)
        return k

    pipe = StagingPipeline(stage, range(2), join_timeout=0.2)
    with caplog.at_level(logging.WARNING, logger="repro_torch.federated.staging"):
        pipe.close()
    assert pipe.leaked
    assert any("failed to join" in r.message for r in caplog.records)
    release.set()
    pipe._thread.join(timeout=5.0)
    assert not pipe._thread.is_alive()


# --------------------------------------------------------------------------
# the staging comparison
# --------------------------------------------------------------------------


def test_staging_comparison_at_a_small_size():
    report = paper.run_staging_comparison(
        rounds=2, total_stays=189 * 8, batch_size=8, cohort_chunk=64, repeats=1,
        variants=paper.STAGING_VARIANTS, verbose=False, device="cpu",
    )
    assert report["num_clients"] == 189 and report["device"] == "cpu"
    assert set(report["variants"]) == set(paper.STAGING_VARIANTS)
    assert report["bytes_ratio"] >= 10.0 and report["speedup"] > 0.0
    assert report["speedup_vs_chunked_rebuild"] > 0.0
    # Every variant is the same computation: the same bits.
    assert report["max_param_diff"] == 0.0
    res = report["variants"]["resident"]
    assert res["chunks"] == 3 and res["bytes_resident"] > 0
    assert report["variants"]["rebuild"]["chunks"] == 1
