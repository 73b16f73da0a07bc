"""The port's population-scale experiment against the JAX package's.

* ``synthetic_population_stats`` and ``synthetic_population_clients`` give
  the reference's streams byte for byte (numpy copies).
* ``run_population_scale`` at a small size on the CPU gives the reference's
  report: streaming modes, recruited counts, participant match and every
  pool counter, exactly.
* The pooled rounds train the reference's pooled ``CohortTrainer`` rounds'
  params to 1e-5 from the same init carried across (one GRU layer: dropout
  does not apply, so the generators' streams do not enter).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.experiments import population as jax_pop  # noqa: E402
from repro.federated.cohort import CohortTrainer as JaxCohortTrainer  # noqa: E402
from repro.federated.cohort import chain_split_keys  # noqa: E402
from repro.models import gru as jax_gru  # noqa: E402
from repro.optim.adamw import AdamW as JaxAdamW  # noqa: E402
from repro_torch.experiments import population as pop  # noqa: E402
from repro_torch.models.gru import params_from_jax  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-5
SMALL = dict(populations=(60, 180), rounds=2, round_clients=12, pool_rows=24)
# the counters and decisions that must equal the reference's exactly
EXACT_KEYS = (
    "population", "streaming_mode", "num_recruited_streaming", "pool_exhausted",
    "num_recruited_exact", "overlap_jaccard", "participant_match", "pool_rows",
    "pool_uploads_total", "pool_evictions_total", "pool_bytes_resident",
    "last_round_pool_uploads", "slice_chunks_last_round",
)


@pytest.mark.parametrize("n, seed, chunk", [(1, 0, 4096), (700, 3, 256), (5000, 0, 4096)])
def test_population_stats_stream_is_the_reference_stream(n, seed, chunk):
    got = list(pop.synthetic_population_stats(n, seed=seed, chunk=chunk))
    ref = list(jax_pop.synthetic_population_stats(n, seed=seed, chunk=chunk))
    assert len(got) == len(ref) == n
    for g, r in zip(got, ref):
        assert g.client_id == r.client_id and g.n == r.n
        assert g.counts.dtype == r.counts.dtype
        assert g.counts.tobytes() == r.counts.tobytes()


@pytest.mark.parametrize("n, seed", [(1, 0), (300, 0), (257, 5)])
def test_population_clients_are_the_reference_clients(n, seed):
    got = pop.synthetic_population_clients(n, seed=seed)
    ref = jax_pop.synthetic_population_clients(n, seed=seed)
    assert [c.client_id for c in got] == [c.client_id for c in ref] == list(range(n))
    for g, r in zip(got, ref):
        for split in ("train", "val"):
            for field in ("x", "y"):
                a, b = getattr(getattr(g, split), field), getattr(getattr(r, split), field)
                assert a.dtype == b.dtype and a.shape == b.shape
                assert a.tobytes() == b.tobytes()


def test_constants_are_the_reference_constants():
    for name in ("NUM_BINS", "SEQ_LEN", "FEAT", "BATCH_SIZE", "N_RANGE", "STREAM_POOL"):
        assert getattr(pop, name) == getattr(jax_pop, name)
    ref = jax_pop.BENCH_RECRUITMENT
    got = pop.BENCH_RECRUITMENT
    assert (got.gamma_dv, got.gamma_sa, got.gamma_th) == (ref.gamma_dv, ref.gamma_sa, ref.gamma_th)


@pytest.fixture(scope="module")
def reports():
    return (
        pop.run_population_scale(**SMALL, verbose=False, device="cpu"),
        jax_pop.run_population_scale(**SMALL, verbose=False),
    )


def test_population_report_matches_the_reference(reports):
    got, ref = reports
    for key in ("bench", "populations", "rounds", "round_clients", "pool_rows", "seed",
                "population_ratio"):
        assert got[key] == ref[key]
    assert set(ref) <= set(got)
    assert len(got["entries"]) == len(ref["entries"]) == 2
    for g, r in zip(got["entries"], ref["entries"]):
        assert set(r) <= set(g)
        for key in EXACT_KEYS:
            assert g[key] == r[key], key
        assert len(g["round_times_s"]) == SMALL["rounds"]
        assert g["round_time_s"] > 0
        # every round runs the schedule's full length: some client has 5-8 stays
        assert g["cohort_steps"] == [pop.STEPS_PER_EPOCH] * SMALL["rounds"]
    small = got["entries"][0]
    assert small["streaming_mode"] == "exact" and small["participant_match"]
    assert small["pool_uploads_total"] >= SMALL["round_clients"]


def test_pooled_rounds_train_the_reference_params():
    """The reference's pooled rounds (its ``run_population_scale`` loop)
    and the port's ``pooled_rounds`` from the same init."""
    clients_ref = jax_pop.synthetic_population_clients(120, seed=0)
    clients = pop.synthetic_population_clients(120, seed=0)
    cfg = jax_gru.GRUConfig(input_dim=jax_pop.FEAT, hidden_dim=4, num_layers=1)
    params0 = jax.tree.map(np.asarray, jax_gru.init_gru(jax.random.key(3), cfg))
    row_bytes = (8 + 1) * jax_pop.SEQ_LEN * jax_pop.FEAT * 4 + (8 + 1) * 4
    trainer = JaxCohortTrainer(
        loss_fn=jax_gru.make_loss_fn(cfg),
        optimizer=JaxAdamW(learning_rate=5e-3, weight_decay=5e-3),
        batch_size=jax_pop.BATCH_SIZE, local_epochs=1, staging="resident",
        resident_budget_bytes=16 * row_bytes,
    )
    dcohort = trainer.attach_device_cohort(clients_ref)
    sample_rng = np.random.default_rng([0, 2])
    key = jax.random.key(0)
    params = params0
    for _ in range(3):
        ids = np.sort(sample_rng.choice(len(clients_ref), size=12, replace=False))
        key, subs = chain_split_keys(key, len(ids))
        params, _, _ = trainer.train_cohort(
            params, [clients_ref[int(i)] for i in ids], sample_rng, subs, steps_per_epoch=2
        )
    out = pop.pooled_rounds(clients, params_from_jax(params0, "cpu"), rounds=3,
                            round_clients=12, pool_rows=16, seed=0, device="cpu")
    assert dcohort.evictions > 0, "3 rounds of 12 out of a 16-row pool must evict"
    dc = out["device_cohort"]
    assert (dc.uploads, dc.evictions, dc.hits, dc.nbytes) == (
        dcohort.uploads, dcohort.evictions, dcohort.hits, dcohort.nbytes)
    for a, b in zip(tree_leaves(out["params"]), jax.tree.leaves(params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=0)


def test_population_defaults_are_the_reference_defaults():
    import inspect

    got = inspect.signature(pop.run_population_scale).parameters
    ref = inspect.signature(jax_pop.run_population_scale).parameters
    for name, param in ref.items():
        assert repr(got[name].default) == repr(param.default), name
    assert got["device"].default is None
