"""The port's training path end to end against the JAX package, on the CPU.

A small federation (8 hospitals, hidden 8, 2 layers, batch 8, dropout 0,
2 rounds) runs through JAX's ``Federation(engine="sequential")`` and the
port's ``Federation`` from the same params carried across: the recruited
federation and each round's participants are identical (the numpy streams
are copies), and each round's loss agrees to 1e-5.

The final params are held to 1e-4.  AdamW's step m_hat / (sqrt(v_hat) + eps)
does not shrink with the gradient: for an entry whose gradient is close to
zero, a rounding difference in its last bits (another summation order in
the backward) is a large relative change, and it moves the step by a
visible fraction of lr; 31 local steps add those up.  On this federation
every entry but one of the second layer's W_hh agrees to 3e-7; that one
drifts to 2.9e-5 in round one and stays there.

``run_seeds`` is held against JAX's on the same stand-in runs (its
aggregation and what it prints), and ``launch/train.py --mode paper`` runs
two seeds on the CPU at scale 0.005 and writes its results file.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.data.pipeline import build_client_datasets as jax_clients  # noqa: E402
from repro.data.pipeline import global_dataset as jax_global  # noqa: E402
from repro.data.synth_eicu import Cohort as JaxCohort  # noqa: E402
from repro.data.synth_eicu import CohortConfig as JaxCohortConfig  # noqa: E402
from repro.data.synth_eicu import generate_cohort as jax_generate  # noqa: E402
from repro.experiments import paper as jax_paper  # noqa: E402
from repro.federated.api import Federation as JaxFederation  # noqa: E402
from repro.federated.api import FederationConfig as JaxFederationConfig  # noqa: E402
from repro.federated.central import CentralConfig as JaxCentralConfig  # noqa: E402
from repro.federated.central import train_central as jax_train_central  # noqa: E402
from repro.metrics.regression import evaluate_predictions as jax_evaluate  # noqa: E402
from repro.models import gru as jax_gru  # noqa: E402
from repro.optim.adamw import AdamW as JaxAdamW  # noqa: E402
from repro_torch.data.pipeline import build_client_datasets, global_dataset  # noqa: E402
from repro_torch.data.synth_eicu import Cohort, CohortConfig, generate_cohort  # noqa: E402
from repro_torch.experiments import paper  # noqa: E402
from repro_torch.federated.api import Federation, FederationConfig  # noqa: E402
from repro_torch.federated.central import CentralConfig, train_central  # noqa: E402
from repro_torch.metrics.regression import evaluate_predictions  # noqa: E402
from repro_torch.models import gru  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-5
PARAMS_TOL = 1e-4
COHORT = dict(num_hospitals=8, total_stays=320, min_hospital_size=10)
JCFG = jax_gru.GRUConfig(hidden_dim=8, num_layers=2, dropout=0.0)
TCFG = gru.GRUConfig(hidden_dim=8, num_layers=2, dropout=0.0)
EXP = paper.ExperimentConfig(rounds=2, local_epochs=1, batch_size=8)
JEXP = jax_paper.ExperimentConfig(rounds=2, local_epochs=1, batch_size=8, engine="sequential")


@pytest.fixture(scope="module")
def cohorts():
    return (
        jax_generate(JaxCohortConfig(**COHORT), seed=3),
        generate_cohort(CohortConfig(**COHORT), seed=3),
    )


@pytest.fixture(scope="module")
def init_params():
    return jax.tree.map(np.asarray, jax_gru.init_gru(jax.random.key(0), JCFG))


def assert_params_close(port_params, jax_params, tol=PARAMS_TOL):
    for a, b in zip(tree_leaves(port_params), jax.tree.leaves(jax_params)):
        assert float(np.max(np.abs(a.detach().numpy() - np.asarray(b)))) <= tol


def test_cohort_arrays_are_bit_equal(cohorts):
    ref, got = cohorts
    for field in ("x_temporal", "x_static", "y", "hospital_id", "split"):
        a, b = getattr(ref, field), getattr(got, field)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert ref.fused_features().tobytes() == got.fused_features().tobytes()


@pytest.mark.parametrize("setting", ["federated-ac", "federated-src"])
def test_federation_matches_jax(cohorts, init_params, setting):
    jax_cohort, cohort = cohorts
    policies = paper.policies_for(setting, EXP)
    assert policies == jax_paper.policies_for(setting, JEXP)
    ref = JaxFederation(
        JaxFederationConfig(rounds=2, local_epochs=1, batch_size=8, seed=1,
                            engine="sequential", **policies),
        jax_clients(jax_cohort), jax_gru.make_loss_fn(JCFG), JaxAdamW(),
    ).run(init_params)
    got = Federation(
        FederationConfig(rounds=2, local_epochs=1, batch_size=8, seed=1, engine="sequential",
                         **policies),
        build_client_datasets(cohort), gru.make_loss_fn(TCFG), AdamW(), device="cpu",
    ).run(gru.params_from_jax(init_params, "cpu"))

    assert got.federation_ids.tolist() == ref.federation_ids.tolist()
    assert (got.recruitment is None) == (ref.recruitment is None)
    if ref.recruitment is not None:
        assert got.recruitment.num_recruited == ref.recruitment.num_recruited
    assert len(got.history) == len(ref.history) == 2
    for g, r in zip(got.history, ref.history):
        assert g.participant_ids == r.participant_ids
        assert g.local_steps == r.local_steps
        assert (g.params_down, g.params_up, g.bytes_transferred) == (
            r.params_down, r.params_up, r.bytes_transferred)
        assert abs(g.mean_local_loss - r.mean_local_loss) <= TOL
    assert_params_close(got.params, ref.params)
    s_got, s_ref = got.summary(), ref.summary()
    assert set(s_got) == set(s_ref)
    for key in ("rounds", "federation_size", "recruited", "total_local_steps",
                "params_down", "params_up", "bytes_transferred", "virtual_time",
                "mean_staleness", "epsilon"):
        assert s_got[key] == s_ref[key]
    assert set(got.history[0].to_state()) == set(ref.history[0].to_state())


def test_train_central_matches_jax(cohorts, init_params):
    jax_cohort, cohort = cohorts
    ref = jax_train_central(
        JaxCentralConfig(epochs=1, batch_size=8, seed=2),
        jax_global(jax_cohort, JaxCohort.TRAIN), init_params,
        jax_gru.make_loss_fn(JCFG), JaxAdamW(),
    )
    got = train_central(
        CentralConfig(epochs=1, batch_size=8, seed=2), global_dataset(cohort, Cohort.TRAIN),
        gru.params_from_jax(init_params, "cpu"), gru.make_loss_fn(TCFG), AdamW(), device="cpu",
    )
    assert got.total_steps == ref.total_steps
    np.testing.assert_allclose(got.epoch_losses, ref.epoch_losses, rtol=0, atol=TOL)
    assert_params_close(got.params, ref.params)


def test_predict_and_metrics_match_jax(cohorts, init_params):
    jax_cohort, cohort = cohorts
    ref_test, test = jax_global(jax_cohort, JaxCohort.TEST), global_dataset(cohort, Cohort.TEST)
    ref = jax_paper._predict(init_params, JCFG, ref_test, batch=16)
    got = paper._predict(gru.params_from_jax(init_params, "cpu"), TCFG, test, batch=16)
    assert got.shape == ref.shape == (len(test),)
    assert float(np.max(np.abs(got - ref))) <= TOL
    m_ref, m_got = jax_evaluate(ref_test.y, ref), evaluate_predictions(test.y, got)
    assert set(m_got) == set(m_ref)
    for key in m_ref:
        assert abs(m_got[key] - m_ref[key]) <= TOL * max(1.0, abs(m_ref[key]))


@pytest.mark.parametrize("setting", paper.MODEL_SETTINGS[:5])
def test_run_setting_runs_every_paper_setting_on_cpu(cohorts, setting):
    _, cohort = cohorts
    exp = dataclasses.replace(EXP, central_epochs=1, device="cpu")
    out = paper.run_setting(setting, exp, cohort, seed=0)
    assert out["setting"] == setting
    assert all(np.isfinite(v) for v in out["metrics"].values())
    assert out["local_steps"] > 0
    if setting == "central":
        assert out["federation_size"] is None
    else:
        assert out["federation_size"] == len(out["federation_ids"]) > 0
        assert len(out["round_times_s"]) == EXP.rounds


@pytest.mark.parametrize(
    "spec",
    ["all", "nu-greedy", "nu-greedy:quality-greedy", "nu-greedy:0.5,0.5,0.1", "random-k:3",
     "top-n-samples:4"],
)
def test_recruitment_policies_match_jax(cohorts, spec):
    from repro.federated.api import resolve_recruitment as jax_resolve
    from repro_torch.federated.api import resolve_recruitment

    jax_cohort, cohort = cohorts
    ref = jax_resolve(spec).recruit(
        [c.stats() for c in jax_clients(jax_cohort)], np.random.default_rng([1, 1]))
    got = resolve_recruitment(spec).recruit(
        [c.stats() for c in build_client_datasets(cohort)], np.random.default_rng([1, 1]))
    assert got.federation_ids.tolist() == ref.federation_ids.tolist()


@pytest.mark.parametrize(
    "spec", ["uniform", "uniform:0.5", "uniform:3", "round-robin:3", "loss-weighted:0.5"]
)
def test_selection_policies_match_jax(spec):
    from repro.federated.api import resolve_selection as jax_resolve
    from repro_torch.federated.api import resolve_selection

    ids = np.arange(2, 12)
    ref, got = jax_resolve(spec), resolve_selection(spec)
    rng_ref, rng_got = np.random.default_rng(5), np.random.default_rng(5)
    for rnd in range(3):
        a = ref.select(rnd, ids, rng_ref)
        b = got.select(rnd, ids, rng_got)
        assert b.tolist() == a.tolist()
        losses = np.linspace(0.5, 2.0, len(a)).astype(np.float32)
        ref.observe(a, losses)
        got.observe(b, losses)


def test_fedavg_primitives_match_jax(init_params):
    from repro.federated import fedavg as jax_fedavg
    from repro_torch.federated import fedavg

    rng = np.random.default_rng(7)
    trees = [jax.tree.map(lambda a: (a + rng.normal(size=a.shape)).astype(np.float32), init_params)
             for _ in range(3)]
    ported = [gru.params_from_jax(t, "cpu") for t in trees]
    w = [3.0, 1.0, 2.0]
    assert_params_close(fedavg.aggregate(ported, w), jax_fedavg.aggregate(trees, w), tol=TOL)
    assert_params_close(fedavg.aggregate(ported), jax_fedavg.aggregate(trees), tol=TOL)
    stacked = jax.tree.map(lambda *leaves: np.stack(leaves), *trees)
    assert_params_close(
        fedavg.weighted_sum_stacked(fedavg.stack_trees(ported), w),
        jax_fedavg.weighted_sum_stacked(stacked, w), tol=TOL,
    )
    d = fedavg.delta(ported[0], ported[1])
    assert_params_close(d, jax_fedavg.delta(trees[0], trees[1]), tol=TOL)
    assert_params_close(fedavg.apply_delta(ported[1], d, 0.5),
                        jax_fedavg.apply_delta(trees[1], jax_fedavg.delta(trees[0], trees[1]), 0.5),
                        tol=TOL)
    assert fedavg.params_nbytes(ported[0]) == jax_fedavg.params_nbytes(trees[0])
    assert fedavg.tree_allclose(ported[0], ported[0])
    assert not fedavg.tree_allclose(ported[0], ported[1])
    with pytest.raises(ValueError):
        fedavg.aggregate(ported, [0.0, 0.0, 0.0])


def fake_run(setting, exp, cohort, seed, **_):
    """A stand-in for ``run_setting`` whose numbers depend on the seed only."""
    return {"setting": setting, "seed": seed, "tau_s": 1.5 + seed, "local_steps": 10 + 3 * seed,
            "federation_size": 7, "recruited": 5,
            "metrics": {"mae": 2.0 + 0.25 * seed, "mape": 0.5 / (1 + seed), "mse": 9.0 - seed,
                        "msle": 0.3 + 0.01 * seed * seed}}


@pytest.mark.parametrize("seeds", [[0], [0, 1, 2]])
def test_run_seeds_aggregates_as_jax(monkeypatch, capsys, seeds):
    for module in (paper, jax_paper):
        monkeypatch.setattr(module, "run_setting", fake_run)
        monkeypatch.setattr(module, "build_cohort", lambda exp, seed: None)
    ref = jax_paper.run_seeds("federated-src", JEXP, seeds)
    ref_out = capsys.readouterr().out
    got = paper.run_seeds("federated-src", EXP, seeds)
    assert capsys.readouterr().out == ref_out
    assert got == ref


def test_train_paper_mode_on_the_cpu_writes_its_results(monkeypatch, tmp_path, capsys):
    from repro_torch.launch import train

    monkeypatch.setattr(train, "RESULTS_DIR", tmp_path)
    train.main(["--mode", "paper", "--device", "cpu", "--setting", "federated-src",
                "--scale", "0.005", "--rounds", "1", "--seeds", "0", "1"])
    out = tmp_path / "paper" / "federated-src_scale0.005.json"
    assert f"saved -> {out}" in capsys.readouterr().out
    agg = json.loads(out.read_text())
    assert agg["setting"] == "federated-src" and agg["seeds"] == [0, 1]
    assert [r["seed"] for r in agg["runs"]] == [0, 1]
    for key in ("mae", "mape", "mse", "msle"):
        vals = [r["metrics"][key] for r in agg["runs"]]
        assert agg[key]["values"] == vals and all(np.isfinite(vals))
        assert agg[key]["mean"] == pytest.approx(np.mean(vals), rel=1e-12)
        assert agg[key]["std"] == pytest.approx(np.std(vals, ddof=1), rel=1e-12)
    assert agg["tau_s"]["values"] == [r["tau_s"] for r in agg["runs"]]
    assert agg["federation_size"] == agg["runs"][0]["federation_size"] > 0
    assert agg["local_steps"] > 0
