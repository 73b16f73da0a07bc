"""The port's adversary scenarios and Krum against the JAX package's.

Parity only: the attacker sets, the label flips, the poisoned client
lists and Krum's choice equal the reference's on the same inputs, and
attacked federations (label-flip on the vectorized engine, scaled-update
and sign-flip through the trainer proxy, Krum) match the reference's
runs.  Whether a robust aggregator survives an attack is not tested: the
reference's own tests of that fail in the JAX package (ROADMAP Queue 3).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro.data.synth_eicu import CohortConfig as JaxCohortConfig  # noqa: E402
from repro.data.synth_eicu import generate_cohort as jax_generate  # noqa: E402
from repro.federated.api import Federation as JaxFederation  # noqa: E402
from repro.federated.api import FederationConfig as JaxFederationConfig  # noqa: E402
from repro.models import gru as jax_gru  # noqa: E402
from repro.optim.adamw import AdamW as JaxAdamW  # noqa: E402
from repro.privacy import adversary as jax_adversary  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.data.synth_eicu import CohortConfig, generate_cohort  # noqa: E402
from repro_torch.federated.api import Federation, FederationConfig, resolve_aggregator  # noqa: E402
from repro_torch.models import gru  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.privacy import adversary  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

torch.set_num_threads(1)

COHORT = dict(num_hospitals=6, total_stays=240, min_hospital_size=10)


@pytest.mark.parametrize("fraction", [0.0, 0.01, 0.2, 0.3, 0.5, 1.0])
@pytest.mark.parametrize("seed", [0, 1, 5])
def test_attacker_ids_are_the_references(fraction, seed):
    ids = [3, 17, 4, 9, 11, 0, 25, 8, 2, 6]
    got = adversary.attacker_ids(ids, adversary.ScenarioConfig(fraction=fraction, seed=seed))
    ref = jax_adversary.attacker_ids(
        ids, jax_adversary.ScenarioConfig(fraction=fraction, seed=seed))
    assert got.dtype == ref.dtype and got.tolist() == ref.tolist()


@pytest.mark.parametrize("kwargs,match", [
    ({"attack": "labelflip"}, "did you mean 'label-flip'"),
    ({"fraction": 1.5}, r"fraction must be in \[0, 1\]"),
    ({"attack": "scaled-update", "scale": float("inf")}, "scale must be finite"),
])
def test_scenario_config_rejects_what_the_reference_rejects(kwargs, match):
    for m in (adversary, jax_adversary):
        with pytest.raises(ValueError, match=match):
            m.ScenarioConfig(**kwargs)
    assert adversary.ATTACKS == jax_adversary.ATTACKS


def test_flip_labels_and_poison_clients_are_the_references():
    clients = pipeline.build_client_datasets(generate_cohort(CohortConfig(**COHORT), seed=3))
    ref_clients = jax_pipeline.build_client_datasets(
        jax_generate(JaxCohortConfig(**COHORT), seed=3))
    attackers = np.array([clients[1].client_id, clients[4].client_id])
    got = adversary.poison_clients(clients, attackers)
    ref = jax_adversary.poison_clients(ref_clients, attackers)
    for g, r, c in zip(got, ref, clients):
        assert g.client_id == r.client_id
        assert g.train.y.tobytes() == np.asarray(r.train.y).tobytes()
        assert g.train.x is c.train.x and g.val is c.val
        assert (g is c) == (int(c.client_id) not in attackers)
    y = np.array([1.0, 2.0, 10.0], dtype=np.float32)
    flipped = adversary.flip_labels(pipeline.ArrayDataset(x=np.zeros((3, 4), np.float32), y=y))
    np.testing.assert_array_equal(flipped.y, [10.0, 9.0, 1.0])


def krum_inputs(c, seed, outliers=1):
    rng = np.random.default_rng(seed)
    tree = {"w": (rng.normal(size=(c, 5, 2)) * 0.01).astype(np.float32),
            "layers": [{"b": (rng.normal(size=(c, 3)) * 0.01).astype(np.float32)}]}
    for i in range(outliers):
        tree["w"][(seed + 2 * i) % c] += 10.0 * (i + 1)
    return tree


@pytest.mark.parametrize("f,m", [(1, 1), (2, 1), (1, 3), (0, 2)])
@pytest.mark.parametrize("seed", [0, 1])
def test_krum_chooses_what_the_reference_chooses(f, m, seed):
    tree = krum_inputs(9, seed, outliers=2)
    ours = adversary.KrumAggregator(f=f, m=m)
    got = ours.aggregate(jax.tree.map(torch.from_numpy, tree), np.ones(9, np.float32))
    want = jax_adversary.KrumAggregator(f=f, m=m).aggregate(
        jax.tree.map(jnp.asarray, tree), jnp.ones(9))
    assert ours.last_chosen.size == m
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-7)
    if m == 1:
        # the mean of one update is that update: the choice itself
        for g, leaf in zip(tree_leaves(got), jax.tree.leaves(tree)):
            assert g.numpy().tobytes() == leaf[ours.last_chosen[0]].tobytes()


def test_krum_spec_forms_and_validation():
    agg = resolve_aggregator("krum:2,3")
    assert isinstance(agg, adversary.KrumAggregator) and (agg.f, agg.m) == (2, 3)
    assert resolve_aggregator("krum").f == 1
    with pytest.raises(ValueError, match="f >= 0"):
        adversary.KrumAggregator(f=-1)
    with pytest.raises(ValueError, match="m >= 1"):
        adversary.KrumAggregator(m=0)
    with pytest.raises(ValueError, match="2f\\+3"):
        adversary.KrumAggregator(f=1).aggregate({"w": torch.ones(4, 3)}, np.ones(4))


def fed_pair(aggregator, engine, scenario=None, rounds=2, lr=5e-3):
    """The same federation in the port and in the reference, from the
    reference's initial params (dropout 0), under ``scenario``, with AdamW
    at ``lr``."""
    jcfg = jax_gru.GRUConfig(hidden_dim=8, num_layers=1, dropout=0.0)
    cfg = gru.GRUConfig(hidden_dim=8, num_layers=1, dropout=0.0)
    init = jax.tree.map(np.asarray, jax_gru.init_gru(jax.random.key(0), jcfg))
    config = dict(rounds=rounds, local_epochs=1, batch_size=16, seed=0,
                  aggregator=aggregator, engine=engine)
    clients = pipeline.build_client_datasets(generate_cohort(CohortConfig(**COHORT), seed=3))
    ours = Federation(FederationConfig(**config), clients, gru.make_loss_fn(cfg),
                      AdamW(learning_rate=lr), device="cpu")
    ref = JaxFederation(JaxFederationConfig(**config, staging="rebuild"),
                        jax_pipeline.build_client_datasets(
                            jax_generate(JaxCohortConfig(**COHORT), seed=3)),
                        jax_gru.make_loss_fn(jcfg), JaxAdamW(learning_rate=lr))
    if scenario is not None:
        adversary.apply_scenario(ours, adversary.ScenarioConfig(**scenario))
        jax_adversary.apply_scenario(ref, jax_adversary.ScenarioConfig(**scenario))
        assert ours.scenario_attackers.tolist() == ref.scenario_attackers.tolist()
    return ours, ours.run(gru.params_from_jax(init, "cpu")), ref, ref.run(init)


@pytest.mark.parametrize("aggregator,engine,scenario", [
    ("fedavg", "vectorized", {"attack": "label-flip", "fraction": 0.4, "seed": 5}),
    ("fedavg", "vectorized", {"attack": "scaled-update", "fraction": 0.3, "scale": 5.0, "seed": 1}),
    ("krum:1", "sequential", {"attack": "sign-flip", "fraction": 0.2, "seed": 2}),
    ("krum:1", "sequential", None),
])
def test_attacked_federations_match_the_reference(aggregator, engine, scenario):
    fed, got, ref_fed, ref = fed_pair(aggregator, engine, scenario)
    assert fed.effective_engine == ref_fed.effective_engine
    assert type(fed.aggregator).__name__ == type(ref_fed.aggregator).__name__
    for g, r in zip(got.history, ref.history):
        assert g.participant_ids == r.participant_ids
        assert abs(g.mean_local_loss - r.mean_local_loss) <= 1e-5
    for a, b in zip(tree_leaves(got.params), jax.tree.leaves(ref.params)):
        assert float(np.max(np.abs(a.numpy() - np.asarray(b)))) <= 1e-4


# At lr 5e-2 the two packages' trajectories drift apart by AdamW's
# amplification of float association (ROADMAP Queue 3): taken at the same
# params, the port's gradient is the reference's within 2.7e-7 at every
# local step, but AdamW divides by sqrt(v) and the last bits grow step by
# step.  Measured on the CPU, port against reference, fedavg and label-flip
# alike: round losses 3.3e-6 and 1.63e-5, params 6.95e-3 and 1.01e-2 (at
# lr 5e-3: 0 and 2.4e-7, 3.0e-7 and 4.5e-7).  Held to about twice that.
HIGH_LR = 5e-2
HIGH_LR_LOSS_TOL = 3.5e-5
HIGH_LR_PARAMS_TOL = 2.5e-2


@pytest.mark.parametrize("scenario", [
    None, {"attack": "label-flip", "fraction": 0.4, "seed": 5},
])
def test_federations_at_a_high_lr_match_the_reference_within_adamw_drift(scenario):
    _, got, _, ref = fed_pair("fedavg", "vectorized", scenario, lr=HIGH_LR)
    for g, r in zip(got.history, ref.history):
        assert g.participant_ids == r.participant_ids
        assert abs(g.mean_local_loss - r.mean_local_loss) <= HIGH_LR_LOSS_TOL
    for a, b in zip(tree_leaves(got.params), jax.tree.leaves(ref.params)):
        assert float(np.max(np.abs(a.numpy() - np.asarray(b)))) <= HIGH_LR_PARAMS_TOL


def test_gradient_at_a_high_lr_is_the_references_at_every_step():
    """The measurement behind the drift: one label-flipped client's local
    AdamW steps at lr 5e-2 in both packages; at each step both take the
    gradient at the reference's params, and they agree to float
    association, while the params the two trajectories reach drift."""
    cfg = gru.GRUConfig(hidden_dim=8, num_layers=1, dropout=0.0)
    jcfg = jax_gru.GRUConfig(hidden_dim=8, num_layers=1, dropout=0.0)
    init = jax.tree.map(np.asarray, jax_gru.init_gru(jax.random.key(0), jcfg))
    clients = pipeline.build_client_datasets(generate_cohort(CohortConfig(**COHORT), seed=3))
    client = adversary.poison_clients(clients, np.array([clients[0].client_id]))[0]
    x, y = client.train.x, client.train.y
    loss_fn = gru.make_loss_fn(cfg)
    jax_grad = jax.jit(jax.value_and_grad(jax_gru.make_loss_fn(jcfg)))
    jax_opt = JaxAdamW(learning_rate=HIGH_LR)
    params = jax.tree.map(jnp.asarray, init)
    state = jax_opt.init(params)
    rng = np.random.default_rng(0)
    for _ in range(30):
        idx = rng.choice(len(y), 16)
        batch = (x[idx], y[idx], np.ones(16, np.float32))
        loss, grads = jax_grad(params, batch)
        ours = [torch.tensor(np.asarray(p), requires_grad=True) for p in jax.tree.leaves(params)]
        tree = jax.tree.unflatten(jax.tree.structure(params), ours)
        got = loss_fn(tree, tuple(torch.from_numpy(a) for a in batch))
        got_grads = torch.autograd.grad(got, ours)
        assert abs(float(got) - float(loss)) <= 1e-6
        for g, w in zip(got_grads, jax.tree.leaves(grads)):
            assert float(np.max(np.abs(g.numpy() - np.asarray(w)))) <= 1e-6
        updates, state = jax_opt.update(grads, state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)


@functools.lru_cache(maxsize=1)
def grouped_federation():
    cfg = gru.GRUConfig(hidden_dim=8, num_layers=1, dropout=0.0)
    return Federation(
        FederationConfig(rounds=1, local_epochs=1, batch_size=16, seed=0,
                         aggregator="hierarchical:2", engine="sequential"),
        pipeline.build_client_datasets(generate_cohort(CohortConfig(**COHORT), seed=3)),
        gru.make_loss_fn(cfg), AdamW(5e-2), device="cpu")


def test_model_poisoning_rejects_grouped_aggregators():
    with pytest.raises(ValueError, match="grouped"):
        adversary.apply_scenario(grouped_federation(), adversary.ScenarioConfig(
            attack="scaled-update", fraction=0.25, scale=50.0, seed=1))


def test_clean_scenario_leaves_the_federation_as_it_was():
    fed = grouped_federation()
    trainer, clients = fed.trainer, dict(fed.all_clients)
    adversary.apply_scenario(fed, adversary.ScenarioConfig(fraction=0.0))
    assert fed.scenario_attackers.size == 0
    assert fed.trainer is trainer and fed.all_clients == clients
