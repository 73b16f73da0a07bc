"""The port's stacked and grouped aggregators on the CPU, against the JAX
package's.

* ``trimmed_mean_stacked`` and ``TrimmedMeanAggregator`` on the same
  client-stacked arrays: within 1e-5 of the reference, the same errors.
* ``HierarchicalFedAvg``: the same groups and the same aggregate (1e-5).
* The built-in policies: every registry of the port holds the reference's
  own built-in names, whatever a user (or an example run earlier in the same
  process) has registered beside them.
* The port's ``Federation`` with ``trimmed-mean`` (the per-client trainer,
  whatever the engine) and ``hierarchical`` (one engine round per group,
  resident staging) against JAX's at dropout 0, from the same params:
  round losses within 1e-5, params within 1e-4.  ``hierarchical`` against
  flat FedAvg in the port within 1e-5.

``trimmed-mean`` is held to the reference's numbers only; whether it
survives an attack is not tested (ROADMAP Queue 3).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.data.pipeline import build_client_datasets as jax_clients  # noqa: E402
from repro.data.synth_eicu import CohortConfig as JaxCohortConfig  # noqa: E402
from repro.data.synth_eicu import generate_cohort as jax_generate  # noqa: E402
from repro.federated import api as jax_api  # noqa: E402
from repro.federated import fedavg as jax_fedavg  # noqa: E402
from repro.models import gru as jax_gru  # noqa: E402
from repro.optim.adamw import AdamW as JaxAdamW  # noqa: E402
from repro_torch.data.pipeline import build_client_datasets  # noqa: E402
from repro_torch.data.synth_eicu import CohortConfig, generate_cohort  # noqa: E402
from repro_torch.federated import api  # noqa: E402
from repro_torch.federated import fedavg  # noqa: E402
from repro_torch.models import gru  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-5
PARAMS_TOL = 1e-4
COHORT = dict(num_hospitals=8, total_stays=320, min_hospital_size=10)


def stacked_arrays(c: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(c, 4, 3)).astype(np.float32),
            "b": {"v": rng.normal(size=(c, 5)).astype(np.float32)}}


def as_torch(tree):
    if isinstance(tree, dict):
        return {k: as_torch(v) for k, v in tree.items()}
    return torch.from_numpy(tree)


def max_gap(port, ref) -> float:
    return max(float(np.max(np.abs(a.numpy() - np.asarray(b))))
               for a, b in zip(tree_leaves(port), jax.tree.leaves(ref)))


@pytest.mark.parametrize("c,trim", [(10, 0.0), (10, 0.2), (7, 0.1), (3, 0.45), (1, 0.3)])
def test_trimmed_mean_stacked_matches_jax(c, trim):
    stacked = stacked_arrays(c, seed=c)
    got = fedavg.trimmed_mean_stacked(as_torch(stacked), trim)
    ref = jax_fedavg.trimmed_mean_stacked(stacked, trim)
    assert max_gap(got, ref) <= TOL
    weights = np.arange(1, c + 1, dtype=np.float32)
    agg = api.resolve_aggregator(f"trimmed-mean:{trim}")
    assert isinstance(agg, api.TrimmedMeanAggregator) and agg.mode == "stacked"
    assert max_gap(agg.aggregate(as_torch(stacked), weights),
                   jax_api.TrimmedMeanAggregator(trim).aggregate(stacked, weights)) <= TOL


def test_trimmed_mean_resists_an_outlier_as_jax_does():
    stacked = stacked_arrays(10)
    stacked["w"][3] = 1e6
    for trim in (0.0, 0.2):
        got = fedavg.trimmed_mean_stacked(as_torch(stacked), trim)
        ref = jax_fedavg.trimmed_mean_stacked(stacked, trim)
        assert max_gap(got, ref) <= TOL * max(1.0, float(np.abs(np.asarray(ref["w"])).max()))


@pytest.mark.parametrize("trim", [0.5, 0.7, 2.0, -0.1])
def test_trim_out_of_range_raises_as_jax(trim):
    with pytest.raises(ValueError) as ours:
        fedavg.trimmed_mean_stacked(as_torch(stacked_arrays(4)), trim)
    with pytest.raises(ValueError) as theirs:
        jax_fedavg.trimmed_mean_stacked(stacked_arrays(4), trim)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="trim fraction"):
        api.TrimmedMeanAggregator(trim)


@pytest.mark.parametrize("regions,n", [(3, 10), (4, 35), (8, 3), (1, 5)])
def test_hierarchical_groups_and_aggregate_match_jax(regions, n):
    ids = np.arange(100, 100 + n)
    ours, theirs = api.HierarchicalFedAvg(regions), jax_api.HierarchicalFedAvg(regions)
    assert ours.mode == theirs.mode == "grouped"
    assert [g.tolist() for g in ours.groups(ids)] == [g.tolist() for g in theirs.groups(ids)]
    stacked = stacked_arrays(len(ours.groups(ids)), seed=n)
    weights = np.arange(2, 2 + len(ours.groups(ids)), dtype=np.float32)
    assert max_gap(ours.aggregate(as_torch(stacked), weights),
                   theirs.aggregate(stacked, weights)) <= TOL
    assert api.resolve_aggregator(f"hierarchical:{regions}").num_regions == regions
    with pytest.raises(ValueError, match="region"):
        api.HierarchicalFedAvg(0)


def builtin_policies(module, package: str) -> dict[str, tuple[str, ...]]:
    """``available_policies()`` of ``module`` cut to the names whose factory
    ``package`` itself defines: a policy registered by user code (an example
    run earlier in this process registers ``median-band``) stays out."""
    module.available_policies()  # the port registers its lazy tiers here
    return {stage: tuple(sorted(name for name, factory in registry.items()
                                if factory.__module__.startswith(package + ".")))
            for stage, registry in (("recruitment", module._RECRUITMENTS),
                                    ("selection", module._SELECTIONS),
                                    ("aggregator", module._AGGREGATORS))}


def test_available_policies_are_the_references_less_the_unported_tiers():
    """Every tier is ported, so each registry's built-in names are the
    reference's own.  The name dates from when the privacy tier and the async
    runtime were not ported, and is kept so the test keeps its identity."""
    ours, theirs = builtin_policies(api, "repro_torch"), builtin_policies(jax_api, "repro")
    assert ours["recruitment"] == theirs["recruitment"]
    assert ours["selection"] == theirs["selection"]
    # Every tier is ported: krum and secagg-fedavg register with the privacy
    # tier, fedbuff and hierarchical-async with the async runtime.
    assert ours["aggregator"] == theirs["aggregator"]
    assert set(ours["aggregator"]) == {
        "fedavg", "hierarchical", "trimmed-mean", "krum", "secagg-fedavg",
        "fedbuff", "hierarchical-async"}
    assert {"all", "nu-greedy", "random-k", "top-n-samples"} == set(ours["recruitment"])
    # What is registered is what available_policies() lists, user policies beside.
    for stage, names in api.available_policies().items():
        assert set(ours[stage]) <= set(names)
    assert api.AGGREGATION_MODES == jax_api.AGGREGATION_MODES
    # A user's aggregator that names no mode gets every client's params.
    assert api.Aggregator.mode == jax_api.Aggregator.mode == "stacked"


# --------------------------------------------------------------------------
# the round program with each mode, against the JAX package
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cohorts():
    return (jax_clients(jax_generate(JaxCohortConfig(**COHORT), seed=3)),
            build_client_datasets(generate_cohort(CohortConfig(**COHORT), seed=3)))


@pytest.mark.parametrize("aggregator,engine", [
    ("trimmed-mean:0.2", "vectorized"),
    ("hierarchical:3", "vectorized"),
    ("hierarchical:3", "sequential"),
])
def test_federation_with_the_aggregator_matches_jax(cohorts, aggregator, engine):
    jax_cohort, cohort = cohorts
    jcfg = jax_gru.GRUConfig(hidden_dim=8, num_layers=2, dropout=0.0)
    init = jax.tree.map(np.asarray, jax_gru.init_gru(jax.random.key(0), jcfg))
    base = dict(rounds=2, local_epochs=1, batch_size=8, seed=1, engine=engine,
                aggregator=aggregator, selection="uniform:0.75")
    ref_fed = jax_api.Federation(jax_api.FederationConfig(**base), jax_cohort,
                                 jax_gru.make_loss_fn(jcfg), JaxAdamW())
    ref = ref_fed.run(init)
    fed = api.Federation(api.FederationConfig(**base), cohort,
                         gru.make_loss_fn(gru.GRUConfig(hidden_dim=8, dropout=0.0)), AdamW(),
                         device="cpu")
    assert fed.effective_engine == ref_fed.effective_engine
    got = fed.run(gru.params_from_jax(init, "cpu"))
    assert got.total_local_steps == ref.total_local_steps
    for g, r in zip(got.history, ref.history):
        assert g.participant_ids == r.participant_ids
        assert abs(g.mean_local_loss - r.mean_local_loss) <= TOL
    assert max_gap(got.params, ref.params) <= PARAMS_TOL
    if aggregator.startswith("trimmed"):
        # Stacked rounds never touch the cohort engine: nothing attached.
        assert fed.effective_engine == "sequential" and fed.cohort_trainer.device_cohort is None
    elif engine == "vectorized":
        # One resident upload; each group's round gathers its rows from it.
        assert fed.cohort_trainer.device_cohort.num_rows == got.federation_ids.size
        assert fed.cohort_trainer.last_round_stats["staging"] == "resident"


def test_hierarchical_telescopes_to_flat_fedavg(cohorts):
    _, cohort = cohorts
    cfg = gru.GRUConfig(hidden_dim=8, dropout=0.05)
    params0 = gru.init_gru(torch.Generator().manual_seed(0), cfg, "cpu")
    out = {}
    for agg in ("fedavg", "hierarchical:3"):
        out[agg] = api.Federation(
            api.FederationConfig(rounds=2, local_epochs=1, batch_size=8, seed=0, aggregator=agg),
            cohort, gru.make_loss_fn(cfg), AdamW(), device="cpu").run(params0)
    gap = max(float((a - b).abs().max()) for a, b in zip(tree_leaves(out["fedavg"].params),
                                                       tree_leaves(out["hierarchical:3"].params)))
    assert gap <= TOL
    for a, b in zip(out["fedavg"].history, out["hierarchical:3"].history):
        assert abs(a.mean_local_loss - b.mean_local_loss) <= TOL


def test_grouped_aggregators_must_partition_the_participants(cohorts):
    _, cohort = cohorts

    class Overlapping(api.HierarchicalFedAvg):
        def groups(self, participant_ids):
            ids = np.asarray(participant_ids)
            return [ids, ids[:1]]

    class Unknown(api.Aggregator):
        mode = "streamed"

    class Buffered(api.Aggregator):
        mode = "buffered"  # the async runtime's mode, as in the reference

    cfg = gru.GRUConfig(hidden_dim=4)
    params0 = gru.init_gru(torch.Generator().manual_seed(0), cfg, "cpu")
    fed = api.Federation(api.FederationConfig(rounds=1, local_epochs=1, batch_size=8,
                                              aggregator=Overlapping(2)),
                         cohort, gru.make_loss_fn(cfg), AdamW(), device="cpu")
    with pytest.raises(ValueError, match="partition"):
        fed.run(params0)
    with pytest.raises(ValueError, match="not in"):
        api.Federation(api.FederationConfig(aggregator=Unknown()), cohort,
                       gru.make_loss_fn(cfg), AdamW(), device="cpu")
    with pytest.raises(ValueError, match="AsyncFederation"):
        api.Federation(api.FederationConfig(aggregator=Buffered()), cohort,
                       gru.make_loss_fn(cfg), AdamW(), device="cpu")
