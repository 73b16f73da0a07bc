"""The port's masked-sum secure aggregation against the JAX package's.

The fixed-point quantization, the pair masks, the ring offsets, the
masked client tensors, the recovered masked sum and the surviving clients
are bit-equal to the reference's on the same inputs; ``SecAggFedAvg``'s
result equals the reference's bit for bit and lies within the
quantization bound of FedAvg; a secagg federation (the per-client
trainer) matches the reference's (dropout 0) and the port's own FedAvg.
The dropout models it draws survivors from (``federated/runtime/
latency.py``) are the reference's copy.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data.pipeline import build_client_datasets as jax_clients  # noqa: E402
from repro.data.synth_eicu import CohortConfig as JaxCohortConfig  # noqa: E402
from repro.data.synth_eicu import generate_cohort as jax_generate  # noqa: E402
from repro.federated.api import Federation as JaxFederation  # noqa: E402
from repro.federated.api import FederationConfig as JaxFederationConfig  # noqa: E402
from repro.federated.runtime import latency as jax_latency  # noqa: E402
from repro.models import gru as jax_gru  # noqa: E402
from repro.optim.adamw import AdamW as JaxAdamW  # noqa: E402
from repro.privacy import secagg as jax_secagg  # noqa: E402
from repro_torch.data.pipeline import build_client_datasets  # noqa: E402
from repro_torch.data.synth_eicu import CohortConfig, generate_cohort  # noqa: E402
from repro_torch.federated.api import (  # noqa: E402
    Federation,
    FederationConfig,
    available_policies,
    resolve_aggregator,
)
from repro_torch.federated.runtime import latency  # noqa: E402
from repro_torch.models import gru  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.privacy import secagg  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

torch.set_num_threads(1)

COHORT = dict(num_hospitals=6, total_stays=240, min_hospital_size=10)


def values(c, size, seed, scale=1.0):
    return np.random.default_rng(seed).normal(size=(c, size)) * scale


@pytest.mark.parametrize("bits", [1, 16, 24, 52])
def test_quantization_is_the_references(bits):
    v = values(5, 17, seed=bits, scale=3.0)
    q = secagg.quantize_leaf(v, bits)
    ref = jax_secagg.quantize_leaf(v, bits)
    assert q.dtype == ref.dtype == np.uint64 and q.tobytes() == ref.tobytes()
    total = q.sum(axis=0, dtype=np.uint64)
    assert secagg.dequantize_total(total, bits).tobytes() == \
        jax_secagg.dequantize_total(total, bits).tobytes()


@pytest.mark.parametrize("c,neighbors", [(1, 8), (2, 8), (7, 3), (12, 8), (30, 8)])
def test_ring_offsets_and_pair_masks_are_the_references(c, neighbors):
    offsets = secagg.ring_offsets(c, neighbors)
    assert offsets == jax_secagg.ring_offsets(c, neighbors)
    for d in offsets:
        assert secagg.pair_masks(3, 2, d, c, 11).tobytes() == \
            jax_secagg.pair_masks(3, 2, d, c, 11).tobytes()


@pytest.mark.parametrize("survivors", [
    [1, 1, 1, 1, 1, 1, 1], [1, 0, 1, 1, 0, 1, 1], [0, 0, 0, 0, 0, 0, 1], [0, 1, 1, 1, 1, 1, 0],
])
def test_masked_tensors_and_sum_are_the_references(survivors):
    q = secagg.quantize_leaf(values(7, 33, seed=0), 24)
    offsets = secagg.ring_offsets(7, 3)
    masked = secagg.masked_client_tensors(q, 5, 2, offsets)
    assert masked.tobytes() == jax_secagg.masked_client_tensors(q, 5, 2, offsets).tobytes()
    surv = np.asarray(survivors, bool)
    total = secagg.masked_sum(masked, surv, 5, 2, offsets)
    assert total.tobytes() == jax_secagg.masked_sum(masked, surv, 5, 2, offsets).tobytes()
    # and it is the survivors' quantized sum, bit for bit
    np.testing.assert_array_equal(total, q[surv].sum(axis=0, dtype=np.uint64))


def test_masked_sum_rejects_what_the_reference_rejects():
    masked = secagg.masked_client_tensors(secagg.quantize_leaf(values(4, 3, 1), 24), 0, 0, [1])
    for m in (secagg, jax_secagg):
        with pytest.raises(RuntimeError, match="dropped"):
            m.masked_sum(masked, np.zeros(4, bool), 0, 0, [1])
        with pytest.raises(ValueError, match="shape"):
            m.masked_sum(masked, np.ones(3, bool), 0, 0, [1])


def stacked_pair(c, seed):
    """One client-stacked tree as numpy arrays, and the port's tensors of it."""
    rng = np.random.default_rng(seed)
    tree = {"w": rng.normal(size=(c, 5, 3)).astype(np.float32),
            "b": rng.normal(size=(c, 4)).astype(np.float32),
            "layers": [{"u": rng.normal(size=(c, 2, 6)).astype(np.float32)}]}
    weights = rng.uniform(1.0, 5.0, size=c).astype(np.float32)
    return tree, weights


@pytest.mark.parametrize("dropout", ["never", 0.3, "bernoulli:0.5"])
def test_secagg_fedavg_is_the_references_round_after_round(dropout):
    c = 9
    ours = secagg.SecAggFedAvg(dropout=dropout, neighbors=3, seed=4)
    ref = jax_secagg.SecAggFedAvg(dropout=dropout, neighbors=3, seed=4)
    for rnd in range(3):
        tree, weights = stacked_pair(c, seed=rnd)
        got = ours.aggregate(jax.tree.map(torch.from_numpy, tree), weights)
        want = ref.aggregate(jax.tree.map(jnp.asarray, tree), jnp.asarray(weights))
        np.testing.assert_array_equal(ours.last_survivors, ref.last_survivors)
        for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
            assert g.dtype == torch.float32
            assert g.numpy().tobytes() == np.asarray(w).tobytes()
    ours.reset_round(1)
    ref.reset_round(1)
    tree, weights = stacked_pair(c, seed=1)
    ours.aggregate(jax.tree.map(torch.from_numpy, tree), weights)
    ref.aggregate(jax.tree.map(jnp.asarray, tree), jnp.asarray(weights))
    np.testing.assert_array_equal(ours.last_survivors, ref.last_survivors)


def test_secagg_is_fedavg_within_the_quantization_bound():
    c = 9
    tree, weights = stacked_pair(c, seed=7)
    agg = secagg.SecAggFedAvg()
    stacked = jax.tree.map(torch.from_numpy, tree)
    out = agg.aggregate(stacked, weights)
    plain = agg.reference_aggregate(stacked, weights)
    bound = c / 2 ** (agg.fraction_bits + 1) * float(weights.max()) / float(weights.sum()) + 1e-6
    for a, b in zip(tree_leaves(out), tree_leaves(plain)):
        assert float((a - b).abs().max()) <= bound
    with pytest.raises(ValueError, match="weights"):
        agg.aggregate(stacked, -weights)


def test_secagg_spec_forms_and_registry():
    assert {"secagg-fedavg", "krum"} <= set(available_policies()["aggregator"])
    plain = resolve_aggregator("secagg-fedavg")
    assert isinstance(plain, secagg.SecAggFedAvg) and plain.mode == "stacked"
    assert isinstance(plain.dropout_model, latency.NeverDropout)
    prob = resolve_aggregator("secagg-fedavg:0.2")
    assert isinstance(prob.dropout_model, latency.BernoulliDropout) and prob.dropout_model.p == 0.2
    named = resolve_aggregator("secagg-fedavg:bernoulli:0.1")
    assert isinstance(named.dropout_model, latency.BernoulliDropout)
    for m in (secagg, jax_secagg):
        with pytest.raises(ValueError, match="neighbor"):
            m.SecAggFedAvg(neighbors=0)
        with pytest.raises(ValueError, match="fraction_bits"):
            m.SecAggFedAvg(fraction_bits=64)


def test_runtime_models_are_the_references():
    assert latency.available_runtime_models() == jax_latency.available_runtime_models()
    rng_a, rng_b = np.random.default_rng(3), np.random.default_rng(3)
    for spec in ("constant:2.0", "lognormal:0.5", "pareto:1.5,2.0", "trace:0.01,0.1"):
        a, b = latency.resolve_latency(spec), jax_latency.resolve_latency(spec)
        assert [a.sample(i % 3, 10 * i, rng_a) for i in range(6)] == \
            [b.sample(i % 3, 10 * i, rng_b) for i in range(6)]
        assert a.state_dict() == b.state_dict() and a.zero_spread == b.zero_spread
    bern, ref = latency.resolve_dropout(0.4), jax_latency.resolve_dropout(0.4)
    assert [bern.drops(i, rng_a) for i in range(20)] == [ref.drops(i, rng_b) for i in range(20)]
    with pytest.raises(ValueError, match="unknown dropout"):
        latency.resolve_dropout("sometimes")


@functools.lru_cache(maxsize=1)
def port_runs():
    cfg = gru.GRUConfig(hidden_dim=8, num_layers=1, dropout=0.0)
    jcfg = jax_gru.GRUConfig(hidden_dim=8, num_layers=1, dropout=0.0)
    init = jax.tree.map(np.asarray, jax_gru.init_gru(jax.random.key(0), jcfg))
    config = dict(rounds=2, local_epochs=1, batch_size=16, seed=0,
                  recruitment="top-n-samples:5")
    runs = {
        agg: Federation(FederationConfig(**config, aggregator=agg, engine="sequential"),
                        build_client_datasets(generate_cohort(CohortConfig(**COHORT), seed=3)),
                        gru.make_loss_fn(cfg), AdamW(1e-2), device="cpu")
        .run(gru.params_from_jax(init, "cpu"))
        for agg in ("fedavg", "secagg-fedavg")
    }
    ref = JaxFederation(
        JaxFederationConfig(**config, aggregator="secagg-fedavg", engine="sequential"),
        jax_clients(jax_generate(JaxCohortConfig(**COHORT), seed=3)),
        jax_gru.make_loss_fn(jcfg), JaxAdamW(learning_rate=1e-2),
    ).run(init)
    return runs, ref


def test_secagg_run_matches_the_reference_and_fedavg():
    runs, ref = port_runs()
    got = runs["secagg-fedavg"]
    for g, r in zip(got.history, ref.history):
        assert g.participant_ids == r.participant_ids
        assert abs(g.mean_local_loss - r.mean_local_loss) <= 1e-5
    for a, b in zip(tree_leaves(got.params), jax.tree.leaves(ref.params)):
        assert float(np.max(np.abs(a.numpy() - np.asarray(b)))) <= 1e-4
    for a, b in zip(tree_leaves(got.params), tree_leaves(runs["fedavg"].params)):
        assert float((a - b).abs().max()) < 1e-5
