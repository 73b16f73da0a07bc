"""The seed draws values only: the hospitals, the federation and the work a
round holds are the same for every seed."""

import numpy as np
import pytest

import tiny
from harness import cohort, common

STRUCTURE = cohort.load_structure(common.BENCH / "configs" / "gru-eicu" / "cohort.json")


def _cell(recruited: bool) -> dict:
    cell = common.find_cell("fedavg-ac")
    if recruited:
        cell["traffic"].update(federation=tiny.ARC, recruitment_check=[0.5, 0.5, 0.1])
    return cell


def test_structure_is_the_original_generators_seed_zero():
    assert cohort.derive_structure(0) == STRUCTURE


def test_structure_matches_the_programs_cohort_at_seed_zero():
    from repro_torch.data.pipeline import build_client_datasets
    from repro_torch.data.synth_eicu import generate_cohort

    clients = build_client_datasets(generate_cohort(seed=0))
    assert [c.client_id for c in clients] == [h["id"] for h in STRUCTURE["hospitals"]]
    assert [c.n_train for c in clients] == [h["n_train"] for h in STRUCTURE["hospitals"]]
    for c, h in zip(clients, STRUCTURE["hospitals"]):
        assert c.stats().counts.tolist() == h["seed0_histogram"]


@pytest.mark.parametrize("recruited, steps, real, samples", [
    (False, 264, 2316, 249_500),
    (True, 264, 872, 101_804),
])
def test_counts_a_round(recruited, steps, real, samples):
    from drivers import federated

    ids = federated.federation_ids(_cell(recruited), STRUCTURE)
    sizes = [h["n_train"] for h in cohort.select(STRUCTURE, ids)]
    assert cohort.steps_per_round(sizes, 128, 4) == (steps, real)
    assert sum(sizes) * 4 == samples


def test_arc_federation_is_nu_greedys_choice():
    from drivers import federated

    assert federated.federation_ids(_cell(True), STRUCTURE) == tiny.ARC
    assert len(tiny.ARC) == 35


def test_a_federation_that_nu_greedy_would_not_choose_is_refused():
    from drivers import federated

    cell = _cell(True)
    cell["traffic"]["federation"] = tiny.ARC[1:]
    with pytest.raises(common.RunFailed):
        federated.federation_ids(cell, STRUCTURE)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 2**31 + 17])
def test_seeds_draw_values_on_the_same_shapes(seed):
    chosen = [dict(h, n_train=max(2, h["n_train"] // 10))
              for h in cohort.select(STRUCTURE, tiny.ARC[:6])]
    base = cohort.make_hospitals(STRUCTURE, chosen, 12345, "cpu")
    got = cohort.make_hospitals(STRUCTURE, chosen, seed, "cpu")
    assert [x.shape for x, _ in got] == [x.shape for x, _ in base]
    assert [y.shape for _, y in got] == [y.shape for _, y in base]
    assert not np.array_equal(got[0][0], base[0][0])
    again = cohort.make_hospitals(STRUCTURE, chosen, seed, "cpu")
    assert all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]) for a, b in zip(got, again))
