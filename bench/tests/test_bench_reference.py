"""Each configuration's plain reference against the program at tiny sizes on
the CPU: a sound run is correct, and each fault the cell can have, planted
in the program under a run, makes it incorrect."""

import pytest
import torch

import tiny


@pytest.mark.parametrize("dp", [False, True])
def test_federated_program_matches_reference(tmp_path, dp):
    result, checks = tiny.run(tiny.fed_cell(tmp_path, dp))
    assert result["correct"], tiny.numbers(checks)
    assert all(c["value"] < 1e-4 for c in checks), tiny.numbers(checks)


def test_lm_train_program_matches_reference_in_float32():
    result, checks = tiny.run(tiny.lm_cell("float32"))
    assert result["correct"], tiny.numbers(checks)
    assert all(c["value"] < 1e-4 for c in checks), tiny.numbers(checks)


def test_lm_train_program_matches_reference_in_bfloat16():
    result, checks = tiny.run(tiny.lm_cell("bfloat16"))
    assert result["correct"], tiny.numbers(checks)


def _unchanged_round(monkeypatch):
    from repro_torch.federated.cohort import CohortTrainer

    real = CohortTrainer.train_cohort

    def train_cohort(self, params, *a, **k):
        _, losses, steps = real(self, params, *a, **k)
        return {key: v for key, v in params.items()}, losses, steps

    monkeypatch.setattr(CohortTrainer, "train_cohort", train_cohort)


def _half_batch_gru(monkeypatch):
    from repro_torch.models import gru

    real = gru.msle_loss

    def msle_loss(y, y_hat, mask=None):
        mask = torch.ones_like(y) if mask is None else mask.clone()
        mask[..., mask.shape[-1] // 2:] = 0.0
        return real(y, y_hat, mask)

    monkeypatch.setattr(gru, "msle_loss", msle_loss)


def _altered_answer(monkeypatch):
    """Each client's mean local loss altered by a thousandth where the cohort
    engine produces it."""
    from repro_torch.federated.cohort import CohortTrainer

    real = CohortTrainer.train_cohort

    def train_cohort(self, *a, **k):
        params, losses, steps = real(self, *a, **k)
        return params, losses * 1.001, steps

    monkeypatch.setattr(CohortTrainer, "train_cohort", train_cohort)


def _late_steps_skipped(monkeypatch):
    """Every step past the first of each local epoch left out of the resident
    plan: only a client with more than one batch (the largest) loses steps."""
    from repro_torch.federated import cohort

    real = cohort.fill_cohort_plan

    def fill_cohort_plan(sizes, batch_size, local_epochs, rng, steps_per_epoch, *a, **k):
        real(sizes, batch_size, local_epochs, rng, steps_per_epoch, *a, **k)
        step_valid = k["step_valid"] if "step_valid" in k else a[2]
        for epoch in range(local_epochs):
            step_valid[:, epoch * steps_per_epoch + 1:(epoch + 1) * steps_per_epoch] = False

    monkeypatch.setattr(cohort, "fill_cohort_plan", fill_cohort_plan)


@pytest.mark.parametrize("dp", [False, True])
@pytest.mark.parametrize("fault", [_unchanged_round, _half_batch_gru, _altered_answer])
def test_federated_faults_are_incorrect(monkeypatch, tmp_path, dp, fault):
    fault(monkeypatch)
    result, checks = tiny.run(tiny.fed_cell(tmp_path, dp))
    assert not result["correct"], tiny.numbers(checks)


def test_late_steps_of_the_largest_client_fail_the_weighted_gap(monkeypatch, tmp_path):
    _late_steps_skipped(monkeypatch)
    result, checks = tiny.run(tiny.fed_cell(tmp_path))
    failed = [c["name"] for c in checks if not c["ok"]]
    assert "loss1_weighted_gap" in failed, tiny.numbers(checks)
    assert "loss1_client_gap" not in failed, tiny.numbers(checks)


def _unchanged_step(monkeypatch):
    from repro_torch.optim.adamw import AdamW

    def update_(self, grads, state, params, coefficients=None):
        return _zeros(params)

    monkeypatch.setattr(AdamW, "update_", update_)


def _params_unwritten(monkeypatch):
    """AdamW's moments written in place, the params left as they were."""
    from repro_torch.optim.adamw import AdamW

    real = AdamW.update_

    def update_(self, grads, state, params, coefficients=None):
        return _zeros(real(self, grads, state, params, coefficients))

    monkeypatch.setattr(AdamW, "update_", update_)


def _zeros(tree):
    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    return torch.zeros_like(tree)


def _half_batch_lm(monkeypatch):
    from repro_torch.models.zoo import Model

    real = Model._chunked_ce

    def chunked_ce(self, h, head, labels):
        labels = labels.clone()
        labels[labels.shape[0] // 2:] = -1
        return real(self, h, head, labels)

    monkeypatch.setattr(Model, "_chunked_ce", chunked_ce)


def _altered_loss(monkeypatch):
    from repro_torch.models.zoo import Model

    real = Model.loss

    def loss(self, params, batch):
        total, metrics = real(self, params, batch)
        metrics = dict(metrics, ce=metrics["ce"] * 1.01)
        return total * 1.01, metrics

    monkeypatch.setattr(Model, "loss", loss)


@pytest.mark.parametrize("fault", [_unchanged_step, _half_batch_lm, _altered_loss,
                                   _params_unwritten])
def test_lm_train_faults_are_incorrect(monkeypatch, fault):
    fault(monkeypatch)
    result, checks = tiny.run(tiny.lm_cell("bfloat16"))
    assert not result["correct"], tiny.numbers(checks)


def test_params_left_unwritten_read_one_by_the_change(monkeypatch):
    _params_unwritten(monkeypatch)
    _, checks = tiny.run(tiny.lm_cell("bfloat16"))
    change = {c["name"]: c["value"] for c in checks}["change_norm_gap"]
    assert change == pytest.approx(1.0), tiny.numbers(checks)
