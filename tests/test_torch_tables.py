"""The port's tables, full run and non-IID ablation against the JAX package's.

With a stand-in for ``run_setting`` (numbers that depend on the setting, the
seed, ``gamma_th`` and the cohort's ``mu_shift`` only) monkeypatched into both
packages, Tables 4 and 5, Fig. 2, the Welch p-values and stars, the markdown,
the files written and what is printed equal the reference's.  Results go
to ``tmp_path``.  Then a real, tiny ``run_table4`` runs on the CPU.
"""

import dataclasses
import json
import math
import sys

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from repro.experiments import noniid_ablation as jax_noniid  # noqa: E402
from repro.experiments import paper as jax_paper  # noqa: E402
from repro.experiments import run_full as jax_run_full  # noqa: E402
from repro.experiments import tables as jax_tables  # noqa: E402
from repro_torch.experiments import noniid_ablation, paper, run_full, tables  # noqa: E402

torch.set_num_threads(1)

SETTING_OFFSET = {s: i for i, s in enumerate(paper.MODEL_SETTINGS)}


def fake_run(setting, exp, cohort, seed, **_):
    """A stand-in for ``run_setting``: its numbers depend on the setting, the
    seed, ``gamma_th`` and the cohort's ``mu_shift`` (the ablation's)."""
    k = SETTING_OFFSET[setting] + 10 * exp.gamma_th + getattr(cohort, "hospital_mu_shift", 0.0)
    fed = None if setting == "central" else 40 + SETTING_OFFSET[setting]
    return {"setting": setting, "seed": seed, "tau_s": 100.0 / (1 + k) + seed,
            "local_steps": 50 + 7 * seed + int(3 * k), "federation_size": fed,
            "recruited": None if fed is None else fed // 2,
            "metrics": {"mae": 2.0 + 0.1 * k + 0.25 * seed * seed, "mape": 0.5 + 0.02 * k - 0.01 * seed,
                        "mse": 9.0 - k + 0.5 * seed, "msle": 0.3 + 0.01 * k + 0.013 * seed ** 1.5}}


@pytest.fixture
def stand_in(monkeypatch, tmp_path):
    """Both packages on the stand-in; each package's results in its own dir."""
    for module in (paper, jax_paper):
        monkeypatch.setattr(module, "run_setting", fake_run)
        monkeypatch.setattr(module, "build_cohort", lambda exp, seed: None)
    for module in (noniid_ablation, jax_noniid):
        monkeypatch.setattr(module, "run_setting", fake_run)
        monkeypatch.setattr(module, "generate_cohort", lambda cfg, seed: cfg)
    monkeypatch.setattr(tables, "RESULTS_DIR", tmp_path / "torch")
    monkeypatch.setattr(jax_tables, "RESULTS_DIR", tmp_path / "jax")
    return tmp_path


def same(a, b) -> bool:
    """Equal, with NaN equal to NaN (a p-value of one seed)."""
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("seeds", [[0], [0, 1], [0, 1, 2]])
def test_tables_equal_the_reference(stand_in, capsys, seeds):
    exp, jexp = paper.ExperimentConfig(device="cpu"), jax_paper.ExperimentConfig()
    t4 = tables.run_table4(exp, seeds)
    t5 = tables.run_table5(exp, seeds)
    fig2 = tables.run_fig2(exp, seeds, [0.05, 0.4])
    out = capsys.readouterr().out
    ref4 = jax_tables.run_table4(jexp, seeds)
    ref5 = jax_tables.run_table5(jexp, seeds)
    ref_fig2 = jax_tables.run_fig2(jexp, seeds, [0.05, 0.4])
    assert out == capsys.readouterr().out
    assert list(t4) == list(ref4) == list(tables.TABLE4_SETTINGS)
    assert same(t4, ref4) and same(t5, ref5) and same(fig2, ref_fig2)
    sig = t4["federated-src"]["significance_vs_sc"]
    assert set(sig) == {"mae", "mape", "mse", "msle"} and t4["federated-sc"]["significance_vs_sc"] == {}
    if len(seeds) > 1:
        assert all(0.0 <= s["p"] <= 1.0 for s in sig.values())
        assert any(s["stars"] for agg in t4.values() for s in agg["significance_vs_sc"].values())
    for t, ref in ((t4, ref4), (t5, ref5)):
        assert tables.to_markdown_table4(t) == jax_tables.to_markdown_table4(ref)


def test_save_writes_the_reference_json(stand_in):
    obj = {"a": [1.5, None], "b": {"c": "d"}}
    got, ref = tables.save(obj, "x.json"), jax_tables.save(obj, "x.json")
    assert got == stand_in / "torch" / "x.json"
    assert got.read_bytes() == ref.read_bytes()


def test_run_full_equals_the_reference(stand_in, capsys, monkeypatch):
    argv = ["--scale", "0.5", "--seeds", "0", "1", "--fig2-seeds", "1", "2"]
    run_full.main([*argv, "--device", "cpu"])
    out = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["run_full", *argv])
    jax_run_full.main()
    assert out == capsys.readouterr().out
    names = sorted(p.name for p in (stand_in / "jax").iterdir())
    assert names == ["fig2_scale0.5.json", "table4_scale0.5.json", "table5_scale0.5.json"]
    assert sorted(p.name for p in (stand_in / "torch").iterdir()) == names
    for name in names:
        assert (stand_in / "torch" / name).read_bytes() == (stand_in / "jax" / name).read_bytes()


@pytest.mark.parametrize("toxic", [False, True])
def test_noniid_ablation_equals_the_reference(stand_in, capsys, monkeypatch, toxic):
    argv = ["--scale", "0.2", "--seeds", "0", "2", "--shifts", "0.1", "0.8"]
    argv += ["--toxic-clients"] if toxic else []
    seen = {"torch": [], "jax": []}
    for module, key in ((noniid_ablation, "torch"), (jax_noniid, "jax")):
        monkeypatch.setattr(module, "generate_cohort",
                            lambda cfg, seed, key=key: seen[key].append((dataclasses.asdict(cfg), seed)) or cfg)
    noniid_ablation.main([*argv, "--device", "cpu"])
    out = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["noniid_ablation", *argv])
    jax_noniid.main()
    assert out == capsys.readouterr().out
    assert seen["torch"] == seen["jax"] and len(seen["jax"]) == 4
    assert all(tuple(cfg["hospital_noise_scale"]) == (0.7, 2.5) for cfg, _ in seen["jax"]) == toxic
    name = f"noniid_ablation_scale0.2{'_toxic' if toxic else ''}.json"
    assert (stand_in / "torch" / name).read_bytes() == (stand_in / "jax" / name).read_bytes()
    rows = json.loads((stand_in / "torch" / name).read_text())
    assert [r["mu_shift"] for r in rows] == [0.1, 0.8]
    assert all(r["src_advantage"] == r["sc_msle"] - r["src_msle"] for r in rows)


def test_a_tiny_table4_runs_on_the_cpu(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(tables, "RESULTS_DIR", tmp_path)
    exp = paper.ExperimentConfig(cohort_scale=0.005, rounds=1, local_epochs=1,
                                 central_epochs=1, device="cpu")
    t4 = tables.run_table4(exp, [0, 1])
    assert list(t4) == list(tables.TABLE4_SETTINGS)
    for name, agg in t4.items():
        assert agg["seeds"] == [0, 1] and len(agg["runs"]) == 2
        assert all(math.isfinite(v) for m in ("mae", "mape", "mse", "msle")
                   for v in agg[m]["values"])
        assert (agg["federation_size"] is None) == (name == "central")
    assert t4["federated-arc"]["federation_size"] == t4["federated-arc"]["recruited"]
    assert set(t4["central"]["significance_vs_sc"]) == {"mae", "mape", "mse", "msle"}
    table = tables.to_markdown_table4(t4)
    assert table.count("\n") == 6 and "| Federated-ARC |" in table
    assert tables.save(t4, "t4.json").exists()
