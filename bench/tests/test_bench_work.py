"""The frozen arithmetic against hand values."""

import json

import pytest

from harness import common, work


def test_gru_eicu_params():
    import torch

    ref = common.load_module(common.BENCH / "configs" / "gru-eicu" / "reference.py", "gru_ref")
    cfg = common.load_json(common.BENCH / "configs" / "gru-eicu" / "config.json")
    model = {k: cfg[k] for k in ("input_dim", "hidden_dim", "num_layers", "dropout")}
    params = ref.init_params(model, 3, "cpu")
    n = sum(ref.get(params, k).numel() for k in ref.leaf_names(2))
    assert n == cfg["params"] == 13_281
    assert all(ref.get(params, k).dtype == torch.float32 for k in ref.leaf_names(2))


def test_mamba2_params():
    from repro_torch.configs import get_config
    from repro_torch.models.zoo import count_params_config

    ref = common.load_module(common.BENCH / "configs" / "mamba2-130m" / "reference.py", "m_ref")
    cfg = common.load_json(common.BENCH / "configs" / "mamba2-130m" / "config.json")
    k = ref.dims(cfg)
    per_layer = (cfg["d_model"] * k["proj"] + cfg["d_conv"] * k["conv"] + k["conv"]
                 + 3 * k["heads"] + k["d_in"] + k["d_in"] * cfg["d_model"] + cfg["d_model"])
    total = cfg["vocab_size"] * cfg["d_model"] + cfg["d_model"] + cfg["n_layer"] * per_layer
    assert total == cfg["params"] == 128_983_488
    assert count_params_config(get_config("mamba2-130m")) == total


def test_gru_bounds_at_189_clients():
    fb, fo, bb, bo = work.gru_work(128, 24, 32)
    assert 189 * max(fb / work.PEAK_BYTES_PER_S, fo / work.PEAK_F32_FLOPS) * 1e3 == pytest.approx(0.0895, abs=5e-5)
    assert 189 * max(bb / work.PEAK_BYTES_PER_S, bo / work.PEAK_F32_FLOPS) * 1e3 == pytest.approx(0.179, abs=5e-4)


def test_gru_round_bound_counts_real_rows_only():
    # one client-step of 128 rows, one layer: the forward and backward bounds above over 189
    one = work.gru_round_bound_s(128, 1, 24, 32, 1)
    fb, fo, bb, bo = work.gru_work(128, 24, 32)
    assert one == pytest.approx(work.bound_s(fb, fo) + work.bound_s(bb, bo))
    # padding rows are not work: 100 real rows cost less than 128
    assert work.gru_round_bound_s(100, 1, 24, 32, 1) < one


def test_frozen_copy_equals_the_programs_today():
    from repro_torch.kernels import work as program_work

    assert work.gru_work(128, 24, 32) == program_work.gru_work(128, 24, 32)
    shape = (8, 8, 256, 24, 64, 128)
    assert work.ssd_work(*shape) == program_work.ssd_work(*shape)
    assert work.ssd_bwd_work(*shape) == program_work.ssd_bwd_work(*shape)
    assert work.PEAK_F32_FLOPS == program_work.PEAK_F32_FLOPS
    assert json.dumps(work.tensor_core_ms(10, 5, 2, 2)) == json.dumps(program_work.tensor_core_ms(10, 5, 2, 2))
