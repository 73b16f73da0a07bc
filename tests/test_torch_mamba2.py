"""The port's Mamba2 serving path (repro_torch.models, repro_torch.launch)
against the JAX package's zoo.

The reduced ``mamba2-130m`` config on both sides; JAX ``Model(cfg).init``
params carried across with ``params_from_jax``; the same numpy tokens.
Tolerances:

* 1e-5 times max(1, max|ref|) in float32 between the port and JAX
  (``mamba2_apply``, ``forward_logits``, the prefill step, a decode
  sequence and its cache);
* the port's own decode against its own forward at JAX's 2e-4 / 1e-4
  (tests/test_decode.py): the recurrence and the chunked form sum in
  another order;
* bfloat16 params: conversion bit for bit; the bf16 forward within
  3e-2 times max(1, max|ref|) of JAX's, as the two frameworks round bf16
  elementwise results at different places.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.models import mamba2 as jax_mamba2  # noqa: E402
from repro.models import zoo as jax_zoo  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.models import mamba2, zoo  # noqa: E402
from repro_torch.models.transformer import layer  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-5
BF16_TOL = 3e-2
ARCH = "mamba2-130m"
B, S = 2, 37  # S ragged against the reduced chunk of 16


def configs(dtype="float32"):
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(), dtype=dtype)
    tcfg = dataclasses.replace(get_config(ARCH).reduced(), dtype=dtype)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def f32():
    jcfg, tcfg = configs()
    jparams = jax.tree.map(np.asarray, jax_zoo.Model(jcfg).init(jax.random.key(0)))
    return jcfg, tcfg, jparams, zoo.params_from_jax(jparams, "cpu")


def tokens(seed=0, s=S):
    return np.random.default_rng(seed).integers(0, 512, (B, s)).astype(np.int32)


def close(got, want, tol=TOL):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    assert float(np.max(np.abs(got - want))) <= tol * max(1.0, float(np.max(np.abs(want))))


def test_configs_match_the_reference():
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(jax_get_config(ARCH))
    jcfg, tcfg = configs()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    for cfg in (get_config(ARCH), tcfg):
        assert zoo.count_params_config(cfg) == jax_zoo.count_params_config(cfg)
        assert cfg.param_count() == zoo.count_params_config(cfg)


def test_params_carry_across_key_for_key(f32):
    _, tcfg, jparams, params = f32
    assert jax.tree.structure(jparams) == jax.tree.structure(zoo.params_to_numpy(params))
    for a, t in zip(jax.tree.leaves(jparams), tree_leaves(zoo.params_to_numpy(params))):
        assert a.dtype == t.dtype and a.shape == t.shape and a.tobytes() == t.tobytes()
    own = zoo.Model(tcfg).init(torch.Generator().manual_seed(0), "cpu")
    for a, t in zip(jax.tree.leaves(jparams), tree_leaves(own)):
        assert tuple(a.shape) == tuple(t.shape)
    assert sum(int(t.numel()) for t in tree_leaves(own)) == zoo.count_params_config(tcfg)


def test_bf16_params_convert_bit_for_bit():
    jcfg, _ = configs("bfloat16")
    jparams = jax.tree.map(np.asarray, jax_zoo.Model(jcfg).init(jax.random.key(1)))
    params = zoo.params_from_jax(jparams, "cpu")
    back = zoo.params_to_numpy(params)
    for a, t, n in zip(jax.tree.leaves(jparams), tree_leaves(params), tree_leaves(back)):
        if a.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16
            assert np.array_equal(t.view(torch.int16).numpy(), a.view(np.int16))
            assert n.dtype == np.float32 and np.array_equal(n, a.astype(np.float32))
        else:
            assert a.tobytes() == t.numpy().tobytes()


@pytest.mark.parametrize("use_pallas", [False, True])
def test_mamba2_apply_matches_jax(f32, use_pallas):
    jcfg, tcfg, jparams, params = f32
    u = np.random.default_rng(2).normal(size=(B, S, tcfg.d_model)).astype(np.float32)
    jlayer = jax.tree.map(lambda a: a[0], jparams["blocks"]["mamba"])
    want = jax_mamba2.mamba2_apply(jlayer, jcfg, u, use_pallas=use_pallas)
    got = mamba2.mamba2_apply(layer(params["blocks"], 0)["mamba"], tcfg, torch.from_numpy(u))
    close(got, want)


def test_forward_logits_and_prefill_step_match_jax(f32):
    jcfg, tcfg, jparams, params = f32
    toks = tokens(3)
    jmodel = jax_zoo.Model(jcfg, use_pallas=True, remat=False)
    model = zoo.Model(tcfg)
    batch = {"tokens": torch.from_numpy(toks)}
    full = model.forward_logits(params, batch)
    close(full, jmodel.forward_logits(jparams, {"tokens": toks}))
    want = jax_steps.make_prefill_step(jmodel)(jparams, {"tokens": toks})
    got = steps.make_prefill_step(model)(params, batch)
    close(got, want)
    close(got, full[:, -1].numpy())


def decode_jax(jcfg, jparams, toks):
    jmodel = jax_zoo.Model(jcfg, remat=False)
    cache = jmodel.init_cache(B, toks.shape[1])
    outs = []
    for t in range(toks.shape[1]):
        lg, cache = jmodel.decode_step(jparams, jnp.asarray(toks[:, t : t + 1]), cache, jnp.int32(t))
        outs.append(lg)
    return np.stack(outs, axis=1), cache


def decode_port(tcfg, params, toks):
    model = zoo.Model(tcfg)
    serve_step = steps.make_serve_step(model)
    cache = model.init_cache(B, toks.shape[1], "cpu")
    toks_t = torch.from_numpy(toks)
    outs = []
    for t in range(toks.shape[1]):
        lg, cache = serve_step(params, toks_t[:, t : t + 1], cache, t)
        outs.append(lg)
    return torch.stack(outs, dim=1), cache


def test_decode_sequence_and_cache_match_jax(f32):
    jcfg, tcfg, jparams, params = f32
    toks = tokens(4, s=12)
    want, want_cache = decode_jax(jcfg, jparams, toks)
    got, cache = decode_port(tcfg, params, toks)
    close(got, want)
    for key in ("ssm_state", "conv_state"):
        close(cache["blocks"][key], want_cache["blocks"][key])


def test_own_decode_matches_own_forward(f32):
    _, tcfg, _, params = f32
    toks = tokens(5, s=20)
    full = zoo.Model(tcfg).forward_logits(params, {"tokens": torch.from_numpy(toks)})
    dec, _ = decode_port(tcfg, params, toks)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), atol=2e-4, rtol=1e-4)


def test_bf16_forward_stays_near_jax():
    jcfg, tcfg = configs("bfloat16")
    jparams = jax.tree.map(np.asarray, jax_zoo.Model(jcfg).init(jax.random.key(6)))
    params = zoo.params_from_jax(jparams, "cpu")
    toks = tokens(6)
    want = jax_steps.make_prefill_step(jax_zoo.Model(jcfg, use_pallas=True, remat=False))(
        jparams, {"tokens": toks})
    got = steps.make_prefill_step(zoo.Model(tcfg))(params, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32
    close(got, want, tol=BF16_TOL)


def test_serve_cli_runs_on_the_cpu(capsys):
    serve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "4", "--gen", "3"])
    out = capsys.readouterr().out
    assert "arch=mamba2-130m batch=2 device=cpu" in out
    assert "decode : 3 steps" in out
