"""The port's AdamW (repro_torch.optim.adamw) against the JAX package's.

The same params and the same gradient sequence (numpy, from a seed) go
through both for N steps; every step's params agree to 1e-5 in float32.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import adamw as jax_adamw  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-5
STEPS = 12


def tree(rng, scale=1.0):
    return {
        "layers": [
            {"w": (rng.normal(size=(3, 6)) * scale).astype(np.float32),
             "b": (rng.normal(size=(6,)) * scale).astype(np.float32)},
        ],
        "head": {"w": (rng.normal(size=(6, 1)) * scale).astype(np.float32)},
    }


@pytest.mark.parametrize(
    "clip_norm,schedule",
    [(None, None), (0.5, None), (None, (3, STEPS)), (0.5, (3, STEPS))],
)
def test_trajectory_matches_jax(clip_norm, schedule):
    rng = np.random.default_rng(0)
    params0 = tree(rng)
    grads = [tree(rng, scale=0.7) for _ in range(STEPS)]
    j_opt = jax_adamw.AdamW(
        clip_norm=clip_norm,
        schedule=None if schedule is None else jax_adamw.cosine_schedule(*schedule),
    )
    t_opt = adamw.AdamW(
        clip_norm=clip_norm,
        schedule=None if schedule is None else adamw.cosine_schedule(*schedule),
    )
    j_params = jax.tree.map(jnp.asarray, params0)
    j_state = j_opt.init(j_params)
    t_params = tree_map(lambda a: torch.tensor(a), params0)
    t_state = t_opt.init(t_params)
    for g in grads:
        j_upd, j_state = j_opt.update(jax.tree.map(jnp.asarray, g), j_state, j_params)
        j_params = jax_adamw.apply_updates(j_params, j_upd)
        t_upd, t_state = t_opt.update(tree_map(torch.tensor, g), t_state, t_params)
        t_params = adamw.apply_updates(t_params, t_upd)
        for a, b in zip(tree_leaves(t_params), jax.tree.leaves(j_params)):
            assert float(np.max(np.abs(a.numpy() - np.asarray(b)))) <= TOL
    assert t_state.step == int(j_state.step) == STEPS


def test_cosine_schedule_matches_jax():
    j = jax_adamw.cosine_schedule(3, 10, min_ratio=0.2)
    t = adamw.cosine_schedule(3, 10, min_ratio=0.2)
    for step in range(13):
        assert abs(float(t(step)) - float(j(jnp.asarray(step)))) <= 1e-6


def test_global_norm_matches_jax():
    g = tree(np.random.default_rng(1))
    ref = jax_adamw.global_norm(jax.tree.map(jnp.asarray, g))
    got = adamw.global_norm(tree_map(torch.tensor, g))
    assert abs(float(got) - float(ref)) <= TOL * max(1.0, float(ref))


def test_apply_updates_is_in_place():
    params = tree_map(torch.tensor, tree(np.random.default_rng(2)))
    before = [p.clone() for p in tree_leaves(params)]
    out = adamw.apply_updates(params, tree_map(torch.ones_like, params))
    assert out is params
    for p, b in zip(tree_leaves(params), before):
        assert torch.equal(p, b + 1)
