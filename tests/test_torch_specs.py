"""The port's ``launch/specs.py`` (the shape half) against the JAX package's.

For each of the ten arch ids and each of the four ``INPUT_SHAPES``: the
config the shape selects, and the batch, decode-token and decode-cache
specs, key for key, in shape and dtype; for each id the param specs against
``jax.eval_shape`` of ``Model.init``.  The port's specs are ``meta``
tensors: nothing is allocated, not even for deepseek-v3-671b's 671.7 B
params.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import specs as jax_specs  # noqa: E402
from repro.models import zoo as jax_zoo  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

torch.set_num_threads(1)


def flat(tree) -> dict[str, tuple]:
    """Path -> (shape, dtype name) of every leaf, JAX or torch."""
    return {jax.tree_util.keystr(p): (tuple(a.shape), str(a.dtype).split(".")[-1])
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_the_shapes_are_the_reference_shapes():
    assert {k: dataclasses.asdict(v) for k, v in specs.INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jax_specs.INPUT_SHAPES.items()}
    assert specs.LONG_CONTEXT_WINDOW == jax_specs.LONG_CONTEXT_WINDOW


@pytest.mark.parametrize("shape", list(specs.INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_token_and_cache_specs_match_jax(arch, shape):
    ours, theirs = specs.INPUT_SHAPES[shape], jax_specs.INPUT_SHAPES[shape]
    cfg = specs.config_for_shape(get_config(arch), ours)
    jcfg = jax_specs.config_for_shape(jax_get_config(arch), theirs)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    batch = specs.batch_specs(cfg, ours)
    assert all(t.device.type == "meta" for t in batch.values())
    assert flat(batch) == flat(jax_specs.batch_specs(jcfg, theirs))
    assert flat(specs.decode_token_specs(cfg, ours)) == \
        flat(jax_specs.decode_token_specs(jcfg, theirs))
    cache = specs.cache_specs(zoo.Model(cfg), ours)
    assert all(t.device.type == "meta" for t in tree_leaves(cache))
    assert flat(cache) == flat(jax_specs.cache_specs(jax_zoo.Model(jcfg), theirs))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_specs_match_jax_and_allocate_nothing(arch):
    cfg = get_config(arch)
    ours = specs.params_specs(zoo.Model(cfg))
    assert all(t.device.type == "meta" for t in tree_leaves(ours))
    assert sum(t.numel() for t in tree_leaves(ours)) == zoo.count_params_config(cfg)
    assert flat(ours) == flat(jax_specs.params_specs(jax_zoo.Model(jax_get_config(arch))))
