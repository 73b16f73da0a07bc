"""The port's sharding rules against the JAX package's, leaf by leaf.

``launch/specs.py``'s ``params_shardings``, ``batch_shardings`` and
``cache_shardings`` (both modes) on the host (1 x 1), single-pod (16 x 16)
and multi-pod (2 x 16 x 16) meshes, the port's device-free
``AbstractMesh`` against ``jax.sharding.AbstractMesh``: every reduced arch
id at every input shape, and the full-size qwen3-1.7b, zamba2-7b and
seamless-m4t at ``decode_32k``.  Leaves are matched by their path in the
param, batch or cache tree (the port's trees have the reference's keys,
which ``params_from_jax`` relies on), and the bytes one device holds equal
the sum of the reference's ``shard_shape`` times the itemsize, exactly.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh as JaxAbstractMesh  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.distribution import sharding as jax_sharding  # noqa: E402
from repro.launch import mesh as jax_mesh  # noqa: E402
from repro.launch import specs as jax_specs  # noqa: E402
from repro.models import zoo as jax_zoo  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.distribution import sharding  # noqa: E402
from repro_torch.launch import mesh, specs  # noqa: E402
from repro_torch.launch.step_analysis import device_bytes  # noqa: E402
from repro_torch.models import zoo  # noqa: E402

torch.set_num_threads(1)

MESHES = {
    "host": (mesh.make_host_mesh(), JaxAbstractMesh((1, 1), ("data", "model"))),
    "single": (mesh.make_production_mesh(), JaxAbstractMesh((16, 16), ("data", "model"))),
    "multi": (mesh.make_production_mesh(multi_pod=True),
              JaxAbstractMesh((2, 16, 16), ("pod", "data", "model"))),
}
FULL_SIZE = ("qwen3-1.7b", "zamba2-7b", "seamless-m4t-large-v2")


def flat_specs(tree) -> dict[str, tuple]:
    """Path -> the spec's entries, for a tree of either package's shardings."""
    return {jax.tree_util.keystr(p): tuple(s.spec)
            for p, s in jax.tree_util.tree_flatten_with_path(tree)[0]}


def jax_device_bytes(tree, shardings) -> int:
    leaves = jax.tree.leaves(tree)
    shards = jax.tree.leaves(shardings, is_leaf=lambda x: hasattr(x, "spec"))
    assert len(leaves) == len(shards)
    return sum(int(np.prod(s.shard_shape(l.shape))) * l.dtype.itemsize
               for l, s in zip(leaves, shards))


@functools.cache
def configs(arch: str, shape: str | None, reduced: bool):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    if shape is not None:
        cfg = specs.config_for_shape(cfg, specs.INPUT_SHAPES[shape])
        jcfg = jax_specs.config_for_shape(jcfg, jax_specs.INPUT_SHAPES[shape])
    return cfg, jcfg


@functools.cache
def param_trees(arch: str, reduced: bool):
    cfg, jcfg = configs(arch, None, reduced)
    return specs.params_specs(zoo.Model(cfg)), jax_specs.params_specs(jax_zoo.Model(jcfg))


@functools.cache
def cache_trees(arch: str, shape: str, reduced: bool):
    cfg, jcfg = configs(arch, shape, reduced)
    return (specs.cache_specs(zoo.Model(cfg), specs.INPUT_SHAPES[shape]),
            jax_specs.cache_specs(jax_zoo.Model(jcfg), jax_specs.INPUT_SHAPES[shape]))


def check_params(arch: str, reduced: bool, mesh_kind: str) -> None:
    ours_mesh, jax_abstract = MESHES[mesh_kind]
    cfg, jcfg = configs(arch, None, reduced)
    ours, theirs = param_trees(arch, reduced)
    ours_sh = specs.params_shardings(ours, cfg, ours_mesh)
    theirs_sh = jax_specs.params_shardings(theirs, jcfg, jax_abstract)
    assert flat_specs(ours_sh) == flat_specs(theirs_sh)
    assert device_bytes(ours, ours_sh) == jax_device_bytes(theirs, theirs_sh)


def check_cache(arch: str, shape: str, reduced: bool, mesh_kind: str) -> None:
    ours_mesh, jax_abstract = MESHES[mesh_kind]
    cfg, jcfg = configs(arch, shape, reduced)
    ours, theirs = cache_trees(arch, shape, reduced)
    for mode in ("heads", "batch"):
        ours_sh = specs.cache_shardings(ours, cfg, ours_mesh, mode=mode)
        theirs_sh = jax_specs.cache_shardings(theirs, jcfg, jax_abstract, mode=mode)
        assert flat_specs(ours_sh) == flat_specs(theirs_sh), mode
        assert device_bytes(ours, ours_sh) == jax_device_bytes(theirs, theirs_sh), mode


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_reduced_param_shardings_match_jax(arch, mesh_kind):
    check_params(arch, True, mesh_kind)


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_reduced_cache_shardings_match_jax_in_both_modes(arch, mesh_kind):
    for shape in ("decode_32k", "long_500k"):
        check_cache(arch, shape, True, mesh_kind)


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_token_shardings_match_jax(arch, mesh_kind):
    ours_mesh, jax_abstract = MESHES[mesh_kind]
    for shape in specs.INPUT_SHAPES:
        cfg, jcfg = configs(arch, shape, True)
        ours_shape, theirs_shape = specs.INPUT_SHAPES[shape], jax_specs.INPUT_SHAPES[shape]
        for ours, theirs in (
            (specs.batch_specs(cfg, ours_shape), jax_specs.batch_specs(jcfg, theirs_shape)),
            ({"tokens": specs.decode_token_specs(cfg, ours_shape)["tokens"]},
             {"tokens": jax_specs.decode_token_specs(jcfg, theirs_shape)["tokens"]}),
        ):
            ours_sh = specs.batch_shardings(ours, ours_mesh)
            theirs_sh = jax_specs.batch_shardings(theirs, jax_abstract)
            assert flat_specs(ours_sh) == flat_specs(theirs_sh)
            assert device_bytes(ours, ours_sh) == jax_device_bytes(theirs, theirs_sh)


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("arch", FULL_SIZE)
def test_full_size_shardings_match_jax(arch, mesh_kind):
    check_params(arch, False, mesh_kind)
    check_cache(arch, "decode_32k", False, mesh_kind)


def test_moe_expert_split_follows_the_variant():
    """deepseek-v3's experts: over (data, model) under ``ep`` on the single
    mesh, each expert's ffn dim under ``tp``, as the reference's."""
    import dataclasses

    ours_mesh, jax_abstract = MESHES["single"]
    for sharding_mode in ("ep", "tp"):
        cfg, jcfg = configs("deepseek-v3-671b", None, True)
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, num_experts=256,
                                                               expert_sharding=sharding_mode))
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, num_experts=256,
                                                                 expert_sharding=sharding_mode))
        leaf = torch.empty((3, 256, 64, 512), device="meta")
        names = ("moe_blocks", "moe", "w_up")
        ours = specs.param_spec(names, leaf, cfg, ours_mesh)
        path = tuple(jax.tree_util.DictKey(n) for n in names)
        theirs = jax_specs.param_spec(path, jax.ShapeDtypeStruct(leaf.shape, np.float32), jcfg,
                                      jax_abstract)
        assert tuple(ours) == tuple(theirs)
        assert tuple(ours) == ((None, ("data", "model"), None, None) if sharding_mode == "ep"
                               else (None, None, None, "model"))


def test_meshes_axes_and_clean_spec_match_jax():
    for ours, theirs in MESHES.values():
        assert ours.axis_names == theirs.axis_names
        assert ours.shape == dict(theirs.shape) and ours.size == theirs.size
        assert mesh.data_axes(ours) == jax_mesh.data_axes(theirs)
        for name in ("pod", "data", "model", "bogus"):
            assert mesh.axis_size(ours, name) == jax_mesh.axis_size(theirs, name)
    host = mesh.make_host_mesh()
    assert sharding.clean_spec(("pod", "data", "bogus"), host) == sharding.P(None, "data", None)
    assert sharding.clean_spec((("pod", "data"), "model"), host) == sharding.P(("data",), "model")
    assert sharding.clean_spec(("data",), None) is None
    assert (sharding.DATA, sharding.MODEL, sharding.POD) == \
        (jax_sharding.DATA, jax_sharding.MODEL, jax_sharding.POD)


def test_shard_shape_matches_jax_and_refuses_uneven_splits():
    from jax.sharding import NamedSharding, PartitionSpec

    ours_mesh, jax_abstract = MESHES["multi"]
    spec = (None, ("pod", "data"), None, "model")
    assert sharding.shard_shape((2, 64, 3, 32), spec, ours_mesh) == \
        NamedSharding(jax_abstract, PartitionSpec(*spec)).shard_shape((2, 64, 3, 32))
    with pytest.raises(ValueError):
        sharding.shard_shape((2, 63, 3, 32), spec, ours_mesh)
    with pytest.raises(ValueError):
        NamedSharding(jax_abstract, PartitionSpec(*spec)).shard_shape((2, 63, 3, 32))
