"""The port's ``checkpoint/store.py`` against the JAX package's.

The port of ``tests/test_checkpoint.py`` case by case, then:

* file compatibility both ways: the port's ``save_pytree`` file is read by
  the reference's ``load_pytree`` into ``init_gru(jax.random.key(0))``'s
  structure with equal bits, and the reference's file by the port's into the
  port's GRU tree;
* leaves come back with the ``like`` tree's dtype (and device);
* federation snapshots: trees, arrays and state round-trip bit for bit, the
  reference's ``load_federation_snapshot`` reads the port's snapshot, a
  structure or shape mismatch fails loudly, a save killed mid-write leaves
  the previous snapshot loadable, and one killed between its payload and
  its manifest leaves a pair that the load refuses.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint import store as jax_store  # noqa: E402
from repro.models import gru as jax_gru  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.checkpoint.store import (  # noqa: E402
    checkpoint_metadata,
    federation_snapshot_state,
    has_federation_snapshot,
    load_federation_snapshot,
    load_pytree,
    restore_server_state,
    save_federation_snapshot,
    save_pytree,
    save_server_state,
)
from repro_torch.federated.api import RoundRecord  # noqa: E402
from repro_torch.models import gru  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

torch.set_num_threads(1)


def torch_params(seed=0, cfg=None):
    return gru.init_gru(torch.Generator().manual_seed(seed), cfg or gru.GRUConfig(), "cpu")


def same_bits(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


# --------------------------------------------------------------------------
# the reference's cases
# --------------------------------------------------------------------------


def test_roundtrip_nested_pytree(tmp_path):
    tree = {
        "layers": [{"w": torch.arange(6.0).reshape(2, 3)}, {"w": torch.ones(3)}],
        "head": {"b": torch.tensor([1.5])},
    }
    save_pytree(str(tmp_path), tree, metadata={"round": 7})
    out = load_pytree(str(tmp_path), tree)
    assert same_bits(out, tree)
    assert checkpoint_metadata(str(tmp_path))["round"] == 7


def test_roundtrip_model_params(tmp_path):
    params = torch_params()
    save_pytree(str(tmp_path), params)
    out = load_pytree(str(tmp_path), params)
    assert same_bits(out, params)
    assert all(isinstance(t, torch.Tensor) for t in tree_leaves(out))


def test_structure_mismatch_raises(tmp_path):
    save_pytree(str(tmp_path), {"a": torch.zeros(2)})
    with pytest.raises(ValueError, match="structure mismatch"):
        load_pytree(str(tmp_path), {"b": torch.zeros(2)})


def test_shape_mismatch_raises(tmp_path):
    save_pytree(str(tmp_path), {"a": torch.zeros(2)})
    with pytest.raises(ValueError, match="shape mismatch"):
        load_pytree(str(tmp_path), {"a": torch.zeros(3)})


# --------------------------------------------------------------------------
# the file format, against the reference
# --------------------------------------------------------------------------


@pytest.mark.parametrize("num_layers", [1, 2])
def test_leaf_keys_match_the_reference(num_layers):
    jcfg = jax_gru.GRUConfig(num_layers=num_layers)
    ref = jax_store._flatten_with_paths(jax_gru.init_gru(jax.random.key(0), jcfg))
    ours = store._flatten_with_paths(torch_params(cfg=gru.GRUConfig(num_layers=num_layers)))
    assert [k for k, _ in ours] == [k for k, _ in ref]
    assert [a.shape for _, a in ours] == [a.shape for _, a in ref]
    assert [a.dtype for _, a in ours] == [a.dtype for _, a in ref]


def test_reference_reads_the_ports_file(tmp_path):
    params = torch_params(seed=3)
    save_pytree(str(tmp_path), params, metadata={"spec_hash": "x", "rounds": 2})
    like = jax_gru.init_gru(jax.random.key(0), jax_gru.GRUConfig())
    out = jax_store.load_pytree(str(tmp_path), like)
    for got, want in zip(jax.tree.leaves(out), tree_leaves(params)):
        assert np.asarray(got).tobytes() == want.numpy().tobytes()
    assert jax_store.checkpoint_metadata(str(tmp_path)) == {"spec_hash": "x", "rounds": 2}


def test_port_reads_the_references_file(tmp_path):
    ref = jax_gru.init_gru(jax.random.key(5), jax_gru.GRUConfig())
    jax_store.save_pytree(str(tmp_path), ref, metadata={"round": 1})
    out = load_pytree(str(tmp_path), torch_params())
    for got, want in zip(tree_leaves(out), jax.tree.leaves(ref)):
        assert got.dtype == torch.float32
        assert got.numpy().tobytes() == np.asarray(want).tobytes()
    assert checkpoint_metadata(str(tmp_path)) == {"round": 1}


def test_leaves_take_the_like_trees_dtype(tmp_path):
    tree = {"a": torch.arange(4, dtype=torch.float32), "b": [torch.tensor([3, 4])]}
    save_pytree(str(tmp_path), tree)
    like = {"a": torch.zeros(4, dtype=torch.float64), "b": [np.zeros(2, np.int32)]}
    out = load_pytree(str(tmp_path), like)
    assert out["a"].dtype == torch.float64 and out["a"].tolist() == [0.0, 1.0, 2.0, 3.0]
    assert isinstance(out["b"][0], np.ndarray) and out["b"][0].dtype == np.int32
    assert out["b"][0].tolist() == [3, 4]
    with open(tmp_path / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["keys"] == ["a", "b/0"] and manifest["dtypes"] == ["float32", "int64"]


def test_server_state_round_trip(tmp_path):
    params = torch_params(seed=2)
    history = [RoundRecord(i, [1, 3], 0.5 / (i + 1), 4, 8, 8, 64, 0.1) for i in range(2)]
    save_server_state(str(tmp_path), params, 2, history)
    got, meta = restore_server_state(str(tmp_path), torch_params())
    assert same_bits(got, params)
    assert meta == {"round_index": 2, "history": [
        {"round": 0, "loss": 0.5, "participants": [1, 3]},
        {"round": 1, "loss": 0.25, "participants": [1, 3]}]}
    ref_params, ref_meta = jax_store.restore_server_state(
        str(tmp_path), jax_gru.init_gru(jax.random.key(0), jax_gru.GRUConfig()))
    assert ref_meta == meta


# --------------------------------------------------------------------------
# federation snapshots
# --------------------------------------------------------------------------


def snapshot_parts(seed=0):
    rng = np.random.default_rng(seed)
    trees = {"params": torch_params(seed), "event0.params": torch_params(seed + 1),
             "event0.anchor": torch_params(seed + 2)}
    arrays = {"event0.losses": rng.normal(size=3).astype(np.float32),
              "event0.client_ids": np.array([2, 5, 7], np.int64)}
    state = {"kind": "async", "version": 3,
             "np_rng_state": np.random.default_rng(9).bit_generator.state,
             "history": [], "spec_hash": "abc"}
    return trees, arrays, state


def test_snapshot_round_trips_bit_for_bit(tmp_path):
    trees, arrays, state = snapshot_parts()
    assert not has_federation_snapshot(str(tmp_path))
    save_federation_snapshot(str(tmp_path), trees=trees, arrays=arrays, state=state)
    assert has_federation_snapshot(str(tmp_path))
    assert federation_snapshot_state(str(tmp_path)) == state
    got_trees, got_arrays, got_state = load_federation_snapshot(str(tmp_path), torch_params())
    assert sorted(got_trees) == sorted(trees)
    for name in trees:
        assert same_bits(got_trees[name], trees[name])
    for name in arrays:
        assert got_arrays[name].dtype == arrays[name].dtype
        assert got_arrays[name].tobytes() == arrays[name].tobytes()
    assert got_state == state
    # an overwrite replaces the snapshot
    trees2, arrays2, state2 = snapshot_parts(seed=4)
    save_federation_snapshot(str(tmp_path), trees={"params": trees2["params"]}, state=state2)
    got_trees, got_arrays, _ = load_federation_snapshot(str(tmp_path), torch_params())
    assert list(got_trees) == ["params"] and got_arrays == {}
    assert same_bits(got_trees["params"], trees2["params"])


def test_reference_reads_the_ports_snapshot(tmp_path):
    trees, arrays, state = snapshot_parts(seed=1)
    save_federation_snapshot(str(tmp_path), trees=trees, arrays=arrays, state=state)
    like = jax_gru.init_gru(jax.random.key(0), jax_gru.GRUConfig())
    ref_trees, ref_arrays, ref_state = jax_store.load_federation_snapshot(str(tmp_path), like)
    assert ref_state == state
    for name, tree in trees.items():
        for got, want in zip(jax.tree.leaves(ref_trees[name]), tree_leaves(tree)):
            assert np.asarray(got).tobytes() == want.numpy().tobytes()
    for name in arrays:
        assert ref_arrays[name].tobytes() == arrays[name].tobytes()


def test_snapshot_mismatches_fail_loudly(tmp_path):
    trees, arrays, state = snapshot_parts()
    save_federation_snapshot(str(tmp_path), trees=trees, arrays=arrays, state=state)
    one_layer = torch_params(cfg=gru.GRUConfig(num_layers=1))
    with pytest.raises(ValueError, match="does not match the model structure"):
        load_federation_snapshot(str(tmp_path), one_layer)
    wide = torch_params(cfg=gru.GRUConfig(hidden_dim=16))
    with pytest.raises(ValueError, match="shape mismatch"):
        load_federation_snapshot(str(tmp_path), wide)


def test_a_save_killed_between_payload_and_manifest_is_refused(tmp_path, monkeypatch):
    """A writer killed after its payload's rename and before its manifest's
    leaves the new payload beside the previous manifest: the load refuses
    the pair (their payload ids differ) rather than resume the previous
    round's state with the next round's params."""
    trees, arrays, state = snapshot_parts()
    save_federation_snapshot(str(tmp_path), trees={"params": trees["params"]}, state=state)

    def dies(*args, **kwargs):
        raise KeyboardInterrupt("killed mid-save")

    monkeypatch.setattr(store, "_atomic_write_json", dies)
    with pytest.raises(KeyboardInterrupt):
        save_federation_snapshot(str(tmp_path), trees={"params": trees["event0.params"]},
                                 state={**state, "version": 4})
    monkeypatch.undo()
    assert federation_snapshot_state(str(tmp_path))["version"] == 3
    with pytest.raises(ValueError, match="torn"):
        load_federation_snapshot(str(tmp_path), torch_params())
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_a_half_written_payload_is_never_read(tmp_path, monkeypatch):
    trees, arrays, state = snapshot_parts()
    save_federation_snapshot(str(tmp_path), trees=trees, arrays=arrays, state=state)
    real_savez = np.savez

    def dies_midway(f, **payload):
        real_savez(f, **dict(list(payload.items())[:1]))
        raise KeyboardInterrupt("killed mid-write")

    monkeypatch.setattr(np, "savez", dies_midway)
    with pytest.raises(KeyboardInterrupt):
        save_federation_snapshot(str(tmp_path), trees=trees, arrays=arrays, state=state)
    monkeypatch.undo()
    got_trees, got_arrays, got_state = load_federation_snapshot(str(tmp_path), torch_params())
    assert got_state == state and same_bits(got_trees["params"], trees["params"])


def test_restored_trees_follow_the_like_trees_device_and_dtype(tmp_path):
    trees, arrays, state = snapshot_parts()
    save_federation_snapshot(str(tmp_path), trees=trees, arrays=arrays, state=state)
    like = {k: v for k, v in torch_params().items()}
    like["head"] = {"b": torch.zeros(1, dtype=torch.float64), "w": like["head"]["w"]}
    got, _, _ = load_federation_snapshot(str(tmp_path), like)
    assert got["params"]["head"]["b"].dtype == torch.float64
    assert got["params"]["head"]["w"].device == like["head"]["w"].device
    assert float(got["params"]["head"]["b"]) == float(trees["params"]["head"]["b"])
