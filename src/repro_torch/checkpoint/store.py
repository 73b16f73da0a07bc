"""Tree checkpointing: npz payload + JSON manifest of the tree's leaf keys.

The port of the JAX package's ``checkpoint/store.py``, with its file names,
manifest layout and leaf keys: a leaf's key is its path, dict keys (sorted)
and list indices joined by ``"/"`` (``"layers/0/w_hh"``), as the reference's
``jax.tree_util.tree_flatten_with_path`` names them.  So the reference's
``load_pytree`` reads what :func:`save_pytree` writes here, and the other way
round.

Two storage formats live here:

* **Tree checkpoints** (``save_pytree`` / ``load_pytree``): one tree of
  tensors plus a small JSON metadata dict.  Used for model params and the
  legacy server round state.
* **Federation snapshots** (``save_federation_snapshot`` /
  ``load_federation_snapshot``): the resumable state of a live federation
  run at a round/flush boundary — several named trees (the global params
  plus every in-flight update's params/anchor), named standalone arrays
  (buffered losses and client ids), and a JSON ``state`` dict carrying
  everything scalar: round index, numpy bit-generator states, the async
  runtime's virtual-clock state and pending-event list, and the
  round-record history.  The snapshot dataclasses live with their
  runtimes (``repro_torch.federated.api.FederationSnapshot`` and
  ``repro_torch.federated.runtime.async_federation.AsyncFederationSnapshot``).

Tensors are written as ``.detach().cpu().numpy()``; on load every leaf comes
back with the dtype and on the device of the matching leaf of the ``like``
tree, bit for bit when the dtypes agree.  Both formats write atomically
(payload first, manifest second, each via ``os.replace``), so a writer
killed mid-save never leaves a half-written file.  A snapshot writer killed
*between* its two renames would pair the new payload with the previous
manifest; each snapshot's manifest and payload therefore carry one random
``payload_id``, and :func:`load_federation_snapshot` refuses a pair whose
ids differ rather than resume from the previous round's state with the next
round's params.  (The reference's loader ignores the extra entry.)
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any

import numpy as np
import torch

PyTree = Any

_MANIFEST = "manifest.json"
_PAYLOAD = "arrays.npz"
_SNAP_MANIFEST = "snapshot.json"
_SNAP_PAYLOAD = "snapshot.npz"
_PAYLOAD_ID = "payload_id"


def _paths(tree: PyTree, prefix: tuple = ()) -> list[tuple[str, Any]]:
    """``(key, leaf)`` in leaf order: dict keys sorted, list items in order."""
    if isinstance(tree, dict):
        return [e for k in sorted(tree) for e in _paths(tree[k], (*prefix, k))]
    if isinstance(tree, (list, tuple)):
        return [e for i, item in enumerate(tree) for e in _paths(item, (*prefix, i))]
    return [("/".join(str(p) for p in prefix), tree)]


def _as_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten_with_paths(tree: PyTree) -> list[tuple[str, np.ndarray]]:
    return [(key, _as_numpy(leaf)) for key, leaf in _paths(tree)]


def _restore_leaf(arr: np.ndarray, ref):
    """``arr`` as a leaf like ``ref``: its dtype, and its device for a tensor."""
    if isinstance(ref, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(device=ref.device, dtype=ref.dtype)
    return arr.astype(np.asarray(ref).dtype)


def _unflatten(like: PyTree, leaves) -> PyTree:
    """``like``'s structure filled from the iterator ``leaves`` in leaf order."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(item, leaves) for item in like)
    return next(leaves)


def _atomic_write_npz(directory: str, filename: str, payload: dict) -> None:
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".npz.tmp")
    with os.fdopen(fd, "wb") as f:  # file handle: savez must not mangle the name
        np.savez(f, **payload)
    os.replace(tmp, os.path.join(directory, filename))


def _atomic_write_json(directory: str, filename: str, obj: dict) -> None:
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".json.tmp")
    with os.fdopen(fd, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, os.path.join(directory, filename))


def save_pytree(directory: str, tree: PyTree, metadata: dict | None = None) -> None:
    """Atomic directory save: write to tmp, then rename files into place."""
    os.makedirs(directory, exist_ok=True)
    entries = _flatten_with_paths(tree)
    payload = {f"a{i}": arr for i, (_, arr) in enumerate(entries)}
    manifest = {
        "keys": [k for k, _ in entries],
        "dtypes": [str(a.dtype) for _, a in entries],
        "shapes": [list(a.shape) for _, a in entries],
        "metadata": metadata or {},
    }
    _atomic_write_npz(directory, _PAYLOAD, payload)
    _atomic_write_json(directory, _MANIFEST, manifest)


def load_pytree(directory: str, like: PyTree) -> PyTree:
    """Restore into the structure of ``like`` (validates key alignment)."""
    with open(os.path.join(directory, _MANIFEST)) as f:
        manifest = json.load(f)
    with np.load(os.path.join(directory, _PAYLOAD)) as data:
        arrays = [data[f"a{i}"] for i in range(len(manifest["keys"]))]

    entries = _paths(like)
    saved_keys = manifest["keys"]
    like_keys = [k for k, _ in entries]
    if saved_keys != like_keys:
        missing = set(like_keys) - set(saved_keys)
        extra = set(saved_keys) - set(like_keys)
        raise ValueError(f"checkpoint structure mismatch; missing={missing} extra={extra}")
    for (key, ref), arr in zip(entries, arrays):
        if list(arr.shape) != list(ref.shape):
            raise ValueError(f"shape mismatch at {key}: {arr.shape} vs {tuple(ref.shape)}")
    leaves = [_restore_leaf(a, r) for a, (_, r) in zip(arrays, entries)]
    return _unflatten(like, iter(leaves))


def checkpoint_metadata(directory: str) -> dict:
    with open(os.path.join(directory, _MANIFEST)) as f:
        return json.load(f)["metadata"]


def save_server_state(directory: str, params: PyTree, round_index: int, history: list) -> None:
    save_pytree(
        directory,
        params,
        metadata={
            "round_index": round_index,
            "history": [
                {"round": r.round_index, "loss": r.mean_local_loss, "participants": r.participant_ids}
                for r in history
            ],
        },
    )


def restore_server_state(directory: str, like_params: PyTree) -> tuple[PyTree, dict]:
    params = load_pytree(directory, like_params)
    return params, checkpoint_metadata(directory)


# ---------------------------------------------------------------------------
# federation-state snapshots
# ---------------------------------------------------------------------------


def save_federation_snapshot(
    directory: str,
    *,
    trees: dict[str, PyTree],
    arrays: dict[str, np.ndarray] | None = None,
    state: dict | None = None,
) -> None:
    """Atomically persist one federation-state snapshot.

    ``trees`` maps names to trees that all share the structure of the run's
    parameter tree — ``"params"`` plus, for async runs, each pending or
    buffered update's ``params``/``anchor``.  ``arrays`` maps names to
    standalone numpy arrays (per-update losses and client ids).  ``state``
    must be JSON-serializable; it carries the scalar run state and is
    returned verbatim by :func:`federation_snapshot_state` without touching
    the array payload.

    Each call overwrites the previous snapshot in ``directory``; payload
    first, manifest second, both via rename, so readers only ever see a
    manifest whose payload is complete.
    """
    os.makedirs(directory, exist_ok=True)
    arrays = arrays or {}
    entries: list[tuple[str, np.ndarray]] = []
    tree_manifest: dict[str, list[str]] = {}
    for name in sorted(trees):
        flat = _flatten_with_paths(trees[name])
        tree_manifest[name] = [k for k, _ in flat]
        entries.extend((f"tree:{name}:{k}", arr) for k, arr in flat)
    for name in sorted(arrays):
        entries.append((f"array:{name}", np.asarray(arrays[name])))
    payload_id = os.urandom(8).hex()
    payload = {f"a{i}": arr for i, (_, arr) in enumerate(entries)}
    payload[_PAYLOAD_ID] = np.array(payload_id)
    manifest = {
        "keys": [k for k, _ in entries],
        "dtypes": [str(a.dtype) for _, a in entries],
        "shapes": [list(a.shape) for _, a in entries],
        "trees": tree_manifest,
        "arrays": sorted(arrays),
        "state": state or {},
        _PAYLOAD_ID: payload_id,
    }
    _atomic_write_npz(directory, _SNAP_PAYLOAD, payload)
    _atomic_write_json(directory, _SNAP_MANIFEST, manifest)


def has_federation_snapshot(directory: str) -> bool:
    return os.path.exists(os.path.join(directory, _SNAP_MANIFEST)) and os.path.exists(
        os.path.join(directory, _SNAP_PAYLOAD)
    )


def federation_snapshot_state(directory: str) -> dict:
    """The snapshot's scalar ``state`` dict, without loading any arrays."""
    with open(os.path.join(directory, _SNAP_MANIFEST)) as f:
        return json.load(f)["state"]


def load_federation_snapshot(
    directory: str, like_params: PyTree
) -> tuple[dict[str, PyTree], dict[str, np.ndarray], dict]:
    """Restore ``(trees, arrays, state)`` as saved by the snapshot writer.

    Every named tree is validated against and unflattened into the
    structure of ``like_params`` (the model built from the job spec), so a
    spec/model mismatch fails loudly here; its leaves take the dtype and
    device of ``like_params``'s.  Arrays come back with their stored dtypes.
    """
    with open(os.path.join(directory, _SNAP_MANIFEST)) as f:
        manifest = json.load(f)
    with np.load(os.path.join(directory, _SNAP_PAYLOAD)) as data:
        stored_id = str(data[_PAYLOAD_ID]) if _PAYLOAD_ID in data.files else None
        if stored_id != manifest.get(_PAYLOAD_ID):
            raise ValueError(
                f"the snapshot in {directory} is torn: its payload and manifest "
                "come from two saves (a writer was killed between them)"
            )
        by_key = {k: data[f"a{i}"] for i, k in enumerate(manifest["keys"])}

    like_entries = _paths(like_params)
    like_keys = [k for k, _ in like_entries]
    trees: dict[str, PyTree] = {}
    for name, keys in manifest["trees"].items():
        if keys != like_keys:
            missing = set(like_keys) - set(keys)
            extra = set(keys) - set(like_keys)
            raise ValueError(
                f"snapshot tree {name!r} does not match the model structure; "
                f"missing={missing} extra={extra}"
            )
        leaves = []
        for key, ref in like_entries:
            arr = by_key[f"tree:{name}:{key}"]
            if list(arr.shape) != list(ref.shape):
                raise ValueError(
                    f"snapshot tree {name!r} shape mismatch at {key}: "
                    f"{arr.shape} vs {tuple(ref.shape)}"
                )
            leaves.append(_restore_leaf(arr, ref))
        trees[name] = _unflatten(like_params, iter(leaves))
    arrays = {name: by_key[f"array:{name}"] for name in manifest["arrays"]}
    return trees, arrays, manifest["state"]
