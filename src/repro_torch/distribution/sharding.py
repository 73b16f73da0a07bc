"""Sharding layouts without devices: axis names, partition specs, abstract meshes.

The port of the JAX package's ``distribution/sharding.py`` and of the
device-free half of ``distribution/compat.py``.  Nothing here touches a
device or a process group: a layout is a mesh's axis names and sizes and,
for each dim of a tensor, the mesh axes it is split over.  The dry run
(``launch/dryrun.py``) and the sharding rules (``launch/specs.py``) read
per-device shapes and bytes from these, as the reference reads
``NamedSharding(...).shard_shape`` on a ``jax.sharding.AbstractMesh``.

Axis conventions (the reference's):

* ``data``  — batch / tokens (and ZeRO-sharded optimizer state)
* ``model`` — heads / ffn / experts / vocab (tensor & expert parallelism)
* ``pod``   — pods; in the federated mapping, one pod = one hospital silo

Not ported: ``constrain``, a ``with_sharding_constraint`` against the
active mesh, which is a no-op without one.  The port runs no model axis
(its one mesh is the client axis of ``launch/mesh.py::DataMesh``), so
there is never an active mesh for it to act on.  Neither is the rest of
``compat.py``, which only bridges jax versions' mesh APIs (``AxisType``,
``set_mesh``, ``get_abstract_mesh``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

AxisLike = Any  # None | str | tuple[str, ...]

DATA = "data"
MODEL = "model"
POD = "pod"


class PartitionSpec(tuple):
    """One entry a tensor dim: ``None`` (replicated), an axis name, or a
    tuple of axis names (split over their product), as
    ``jax.sharding.PartitionSpec``.  ``P()`` is fully replicated; unlike a
    spec of explicit ``None``s it is not padded to the tensor's rank."""

    def __new__(cls, *entries: AxisLike) -> "PartitionSpec":
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis sizes and names, and no devices: the counterpart of
    ``jax.sharding.AbstractMesh(axis_sizes, axis_names)``."""

    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"{len(self.axis_sizes)} axis sizes for {len(self.axis_names)} names")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def _entry_axes(entry: AxisLike) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def clean_spec(spec: Sequence[AxisLike], mesh: AbstractMesh | None) -> PartitionSpec | None:
    """Drop axis names that ``mesh`` does not have (None without a mesh), so
    one spec serves the ``("data", "model")`` and ``("pod", "data",
    "model")`` meshes."""
    if mesh is None:
        return None
    names = set(mesh.axis_names)

    def _clean(axis: AxisLike) -> AxisLike:
        if axis is None:
            return None
        if isinstance(axis, (tuple, list)):
            kept = tuple(a for a in axis if a in names)
            return kept if kept else None
        return axis if axis in names else None

    return P(*(_clean(a) for a in spec))


def shard_shape(shape: Sequence[int], spec: Sequence[AxisLike], mesh: AbstractMesh) -> tuple[int, ...]:
    """The shape of one device's shard of a ``shape`` tensor laid out by
    ``spec`` on ``mesh``: each dim divided by the product of its axes' sizes.
    Raises ``ValueError`` where a dim does not divide evenly or the spec is
    longer than the shape, as ``NamedSharding.shard_shape`` does."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec!r} has more entries than shape {tuple(shape)} has dims")
    sizes = mesh.shape
    out = list(shape)
    for dim, entry in enumerate(spec):
        parts = math.prod(sizes[a] for a in _entry_axes(entry))
        if out[dim] % parts:
            raise ValueError(f"dim {dim} of {tuple(shape)} is split {parts} ways by {spec!r}, "
                             "which does not divide it")
        out[dim] //= parts
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, the counterpart of ``jax.sharding.NamedSharding``."""

    mesh: AbstractMesh
    spec: PartitionSpec

    def shard_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        return shard_shape(shape, self.spec, self.mesh)

