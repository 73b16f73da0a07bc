"""The federated client axis over several processes: a 1-D ``("data",)`` mesh.

The port of the JAX package's ``launch/mesh.py``.  The reference shards the
cohort engine's client axis over a ``jax.sharding.Mesh`` with
``shard_map`` and folds the round's FedAvg into one ``psum``.  Here the
axis is a ``torch.distributed`` process group, SPMD as ``shard_map`` is:
every rank runs the same program on the same config, trains its block of
the round's participants, and the round's FedAvg accumulator is summed
across ranks by one all-reduce.

* The caller creates the process group (``torchrun`` and
  ``init_process_group``, a test, ``chip_smoke.py``); nothing in the port
  creates one.  ``"auto"`` resolves to the default group's world when a
  group of more than one rank is initialized and to ``None`` otherwise, the
  counterpart of ``make_data_mesh() if jax.device_count() > 1 else None``:
  in one process ``"auto"`` is the run without a mesh, bit for bit.
* The backend is the caller's choice: NCCL with one GPU a rank, or gloo for
  the CPU and for several ranks sharing one card.  Under gloo the
  all-reduce here copies a CUDA tensor to the host and back (gloo's own
  CUDA paths are not relied on); under any other backend the tensor goes to
  the collective as it is.  There is no fallback from one backend to
  another.
* The block layout is the reference's: ``n`` clients are padded to a
  multiple of the axis size and cut into contiguous blocks, rank ``k``
  taking block ``k`` (``block_of``).

The production meshes of the reference, without devices:
``make_production_mesh`` ((16, 16) over ``("data", "model")``, or (2, 16,
16) over ``("pod", "data", "model")``) and ``make_host_mesh`` ((1, 1))
return a ``distribution/sharding.py::AbstractMesh``, which the sharding
rules (``launch/specs.py``) and the dry run (``launch/dryrun.py``) read
through ``data_axes`` and ``axis_size``.  No program runs on them: the
port executes no model axis.

What of the reference has no counterpart, and why:

* ``distribution/compat.py``'s version shims over jax's mesh APIs.
* ``distribution/sharding.py::constrain``: a sharding constraint that is a
  no-op on one device; a process group needs none.
* The ``("pod", "data")`` mesh of ``federated/api.py``'s hierarchical
  aggregator, a region to a pod: the port's mesh is 1-D, and a grouped
  aggregator's regions are trained one after another, one all-reduce each.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.distribution.sharding import AbstractMesh


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """A process group as the ``"data"`` axis: this process's ``rank`` of
    ``size``."""

    group: Any                 # a torch.distributed ProcessGroup
    rank: int
    size: int

    @property
    def backend(self) -> str:
        return str(dist.get_backend(self.group))


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The reference's TPU pod layouts: 256 chips as (16, 16) over
    ``("data", "model")``, or 512 as (2, 16, 16) over ``("pod", "data",
    "model")``."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def make_host_mesh() -> AbstractMesh:
    """The one-device layout, (1, 1) over ``("data", "model")``."""
    return AbstractMesh((1, 1), ("data", "model"))


def data_axes(mesh: AbstractMesh) -> tuple[str, ...]:
    """Axes that carry the batch: ('pod','data') on multi-pod, ('data',) else."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def axis_size(mesh: AbstractMesh, name: str) -> int:
    """The size of axis ``name``, 1 where the mesh lacks it."""
    return mesh.shape.get(name, 1)


def make_data_mesh(group: Any = None) -> DataMesh:
    """A ``DataMesh`` over ``group`` (default: the default group's world).

    Raises ``RuntimeError`` when no process group is initialized.  A rank
    trains on its trainer's ``device``: on the card, the current CUDA
    device, which the launcher sets from ``LOCAL_RANK``.
    """
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no torch.distributed process group is initialized; create one "
            "(torchrun and init_process_group) before asking for a data mesh"
        )
    group = dist.group.WORLD if group is None else group
    return DataMesh(group=group, rank=dist.get_rank(group), size=dist.get_world_size(group))


def resolve_mesh(mesh: Any) -> DataMesh | None:
    """``None``, ``"auto"`` or a ``DataMesh`` -> a ``DataMesh`` or ``None``.

    ``"auto"`` is the default group's world when more than one rank is
    initialized, else ``None``.
    """
    if mesh is None or isinstance(mesh, DataMesh):
        return mesh
    if isinstance(mesh, str):
        if mesh != "auto":
            raise ValueError(f"mesh must be a DataMesh, None, or 'auto'; got {mesh!r}")
        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            return make_data_mesh()
        return None
    raise TypeError(f"mesh must be a DataMesh, None, or 'auto'; got {type(mesh).__name__}")


def is_writer(mesh: DataMesh | None) -> bool:
    """Whether this process writes a run's files: rank 0, or the only process."""
    return mesh is None or mesh.rank == 0


def block_of(n: int, mesh: DataMesh | None, rank: int | None = None) -> range:
    """The positions of ``rank``'s block (default: this process's) of ``n``
    clients: ``n`` padded to a multiple of the axis size, cut into
    contiguous blocks, block ``k`` to rank ``k``; padding positions are
    dropped, so a block may be short or empty."""
    if mesh is None:
        return range(n)
    k = mesh.rank if rank is None else rank
    width = -(-n // mesh.size)
    return range(min(k * width, n), min((k + 1) * width, n))


def barrier(mesh: DataMesh) -> None:
    """Wait until every rank of the mesh is here."""
    dist.barrier(group=mesh.group)


def _host_if_gloo(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    return t.cpu() if t.is_cuda and mesh.backend == "gloo" else t


def all_reduce_sum_(flat: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Sum ``flat`` over the mesh's ranks, in place; returns it."""
    buf = _host_if_gloo(flat, mesh)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    if buf is not flat:
        flat.copy_(buf)
    return flat
