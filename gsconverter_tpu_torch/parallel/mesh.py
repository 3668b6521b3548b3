"""The process-group mesh: one process per device, ranks over ``torch.distributed``.

The JAX package runs one controller over a ``Mesh`` of devices.  Here each
device has its own process, and the ranks of a process group form the
mesh.  Every rank runs the same program on the same (replicated) inputs;
a sharded function computes this rank's share of the kernel work on
``Mesh.device`` and exchanges what the JAX body exchanges through the
group (``parallel/distributed.py``).  Gloo carries the CPU tests; NCCL
carries the card.

A rank's device is ``cuda:{local_rank % device_count}`` on an NCCL group
and the CPU on any other group, unless ``make_mesh`` is given one (a gloo
group over the card passes ``device="cuda:0"``: its collectives are staged
through the host).
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the mesh: its group, rank, size, device, backend.

    ``group`` is None only for the one-process mesh of an uninitialised
    ``torch.distributed``; every collective then has nothing to exchange.
    """

    group: object
    rank: int
    size: int
    device: torch.device
    backend: str | None

    def barrier(self) -> None:
        """Wait for every rank of the group."""
        if self.group is None:
            return
        if self.backend == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index or 0])
        else:
            dist.barrier(group=self.group)


def _local_rank(rank: int) -> int:
    return int(os.environ.get("LOCAL_RANK", rank))


def make_mesh(group=None, device=None) -> Mesh:
    """The mesh over ``group`` (default: the default group) for this rank.

    Without an initialised ``torch.distributed`` this is a one-process mesh
    on ``device`` (default the card).
    """
    if not (dist.is_available() and dist.is_initialized()):
        from ..config import resolve_device

        return Mesh(None, 0, 1, resolve_device(device), None)
    group = group if group is not None else dist.group.WORLD
    rank = dist.get_rank(group)
    size = dist.get_world_size(group)
    backend = str(dist.get_backend(group))
    if device is not None:
        dev = torch.device(device)
    elif backend == "nccl":
        dev = torch.device("cuda", _local_rank(dist.get_rank()) % torch.cuda.device_count())
    else:
        dev = torch.device("cpu")
    return Mesh(group, rank, size, dev, backend)


# --------------------------------------------------------- active mesh context
#
# The pipeline takes the multi-device paths whenever a mesh of more than one
# rank is active: the analogue of the reference's automatic GPU/CPU backend
# dispatch.  ``set_active_mesh`` overrides (a specific mesh, or None to force
# the single-device ops).

_ACTIVE_MESH: Mesh | None = None
_MESH_OVERRIDDEN = False


def set_active_mesh(mesh: Mesh | None) -> None:
    """Pin the pipeline to a specific mesh (or force single-device with None)."""
    global _ACTIVE_MESH, _MESH_OVERRIDDEN
    _ACTIVE_MESH = mesh
    _MESH_OVERRIDDEN = True


def clear_active_mesh() -> None:
    """Restore automatic mesh resolution."""
    global _ACTIVE_MESH, _MESH_OVERRIDDEN
    _ACTIVE_MESH = None
    _MESH_OVERRIDDEN = False


def active_mesh() -> Mesh | None:
    """The mesh the pipeline should run on: the pinned one, else a mesh over
    the default group when ``torch.distributed`` is initialised with more
    than one rank, else None."""
    if _MESH_OVERRIDDEN:
        return _ACTIVE_MESH
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return make_mesh()
    return None


def multi_rank_mesh() -> Mesh | None:
    """The active mesh if it has more than one rank, else None."""
    mesh = active_mesh()
    return mesh if mesh is not None and mesh.size > 1 else None


def is_writer() -> bool:
    """True on the rank that writes output files: rank 0 of a multi-rank
    mesh, and every process without one."""
    mesh = multi_rank_mesh()
    return mesh is None or mesh.rank == 0


def init_multihost(backend: str | None = None) -> bool:
    """Initialise the default group from ``torchrun``'s environment
    (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``).
    Does nothing when
    ``WORLD_SIZE`` is unset or 1, or when a group exists already.  Returns
    True when it initialised the group.  ``backend`` defaults to NCCL when a
    card is visible, else gloo."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or (dist.is_available() and dist.is_initialized()):
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    rank = int(os.environ.get("RANK", "0"))
    if backend == "nccl":
        torch.cuda.set_device(_local_rank(rank) % torch.cuda.device_count())
    dist.init_process_group(backend, init_method="env://", world_size=world, rank=rank)
    return True
