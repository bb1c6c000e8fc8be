"""Multi-process execution helpers.

PyTorch port of ``clarabel_tpu/parallel/distributed.py``.  JAX runs one
program over every device of a mesh; PyTorch runs one process per device,
joined in a ``torch.distributed`` process group, and a
``torch.distributed.device_mesh.DeviceMesh`` names the ranks' layout.
These helpers standardize the group's initialization and the mesh, so the
solver classes take a mesh as the JAX package's take a
``jax.sharding.Mesh``:

    from clarabel_tpu_torch.parallel import distributed as dist
    dist.initialize()                        # under torchrun: from its env
    mesh = dist.global_mesh(("batch",))      # 1-D over every rank
    mesh2 = dist.global_mesh(("batch", "rows"), shape=(H, C))

``BatchSolver(..., mesh=mesh)``, ``SparseBatchSolver(..., mesh=mesh)`` and
``ShardedRowSolver(..., mesh=mesh)`` then run on every rank, each on its
own device (``cuda:{local_rank % device_count}``, or the CPU for a mesh of
``device_type="cpu"``), and exchange what they must through the group's
collectives (``parallel/comm.py``).

The backend is named once, at :func:`initialize`: "nccl" where a CUDA
device is present, "gloo" where none is, or what the caller names (gloo
also carries CUDA tensors, and takes several ranks on one card, which NCCL
refuses).  Nothing retries with another backend or another device.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    **kwargs,
) -> None:
    """Join this process to the default process group.  Under ``torchrun``
    every argument comes from its environment (``MASTER_ADDR``,
    ``WORLD_SIZE``, ``RANK``); elsewhere pass the coordinator's
    ``host:port`` plus the process count and this process's rank.  A no-op
    once the group exists.  ``kwargs`` go to
    ``torch.distributed.init_process_group`` (``timeout=``, ...)."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is None:
        dist.init_process_group(backend=backend, init_method="env://", **kwargs)
    else:
        dist.init_process_group(
            backend=backend, init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id, **kwargs,
        )


def local_rank() -> int:
    """This process's rank among the processes of its host: ``LOCAL_RANK``
    where a launcher sets it, else its global rank."""
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


def global_mesh(
    axis_names: Sequence[str] = ("batch",),
    shape: Optional[Tuple[int, ...]] = None,
    device_type: str = "cuda",
):
    """A ``DeviceMesh`` over every rank of the default group.

    ``shape`` lays the ranks out; the default puts them all on the first
    axis.  For a 2-D (batch x rows) mesh on H hosts of C cards,
    ``shape=(H, C)`` keeps the row axis, whose all-reduces run every
    iteration, inside each host.  ``device_type="cuda"`` (the default)
    raises without a CUDA device; ``"cpu"`` builds a mesh of CPU ranks."""
    if not dist.is_initialized():
        raise RuntimeError("call distributed.initialize() before global_mesh()")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device_type='cpu' for a "
                               "mesh of CPU ranks")
        # select this rank's card before the mesh is built, so the mesh
        # does not pick one by its own rule
        torch.cuda.set_device(local_rank() % torch.cuda.device_count())
    elif device_type != "cpu":
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axis_names))


def check_mesh(mesh, ndims=(1,), who="the solver"):
    """``mesh`` if it is a ``DeviceMesh`` with one of ``ndims`` axes; raises
    otherwise (a ``TypeError`` for another object, the JAX package's
    "requires a 1-D mesh" ``ValueError`` for a mesh of the wrong rank)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"{who} takes a torch.distributed.device_mesh.DeviceMesh as mesh, "
                        f"got {type(mesh).__name__}")
    if mesh.ndim not in ndims:
        want = " or ".join(f"{d}-D" for d in ndims)
        raise ValueError(f"{who} requires a {want} mesh, got a {mesh.ndim}-D one")
    return mesh


def mesh_device(mesh) -> torch.device:
    """The device this rank of ``mesh`` computes on: its card
    (``cuda:{local_rank % device_count}``) or the CPU."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device(mesh.device_type, local_rank() % torch.cuda.device_count())


def lane_block(B: int, mesh, dim: int = 0):
    """This rank's contiguous block of a batch of ``B`` lanes split over
    mesh axis ``dim``: (first lane, lanes per rank).  ``B`` must divide the
    axis, as a ``NamedSharding`` of the batch requires in the JAX package."""
    size = mesh.size(dim)
    if B % size:
        name = mesh.mesh_dim_names[dim] if mesh.mesh_dim_names else dim
        raise ValueError(f"the batch ({B}) must divide the mesh axis {name!r} ({size})")
    per = B // size
    return mesh.get_local_rank(dim) * per, per
