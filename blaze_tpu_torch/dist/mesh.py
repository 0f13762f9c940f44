"""Mesh bootstrap on torch.distributed: the multi-card management layer the
reference leaves unimplemented (connection pooling and multi-card state
machines are "for the management layer", blaze README).

Port of blaze_tpu/dist/mesh.py.  One torch.distributed process group, one
process per card, replaces the JAX package's single-process device mesh;
NCCL collectives (gloo on the CPU) replace XLA's over ICI.  A DeviceMesh
names the group's ranks by axis, e.g. {'dp': 4, 'sp': 2}; the sharded paths
(msm_dist.py, ntt_dist.py) run the collectives on one axis's sub-group.

JAX builds a single-process mesh with no bootstrap; a DeviceMesh needs a
process group.  So when none exists, `make_mesh` makes a group of one rank
from an in-process store (HashStore), on the mesh's backend, and the
single-card path needs no environment variables.  A mesh spans every rank
of the group (the JAX mesh may take the first n of more devices: here each
rank is a process, and a rank outside the mesh would have nothing to run).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from ..utils.errors import DeviceError

__all__ = ["init_distributed", "make_mesh", "shard_leading", "replicated"]

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _backend(device_type: str) -> str:
    if device_type not in BACKENDS:
        raise ValueError(f"unsupported mesh device type {device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise DeviceError("no CUDA device for a cuda mesh; pass device_type='cpu'")
    return BACKENDS[device_type]


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device_type: str = "cuda") -> None:
    """Multi-process bootstrap: join the process group of `num_processes`
    ranks as rank `process_id`, meeting at `coordinator` ("host:port" or a
    torch init URL such as "tcp://host:port").  NCCL for a cuda mesh (the
    process takes card process_id mod the cards it sees), gloo for a cpu
    one.  No-op for coordinator=None (a single process: make_mesh makes its
    group of one)."""
    if coordinator is None:
        return
    backend = _backend(device_type)
    if device_type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=url, world_size=num_processes,
                            rank=process_id)


def make_mesh(axes: dict, device_type: str = "cuda") -> DeviceMesh:
    """Named mesh over the process group's ranks, e.g. make_mesh({'dp': 4,
    'sp': 2}) on 8 ranks: a DeviceMesh whose mesh_dim_names are the keys,
    rank r at the row-major position r.  Without a process group, one of a
    single rank is made first (HashStore, NCCL for cuda, gloo for cpu).
    Raises ValueError when the mesh wants another number of ranks than the
    group has, or the group's backend does not serve `device_type`."""
    names = tuple(axes)
    shape = tuple(int(v) for v in axes.values())
    if not names or min(shape) < 1:
        raise ValueError(f"mesh {axes}: want named axes of size >= 1")
    backend = _backend(device_type)
    if not dist.is_initialized():
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    n = math.prod(shape)
    if n > world:
        raise ValueError(f"mesh {axes} wants {n} ranks, have {world}")
    if n < world:
        raise ValueError(f"mesh {axes} spans {n} of the group's {world} ranks: a mesh "
                         f"spans every rank")
    if backend not in str(dist.get_backend()):
        raise ValueError(f"the process group runs {dist.get_backend()}, a {device_type} "
                         f"mesh needs {backend}")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=names)


def shard_leading(mesh: DeviceMesh, axis: str) -> tuple:
    """DTensor placements that split the leading dimension over one mesh
    axis and replicate over the others (JAX: NamedSharding(mesh, P(axis)))."""
    if axis not in mesh.mesh_dim_names:
        raise ValueError(f"no axis {axis!r} in mesh {mesh.mesh_dim_names}")
    return tuple(Shard(0) if name == axis else Replicate() for name in mesh.mesh_dim_names)


def replicated(mesh: DeviceMesh) -> tuple:
    """DTensor placements that replicate over every mesh axis."""
    return (Replicate(),) * mesh.ndim


# ------------------------------------------------- the sharded paths' plumbing
def mesh_axis(mesh: DeviceMesh, axis: str):
    """(process group, size, this rank's coordinate) of one mesh axis."""
    if axis not in mesh.mesh_dim_names:
        raise ValueError(f"no axis {axis!r} in mesh {mesh.mesh_dim_names}")
    dim = mesh.mesh_dim_names.index(axis)
    return mesh.get_group(axis), mesh.size(dim), mesh.get_local_rank(axis)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's tensors of the mesh live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def all_gather(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """(size, *x.shape): every rank's x, in rank order along the axis."""
    out = torch.empty((size * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
    # all_gather_single where torch has it (all_gather_into_tensor is
    # deprecated in its favour); the same collective either way
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, x.contiguous(), group=group)
    return out.view(size, *x.shape)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Block e of x's leading dimension (of `size` equal blocks) goes to
    rank e; block e of the result came from rank e."""
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out
