"""Meshes of processes for the sharded federation: the port of
``repro.launch.mesh`` on ``torch.distributed``.

The reference names the axes of one controller's devices
(``jax.make_mesh``).  The port runs one process per device -- NCCL between
cards, gloo on the CPU -- and names the axes of a
``torch.distributed.device_mesh.DeviceMesh`` the same way.  A federation
reads three things from a mesh: its batch axes (``pod``, ``data``), over
which each width bucket's node axis is split; the process group across
them (``batch_group``), on which the server step's collectives run; and
the rank's place along them (``shard_index``), pod-major as the reference
linearises ``axis_index``.

A process group comes from the launcher (``torchrun --nproc-per-node N``
sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and the rendezvous address;
the caller runs ``init_process_group``), or from ``make_local_mesh``,
which starts a one-rank group on an in-process ``HashStore`` when there
is none: no port and no network.

Functions, so importing this module touches no process group.  The
reference's ``HW`` table holds TPU v5e figures and is not carried over:
the H100's are in ``roofline/analysis.py``.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes without devices or process groups: what the
    sharding rules read (the reference's ``jax.sharding.AbstractMesh``)."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))


def make_abstract_mesh(shape, axes) -> AbstractMesh:
    if len(shape) != len(axes):
        raise ValueError(f"{len(shape)} sizes for {len(axes)} axes")
    return AbstractMesh(tuple(axes), tuple(int(s) for s in shape))


def _local_card() -> int:
    """The card of this process: ``LOCAL_RANK`` where a launcher set it,
    else the global rank modulo the cards of the host."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() % torch.cuda.device_count()


def make_mesh(shape, axes, device="cuda"):
    """A ``DeviceMesh`` with the named ``axes`` over the initialised world,
    whose size must be the product of ``shape``.  On ``cuda`` the process
    takes its own card first (``device``'s index, else ``_local_card``),
    so NCCL's communicators open on it."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; start one "
                           "(torchrun + init_process_group) or use "
                           "make_local_mesh")
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"{len(shape)} sizes for {len(axes)} axes")
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs "
                         f"{math.prod(shape)} ranks; the world has "
                         f"{dist.get_world_size()}")
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else _local_card())
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_local_mesh(device="cuda"):
    """The 1 x 1 ``("data", "model")`` mesh of one process.  Without a
    default group it starts a one-rank one on a ``HashStore``: NCCL for a
    ``cuda`` device, gloo for the CPU."""
    dev = torch.device(device)
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    return make_mesh((1, 1), ("data", "model"), dev)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The reference's production shapes: (16, 16) ``("data", "model")``,
    or (2, 16, 16) ``("pod", "data", "model")``; raises unless the world
    has that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def axis_sizes(mesh) -> dict:
    """Axis name -> size, of a ``DeviceMesh`` (``mesh_dim_names``) or of
    anything whose ``shape`` maps names to sizes (``AbstractMesh``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    shape = getattr(mesh, "shape", None)
    if not hasattr(shape, "items"):
        raise ValueError(f"{mesh!r} is not a mesh with named axes")
    return dict(shape)


def batch_axes(mesh) -> tuple:
    sizes = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def n_nodes(mesh) -> int:
    """Federated node slices: the product of the batch axes' sizes."""
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in batch_axes(mesh))


def shard_index(mesh) -> int:
    """This rank's slice of the batch axes, linearised pod-major (the
    reference's ``shard * size + axis_index`` over ``batch_axes``)."""
    sizes, coord = axis_sizes(mesh), mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    names, idx = list(sizes), 0
    for a in batch_axes(mesh):
        idx = idx * sizes[a] + coord[names.index(a)]
    return idx


def batch_group(mesh):
    """The process group across the batch axes that holds this rank: the
    whole world when the batch axes span it (``("pod", "data")``), else
    one group per index of the other axes (``("data", "model")``: one per
    ``model`` index), made with ``dist.new_group`` on every rank in the
    same order.  A group's ranks ascend with ``shard_index``, so a gather
    on it is in shard order.  Collective: every rank calls it."""
    axes = batch_axes(mesh)
    if not axes:
        raise ValueError("mesh has no batch axes to map nodes onto")
    names = list(axis_sizes(mesh))
    ranks = mesh.mesh
    inner = [names.index(a) for a in axes]
    outer = [i for i in range(ranks.dim()) if i not in inner]
    rows = ranks.permute(*outer, *inner).reshape(-1, n_nodes(mesh)).tolist()
    if any(row != sorted(row) for row in rows):
        raise ValueError("batch_group: the mesh's ranks do not ascend along "
                         "its batch axes")
    if len(rows) == 1 and len(rows[0]) == dist.get_world_size():
        return dist.group.WORLD
    me, mine = dist.get_rank(), None
    for row in rows:
        group = dist.new_group(ranks=row)
        if me in row:
            mine = group
    return mine


def mesh_device(mesh) -> torch.device:
    """The device this rank's state lives on: its card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


__all__ = ["AbstractMesh", "make_abstract_mesh", "make_mesh",
           "make_local_mesh", "make_production_mesh", "axis_sizes",
           "batch_axes", "n_nodes", "shard_index", "batch_group",
           "mesh_device"]
