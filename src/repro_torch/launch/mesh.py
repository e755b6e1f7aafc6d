"""Meshes of shards: the sharded query engine's and the models'.

The counterpart of `repro/launch/mesh.py`.  A JAX mesh lays named axes
over devices, one shard a device.  The port has two uses for a mesh:

  * stacked: a mesh's shards lie on the leading axis of tensors that one
    device holds (`repro_torch.query.distributed`; the expert-parallel
    MoE of `repro_torch.models.layers`), so a `Mesh` is the shape by
    axis name and that device;
  * per device: under `per_device(mesh)` rank 0 of a fake process group
    of `prod(shape)` ranks traces its own program, as one device of the
    production meshes (`make_production_mesh`: (data 16, model 16) and
    (pod 2, data 16, model 16)) runs it: its arguments are DTensors of
    its local shards on `meta` and its collectives are
    `torch.distributed` calls that move no data (the dry-run,
    `launch/dryrun.py`).

Nothing is placed on a device, and no process group is made, when this
module is imported.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field
from typing import Any

import torch

import repro_torch


@dataclass
class Mesh:
    """Named axes of shards, all held by `device`.  `mesh.shape[axis]`
    reads as on a JAX mesh.  While `per_device(mesh)` is open,
    `root_mesh` is the fake process group's `DeviceMesh` with the mesh's
    axes and `device_mesh` the one its DTensors are laid on (`pod` and
    `data` merged into one dim "pod.data" where both exist); else None."""

    shape: dict[str, int]
    device: torch.device
    device_mesh: Any = field(default=None, compare=False, repr=False)
    root_mesh: Any = field(default=None, compare=False, repr=False)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.shape)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device=None) -> Mesh:
    """A mesh of `shape` over `axes`; `device` resolves as every entry
    point's does (`repro_torch.device`: the card unless "cpu" is asked)."""
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} must pair one to "
                         f"one, each axis named once")
    if any(int(n) < 1 for n in shape):
        raise ValueError(f"every axis needs at least one shard: {shape}")
    return Mesh({a: int(n) for a, n in zip(axes, shape)},
                repro_torch.device(device))


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The JAX dry-run's mesh: (data 16, model 16), 256 chips, or with
    `multi_pod` (pod 2, data 16, model 16), 512; the `pod` axis carries
    data parallelism only.  `device` resolves as `make_mesh`'s."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


@contextlib.contextmanager
def per_device(mesh: Mesh):
    """Rank 0 of `prod(mesh.shape)` ranks of the "fake" backend (its
    collectives return at once and move nothing), with a `DeviceMesh` of
    the mesh's axes on the CPU; yields that `DeviceMesh` and sets
    `mesh.root_mesh` and `mesh.device_mesh` until exit, when the group is
    destroyed.  Refuses to start while a process group is initialised.

    The DTensors of a mesh with both `pod` and `data` are laid on a mesh
    of one dim fewer, "pod.data" of pod x data ranks (pod major, as
    JAX's ("pod", "data") split orders them): every rule table splits
    over the two together, and DTensor (in some torch versions) plans
    redistributions over two mesh dims of one tensor dim by a search
    that takes seconds an op."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.distributed import sharding

    if dist.is_initialized():
        raise RuntimeError("per_device needs no process group to be "
                           "initialised: one already is")
    sharding.register_rules()
    world = math.prod(mesh.shape.values())
    dist.init_process_group("fake", rank=0, world_size=world,
                            store=FakeStore())
    try:
        root = init_device_mesh("cpu", tuple(mesh.shape.values()),
                                mesh_dim_names=mesh.axis_names)
        layout = root
        names = mesh.axis_names
        if names[:2] == ("pod", "data"):
            layout = init_device_mesh(
                "cpu", (mesh.shape["pod"] * mesh.shape["data"],)
                + tuple(mesh.shape[a] for a in names[2:]),
                mesh_dim_names=("pod.data",) + names[2:])
        mesh.root_mesh, mesh.device_mesh = root, layout
        yield root
    finally:
        mesh.root_mesh = mesh.device_mesh = None
        dist.destroy_process_group()


def make_host_mesh(ndev: int | None = None, axis: str = "data",
                   device=None) -> Mesh:
    """A 1-D mesh of `ndev` shards; by default one shard a visible
    device, as `len(jax.devices())`: `torch.cuda.device_count()` on the
    card, 1 on the CPU."""
    dev = repro_torch.device(device)
    n = ndev or (torch.cuda.device_count() if dev.type == "cuda" else 1)
    return make_mesh((n,), (axis,), dev)


def data_axis_names(mesh: Mesh) -> tuple[str, ...]:
    """Axes used for batch sharding: ('pod','data') when a pod axis exists."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))
