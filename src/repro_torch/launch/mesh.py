"""Meshes of shards: the sharded query engine's and the models'.

The counterpart of `make_mesh`, `make_host_mesh` and `data_axis_names`
in `repro/launch/mesh.py` (`make_production_mesh`, the 256- and
512-chip meshes, waits with the multi-pod dry-run).  A JAX mesh lays
named axes over devices, one shard a device.  The port stacks a mesh's
shards on the leading axis of tensors that one device holds
(`repro_torch.query.distributed`; the expert-parallel MoE of
`repro_torch.models.layers`), so a `Mesh` here is the shape by axis name
and that device.  Nothing is placed on a device when this module is
imported.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

import repro_torch


@dataclass
class Mesh:
    """Named axes of shards, all held by `device`.  `mesh.shape[axis]`
    reads as on a JAX mesh."""

    shape: dict[str, int]
    device: torch.device

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
