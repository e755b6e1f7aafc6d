"""Logical-axis sharding: one rules table maps logical axes to mesh axes.

Twin of `repro/distributed/sharding.py`.  Params and activations carry
logical axis names ('embed', 'heads', 'mlp', 'vocab', 'expert', 'batch',
'seq', ...); a RULES dict maps them onto the axes of a mesh.  Changing
the distribution strategy = changing the table.

A mesh of the port is `ndev` shards stacked on one device
(`repro_torch.launch.mesh.Mesh`).  `PartitionSpec` and `NamedSharding`
here are the small counterparts of JAX's: a sharding names how a leaf
splits over the mesh and checks that it splits evenly
(`NamedSharding.shard_shape`), while the leaf itself stays whole on the
mesh's device.  Shardings live in trees parallel to the tensor trees;
they are never attributes of tensors.

`axis_ctx` threads (mesh, rules) to the model code.  Inside it
`shard_act` resolves an activation's spec and returns the activation
unchanged (a constraint changes no value), and `moe` takes the
expert-parallel path (`models/layers.py::_moe_expert_parallel`).  JAX's
`shard_map_compat` has no counterpart: the one `shard_map` on this path,
the expert-parallel MoE body, is computed for all (data, expert) shards
at once on the stacked axis, its `all_gather` and `psum` becoming a
whole-width product and a sum over the expert index.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Any

from repro_torch.launch.mesh import Mesh
from repro_torch.models.params import tree_map

# default: TP on the feature axes, DP (pod x data) on batch, params replicated
DEFAULT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "heads": "model",
    "kv": "model",
    "kv_heads": "model",
    "mlp": "model",
    "vocab": "model",
    "expert": "model",
    "layer": None,
    "seq_cache": None,
}

# FSDP: additionally shard the params' embed dim over ALL data-parallel
# axes (ZeRO-3 style) — needed for >=20B configs.  'pod' is dropped
# automatically on the single-pod mesh.
FSDP_RULES = {**DEFAULT_RULES, "embed": ("pod", "data")}

# sequence parallelism for activations (long-context prefill)
SEQ_RULES = {**DEFAULT_RULES, "seq": "data"}

# decode: KV caches shard on their length (flash-decode style partial
# softmax) because kv_heads (often 8) do not divide the model axis;
# recurrent-state features shard over model
DECODE_RULES = {**DEFAULT_RULES, "seq_cache": "model", "kv_heads": None,
                "state_feat": "model"}

# long-context decode (batch=1): parallelism comes from the cache length,
# not the batch — shard every KV cache over ALL mesh axes
LONG_RULES = {**DEFAULT_RULES, "batch": None, "kv_heads": None,
              "seq_cache": ("pod", "data", "model"), "state_feat": "model"}


class PartitionSpec(tuple):
    """How each dimension of a leaf splits over mesh axes: per dimension
    None (whole), an axis name, or a tuple of axis names.  Immutable;
    trailing Nones are dropped, so `PartitionSpec("data", None) ==
    PartitionSpec("data")`."""

    def __new__(cls, *parts):
        parts = list(parts)
        while parts and parts[-1] is None:
            parts.pop()
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclass(frozen=True)
class NamedSharding:
    """A leaf laid over `mesh` as `spec` says."""

    mesh: Mesh
    spec: PartitionSpec

    def shard_shape(self, global_shape) -> tuple[int, ...]:
        """The shape of one shard of a leaf of `global_shape`.  Raises
        ValueError where a dimension does not divide by its axes' shard
        count, as `jax.device_put` does, or where the spec names an axis
        the mesh lacks or has more entries than the leaf has dimensions."""
        shape = tuple(int(n) for n in global_shape)
        if len(self.spec) > len(shape):
            raise ValueError(f"{self.spec} has {len(self.spec)} entries, "
                             f"more than the rank of shape {shape}")
        out = list(shape)
        for dim, entry in enumerate(self.spec):
            names = _axes(entry)
            for a in names:
                if a not in self.mesh.shape:
                    raise ValueError(f"{self.spec} names axis {a!r}, which "
                                     f"the mesh {self.mesh.shape} lacks")
            n = math.prod(self.mesh.shape[a] for a in names)
            if shape[dim] % n:
                raise ValueError(
                    f"{self} implies that the global size of its dimension "
                    f"{dim} should be divisible by {n}, but it is equal to "
                    f"{shape[dim]} (full shape: {shape})")
            out[dim] = shape[dim] // n
        return tuple(out)


def spec_for(axes: tuple[str | None, ...], rules: dict,
             mesh: Mesh) -> PartitionSpec:
    """PartitionSpec for logical axes; drops axes absent from the mesh and
    resolves conflicts (a mesh axis may appear only once) left-to-right."""
    used: set[str] = set()
    parts: list = []
    for ax in axes:
        m = rules.get(ax) if ax is not None else None
        if m is None:
            parts.append(None)
            continue
        names = m if isinstance(m, tuple) else (m,)
        names = tuple(n for n in names if n in mesh.axis_names and n not in used)
        if not names:
            parts.append(None)
        elif len(names) == 1:
            parts.append(names[0])
            used.add(names[0])
        else:
            parts.append(names)
            used.update(names)
    return PartitionSpec(*parts)


def param_shardings(template, rules: dict, mesh: Mesh):
    """NamedSharding tree parallel to a ParamSpec template."""
    return tree_map(
        lambda s: NamedSharding(mesh, spec_for(s.axes, rules, mesh)),
        template)


# ----------------------------------------------------------------------
# activation-constraint context
# ----------------------------------------------------------------------
_ACTIVE: list[tuple[Mesh, dict]] = []


@contextlib.contextmanager
def axis_ctx(mesh: Mesh, rules: dict):
    _ACTIVE.append((mesh, rules))
    try:
        yield
    finally:
        _ACTIVE.pop()


def shard_act(x, axes: tuple[str | None, ...]):
    """Constrain an activation to the active rules (no-op outside ctx).
    The spec is resolved and `x` returned as it is: every shard of the
    mesh is on its one device, and a constraint changes no value."""
    if not _ACTIVE:
        return x
    mesh, rules = _ACTIVE[-1]
    spec = spec_for(axes, rules, mesh)
    if len(spec) > x.dim():
        raise ValueError(f"{spec} does not fit an activation of shape "
                         f"{tuple(x.shape)}")
    return x


def active_ctx() -> tuple[Mesh, dict] | None:
    """The (mesh, rules) pair threaded by axis_ctx, if any."""
    return _ACTIVE[-1] if _ACTIVE else None


def mesh_axes_of(logical: str) -> tuple[str, ...]:
    """Physical mesh axes a logical axis maps to under the active rules."""
    ctx = active_ctx()
    if ctx is None:
        return ()
    mesh, rules = ctx
    m = rules.get(logical)
    if m is None:
        return ()
    names = m if isinstance(m, tuple) else (m,)
    return tuple(n for n in names if n in mesh.axis_names)

