"""Logical-axis sharding: one rules table maps logical axes to mesh axes.

Twin of `repro/distributed/sharding.py`.  Params and activations carry
logical axis names ('embed', 'heads', 'mlp', 'vocab', 'expert', 'batch',
'seq', ...); a RULES dict maps them onto the axes of a mesh.  Changing
the distribution strategy = changing the table.

A mesh of the port (`repro_torch.launch.mesh.Mesh`) is used two ways.

Stacked: `ndev` shards on one device.  `PartitionSpec` and
`NamedSharding` here are the small counterparts of JAX's: a sharding
names how a leaf splits over the mesh and checks that it splits evenly
(`NamedSharding.shard_shape`), while the leaf itself stays whole on the
mesh's device.  Shardings live in trees parallel to the tensor trees;
they are never attributes of tensors.  Inside `axis_ctx` `shard_act`
resolves an activation's spec and returns the activation unchanged (a
constraint changes no value), and `moe` takes the expert-parallel path
(`models/layers.py::_moe_expert_parallel`), which computes JAX's
`shard_map` body for all (data, expert) shards at once.

Per device: under `launch.mesh.per_device(mesh)` the mesh carries a
`DeviceMesh` of a fake process group, and one device's program is
traced on DTensors, PyTorch's counterpart of GSPMD.  `placements`
turns a spec into DTensor placements, `NamedSharding.local` gives rank
0's meta DTensor of a leaf (JAX's padding where a split is uneven), and
inside `axis_ctx` `shard_act` redistributes to the resolved placements
(JAX's `with_sharding_constraint`).  `axis_ctx` also applies two rules
of GSPMD that DTensor does not: a plain tensor the program builds
(positions, masks, rotary angles) is replicated on every device, and a
reshape that unflattens a dimension split unevenly (heads that do
not divide the model axis), or flattens a split dimension into an outer
one, gathers that dimension first (`_UnevenViews`, decided from the
placements before the op).  An op that DTensor cannot partition raises; nothing falls back to a
whole-program trace.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode

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

    def local(self, global_shape, dtype: torch.dtype):
        """Rank 0's shard of an argument of `global_shape` as a meta
        DTensor over the mesh's `DeviceMesh` (open `per_device(mesh)`
        first).  Its local shape is `shard_shape`'s, which raises where a
        dimension does not divide, as `jax.jit` refuses such an argument
        sharding; activations split unevenly inside the program are
        DTensor's (rank 0 holds ceil(size / n) rows, JAX's padded
        shard)."""
        from torch.distributed.tensor import DTensor

        dm = self.mesh.device_mesh
        if dm is None:
            raise RuntimeError("NamedSharding.local needs the mesh's "
                               "per_device context")
        loc = self.shard_shape(global_shape)
        full = torch.empty(tuple(global_shape), dtype=dtype, device="meta")
        return DTensor.from_local(
            torch.empty(loc, dtype=dtype, device="meta"), dm,
            placements(self.spec, dm), run_check=False, shape=full.shape,
            stride=full.stride())


def mesh_dims(device_mesh, axes) -> list[int]:
    """The dims of `device_mesh` that split over the mesh axes `axes`, in
    order: a dim named "pod.data" covers pod and data (`per_device`'s
    layout), so `axes` must name whole dims, in the mesh's order."""
    groups = [tuple(n.split(".")) for n in device_mesh.mesh_dim_names]
    axes, out, k = tuple(axes), [], 0
    while k < len(axes):
        dim = next((d for d, g in enumerate(groups) if g[0] == axes[k]), None)
        if dim is None or axes[k:k + len(groups[dim])] != groups[dim]:
            raise ValueError(f"axes {axes} do not name whole dims of the "
                             f"mesh {device_mesh.mesh_dim_names}")
        out.append(dim)
        k += len(groups[dim])
    if out != sorted(out):
        raise ValueError(f"axes {axes} are out of the mesh's order "
                         f"{device_mesh.mesh_dim_names}")
    return out


def placements(spec: PartitionSpec, device_mesh) -> list:
    """DTensor placements of `spec` over `device_mesh` (`mesh_dims`):
    `Shard(d)` on each mesh dim that splits tensor dim d, `Replicate()`
    on the others.  An entry of several axes, such as ("pod", "data"),
    splits its dimension over those dims major to minor, as JAX does,
    which is DTensor's order for dims in mesh order."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate() for _ in device_mesh.mesh_dim_names]
    for dim, entry in enumerate(spec):
        for i in mesh_dims(device_mesh, _axes(entry)):
            out[i] = Shard(dim)
    return out


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


# the reshapes DTensor carries a split through by its view rules
_RESHAPES = (torch.ops.aten.view, torch.ops.aten._unsafe_view,
             torch.ops.aten.reshape)

# (calls, gathered bytes) of the gathers `_UnevenViews` issued, one entry
# a reshape; `launch/flops_audit.py::count` reads what a trace added
VIEW_GATHERS: list[int] = []


class _UnevenViews(TorchDispatchMode):
    """A reshape of a DTensor that would keep a dimension split where the
    split cannot be carried (`view_gathers`) is taken after gathering
    that dimension on the mesh dims that split it, as GSPMD reshards such
    a reshape; the gather is a collective of the program, and its
    gathered bytes are recorded in `VIEW_GATHERS`.  The decision is made
    from the placements and the target size before the op; every other
    op goes to DTensor as it is, and raises where DTensor raises."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        x = args[0] if args else None
        if func._overloadpacket in _RESHAPES and _is_dtensor(x):
            shards: dict[int, int] = {}
            for i, p in enumerate(x.placements):
                if p.is_shard():
                    shards[p.dim] = shards.get(p.dim, 1) * x.device_mesh.size(i)
            dims = view_gathers(tuple(x.shape), args[1], shards)
            if dims:
                from torch.distributed.tensor import Replicate

                whole = [Replicate() if p.is_shard() and p.dim in dims
                         else p for p in x.placements]
                x = x.redistribute(x.device_mesh, whole)
                VIEW_GATHERS.append(x.to_local().nbytes)
                args = (x, *args[1:])
        return func(*args, **kwargs)


def view_gathers(shape: tuple, size, shards: dict[int, int]) -> set[int]:
    """The dims of `shape`, split `shards[d]` ways, that a view to `size`
    must gather first: a split dim the view flattens into an outer dim,
    and a split dim the view flattens or unflattens while it, or the
    leading dim it becomes, does not divide by its shard count (where
    JAX pads a split, a reshape has no padding to carry).  A dim the view
    keeps whole stays split.  Dims of extent 1 take no part."""
    size = [int(n) for n in size]
    if -1 in size:
        rest = math.prod(n for n in size if n != -1)
        size[size.index(-1)] = math.prod(shape) // max(rest, 1)
    out = set()
    for ins, outs in _view_groups(shape, size):
        if len(ins) == 1 and len(outs) == 1:
            continue
        for k, d in enumerate(ins):
            n = shards.get(d, 1)
            if n > 1 and (k > 0 or shape[d] % n or size[outs[0]] % n):
                out.add(d)
    return out


def _view_groups(shape, size) -> list[tuple[list[int], list[int]]]:
    """The view of `shape` to `size` as groups (dims in, dims out) of
    equal element counts, each as small as can be, over the dims of
    extent other than 1."""
    a = [d for d, n in enumerate(shape) if n != 1]
    b = [d for d, n in enumerate(size) if n != 1]
    groups, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        ins, outs = [a[i]], [b[j]]
        pa, pb = shape[a[i]], size[b[j]]
        i, j = i + 1, j + 1
        while pa != pb:
            if pa < pb and i < len(a):
                ins.append(a[i])
                pa, i = pa * shape[a[i]], i + 1
            elif pb < pa and j < len(b):
                outs.append(b[j])
                pb, j = pb * size[b[j]], j + 1
            else:
                raise ValueError(f"no view of {tuple(shape)} is {size}")
        groups.append((ins, outs))
    return groups


_RULES: list = []


def register_rules() -> None:
    """The DTensor sharding rules the port's per-device programs need
    (once a process; `launch.mesh.per_device` calls it):
    `flash_attention`'s (`kernels/ops.py::register_partitioning`) and
    `flip`'s, which some torch versions lack (the gradient of
    `cumsum`): a dimension that is not flipped may stay split."""
    if _RULES:
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    from repro_torch.kernels import ops

    ops.register_partitioning()

    @register_sharding(torch.ops.aten.flip.default)
    def _(x, dims):
        flipped = {d % x.ndim for d in dims}
        return [([p], [p, None]) for p in [Replicate()] + [
            Shard(d) for d in range(x.ndim) if d not in flipped]]

    _RULES.append(True)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


@contextlib.contextmanager
def axis_ctx(mesh: Mesh, rules: dict):
    """Thread (mesh, rules) to the model code; when the mesh carries a
    `DeviceMesh` (`per_device`), also replicate the plain tensors the
    program mixes with DTensors and gather before uneven views."""
    _ACTIVE.append((mesh, rules))
    try:
        if mesh.device_mesh is None:
            yield
        else:
            from torch.distributed.tensor.experimental import \
                implicit_replication

            with implicit_replication(), _UnevenViews():
                yield
    finally:
        _ACTIVE.pop()


def shard_act(x, axes: tuple[str | None, ...]):
    """Constrain an activation to the active rules (no-op outside ctx).
    Over a stacked mesh the spec is resolved and `x` returned as it is:
    every shard of the mesh is on its one device, and a constraint
    changes no value.  Per device, a DTensor is redistributed to the
    spec's placements (JAX's `with_sharding_constraint`)."""
    if not _ACTIVE:
        return x
    mesh, rules = _ACTIVE[-1]
    spec = spec_for(axes, rules, mesh)
    if len(spec) > x.dim():
        raise ValueError(f"{spec} does not fit an activation of shape "
                         f"{tuple(x.shape)}")
    dm = mesh.device_mesh
    if dm is None or not _is_dtensor(x):
        return x
    return redistribute(x, placements(spec, dm))


def redistribute(x, target: list):
    """`x` (a DTensor) redistributed to the placements `target`, its
    partial sums that `target` replicates reduced first (on the smaller
    local shard, before any gather), as XLA orders a reduction and a
    gather."""
    from torch.distributed.tensor import Replicate

    first = [Replicate() if p.is_partial() and t.is_replicate() else p
             for p, t in zip(x.placements, target)]
    if first != list(x.placements):
        x = x.redistribute(x.device_mesh, first)
    return x.redistribute(x.device_mesh, target)


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

