"""Parameter templates: shapes + logical axes + initializers.

Twin of `repro/models/params.py`.  A model is described as a nested
dict of `ParamSpec`s; the same template yields materialized parameters
and their shapes.  The logical axes are kept so the template stays
leaf for leaf the JAX package's; the port does not shard.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterator

import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]   # logical axis name per dim
    init: str = "normal"           # normal | zeros | ones | scaled
    scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ "
                             "in rank")


def is_spec(x: Any) -> bool:
    return isinstance(x, ParamSpec)


def tree_map(fn: Callable, tree, *rest):
    """Apply `fn` to the leaves of nested dicts (a leaf is anything that
    is not a dict), in the same structure; `rest` are trees of the same
    structure whose leaves are passed alongside."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree, prefix: tuple[str, ...] = ()
                ) -> Iterator[tuple[tuple[str, ...], Any]]:
    """`(path, leaf)` pairs in sorted key order, the order
    `jax.tree.flatten` visits a dict in."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def tree_from_leaves(leaves) -> dict:
    """The nested dict of `(path, leaf)` pairs (the inverse of
    `tree_leaves`)."""
    out: dict = {}
    for path, x in leaves:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = x
    return out


def tree_shapes(template) -> dict:
    return tree_map(lambda s: tuple(s.shape), template)


def init_params(template, generator: torch.Generator,
                dtype: torch.dtype = torch.float32,
                device: torch.device | str = "cpu") -> dict:
    """Materialize every spec of `template` on `device` in `dtype`, drawn
    from `generator` (on the same device) in sorted leaf order.  The
    initializers are the JAX package's: zeros, ones, `scaled` (fan-in:
    std = scale / sqrt(fan_in)) and `normal` (std = 0.02 * scale).  The
    numbers differ from `jax.random`'s for the same seed."""
    device = torch.device(device)
    if generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device} cannot draw "
                         f"parameters on {device}")

    def mk(spec: ParamSpec) -> torch.Tensor:
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=device)
        if spec.init == "scaled":  # fan-in scaled
            fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
            std = spec.scale / math.sqrt(max(fan_in, 1))
        else:
            std = 0.02 * spec.scale
        x = torch.randn(spec.shape, generator=generator, dtype=dtype,
                        device=device)
        return x.mul_(std)

    out = tree_from_leaves((path, mk(spec))
                           for path, spec in tree_leaves(template))
    return tree_map(lambda _s, x: x, template, out)  # the template's order


def count_params(template) -> int:
    return sum(int(math.prod(s.shape)) for _, s in tree_leaves(template))
