"""Body lint: run every bucket body abstractly and check the ops it
issues obey the engine's hard rules.

The counterpart of `repro/analysis/jaxpr_lint.py`.  Where the JAX lint
traces a body with `jax.make_jaxpr` over `ShapeDtypeStruct`s and walks
the jaxpr's equations, this one runs the body on tensors of the `meta`
device (shapes and dtypes, no data) under a `TorchDispatchMode`, which
sees every aten op the body issues with its inputs and outputs.  Nothing
executes on a device and nothing is read back.

The bucketed executor builds each bucket body once and reuses it for
every member through a process-global cache keyed on hand-built
signatures.  Two classes of silent failure live here: (1) the body
drifts from the engine contract — a float64 promotion, a host read (a
device sync on every run), a data-dependent shape; (2) the cache keys
collide or stop being hashable, in which case one body silently serves a
different bucket's members.

  body/float64        a float64/complex128 tensor seen by any op
  body/weak-float     any float dtype in a query-engine body (the
                      engine is pure int32/bool, with int64 indices)
  body/host-sync      a host read in the body: `aten._local_scalar_dense`
                      (`.item()`, `int(t)`) or a copy to the CPU
                      (`.cpu()`, `.tolist()`, `.to("cpu")`)
  body/dynamic-shape  an op whose output shape depends on the data
                      (`nonzero`, `unique`, `masked_select`,
                      `bincount`, boolean indexing, `repeat_interleave`
                      by a tensor)
  body/trace-error    the body failed to run abstractly at all
  body/key-unhashable a compile-cache key is not hashable
  body/key-collision  two buckets with different signatures map to the
                      same compile-cache key

A host read or a data-dependent op is recorded and the run goes on with
a placeholder result (zeros on the CPU for a read; for a data-dependent
op, the op's result on zero operands, as meta tensors), so one lint
reports every such op of a body.
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

from repro_torch.analysis.findings import Finding
from repro_torch.query.buckets import BucketedProgram, body_builder

_aten = torch.ops.aten

# ops whose output shape depends on the values of their operands
_DATA_DEPENDENT = frozenset({
    "nonzero", "argwhere", "masked_select", "unique", "_unique",
    "_unique2", "unique_dim", "unique_consecutive", "bincount",
})


def _f(rule: str, severity: str, message: str, location: str = "") -> Finding:
    return Finding("body", rule, severity, message, location)


def _tensors(tree) -> list[torch.Tensor]:
    leaves, _ = tree_flatten(tree)
    return [t for t in leaves if isinstance(t, torch.Tensor)]


def _to_cpu_zeros(tree):
    return tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype)
                    if isinstance(t, torch.Tensor) else t, tree)


def _to_meta(tree):
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta")
                    if isinstance(t, torch.Tensor) else t, tree)


def _copies_to_host(func, args, kwargs) -> bool:
    """A copy that moves a meta (device) tensor's data to the CPU."""
    dev = kwargs.get("device")
    return func is _aten._to_copy.default and dev is not None \
        and torch.device(dev).type == "cpu" and args[0].device.type != "cpu"


def _is_data_dependent(func, args, kwargs) -> bool:
    name = func._schema.name.split("::")[-1]
    if name in _DATA_DEPENDENT:
        return True
    if name == "repeat_interleave":  # repeats as a tensor, no output_size
        return func._overloadname != "self_int" \
            and kwargs.get("output_size") is None
    if func is _aten.index.Tensor:  # boolean-mask indexing
        return any(isinstance(i, torch.Tensor)
                   and i.dtype in (torch.bool, torch.uint8)
                   for i in args[1])
    return False


class _LintMode(TorchDispatchMode):
    """Records the dtypes, host reads and data-dependent ops of every
    aten op run under it."""

    def __init__(self, location: str):
        super().__init__()
        self.location = location
        self.dtypes: set[torch.dtype] = set()
        self.findings: list[Finding] = []

    def _host_sync(self, what: str) -> None:
        self.findings.append(_f(
            "body/host-sync", "error",
            f"host read {what} in a bucket body — every run would wait "
            "for the device and copy to the host", self.location))

    def _dynamic(self, func, args, kwargs):
        self.findings.append(_f(
            "body/dynamic-shape", "error",
            f"{func._schema.name} has a data-dependent output shape — the "
            "body's buffers would no longer be static", self.location))
        return _to_meta(func(*_to_cpu_zeros(args), **_to_cpu_zeros(kwargs)))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for t in _tensors((args, kwargs)):
            self.dtypes.add(t.dtype)
        if func is _aten._local_scalar_dense.default:
            self._host_sync("aten._local_scalar_dense (.item() / int(t))")
            return False if args[0].dtype == torch.bool else \
                0.0 if args[0].dtype.is_floating_point else 0
        if _copies_to_host(func, args, kwargs):
            self._host_sync("aten._to_copy to the CPU "
                            "(.cpu() / .tolist() / .to('cpu'))")
            return torch.zeros(args[0].shape,
                               dtype=kwargs.get("dtype") or args[0].dtype)
        if _is_data_dependent(func, args, kwargs):
            out = self._dynamic(func, args, kwargs)
        else:
            out = func(*args, **kwargs)
        for t in _tensors(out):
            self.dtypes.add(t.dtype)
        return out


def lint_traced(fn, arg_specs, location: str = "",
                forbid_floats: bool = True) -> list[Finding]:
    """Run `fn` over `arg_specs` (tensors on the `meta` device) and lint
    every op it issues.

    `forbid_floats=True` applies the query-engine contract (int32/bool,
    int64 indices); pass False for numeric kernels where f32 is expected
    and only 64-bit float promotion is an error.
    """
    mode = _LintMode(location)
    try:
        with mode:
            fn(*arg_specs)
    except Exception as e:  # any failure to run is itself the finding
        return mode.findings + [_f(
            "body/trace-error", "error",
            f"body failed to trace: {type(e).__name__}: {e}", location)]

    out = list(mode.findings)
    for dtype in sorted(mode.dtypes, key=str):
        name = str(dtype).removeprefix("torch.")
        if dtype in (torch.float64, torch.complex128):
            out.append(_f(
                "body/float64", "error",
                f"{name} appears in the body — 64-bit promotion (check "
                "literal dtypes and torch.get_default_dtype())", location))
        elif forbid_floats and (dtype.is_floating_point or dtype.is_complex):
            out.append(_f(
                "body/weak-float", "error",
                f"{name} appears in a query-engine body that must be "
                "pure int32/bool — a float literal leaked into the "
                "relational path", location))
    return out


def check_cache_keys(keyed: list[tuple[object, object, str]]
                     ) -> list[Finding]:
    """`keyed` is [(signature, cache_key, location)]: every key must be
    hashable, and distinct signatures must yield distinct keys."""
    out: list[Finding] = []
    by_key: dict = {}
    for sig, key, loc in keyed:
        try:
            hash(key)
        except TypeError as e:
            out.append(_f(
                "body/key-unhashable", "error",
                f"compile-cache key is unhashable ({e}) — every lookup "
                "would crash or, worse, fall back to identity", loc))
            continue
        prev = by_key.get(key)
        if prev is not None and prev[0] != sig:
            out.append(_f(
                "body/key-collision", "error",
                f"cache key collides with {prev[1]} despite different "
                "static signatures — one body would serve both",
                loc))
        else:
            by_key[key] = (sig, loc)
    return out


def lint_program(program: BucketedProgram, n_tt: int,
                 view_caps: dict[int, int] | None = None) -> list[Finding]:
    """Lint every bucket body of a `BucketedProgram` without executing:
    run each body over `meta` operands and check the compile-cache keys
    the program would use for them."""
    out: list[Finding] = []
    eff = program.static_eff_caps(view_caps)
    keyed: list[tuple[object, object, str]] = []
    for bucket in program.buckets:
        loc = f"bucket {bucket.label}"
        specs = program.abstract_args(bucket, n_tt, eff)
        fn = body_builder(bucket, program.use_kernels)
        out.extend(lint_traced(fn, specs, location=loc))
        keyed.append(((bucket.static, bucket.cap),
                      program.cache_key(bucket, specs), loc))
    out.extend(check_cache_keys(keyed))
    return out
