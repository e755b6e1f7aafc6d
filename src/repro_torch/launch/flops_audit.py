"""Counting a dry-run cell: flops, bytes and peak memory of a trace on
`meta`, and the per-group decomposition of `repro/launch/flops_audit.py`.

`count(fn, *args)` runs `fn` on tensors of the `meta` device (no data,
no allocation, no card) under one dispatch mode and returns:

  * flops — the formulas `torch.utils.flop_counter` registers, op by op
    (the matrix products `mm`, `bmm`, `addmm`, ...; elementwise ops
    count nothing), the kernels' own among them (`flash_attention`:
    4 * hd flops per unmasked (query, key) pair per head,
    `kernels/ops.py::attention_flops`);
  * bytes — the sum over aten ops of their tensor inputs' and outputs'
    `nbytes` (views and bare allocations move nothing and count
    nothing).  This is the eager program's own traffic, op by op, with
    no fusion.  It is NOT XLA's post-fusion "bytes accessed" that the
    JAX dry-run reads, and the two are never compared raw;
  * coll, coll_by_op — collective bytes by JAX's op name (`all-gather`,
    `all-reduce`, `reduce-scatter`, `all-to-all`, `collective-permute`),
    each collective counted by its output's bytes as
    `roofline.parse_collectives` counts an HLO collective; their number
    by op name (`coll_count_by_op`) is `CommDebugMode`'s;
  * temp — the peak of live bytes above the arguments during the trace
    (each storage an op creates is live until its last tensor dies),
    and out, the bytes of the result; `args_read`, the bytes of the
    argument storages some op reads (JAX's jit drops the others);
    `kernel_calls`, the operand shapes (and the other arguments) of each
    call of the kernels' ops (on a production mesh, rank 0's shards: the
    shapes its card would launch the kernel at); `view_gathers` and
    `view_gather_bytes`, the gathers a production mesh's program issues
    before a reshape that cannot keep a dimension split
    (`distributed/sharding.py::view_gathers`) and their gathered bytes,
    which `coll` includes.

On one card (`mesh=None`) the program runs no collective.  A cell of a
production mesh is one device's program (`launch/shapes.py`): its
arguments are DTensors of rank 0's shards, and DTensor runs each op as
local ops on those shards, with collectives where the layouts ask for
them.  The mode declines the DTensor-level ops (`NotImplemented`), so it
counts the local ops beneath them, rank 0's: per-device flops, bytes,
live bytes and collectives.  A DTensor op's global flops, and the fake
tensors of DTensor's sharding propagation, are not counted.

The JAX module compiles each cell, and XLA's `cost_analysis()` counts a
`lax.scan` body once, so it recovers totals from variants with 0 and 1
layer groups (`corrected = stem + G * (body - stem) [+ E * (enc -
stem)]`) and adds two in-body loops analytically (`_loop_corrections`:
RWKV6's WKV time scan, Mamba2's inter-chunk scan).  The eager trace runs
every Python loop of the port step by step — the group loop
(`transformer._groups`), the encoder's layers, Mamba2's inter-chunk loop
(`ssm.mamba2_train`), RWKV6's WKV loop (`ssm.rwkv6_time_mix_train`) and
`attention_backward`'s blocks — and `flash_attention` is one op with
its formula, so no loop is counted once and none needs a correction
(`loop_correction` is kept in the result, 0).

`corrected_costs` keeps the decomposition, for the time it saves: a
trace of 1 and 2 groups (and 1 and 2 encoder layers) instead of all of
them.  The stem is the intercept of that affine fit, not a 0-group
trace: with no group, no gradient reaches the stem's parameters (the
encoder's front end, zamba2's shared block), and the (G - 1)
accumulations of a shared parameter's gradient are affine in G only
from G = 1.  Every count is affine in G for G >= 1 and in E (no term
in G * E), so the result equals the full trace's counts exactly
(`tests/test_torch_dryrun.py`, on one card and per device).

One loop is too long to trace at full size: RWKV6's WKV loop runs 18
ops a position a layer, at about 40 us an op on `meta`, which would be
some 20 minutes for rwkv6-3b's 32k prefill.  An RWKV6 config costs
exactly an affine function of the sequence length (every op is per
position or per step; no op is S x S), so `measure` traces it at two
short lengths and extrapolates (`seq_affine`, `SEQ_PROBE`); the tests
hold the extrapolation equal to a full trace at a length both reach.
"""
from __future__ import annotations

import contextlib
import json
import math
import time
import weakref
from dataclasses import replace

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import get_config
from repro_torch.distributed.sharding import VIEW_GATHERS
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import per_device
from repro_torch.launch.shapes import SHAPES, env_cfg, make_cell, rules_for

_aten = torch.ops.aten
# bare allocations: they write nothing
_ALLOCATIONS = {_aten.empty, _aten.empty_like, _aten.empty_strided,
                _aten.new_empty, _aten.new_empty_strided}
SEQ_PROBE = 64      # the shorter of the two traced lengths (and half the
#                     longer) of a sequence-affine cell


# the collectives of a per-device program, by JAX's HLO op names
COLLECTIVES = {"all_gather_into_tensor": "all-gather",
               "all_reduce": "all-reduce",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_to_all_single": "all-to-all",
               "permute_tensor": "collective-permute"}


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors of `tree`, each DTensor as its local shard."""
    return [t.to_local() if _is_dtensor(t) else t for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def tree_bytes(tree) -> int:
    """Bytes of the distinct storages of the tensors in `tree` (of a
    DTensor, its local shard's)."""
    seen: dict[int, int] = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def _collective(func) -> str | None:
    """JAX's name of the collective `func` is, or None."""
    if func.namespace not in ("_c10d_functional", "c10d_functional"):
        return None
    return COLLECTIVES.get(func._overloadpacket.__name__)


class _Traffic(TorchDispatchMode):
    """Counts each op's flops (the registered formulas), the bytes it
    reads and writes and, for a collective, its output bytes; tracks the
    bytes of the storages the ops create (live until collected), their
    peak, and which argument storages are read.  It declines the ops of
    DTensors, so the local ops they run are what it counts; it skips
    ops on fake tensors (DTensor's shape propagation) and ops on no
    meta tensor (DTensor's own index arithmetic on the CPU)."""

    def __init__(self, args):
        super().__init__()
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        self._dtensor, self._fake = DTensor, FakeTensor
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.coll: dict[str, int] = {}
        self._sizes: dict[int, int] = {}
        self._args = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
                      for t in _tensors(args)}
        self._read: set[int] = set()
        self.kernels: dict[str, list] = {}

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key)

    @property
    def args_read(self) -> int:
        return sum(self._args[k] for k in self._read)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if not any(t.is_meta for t in ins + outs) or any(
                isinstance(t, self._fake) for t in ins + outs):
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        in_keys = {t.untyped_storage()._cdata for t in ins}
        if not (func.is_view or packet in _ALLOCATIONS):
            self.bytes += sum(t.nbytes for t in ins) \
                + sum(t.nbytes for t in outs)
            self._read |= in_keys & self._args.keys()
        if func.namespace == "repro_torch":
            self.kernels.setdefault(packet.__name__, []).append(
                [list(a.shape) if isinstance(a, torch.Tensor) else a
                 for a in args])
        name = _collective(func)
        if name is not None:
            self.coll[name] = self.coll.get(name, 0) + sum(
                t.nbytes for t in outs)
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in in_keys or key in self._sizes or key in self._args:
                continue
            self._sizes[key] = st.nbytes()
            self.live += self._sizes[key]
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)
        return out


def count(fn, *args) -> dict:
    """Trace `fn(*args)` (meta tensors, or meta DTensors of one device's
    shards) and count it: `flops`, `bytes`, `coll`, `coll_by_op`,
    `coll_count_by_op`, `temp` (peak live bytes above the arguments),
    `out` (bytes of the result), `args_read`, `kernel_calls` (the
    arguments of each call of a kernel's op, `repro_torch::*`, by name,
    tensors as their shapes) and `seconds` (the trace's)."""
    from torch.distributed.tensor.debug import CommDebugMode

    t0 = time.perf_counter()
    traffic = _Traffic(args)
    first = len(VIEW_GATHERS)
    with traffic, CommDebugMode() as comm:
        out = fn(*args)
    gathers = VIEW_GATHERS[first:]
    del VIEW_GATHERS[first:]
    issued = {COLLECTIVES[str(op).split(".")[-1]]: n
              for op, n in comm.get_comm_counts().items() if n}
    return {"flops": float(traffic.flops), "bytes": float(traffic.bytes),
            "coll": float(sum(traffic.coll.values())),
            "coll_by_op": dict(traffic.coll), "coll_count_by_op": issued,
            "temp": float(traffic.peak), "out": float(tree_bytes(out)),
            "args_read": float(traffic.args_read),
            "view_gathers": float(len(gathers)),
            "view_gather_bytes": float(sum(gathers)),
            "kernel_calls": traffic.kernels,
            "seconds": time.perf_counter() - t0}


_KEYS = ("flops", "bytes", "coll", "temp", "out", "args_read",
         "view_gathers", "view_gather_bytes")


def seq_affine(cfg) -> bool:
    """Whether every count of `cfg`'s steps is affine in the sequence
    length: RWKV6 blocks only (no attention, no encoder; Mamba2's chunks
    would also need a length a multiple of the chunk, and the one config
    with Mamba2 blocks, zamba2, has shared attention)."""
    return cfg.encoder is None and set(cfg.block_pattern) == {"rwkv6"}


def _variant(cfg, n_groups: int, enc_layers: int | None = None):
    c = replace(cfg, n_layers=n_groups * len(cfg.block_pattern))
    if cfg.encoder is not None:
        e = enc_layers if enc_layers is not None else cfg.encoder.n_layers
        c = replace(c, encoder=replace(cfg.encoder, n_layers=e))
    return c


def on(mesh):
    """The context a cell of `mesh` is traced in: none for one card
    (None) or a mesh whose `per_device` is open, else `per_device`."""
    if mesh is None or mesh.device_mesh is not None:
        return contextlib.nullcontext()
    return per_device(mesh)


def _trace(arch: str, shape: str, rules, cfg, seq: int | None = None,
           mesh=None) -> dict:
    """`count` of the cell, at sequence length `seq` if given."""
    spec = SHAPES[shape]
    full = spec["seq"]
    spec["seq"] = full if seq is None else seq
    try:
        cell = make_cell(arch, shape, mesh, rules=rules, cfg=cfg)
    finally:
        spec["seq"] = full
    return count(cell.fn, *cell.args)


def _affine(a: dict, b: dict, steps: float) -> dict:
    return {k: a.get(k, 0) + steps * (b.get(k, 0) - a.get(k, 0))
            for k in set(a) | set(b)}


def measure(arch: str, shape: str, rules, cfg, mesh=None) -> dict:
    """The JAX module's `_measure`, a trace where JAX compiles: the
    counts of the cell of `cfg` at `shape` (on `mesh`, inside its
    `per_device` context), from one trace, or, for a sequence-affine
    config at a length past 2 * SEQ_PROBE on a train or prefill cell,
    the affine extrapolation of traces at SEQ_PROBE and 2 * SEQ_PROBE
    (`seconds` the two traces')."""
    spec = SHAPES[shape]
    seq = spec["seq"]
    if not (seq_affine(cfg) and spec["kind"] != "decode"
            and seq > 2 * SEQ_PROBE):
        return _trace(arch, shape, rules, cfg, mesh=mesh)
    a = _trace(arch, shape, rules, cfg, SEQ_PROBE, mesh)
    b = _trace(arch, shape, rules, cfg, 2 * SEQ_PROBE, mesh)
    steps = (seq - SEQ_PROBE) / SEQ_PROBE
    out = {k: a[k] + steps * (b[k] - a[k]) for k in _KEYS}
    for k in ("coll_by_op", "coll_count_by_op"):
        out[k] = _affine(a[k], b[k], steps)
    out["kernel_calls"] = {}    # RWKV6 blocks call no kernel
    out["seconds"] = a["seconds"] + b["seconds"]
    out["seq_probes"] = [SEQ_PROBE, 2 * SEQ_PROBE]
    return out


def corrected_costs(arch: str, shape: str, mesh=None, rules=None,
                    cfg=None) -> dict:
    """Per-device (flops, bytes, collective bytes) of the whole cell on
    `mesh` (None: one card) from traces of 1 and 2 groups (and, with an
    encoder, 1 and 2 encoder layers): stem + G * per_group [+ E *
    per_enc_layer], with the detail keys of the JAX module (`stem`,
    `per_group`, `loop_correction`)."""
    cfg = env_cfg(cfg if cfg is not None else get_config(arch))
    rules = rules or rules_for(arch, shape)
    G = cfg.n_groups
    E = cfg.encoder.n_layers if cfg.encoder is not None else 0
    e1 = 1 if E else None
    with on(mesh):
        one = measure(arch, shape, rules, _variant(cfg, 1, e1), mesh)
        two = measure(arch, shape, rules, _variant(cfg, 2, e1), mesh)
        if E:
            enc = measure(arch, shape, rules, _variant(cfg, 1, 2), mesh)
    per_group = {k: two[k] - one[k] for k in ("flops", "bytes", "coll")}
    per_enc = dict.fromkeys(per_group, 0.0)
    if E:
        per_enc = {k: enc[k] - one[k] for k in per_group}
    stem = {k: one[k] - per_group[k] - (per_enc[k] if E else 0.0)
            for k in per_group}
    out = {k: stem[k] + G * per_group[k] + E * per_enc[k]
           for k in per_group}
    out["loop_correction"] = {"flops": 0.0, "bytes": 0.0}
    out["stem"] = stem
    out["per_group"] = per_group
    if E:
        out["per_enc_layer"] = per_enc
    return out


def kernel_summary(counts: dict) -> dict:
    """`count`'s kernel calls as `{name: {"calls": n, "shapes": {operand
    shapes: calls}}}` for an artifact."""
    out = {}
    for name, calls in counts.get("kernel_calls", {}).items():
        shapes: dict[str, int] = {}
        for c in calls:
            shapes[json.dumps(c)] = shapes.get(json.dumps(c), 0) + 1
        out[name] = {"calls": len(calls), "shapes": shapes}
    return out


def chips_of(mesh) -> int:
    """Devices of `mesh`; one card for None."""
    return 1 if mesh is None else math.prod(mesh.shape.values())


def corrected_roofline(arch: str, shape: str, mesh=None, rules=None
                       ) -> RL.Roofline:
    cfg = get_config(arch)
    spec = SHAPES[shape]
    c = corrected_costs(arch, shape, mesh, rules)
    mf = RL.model_flops_for(cfg, spec["kind"], spec["batch"], spec["seq"])
    return RL.Roofline(flops=c["flops"], hbm_bytes=c["bytes"],
                       collective_bytes=c["coll"], chips=chips_of(mesh),
                       model_flops=mf)
