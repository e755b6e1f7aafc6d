"""Counting a dry-run cell: flops, bytes and peak memory of a trace on
`meta`, and the per-group decomposition of `repro/launch/flops_audit.py`.

`count(fn, *args)` runs `fn` on tensors of the `meta` device (no data,
no allocation, no card) under two dispatch modes and returns:

  * flops — `torch.utils.flop_counter.FlopCounterMode`'s count: the
    matrix products (`mm`, `bmm`, `addmm`, ...; elementwise ops count
    nothing), plus the kernels' own formulas, which it reads from the
    ops they register (`flash_attention`: 4 * hd flops per unmasked
    (query, key) pair per head, `kernels/ops.py::attention_flops`);
  * bytes — the sum over aten ops of their tensor inputs' and outputs'
    `nbytes` (views and bare allocations move nothing and count
    nothing).  This is the eager program's own traffic, op by op, with
    no fusion.  It is NOT XLA's post-fusion "bytes accessed" that the
    JAX dry-run reads, and the two are never compared raw;
  * coll — collective bytes: 0 on one card (the port runs no
    collective; a sharded program's exchanges are on-card copies,
    counted in bytes);
  * temp — the peak of live bytes above the arguments during the trace
    (each storage an op creates is live until its last tensor dies),
    and out, the bytes of the result.

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
(`tests/test_torch_dryrun.py`).

One loop is too long to trace at full size: RWKV6's WKV loop runs 18
ops a position a layer, at about 40 us an op on `meta`, which would be
some 20 minutes for rwkv6-3b's 32k prefill.  An RWKV6 config costs
exactly an affine function of the sequence length (every op is per
position or per step; no op is S x S), so `measure` traces it at two
short lengths and extrapolates (`seq_affine`, `SEQ_PROBE`); the tests
hold the extrapolation equal to a full trace at a length both reach.
"""
from __future__ import annotations

import time
import weakref
from dataclasses import replace

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_config
from repro_torch.launch import roofline as RL
from repro_torch.launch.shapes import SHAPES, env_cfg, make_cell, rules_for

_aten = torch.ops.aten
# bare allocations: they write nothing
_ALLOCATIONS = {_aten.empty, _aten.empty_like, _aten.empty_strided,
                _aten.new_empty, _aten.new_empty_strided}
SEQ_PROBE = 64      # the shorter of the two traced lengths (and half the
#                     longer) of a sequence-affine cell


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def tree_bytes(tree) -> int:
    """Bytes of the distinct storages of the tensors in `tree`."""
    seen: dict[int, int] = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


class _Traffic(TorchDispatchMode):
    """Sums the bytes each aten op reads and writes, and tracks the bytes
    of the storages the ops create (live until collected) and their
    peak."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._sizes: dict[int, int] = {}

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if not (func.is_view or func._overloadpacket in _ALLOCATIONS):
            self.bytes += sum(t.nbytes for t in ins) \
                + sum(t.nbytes for t in outs)
        in_keys = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in in_keys or key in self._sizes:
                continue
            self._sizes[key] = st.nbytes()
            self.live += self._sizes[key]
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)
        return out


def count(fn, *args) -> dict:
    """Trace `fn(*args)` (meta tensors) and count it: `flops`, `bytes`,
    `coll`, `coll_by_op`, `temp` (peak live bytes above the arguments),
    `out` (bytes of the result) and `seconds` (the trace's)."""
    t0 = time.perf_counter()
    traffic = _Traffic()
    with FlopCounterMode(display=False) as flops, traffic:
        out = fn(*args)
    return {"flops": float(flops.get_total_flops()),
            "bytes": float(traffic.bytes), "coll": 0.0, "coll_by_op": {},
            "temp": float(traffic.peak), "out": float(tree_bytes(out)),
            "seconds": time.perf_counter() - t0}


_KEYS = ("flops", "bytes", "coll", "temp", "out")


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


def _trace(arch: str, shape: str, rules, cfg, seq: int | None = None
           ) -> dict:
    """`count` of the cell, at sequence length `seq` if given."""
    spec = SHAPES[shape]
    full = spec["seq"]
    spec["seq"] = full if seq is None else seq
    try:
        cell = make_cell(arch, shape, rules=rules, cfg=cfg)
    finally:
        spec["seq"] = full
    return count(cell.fn, *cell.args)


def measure(arch: str, shape: str, rules, cfg) -> dict:
    """The JAX module's `_measure`, a trace where JAX compiles: the
    counts of the cell of `cfg` at `shape`, from one trace, or, for a
    sequence-affine config at a length past 2 * SEQ_PROBE on a train or
    prefill cell, the affine extrapolation of traces at SEQ_PROBE and
    2 * SEQ_PROBE (`seconds` the two traces')."""
    spec = SHAPES[shape]
    seq = spec["seq"]
    if not (seq_affine(cfg) and spec["kind"] != "decode"
            and seq > 2 * SEQ_PROBE):
        return _trace(arch, shape, rules, cfg)
    a = _trace(arch, shape, rules, cfg, SEQ_PROBE)
    b = _trace(arch, shape, rules, cfg, 2 * SEQ_PROBE)
    steps = (seq - SEQ_PROBE) / SEQ_PROBE
    out = {k: a[k] + steps * (b[k] - a[k]) for k in _KEYS}
    out["coll_by_op"] = {}
    out["seconds"] = a["seconds"] + b["seconds"]
    out["seq_probes"] = [SEQ_PROBE, 2 * SEQ_PROBE]
    return out


def corrected_costs(arch: str, shape: str, mesh=None, rules=None,
                    cfg=None) -> dict:
    """Per-device (flops, bytes, collective bytes) of the whole cell from
    traces of 1 and 2 groups (and, with an encoder, 1 and 2 encoder
    layers): stem + G * per_group [+ E * per_enc_layer], with the detail
    keys of the JAX module (`stem`, `per_group`, `loop_correction`)."""
    cfg = env_cfg(cfg if cfg is not None else get_config(arch))
    rules = rules or rules_for(arch, shape)
    G = cfg.n_groups
    E = cfg.encoder.n_layers if cfg.encoder is not None else 0
    e1 = 1 if E else None
    one = measure(arch, shape, rules, _variant(cfg, 1, e1))
    two = measure(arch, shape, rules, _variant(cfg, 2, e1))
    per_group = {k: two[k] - one[k] for k in ("flops", "bytes", "coll")}
    per_enc = dict.fromkeys(per_group, 0.0)
    if E:
        enc = measure(arch, shape, rules, _variant(cfg, 1, 2))
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


def corrected_roofline(arch: str, shape: str, mesh=None, rules=None
                       ) -> RL.Roofline:
    cfg = get_config(arch)
    spec = SHAPES[shape]
    c = corrected_costs(arch, shape, mesh, rules)
    mf = RL.model_flops_for(cfg, spec["kind"], spec["batch"], spec["seq"])
    return RL.Roofline(flops=c["flops"], hbm_bytes=c["bytes"],
                       collective_bytes=c["coll"], chips=1,
                       model_flops=mf)
