"""Distributed query evaluation: sharded TT + views, repartition joins.

The counterpart of `repro/query/distributed.py`.  The triple table and
every materialized view are row-sharded by hash over the mesh's `data`
axis, and a rewriting becomes one program over all shards, built from:

  * local scans and filters (selections are row-local);
  * hash-repartition equi-joins: both sides are bucketed by
    `key % ndev` into fixed-capacity per-destination buckets and
    exchanged, then joined locally;
  * co-partition elision: a side already partitioned by the join column
    (tracked statically through the plan) is not exchanged.

JAX runs the program once per shard under `shard_map` over a device
mesh.  The port stacks the shards on the leading member axis of the
engine's operators (`query/engine.py`): every sharded relation is a
batched `PRel` with `(ndev, cap, w)` data, `(ndev,)` counts and
`(ndev,)` flags, the JAX global `(ndev * cap, w)` array reshaped, and
each operator runs once for all shards (a join's probe is one
`join_count` launch with B = ndev).  The collectives become:

  * `lax.all_to_all` of the send buffers -> `exchange`, a transpose of
    the `(ndev_src, ndev_dst, bucket, w)` send buffer, the only place
    where rows move between shards;
  * `lax.pmax` of the overflow flag -> an `any` over the shard axis,
    broadcast back to every shard on the device.

Each shard's rows come out in JAX's order: the bucketing sort is
stable and the exchange concatenates by source shard.  Buckets make the
exchange static-shaped; overflow latches like the local engine.  The
final relation stays sharded; `gather_result` collects it.

Per device: when the mesh carries a process group's `DeviceMesh`
(`launch.mesh.per_device`, or a real group's), the program is JAX's
`local_program`, one device's function of its own shards, the engine's
operators at B = 1: the send buffers go out by `all_to_all_single` over
the partition axes' group and the overflow flag is OR-ed by
`all_reduce(MAX)`, JAX's `lax.all_to_all` and `lax.pmax`.
"""
from __future__ import annotations

import functools
import math
import os
from typing import Callable

import numpy as np
import torch

from repro_torch.core.queries import Var
from repro_torch.query import cost as cost_mod
from repro_torch.query import engine as E
from repro_torch.query.engine import (INVALID, SENTINEL_HI, PRel, compact,
                                      _columns, _gather_rows, _valid_mask)
from repro_torch.query.plan import EquiJoin, Filter, Plan, Project, TTScan, ViewRef
from repro_torch.rdf.triples import TripleStore


# ----------------------------------------------------------------------
# repartition
# ----------------------------------------------------------------------
def bucket_by_dest(rel: PRel, key_col: int, ndev: int, bucket_cap: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack each shard's rows into an `(ndev, bucket_cap, w)` send buffer
    by key % ndev.  Returns the `(ndev_src, ndev_dst, bucket_cap, w)`
    buffers and the `(ndev,)` overflow flags.  Empty slots are -1."""
    B, cap, w = rel.data.shape
    dev = rel.data.device
    dest = torch.where(_valid_mask(rel), rel.data[..., key_col] % ndev, ndev)
    order = torch.argsort(dest, dim=1, stable=True)  # invalid rows last
    sorted_dest = dest.gather(1, order)
    sorted_rows = _gather_rows(rel.data, order)
    # rank of each row within its destination group
    group_start = torch.searchsorted(sorted_dest, sorted_dest, side="left")
    rank = torch.arange(cap, device=dev)[None, :] - group_start
    live = sorted_dest < ndev
    ok = live & (rank < bucket_cap)
    # every kept row owns its slot; dropped rows all land on the spill
    # row past the buckets, which is cut off
    spill = ndev * bucket_cap
    slot = torch.where(ok, sorted_dest * bucket_cap + rank, spill)
    slot = slot + torch.arange(B, device=dev)[:, None] * (spill + 1)
    buf = torch.full((B, spill + 1, w), INVALID, dtype=torch.int32,
                     device=dev)
    buf.view(-1, w)[slot.reshape(-1)] = sorted_rows.reshape(-1, w)
    overflow = rel.overflow | (live & (rank >= bucket_cap)).any(dim=1)
    return buf[:, :-1].reshape(B, ndev, bucket_cap, w), overflow


def exchange(send: torch.Tensor) -> torch.Tensor:
    """`lax.all_to_all(split_axis=0, concat_axis=0)` over the shard axis:
    shard d receives every source's bucket d, concatenated by source.
    `(ndev_src, ndev_dst, bucket, w)` -> `(ndev_dst, ndev_src * bucket,
    w)`."""
    ndev, _, bucket, w = send.shape
    return send.transpose(0, 1).reshape(ndev, ndev * bucket, w)


def repartition(rel: PRel, key_col: int, ndev: int, bucket_cap: int,
                group=None) -> PRel:
    """Exchange rows so that equal keys land on the same shard: over the
    stacked shard axis, or, given the partition axes' `group`, between
    the devices of one device's program (`rel` that device's, B = 1)."""
    buf, overflow = bucket_by_dest(rel, key_col, ndev, bucket_cap)
    if group is None:
        data = exchange(buf)
        out = compact(data, data[..., 0] != INVALID, overflow)
        # the flag is per source shard; make it global so every shard agrees
        return PRel(out.data, out.n, overflow.any().expand(ndev))
    from torch.distributed import _functional_collectives as funcol

    w = buf.shape[-1]
    data = funcol.wait_tensor(funcol.all_to_all_single(
        buf.reshape(ndev * bucket_cap, w), None, None, group))
    data = data.reshape(1, ndev * bucket_cap, w)
    out = compact(data, data[..., 0] != INVALID, overflow)
    flag = funcol.wait_tensor(funcol.all_reduce(
        overflow.to(torch.int32), "max", group))
    return PRel(out.data, out.n, flag > 0)


# ----------------------------------------------------------------------
# per-shard scans
# ----------------------------------------------------------------------
def scan_pattern_sharded(index_data: torch.Tensor,
                         prefix: tuple[tuple[int, int], ...],
                         residual: tuple[tuple[int, int], ...],
                         takes: tuple[int, ...],
                         self_eq: tuple[tuple[int, int], ...],
                         cap: int) -> PRel:
    """`engine.scan_pattern` on every shard's own sorted index at once:
    `index_data` is `(ndev, n_tt, 3)`, each shard's slab sorted and
    padded with SENTINEL_HI rows.  Bound values stay Python ints (filled
    on the device, no host-to-device copy)."""
    ndev, n_tt, _ = index_data.shape
    dev = index_data.device

    def keys(value: int, dtype) -> torch.Tensor:
        return torch.full((ndev, 1), value, dtype=dtype, device=dev)

    if len(prefix) == 0:
        # count real rows so the padding doesn't inflate the overflow check
        lo = torch.zeros(ndev, dtype=torch.int64, device=dev)
        hi = (index_data[..., 0] != SENTINEL_HI).sum(dim=1)
    else:
        if len(prefix) == 1:
            (c, v), = prefix
            col = index_data[..., c].contiguous()
            key = keys(int(v), torch.int32)
        else:
            # the two prefix columns lead the index order, so the int64
            # key c1 * 2^32 + c2 (ids >= 0) is ascending in every shard
            (c1, v1), (c2, v2) = prefix
            col = (index_data[..., c1].to(torch.int64) << 32) \
                | index_data[..., c2].to(torch.int64)
            key = keys((int(v1) << 32) | int(v2), torch.int64)
        lo = torch.searchsorted(col, key, side="left")[:, 0]
        hi = torch.searchsorted(col, key, side="right")[:, 0]
    pos = lo[:, None] + torch.arange(cap, dtype=torch.int64, device=dev)[None]
    valid = pos < hi[:, None]
    rows = _gather_rows(index_data, pos.clamp(0, max(n_tt - 1, 0)))
    # shards are padded with SENTINEL_HI rows; exclude them
    valid = valid & (rows[..., 0] != SENTINEL_HI)
    for c, v in residual:
        valid = valid & (rows[..., c] == int(v))
    for a, b in self_eq:
        valid = valid & (rows[..., a] == rows[..., b])
    return compact(_columns(rows, takes), valid, (hi - lo) > cap)


# ----------------------------------------------------------------------
# distributed plan compiler
# ----------------------------------------------------------------------
def build_distributed_executor(plan: Plan, stats, view_infos, mesh,
                               axis="data", safety: float = 4.0,
                               partition_cols: dict[int, str] | None = None,
                               use_kernels: bool = True):
    """Compile `plan` into one program over the shards of `mesh` axis
    `axis` (a name or a tuple of names: the partition space is their
    product).

    `partition_cols` maps view_id -> column name the extent is hash-
    partitioned by (enables co-partition elision; the TT is partitioned
    by subject).  Per-shard capacities are the global estimates divided
    by ndev times a skew factor (`REPRO_QUERY_SKEW`, default 4).  Joins
    probe through the `join_count` kernel unless `use_kernels=False`.

    Returns `fn(tt_shards, view_shards) -> PRel`: `tt_shards` maps each
    index name to `(ndev, cap, 3)`, `view_shards` each view id to a
    batched `PRel`; the result stays sharded.  `fn.exchanges` counts the
    repartitions one run makes and `fn.elided` the join sides it keeps
    in place because they are already partitioned on the join column.

    When `mesh.device_mesh` is set, `fn` is one device's program (JAX's
    `local_program`): `tt_shards` maps each index name to the device's
    `(cap, 3)` rows, `view_shards` each view id to its `PRel` of `(cap,
    w)` rows, and the result is its `PRel` of `(cap, w)` data, `(1,)` n
    and `(1,)` overflow, as JAX's `out_specs` lay them out.
    """
    axes = axis if isinstance(axis, tuple) else (axis,)
    ndev = math.prod(mesh.shape[a] for a in axes)
    group = None if mesh.device_mesh is None else _group(
        mesh.root_mesh or mesh.device_mesh, axes)
    partition_cols = partition_cols or {}
    SKEW = float(os.environ.get("REPRO_QUERY_SKEW", "4.0"))
    moves = {"exchanges": 0, "elided": 0}

    def cap_of(rows_global: float) -> int:
        per_dev = rows_global / ndev * SKEW
        return cost_mod.capacity_for(per_dev, safety=safety)

    def build(node: Plan, prefer_sorted: str | None = None
              ) -> tuple[Callable, tuple[str, ...], object, str | None, str | None]:
        """returns (fn, cols, info, partitioned_by|None, sorted_by|None)"""
        est = cost_mod.estimate_plan(node, stats, view_infos)
        if isinstance(node, TTScan):
            idx_name, prefix, residual, takes, self_eq, sorted_by = \
                E.atom_scan_spec(node.atom, prefer_sorted)
            cap = cap_of(E.range_cardinality(node.atom, prefix, stats))
            cols = node.columns()
            # the TT is hash(s)-partitioned: a scan output inherits the
            # subject partitioning iff it keeps the subject column
            part = node.atom.s.name if isinstance(node.atom.s, Var) else None

            def run(tt, views, _f=functools.partial(
                    scan_pattern_sharded, prefix=prefix, residual=residual,
                    takes=takes, self_eq=self_eq, cap=cap), _idx=idx_name):
                return _f(tt[_idx])

            return run, cols, est.info, part, sorted_by
        if isinstance(node, ViewRef):
            part_src = partition_cols.get(node.view_id)
            # positional alignment: view head name -> plan-local name
            part = None
            if part_src is not None and part_src in node.schema:
                part = part_src

            def run(tt, views, _vid=node.view_id):
                return views[_vid]

            return run, node.schema, est.info, part, None
        if isinstance(node, Filter):
            child_fn, cols, _, part, sorted_by = build(node.child, prefer_sorted)
            ci = cols.index(node.col)

            def run(tt, views, _fn=child_fn, _ci=ci, _v=node.value):
                return E.filter_eq(_fn(tt, views), _ci, _v)

            return run, cols, est.info, part, sorted_by
        if isinstance(node, EquiJoin):
            if not node.pairs:
                raise NotImplementedError("cartesian products not supported distributed")
            l_est = cost_mod.estimate_plan(node.left, stats, view_infos)
            r_est = cost_mod.estimate_plan(node.right, stats, view_infos)
            doms = [max(l_est.info.dcol(l), r_est.info.dcol(r))
                    for l, r in node.pairs]
            lead_k = max(range(len(doms)), key=lambda i: doms[i])
            lead_pair = node.pairs[lead_k]
            lf, lcols, linfo, lpart, _ = build(node.left)
            rf, rcols, rinfo, rpart, r_sorted_by = build(node.right,
                                                         lead_pair[1])
            li, ri = lcols.index(lead_pair[0]), rcols.index(lead_pair[1])
            residual = tuple(
                (lcols.index(l), rcols.index(r))
                for k, (l, r) in enumerate(node.pairs) if k != lead_k
            )
            lead_rows = max(linfo.rows * rinfo.rows / doms[lead_k], 1e-3)
            drop = {r for _, r in node.pairs}
            keep_right = tuple(i for i, c in enumerate(rcols) if c not in drop)
            out_cols = lcols + tuple(c for c in rcols if c not in drop)
            out_cap = cap_of(lead_rows)
            # per-destination bucket: rows/(ndev^2) with skew headroom
            lbucket = cost_mod.capacity_for(
                linfo.rows / (ndev * ndev) * SKEW * 2, safety=safety, floor=16)
            rbucket = cost_mod.capacity_for(
                rinfo.rows / (ndev * ndev) * SKEW * 2, safety=safety, floor=16)
            l_colocated = lpart == lead_pair[0] and lpart is not None
            r_colocated = rpart == lead_pair[1] and rpart is not None
            # sort elision survives only when the right side is NOT
            # repartitioned (the exchange destroys row order)
            r_presorted = r_colocated and r_sorted_by == lead_pair[1]
            for colocated in (l_colocated, r_colocated):
                moves["elided" if colocated else "exchanges"] += 1

            def run(tt, views, _lf=lf, _rf=rf, _li=li, _ri=ri, _res=residual,
                    _keep=keep_right, _cap=out_cap, _lb=lbucket, _rb=rbucket,
                    _lcol=l_colocated, _rcol=r_colocated, _rs=r_presorted):
                left = _lf(tt, views)
                right = _rf(tt, views)
                # co-partition elision: only repartition sides not already
                # hashed on the lead join column
                if not _lcol:
                    left = repartition(left, _li, ndev, _lb, group)
                if not _rcol:
                    right = repartition(right, _ri, ndev, _rb, group)
                return E.join(left, right, _li, _ri, _res, _keep, _cap,
                              use_kernels=use_kernels, right_sorted=_rs)

            return run, out_cols, est.info, lead_pair[0], None
        if isinstance(node, Project):
            child_fn, cols, _, part, sorted_by = build(node.child, prefer_sorted)
            idx = tuple(cols.index(c) for c in node.cols)
            out_part = part if part in node.cols else None
            out_sorted = sorted_by if (not node.dedupe and sorted_by in node.cols) \
                else (node.cols[0] if node.dedupe else None)

            def run(tt, views, _fn=child_fn, _idx=idx, _d=node.dedupe):
                rel = _fn(tt, views)
                # local dedupe is enough: rows are co-partitioned by the
                # kept partition column or will be deduped at gather
                return E.project(rel, _idx, _d)

            return run, node.cols, est.info, out_part, out_sorted
        raise TypeError(type(node))

    fn, cols, info, _part, _sorted = build(plan)
    if group is not None:
        fn = _local_program(fn)
    fn.out_columns = cols   # type: ignore[attr-defined]
    fn.est_rows = info.rows  # type: ignore[attr-defined]
    fn.exchanges = moves["exchanges"]  # type: ignore[attr-defined]
    fn.elided = moves["elided"]  # type: ignore[attr-defined]
    return fn


def _group(device_mesh, axes: tuple[str, ...]):
    """The process group of the partition axes: one mesh dim's, or the
    flattened product of several (JAX's tuple axis)."""
    names = device_mesh.mesh_dim_names
    if len(axes) == 1:
        return (device_mesh, names.index(axes[0]))
    return device_mesh[axes]._flatten()


def _local_program(fn):
    """JAX's `local_program`: one device's `(cap, w)` shards in, run at
    B = 1, its `PRel` out with `(1,)` n and overflow."""
    def run(tt, views):
        tt = {k: v[None] for k, v in tt.items()}
        views = {vid: PRel(v.data[None], v.n.reshape(1),
                           v.overflow.reshape(1)) for vid, v in views.items()}
        out = fn(tt, views)
        return PRel(out.data[0], out.n.reshape(1), out.overflow.reshape(1))
    return run


# ----------------------------------------------------------------------
# host helpers
# ----------------------------------------------------------------------
def shard_store_by_subject(store, mesh, axis: str = "data",
                           with_shards: bool = False):
    """Partition the TT by hash(subject); per-shard local sorted indexes,
    stacked as `(ndev, cap, 3)` tensors on `mesh.device`.

    Empty shards are legal (hash skew, or ndev > distinct subjects —
    common on tiny stores over wide meshes): they stack as all-sentinel
    slabs, which every index order sorts last and the scans mask, so
    searchsorted sees a valid zero-row sorted index.  The per-shard
    capacity always covers the longest shard even past the planner's
    power-of-two ceiling, so a heavily skewed shard can never truncate
    rows.  `with_shards=True` additionally returns the host-side
    per-shard `TripleStore`s (the mirrors a sharded serving backend
    probes against and falls back to when a device shard degrades).
    """
    ndev = mesh.shape[axis]
    t = store.triples
    dest = t[:, 0] % ndev
    shards = [TripleStore(t[dest == d]) for d in range(ndev)]
    longest = max((len(s) for s in shards), default=0)
    cap = max(cost_mod.capacity_for(max(longest, 1), safety=1.0),
              max(longest, 1))

    tt: dict[str, torch.Tensor] = {}
    for name in E.INDEX_NAMES:
        stacked = np.full((ndev, cap, 3), SENTINEL_HI, dtype=np.int32)
        for d, s in enumerate(shards):
            idx = s.index(name)
            stacked[d, : len(idx)] = idx
        tt[name] = torch.from_numpy(stacked).to(mesh.device)
    return (tt, shards) if with_shards else tt


def shard_prel_rows(rows: np.ndarray, key_col: int, mesh, axis: str = "data",
                    cap_per_dev: int | None = None,
                    width: int | None = None) -> PRel:
    """Hash-partition extent rows by `key_col` into a sharded PRel.

    A zero-row extent is valid input, including the degenerate 1-D empty
    array numpy produces for `[]` — it is normalized to a (0, width)
    table (`width` defaults to `key_col + 1`) so every shard gets an
    empty-but-well-shaped slab instead of crashing on the column index.
    """
    ndev = mesh.shape[axis]
    rows = np.asarray(rows, np.int32)
    if rows.ndim != 2:
        rows = rows.reshape(0, width if width else key_col + 1)
    dest = rows[:, key_col] % ndev
    groups = [rows[dest == d] for d in range(ndev)]
    cap = cap_per_dev or cost_mod.capacity_for(
        max(max((len(g) for g in groups), default=1), 1), safety=2.0)
    data = np.full((ndev, cap, rows.shape[1]), -1, dtype=np.int32)
    ns = np.zeros((ndev,), np.int32)
    for d, g in enumerate(groups):
        k = min(len(g), cap)
        data[d, :k] = g[:k]
        ns[d] = k
    dev = mesh.device
    return PRel(torch.from_numpy(data).to(dev), torch.from_numpy(ns).to(dev),
                torch.zeros(ndev, dtype=torch.bool, device=dev))


def gather_result(rel: PRel) -> np.ndarray:
    """Collect a sharded result to the host in one read (set semantics:
    dedupe rows that a head projection may have duplicated across
    shards)."""
    ndev, cap, w = rel.data.shape
    data = rel.data.cpu().numpy().reshape(ndev * cap, w)
    mask = data[:, 0] != -1 if w else np.zeros(len(data), bool)
    rows = data[mask]
    return np.unique(rows, axis=0) if len(rows) else rows
