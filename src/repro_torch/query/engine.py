"""PyTorch query engine: static-capacity padded relations.

The counterpart of `repro/query/engine.py`.  Every relation is a
`(capacity, width)` int32 buffer + a valid-row count + an overflow flag,
with the same invariants:

  * valid rows occupy a prefix `[0, n)`;
  * rows at `[n, capacity)` are scrubbed to -1 (no stale ids);
  * `overflow` latches if any operator's true output exceeded capacity.

Operators are written on a leading member axis — `(B, cap, w)` data with
`(B,)` counts and flags — so that one call runs a whole shape bucket
(`query/buckets.py`); an unbatched `(cap, w)` relation runs as `B = 1`.

Joins are sort + probe + bounded expansion.  The probe goes through the
hand-written CUDA kernel (`kernels/ops.join_count`) with
`use_kernels=True`, the default; its plain version runs on the CPU.
Where PyTorch differs from JAX the code keeps JAX's results:
`jnp.repeat(..., total_repeat_length=)` becomes a `searchsorted` over the
inclusive prefix of counts, every gather index is clipped (JAX clamps,
PyTorch raises), and every sort the result depends on is stable.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import numpy as np
import torch

import repro_torch
from repro_torch.core.queries import Const, Var
from repro_torch.kernels import ops as kops
from repro_torch.query import cost as cost_mod
from repro_torch.query.plan import EquiJoin, Filter, Plan, Project, TTScan, ViewRef

INVALID = -1
SENTINEL_HI = 2**31 - 1


class PRel(NamedTuple):
    data: torch.Tensor      # (cap, w) or (B, cap, w) int32
    n: torch.Tensor         # () or (B,) int32
    overflow: torch.Tensor  # () or (B,) bool

    @property
    def cap(self) -> int:
        return self.data.shape[-2]

    @property
    def width(self) -> int:
        return self.data.shape[-1]


def make_prel(rows: np.ndarray, cap: int, device=None) -> PRel:
    dev = repro_torch.device(device)
    rows = np.asarray(rows, dtype=np.int32)
    n = min(len(rows), cap)
    w = rows.shape[1] if rows.ndim == 2 else 0
    buf = np.full((cap, w), -1, dtype=np.int32)
    buf[:n] = rows[:n]
    return PRel(torch.from_numpy(buf).to(dev),
                torch.tensor(n, dtype=torch.int32, device=dev),
                torch.tensor(len(rows) > cap, device=dev))


def to_numpy(rel: PRel) -> np.ndarray:
    n = int(rel.n)
    return rel.data[:n].cpu().numpy()


# ----------------------------------------------------------------------
# member axis
# ----------------------------------------------------------------------
def _lift(rel: PRel) -> tuple[PRel, bool]:
    """Give an unbatched relation a member axis of 1."""
    if rel.data.dim() == 3:
        return rel, False
    return PRel(rel.data[None], rel.n.reshape(1), rel.overflow.reshape(1)), True


def _drop(rel: PRel, squeeze: bool) -> PRel:
    if not squeeze:
        return rel
    return PRel(rel.data[0], rel.n[0], rel.overflow[0])


def _gather_rows(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """data (B, R, w), idx (B, K) int64 -> (B, K, w)."""
    return torch.gather(data, 1, idx[..., None].expand(-1, -1, data.shape[2]))


def _columns(data: torch.Tensor, cols) -> torch.Tensor:
    """data[..., cols] for a static column tuple, built from views: an
    index list would be copied to the device (a stream sync) per call."""
    if not cols:
        return data[..., :0]
    return torch.stack([data[..., c] for c in cols], dim=-1)


def _valid_mask(rel: PRel) -> torch.Tensor:
    """(B, cap) mask of the valid prefix of a batched relation."""
    pos = torch.arange(rel.cap, dtype=torch.int32, device=rel.data.device)
    return pos[None, :] < rel.n[:, None]


def _column_values(value):
    """One value per member as a (B, 1) tensor, or a Python scalar, which
    broadcasts without a host-to-device copy (and its stream sync)."""
    if isinstance(value, torch.Tensor):
        return value.to(torch.int32).reshape(-1, 1)
    return int(value)


def compact(data: torch.Tensor, mask: torch.Tensor,
            overflow: torch.Tensor) -> PRel:
    """Stable-partition valid rows to the front and scrub the tail.
    Takes `(cap, w)` or `(B, cap, w)` data with a matching mask."""
    if data.dim() == 2:
        return _drop(compact(data[None], mask[None], overflow.reshape(1)), True)
    # valid rows (key 0) sort first; the sort must be stable
    perm = torch.argsort((~mask).to(torch.uint8), dim=1, stable=True)
    data = _gather_rows(data, perm)
    n = mask.sum(dim=1, dtype=torch.int32)
    keep = torch.arange(data.shape[1], dtype=torch.int32,
                        device=data.device)[None, :] < n[:, None]
    data = torch.where(keep[..., None], data, INVALID)
    return PRel(data, n, overflow)


# ----------------------------------------------------------------------
# operators
# ----------------------------------------------------------------------
def filter_eq(rel: PRel, col: int, value) -> PRel:
    """Keep rows with `data[:, col] == value`.  `value` is a scalar or,
    on a batched relation, one value per member."""
    rel, sq = _lift(rel)
    mask = _valid_mask(rel) & (rel.data[..., col] == _column_values(value))
    return _drop(compact(rel.data, mask, rel.overflow), sq)


def join(left: PRel, right: PRel, lcol: int, rcol: int,
         residual: tuple[tuple[int, int], ...], keep_right: tuple[int, ...],
         out_cap: int, use_kernels: bool = True,
         right_sorted: bool = False) -> PRel:
    """Equi-join on one column pair + residual equality pairs.

    Output columns: all of left's, then right's `keep_right`.
    `right_sorted=True` skips the build-side sort (the planner proved the
    input arrives ordered by `rcol` — six-index sort elision).  Both
    sides are unbatched, or both batched with the same member count.
    """
    left, sq = _lift(left)
    right, _ = _lift(right)
    dev = left.data.device
    lkeys = torch.where(_valid_mask(left), left.data[..., lcol], INVALID)
    rkeys = torch.where(_valid_mask(right), right.data[..., rcol], SENTINEL_HI)
    if right_sorted:
        # valid rows are a sorted prefix; the scrubbed tail maps to +inf
        rsorted = right.data
        rkeys_sorted = rkeys
    else:
        order = torch.argsort(rkeys, dim=1, stable=True)
        rsorted = _gather_rows(right.data, order)
        rkeys_sorted = rkeys.gather(1, order)

    lkeys = lkeys.contiguous()
    rkeys_sorted = rkeys_sorted.contiguous()
    if use_kernels:
        lo, counts = kops.join_count(lkeys, rkeys_sorted)
    else:
        lo = torch.searchsorted(rkeys_sorted, lkeys, side="left",
                                out_int32=True)
        hi = torch.searchsorted(rkeys_sorted, lkeys, side="right",
                                out_int32=True)
        counts = hi - lo
    counts = torch.where(lkeys == INVALID, 0, counts)

    # bounded expansion: output slot p reads left row
    # #{i : inclusive_prefix[i] <= p}, clipped like jnp.repeat's padding
    incl = torch.cumsum(counts, dim=1, dtype=torch.int64)
    total = incl[:, -1]
    offsets = incl - counts                     # exclusive prefix
    B = lkeys.shape[0]
    pos = torch.arange(out_cap, dtype=torch.int64, device=dev
                       ).expand(B, out_cap).contiguous()
    left_idx = torch.searchsorted(incl, pos, right=True).clamp_(
        max=left.cap - 1)
    within = pos - offsets.gather(1, left_idx)
    right_idx = (lo.gather(1, left_idx) + within).clamp_(0, right.cap - 1)
    valid = pos < total.clamp(max=out_cap)[:, None]

    lrows = _gather_rows(left.data, left_idx)
    rrows = _gather_rows(rsorted, right_idx)
    for lc, rc in residual:
        valid = valid & (lrows[..., lc] == rrows[..., rc])
    out = torch.cat([lrows, _columns(rrows, keep_right)], dim=2) \
        if keep_right else lrows
    overflow = left.overflow | right.overflow | (total > out_cap)
    return _drop(compact(out, valid, overflow), sq)


def project(rel: PRel, cols: tuple[int, ...], dedupe: bool) -> PRel:
    rel, sq = _lift(rel)
    data = _columns(rel.data, cols)
    mask = _valid_mask(rel)
    if not dedupe:
        data = torch.where(mask[..., None], data, INVALID)
        return _drop(PRel(data, rel.n, rel.overflow), sq)
    # lexicographic sort: iterate stable argsort minor->major, invalid last
    B, cap = mask.shape
    order = torch.arange(cap, device=data.device).expand(B, cap)
    for c in reversed(range(data.shape[2])):
        keys = torch.where(mask.gather(1, order),
                           data[..., c].gather(1, order), SENTINEL_HI)
        order = order.gather(1, torch.argsort(keys, dim=1, stable=True))
    sorted_rows = _gather_rows(data, order)
    sorted_valid = mask.gather(1, order)
    prev = torch.roll(sorted_rows, 1, dims=1)
    same = torch.all(sorted_rows == prev, dim=2)
    same[:, 0] = False
    keep = sorted_valid & ~same
    return _drop(compact(sorted_rows, keep, rel.overflow), sq)


def scan_pattern_batched(index_data: torch.Tensor,
                         prefix_cols: tuple[int, ...], pvals: torch.Tensor,
                         residual_cols: tuple[int, ...], rvals: torch.Tensor,
                         takes: tuple[int, ...],
                         self_eq: tuple[tuple[int, int], ...],
                         cap: int) -> PRel:
    """`scan_pattern` for B members that share the index and the static
    column positions: `pvals` (B, len(prefix_cols)) and `rvals`
    (B, len(residual_cols)) hold each member's bound values."""
    dev = index_data.device
    n_tt = index_data.shape[0]
    B = pvals.shape[0]
    if len(prefix_cols) == 0:
        # padded TT buffers (capacity-class maintenance uploads, shards)
        # end in SENTINEL_HI rows, which sort last in every index order —
        # count real rows so padding doesn't inflate the overflow check
        real = (index_data[:, 0] != SENTINEL_HI).sum()
        lo = torch.zeros(B, dtype=torch.int64, device=dev)
        hi = real.expand(B)
    elif len(prefix_cols) == 1:
        col = index_data[:, prefix_cols[0]].contiguous()
        key = pvals[:, 0].contiguous()
        lo = torch.searchsorted(col, key, side="left")
        hi = torch.searchsorted(col, key, side="right")
    else:
        # the two prefix columns lead the index order, so the int64 key
        # c1 * 2^32 + c2 (ids >= 0) is ascending: an exact contiguous range
        c1, c2 = prefix_cols
        fused = (index_data[:, c1].to(torch.int64) << 32) \
            | index_data[:, c2].to(torch.int64)
        key = (pvals[:, 0].to(torch.int64) << 32) | pvals[:, 1].to(torch.int64)
        lo = torch.searchsorted(fused, key, side="left")
        hi = torch.searchsorted(fused, key, side="right")
    pos = lo[:, None] + torch.arange(cap, dtype=torch.int64, device=dev)[None]
    valid = pos < hi[:, None]
    rows = index_data[pos.clamp(0, max(n_tt - 1, 0))]      # (B, cap, 3)
    # distributed TT shards are padded with SENTINEL_HI rows; exclude them
    valid = valid & (rows[..., 0] != SENTINEL_HI)
    for i, c in enumerate(residual_cols):
        valid = valid & (rows[..., c] == rvals[:, i:i + 1])
    for a, b in self_eq:
        valid = valid & (rows[..., a] == rows[..., b])
    overflow = (hi - lo) > cap
    return compact(_columns(rows, takes), valid, overflow)


def scan_pattern(index_data: torch.Tensor, prefix: tuple[tuple[int, int], ...],
                 residual: tuple[tuple[int, int], ...],
                 takes: tuple[int, ...], self_eq: tuple[tuple[int, int], ...],
                 cap: int) -> PRel:
    """Range scan of one sorted TT index for a triple pattern.

    index_data: (N,3) sorted lexicographically; `prefix` gives up to two
    (col, value) bindings covered by the sort order — the matching rows
    are one contiguous range located by binary search.
    residual: (col, value) equality filters not covered by the prefix.
    takes: variable positions to output; self_eq: same-var positions.
    """
    dev = index_data.device

    def values(pairs):
        return torch.as_tensor([int(v) for _, v in pairs], dtype=torch.int32,
                               device=dev).reshape(1, len(pairs))

    out = scan_pattern_batched(
        index_data, tuple(c for c, _ in prefix), values(prefix),
        tuple(c for c, _ in residual), values(residual), takes, self_eq, cap)
    return _drop(out, True)


# ----------------------------------------------------------------------
# plan compiler
# ----------------------------------------------------------------------
# all six index orders, as triple positions (s=0, p=1, o=2)
INDEX_NAMES = ("spo", "pos", "osp", "pso", "ops", "sop")
_INDEX_ORDERS = {
    "spo": (0, 1, 2), "pos": (1, 2, 0), "osp": (2, 0, 1),
    "pso": (1, 0, 2), "ops": (2, 1, 0), "sop": (0, 2, 1),
}


def atom_scan_spec(atom, prefer_sorted: str | None = None):
    """Static scan parameters for a TTScan node: pick the index whose sort
    prefix covers the most bound positions (exact contiguous range); among
    ties, prefer the index whose NEXT sort column is the variable a
    downstream merge join wants pre-sorted (sort elision).

    Returns (idx_name, prefix, residual, takes, self_eq, sorted_by) where
    sorted_by is the output variable the rows are ordered by (or None).
    """
    bound = {i: t.id for i, t in enumerate(atom.terms()) if isinstance(t, Const)}
    var_at = {i: t.name for i, t in enumerate(atom.terms())
              if isinstance(t, Var)}

    def next_var(cols, plen):
        for c in cols[plen:]:
            if c in var_at:
                return var_at[c]
            return None  # a bound residual column interrupts sortedness
        return None

    best = None  # (coverage, prefer_hit, idx_name, prefix)
    for idx_name, cols in _INDEX_ORDERS.items():
        prefix = []
        for c in cols:
            if c in bound:
                prefix.append((c, bound[c]))
            else:
                break
        hit = 1 if (prefer_sorted is not None
                    and next_var(cols, len(prefix)) == prefer_sorted) else 0
        key = (len(prefix), hit)
        if best is None or key > best[0]:
            best = (key, idx_name, tuple(prefix))
    _, best_idx, best_prefix = best
    covered = {c for c, _ in best_prefix}
    residual = tuple((c, v) for c, v in bound.items() if c not in covered)
    sorted_by = None
    if not residual:  # residual filters don't reorder, but sortedness on
        # the next column only holds when the prefix is exactly covered
        sorted_by = next_var(_INDEX_ORDERS[best_idx], len(best_prefix))
    takes: list[int] = []
    first: dict[str, int] = {}
    self_eq: list[tuple[int, int]] = []
    for posn, t in enumerate(atom.terms()):
        if isinstance(t, Var):
            if t.name in first:
                self_eq.append((first[t.name], posn))
            else:
                first[t.name] = posn
                takes.append(posn)
    return best_idx, best_prefix, residual, tuple(takes), tuple(self_eq), sorted_by


def range_cardinality(atom, prefix, stats) -> float:
    """Estimated size of the contiguous index range (prefix-bound only) —
    this, not the fully-filtered estimate, sizes the scan buffer."""
    covered = {c for c, _ in prefix}
    p = atom.p.id if (1 in covered and isinstance(atom.p, Const)) else None
    o_val = atom.o.id if (2 in covered and isinstance(atom.o, Const)) else None
    return stats.atom_card(s_bound=0 in covered, p=p, o_bound=2 in covered,
                           o_val=o_val)


def build_executor(plan: Plan, stats, view_infos: dict[int, "cost_mod.RelInfo"],
                   safety: float = 4.0, use_kernels: bool = True,
                   cap_override: Callable[[Plan, float], int] | None = None):
    """Compile a plan into `fn(tt_indexes, views) -> PRel`.

    `tt_indexes`: {index name: (N,3) int32 tensor}
    `views`: {view_id: PRel}
    `view_infos`: {view_id: cost.RelInfo} — extent cardinality + per-column
    distincts (estimated from the view CQ, or measured after
    materialization).  Buffer capacities are static, sized from the same
    estimates the quality function uses; join lead columns are chosen to
    minimize pre-residual expansion.
    """

    def cap_of(node: Plan, rows: float) -> int:
        if cap_override is not None:
            return cap_override(node, rows)
        return cost_mod.capacity_for(rows, safety=safety)

    def build(node: Plan, prefer_sorted: str | None = None
              ) -> tuple[Callable, tuple[str, ...], "cost_mod.RelInfo", str | None]:
        """returns (fn, cols, info, sorted_by)"""
        est = cost_mod.estimate_plan(node, stats, view_infos)
        if isinstance(node, TTScan):
            idx_name, prefix, residual, takes, self_eq, sorted_by = \
                atom_scan_spec(node.atom, prefer_sorted)
            cap = cap_of(node, range_cardinality(node.atom, prefix, stats))
            cols = node.columns()

            def run(tt, views, _f=functools.partial(
                    scan_pattern, prefix=prefix, residual=residual,
                    takes=takes, self_eq=self_eq, cap=cap), _idx=idx_name):
                return _f(tt[_idx])

            return run, cols, est.info, sorted_by
        if isinstance(node, ViewRef):
            def run(tt, views, _vid=node.view_id):
                return views[_vid]

            return run, node.schema, est.info, None
        if isinstance(node, Filter):
            child_fn, cols, _, sorted_by = build(node.child, prefer_sorted)
            ci = cols.index(node.col)

            def run(tt, views, _fn=child_fn, _ci=ci, _v=node.value):
                return filter_eq(_fn(tt, views), _ci, _v)

            # compact() is stable: filtering preserves row order
            return run, cols, est.info, sorted_by
        if isinstance(node, EquiJoin):
            if not node.pairs:
                raise NotImplementedError(
                    "cartesian products are not compiled to the device engine; "
                    "disconnected rewritings stay on the oracle path"
                )
            # pick the lead pair from static estimates, then build children
            # with the sort preference so scans can elide the join sort
            l_est = cost_mod.estimate_plan(node.left, stats, view_infos)
            r_est = cost_mod.estimate_plan(node.right, stats, view_infos)
            doms = [
                max(l_est.info.dcol(l), r_est.info.dcol(r))
                for l, r in node.pairs
            ]
            lead_k = max(range(len(doms)), key=lambda i: doms[i])
            lead_pair = node.pairs[lead_k]
            lf, lcols, linfo, _ = build(node.left)
            rf, rcols, rinfo, r_sorted_by = build(node.right, lead_pair[1])
            lead = (lcols.index(lead_pair[0]), rcols.index(lead_pair[1]))
            residual = tuple(
                (lcols.index(l), rcols.index(r))
                for k, (l, r) in enumerate(node.pairs) if k != lead_k
            )
            lead_rows = max(linfo.rows * rinfo.rows / doms[lead_k], 1e-3)
            drop = {r for _, r in node.pairs}
            keep_right = tuple(i for i, c in enumerate(rcols) if c not in drop)
            out_cols = lcols + tuple(c for c in rcols if c not in drop)
            cap = cap_of(node, lead_rows)
            r_presorted = r_sorted_by == lead_pair[1]

            def run(tt, views, _lf=lf, _rf=rf, _lead=lead, _res=residual,
                    _keep=keep_right, _cap=cap, _rs=r_presorted):
                return join(_lf(tt, views), _rf(tt, views), _lead[0], _lead[1],
                            _res, _keep, _cap, use_kernels=use_kernels,
                            right_sorted=_rs)

            # join output follows left row-major order: sorted by nothing
            # we track (expansion interleaves groups)
            return run, out_cols, est.info, None
        if isinstance(node, Project):
            child_fn, cols, _, sorted_by = build(node.child, prefer_sorted)
            idx = tuple(cols.index(c) for c in node.cols)
            out_sorted = sorted_by if (not node.dedupe and sorted_by in node.cols) \
                else (node.cols[0] if node.dedupe else None)

            def run(tt, views, _fn=child_fn, _idx=idx, _d=node.dedupe):
                return project(_fn(tt, views), _idx, _d)

            return run, node.cols, est.info, out_sorted
        raise TypeError(type(node))

    fn, cols, info, _ = build(plan)
    fn.out_columns = cols   # type: ignore[attr-defined]
    fn.est_rows = info.rows  # type: ignore[attr-defined]
    return fn


def tt_device_indexes(store, device=None) -> dict[str, torch.Tensor]:
    dev = repro_torch.device(device)
    return {name: torch.from_numpy(np.ascontiguousarray(store.index(name))
                                   ).to(dev)
            for name in INDEX_NAMES}


def tt_device_indexes_padded(store, cap: int, device=None
                             ) -> dict[str, torch.Tensor]:
    """TT indexes padded with SENTINEL_HI rows to a fixed capacity class.

    Streaming maintenance re-uploads TT' every batch; padding to a class
    keeps every scan operand shape constant while the store grows.
    Sentinel rows sort after every real id in all six orders, preserving
    binary-search semantics, and `scan_pattern` masks them out."""
    if cap < len(store):
        raise ValueError(
            f"tt capacity class {cap} < store size {len(store)}")
    dev = repro_torch.device(device)
    out = {}
    for name in INDEX_NAMES:
        data = store.index(name)
        buf = np.full((cap, 3), np.iinfo(np.int32).max, dtype=np.int32)
        buf[: len(data)] = data
        out[name] = torch.from_numpy(buf).to(dev)
    return out
