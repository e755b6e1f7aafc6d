"""Vectorized host evaluation of delta plans — the CPU insert engine.

The maintainer's insert candidates come from the SAME per-(view, atom)
delta plan IR whichever engine runs it (`delta_plan.py`); this module
evaluates those plans with numpy instead of the device program.  It
exists because the two engines win on different hardware:

  * device (`WorkloadExecutor` over the shared delta DAG): one fused
    call per batch, shapes pinned to capacity classes — amortizes on an
    accelerator, but on CPU every bucket pays eager dispatch overhead
    and every TT scan walks the full padded class;
  * host (this module): dynamic shapes, selective scans, sort-based
    equi-joins — O(batch + matching triples) per plan with small
    constants, no dispatch overhead.

The reference oracle (`query/ref_engine.py`) evaluates the same IR with
a row-at-a-time dict join; this is its vectorized twin for the
maintenance hot path (joins via factorized codes + argsort/searchsorted
instead of python loops), with an empty-seed short-circuit so a batch
that touches no atom of a view never scans the store for that view.
"""
from __future__ import annotations

import numpy as np

from repro_torch.query.plan import EquiJoin, Filter, Plan, Project, TTScan, ViewRef
from repro_torch.query.ref_engine import Relation, scan_atom


def _fused_key(rows: np.ndarray, cols: list[int]) -> np.ndarray | None:
    """One uint64 sort key per row over <= 2 join columns.  Dictionary
    ids are non-negative int32, so two fit side by side; wider keys (or
    out-of-range ids) return None and take the factorization path."""
    if len(cols) > 2 or (len(rows) and int(rows[:, cols].min()) < 0):
        return None
    k = rows[:, cols[0]].astype(np.uint64)
    if len(cols) == 2:
        k = (k << np.uint64(32)) | rows[:, cols[1]].astype(np.uint64)
    return k


def np_equijoin(left: Relation, right: Relation,
                pairs: tuple[tuple[str, str], ...]) -> Relation:
    """Sort-based equi-join: fuse the (multi-column) key over both
    sides, argsort the right, searchsorted the left — no python loops."""
    rights_drop = {r for _, r in pairs}
    out_cols = left.cols + tuple(c for c in right.cols if c not in rights_drop)
    if len(left) == 0 or len(right) == 0 or not pairs:
        from repro_torch.query.ref_engine import _join

        return _join(left, right, pairs)  # degenerate / cartesian cases
    lcols = [left.col_index(a) for a, _ in pairs]
    rcols = [right.col_index(b) for _, b in pairs]
    lc = _fused_key(left.rows, lcols)
    rc = _fused_key(right.rows, rcols)
    if lc is None or rc is None:  # >2 key columns: factorize instead
        lk = np.stack([left.rows[:, i] for i in lcols], axis=1)
        rk = np.stack([right.rows[:, i] for i in rcols], axis=1)
        _, codes = np.unique(np.concatenate([lk, rk]), axis=0,
                             return_inverse=True)
        lc, rc = codes[: len(lk)], codes[len(lk):]
    order = np.argsort(rc, kind="stable")
    rs = rc[order]
    starts = np.searchsorted(rs, lc, side="left")
    counts = np.searchsorted(rs, lc, side="right") - starts
    total = int(counts.sum())
    if total == 0:
        return Relation(np.zeros((0, len(out_cols)), np.int32), out_cols)
    li = np.repeat(np.arange(len(lc)), counts)
    offs = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
    ri = order[np.repeat(starts, counts) + offs]
    keep_right = [i for i, c in enumerate(right.cols) if c not in rights_drop]
    rows = np.concatenate([left.rows[li], right.rows[ri][:, keep_right]],
                          axis=1)
    return Relation(rows, out_cols)


def execute_host(plan: Plan, store,
                 leaves: dict[int, np.ndarray]) -> Relation:
    """Evaluate one delta plan over the store, resolving `ViewRef` leaves
    from the matched delta relations (`leaves`: pseudo-vid -> (k, w)
    rows in the leaf's variable order)."""
    if isinstance(plan, TTScan):
        return scan_atom(store, plan.atom)
    if isinstance(plan, ViewRef):
        return Relation(leaves[plan.view_id], plan.schema)
    if isinstance(plan, Filter):
        child = execute_host(plan.child, store, leaves)
        i = child.col_index(plan.col)
        return Relation(child.rows[child.rows[:, i] == plan.value],
                        child.cols)
    if isinstance(plan, EquiJoin):
        left = execute_host(plan.left, store, leaves)
        if len(left) == 0:
            # delta plans are left-deep over the seed: an empty seed
            # chain can never produce rows — skip the right-side scan
            drops = {r for _, r in plan.pairs}
            cols = left.cols + tuple(c for c in plan.right.columns()
                                     if c not in drops)
            return Relation(np.zeros((0, len(cols)), np.int32), cols)
        right = execute_host(plan.right, store, leaves)
        return np_equijoin(left, right, plan.pairs)
    if isinstance(plan, Project):
        child = execute_host(plan.child, store, leaves)
        idx = [child.col_index(c) for c in plan.cols]
        rows = child.rows[:, idx]
        if plan.dedupe and len(rows):
            rows = np.unique(rows, axis=0)
        return Relation(rows, plan.cols)
    raise TypeError(type(plan))
