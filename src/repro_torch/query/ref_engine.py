"""Numpy oracle engine: dynamic-shape plan evaluation (ground truth).

Every JAX-engine and kernel result is checked against this module in the
test suite.  Also used to materialize view extents host-side.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.queries import CQ, Const, Var
from repro_torch.errors import InvariantViolation
from repro_torch.query.plan import EquiJoin, Filter, Plan, Project, TTScan, ViewRef
from repro_torch.rdf.triples import TripleStore


class Relation:
    """(rows, columns): rows is (n, w) int32, columns are variable names."""

    __slots__ = ("rows", "cols")

    def __init__(self, rows: np.ndarray, cols: tuple[str, ...]):
        rows = np.asarray(rows, dtype=np.int32)
        if cols:
            rows = rows.reshape(-1, len(cols))
        else:
            # 0-column relation: row COUNT still matters (boolean filter
            # semantics for fully-bound atoms)
            n = len(rows) if rows.ndim else 0
            rows = rows.reshape(n, 0)
        self.rows = rows
        self.cols = tuple(cols)

    def __len__(self) -> int:
        return len(self.rows)

    def col_index(self, name: str) -> int:
        return self.cols.index(name)

    def as_set(self) -> set[tuple[int, ...]]:
        return {tuple(r) for r in self.rows.tolist()}


def scan_atom(store: TripleStore, atom) -> Relation:
    s = atom.s.id if isinstance(atom.s, Const) else None
    p = atom.p.id if isinstance(atom.p, Const) else None
    o = atom.o.id if isinstance(atom.o, Const) else None
    matched = store.scan(s, p, o)
    # build output columns from variable positions (dedupe repeated vars)
    cols: list[str] = []
    takes: list[int] = []
    eq_pairs: list[tuple[int, int]] = []
    first_pos: dict[str, int] = {}
    for pos, t in enumerate(atom.terms()):
        if isinstance(t, Var):
            if t.name in first_pos:
                eq_pairs.append((first_pos[t.name], pos))
            else:
                first_pos[t.name] = pos
                cols.append(t.name)
                takes.append(pos)
    for a, b in eq_pairs:
        matched = matched[matched[:, a] == matched[:, b]]
    return Relation(matched[:, takes] if cols else matched[:, :0], tuple(cols))


def execute(plan: Plan, store: TripleStore | None,
            views: dict[int, Relation] | None = None) -> Relation:
    views = views or {}
    if isinstance(plan, TTScan):
        if store is None:
            raise InvariantViolation("TTScan requires a triple store")
        return scan_atom(store, plan.atom)
    if isinstance(plan, ViewRef):
        ext = views[plan.view_id]
        if ext.cols != plan.schema:
            # align by position (extent columns follow the view head order)
            if len(ext.cols) != len(plan.schema):
                raise InvariantViolation(
                    f"view {plan.view_id} extent arity {ext.cols} does not "
                    f"match reference schema {plan.schema}")
            return Relation(ext.rows, plan.schema)
        return ext
    if isinstance(plan, Filter):
        child = execute(plan.child, store, views)
        i = child.col_index(plan.col)
        return Relation(child.rows[child.rows[:, i] == plan.value], child.cols)
    if isinstance(plan, EquiJoin):
        left = execute(plan.left, store, views)
        right = execute(plan.right, store, views)
        return _join(left, right, plan.pairs)
    if isinstance(plan, Project):
        child = execute(plan.child, store, views)
        idx = [child.col_index(c) for c in plan.cols]
        rows = child.rows[:, idx]
        if plan.dedupe and len(rows):
            rows = np.unique(rows, axis=0)
        return Relation(rows, plan.cols)
    raise TypeError(type(plan))


def _join(left: Relation, right: Relation,
          pairs: tuple[tuple[str, str], ...]) -> Relation:
    rights_drop = {r for _, r in pairs}
    out_cols = left.cols + tuple(c for c in right.cols if c not in rights_drop)
    if len(left) == 0 or len(right) == 0:
        if not pairs:  # cartesian with empty side
            return Relation(np.zeros((0, len(out_cols)), np.int32), out_cols)
        return Relation(np.zeros((0, len(out_cols)), np.int32), out_cols)
    if not pairs:  # cartesian product
        li = np.repeat(np.arange(len(left)), len(right))
        ri = np.tile(np.arange(len(right)), len(left))
    else:
        lkey = np.stack([left.rows[:, left.col_index(l)] for l, _ in pairs], axis=1)
        rkey = np.stack([right.rows[:, right.col_index(r)] for _, r in pairs], axis=1)
        # hash join via python dict on tuple keys (oracle: clarity > speed)
        buckets: dict[tuple, list[int]] = {}
        for j, k in enumerate(map(tuple, rkey.tolist())):
            buckets.setdefault(k, []).append(j)
        li_l, ri_l = [], []
        for i, k in enumerate(map(tuple, lkey.tolist())):
            for j in buckets.get(k, ()):
                li_l.append(i)
                ri_l.append(j)
        li = np.array(li_l, dtype=np.int64)
        ri = np.array(ri_l, dtype=np.int64)
    keep_right = [i for i, c in enumerate(right.cols) if c not in rights_drop]
    rows = np.concatenate(
        [left.rows[li], right.rows[ri][:, keep_right]], axis=1
    ) if len(li) else np.zeros((0, len(out_cols)), np.int32)
    return Relation(rows, out_cols)


def evaluate_cq(cq: CQ, store: TripleStore) -> Relation:
    """Direct evaluation of a CQ over the triple table (oracle)."""
    from repro_torch.query.plan import plan_for_cq

    return execute(plan_for_cq(cq), store)


def evaluate_ucq(cqs, store: TripleStore) -> set[tuple[int, ...]]:
    out: set[tuple[int, ...]] = set()
    for q in cqs:
        out |= evaluate_cq(q, store).as_set()
    return out
