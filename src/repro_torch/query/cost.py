"""Cardinality estimation + cost model.

Feeds (i) the quality function of the view-selection search and (ii) the
static capacity planner of the JAX engine.  System-R-style independence
assumptions over the triple-store statistics.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.queries import CQ, Atom, Const, Var
from repro_torch.query.plan import EquiJoin, Filter, Plan, Project, TTScan, ViewRef
from repro_torch.rdf.triples import Statistics

# relative per-row costs (calibrated to the JAX engine's ops)
C_SCAN = 1.0
C_FILTER = 0.5
C_JOIN_BUILD = 2.0   # sort side
C_JOIN_PROBE = 1.0
C_OUT = 1.0
C_DEDUPE = 2.0


def atom_cardinality(atom: Atom, stats: Statistics) -> float:
    p = atom.p.id if isinstance(atom.p, Const) else None
    o_val = atom.o.id if isinstance(atom.o, Const) else None
    return stats.atom_card(
        s_bound=isinstance(atom.s, Const), p=p,
        o_bound=isinstance(atom.o, Const), o_val=o_val,
    )


def _var_domain(var: Var, cq: CQ, stats: Statistics) -> float:
    """Estimated #distinct values a variable ranges over (min across its
    occurrences — the most selective role wins)."""
    best = float(max(stats.n_ids, 1))
    for atom in cq.atoms:
        for pos, t in enumerate(atom.terms()):
            if t != var:
                continue
            p = atom.p.id if isinstance(atom.p, Const) else None
            if pos == 0:
                d = stats.pred_distinct_s.get(p, stats.distinct_s) if p is not None else stats.distinct_s
            elif pos == 2:
                d = stats.pred_distinct_o.get(p, stats.distinct_o) if p is not None else stats.distinct_o
            else:
                d = stats.distinct_p
            best = min(best, float(max(d, 1)))
    return best


def cq_cardinality(cq: CQ, stats: Statistics) -> float:
    """Join cardinality estimate: product of atom cards, divided by the
    domain of each join variable once per extra occurrence."""
    card = 1.0
    for a in cq.atoms:
        card *= atom_cardinality(a, stats)
    occ = cq.var_positions()
    for v, ps in occ.items():
        n_atoms = len({i for i, _ in ps})
        if n_atoms >= 2:
            card /= _var_domain(v, cq, stats) ** (n_atoms - 1)
    return max(card, 1e-3)


@dataclass
class RelInfo:
    """Cardinality + per-column distinct-value estimates for a relation."""

    rows: float
    distinct: dict[str, float]

    def dcol(self, col: str) -> float:
        return max(self.distinct.get(col, self.rows), 1.0)


@dataclass
class PlanEstimate:
    rows: float
    cost: float
    info: RelInfo
    lead_rows: float = 0.0  # pre-residual expansion of the topmost join


def _atom_col_distinct(atom: Atom, stats: Statistics, rows: float) -> dict[str, float]:
    p = atom.p.id if isinstance(atom.p, Const) else None
    out: dict[str, float] = {}
    for pos, t in enumerate(atom.terms()):
        if not isinstance(t, Var):
            continue
        if pos == 0:
            d = stats.pred_distinct_s.get(p, stats.distinct_s) if p is not None else stats.distinct_s
        elif pos == 2:
            d = stats.pred_distinct_o.get(p, stats.distinct_o) if p is not None else stats.distinct_o
        else:
            d = stats.distinct_p
        out[t.name] = min(max(float(d), 1.0), max(rows, 1.0))
    return out


def cq_rel_info(cq: CQ, stats: Statistics) -> RelInfo:
    """Extent estimate for a view CQ: rows + per-head-variable distincts."""
    rows = cq_cardinality(cq, stats)
    distinct = {
        v.name: min(_var_domain(v, cq, stats), max(rows, 1.0)) for v in cq.all_vars()
    }
    return RelInfo(rows=max(rows, 1e-3), distinct=distinct)


def estimate_plan(plan: Plan, stats: Statistics,
                  view_infos: dict[int, RelInfo]) -> PlanEstimate:
    """Bottom-up (rows, cost, distincts) estimate of a rewriting plan.

    `view_infos` maps view id -> RelInfo of the (estimated or actual)
    extent; computed once per state from the view CQs, or measured after
    materialization.
    """
    if isinstance(plan, TTScan):
        rows = atom_cardinality(plan.atom, stats)
        info = RelInfo(max(rows, 1e-3), _atom_col_distinct(plan.atom, stats, rows))
        return PlanEstimate(info.rows, C_SCAN * info.rows, info)
    if isinstance(plan, ViewRef):
        vi = view_infos[plan.view_id]
        # align distinct names to the reference schema (positional)
        names = list(vi.distinct)
        if set(names) != set(plan.schema) and len(names) == len(plan.schema):
            distinct = {c: vi.distinct[n] for c, n in zip(plan.schema, names)}
        else:
            distinct = dict(vi.distinct)
        info = RelInfo(vi.rows, distinct)
        return PlanEstimate(info.rows, C_SCAN * info.rows, info)
    if isinstance(plan, Filter):
        child = estimate_plan(plan.child, stats, view_infos)
        sel = 1.0 / child.info.dcol(plan.col)
        rows = max(child.rows * sel, 1e-3)
        distinct = {c: min(d, max(rows, 1.0)) for c, d in child.info.distinct.items()}
        distinct[plan.col] = 1.0
        return PlanEstimate(rows, child.cost + C_FILTER * child.rows,
                            RelInfo(rows, distinct))
    if isinstance(plan, EquiJoin):
        left = estimate_plan(plan.left, stats, view_infos)
        right = estimate_plan(plan.right, stats, view_infos)
        cross = left.rows * right.rows
        rows = cross
        lead_rows = cross
        if plan.pairs:
            doms = [
                max(left.info.dcol(l), right.info.dcol(r)) for l, r in plan.pairs
            ]
            lead_dom = max(doms)
            lead_rows = cross / lead_dom
            for d in doms:
                rows /= d
        rows = max(rows, 1e-3)
        lead_rows = max(lead_rows, 1e-3)
        drop = {r for _, r in plan.pairs}
        distinct: dict[str, float] = {}
        for c, d in left.info.distinct.items():
            distinct[c] = min(d, max(rows, 1.0))
        for c, d in right.info.distinct.items():
            if c not in drop:
                distinct[c] = min(d, max(rows, 1.0))
        cost = (
            left.cost + right.cost
            + C_JOIN_BUILD * right.rows + C_JOIN_PROBE * left.rows
            + C_OUT * lead_rows  # expansion happens before residual filtering
        )
        return PlanEstimate(rows, cost, RelInfo(rows, distinct), lead_rows)
    if isinstance(plan, Project):
        child = estimate_plan(plan.child, stats, view_infos)
        rows = child.rows
        if plan.dedupe:
            limit = 1.0
            for c in plan.cols:
                limit *= child.info.dcol(c)
            rows = min(rows, limit)
        distinct = {c: min(child.info.dcol(c), max(rows, 1.0)) for c in plan.cols}
        extra = C_DEDUPE * child.rows if plan.dedupe else 0.0
        return PlanEstimate(rows, child.cost + extra, RelInfo(rows, distinct))
    raise TypeError(type(plan))


# ----------------------------------------------------------------------
# DAG-wide estimation (workload compiler)
# ----------------------------------------------------------------------
def estimate_dag(dag, stats: Statistics,
                 view_infos: dict[int, RelInfo]) -> list[PlanEstimate]:
    """Bottom-up estimates over a `WorkloadDAG`, one per node, memoized
    by node id — each shared subtree is estimated exactly once, matching
    how the fused executor evaluates it.

    DAG nodes are positional (no column names), so the returned
    `RelInfo.distinct` dicts are keyed by output column *index*; the
    formulas mirror `estimate_plan` exactly.
    """
    ests: list[PlanEstimate] = []
    for node in dag.nodes:
        if node.kind == "scan":
            atom = node.spec
            rows = atom_cardinality(atom, stats)
            named = _atom_col_distinct(atom, stats, rows)
            cols = TTScan(atom).columns()
            info = RelInfo(max(rows, 1e-3),
                           {i: named[c] for i, c in enumerate(cols)})
            ests.append(PlanEstimate(info.rows, C_SCAN * info.rows, info))
        elif node.kind == "view":
            vi = view_infos[node.spec]
            vals = list(vi.distinct.values())
            if len(vals) != node.width:  # stale/missing stats: assume keys
                vals = [vi.rows] * node.width
            info = RelInfo(vi.rows, dict(enumerate(vals)))
            ests.append(PlanEstimate(info.rows, C_SCAN * info.rows, info))
        elif node.kind == "filter":
            child = ests[node.child_ids[0]]
            ci, _value = node.spec
            rows = max(child.rows / child.info.dcol(ci), 1e-3)
            distinct = {c: min(d, max(rows, 1.0))
                        for c, d in child.info.distinct.items()}
            distinct[ci] = 1.0
            ests.append(PlanEstimate(rows, child.cost + C_FILTER * child.rows,
                                     RelInfo(rows, distinct)))
        elif node.kind == "join":
            left = ests[node.child_ids[0]]
            right = ests[node.child_ids[1]]
            pairs = node.spec
            doms = [max(left.info.dcol(l), right.info.dcol(r))
                    for l, r in pairs]
            cross = left.rows * right.rows
            rows = cross
            for d in doms:
                rows /= d
            rows = max(rows, 1e-3)
            lead_rows = max(cross / max(doms), 1e-3)
            lw = dag.nodes[node.child_ids[0]].width
            rw = dag.nodes[node.child_ids[1]].width
            drop = {r for _, r in pairs}
            distinct: dict = {
                i: min(left.info.dcol(i), max(rows, 1.0)) for i in range(lw)
            }
            out = lw
            for j in range(rw):
                if j not in drop:
                    distinct[out] = min(right.info.dcol(j), max(rows, 1.0))
                    out += 1
            cost = (left.cost + right.cost
                    + C_JOIN_BUILD * right.rows + C_JOIN_PROBE * left.rows
                    + C_OUT * lead_rows)
            ests.append(PlanEstimate(rows, cost, RelInfo(rows, distinct),
                                     lead_rows))
        elif node.kind == "project":
            child = ests[node.child_ids[0]]
            idxs, dedupe = node.spec
            rows = child.rows
            if dedupe:
                limit = 1.0
                for c in idxs:
                    limit *= child.info.dcol(c)
                rows = min(rows, limit)
            distinct = {
                i: min(child.info.dcol(src), max(rows, 1.0))
                for i, src in enumerate(idxs)
            }
            extra = C_DEDUPE * child.rows if dedupe else 0.0
            ests.append(PlanEstimate(rows, child.cost + extra,
                                     RelInfo(rows, distinct)))
        else:
            raise TypeError(node.kind)
    return ests


def capacity_for(rows_estimate: float, safety: float = 4.0, floor: int = 128,
                 ceil: int = 1 << 22) -> int:
    """Static buffer capacity for the JAX engine: next power of two above
    safety * estimate (the paper's statistics reused for shape planning)."""
    import math

    target = max(float(rows_estimate) * safety, float(floor))
    cap = 1 << max(int(math.ceil(math.log2(target))), 0)
    return int(min(max(cap, floor), ceil))


def promotion_chain(cap: int, ceil: int = 1 << 22,
                    max_steps: int = 64) -> list[int]:
    """The full capacity-class ladder from `cap` (exclusive) to the
    ceiling, as the adaptive driver would climb it one overflow at a
    time.  Statically bounds the overflow→promote→recompile cycle: the
    chain must be strictly increasing and terminate at the ceiling
    within `max_steps`, else the promotion logic itself is broken and
    the driver would recompile forever.  Raises InvariantViolation on an
    unbounded or non-monotonic chain (the capacity analyzer also reports
    this as a finding)."""
    from repro_torch.errors import InvariantViolation

    chain: list[int] = []
    cur = cap
    for _ in range(max_steps):
        nxt = promote_capacity(cur, ceil)
        if nxt <= cur:
            if cur < ceil:
                raise InvariantViolation(
                    f"promotion stalled at {cur} below the ceiling {ceil}")
            return chain
        chain.append(nxt)
        cur = nxt
    raise InvariantViolation(
        f"promotion chain from {cap} did not reach the ceiling {ceil} "
        f"within {max_steps} steps")


def promote_capacity(cap: int, ceil: int = 1 << 22) -> int:
    """Next capacity class above `cap` (classes are powers of two, so
    promotion doubles).  Returns `cap` unchanged once the ceiling is
    reached — callers treat a no-op promotion as 'cannot grow further'.
    The bucketed executor promotes a whole shape bucket at a time, so
    every member node of the bucket moves to the new class together and
    the bucket's compiled body stays shared."""
    return int(min(max(cap * 2, 2), ceil))
