"""Search states: S = ⟨V, R⟩ — candidate views + workload rewritings.

Invariant maintained by every transition: for each workload query q,
`rewritings[q.name]` evaluates (over the extents of `views`) to exactly
the answer of q over the triple table.  The property-based test suite
checks this invariant on randomly generated transition paths.

Positional contract: a `ViewRef(vid).schema` is positionally aligned with
`views[vid].cq.head` (names may be plan-local renamings).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field, replace

from repro_torch.core.queries import CQ, Atom, Const, Var, full_projection
from repro_torch.query.plan import Plan, Project, ViewRef, referenced_views


@dataclass(frozen=True)
class View:
    id: int
    cq: CQ  # full projection: head == all body variables


@dataclass(frozen=True)
class State:
    views: dict[int, View] = field(default_factory=dict)
    rewritings: dict[str, Plan] = field(default_factory=dict)
    queries: tuple[CQ, ...] = ()
    next_view_id: int = 0
    next_fresh: int = 0
    # the transition path that produced this state (for the demo UI / logs)
    path: tuple[str, ...] = ()

    # ------------------------------------------------------------------
    def key(self) -> frozenset:
        """Memoization key: the canonical multiset of views."""
        keys: list = []
        for v in self.views.values():
            keys.append(v.cq.canonical_key())
        # multiset: count duplicates
        out: dict = {}
        for k in keys:
            out[k] = out.get(k, 0) + 1
        return frozenset(out.items())

    def live_view_ids(self) -> set[int]:
        used: set[int] = set()
        for p in self.rewritings.values():
            used |= referenced_views(p)
        return used

    def gc(self) -> "State":
        """Drop views no rewriting references."""
        live = self.live_view_ids()
        if live == set(self.views):
            return self
        return replace(self, views={k: v for k, v in self.views.items() if k in live})

    def with_path(self, step: str) -> "State":
        return replace(self, path=self.path + (step,))

    def fresh_var(self) -> tuple[Var, "State"]:
        v = Var(f"_f{self.next_fresh}")
        return v, replace(self, next_fresh=self.next_fresh + 1)

    def summary(self) -> str:  # pragma: no cover - debug aid
        lines = [f"State({len(self.views)} views)"]
        for v in self.views.values():
            lines.append(f"  v{v.id}: {len(v.cq.atoms)} atoms, head={len(v.cq.head)}")
        return "\n".join(lines)


def _materialize_exactly(state_views: dict[int, View],
                         rewritings: dict[str, Plan],
                         q: CQ, nid: int) -> int:
    """Add q's own full-projection view + trivial rewriting (the paper's
    initial-state shape for one query); returns the next free view id."""
    view_cq = full_projection(q.atoms, name=f"v_{q.name}")
    state_views[nid] = View(id=nid, cq=view_cq)
    head_names = tuple(h.name for h in view_cq.head)
    ref = ViewRef(nid, head_names)
    plan: Plan = ref
    q_head = tuple(h.name for h in q.head)
    if q_head != head_names:
        plan = Project(ref, q_head)
    rewritings[q.name] = plan
    return nid + 1


def initial_state(queries: list[CQ]) -> State:
    """The paper's initial state: materialize exactly the workload.

    Best execution cost (each query is a view scan), worst storage /
    maintenance.
    """
    views: dict[int, View] = {}
    rewritings: dict[str, Plan] = {}
    nid = 0
    for q in queries:
        if not q.name:
            raise ValueError("workload queries must be named")
        if q.name in rewritings:
            raise ValueError(f"duplicate query name {q.name!r}")
        nid = _materialize_exactly(views, rewritings, q, nid)
    return State(views=views, rewritings=rewritings, queries=tuple(queries),
                 next_view_id=nid)


def graft_queries(state: State, queries: list[CQ]) -> State:
    """Evolve a tuned state's workload: each new query enters in its
    initial-state shape (own view, trivial rewriting) next to the
    already-relaxed views — the warm-start seed for an incremental
    retune."""
    views = dict(state.views)
    rewritings = dict(state.rewritings)
    nid = state.next_view_id
    for q in queries:
        if not q.name:
            raise ValueError("workload queries must be named")
        if q.name in rewritings:
            raise ValueError(f"duplicate query name {q.name!r}")
        nid = _materialize_exactly(views, rewritings, q, nid)
    return replace(state, views=views, rewritings=rewritings,
                   queries=state.queries + tuple(queries), next_view_id=nid)


def drop_queries(state: State, names: set[str]) -> State:
    """Remove queries from a tuned state; views only they referenced are
    garbage-collected (their extents become droppable dead weight)."""
    missing = names - {q.name for q in state.queries}
    if missing:
        raise KeyError(f"unknown queries: {sorted(missing)}")
    rewritings = {n: p for n, p in state.rewritings.items() if n not in names}
    queries = tuple(q for q in state.queries if q.name not in names)
    return replace(state, rewritings=rewritings, queries=queries).gc()
