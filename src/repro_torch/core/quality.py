"""The quality function: weighted execution cost + maintenance + space.

epsilon(S) = w_exec * Σ_q weight(q)·cost(R(q))
           + w_maint * Σ_v maint(v)
           + w_space * Σ_v space(v)

All terms come from the statistics-driven cost model (query/cost.py), so
the same numbers drive the search, the JAX engine's buffer capacities and
the EXPERIMENTS.md claims.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.queries import CQ
from repro_torch.core.state import State
from repro_torch.query import cost as cost_mod
from repro_torch.rdf.triples import Statistics

BYTES_PER_ID = 4


@dataclass(frozen=True)
class QualityWeights:
    w_exec: float = 1.0
    w_maint: float = 0.1
    w_space: float = 0.01
    update_rate: float = 1.0  # expected triple inserts per query answered


@dataclass
class QualityBreakdown:
    exec_cost: float
    maint_cost: float
    space_bytes: float
    total: float
    per_query: dict[str, float] = field(default_factory=dict)
    per_view_rows: dict[int, float] = field(default_factory=dict)


def view_maintenance_cost(cq: CQ, stats: Statistics) -> float:
    """Expected incremental-maintenance work for one random triple insert.

    For each atom i, the insert matches it with probability
    card(atom_i)/N; the delta query then joins the remaining atoms —
    approximated by the view cardinality over the atom's own cardinality
    (delta-join estimate).
    """
    n = max(stats.n_triples, 1)
    total_card = cost_mod.cq_cardinality(cq, stats)
    cost = 0.0
    for atom in cq.atoms:
        a_card = max(cost_mod.atom_cardinality(atom, stats), 1e-3)
        p_match = min(a_card / n, 1.0)
        delta_cost = max(total_card / a_card, 1.0) + len(cq.atoms)
        cost += p_match * delta_cost
    return cost


@dataclass
class MaintenanceCostModel:
    """Measured per-view maintenance cost, keyed by the view CQ's
    canonical key so measurements survive retunes (view ids change,
    isomorphic views keep their key).

    `measured` holds EWMA'd work units (extent rows touched per update
    triple) reported by the streaming maintainer; views never maintained
    yet fall back to the static `view_maintenance_cost` estimate — the
    paper's a-priori model, progressively replaced by reality."""

    measured: dict = field(default_factory=dict)  # canonical_key -> units
    alpha: float = 0.3  # EWMA smoothing for observe()

    def observe(self, cq: CQ, units_per_triple: float) -> None:
        key = cq.canonical_key()
        prev = self.measured.get(key)
        self.measured[key] = (units_per_triple if prev is None else
                              (1 - self.alpha) * prev
                              + self.alpha * units_per_triple)

    def cost_for(self, cq: CQ, stats: Statistics) -> float:
        got = self.measured.get(cq.canonical_key())
        return view_maintenance_cost(cq, stats) if got is None else got

    def __len__(self) -> int:
        return len(self.measured)


def view_infos_for(state: State, stats: Statistics) -> dict[int, cost_mod.RelInfo]:
    return {vid: cost_mod.cq_rel_info(v.cq, stats) for vid, v in state.views.items()}


def quality(state: State, stats: Statistics,
            weights: QualityWeights = QualityWeights(),
            maint_model: MaintenanceCostModel | None = None
            ) -> QualityBreakdown:
    infos = view_infos_for(state, stats)
    per_query: dict[str, float] = {}
    exec_cost = 0.0
    for q in state.queries:
        est = cost_mod.estimate_plan(state.rewritings[q.name], stats, infos)
        per_query[q.name] = est.cost
        exec_cost += q.weight * est.cost

    maint = 0.0
    space = 0.0
    per_view_rows: dict[int, float] = {}
    for vid, v in state.views.items():
        rows = infos[vid].rows
        per_view_rows[vid] = rows
        space += rows * len(v.cq.head) * BYTES_PER_ID
        unit = (maint_model.cost_for(v.cq, stats) if maint_model is not None
                else view_maintenance_cost(v.cq, stats))
        maint += weights.update_rate * unit

    total = (weights.w_exec * exec_cost + weights.w_maint * maint
             + weights.w_space * space)
    return QualityBreakdown(exec_cost=exec_cost, maint_cost=maint,
                            space_bytes=space, total=total,
                            per_query=per_query, per_view_rows=per_view_rows)
