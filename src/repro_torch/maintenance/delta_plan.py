"""Delta planner: per-view incremental plans derived from the view CQs.

For a view V(x̄) :- a_1, …, a_m and an insert batch Δ⁺, the classic
counting-free delta rule (valid here because wizard views are full
projections — every extent row has a unique derivation) is

    ΔV = ∪_i  π_head( (Δ⁺ ⋉ a_i)  ⋈  a_1 … a_{i-1}, a_{i+1} … a_m )

evaluated over TT' = updated store.  Each `Δ⁺ ⋉ a_i` (the batch rows
unifying with atom i, projected onto the atom's variables) enters the
plan IR as a `ViewRef` with a *pseudo view id keyed by the atom's
renaming-invariant pattern* (`dag._atom_key`), so:

  * isomorphic atoms across views/positions share ONE delta relation
    upload and one DAG leaf,
  * every remaining atom is a plain `TTScan` — shared with other delta
    plans through normal DAG interning,
  * the whole delta workload (all views × all atoms) canonicalizes into
    one `WorkloadDAG` executed in a single device call per batch by the
    same bucketed compiler the serving path uses.

Delta relations are padded to a fixed capacity class (`delta_cap`), so
plan shapes are batch-size-independent: steady-state maintenance hits
the persistent compile cache every batch.

Views whose delta plan would be disconnected (cartesian — only possible
when the view body itself was disconnected, since the delta leaf carries
all of atom i's variables) fall back to the host oracle, exactly like
the serving path does for disconnected rewritings.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.queries import Const, Var
from repro_torch.core.state import State
from repro_torch.query.cost import RelInfo
from repro_torch.query.dag import WorkloadDAG, _atom_key, build_dag
from repro_torch.query.plan import EquiJoin, Plan, Project, TTScan, ViewRef
from repro_torch.views.maintenance import is_full_projection

# pseudo view ids for delta relations live far above real view ids
DELTA_VID_BASE = 1_000_000


@dataclass(frozen=True)
class DeltaLeaf:
    """One shared delta relation: batch rows matching one atom pattern."""

    vid: int                                  # pseudo view id
    key: tuple                                # dag._atom_key of the pattern
    width: int                                # distinct variables
    consts: tuple[tuple[int, int], ...]       # (triple position, id)
    self_eq: tuple[tuple[int, int], ...]      # same-variable positions
    takes: tuple[int, ...]                    # first-occurrence positions

    def match(self, batch: np.ndarray) -> np.ndarray:
        """Project the (k, 3) triple batch onto this pattern's variables:
        unification as a vectorized filter + column take."""
        batch = np.asarray(batch, np.int32).reshape(-1, 3)
        mask = np.ones(len(batch), dtype=bool)
        for pos, cid in self.consts:
            mask &= batch[:, pos] == cid
        for a, b in self.self_eq:
            mask &= batch[:, a] == batch[:, b]
        rows = batch[mask][:, list(self.takes)]
        return np.unique(rows, axis=0) if len(rows) else rows


def _leaf_spec(atom) -> tuple[tuple, tuple, tuple]:
    consts, self_eq, takes = [], [], []
    first: dict[str, int] = {}
    for pos, t in enumerate(atom.terms()):
        if isinstance(t, Const):
            consts.append((pos, t.id))
        elif t.name in first:
            self_eq.append((first[t.name], pos))
        else:
            first[t.name] = pos
            takes.append(pos)
    return tuple(consts), tuple(self_eq), tuple(takes)


def _atom_var_names(atom) -> tuple[str, ...]:
    seen: dict[str, None] = {}
    for t in atom.terms():
        if isinstance(t, Var):
            seen.setdefault(t.name)
    return tuple(seen)


@dataclass
class DeltaPlanSet:
    """Everything the maintainer needs to run one insert batch."""

    plans: dict[str, Plan] = field(default_factory=dict)   # root name -> plan
    root_vid: dict[str, int] = field(default_factory=dict)  # root -> view id
    leaves: dict[tuple, DeltaLeaf] = field(default_factory=dict)  # key -> leaf
    oracle_vids: set[int] = field(default_factory=set)
    dag: WorkloadDAG | None = None

    def leaf_list(self) -> list[DeltaLeaf]:
        return sorted(self.leaves.values(), key=lambda l: l.vid)

    def view_infos(self, expected_batch: int) -> dict[int, RelInfo]:
        """Delta relations look like small key-relations to the cost
        model: `expected_batch` rows, every column near-distinct."""
        exp = float(max(expected_batch, 1))
        return {
            leaf.vid: RelInfo(exp, {i: exp for i in range(leaf.width)})
            for leaf in self.leaves.values()
        }


def delta_plan_for_atom(cq, i: int, leaf: DeltaLeaf) -> Plan | None:
    """Left-deep rest-plan for atom i seeded by its delta leaf, in the
    same greedy connected order as `plan_for_cq`.  Returns None when the
    chain disconnects (cartesian — view body was disconnected)."""
    current: Plan = ViewRef(leaf.vid, _atom_var_names(cq.atoms[i]))
    remaining = [TTScan(a) for j, a in enumerate(cq.atoms) if j != i]
    while remaining:
        cur_cols = set(current.columns())
        pick = None
        for j, p in enumerate(remaining):
            shared = cur_cols & set(p.columns())
            if shared:
                pick = (j, tuple(sorted(shared)))
                break
        if pick is None:
            return None
        j, shared = pick
        nxt = remaining.pop(j)
        current = EquiJoin(current, nxt, tuple((c, c) for c in shared))
    head_cols = tuple(h.name for h in cq.head)
    if head_cols != current.columns():
        current = Project(current, head_cols)
    return current


def build_delta_plans(state: State) -> DeltaPlanSet:
    """One delta plan per (view, atom), sharing leaves and scans through
    a single workload DAG."""
    out = DeltaPlanSet()
    next_vid = DELTA_VID_BASE
    for vid in sorted(state.views):
        cq = state.views[vid].cq
        if not is_full_projection(cq):
            # deletion needs unique derivations; keep the whole view on
            # the oracle (the wizard never produces such views)
            out.oracle_vids.add(vid)
            continue
        atom_plans: list[tuple[str, Plan, DeltaLeaf]] = []
        new_leaves: list[DeltaLeaf] = []
        disconnected = False
        for i, atom in enumerate(cq.atoms):
            key = _atom_key(atom)
            leaf = out.leaves.get(key)
            if leaf is None:
                leaf = next((l for l in new_leaves if l.key == key), None)
            if leaf is None:
                consts, self_eq, takes = _leaf_spec(atom)
                leaf = DeltaLeaf(next_vid, key, len(takes), consts,
                                 self_eq, takes)
                new_leaves.append(leaf)
                next_vid += 1
            plan = delta_plan_for_atom(cq, i, leaf)
            if plan is None:
                disconnected = True
                break
            atom_plans.append((f"v{vid}a{i}", plan, leaf))
        if disconnected:
            out.oracle_vids.add(vid)
            continue
        for name, plan, leaf in atom_plans:
            out.plans[name] = plan
            out.root_vid[name] = vid
            out.leaves.setdefault(leaf.key, leaf)
    if out.plans:
        out.dag = build_dag(out.plans)
    return out
