"""Workload-level common-subexpression DAG over rewriting plans.

Rewritings of one workload overlap heavily: reformulation-group members
share triple-pattern scans, rewritings of different queries scan the
same views, and join subtrees recur across queries.  Per-query tree
compilation re-evaluates every shared fragment once per consumer; this
module hashes `Plan` subtrees across *all* workload rewritings into a
common-subexpression DAG so the physical compiler
(`query/workload.py`) computes each distinct fragment exactly once.

Canonicalization is *positional*: a subtree's key replaces plan-local
column names by structural ordinals (variables by first occurrence
inside an atom, operator arguments by column index in the child's
output).  Two subtrees that are equal up to a renaming of their columns
therefore intern to the same node, and because `Plan.columns()` order is
itself structure-determined, their outputs are positionally aligned —
every consumer can read the shared buffer through its own local names.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.queries import Const, Var
from repro_torch.query.plan import (EquiJoin, Filter, Plan, Project, TTScan,
                              ViewRef, iter_subplans)


@dataclass(frozen=True)
class DagNode:
    """One shared physical operator.

    kind/spec are fully positional (no column names):
      scan:    spec = Atom (representative; variable names arbitrary)
      view:    spec = view_id
      filter:  spec = (child_col_idx, value)
      join:    spec = ((left_idx, right_idx), ...) equality pairs
      project: spec = (child_col_idxs, dedupe)
    """

    id: int
    kind: str
    spec: object
    child_ids: tuple[int, ...]
    width: int
    key: tuple
    plan: Plan  # representative subtree (first interned); for debugging


def derived_width(kind: str, spec, child_widths: tuple[int, ...]) -> int:
    """Output width an operator MUST have, derived from its spec and its
    children's widths — the single source of truth shared by the interner
    and the static IR verifier (`repro.analysis.ir_verifier`).  `view`
    widths are not derivable from the spec (a view id); callers check
    those against the representative plan's schema instead."""
    if kind == "scan":
        return len(TTScan(spec).columns())
    if kind == "filter":
        return child_widths[0]
    if kind == "join":
        drop = {r for _, r in spec}
        return child_widths[0] + sum(
            1 for i in range(child_widths[1]) if i not in drop)
    if kind == "project":
        idxs, _dedupe = spec
        return len(idxs)
    raise TypeError(kind)


def _atom_key(atom) -> tuple:
    """Renaming-invariant atom encoding: constants by id, variables by
    first-occurrence ordinal (captures self-join positions)."""
    rename: dict[str, int] = {}
    enc = []
    for t in atom.terms():
        if isinstance(t, Const):
            enc.append(("c", t.id))
        else:
            if t.name not in rename:
                rename[t.name] = len(rename)
            enc.append(("v", rename[t.name]))
    return tuple(enc)


class WorkloadDAG:
    """Interned plan forest: every distinct subtree is one node; roots
    map workload member names to their rewriting's top node."""

    def __init__(self) -> None:
        self.nodes: list[DagNode] = []
        self.roots: dict[str, int] = {}
        self._by_key: dict[tuple, int] = {}
        self.consumers: dict[int, int] = {}  # node id -> consumer edges
        self.intern_hits = 0  # subtree evaluations avoided by sharing

    # ------------------------------------------------------------------
    def intern(self, plan: Plan) -> int:
        if isinstance(plan, TTScan):
            key = ("scan", _atom_key(plan.atom))
            return self._get_or_add(key, "scan", plan.atom, (),
                                    len(plan.columns()), plan)
        if isinstance(plan, ViewRef):
            key = ("view", plan.view_id)
            return self._get_or_add(key, "view", plan.view_id, (),
                                    len(plan.schema), plan)
        if isinstance(plan, Filter):
            cid = self.intern(plan.child)
            ci = plan.child.columns().index(plan.col)
            key = ("filter", cid, ci, plan.value)
            return self._get_or_add(key, "filter", (ci, plan.value), (cid,),
                                    self.nodes[cid].width, plan)
        if isinstance(plan, EquiJoin):
            if not plan.pairs:
                raise NotImplementedError(
                    "cartesian products are not compiled to the device "
                    "engine; disconnected rewritings stay on the oracle path"
                )
            lid = self.intern(plan.left)
            rid = self.intern(plan.right)
            lcols = plan.left.columns()
            rcols = plan.right.columns()
            pairs = tuple((lcols.index(l), rcols.index(r))
                          for l, r in plan.pairs)
            # pair order never changes the output relation, so sort it out
            # of the key (the spec keeps the original order for lead choice)
            key = ("join", lid, rid, tuple(sorted(pairs)))
            width = derived_width(
                "join", pairs,
                (self.nodes[lid].width, self.nodes[rid].width))
            return self._get_or_add(key, "join", pairs, (lid, rid), width, plan)
        if isinstance(plan, Project):
            cid = self.intern(plan.child)
            ccols = plan.child.columns()
            idxs = tuple(ccols.index(c) for c in plan.cols)
            key = ("project", cid, idxs, plan.dedupe)
            return self._get_or_add(key, "project", (idxs, plan.dedupe),
                                    (cid,), len(idxs), plan)
        raise TypeError(type(plan))

    def _get_or_add(self, key: tuple, kind: str, spec, child_ids: tuple,
                    width: int, plan: Plan) -> int:
        nid = self._by_key.get(key)
        if nid is not None:
            self.intern_hits += 1
            return nid
        nid = len(self.nodes)
        self.nodes.append(DagNode(nid, kind, spec, child_ids, width, key, plan))
        self._by_key[key] = nid
        self.consumers.setdefault(nid, 0)
        for c in child_ids:
            self.consumers[c] = self.consumers.get(c, 0) + 1
        return nid

    def add_root(self, name: str, plan: Plan) -> int:
        nid = self.intern(plan)
        self.roots[name] = nid
        self.consumers[nid] = self.consumers.get(nid, 0) + 1
        return nid

    # ------------------------------------------------------------------
    # stable identity across DAGs
    # ------------------------------------------------------------------
    def content_keys(self) -> list[tuple]:
        """One fully-recursive canonical key per node, stable across DAG
        instances: unlike `DagNode.key` (which embeds DAG-local child
        *ids*), a content key embeds the children's content keys, so the
        same logical subtree built in two different workload DAGs — e.g.
        before and after a `swap_state` hot swap — maps to the same key.
        Used to carry learned buffer capacities across program rebuilds.
        """
        out: list[tuple] = []
        for node in self.nodes:
            if node.kind == "scan":
                out.append(("scan", _atom_key(node.spec)))
            elif node.kind == "view":
                out.append(("view", node.spec))
            elif node.kind == "filter":
                out.append(("filter", node.spec, out[node.child_ids[0]]))
            elif node.kind == "join":
                out.append(("join", tuple(sorted(node.spec)),
                            out[node.child_ids[0]], out[node.child_ids[1]]))
            elif node.kind == "project":
                out.append(("project", node.spec, out[node.child_ids[0]]))
            else:
                raise TypeError(node.kind)
        return out

    # ------------------------------------------------------------------
    # sharing telemetry
    # ------------------------------------------------------------------
    def shared_node_ids(self) -> list[int]:
        """Nodes with more than one consumer (computed once, read many)."""
        return [nid for nid, c in self.consumers.items() if c >= 2]

    @property
    def node_reuse_count(self) -> int:
        """Consumer edges saved by sharing: sum over nodes of
        (consumers - 1); equals the number of subtree evaluations a
        per-query compiler would perform beyond the DAG's."""
        return sum(c - 1 for c in self.consumers.values() if c >= 2)

    def tree_node_count(self) -> int:
        """Total operator count if every root were compiled as a tree."""
        return sum(
            sum(1 for _ in iter_subplans(self.nodes[nid].plan))
            for nid in self.roots.values()
        )

    def stats(self) -> dict:
        tree = self.tree_node_count()
        return {
            "dag_nodes": len(self.nodes),
            "tree_nodes": tree,
            "shared_nodes": len(self.shared_node_ids()),
            "node_reuse_count": self.node_reuse_count,
            "hit_rate": 1.0 - len(self.nodes) / max(tree, 1),
        }


def build_dag(rewritings: dict[str, Plan]) -> WorkloadDAG:
    """Canonicalize every rewriting of the workload into one shared DAG.

    Member names are interned in sorted order so the node numbering (and
    therefore capacity planning and compiled programs) is deterministic.
    """
    dag = WorkloadDAG()
    for name in sorted(rewritings):
        dag.add_root(name, rewritings[name])
    return dag
