"""The three transitions of the paper: selection cut, join cut, view fusion.

Each transition maps a state to a successor state, updating both the view
set V and every affected rewriting in R so the state invariant holds
(rewritings answer the workload exactly).

  * selection cut — relax a constant in a view to a fresh variable; the
    rewritings compensate with sigma (Filter) + a no-dedupe Project that
    restores the original arity/order.
  * join cut — split a view across a join variable whose removal
    disconnects its atom set; rewritings compensate with an EquiJoin.
  * view fusion — merge two views that are identical up to variable
    renaming; rewritings are redirected through a column permutation.

Relaxations (cuts) make views more generic, which is what enables fusion
to discover shared sub-queries across the workload — the paper's route to
storage savings.
"""
from __future__ import annotations

import itertools
from dataclasses import replace
from typing import Iterator

from repro_torch.core.queries import CQ, Atom, Const, Var, full_projection, isomorphism
from repro_torch.core.state import State, View
from repro_torch.errors import InvariantViolation, require
from repro_torch.query.plan import (EquiJoin, Filter, Plan, Project, ViewRef,
                              referenced_views, remap_view, replace_view)


def _update_rewritings(state: State, vid: int, replacement: Plan) -> dict[str, Plan]:
    out = {}
    for name, plan in state.rewritings.items():
        out[name] = replace_view(plan, vid, replacement) if vid in referenced_views(plan) else plan
    return out


# ----------------------------------------------------------------------
# selection cut
# ----------------------------------------------------------------------
def selection_cut_candidates(state: State, allow_predicate_cut: bool = False
                             ) -> Iterator[tuple[int, int, int]]:
    """(view_id, atom_idx, position) for every constant occurrence."""
    for vid, v in state.views.items():
        for ai, atom in enumerate(v.cq.atoms):
            for pos, t in enumerate(atom.terms()):
                if isinstance(t, Const):
                    if pos == 1 and not allow_predicate_cut:
                        continue
                    yield (vid, ai, pos)


def apply_selection_cut(state: State, vid: int, atom_idx: int, pos: int) -> State:
    view = state.views[vid]
    atom = view.cq.atoms[atom_idx]
    const = atom.terms()[pos]
    if not isinstance(const, Const):
        raise InvariantViolation("selection cut needs a constant")
    fresh, state = state.fresh_var()
    new_terms = list(atom.terms())
    new_terms[pos] = fresh
    new_atoms = list(view.cq.atoms)
    new_atoms[atom_idx] = Atom(*new_terms)
    new_cq = full_projection(new_atoms, name=f"{view.cq.name}+sc")
    new_vid = state.next_view_id
    new_view = View(new_vid, new_cq)

    old_head = tuple(h.name for h in view.cq.head)
    new_head = tuple(h.name for h in new_cq.head)
    # compensation: sigma_{fresh = const} then restore the old column order
    comp: Plan = Filter(ViewRef(new_vid, new_head), fresh.name, const.id)
    comp = Project(comp, old_head, dedupe=False)

    views = dict(state.views)
    del views[vid]
    views[new_vid] = new_view
    rewritings = _update_rewritings(state, vid, comp)
    return replace(
        state, views=views, rewritings=rewritings, next_view_id=new_vid + 1,
    ).gc().with_path(f"sc(v{vid},a{atom_idx},p{pos})")


# ----------------------------------------------------------------------
# join cut
# ----------------------------------------------------------------------
def join_cut_candidates(state: State) -> Iterator[tuple[int, Var, tuple[int, ...]]]:
    """(view_id, var, atom-component) such that dropping `var`'s edges
    splits the view into `component` + rest, sharing only `var`."""
    for vid, v in state.views.items():
        if len(v.cq.atoms) < 2:
            continue
        occ = v.cq.var_positions()
        for x in v.cq.join_vars():
            comps = v.cq.connected_components(drop_var=x)
            if len(comps) < 2:
                continue
            x_atoms = {i for i, _ in occ[x]}
            for comp in comps:
                comp_set = set(comp)
                # both sides of the split must contain the cut variable
                if not (x_atoms & comp_set) or not (x_atoms - comp_set):
                    continue
                yield (vid, x, comp)


def apply_join_cut(state: State, vid: int, x: Var, comp: tuple[int, ...]) -> State:
    view = state.views[vid]
    part1 = [view.cq.atoms[i] for i in comp]
    part2 = [a for i, a in enumerate(view.cq.atoms) if i not in comp]
    require(bool(part1 and part2), "join cut must split the view")
    cq1 = full_projection(part1, name=f"{view.cq.name}+jc1")
    cq2 = full_projection(part2, name=f"{view.cq.name}+jc2")
    # both sides must still contain the cut variable
    require(x in cq1.all_vars() and x in cq2.all_vars(),
            f"cut variable {x!r} must appear on both sides of the split")
    # the two parts share only x (guaranteed by component construction)
    shared = set(cq1.all_vars()) & set(cq2.all_vars())
    require(shared == {x}, f"parts share {shared}, expected only {x}")

    vid1 = state.next_view_id
    vid2 = vid1 + 1
    head1 = tuple(h.name for h in cq1.head)
    head2 = tuple(h.name for h in cq2.head)
    joined = EquiJoin(ViewRef(vid1, head1), ViewRef(vid2, head2),
                      pairs=((x.name, x.name),))
    old_head = tuple(h.name for h in view.cq.head)
    comp_plan: Plan = Project(joined, old_head, dedupe=False)

    views = dict(state.views)
    del views[vid]
    views[vid1] = View(vid1, cq1)
    views[vid2] = View(vid2, cq2)
    rewritings = _update_rewritings(state, vid, comp_plan)
    return replace(
        state, views=views, rewritings=rewritings, next_view_id=vid2 + 1,
    ).gc().with_path(f"jc(v{vid},{x.name})")


# ----------------------------------------------------------------------
# view fusion
# ----------------------------------------------------------------------
def fusion_candidates(state: State) -> Iterator[tuple[int, int]]:
    """(keep_vid, drop_vid) pairs of views equal up to variable renaming."""
    by_key: dict = {}
    for vid in sorted(state.views):
        k = state.views[vid].cq.canonical_key()
        by_key.setdefault(k, []).append(vid)
    for vids in by_key.values():
        for a, b in itertools.combinations(vids, 2):
            yield (a, b)


def apply_fusion(state: State, keep_vid: int, drop_vid: int) -> State:
    keep, drop = state.views[keep_vid], state.views[drop_vid]
    iso = isomorphism(drop.cq, keep.cq)
    if iso is None:
        raise InvariantViolation("fusion requires isomorphic views")
    # perm[j]: position in drop.head of the variable mapped to keep.head[j]
    drop_pos = {h: i for i, h in enumerate(drop.cq.head)}
    keep_pos = {h: j for j, h in enumerate(keep.cq.head)}
    perm = [0] * len(keep.cq.head)
    for dvar, kvar in iso.items():
        perm[keep_pos[kvar]] = drop_pos[dvar]
    views = dict(state.views)
    del views[drop_vid]
    rewritings = {
        name: remap_view(plan, drop_vid, keep_vid, tuple(perm))
        for name, plan in state.rewritings.items()
    }
    return replace(state, views=views, rewritings=rewritings).gc().with_path(
        f"fuse(v{keep_vid}<-v{drop_vid})"
    )


# ----------------------------------------------------------------------
# successor enumeration
# ----------------------------------------------------------------------
def successors(state: State, allow_predicate_cut: bool = False) -> Iterator[State]:
    for a, b in fusion_candidates(state):
        yield apply_fusion(state, a, b)
    for vid, ai, pos in selection_cut_candidates(state, allow_predicate_cut):
        yield apply_selection_cut(state, vid, ai, pos)
    for vid, x, comp in join_cut_candidates(state):
        yield apply_join_cut(state, vid, x, comp)


def is_fully_relaxed(state: State) -> bool:
    """Stop condition: every view is a single const-free atom (the TT
    itself) — no further transition can be useful."""
    for v in state.views.values():
        if len(v.cq.atoms) > 1:
            return False
        if any(isinstance(t, Const) for t in v.cq.atoms[0].terms()):
            return False
    return True
