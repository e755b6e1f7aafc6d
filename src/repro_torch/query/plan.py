"""Physical plan algebra for rewritings.

A rewriting (state component R of the paper) is a plan tree whose leaves
are materialized views (`ViewRef`) or the triple table (`TTScan`, used by
the no-views baseline).  Inner nodes re-apply the selections and joins
that transitions removed from views.

Plans are executed by two engines with identical semantics:
  * query/ref_engine.py — numpy, dynamic shapes (oracle),
  * query/engine.py    — JAX, static padded shapes (jittable, shardable).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.queries import Atom, Const, Var


@dataclass(frozen=True)
class Plan:
    def columns(self) -> tuple[str, ...]:
        raise NotImplementedError

    def children(self) -> tuple["Plan", ...]:
        return ()


@dataclass(frozen=True)
class ViewRef(Plan):
    """Scan of a materialized view extent; columns follow the view head."""

    view_id: int
    schema: tuple[str, ...]

    def columns(self) -> tuple[str, ...]:
        return self.schema


@dataclass(frozen=True)
class TTScan(Plan):
    """Scan of the triple table with one triple pattern."""

    atom: Atom

    def columns(self) -> tuple[str, ...]:
        seen: dict[str, None] = {}
        for t in self.atom.terms():
            if isinstance(t, Var):
                seen.setdefault(t.name)
        return tuple(seen)


@dataclass(frozen=True)
class Filter(Plan):
    """sigma_{col = value} — compensation for a selection cut."""

    child: Plan
    col: str
    value: int

    def columns(self) -> tuple[str, ...]:
        return self.child.columns()

    def children(self) -> tuple[Plan, ...]:
        return (self.child,)


@dataclass(frozen=True)
class EquiJoin(Plan):
    """left ⋈ right on pairs of named columns — compensation for a join cut."""

    left: Plan
    right: Plan
    pairs: tuple[tuple[str, str], ...]  # (left_col, right_col)

    def columns(self) -> tuple[str, ...]:
        rights = {r for _, r in self.pairs}
        return self.left.columns() + tuple(
            c for c in self.right.columns() if c not in rights
        )

    def children(self) -> tuple[Plan, ...]:
        return (self.left, self.right)


@dataclass(frozen=True)
class Project(Plan):
    child: Plan
    cols: tuple[str, ...]
    dedupe: bool = True

    def columns(self) -> tuple[str, ...]:
        return self.cols

    def children(self) -> tuple[Plan, ...]:
        return (self.child,)


def rename_columns(plan: Plan, mapping: dict[str, str]) -> Plan:
    """Rename output columns throughout a plan (used by view fusion to
    redirect rewritings onto the surviving isomorphic view)."""
    if isinstance(plan, ViewRef):
        return ViewRef(plan.view_id, tuple(mapping.get(c, c) for c in plan.schema))
    if isinstance(plan, TTScan):
        def sub(t):
            if isinstance(t, Var) and t.name in mapping:
                return Var(mapping[t.name])
            return t
        a = plan.atom
        return TTScan(Atom(sub(a.s), sub(a.p), sub(a.o)))
    if isinstance(plan, Filter):
        return Filter(rename_columns(plan.child, mapping), mapping.get(plan.col, plan.col), plan.value)
    if isinstance(plan, EquiJoin):
        return EquiJoin(
            rename_columns(plan.left, mapping),
            rename_columns(plan.right, mapping),
            tuple((mapping.get(l, l), mapping.get(r, r)) for l, r in plan.pairs),
        )
    if isinstance(plan, Project):
        return Project(
            rename_columns(plan.child, mapping),
            tuple(mapping.get(c, c) for c in plan.cols),
            plan.dedupe,
        )
    raise TypeError(type(plan))


def replace_view(plan: Plan, view_id: int, replacement: Plan) -> Plan:
    """Substitute every `ViewRef(view_id)` by `replacement` (column-aligned)."""
    if isinstance(plan, ViewRef):
        if plan.view_id == view_id:
            rep_cols = replacement.columns()
            if tuple(rep_cols) != tuple(plan.schema):
                # align replacement columns to the old reference's schema
                mapping = dict(zip(rep_cols, plan.schema))
                return rename_columns(replacement, mapping)
            return replacement
        return plan
    if isinstance(plan, TTScan):
        return plan
    if isinstance(plan, Filter):
        return Filter(replace_view(plan.child, view_id, replacement), plan.col, plan.value)
    if isinstance(plan, EquiJoin):
        return EquiJoin(
            replace_view(plan.left, view_id, replacement),
            replace_view(plan.right, view_id, replacement),
            plan.pairs,
        )
    if isinstance(plan, Project):
        return Project(replace_view(plan.child, view_id, replacement), plan.cols, plan.dedupe)
    raise TypeError(type(plan))


def remap_view(plan: Plan, old_vid: int, new_vid: int,
               perm: tuple[int, ...]) -> Plan:
    """Redirect `ViewRef(old_vid)` to `new_vid` with a column permutation:
    new schema[j] = old schema[perm[j]] (view-fusion plumbing)."""
    if isinstance(plan, ViewRef):
        if plan.view_id == old_vid:
            return ViewRef(new_vid, tuple(plan.schema[i] for i in perm))
        return plan
    if isinstance(plan, TTScan):
        return plan
    if isinstance(plan, Filter):
        return Filter(remap_view(plan.child, old_vid, new_vid, perm), plan.col, plan.value)
    if isinstance(plan, EquiJoin):
        return EquiJoin(
            remap_view(plan.left, old_vid, new_vid, perm),
            remap_view(plan.right, old_vid, new_vid, perm),
            plan.pairs,
        )
    if isinstance(plan, Project):
        return Project(remap_view(plan.child, old_vid, new_vid, perm), plan.cols, plan.dedupe)
    raise TypeError(type(plan))


def validate_plan(plan: Plan) -> list[str]:
    """Structural well-formedness of a plan tree: every column an
    operator references must exist in its child's output, join pairs and
    projections must resolve, and ViewRef schemas must be duplicate-free.
    Returns a list of human-readable problems (empty when sound) — the
    static IR verifier turns these into findings instead of letting a
    malformed plan surface as a KeyError mid-compile."""
    problems: list[str] = []
    if isinstance(plan, ViewRef):
        if len(set(plan.schema)) != len(plan.schema):
            problems.append(
                f"ViewRef(v{plan.view_id}) schema has duplicate columns: "
                f"{plan.schema}")
    elif isinstance(plan, TTScan):
        if not plan.columns() and not any(
                isinstance(t, Const) for t in plan.atom.terms()):
            problems.append(f"TTScan {plan.atom!r} has no output columns "
                            "and no constants (empty pattern)")
    elif isinstance(plan, Filter):
        if plan.col not in plan.child.columns():
            problems.append(
                f"Filter references column {plan.col!r} absent from child "
                f"output {plan.child.columns()}")
    elif isinstance(plan, EquiJoin):
        lcols, rcols = plan.left.columns(), plan.right.columns()
        for l, r in plan.pairs:
            if l not in lcols:
                problems.append(f"EquiJoin left column {l!r} absent from "
                                f"{lcols}")
            if r not in rcols:
                problems.append(f"EquiJoin right column {r!r} absent from "
                                f"{rcols}")
    elif isinstance(plan, Project):
        ccols = plan.child.columns()
        for c in plan.cols:
            if c not in ccols:
                problems.append(f"Project column {c!r} absent from child "
                                f"output {ccols}")
    else:
        problems.append(f"unknown plan operator {type(plan).__name__}")
        return problems
    for child in plan.children():
        problems.extend(validate_plan(child))
    return problems


def iter_subplans(plan: Plan):
    """Pre-order traversal over every operator of a plan tree."""
    yield plan
    for c in plan.children():
        yield from iter_subplans(c)


def has_cartesian(plan: Plan) -> bool:
    """True when the plan contains an empty-pairs join (disconnected
    rewriting) — those stay on the oracle path; the device engine only
    compiles connected plans."""
    return any(
        isinstance(p, EquiJoin) and not p.pairs for p in iter_subplans(plan)
    )


def referenced_views(plan: Plan) -> set[int]:
    if isinstance(plan, ViewRef):
        return {plan.view_id}
    out: set[int] = set()
    for c in plan.children():
        out |= referenced_views(c)
    return out


def plan_for_cq(cq, use_tt: bool = True) -> Plan:
    """Left-deep TT-scan plan evaluating a CQ directly over the triple
    table — the paper's no-views baseline, and the shape of view
    materialization jobs."""
    plans: list[Plan] = [TTScan(a) for a in cq.atoms]
    # self-join columns inside one atom are handled by TTScan semantics
    current = plans[0]
    remaining = plans[1:]
    while remaining:
        # pick next scan sharing a column (connected order)
        cur_cols = set(current.columns())
        pick = None
        for i, p in enumerate(remaining):
            shared = cur_cols & set(p.columns())
            if shared:
                pick = (i, tuple(sorted(shared)))
                break
        if pick is None:  # cartesian (disconnected query)
            i, shared = 0, ()
        else:
            i, shared = pick
        nxt = remaining.pop(i)
        current = EquiJoin(current, nxt, tuple((c, c) for c in shared))
    head_cols = tuple(h.name for h in cq.head)
    if head_cols != current.columns():
        current = Project(current, head_cols)
    return current
