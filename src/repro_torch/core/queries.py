"""Conjunctive-query (CQ) model for RDFViewS.

A conjunctive SPARQL query is a set of triple-pattern atoms over the
single triple table, plus a head (projected variables) and a workload
weight.  Views are full-projection CQs (they materialize every variable
of their body) so that rewritings can re-apply selections and joins on
top of them.

Canonicalization (`canonical_key`) gives a hashable form invariant under
variable renaming and atom reordering; it powers view fusion and search
memoization.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Iterator, Mapping, Sequence

from repro_torch.errors import InvariantViolation


@dataclass(frozen=True, order=True)
class Var:
    name: str

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"?{self.name}"


@dataclass(frozen=True, order=True)
class Const:
    id: int

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"#{self.id}"


Term = Var | Const


@dataclass(frozen=True)
class Atom:
    """One triple pattern (s, p, o)."""

    s: Term
    p: Term
    o: Term

    def terms(self) -> tuple[Term, Term, Term]:
        return (self.s, self.p, self.o)

    def vars(self) -> tuple[Var, ...]:
        return tuple(t for t in self.terms() if isinstance(t, Var))

    def consts(self) -> tuple[tuple[int, int], ...]:
        """(position, id) for each constant in the atom."""
        return tuple(
            (i, t.id) for i, t in enumerate(self.terms()) if isinstance(t, Const)
        )

    def signature(self) -> tuple:
        """Shape of the atom ignoring variable identities (canonical aid).
        Uniform ("kind", id) entries so signatures sort across mixed
        constant/variable positions."""
        return tuple(
            ("c", t.id) if isinstance(t, Const) else ("v", -1)
            for t in self.terms()
        )

    def substitute(self, mapping: Mapping[Var, Term]) -> "Atom":
        def sub(t: Term) -> Term:
            return mapping.get(t, t) if isinstance(t, Var) else t

        return Atom(sub(self.s), sub(self.p), sub(self.o))


# Cap on the canonical-labelling search; beyond it we fall back to a greedy
# (deterministic but not perfectly canonical) labelling.  Workload queries
# have a handful of atoms, so this never triggers in practice.
_CANON_BUDGET = 20_000


@dataclass(frozen=True)
class CQ:
    """A conjunctive query: head <- atoms, with a workload weight."""

    head: tuple[Var, ...]
    atoms: tuple[Atom, ...]
    name: str = field(default="", compare=False)
    weight: float = field(default=1.0, compare=False)

    # ------------------------------------------------------------------
    # basic structure
    # ------------------------------------------------------------------
    def all_vars(self) -> tuple[Var, ...]:
        seen: dict[Var, None] = {}
        for a in self.atoms:
            for v in a.vars():
                seen.setdefault(v)
        return tuple(seen)

    def var_positions(self) -> dict[Var, list[tuple[int, int]]]:
        """var -> [(atom_idx, position)] occurrences."""
        occ: dict[Var, list[tuple[int, int]]] = {}
        for i, a in enumerate(self.atoms):
            for pos, t in enumerate(a.terms()):
                if isinstance(t, Var):
                    occ.setdefault(t, []).append((i, pos))
        return occ

    def join_vars(self) -> tuple[Var, ...]:
        """Variables shared by >= 2 atoms (join edges)."""
        occ = self.var_positions()
        return tuple(
            v for v, ps in occ.items() if len({i for i, _ in ps}) >= 2
        )

    def is_connected(self) -> bool:
        if len(self.atoms) <= 1:
            return True
        adj: dict[int, set[int]] = {i: set() for i in range(len(self.atoms))}
        occ = self.var_positions()
        for ps in occ.values():
            idxs = sorted({i for i, _ in ps})
            for a, b in itertools.combinations(idxs, 2):
                adj[a].add(b)
                adj[b].add(a)
        seen = {0}
        stack = [0]
        while stack:
            cur = stack.pop()
            for nxt in adj[cur]:
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append(nxt)
        return len(seen) == len(self.atoms)

    def connected_components(self, drop_var: Var | None = None) -> list[tuple[int, ...]]:
        """Connected components of the atom join graph; edges induced by
        shared variables, optionally ignoring `drop_var` (join-cut probe)."""
        n = len(self.atoms)
        adj: dict[int, set[int]] = {i: set() for i in range(n)}
        for v, ps in self.var_positions().items():
            if drop_var is not None and v == drop_var:
                continue
            idxs = sorted({i for i, _ in ps})
            for a, b in itertools.combinations(idxs, 2):
                adj[a].add(b)
                adj[b].add(a)
        comps: list[tuple[int, ...]] = []
        unseen = set(range(n))
        while unseen:
            root = min(unseen)
            comp = {root}
            stack = [root]
            unseen.discard(root)
            while stack:
                cur = stack.pop()
                for nxt in adj[cur]:
                    if nxt in unseen:
                        unseen.discard(nxt)
                        comp.add(nxt)
                        stack.append(nxt)
            comps.append(tuple(sorted(comp)))
        return comps

    # ------------------------------------------------------------------
    # canonicalization
    # ------------------------------------------------------------------
    def canonical_key(self) -> tuple:
        """Hashable form invariant under variable renaming / atom order.

        Atoms are grouped by signature (constants pin groups); we search
        over within-group permutations, rename variables by first
        occurrence, and keep the lexicographically smallest encoding.
        The head is encoded through the same renaming.
        """
        atoms = list(self.atoms)
        order0 = sorted(range(len(atoms)), key=lambda i: atoms[i].signature())
        groups: list[list[int]] = []
        for i in order0:
            if groups and atoms[groups[-1][-1]].signature() == atoms[i].signature():
                groups[-1].append(i)
            else:
                groups.append([i])

        total = 1
        for g in groups:
            for k in range(2, len(g) + 1):
                total *= k
            if total > _CANON_BUDGET:
                break

        def encode(order: Sequence[int]) -> tuple:
            rename: dict[Var, int] = {}
            enc_atoms = []
            for i in order:
                enc_terms = []
                for t in atoms[i].terms():
                    if isinstance(t, Const):
                        enc_terms.append(("c", t.id))
                    else:
                        if t not in rename:
                            rename[t] = len(rename)
                        enc_terms.append(("v", rename[t]))
                enc_atoms.append(tuple(enc_terms))
            head_enc = tuple(
                ("v", rename[h]) if h in rename else ("free", h.name) for h in self.head
            )
            return (tuple(enc_atoms), tuple(sorted(head_enc)))

        if total > _CANON_BUDGET:  # pragma: no cover - pathological queries only
            return encode(order0)

        best: tuple | None = None
        for perms in itertools.product(
            *[itertools.permutations(g) for g in groups]
        ):
            order = [i for g in perms for i in g]
            cand = encode(order)
            if best is None or cand < best:
                best = cand
        if best is None:
            raise InvariantViolation("canonical search visited no ordering")
        return best

    def canonical_var_order(self) -> tuple[Var, ...]:
        """Variable order consistent with the winning canonical labelling."""
        atoms = list(self.atoms)
        order0 = sorted(range(len(atoms)), key=lambda i: atoms[i].signature())
        groups: list[list[int]] = []
        for i in order0:
            if groups and atoms[groups[-1][-1]].signature() == atoms[i].signature():
                groups[-1].append(i)
            else:
                groups.append([i])

        def encode(order: Sequence[int]) -> tuple[tuple, tuple[Var, ...]]:
            rename: dict[Var, int] = {}
            enc_atoms = []
            for i in order:
                enc_terms = []
                for t in atoms[i].terms():
                    if isinstance(t, Const):
                        enc_terms.append(("c", t.id))
                    else:
                        if t not in rename:
                            rename[t] = len(rename)
                        enc_terms.append(("v", rename[t]))
                enc_atoms.append(tuple(enc_terms))
            head_enc = tuple(
                ("v", rename[h]) if h in rename else ("free", h.name) for h in self.head
            )
            return (tuple(enc_atoms), tuple(sorted(head_enc))), tuple(rename)

        total = 1
        for g in groups:
            for k in range(2, len(g) + 1):
                total *= k

        if total > _CANON_BUDGET:  # pragma: no cover
            return encode([i for g in groups for i in g])[1]

        best: tuple | None = None
        best_vars: tuple[Var, ...] = ()
        for perms in itertools.product(*[itertools.permutations(g) for g in groups]):
            order = [i for g in perms for i in g]
            cand, vars_ = encode(order)
            if best is None or cand < best:
                best, best_vars = cand, vars_
        return best_vars

    def rename_apart(self, suffix: str) -> "CQ":
        mapping = {v: Var(f"{v.name}{suffix}") for v in self.all_vars()}
        return CQ(
            head=tuple(mapping[h] for h in self.head),
            atoms=tuple(a.substitute(mapping) for a in self.atoms),
            name=self.name,
            weight=self.weight,
        )

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        body = " . ".join(
            f"({a.s!r} {a.p!r} {a.o!r})" for a in self.atoms
        )
        return f"CQ[{self.name}]({', '.join(map(repr, self.head))} <- {body})"


def full_projection(atoms: Sequence[Atom], name: str = "", weight: float = 1.0) -> CQ:
    """A view-style CQ projecting every variable of its body."""
    tmp = CQ(head=(), atoms=tuple(atoms))
    return CQ(head=tmp.all_vars(), atoms=tuple(atoms), name=name, weight=weight)


def isomorphism(a: CQ, b: CQ) -> dict[Var, Var] | None:
    """Variable bijection mapping `a` onto `b` (atoms as sets), or None.

    Used by view fusion to redirect rewritings onto the surviving view.
    """
    if len(a.atoms) != len(b.atoms):
        return None
    if a.canonical_key() != b.canonical_key():
        return None
    b_atoms = set(b.atoms)

    a_vars = list(a.all_vars())

    def backtrack(i: int, mapping: dict[Var, Var], used: set[Var]) -> dict[Var, Var] | None:
        if i == len(a_vars):
            mapped = {at.substitute(mapping) for at in a.atoms}
            return dict(mapping) if mapped == b_atoms else None
        for cand in b.all_vars():
            if cand in used:
                continue
            mapping[a_vars[i]] = cand
            # quick pruning: every atom fully mapped so far must exist in b
            ok = True
            for at in a.atoms:
                sub = at.substitute(mapping)
                if not sub.vars() or all(v in mapping.values() for v in sub.vars()):
                    pass
            if ok:
                res = backtrack(i + 1, mapping, used | {cand})
                if res is not None:
                    return res
            del mapping[a_vars[i]]
        return None

    return backtrack(0, {}, set())


def dedupe_cqs(cqs: Sequence[CQ]) -> list[CQ]:
    seen: set = set()
    out: list[CQ] = []
    for q in cqs:
        k = q.canonical_key()
        if k not in seen:
            seen.add(k)
            out.append(q)
    return out
