"""RDF Schema: subclass / subproperty hierarchies + domain / range.

All ids are dictionary-encoded ints.  `closure()` is reflexive-transitive;
reasoning is done once at load, then reformulation (core/reformulation.py)
consults the closed relations.
"""
from __future__ import annotations

from dataclasses import dataclass, field


def _transitive_closure(edges: dict[int, set[int]]) -> dict[int, set[int]]:
    """edges[x] = set of direct supers; returns reflexive-transitive closure
    mapping x -> all supers incl. x."""
    closed: dict[int, set[int]] = {}

    def visit(x: int, stack: set[int]) -> set[int]:
        if x in closed:
            return closed[x]
        if x in stack:  # cycle guard: treat as already-resolved
            return {x}
        stack.add(x)
        acc = {x}
        for y in edges.get(x, ()):
            acc |= visit(y, stack)
        stack.discard(x)
        closed[x] = acc
        return acc

    for x in list(edges):
        visit(x, set())
    return closed


@dataclass
class RDFSchema:
    """subclass/subproperty edges are child -> {direct parents}."""

    subclass: dict[int, set[int]] = field(default_factory=dict)
    subprop: dict[int, set[int]] = field(default_factory=dict)
    domain: dict[int, int] = field(default_factory=dict)   # prop -> class
    range_: dict[int, int] = field(default_factory=dict)   # prop -> class

    _sup_class: dict[int, set[int]] | None = None
    _sup_prop: dict[int, set[int]] | None = None
    _sub_class: dict[int, set[int]] | None = None
    _sub_prop: dict[int, set[int]] | None = None

    # ------------------------------------------------------------------
    def add_subclass(self, child: int, parent: int) -> None:
        self.subclass.setdefault(child, set()).add(parent)
        self._invalidate()

    def add_subprop(self, child: int, parent: int) -> None:
        self.subprop.setdefault(child, set()).add(parent)
        self._invalidate()

    def set_domain(self, prop: int, cls: int) -> None:
        self.domain[prop] = cls
        self._invalidate()

    def set_range(self, prop: int, cls: int) -> None:
        self.range_[prop] = cls
        self._invalidate()

    def _invalidate(self) -> None:
        self._sup_class = self._sup_prop = None
        self._sub_class = self._sub_prop = None

    # ------------------------------------------------------------------
    def _ensure_closed(self) -> None:
        if self._sup_class is None:
            self._sup_class = _transitive_closure(self.subclass)
            self._sup_prop = _transitive_closure(self.subprop)
            inv_c: dict[int, set[int]] = {}
            for c, sups in self._sup_class.items():
                for s in sups:
                    inv_c.setdefault(s, set()).add(c)
            inv_p: dict[int, set[int]] = {}
            for p, sups in self._sup_prop.items():
                for s in sups:
                    inv_p.setdefault(s, set()).add(p)
            self._sub_class = inv_c
            self._sub_prop = inv_p

    def superclasses(self, c: int) -> set[int]:
        self._ensure_closed()
        return self._sup_class.get(c, {c}) | {c}

    def subclasses(self, c: int) -> set[int]:
        """All classes C' with C' <= c (reflexive)."""
        self._ensure_closed()
        return self._sub_class.get(c, set()) | {c}

    def subproperties(self, p: int) -> set[int]:
        self._ensure_closed()
        return self._sub_prop.get(p, set()) | {p}

    def props_with_domain_under(self, c: int) -> set[int]:
        """Properties P with domain(P) <= c: (x P y) entails (x type c)."""
        subs = self.subclasses(c)
        return {p for p, d in self.domain.items() if d in subs}

    def props_with_range_under(self, c: int) -> set[int]:
        subs = self.subclasses(c)
        return {p for p, r in self.range_.items() if r in subs}

    def saturate_instance(self, triples, type_id: int):
        """Forward-chain RDFS entailment over instance triples (numpy array
        (N,3)).  Used as the ground truth that query reformulation must
        match (completeness check).  Returns an (M,3) array, M >= N.
        """
        import numpy as np

        self._ensure_closed()
        out = {tuple(t) for t in np.asarray(triples).tolist()}
        changed = True
        while changed:
            changed = False
            new: set[tuple[int, int, int]] = set()
            for s, p, o in out:
                if p == type_id:
                    for sup in self.superclasses(o):
                        t = (s, type_id, sup)
                        if t not in out:
                            new.add(t)
                else:
                    for sup in self._sup_prop.get(p, set()) | {p}:
                        if sup != p:
                            t = (s, sup, o)
                            if t not in out:
                                new.add(t)
                    d = self.domain.get(p)
                    if d is not None:
                        t = (s, type_id, d)
                        if t not in out:
                            new.add(t)
                    r = self.range_.get(p)
                    if r is not None:
                        t = (o, type_id, r)
                        if t not in out:
                            new.add(t)
            if new:
                out |= new
                changed = True
        arr = np.array(sorted(out), dtype=np.int32)
        return arr
