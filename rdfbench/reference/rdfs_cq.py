"""The plain reference: conjunctive queries over RDFS-entailed triples.

Straight numpy, independent of the program: it reads the triples, the
ids of the constants the queries name, the schema as name pairs
(`rdfbench.data.<name>`) and the queries as text (the configuration),
works out the subclass and subproperty closures itself, and answers each
query over every triple that the RDFS rules entail from the data
(subproperty, domain, range, subclass).  It imports nothing of the
program and takes nothing the program made.

An atom's entailed extension is built from the data directly: for
`(?x rdf:type C)`, every explicit `(x rdf:type C')` with C' below C, and
every subject (object) of a property whose own or inherited domain
(range) lies below C; for `(?x P ?y)`, the union of the triples of P and
of every property below it.  Atoms are joined by sort and binary search.
"""
from __future__ import annotations

import numpy as np


def closure(pairs) -> dict[str, set[str]]:
    """child -> every name above it, itself included."""
    up: dict[str, set[str]] = {}
    for child, parent in pairs:
        up.setdefault(child, set()).add(parent)
        up.setdefault(parent, set())
    out: dict[str, set[str]] = {}

    def above(x: str, seen: frozenset) -> set[str]:
        if x in out:
            return out[x]
        acc = {x}
        for y in up.get(x, ()):
            if y not in seen:
                acc |= above(y, seen | {x})
        out[x] = acc
        return acc

    for x in list(up):
        above(x, frozenset())
    return out


class Entailed:
    """The triples of one store and what the schema entails from them."""

    def __init__(self, triples: np.ndarray, data, consts: dict,
                 entail: bool = True):
        """`data` is a module of `rdfbench.data`, `consts` the ids of the
        entities the queries name; `entail=False` answers over the
        explicit triples alone (the control's broken guarantee)."""
        t = np.asarray(triples, np.int32).reshape(-1, 3)
        order = np.argsort(t[:, 1], kind="stable")
        self._t = t[order]
        self._p = self._t[:, 1]
        self.schema_names = data.NAMES
        self.names = {**data.NAMES, **{f"<{k}>": v for k, v in consts.items()}}
        self.type_name = data.RDF_TYPE
        self.entail = entail
        self.sup_class = closure(data.SUBCLASS)
        self.sup_prop = closure(data.SUBPROP)
        self.domain = {p: d for p, (d, _r) in data.PROPS.items() if d}
        self.range = {p: r for p, (_d, r) in data.PROPS.items() if r}

    def _explicit(self, p: str) -> np.ndarray:
        pid = self.names[p]
        lo, hi = np.searchsorted(self._p, np.array([pid, pid + 1],
                                                   self._p.dtype))
        return self._t[lo:hi]

    def _sub_props(self, p: str) -> list[str]:
        if not self.entail:
            return [p]
        return sorted(q for q in self.schema_names
                      if p in self.sup_prop.get(q, {q}))

    def pairs(self, p: str) -> tuple[np.ndarray, np.ndarray]:
        """(s, o) of every triple with predicate `p`, entailed included,
        without repeats."""
        rows = [self._explicit(q) for q in self._sub_props(p)]
        t = np.concatenate(rows) if rows else np.zeros((0, 3), np.int32)
        if len(rows) > 1:
            key = np.unique(t[:, 0].astype(np.int64) << 32
                            | t[:, 2].astype(np.int64))
            return key >> 32, key & 0xFFFFFFFF
        return t[:, 0].astype(np.int64), t[:, 2].astype(np.int64)

    def _below(self, c: str) -> list[str]:
        return sorted(k for k in self.schema_names
                      if c in self.sup_class.get(k, {k}))

    def members(self, c: str) -> np.ndarray:
        """Every x with `(x rdf:type c)` entailed."""
        typed = self._explicit(self.type_name)
        below = [self.names[k] for k in self._below(c)] if self.entail \
            else [self.names[c]]
        parts = [typed[np.isin(typed[:, 2], below), 0]]
        if self.entail:
            for p in sorted(set(self.domain) | set(self.range)
                            | set(self.sup_prop)):
                # p's triples type their subject by the domain of p and
                # of every property above p
                doms = {self.domain[q] for q in self.sup_prop.get(p, {p})
                        if q in self.domain}
                rngs = {self.range[q] for q in self.sup_prop.get(p, {p})
                        if q in self.range}
                t = self._explicit(p)
                if any(c in self.sup_class.get(d, {d}) for d in doms):
                    parts.append(t[:, 0])
                if any(c in self.sup_class.get(r, {r}) for r in rngs):
                    parts.append(t[:, 2])
        return np.unique(np.concatenate(parts).astype(np.int64))

    def atom(self, s: str, p: str, o: str) -> dict[str, np.ndarray]:
        """The bindings of one atom: variable -> column."""
        if p.startswith("?"):
            raise NotImplementedError("a variable predicate")
        if p == self.type_name:
            if o.startswith("?"):
                raise NotImplementedError("a variable class")
            xs = self.members(o)
            if not s.startswith("?"):
                return {} if self.names.get(s) in set(xs.tolist()) else None
            return {s: xs}
        cs, co = self.pairs(p)
        keep = np.ones(len(cs), bool)
        if not s.startswith("?"):
            keep &= cs == self.names[s]
        if not o.startswith("?"):
            keep &= co == self.names[o]
        if s.startswith("?") and s == o:
            keep &= cs == co
        out = {}
        if s.startswith("?"):
            out[s] = cs[keep]
        if o.startswith("?") and o != s:
            out[o] = co[keep]
        return out


def _key(table: dict, vs: list[str]) -> np.ndarray:
    k = table[vs[0]].astype(np.int64)
    if len(vs) > 1:
        k = (k << 32) | table[vs[1]].astype(np.int64)
    return k


def join(left: dict, right: dict) -> dict:
    """Natural join of two binding tables (many to many)."""
    shared = [v for v in left if v in right]
    if not shared:
        raise NotImplementedError("a cartesian product")
    lk, rk = _key(left, shared[:2]), _key(right, shared[:2])
    order = np.argsort(rk, kind="stable")
    rks = rk[order]
    lo = np.searchsorted(rks, lk, "left")
    cnt = np.searchsorted(rks, lk, "right") - lo
    total = int(cnt.sum())
    li = np.repeat(np.arange(len(lk)), cnt)
    start = np.repeat(lo - (np.cumsum(cnt) - cnt), cnt)
    ri = order[start + np.arange(total)]
    out = {v: col[li] for v, col in left.items()}
    keep = np.ones(total, bool)
    for v, col in right.items():
        if v in shared[2:]:
            keep &= out[v] == col[ri]
        elif v not in out:
            out[v] = col[ri]
    if not keep.all():
        out = {v: col[keep] for v, col in out.items()}
    return out


def unique_rows(rows: np.ndarray) -> np.ndarray:
    """Distinct rows of an (N, W) int array, sorted."""
    rows = np.asarray(rows, np.int64)
    if rows.ndim == 1:
        rows = rows[:, None]
    if len(rows) == 0:
        return rows
    order = np.lexsort(rows.T[::-1])
    r = rows[order]
    keep = np.ones(len(r), bool)
    keep[1:] = (r[1:] != r[:-1]).any(axis=1)
    return r[keep]


def evaluate(ent: Entailed, head, atoms) -> np.ndarray:
    """The answer rows of one conjunctive query, distinct and sorted."""
    tables = []
    for s, p, o in atoms:
        t = ent.atom(s, p, o)
        if t is None:       # a ground atom that does not hold
            return np.zeros((0, len(head)), np.int64)
        if t:
            tables.append(t)
    tables.sort(key=lambda t: len(next(iter(t.values()))))
    acc = tables.pop(0)
    while tables:
        i = min((i for i, t in enumerate(tables) if set(t) & set(acc)),
                key=lambda i: len(next(iter(tables[i].values()))))
        acc = join(acc, tables.pop(i))
    return unique_rows(np.stack([acc[v] for v in head], axis=1))


def answers(triples: np.ndarray, data, consts: dict, queries: dict,
            names=None, entail: bool = True) -> dict[str, np.ndarray]:
    """query name -> its answer rows, for `names` (default: all of
    `queries`, name -> (head, atoms) as the configuration writes them)."""
    ent = Entailed(triples, data, consts, entail=entail)
    return {q: evaluate(ent, *queries[q]) for q in (names or queries)}


def _row_keys(rows: np.ndarray) -> np.ndarray | None:
    """One int64 per row for rows of one or two non-negative int32
    columns; None for wider rows."""
    rows = np.asarray(rows, np.int64)
    if rows.ndim == 1:
        return rows
    if rows.shape[1] == 1:
        return rows[:, 0]
    if rows.shape[1] == 2:
        return rows[:, 0] << 32 | rows[:, 1]
    return None


def diff_counts(got: np.ndarray, want: np.ndarray) -> tuple[int, int]:
    """(rows of `want` missing from `got`, rows of `got` not in `want`),
    as sets of rows."""
    got, want = np.asarray(got), np.asarray(want)
    if len(got) == 0 or len(want) == 0:
        return len(unique_rows(want)), len(unique_rows(got))
    if got.ndim == want.ndim == 2 and got.shape[1] != want.shape[1]:
        raise ValueError(f"rows of width {got.shape[1]} against "
                         f"{want.shape[1]}")
    gk, wk = _row_keys(got), _row_keys(want)
    if gk is not None and wk is not None:
        g, w = np.unique(gk), np.unique(wk)
        common = int(np.isin(g, w, assume_unique=True).sum())
        return len(w) - common, len(g) - common
    g, w = unique_rows(got), unique_rows(want)
    common = len(g) + len(w) - len(unique_rows(np.concatenate([g, w])))
    return len(w) - common, len(g) - common
