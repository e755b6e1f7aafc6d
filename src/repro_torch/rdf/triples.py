"""The triple table (TT): dictionary-encoded int32 triples + sorted indexes.

Storage model (TPU adaptation of the paper's RDBMS triple table):
  * one (N, 3) int32 array of deduplicated triples,
  * three sorted copies — SPO, POS, OSP — so that every bound-prefix
    access path is a contiguous range located by binary search
    (`searchsorted` on a fused uint64 key), the vectorized analogue of a
    clustered B-tree.

`Statistics` feeds the cost model (core/quality.py) and the static
capacity planner of the JAX engine.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch import trace

# all six orders (Hexastore [7] / RDF-3X [4], both cited by the paper):
# any bound prefix is a contiguous range AND the scan can emit rows
# pre-sorted on the column a downstream merge join needs (sort elision)
_ORDERS = {
    "spo": (0, 1, 2), "pos": (1, 2, 0), "osp": (2, 0, 1),
    "pso": (1, 0, 2), "ops": (2, 1, 0), "sop": (0, 2, 1),
}


def _fuse_keys(cols: np.ndarray) -> np.ndarray:
    """Fuse 2 leading sort columns into one uint64 key (ids are < 2^31)."""
    c = cols.astype(np.uint64)
    return (c[:, 0] << np.uint64(32)) | c[:, 1]


def _order_keys(rows: np.ndarray, perm: tuple[int, int, int]) -> np.ndarray:
    """Full-row uint64 key in one index order — matches the lexsort of
    `TripleStore.__init__` exactly when every id fits in 21 bits (the
    guard in `apply_delta`), so merge positions come from searchsorted."""
    u = np.asarray(rows, np.int32).astype(np.uint64)
    return ((u[:, perm[0]] << np.uint64(42))
            | (u[:, perm[1]] << np.uint64(21)) | u[:, perm[2]])


def triple_keys(triples: np.ndarray) -> np.ndarray:
    """One comparable key per (s, p, o) row.  Dictionary-encoded ids are
    normally tiny, so the fast path packs 21 bits per position into one
    uint64; ids that don't fit fall back to a structured (void) view.
    Powers vectorized set membership for batched deltas."""
    t = np.ascontiguousarray(np.asarray(triples, np.int32).reshape(-1, 3))
    if len(t) == 0 or int(t.max(initial=0)) < (1 << 21) and int(t.min(initial=0)) >= 0:
        u = t.astype(np.uint64)
        return (u[:, 0] << np.uint64(42)) | (u[:, 1] << np.uint64(21)) | u[:, 2]
    return t.view([("s", np.int32), ("p", np.int32), ("o", np.int32)]).reshape(-1)


def triples_in(triples: np.ndarray, reference: np.ndarray) -> np.ndarray:
    """Boolean mask: which rows of `triples` appear in `reference`."""
    triples = np.asarray(triples, np.int32).reshape(-1, 3)
    reference = np.asarray(reference, np.int32).reshape(-1, 3)
    if len(triples) == 0:
        return np.zeros(0, dtype=bool)
    if len(reference) == 0:
        return np.zeros(len(triples), dtype=bool)
    both = np.concatenate([triples, reference])
    keys = triple_keys(both)  # one keying pass so both sides share a scheme
    # sort only the reference side: O((n + k) log k) beats np.isin's
    # sort-the-concatenation when one side is a small delta batch
    ref = np.sort(keys[len(triples):])
    pos = np.searchsorted(ref, keys[: len(triples)])
    ok = pos < len(ref)
    out = np.zeros(len(triples), dtype=bool)
    out[ok] = ref[pos[ok]] == keys[: len(triples)][ok]
    return out


# keep a full object-value histogram for predicates with at most this many
# distinct objects (rdf:type and other categorical predicates): exact
# per-class counts instead of uniform averages.
_HIST_MAX_DISTINCT = 256


@dataclass(frozen=True)
class Statistics:
    n_triples: int
    n_ids: int
    pred_count: dict[int, int]          # p -> #triples
    pred_distinct_s: dict[int, int]     # p -> #distinct subjects
    pred_distinct_o: dict[int, int]     # p -> #distinct objects
    distinct_s: int
    distinct_o: int
    distinct_p: int
    pred_obj_hist: dict[int, dict[int, int]]  # p -> {o -> count}, low-card preds

    def atom_card(self, s_bound: bool, p: int | None, o_bound: bool,
                  o_val: int | None = None) -> float:
        """Estimated cardinality of one triple pattern (System-R style,
        exact histogram for categorical predicates)."""
        if p is not None:
            base = float(self.pred_count.get(p, 0))
            if base == 0.0:
                return 0.0
            if o_bound:
                hist = self.pred_obj_hist.get(p)
                if hist is not None and o_val is not None:
                    base = float(hist.get(o_val, 0))
                    if base == 0.0:
                        return 0.0
                else:
                    base /= max(self.pred_distinct_o.get(p, 1), 1)
            if s_bound:
                base /= max(self.pred_distinct_s.get(p, 1), 1)
            return max(base, 1e-3)
        base = float(self.n_triples)
        if s_bound:
            base /= max(self.distinct_s, 1)
        if o_bound:
            base /= max(self.distinct_o, 1)
        return max(base, 1e-3)


class TripleStore:
    def __init__(self, triples: np.ndarray, dictionary=None):
        triples = np.asarray(triples, dtype=np.int32).reshape(-1, 3)
        with trace.phase("store.dedupe", rows=len(triples)):
            if len(triples):
                triples = np.unique(triples, axis=0)
        self.triples = triples
        self.dictionary = dictionary
        self._indexes: dict[str, np.ndarray] = {}
        self._keys: dict[str, np.ndarray] = {}
        with trace.phase("store.sort", rows=len(triples)):
            for name, perm in _ORDERS.items():
                proj = triples[:, perm]
                order = np.lexsort((proj[:, 2], proj[:, 1], proj[:, 0]))
                sorted_t = triples[order]
                self._indexes[name] = sorted_t
                self._keys[name] = _fuse_keys(
                    sorted_t[:, perm[:2]].reshape(-1, 2))
        self._stats: Statistics | None = None
        self._rk: np.ndarray | None | bool = None  # lazy sorted row keys

    @property
    def row_keys(self) -> np.ndarray | None:
        """Sorted full-row uint64 keys (spo order), or None when an id
        overflows the 21-bit packing.  Powers O(k log n) `contains`."""
        if self._rk is None:
            t = self.triples
            if len(t) and (int(t.max()) >= (1 << 21) or int(t.min()) < 0):
                self._rk = False
            else:
                self._rk = _order_keys(self._indexes["spo"], (0, 1, 2))
        return None if self._rk is False else self._rk

    def __len__(self) -> int:
        return len(self.triples)

    # ------------------------------------------------------------------
    # access paths
    # ------------------------------------------------------------------
    def index(self, name: str) -> np.ndarray:
        return self._indexes[name]

    def scan(self, s: int | None, p: int | None, o: int | None) -> np.ndarray:
        """All triples matching the (possibly unbound) pattern; (M,3)."""
        # choose the index whose sort prefix covers the bound positions
        if p is not None and o is not None:
            idx, key = "pos", (p, o)
        elif p is not None:
            idx, key = "pos", (p,)
        elif s is not None:
            idx, key = "spo", (s,) if o is None else (s,)
        elif o is not None:
            idx, key = "osp", (o,)
        else:
            res = self._indexes["spo"]
            return res
        data = self._indexes[idx]
        perm = _ORDERS[idx]
        if len(key) == 2:
            fused = self._keys[idx]
            target = (np.uint64(key[0]) << np.uint64(32)) | np.uint64(key[1])
            lo = np.searchsorted(fused, target, side="left")
            hi = np.searchsorted(fused, target, side="right")
        else:
            col = data[:, perm[0]]
            lo = np.searchsorted(col, key[0], side="left")
            hi = np.searchsorted(col, key[0], side="right")
        res = data[lo:hi]
        # residual filters for positions not covered by the index prefix
        for pos, val in (("s", s), ("p", p), ("o", o)):
            if val is None:
                continue
            col_i = {"s": 0, "p": 1, "o": 2}[pos]
            if col_i in (perm[0], perm[1])[: len(key)]:
                continue
            res = res[res[:, col_i] == val]
        return res

    # ------------------------------------------------------------------
    def insert(self, new_triples: np.ndarray) -> "TripleStore":
        """Functional insert (returns a new store); powers maintenance tests."""
        merged = np.concatenate([self.triples, np.asarray(new_triples, np.int32).reshape(-1, 3)])
        return TripleStore(merged, self.dictionary)

    def delete(self, gone_triples: np.ndarray) -> "TripleStore":
        """Functional delete (returns a new store).  Rows not present are
        ignored — deletes are idempotent, like inserts."""
        gone = np.asarray(gone_triples, np.int32).reshape(-1, 3)
        if len(gone) == 0 or len(self.triples) == 0:
            return TripleStore(self.triples, self.dictionary)
        keep = ~triples_in(self.triples, gone)
        return TripleStore(self.triples[keep], self.dictionary)

    def apply_delta(self, inserts: np.ndarray | None = None,
                    deletes: np.ndarray | None = None) -> "TripleStore":
        """TT' = (TT \\ deletes) ∪ inserts — inserts win over deletes on
        the same triple, matching the streaming-delta semantics of
        repro.maintenance.

        The six sorted copies are maintained by merge (delete mask +
        `np.insert` at searchsorted positions per order) instead of
        re-sorting the whole table: O(n + k log n) per order, the term
        that keeps a small-batch maintenance pass from paying the full
        6-lexsort rebuild every batch."""
        ins = (np.zeros((0, 3), np.int32) if inserts is None
               else np.asarray(inserts, np.int32).reshape(-1, 3))
        dels = (np.zeros((0, 3), np.int32) if deletes is None
                else np.asarray(deletes, np.int32).reshape(-1, 3))
        if len(ins) == 0 and len(dels) == 0:
            return self
        hi = max(int(ins.max(initial=0)), int(dels.max(initial=0)),
                 int(self.triples.max(initial=0)))
        lo = min(int(ins.min(initial=0)), int(dels.min(initial=0)))
        if hi >= (1 << 21) or lo < 0:  # ids too wide for fused order keys
            base = self.triples
            if len(dels):
                base = base[~triples_in(base, dels)]
            if len(ins):
                base = np.concatenate([base, ins])
            return TripleStore(base, self.dictionary)
        # net the batch: dedupe inserts, drop present inserts / absent
        # deletes, and let an insert win over a delete of the same triple
        if len(ins):
            ins = ins[np.unique(triple_keys(ins), return_index=True)[1]]
        if len(dels):
            dels = dels[self.contains(dels)]
            if len(ins):  # insert wins over delete of the same triple —
                dels = dels[~triples_in(dels, ins)]  # net BEFORE dropping
        if len(ins):      # inserts that are already present
            ins = ins[~self.contains(ins)]
        st = TripleStore.__new__(TripleStore)
        st.dictionary = self.dictionary
        st._stats = None
        st._rk = None
        st._indexes = {}
        st._keys = {}
        for name, perm in _ORDERS.items():
            data = self._indexes[name]
            keys = _order_keys(data, perm)
            if len(dels):
                pos = np.searchsorted(keys, _order_keys(dels, perm))
                keep = np.ones(len(data), dtype=bool)
                keep[pos] = False  # netted deletes are all present
                data, keys = data[keep], keys[keep]
            if len(ins):
                ik = _order_keys(ins, perm)
                io = np.argsort(ik, kind="stable")
                at = np.searchsorted(keys, ik[io])
                data = np.insert(data, at, ins[io], axis=0)
                if name == "spo":
                    st._rk = np.insert(keys, at, ik[io])
            elif name == "spo":
                st._rk = keys
            st._indexes[name] = data
            st._keys[name] = _fuse_keys(data[:, perm[:2]].reshape(-1, 2))
        st.triples = st._indexes["spo"]  # lexicographic == unique order
        return st

    def contains(self, triples: np.ndarray) -> np.ndarray:
        """Boolean membership mask for a (k, 3) batch of triples."""
        t = np.asarray(triples, np.int32).reshape(-1, 3)
        rk = self.row_keys
        if rk is None or (len(t) and (int(t.max(initial=0)) >= (1 << 21)
                                      or int(t.min(initial=0)) < 0)):
            return triples_in(t, self.triples)
        if len(t) == 0 or len(rk) == 0:
            return np.zeros(len(t), dtype=bool)
        k = _order_keys(t, (0, 1, 2))
        pos = np.searchsorted(rk, k)
        ok = pos < len(rk)
        out = np.zeros(len(t), dtype=bool)
        out[ok] = rk[pos[ok]] == k[ok]
        return out

    # ------------------------------------------------------------------
    @property
    def stats(self) -> Statistics:
        if self._stats is None:
            t = self.triples
            preds, counts = np.unique(t[:, 1], return_counts=True) if len(t) else ([], [])
            pc: dict[int, int] = {}
            pds: dict[int, int] = {}
            pdo: dict[int, int] = {}
            hist: dict[int, dict[int, int]] = {}
            for p, c in zip(np.asarray(preds).tolist(), np.asarray(counts).tolist()):
                mask = t[:, 1] == p
                pc[p] = int(c)
                pds[p] = int(len(np.unique(t[mask, 0])))
                objs, ocounts = np.unique(t[mask, 2], return_counts=True)
                pdo[p] = int(len(objs))
                if len(objs) <= _HIST_MAX_DISTINCT:
                    hist[p] = {int(o): int(n) for o, n in zip(objs, ocounts)}
            n_ids = int(t.max()) + 1 if len(t) else 0
            self._stats = Statistics(
                n_triples=len(t),
                n_ids=n_ids,
                pred_count=pc,
                pred_distinct_s=pds,
                pred_distinct_o=pdo,
                distinct_s=int(len(np.unique(t[:, 0]))) if len(t) else 0,
                distinct_o=int(len(np.unique(t[:, 2]))) if len(t) else 0,
                distinct_p=int(len(pc)),
                pred_obj_hist=hist,
            )
        return self._stats
