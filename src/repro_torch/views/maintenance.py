"""Incremental view maintenance reference oracle.

Single-triple inserts (the original oracle, kept verbatim for the
transition suite):

    delta(V, t) = ∪_i  eval( V with atom_i unified against t )  over TT ∪ {t}

Batched deltas (`apply_delta`) extend it to insert+delete streams and
serve as the correctness oracle for the device subsystem in
`repro_torch.maintenance`:

  * effective deletes  Δ⁻ₑ = (TT ∩ Δ⁻) \\ Δ⁺   (insert wins on a tie)
  * effective inserts  Δ⁺ₑ = Δ⁺ \\ TT
  * TT' = (TT \\ Δ⁻) ∪ Δ⁺
  * deletions: views here are full projections (head == all body vars),
    so every extent row IS a total variable assignment and has exactly
    one derivation — a row dies iff any of its instantiated atom
    triples is in Δ⁻ₑ.  No re-derivation or counting needed.
  * insertions: per-atom unification against the batch, rest evaluated
    over TT' (covers multi-delta derivations: every atom of a new
    derivation is either in TT' already or arrives in the same batch).

The quality function only needs the *cost estimate*
(core/quality.view_maintenance_cost); this module implements the actual
maintenance so the estimate is validated against reality in tests.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.queries import CQ, Atom, Const, Term, Var
from repro_torch.query import ref_engine as R
from repro_torch.rdf.triples import TripleStore, triples_in


def _unify(atom: Atom, triple: tuple[int, int, int]) -> dict[Var, Const] | None:
    mapping: dict[Var, Const] = {}
    for t, val in zip(atom.terms(), triple):
        if isinstance(t, Const):
            if t.id != val:
                return None
        else:
            if t in mapping and mapping[t].id != val:
                return None
            mapping[t] = Const(int(val))
    return mapping


def delta_rows(view_cq: CQ, new_store: TripleStore,
               triple: tuple[int, int, int]) -> np.ndarray:
    """Rows added to the view extent by inserting `triple` (the store
    passed in must already contain it)."""
    out: set[tuple[int, ...]] = set()
    for i, atom in enumerate(view_cq.atoms):
        mapping = _unify(atom, triple)
        if mapping is None:
            continue
        rest = [a.substitute(mapping) for j, a in enumerate(view_cq.atoms) if j != i]
        if not rest:
            row = tuple(mapping[h].id for h in view_cq.head)
            out.add(row)
            continue
        sub_head = tuple(
            h for h in view_cq.head if h not in mapping
        )
        sub_cq = CQ(sub_head, tuple(rest), name="_delta")
        rel = R.evaluate_cq(sub_cq, new_store)
        col = {c: k for k, c in enumerate(rel.cols)}
        for r in rel.rows.tolist():
            row = tuple(
                mapping[h].id if h in mapping else r[col[h.name]]
                for h in view_cq.head
            )
            out.add(row)
    if not out:
        return np.zeros((0, len(view_cq.head)), np.int32)
    return np.array(sorted(out), dtype=np.int32)


def maintain(view_cq: CQ, old_extent: np.ndarray, store: TripleStore,
             triple: tuple[int, int, int]) -> tuple[np.ndarray, TripleStore, int]:
    """Insert `triple` into the store and maintain the extent.

    Returns (new_extent, new_store, delta_size)."""
    new_store = store.insert(np.array([triple], np.int32))
    if len(new_store) == len(store):  # duplicate insert: no-op
        return old_extent, new_store, 0
    delta = delta_rows(view_cq, new_store, triple)
    if len(delta) == 0:
        return old_extent, new_store, 0
    merged = np.unique(
        np.concatenate([old_extent.reshape(-1, len(view_cq.head)), delta]), axis=0
    )
    return merged, new_store, int(len(merged) - len(old_extent))


# ----------------------------------------------------------------------
# batched insert/delete deltas
# ----------------------------------------------------------------------
def is_full_projection(view_cq: CQ) -> bool:
    """Head covers every body variable (the shape the wizard's views
    always have) — the precondition for membership-based deletion."""
    return tuple(view_cq.head) == view_cq.all_vars()


def instantiate_atoms(view_cq: CQ, extent: np.ndarray) -> list[np.ndarray]:
    """Per atom, the (n, 3) concrete triples each extent row derives it
    from.  Only valid for full-projection views (total assignments)."""
    extent = np.asarray(extent, np.int32).reshape(-1, len(view_cq.head))
    col = {h.name: k for k, h in enumerate(view_cq.head)}
    out = []
    n = len(extent)
    for atom in view_cq.atoms:
        cols = []
        for t in atom.terms():
            if isinstance(t, Const):
                cols.append(np.full(n, t.id, np.int32))
            else:
                cols.append(extent[:, col[t.name]])
        out.append(np.stack(cols, axis=1) if n else np.zeros((0, 3), np.int32))
    return out


def retract_mask(view_cq: CQ, extent: np.ndarray,
                 eff_deletes: np.ndarray) -> np.ndarray:
    """Boolean mask of extent rows that survive the effective deletes."""
    extent = np.asarray(extent, np.int32).reshape(-1, len(view_cq.head))
    keep = np.ones(len(extent), dtype=bool)
    if len(extent) == 0 or len(eff_deletes) == 0:
        return keep
    for inst in instantiate_atoms(view_cq, extent):
        keep &= ~triples_in(inst, eff_deletes)
    return keep


def effective_delta(store: TripleStore, inserts: np.ndarray | None,
                    deletes: np.ndarray | None
                    ) -> tuple[np.ndarray, np.ndarray]:
    """(effective_inserts, effective_deletes) vs the current store:
    duplicates of existing triples and deletes of absent triples are
    dropped; an insert and delete of the same triple in one batch nets
    to the insert."""
    ins = (np.zeros((0, 3), np.int32) if inserts is None
           else np.unique(np.asarray(inserts, np.int32).reshape(-1, 3), axis=0))
    dels = (np.zeros((0, 3), np.int32) if deletes is None
            else np.unique(np.asarray(deletes, np.int32).reshape(-1, 3), axis=0))
    if len(dels):
        dels = dels[store.contains(dels)]
        if len(ins):
            dels = dels[~triples_in(dels, ins)]
    if len(ins):
        ins = ins[~store.contains(ins)]
    return ins, dels


def apply_delta(view_cq: CQ, old_extent: np.ndarray, store: TripleStore,
                inserts: np.ndarray | None = None,
                deletes: np.ndarray | None = None
                ) -> tuple[np.ndarray, TripleStore]:
    """Batched-delta oracle: maintain `old_extent` (rows in head order)
    through one insert/delete batch.  Returns (new_extent, new_store).

    Views that are not full projections fall back to re-evaluation for
    the delete side (no way to attribute derivations from the extent
    alone); the wizard never produces such views."""
    width = len(view_cq.head)
    old_extent = np.asarray(old_extent, np.int32).reshape(-1, width)
    eff_ins, eff_del = effective_delta(store, inserts, deletes)
    new_store = store.apply_delta(inserts, deletes)

    if len(eff_del):
        if is_full_projection(view_cq):
            extent = old_extent[retract_mask(view_cq, old_extent, eff_del)]
        else:
            extent = R.evaluate_cq(view_cq, new_store).rows.reshape(-1, width)
            extent = np.unique(np.asarray(extent, np.int32), axis=0)
            return extent, new_store
    else:
        extent = old_extent

    if len(eff_ins):
        parts = [extent]
        for t in eff_ins:
            parts.append(delta_rows(view_cq, new_store, tuple(int(v) for v in t)))
        extent = np.unique(np.concatenate(parts), axis=0) if len(parts) > 1 else extent
    elif len(eff_del):
        extent = np.unique(extent, axis=0) if len(extent) else extent
    return extent, new_store
