"""RDFS query reformulation: compile schema knowledge into the workload.

Each query becomes a union of conjunctive queries (UCQ) whose plain
evaluation over the raw triples equals the original query's evaluation
over the RDFS-saturated triples (completeness under entailment).  The
rules follow the paper's technical report [3]:

  (s rdf:type C)  ->  (s rdf:type C') for every C' <= C
                  |   (s P ?new)      for every P with domain(P) <= C
                  |   (?new P s)      for every P with range(P)  <= C
  (s P o)         ->  (s P' o)        for every P' <= P

The cartesian product over atoms is deduplicated by canonical key and
capped (reformulation is exponential in the worst case; the cap is a
stop-condition the demo exposes).
"""
from __future__ import annotations

import itertools

from repro_torch.core.queries import CQ, Atom, Const, Term, Var, dedupe_cqs
from repro_torch.rdf.schema import RDFSchema

DEFAULT_MAX_REFORMULATIONS = 2048


def _atom_alternatives(atom: Atom, schema: RDFSchema, type_id: int,
                       fresh_counter: list[int]) -> list[Atom]:
    alts: list[Atom] = []
    if isinstance(atom.p, Const) and atom.p.id == type_id and isinstance(atom.o, Const):
        c = atom.o.id
        for sub in sorted(schema.subclasses(c)):
            alts.append(Atom(atom.s, atom.p, Const(sub)))
        # (x P y) entails (x type C) when domain(P) <= C — and so does any
        # SUBPROPERTY of such a P (P' <= P implies P'-triples are P-triples)
        dom_props: set[int] = set()
        for p in schema.props_with_domain_under(c):
            dom_props |= schema.subproperties(p)
        for p in sorted(dom_props):
            fresh_counter[0] += 1
            alts.append(Atom(atom.s, Const(p), Var(f"_r{fresh_counter[0]}")))
        rng_props: set[int] = set()
        for p in schema.props_with_range_under(c):
            rng_props |= schema.subproperties(p)
        for p in sorted(rng_props):
            fresh_counter[0] += 1
            alts.append(Atom(Var(f"_r{fresh_counter[0]}"), Const(p), atom.s))
        return alts
    if isinstance(atom.p, Const) and atom.p.id != type_id:
        for sub in sorted(schema.subproperties(atom.p.id)):
            alts.append(Atom(atom.s, Const(sub), atom.o))
        return alts
    return [atom]


def reformulate(cq: CQ, schema: RDFSchema, type_id: int,
                max_reformulations: int = DEFAULT_MAX_REFORMULATIONS) -> list[CQ]:
    """CQ -> UCQ, deduplicated; member i is named `{cq.name}#i`."""
    fresh_counter = [0]
    per_atom = [
        _atom_alternatives(a, schema, type_id, fresh_counter) for a in cq.atoms
    ]
    total = 1
    for alts in per_atom:
        total *= len(alts)
    if total > max_reformulations:
        raise ValueError(
            f"reformulation of {cq.name!r} would produce {total} CQs "
            f"(cap {max_reformulations}); raise the cap or simplify the schema"
        )
    out: list[CQ] = []
    for combo in itertools.product(*per_atom):
        out.append(CQ(cq.head, tuple(combo), name=cq.name, weight=cq.weight))
    out = dedupe_cqs(out)
    return [
        CQ(q.head, q.atoms, name=f"{cq.name}#{i}", weight=cq.weight)
        for i, q in enumerate(out)
    ]


def infer_type_id(queries: list[CQ], schema: RDFSchema) -> int | None:
    """Infer the rdf:type predicate id from workload + schema shape.

    A type atom is (?s, type, Class): its predicate is a constant the
    schema does NOT know as a property, and its object is a constant the
    schema DOES know as a class.  Returns the id when exactly one
    predicate qualifies across the workload, else None (ambiguous or no
    evidence — the caller must be told explicitly)."""
    classes: set[int] = set(schema.domain.values()) | set(schema.range_.values())
    for c, parents in schema.subclass.items():
        classes.add(c)
        classes |= parents
    props: set[int] = set(schema.domain) | set(schema.range_)
    for p, parents in schema.subprop.items():
        props.add(p)
        props |= parents
    candidates: set[int] = set()
    for q in queries:
        for atom in q.atoms:
            if (isinstance(atom.p, Const) and isinstance(atom.o, Const)
                    and atom.o.id in classes and atom.p.id not in props):
                candidates.add(atom.p.id)
    if len(candidates) == 1:
        return candidates.pop()
    return None


def reformulate_workload(queries: list[CQ], schema: RDFSchema | None, type_id: int,
                         max_reformulations: int = DEFAULT_MAX_REFORMULATIONS
                         ) -> tuple[list[CQ], dict[str, list[str]]]:
    """Reformulate every workload query; returns (all members, groups)
    where groups maps original name -> member names (union semantics)."""
    if schema is None:
        return list(queries), {q.name: [q.name] for q in queries}
    members: list[CQ] = []
    groups: dict[str, list[str]] = {}
    for q in queries:
        ref = reformulate(q, schema, type_id, max_reformulations)
        members.extend(ref)
        groups[q.name] = [m.name for m in ref]
    return members, groups
