"""Minimal parsers: conjunctive SPARQL SELECT and N-Triples lines.

The demo lets users edit queries in a SPARQL editor; this is the
programmatic equivalent.  Only the conjunctive fragment is accepted
(SELECT + basic graph pattern), matching the paper's problem model.
"""
from __future__ import annotations

import re

import numpy as np

from repro_torch.core.queries import CQ, Atom, Const, Term, Var
from repro_torch.rdf.dictionary import Dictionary

_SELECT_RE = re.compile(
    r"SELECT\s+(?P<head>[^{]+)\s+WHERE\s*\{(?P<body>.*)\}", re.IGNORECASE | re.DOTALL
)


class SparqlParseError(ValueError):
    pass


def _term(tok: str, d: Dictionary) -> Term:
    tok = tok.strip()
    if tok.startswith("?"):
        return Var(tok[1:])
    if tok.startswith("<") and tok.endswith(">"):
        tok = tok[1:-1]
    if tok.startswith('"') and tok.endswith('"'):
        tok = tok[1:-1]
    if tok == "a":
        tok = "rdf:type"
    return Const(d.encode(tok))


def parse_sparql(text: str, d: Dictionary, name: str = "", weight: float = 1.0) -> CQ:
    m = _SELECT_RE.search(text.strip())
    if not m:
        raise SparqlParseError(f"not a conjunctive SELECT query: {text[:80]!r}")
    head_toks = m.group("head").split()
    head = []
    for tok in head_toks:
        if not tok.startswith("?"):
            raise SparqlParseError(f"head terms must be variables, got {tok!r}")
        head.append(Var(tok[1:]))
    body = m.group("body")
    atoms = []
    for part in [p.strip() for p in body.split(".") if p.strip()]:
        toks = part.split()
        if len(toks) != 3:
            raise SparqlParseError(f"triple pattern must have 3 terms: {part!r}")
        s, p, o = (_term(t, d) for t in toks)
        atoms.append(Atom(s, p, o))
    if not atoms:
        raise SparqlParseError("empty basic graph pattern")
    return CQ(tuple(head), tuple(atoms), name=name, weight=weight)


_NT_RE = re.compile(r'\s*(<[^>]*>|"[^"]*"|\S+)\s+(<[^>]*>|\S+)\s+(<[^>]*>|"[^"]*"|\S+)\s*\.\s*$')


def parse_ntriples(text: str, d: Dictionary) -> np.ndarray:
    """Parse N-Triples-ish lines into an (N,3) int32 array."""
    rows = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _NT_RE.match(line)
        if not m:
            raise SparqlParseError(f"bad N-Triples line: {line!r}")
        ids = []
        for tok in m.groups():
            if tok.startswith("<") and tok.endswith(">"):
                tok = tok[1:-1]
            if tok.startswith('"') and tok.endswith('"'):
                tok = tok[1:-1]
            ids.append(d.encode(tok))
        rows.append(ids)
    return np.array(rows, dtype=np.int32).reshape(-1, 3)
