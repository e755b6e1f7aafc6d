"""The plain reference against the port, and its own parts by hand."""
from __future__ import annotations

import itertools
import json

import numpy as np
import pytest

from rdfbench import program, registry
from rdfbench.data import lubm
from rdfbench.reference import rdfs_cq


CONFIG = json.loads((registry.HERE / "configs" / "lubm-50.json").read_text())
QUERIES = CONFIG["queries"]


@pytest.fixture(scope="module")
def port_at_2():
    pytest.importorskip("repro_torch.rdf.triples")
    from repro_torch.api import TuningSession
    from repro_torch.core.search import SearchConfig
    from repro_torch.core.wizard import WizardConfig
    from repro_torch.rdf.triples import TripleStore

    triples, consts = lubm.make(2, seed=3)
    d, schema, wl = program.port_inputs(CONFIG, lubm, consts)
    cfg = WizardConfig(search=SearchConfig(**CONFIG["search"]),
                       **CONFIG["wizard"])
    s = TuningSession(TripleStore(lubm.saturate(triples), d), wl,
                      schema=schema, type_id=lubm.NAMES[lubm.RDF_TYPE],
                      cfg=cfg, device="cpu")
    s.retune()
    s.apply()
    return triples, consts, s


@pytest.mark.parametrize("query", sorted(QUERIES))
def test_reference_equals_the_port(port_at_2, query):
    triples, consts, session = port_at_2
    want = rdfs_cq.answers(triples, lubm, consts, QUERIES, names=[query])[query]
    width = len(QUERIES[query][0])
    got = np.array(sorted(session.executor.answer_group(query)),
                   np.int64).reshape(-1, width)
    direct = np.array(sorted(session.executor.answer_group_direct(query)),
                      np.int64).reshape(-1, width)
    if query not in ("q10", "q11", "q12", "q13"):   # empty under RDFS
        assert len(want) > 0
    assert rdfs_cq.diff_counts(got, want) == (0, 0)
    assert rdfs_cq.diff_counts(direct, want) == (0, 0)


def test_entailment_equals_plain_answers_over_the_closure():
    triples, consts = lubm.make(1, seed=11)
    full = rdfs_cq.answers(triples, lubm, consts, QUERIES)
    closed = rdfs_cq.answers(lubm.saturate(triples), lubm, consts, QUERIES,
                             entail=False)
    for q in QUERIES:
        assert rdfs_cq.diff_counts(closed[q], full[q]) == (0, 0), q


def test_without_entailment_q6_loses_every_row():
    triples, consts = lubm.make(1, seed=12)
    full = rdfs_cq.answers(triples, lubm, consts, QUERIES)
    bare = rdfs_cq.answers(triples, lubm, consts, QUERIES, entail=False)
    assert len(full["q6"]) > 0
    assert rdfs_cq.diff_counts(bare["q6"], full["q6"]) == (len(full["q6"]), 0)


def test_join_many_to_many_matches_brute_force():
    rng = np.random.default_rng(0)
    left = {"?a": rng.integers(0, 5, 40), "?b": rng.integers(0, 4, 40)}
    right = {"?b": rng.integers(0, 4, 30), "?c": rng.integers(0, 6, 30),
             "?a": rng.integers(0, 5, 30)}
    got = rdfs_cq.join(left, right)
    rows = {(a, b, c) for (a, b), (b2, c, a2) in itertools.product(
        zip(left["?a"], left["?b"]),
        zip(right["?b"], right["?c"], right["?a"])) if b == b2 and a == a2}
    mult = sum(1 for (a, b), (b2, c, a2) in itertools.product(
        zip(left["?a"], left["?b"]),
        zip(right["?b"], right["?c"], right["?a"])) if b == b2 and a == a2)
    assert len(got["?a"]) == mult
    assert set(zip(got["?a"], got["?b"], got["?c"])) == rows


def test_diff_counts_and_unique_rows():
    a = np.array([[1, 2, 3], [1, 2, 3], [4, 5, 6], [7, 8, 9]])
    b = np.array([[4, 5, 6], [10, 11, 12]])
    assert rdfs_cq.unique_rows(a).tolist() == [[1, 2, 3], [4, 5, 6], [7, 8, 9]]
    assert rdfs_cq.diff_counts(a, b) == (1, 2)
    assert rdfs_cq.diff_counts(a[:0], b) == (2, 0)
    assert rdfs_cq.diff_counts(a, a[::-1]) == (0, 0)


def test_closure_is_reflexive_and_transitive():
    up = rdfs_cq.closure(lubm.SUBCLASS)
    assert up["ub:FullProfessor"] == {"ub:FullProfessor", "ub:Professor",
                                      "ub:Faculty", "ub:Employee",
                                      "ub:Person"}
    assert up["ub:Person"] == {"ub:Person"}
    assert up["ub:Chair"] == {"ub:Chair", "ub:Person", "ub:Professor",
                              "ub:Faculty", "ub:Employee"}
