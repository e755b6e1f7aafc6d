"""The port's SPARQL / N-Triples parsers (`repro_torch.rdf.parser`, a copy
of `repro/rdf/parser.py`): the cases of tests/test_rdf.py, each also held
against the JAX package's parser on the same text."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.api import serde as jserde  # noqa: E402
from repro.rdf import parser as jparser  # noqa: E402
from repro.rdf.dictionary import Dictionary as JDictionary  # noqa: E402
from repro_torch.api import serde as tserde  # noqa: E402
from repro_torch.rdf import parser as tparser  # noqa: E402
from repro_torch.rdf.dictionary import Dictionary  # noqa: E402
from repro_torch.rdf.generator import RDF_TYPE  # noqa: E402

SPARQL = ("SELECT ?x ?y WHERE { ?x rdf:type ub:Student . "
          "?x ub:takesCourse ?y }")
NTRIPLES = "<a> <p> <b> .\n<b> <p> \"lit\" ."


def test_sparql_parser():
    d = Dictionary()
    q = tparser.parse_sparql(SPARQL, d, name="p1")
    assert len(q.atoms) == 2
    assert [h.name for h in q.head] == ["x", "y"]
    assert q.atoms[0].p.id == d.lookup(RDF_TYPE)

    with pytest.raises(Exception):
        tparser.parse_sparql("SELECT ?x WHERE { ?x ?p }", d)


def test_sparql_parser_matches_jax():
    jd, td = JDictionary(), Dictionary()
    jq = jparser.parse_sparql(SPARQL, jd, name="p1")
    tq = tparser.parse_sparql(SPARQL, td, name="p1")
    assert tserde.cq_to_json(tq) == jserde.cq_to_json(jq)
    assert td._to_str == jd._to_str


def test_ntriples_parser():
    d = Dictionary()
    arr = tparser.parse_ntriples(NTRIPLES, d)
    assert arr.shape == (2, 3)
    assert arr[0, 1] == arr[1, 1]


def test_ntriples_parser_matches_jax():
    jd, td = JDictionary(), Dictionary()
    ja = jparser.parse_ntriples(NTRIPLES, jd)
    ta = tparser.parse_ntriples(NTRIPLES, td)
    np.testing.assert_array_equal(ta, ja)
    assert ta.dtype == ja.dtype
    assert td._to_str == jd._to_str
