"""The numpy data maker against UBA's data profile, and its closure
against the port's own forward chainer."""
from __future__ import annotations

import numpy as np
import pytest

from rdfbench.data import lubm

N = lubm.NAMES
TYPE = N[lubm.RDF_TYPE]


@pytest.fixture(scope="module")
def three():
    return lubm.make(3, seed=2**31 + 12345)


def _typed(t, cls):
    return np.unique(t[(t[:, 1] == TYPE) & (t[:, 2] == N[cls]), 0])


def _pairs(t, prop):
    return t[t[:, 1] == N[prop]][:, [0, 2]]


def _per(keys, within):
    """How many of `keys` map into each of `within` (zeros included)."""
    return np.array([(keys == w).sum() for w in within])


def test_no_repeats_and_seeded(three):
    t, consts = three
    assert len(np.unique(t, axis=0)) == len(t)
    again, consts2 = lubm.make(3, seed=2**31 + 12345)
    assert (again == t).all() and consts2 == consts
    other, _ = lubm.make(3, seed=2**31 + 12346)
    assert not np.array_equal(other, t)


def test_every_seed_makes_the_same_sizes(three):
    t, _ = three
    other, _ = lubm.make(3, seed=5)

    def sizes(x):
        typed = x[x[:, 1] == TYPE]
        return (np.unique(x[:, 1], return_counts=True)[1].tolist(),
                np.unique(typed[:, 2], return_counts=True)[1].tolist())

    assert sizes(other) == sizes(t)


def test_departments_and_faculty_follow_the_profile(three):
    t, consts = three
    univ = _typed(t, "ub:University")
    dept = _typed(t, "ub:Department")
    assert len(univ) == 3 and consts["University0"] == univ.min()
    sub = _pairs(t, "ub:subOrganizationOf")
    dept_of_univ = sub[np.isin(sub[:, 0], dept)]
    assert sorted(set(dept_of_univ[:, 1])) == sorted(univ)
    per_univ = _per(dept_of_univ[:, 1], univ)
    assert ((15 <= per_univ) & (per_univ <= 25)).all()
    groups = sub[np.isin(sub[:, 0], _typed(t, "ub:ResearchGroup"))]
    per_dept = _per(groups[:, 1], dept)
    assert ((10 <= per_dept) & (per_dept <= 20)).all()
    works = _pairs(t, "ub:worksFor")
    for cls, (lo, hi), (plo, phi) in lubm.FACULTY:
        who = _typed(t, cls)
        n = _per(works[np.isin(works[:, 0], who), 1], dept)
        assert ((lo <= n) & (n <= hi)).all(), cls
        pubs = _pairs(t, "ub:publicationAuthor")
        k = _per(pubs[:, 1], who)
        assert ((plo <= k) & (k <= phi)).all(), cls
    heads = _pairs(t, "ub:headOf")
    assert sorted(heads[:, 1]) == sorted(dept)
    assert np.isin(heads[:, 0], _typed(t, "ub:FullProfessor")).all()
    teaches = _pairs(t, "ub:teacherOf")
    assert len(np.unique(teaches[:, 1])) == len(teaches)   # own courses
    faculty = np.unique(works[:, 0])
    for cls in ("ub:Course", "ub:GraduateCourse"):
        mine = teaches[np.isin(teaches[:, 1], _typed(t, cls))]
        k = _per(mine[:, 0], faculty)
        assert ((1 <= k) & (k <= 2)).all(), cls
    for prop in ("ub:undergraduateDegreeFrom", "ub:mastersDegreeFrom",
                 "ub:doctoralDegreeFrom"):
        deg = _pairs(t, prop)
        assert np.isin(faculty, deg[:, 0]).all()
        assert (deg[:, 1] < N["ub:worksFor"] + 1 + lubm.UNIVERSITY_POOL).all()


def test_students_follow_the_profile(three):
    t, _ = three
    dept = _typed(t, "ub:Department")
    works = _pairs(t, "ub:worksFor")
    n_fac = _per(works[:, 1], dept)
    member = _pairs(t, "ub:memberOf")
    takes = _pairs(t, "ub:takesCourse")
    advisor = _pairs(t, "ub:advisor")
    profs = np.concatenate([_typed(t, c) for c, *_ in
                            lubm.FACULTY[:lubm.PROFESSOR_KINDS]])
    for cls, (lo, hi), course_cls, (clo, chi) in (
            ("ub:UndergraduateStudent", (8, 14), "ub:Course", (2, 4)),
            ("ub:GraduateStudent", (3, 4), "ub:GraduateCourse", (1, 3))):
        who = _typed(t, cls)
        n = _per(member[np.isin(member[:, 0], who), 1], dept)
        assert ((lo * n_fac <= n) & (n <= hi * n_fac)).all(), cls
        mine = takes[np.isin(takes[:, 0], who)]
        assert np.isin(mine[:, 1], _typed(t, course_cls)).all()
        k = np.unique(mine[:, 0], return_counts=True)[1]
        assert len(k) == len(who) and k.min() >= clo and k.max() <= chi
        adv = advisor[np.isin(advisor[:, 0], who)]
        assert np.isin(adv[:, 1], profs).all()
    ug = _typed(t, "ub:UndergraduateStudent")
    share = np.isin(ug, advisor[:, 0]).mean()
    assert 0.17 < share < 0.23
    gs = _typed(t, "ub:GraduateStudent")
    assert np.isin(gs, advisor[:, 0]).all()
    ta = _pairs(t, "ub:teachingAssistantOf")
    assert np.isin(ta[:, 0], gs).all()
    assert len(np.unique(ta[:, 1])) == len(ta)   # pairwise different
    assert 0.18 < len(ta) / len(gs) < 0.26
    ra = _typed(t, "ub:ResearchAssistant")
    assert np.isin(ra, gs).all() and not np.isin(ra, ta[:, 0]).any()
    coauth = _pairs(t, "ub:publicationAuthor")
    k = _per(coauth[:, 1], gs)
    assert k.min() >= 0 and k.max() <= 5
    for prop in ("ub:name", "ub:emailAddress", "ub:telephone"):
        assert np.isin(np.concatenate([ug, gs]), _pairs(t, prop)[:, 0]).all()
    assert len(np.unique(_pairs(t, "ub:telephone")[:, 1])) == 1


def test_constants_name_what_the_queries_expect(three):
    t, c = three
    dept0 = c["Department0.University0"]
    sub = _pairs(t, "ub:subOrganizationOf")
    assert [c["University0"]] == list(sub[sub[:, 0] == dept0, 1])
    works = _pairs(t, "ub:worksFor")
    for key, cls in (("AssistantProfessor0", "ub:AssistantProfessor"),
                     ("AssociateProfessor0", "ub:AssociateProfessor")):
        x = c[f"Department0.University0/{key}"]
        assert x in _typed(t, cls)
        assert list(works[works[:, 0] == x, 1]) == [dept0]
    gc = c["Department0.University0/GraduateCourse0"]
    assert gc == _typed(t, "ub:GraduateCourse").min()
    teach = _pairs(t, "ub:teacherOf")
    teacher = teach[teach[:, 1] == gc, 0]
    assert list(works[works[:, 0] == teacher[0], 1]) == [dept0]


def test_closure_equals_the_ports_forward_chainer():
    generator = pytest.importorskip("repro_torch.rdf.generator")
    from rdfbench import program
    t, consts = lubm.make(1, seed=7)
    _, schema, _ = program.port_inputs({"queries": {}, "weights": {}},
                                       lubm, consts)
    assert generator is not None
    want = schema.saturate_instance(t, TYPE)
    got = np.unique(lubm.saturate(t), axis=0)
    assert got.shape == want.shape and (got == want).all()
