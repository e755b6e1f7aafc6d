"""LUBM-style synthetic RDF benchmark data + workload generator.

Mirrors the datasets the demo pre-loads (LUBM et al.): a university
ontology with an RDFS class/property hierarchy, instance data scaled by
`n_universities`, and a weighted conjunctive SPARQL workload patterned on
the published LUBM queries (conjunctive subset).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.queries import CQ, Atom, Const, Var
from repro_torch.rdf.dictionary import Dictionary, RDF_TYPE
from repro_torch.rdf.schema import RDFSchema
from repro_torch.rdf.triples import TripleStore

CLASSES = [
    "ub:Person", "ub:Student", "ub:UndergraduateStudent", "ub:GraduateStudent",
    "ub:Employee", "ub:Faculty", "ub:Professor", "ub:FullProfessor",
    "ub:AssociateProfessor", "ub:Lecturer", "ub:Course", "ub:GraduateCourse",
    "ub:Department", "ub:University", "ub:Publication",
]

SUBCLASS = [
    ("ub:Student", "ub:Person"),
    ("ub:UndergraduateStudent", "ub:Student"),
    ("ub:GraduateStudent", "ub:Student"),
    ("ub:Employee", "ub:Person"),
    ("ub:Faculty", "ub:Employee"),
    ("ub:Professor", "ub:Faculty"),
    ("ub:FullProfessor", "ub:Professor"),
    ("ub:AssociateProfessor", "ub:Professor"),
    ("ub:Lecturer", "ub:Faculty"),
    ("ub:GraduateCourse", "ub:Course"),
]

PROPS = {
    # prop: (domain, range)
    "ub:takesCourse": ("ub:Student", "ub:Course"),
    "ub:teacherOf": ("ub:Faculty", "ub:Course"),
    "ub:advisor": ("ub:Student", "ub:Professor"),
    "ub:worksFor": ("ub:Employee", "ub:Department"),
    "ub:memberOf": ("ub:Person", "ub:Department"),
    "ub:subOrganizationOf": ("ub:Department", "ub:University"),
    "ub:publicationAuthor": ("ub:Publication", "ub:Person"),
    "ub:undergraduateDegreeFrom": ("ub:Person", "ub:University"),
    "ub:headOf": ("ub:Professor", "ub:Department"),
}

SUBPROP = [
    ("ub:headOf", "ub:worksFor"),
]


@dataclass
class Universe:
    store: TripleStore
    schema: RDFSchema
    dictionary: Dictionary
    type_id: int


def build_schema(d: Dictionary) -> RDFSchema:
    schema = RDFSchema()
    for child, parent in SUBCLASS:
        schema.add_subclass(d.encode(child), d.encode(parent))
    for child, parent in SUBPROP:
        schema.add_subprop(d.encode(child), d.encode(parent))
    for prop, (dom, rng) in PROPS.items():
        schema.set_domain(d.encode(prop), d.encode(dom))
        schema.set_range(d.encode(prop), d.encode(rng))
    return schema


def generate(n_universities: int = 1, seed: int = 0, dept_per_univ: int = 3,
             prof_per_dept: int = 6, stud_per_dept: int = 40,
             course_per_dept: int = 10) -> Universe:
    rng = np.random.default_rng(seed)
    d = Dictionary()
    type_id = d.encode(RDF_TYPE)
    for c in CLASSES:
        d.encode(c)
    for p in PROPS:
        d.encode(p)
    schema = build_schema(d)

    T: list[tuple[int, int, int]] = []

    def tid(name: str) -> int:
        return d.encode(name)

    def add(s: int, p: str, o: int) -> None:
        T.append((s, tid(p), o))

    def add_type(s: int, cls: str) -> None:
        T.append((s, type_id, tid(cls)))

    for u in range(n_universities):
        univ = d.encode(f"u{u}")
        add_type(univ, "ub:University")
        for dep in range(dept_per_univ):
            dept = d.encode(f"u{u}.d{dep}")
            add_type(dept, "ub:Department")
            add(dept, "ub:subOrganizationOf", univ)
            courses = []
            for c in range(course_per_dept):
                crs = d.encode(f"u{u}.d{dep}.c{c}")
                cls = "ub:GraduateCourse" if c % 3 == 0 else "ub:Course"
                add_type(crs, cls)
                courses.append(crs)
            profs = []
            for p in range(prof_per_dept):
                prof = d.encode(f"u{u}.d{dep}.p{p}")
                cls = ["ub:FullProfessor", "ub:AssociateProfessor", "ub:Lecturer"][p % 3]
                add_type(prof, cls)
                add(prof, "ub:worksFor", dept)
                taught = rng.choice(len(courses), size=min(2, len(courses)), replace=False)
                for c in taught:
                    add(prof, "ub:teacherOf", courses[c])
                profs.append(prof)
            head = profs[0]
            add(head, "ub:headOf", dept)
            for s in range(stud_per_dept):
                stu = d.encode(f"u{u}.d{dep}.s{s}")
                grad = s % 4 == 0
                add_type(stu, "ub:GraduateStudent" if grad else "ub:UndergraduateStudent")
                add(stu, "ub:memberOf", dept)
                n_courses = int(rng.integers(1, 4))
                for c in rng.choice(len(courses), size=n_courses, replace=False):
                    add(stu, "ub:takesCourse", courses[c])
                if grad:
                    add(stu, "ub:advisor", profs[int(rng.integers(0, len(profs)))])
                    add(stu, "ub:undergraduateDegreeFrom", univ)
            for pub in range(prof_per_dept * 2):
                pb = d.encode(f"u{u}.d{dep}.pub{pub}")
                add_type(pb, "ub:Publication")
                add(pb, "ub:publicationAuthor", profs[pub % len(profs)])

    store = TripleStore(np.array(T, dtype=np.int32), d)
    return Universe(store=store, schema=schema, dictionary=d, type_id=type_id)


# ----------------------------------------------------------------------
# Workload: conjunctive subset of the published LUBM queries
# ----------------------------------------------------------------------
def lubm_workload(d: Dictionary, weights: dict[str, float] | None = None) -> list[CQ]:
    """Conjunctive SPARQL workload over the generated universe."""
    w = weights or {}
    t = Const(d.encode(RDF_TYPE))

    def c(name: str) -> Const:
        return Const(d.encode(name))

    x, y, z, u_ = Var("x"), Var("y"), Var("z"), Var("u")

    qs = [
        # Q1: graduate students and the courses they take
        CQ((x, y), (
            Atom(x, t, c("ub:GraduateStudent")),
            Atom(x, c("ub:takesCourse"), y),
        ), name="q1", weight=w.get("q1", 10.0)),
        # Q2: students with an advisor who teaches a course they take
        CQ((x, y, z), (
            Atom(x, c("ub:advisor"), y),
            Atom(y, c("ub:teacherOf"), z),
            Atom(x, c("ub:takesCourse"), z),
        ), name="q2", weight=w.get("q2", 5.0)),
        # Q3: members of departments of a university, with their courses
        CQ((x, z), (
            Atom(x, c("ub:memberOf"), y),
            Atom(y, c("ub:subOrganizationOf"), z),
            Atom(x, c("ub:takesCourse"), u_),
        ), name="q3", weight=w.get("q3", 3.0)),
        # Q4: faculty (via schema: professors/lecturers) and their dept
        CQ((x, y), (
            Atom(x, t, c("ub:Faculty")),
            Atom(x, c("ub:worksFor"), y),
        ), name="q4", weight=w.get("q4", 8.0)),
        # Q5: publications of professors working in a department
        CQ((x, y), (
            Atom(x, c("ub:publicationAuthor"), y),
            Atom(y, c("ub:worksFor"), z),
        ), name="q5", weight=w.get("q5", 2.0)),
        # Q6: students taking a course taught by their dept head
        CQ((x,), (
            Atom(x, c("ub:takesCourse"), y),
            Atom(z, c("ub:teacherOf"), y),
            Atom(z, c("ub:headOf"), u_),
            Atom(x, c("ub:memberOf"), u_),
        ), name="q6", weight=w.get("q6", 1.0)),
    ]
    return qs
