"""LUBM data in bulk numpy, made from a seed, in the shape of UBA.

UBA is LUBM's data generator (Guo, Pan and Heflin, "LUBM: A benchmark
for OWL knowledge base systems", J. Web Semantics 3(2-3), 2005, section
2.2, and UBA's published data profile).  Per university it makes 15-25
departments; per department 7-10 full, 10-14 associate and 8-11
assistant professors and 5-7 lecturers (one full professor heads it),
each teaching 1-2 courses and 1-2 graduate courses of their own; 8-14
undergraduates and 3-4 graduate students per faculty member; 10-20
research groups.  An undergraduate takes 2-4 of the department's
courses, and one in five has a professor as advisor; a graduate student
takes 1-3 graduate courses, has a professor as advisor and an
undergraduate degree from one of 1,000 universities; a fifth to a
quarter of them assist in one course each (pairwise different courses),
a quarter to a third are research assistants.  Full, associate and
assistant professors write 15-20, 10-18 and 5-10 publications, lecturers
0-5; a graduate student co-authors 0-5 of the department's professors'
publications.  Faculty hold three degrees, each from one of the 1,000
universities.  Every person has a name, an e-mail address and a
telephone; faculty a research interest; universities, departments,
courses and publications a name.  Counts are uniform over their ranges,
each drawn per department or per person as UBA draws it, from a fixed
stream: every seed makes the same number of departments, people,
courses, publications and links of each kind, and draws which course,
advisor, degree or publication each link goes to.

Every id is an int: the schema's names first (`NAMES`), then the 1,000
universities, then literals and the other entities.  The constants that
LUBM's queries name (`University0`, `Department0.University0`, its
`GraduateCourse0`, `AssistantProfessor0` and `AssociateProfessor0`)
are returned by `make` beside the triples.

The schema is the RDFS part of LUBM's ontology, univ-bench.owl: its
`rdfs:subClassOf`, `rdfs:subPropertyOf`, `rdfs:domain` and `rdfs:range`
statements between named classes and properties, with a class that
univ-bench defines as an `owl:intersectionOf` taken as a subclass of the
named class in it (Student, Employee, Chair, Director, ResearchAssistant
and TeachingAssistant of Person).  The OWL-only axioms (the other parts
of those definitions, `owl:inverseOf`, `owl:TransitiveProperty`) are not
RDFS and are not part of it.

`saturate` adds to the triples what the schema entails from them (the
RDFS closure, by forward chaining): a store loaded that way answers
LUBM's queries completely by plain evaluation.

This module is plain numpy: the reference reads it, so it imports
nothing of the program.
"""
from __future__ import annotations

import numpy as np

RDF_TYPE = "rdf:type"
CLASSES = tuple(f"ub:{c}" for c in (
    "AdministrativeStaff", "Article", "AssistantProfessor",
    "AssociateProfessor", "Book", "Chair", "ClericalStaff", "College",
    "ConferencePaper", "Course", "Dean", "Department", "Director",
    "Employee", "Faculty", "FullProfessor", "GraduateCourse",
    "GraduateStudent", "Institute", "JournalArticle", "Lecturer", "Manual",
    "Organization", "Person", "PostDoc", "Professor", "Program",
    "Publication", "Research", "ResearchAssistant", "ResearchGroup",
    "Schedule", "Software", "Specification", "Student", "SystemsStaff",
    "TeachingAssistant", "TechnicalReport", "UndergraduateStudent",
    "University", "UnofficialPublication", "VisitingProfessor", "Work"))
SUBCLASS = tuple((f"ub:{a}", f"ub:{b}") for a, b in (
    ("AdministrativeStaff", "Employee"), ("Article", "Publication"),
    ("AssistantProfessor", "Professor"), ("AssociateProfessor", "Professor"),
    ("Book", "Publication"), ("Chair", "Person"), ("Chair", "Professor"),
    ("ClericalStaff", "AdministrativeStaff"), ("College", "Organization"),
    ("ConferencePaper", "Article"), ("Course", "Work"), ("Dean", "Professor"),
    ("Department", "Organization"), ("Director", "Person"),
    ("Employee", "Person"), ("Faculty", "Employee"),
    ("FullProfessor", "Professor"), ("GraduateCourse", "Course"),
    ("GraduateStudent", "Person"), ("Institute", "Organization"),
    ("JournalArticle", "Article"), ("Lecturer", "Faculty"),
    ("Manual", "Publication"), ("PostDoc", "Faculty"),
    ("Professor", "Faculty"), ("Program", "Organization"),
    ("Research", "Work"), ("ResearchAssistant", "Person"),
    ("ResearchGroup", "Organization"), ("Software", "Publication"),
    ("Specification", "Publication"), ("Student", "Person"),
    ("SystemsStaff", "AdministrativeStaff"), ("TeachingAssistant", "Person"),
    ("TechnicalReport", "Article"), ("UndergraduateStudent", "Student"),
    ("University", "Organization"), ("UnofficialPublication", "Publication"),
    ("VisitingProfessor", "Professor")))
# property: (domain, range); None where univ-bench states none
_P = {
    "advisor": ("Person", "Professor"),
    "affiliatedOrganizationOf": ("Organization", "Organization"),
    "affiliateOf": ("Organization", "Person"),
    "age": ("Person", None),
    "degreeFrom": ("Person", "University"),
    "doctoralDegreeFrom": ("Person", "University"),
    "emailAddress": ("Person", None),
    "hasAlumnus": ("University", "Person"),
    "headOf": (None, None),
    "listedCourse": ("Schedule", "Course"),
    "mastersDegreeFrom": ("Person", "University"),
    "member": ("Organization", "Person"),
    "memberOf": (None, None),
    "name": (None, None),
    "officeNumber": (None, None),
    "orgPublication": ("Organization", "Publication"),
    "publicationAuthor": ("Publication", "Person"),
    "publicationDate": ("Publication", None),
    "publicationResearch": ("Publication", "Research"),
    "researchInterest": (None, None),
    "researchProject": ("ResearchGroup", "Research"),
    "softwareDocumentation": ("Software", "Publication"),
    "softwareVersion": ("Software", None),
    "subOrganizationOf": ("Organization", "Organization"),
    "takesCourse": (None, None),
    "teacherOf": ("Faculty", "Course"),
    "teachingAssistantOf": ("TeachingAssistant", "Course"),
    "telephone": ("Person", None),
    "tenured": ("Professor", None),
    "title": ("Person", None),
    "undergraduateDegreeFrom": ("Person", "University"),
    "worksFor": (None, None),
}
PROPS = {f"ub:{p}": tuple(None if c is None else f"ub:{c}" for c in dr)
         for p, dr in _P.items()}
SUBPROP = tuple((f"ub:{a}", f"ub:{b}") for a, b in (
    ("doctoralDegreeFrom", "degreeFrom"), ("headOf", "worksFor"),
    ("mastersDegreeFrom", "degreeFrom"),
    ("undergraduateDegreeFrom", "degreeFrom"), ("worksFor", "memberOf")))

NAMES = {name: i for i, name in
         enumerate((RDF_TYPE,) + CLASSES + tuple(PROPS))}

UNIVERSITY_POOL = 1000       # the universities degrees are drawn from
RESEARCH_TOPICS = 30         # the research interests faculty draw from
# faculty kinds in a department: (class, per department, publications)
FACULTY = (("ub:FullProfessor", (7, 10), (15, 20)),
           ("ub:AssociateProfessor", (10, 14), (10, 18)),
           ("ub:AssistantProfessor", (8, 11), (5, 10)),
           ("ub:Lecturer", (5, 7), (0, 5)))
PROFESSOR_KINDS = 3          # the first three kinds are professors
RANGES = {
    "departments": (15, 25), "research_groups": (10, 20),
    "courses_per_faculty": (1, 2), "graduate_courses_per_faculty": (1, 2),
    "undergraduates_per_faculty": (8, 14), "graduates_per_faculty": (3, 4),
    "undergraduate_courses": (2, 4), "graduate_courses": (1, 3),
    "graduate_publications": (0, 5),
}
UNDERGRADUATE_ADVISED = 0.2  # one undergraduate in five has an advisor
SIZES_STREAM = 20050101      # the fixed stream every count is drawn from


def _between(rng, lo, hi, n=None):
    """Uniform integers in [lo, hi], both ends included; lo, hi may be
    arrays."""
    return rng.integers(lo, np.asarray(hi) + 1, n)


def _segments(counts):
    """For children counted per parent: each child's parent and its
    index within the parent; each parent's first child."""
    counts = np.asarray(counts, np.int64)
    parent = np.repeat(np.arange(len(counts)), counts)
    first = np.cumsum(counts) - counts
    return parent, np.arange(counts.sum()) - first[parent], first


def _distinct(rng, sizes, k: int) -> np.ndarray:
    """For each row, k distinct uniform integers below sizes[row]."""
    sizes = np.asarray(sizes, np.int64)
    out = np.zeros((len(sizes), k), np.int64)
    for j in range(k):
        x = rng.integers(0, sizes - j)
        prev = np.sort(out[:, :j], axis=1)
        for t in range(j):          # the x-th value not yet taken
            x += x >= prev[:, t]
        out[:, j] = x
    return out


def _rank_within(rng, group):
    """A random order of the items of each group: each item's rank."""
    order = np.lexsort((rng.random(len(group)), group))
    rank = np.empty(len(group), np.int64)
    _, _, first = _segments(np.bincount(group))
    rank[order] = np.arange(len(group)) - first[group[order]]
    return rank


class _Ids:
    def __init__(self, start: int):
        self.next = start

    def take(self, n: int) -> np.ndarray:
        out = np.arange(self.next, self.next + n, dtype=np.int64)
        self.next += int(n)
        return out


class _Triples:
    def __init__(self):
        self.parts = []

    def add(self, s, p: str, o) -> None:
        s = np.asarray(s, np.int64)
        t = np.empty((len(s), 3), np.int64)
        t[:, 0] = s
        t[:, 1] = NAMES[p]
        t[:, 2] = np.broadcast_to(np.asarray(o, np.int64), s.shape)
        self.parts.append(t)

    def type(self, s, cls) -> None:
        self.add(s, RDF_TYPE, cls if not isinstance(cls, str) else NAMES[cls])


def make(universities: int, seed: int) -> tuple[np.ndarray, dict[str, int]]:
    """The (N, 3) int32 triples of `universities` universities, and the
    ids of the constants that LUBM's queries name.  Rows come grouped by
    kind; the program deduplicates and sorts them in its store."""
    if not 1 <= universities <= UNIVERSITY_POOL:
        raise ValueError(f"1 to {UNIVERSITY_POOL} universities")
    # every count comes from a stream of its own that no seed changes, so
    # every seed makes the same sizes; the seed draws the choices
    size = np.random.default_rng([SIZES_STREAM, 0])
    rng = np.random.default_rng([seed % (1 << 64), 1])
    ids, T = _Ids(len(NAMES)), _Triples()
    univ = ids.take(UNIVERSITY_POOL)
    T.type(univ[:universities], "ub:University")
    T.add(univ[:universities], "ub:name", ids.take(universities))

    # departments and research groups
    n_dept = _between(size, *RANGES["departments"], universities)
    dept_univ, dept_local, _ = _segments(n_dept)
    D = len(dept_univ)
    dept = ids.take(D)
    dept_name = ids.take(RANGES["departments"][1])
    T.type(dept, "ub:Department")
    T.add(dept, "ub:name", dept_name[dept_local])
    T.add(dept, "ub:subOrganizationOf", univ[dept_univ])
    rg_dept, _, _ = _segments(_between(size, *RANGES["research_groups"], D))
    rg = ids.take(len(rg_dept))
    T.type(rg, "ub:ResearchGroup")
    T.add(rg, "ub:subOrganizationOf", dept[rg_dept])

    # faculty, by department and then by kind
    per_kind = np.stack([_between(size, lo, hi, D)
                         for _, (lo, hi), _ in FACULTY], axis=1)
    fk, f_local, _ = _segments(per_kind.ravel())
    f_dept, f_kind = fk // len(FACULTY), fk % len(FACULTY)
    n_fac = per_kind.sum(axis=1)
    n_prof = per_kind[:, :PROFESSOR_KINDS].sum(axis=1)
    _, _, fac_first = _segments(n_fac)
    fac = ids.take(len(f_dept))
    head = fac[fac_first + rng.integers(0, per_kind[:, 0])]
    T.add(head, "ub:headOf", dept)
    T.add(fac, "ub:worksFor", dept[f_dept])
    for k, (cls, (_, hi), _) in enumerate(FACULTY):
        sel = f_kind == k
        T.type(fac[sel], cls)
        T.add(fac[sel], "ub:name", ids.take(hi)[f_local[sel]])
    for prop in ("ub:undergraduateDegreeFrom", "ub:mastersDegreeFrom",
                 "ub:doctoralDegreeFrom"):
        T.add(fac, prop, univ[rng.integers(0, UNIVERSITY_POOL, len(fac))])
    T.add(fac, "ub:researchInterest",
          ids.take(RESEARCH_TOPICS)[rng.integers(0, RESEARCH_TOPICS,
                                                 len(fac))])

    # courses: each faculty member's own, numbered within the department
    courses = {}
    for cls, key in (("ub:Course", "courses_per_faculty"),
                     ("ub:GraduateCourse", "graduate_courses_per_faculty")):
        teacher, _, _ = _segments(_between(size, *RANGES[key], len(fac)))
        c = ids.take(len(teacher))
        per_dept = np.bincount(f_dept[teacher], minlength=D)
        _, c_local, c_first = _segments(per_dept)
        T.type(c, cls)
        T.add(c, "ub:name", ids.take(per_dept.max())[c_local])
        T.add(fac[teacher], "ub:teacherOf", c)
        courses[cls] = (c, per_dept, c_first)

    # students
    tel = ids.take(1)
    students = {}
    for cls, key in (("ub:UndergraduateStudent", "undergraduates_per_faculty"),
                     ("ub:GraduateStudent", "graduates_per_faculty")):
        lo, hi = RANGES[key]
        n = _between(size, lo * n_fac, hi * n_fac)
        s_dept, s_local, _ = _segments(n)
        s = ids.take(len(s_dept))
        T.type(s, cls)
        T.add(s, "ub:name", ids.take(n.max())[s_local])
        T.add(s, "ub:memberOf", dept[s_dept])
        students[cls] = (s, s_dept, n)
    for s, s_dept, _ in (*students.values(),
                         (fac, f_dept, None)):
        T.add(s, "ub:emailAddress", ids.take(len(s)))
        T.add(s, "ub:telephone", tel)

    def takes(s, s_dept, course_cls, key):
        c, per_dept, c_first = courses[course_cls]
        lo, hi = RANGES[key]
        pick = _distinct(rng, per_dept[s_dept], hi)
        k = _between(size, lo, hi, len(s))
        for j in range(hi):
            sel = j < k
            T.add(s[sel], "ub:takesCourse",
                  c[c_first[s_dept[sel]] + pick[sel, j]])

    def professor_of(s_dept):
        return fac[fac_first[s_dept] + rng.integers(0, n_prof[s_dept])]

    ug, ug_dept, _ = students["ub:UndergraduateStudent"]
    takes(ug, ug_dept, "ub:Course", "undergraduate_courses")
    adv = size.random(len(ug)) < UNDERGRADUATE_ADVISED
    T.add(ug[adv], "ub:advisor", professor_of(ug_dept[adv]))

    gs, gs_dept, n_gs = students["ub:GraduateStudent"]
    takes(gs, gs_dept, "ub:GraduateCourse", "graduate_courses")
    T.add(gs, "ub:advisor", professor_of(gs_dept))
    T.add(gs, "ub:undergraduateDegreeFrom",
          univ[rng.integers(0, UNIVERSITY_POOL, len(gs))])
    # teaching and research assistants, from a random order of each
    # department's graduate students; each assistant's course is the
    # next of a random order of the department's courses
    n_ta = _between(size, n_gs // 5, n_gs // 4)
    n_ra = _between(size, n_gs // 4, n_gs // 3)
    rank = _rank_within(rng, gs_dept)
    ta = rank < n_ta[gs_dept]
    ra = ~ta & (rank < (n_ta + n_ra)[gs_dept])
    c, per_dept, c_first = courses["ub:Course"]
    c_rank = _rank_within(rng, np.repeat(np.arange(D), per_dept))
    by_rank = np.empty(len(c), np.int64)
    by_rank[c_first[np.repeat(np.arange(D), per_dept)] + c_rank] = c
    T.type(gs[ta], "ub:TeachingAssistant")
    T.add(gs[ta], "ub:teachingAssistantOf",
          by_rank[c_first[gs_dept[ta]] + rank[ta]])
    T.type(gs[ra], "ub:ResearchAssistant")

    # publications: each faculty member's own, in faculty order, so a
    # department's professors' publications come first and together
    n_pub = np.zeros(len(fac), np.int64)
    for k, (_, _, (lo, hi)) in enumerate(FACULTY):
        sel = f_kind == k
        n_pub[sel] = _between(size, lo, hi, int(sel.sum()))
    author, p_local, _ = _segments(n_pub)
    pub = ids.take(len(author))
    T.type(pub, "ub:Publication")
    T.add(pub, "ub:name", ids.take(max(hi for *_, (_, hi) in FACULTY))[p_local])
    T.add(pub, "ub:publicationAuthor", fac[author])
    prof_pubs = np.bincount(f_dept[author],
                            weights=f_kind[author] < PROFESSOR_KINDS,
                            minlength=D).astype(np.int64)
    _, _, pub_first = _segments(np.bincount(f_dept[author], minlength=D))
    lo, hi = RANGES["graduate_publications"]
    pick = _distinct(rng, prof_pubs[gs_dept], hi)
    k = _between(size, lo, hi, len(gs))
    for j in range(hi):
        sel = j < k
        T.add(pub[pub_first[gs_dept[sel]] + pick[sel, j]],
              "ub:publicationAuthor", gs[sel])

    triples = np.concatenate(T.parts)
    if ids.next >= 2**31:
        raise ValueError("ids past int32")
    consts = {
        "University0": int(univ[0]),
        "Department0.University0": int(dept[0]),
        "Department0.University0/GraduateCourse0":
            int(courses["ub:GraduateCourse"][0][0]),
        "Department0.University0/AssistantProfessor0":
            int(fac[(f_dept == 0) & (f_kind == 2)][0]),
        "Department0.University0/AssociateProfessor0":
            int(fac[(f_dept == 0) & (f_kind == 1)][0]),
    }
    return triples.astype(np.int32), consts


def _above(pairs) -> dict[str, set[str]]:
    """name -> every name strictly above it, by repeated steps up."""
    up = {}
    for child, parent in pairs:
        up.setdefault(child, set()).add(parent)
    changed = True
    while changed:
        changed = False
        for x, ups in up.items():
            more = set().union(*(up.get(y, set()) for y in ups)) - ups
            if more:
                ups |= more
                changed = True
    return up


def saturate(triples: np.ndarray) -> np.ndarray:
    """The triples with every triple the schema entails from them
    (subproperty, then domain and range, then subclass), repeats left
    in: the program's store removes them."""
    t = np.asarray(triples, np.int32)
    parts = [t]
    for p, ups in _above(SUBPROP).items():
        rows = t[t[:, 1] == NAMES[p]]
        for q in sorted(ups):
            parts.append(np.column_stack([rows[:, 0],
                                          np.full(len(rows), NAMES[q]),
                                          rows[:, 2]]).astype(np.int32))
    t = np.concatenate(parts)
    type_id = NAMES[RDF_TYPE]
    parts = [t]
    for p, (dom, rng_) in PROPS.items():
        rows = t[t[:, 1] == NAMES[p]]
        for col, cls in ((0, dom), (2, rng_)):
            if cls:
                parts.append(np.column_stack([
                    rows[:, col], np.full(len(rows), type_id),
                    np.full(len(rows), NAMES[cls])]).astype(np.int32))
    t = np.concatenate(parts)
    typed = t[t[:, 1] == type_id]
    parts = [t]
    for c, ups in _above(SUBCLASS).items():
        rows = typed[typed[:, 2] == NAMES[c]]
        for q in sorted(ups):
            parts.append(np.column_stack([
                rows[:, 0], np.full(len(rows), type_id),
                np.full(len(rows), NAMES[q])]).astype(np.int32))
    return np.concatenate(parts)
