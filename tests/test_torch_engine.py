"""The port's padded-buffer operators against `repro.query.engine`.

The same numpy buffers go through both engines; `data`, `n` and
`overflow` must be equal exactly.  Batched (member-axis) calls must equal
the JAX operator run on each member alone."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.reformulation import reformulate_workload  # noqa: E402
from repro.query import engine as JE  # noqa: E402
from repro.query.plan import plan_for_cq  # noqa: E402
from repro.rdf.generator import generate, lubm_workload  # noqa: E402
from repro_torch.query import engine as TE  # noqa: E402

SENTINEL = 2**31 - 1


@pytest.fixture(scope="module")
def uni():
    return generate(n_universities=1, seed=0, dept_per_univ=2,
                    prof_per_dept=4, stud_per_dept=12, course_per_dept=5)


def _rel_np(rng, cap, w, n, key_space):
    data = np.full((cap, w), -1, np.int32)
    data[:n] = rng.integers(0, key_space, size=(n, w))
    return data


def _jrel(data, n, ovf=False):
    return JE.PRel(jnp.asarray(data), jnp.int32(n), jnp.asarray(ovf))


def _trel(data, n, ovf=False):
    return TE.PRel(torch.from_numpy(np.array(data)),
                   torch.tensor(n, dtype=torch.int32), torch.tensor(ovf))


def _trel_batch(datas, ns, ovfs):
    return TE.PRel(torch.from_numpy(np.stack(datas)),
                   torch.tensor(ns, dtype=torch.int32), torch.tensor(ovfs))


def _assert_same(j, t):
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
    assert int(t.n) == int(j.n)
    assert bool(t.overflow) == bool(j.overflow)
    assert t.data.dtype == torch.int32 and t.n.dtype == torch.int32
    assert t.overflow.dtype == torch.bool


def _member(t, i):
    return TE.PRel(t.data[i], t.n[i], t.overflow[i])


# ----------------------------------------------------------------------
# operators
# ----------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(3))
def test_compact(seed):
    rng = np.random.default_rng(seed)
    data = rng.integers(-1, 9, size=(77, 3)).astype(np.int32)
    mask = rng.random(77) < 0.4
    ovf = bool(seed % 2)
    j = JE.compact(jnp.asarray(data), jnp.asarray(mask), jnp.asarray(ovf))
    t = TE.compact(torch.from_numpy(data), torch.from_numpy(mask),
                   torch.tensor(ovf))
    _assert_same(j, t)


@pytest.mark.parametrize("col,value", [(0, 2), (1, 0), (2, 4), (1, 99)])
def test_filter_eq(col, value):
    rng = np.random.default_rng(col * 10 + value)
    data = _rel_np(rng, 64, 3, 41, 5)
    _assert_same(JE.filter_eq(_jrel(data, 41), col, value),
                 TE.filter_eq(_trel(data, 41), col, value))


def test_filter_eq_member_axis():
    rng = np.random.default_rng(7)
    datas = [_rel_np(rng, 32, 2, n, 4) for n in (0, 17, 32)]
    vals = [1, 3, 0]
    out = TE.filter_eq(_trel_batch(datas, [0, 17, 32], [False, True, False]),
                       1, torch.tensor(vals, dtype=torch.int32))
    for i, (d, n, o) in enumerate(zip(datas, [0, 17, 32], [False, True, False])):
        _assert_same(JE.filter_eq(_jrel(d, n, o), 1, vals[i]), _member(out, i))


JOIN_CASES = [
    # lcol, rcol, residual, keep_right, out_cap
    (0, 0, (), (1, 2), 512),
    (1, 2, ((0, 0),), (1,), 512),
    (0, 1, ((1, 2),), (), 512),
    (0, 0, (), (1, 2), 8),            # forced overflow
    (1, 0, ((0, 1),), (2,), 16),      # overflow with a residual pair
]


@pytest.mark.parametrize("lcol,rcol,residual,keep_right,out_cap", JOIN_CASES)
@pytest.mark.parametrize("use_kernels", [True, False])
def test_join(lcol, rcol, residual, keep_right, out_cap, use_kernels):
    rng = np.random.default_rng(out_cap + lcol * 3 + rcol)
    ld = _rel_np(rng, 50, 2, 37, 6)
    rd = _rel_np(rng, 70, 3, 61, 6)
    j = JE.join(_jrel(ld, 37), _jrel(rd, 61), lcol, rcol, residual,
                keep_right, out_cap)
    t = TE.join(_trel(ld, 37), _trel(rd, 61), lcol, rcol, residual,
                keep_right, out_cap, use_kernels=use_kernels)
    _assert_same(j, t)
    if out_cap == 8:
        assert bool(t.overflow)


def test_join_right_sorted_and_inherited_overflow():
    rng = np.random.default_rng(11)
    ld = _rel_np(rng, 40, 2, 30, 5)
    rd = _rel_np(rng, 40, 2, 25, 5)
    order = np.argsort(rd[:25, 1], kind="stable")
    rd[:25] = rd[:25][order]
    j = JE.join(_jrel(ld, 30, True), _jrel(rd, 25), 0, 1, (), (0,), 256,
                right_sorted=True)
    t = TE.join(_trel(ld, 30, True), _trel(rd, 25), 0, 1, (), (0,), 256,
                right_sorted=True)
    _assert_same(j, t)
    assert bool(t.overflow)


def test_join_member_axis():
    """One batched call over three members equals three JAX joins."""
    rng = np.random.default_rng(3)
    ns_l, ns_r = [20, 0, 33], [31, 12, 40]
    lds = [_rel_np(rng, 40, 2, n, 5) for n in ns_l]
    rds = [_rel_np(rng, 48, 3, n, 5) for n in ns_r]
    ovf = [False, False, True]
    out = TE.join(_trel_batch(lds, ns_l, ovf), _trel_batch(rds, ns_r, ovf),
                  0, 1, ((1, 2),), (0,), 64)
    for i in range(3):
        _assert_same(JE.join(_jrel(lds[i], ns_l[i], ovf[i]),
                             _jrel(rds[i], ns_r[i], ovf[i]),
                             0, 1, ((1, 2),), (0,), 64), _member(out, i))


@pytest.mark.parametrize("cols", [(0,), (2, 0), (1, 1, 2), (0, 1, 2), ()])
@pytest.mark.parametrize("dedupe", [True, False])
def test_project(cols, dedupe):
    rng = np.random.default_rng(len(cols) + 5 * dedupe)
    data = _rel_np(rng, 64, 3, 50, 3)
    _assert_same(JE.project(_jrel(data, 50), cols, dedupe),
                 TE.project(_trel(data, 50), cols, dedupe))


def test_project_member_axis():
    rng = np.random.default_rng(9)
    ns = [64, 5, 0]
    datas = [_rel_np(rng, 64, 3, n, 3) for n in ns]
    out = TE.project(_trel_batch(datas, ns, [False] * 3), (2, 0), True)
    for i, n in enumerate(ns):
        _assert_same(JE.project(_jrel(datas[i], n), (2, 0), True),
                     _member(out, i))


# ----------------------------------------------------------------------
# scans over the six TT indexes
# ----------------------------------------------------------------------
def _scan_cases(uni):
    d = uni.dictionary
    t = d.lookup("rdf:type")
    takes = d.lookup("ub:takesCourse")
    grad = d.lookup("ub:GraduateStudent")
    stu = d.lookup("u0.d0.s0")
    crs = d.lookup("u0.d1.c3")
    return [
        # index, prefix, residual, takes, self_eq, cap
        ("spo", (), (), (0, 1, 2), (), 4096),
        ("spo", (), (), (0, 1, 2), (), 64),                  # overflow
        ("pos", ((1, takes),), (), (0, 2), (), 1024),
        ("spo", ((0, stu),), (), (1, 2), (), 16),
        ("pos", ((1, t), (2, grad)), (), (0,), (), 512),
        ("pos", ((1, takes), (2, crs)), (), (0,), (), 8),     # overflow
        ("pso", ((1, takes),), ((2, crs),), (0,), (), 1024),
        ("spo", ((0, stu),), ((2, crs),), (1,), (), 16),
        ("pos", ((1, takes),), (), (0,), ((0, 2),), 1024),    # self-join
        ("pos", ((1, 999_999), (2, 3)), (), (0,), (), 16),    # empty range
    ]


@pytest.mark.parametrize("padded", [False, True])
def test_scan_pattern(uni, padded):
    if padded:
        cap = len(uni.store) + 100
        jtt = JE.tt_device_indexes_padded(uni.store, cap)
        ttt = TE.tt_device_indexes_padded(uni.store, cap, "cpu")
        assert int((ttt["spo"][:, 0] == SENTINEL).sum()) == 100
    else:
        jtt = JE.tt_device_indexes(uni.store)
        ttt = TE.tt_device_indexes(uni.store, "cpu")
    for idx, prefix, residual, takes, self_eq, cap in _scan_cases(uni):
        j = JE.scan_pattern(jtt[idx], prefix, residual, takes, self_eq, cap)
        t = TE.scan_pattern(ttt[idx], prefix, residual, takes, self_eq, cap)
        _assert_same(j, t)


def test_scan_pattern_member_axis(uni):
    d = uni.dictionary
    takes = d.lookup("ub:takesCourse")
    crs = [d.lookup(c) for c in ("u0.d0.c0", "u0.d1.c2", "u0.d1.c4")]
    ttt = TE.tt_device_indexes(uni.store, "cpu")
    jtt = JE.tt_device_indexes(uni.store)
    pvals = torch.tensor([[takes, c] for c in crs], dtype=torch.int32)
    out = TE.scan_pattern_batched(ttt["pos"], (1, 2), pvals, (),
                                  torch.zeros((3, 0), dtype=torch.int32),
                                  (0,), (), 32)
    for i, c in enumerate(crs):
        _assert_same(JE.scan_pattern(jtt["pos"], ((1, takes), (2, c)), (),
                                     (0,), (), 32), _member(out, i))


# ----------------------------------------------------------------------
# planner helpers and the per-query executor
# ----------------------------------------------------------------------
def _all_atoms(uni):
    ms, _ = reformulate_workload(lubm_workload(uni.dictionary), uni.schema,
                                 uni.type_id, 2048)
    return [a for m in ms for a in m.atoms]


def test_scan_specs_and_range_cardinality_agree(uni):
    from repro_torch.rdf.triples import TripleStore as TStore
    from repro_torch.core.queries import Atom, Const, Var

    def to_port(atom):
        return Atom(*[Var(t.name) if hasattr(t, "name") else Const(t.id)
                      for t in atom.terms()])

    tstats = TStore(uni.store.triples).stats
    atoms = _all_atoms(uni)
    assert len(atoms) > 20
    for atom in atoms:
        for prefer in (None, "x", "y", "z", "u"):
            js = JE.atom_scan_spec(atom, prefer)
            ts = TE.atom_scan_spec(to_port(atom), prefer)
            assert js == ts, atom
        assert TE.range_cardinality(to_port(atom), js[1], tstats) == \
            JE.range_cardinality(atom, js[1], uni.store.stats)
    assert TE.INDEX_NAMES == JE.INDEX_NAMES


def test_build_executor_answers_like_jax(uni):
    from repro_torch.api import serde as tserde
    from repro.api import serde as jserde
    from repro_torch.rdf.triples import TripleStore as TStore

    tstore = TStore(uni.store.triples)
    jtt = JE.tt_device_indexes(uni.store)
    ttt = TE.tt_device_indexes(tstore, "cpu")
    for q in lubm_workload(uni.dictionary):
        jplan = plan_for_cq(q)
        tplan = tserde.plan_from_json(jserde.plan_to_json(jplan))
        j = jax.jit(JE.build_executor(jplan, uni.store.stats, {}))(jtt, {})
        t = TE.build_executor(tplan, tstore.stats, {})(ttt, {})
        _assert_same(j, t)
        assert not bool(t.overflow)
