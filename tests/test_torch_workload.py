"""The port's bucketed workload program against `repro.query.buckets` /
`repro.query.workload` on the same DAG: planning, execution, overflow
promotion, the unrolled mode and telemetry."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import serde as jserde  # noqa: E402
from repro.core.queries import CQ, Atom, Const, Var  # noqa: E402
from repro.core.reformulation import reformulate_workload  # noqa: E402
from repro.query import buckets as JB  # noqa: E402
from repro.query import engine as JE  # noqa: E402
from repro.query.dag import build_dag as j_build_dag  # noqa: E402
from repro.query.plan import TTScan, plan_for_cq  # noqa: E402
from repro.query.workload import WorkloadExecutor as JWorkload  # noqa: E402
from repro.rdf.generator import generate, lubm_workload  # noqa: E402
from repro_torch.api import serde as tserde  # noqa: E402
from repro_torch.query import buckets as TB  # noqa: E402
from repro_torch.query import engine as TE  # noqa: E402
from repro_torch.query.dag import build_dag as t_build_dag  # noqa: E402
from repro_torch.query.plan import TTScan as TTTScan  # noqa: E402
from repro_torch.query.plan import plan_for_cq as t_plan_for_cq  # noqa: E402
from repro_torch.query.workload import WorkloadExecutor as TWorkload  # noqa: E402
from repro_torch.rdf.triples import TripleStore as TStore  # noqa: E402


@pytest.fixture(scope="module")
def uni():
    return generate(n_universities=1, seed=0, dept_per_univ=2,
                    prof_per_dept=4, stud_per_dept=12, course_per_dept=5)


@pytest.fixture(scope="module")
def tstore(uni):
    return TStore(uni.store.triples)


@pytest.fixture(scope="module")
def tts(uni, tstore):
    return JE.tt_device_indexes(uni.store), TE.tt_device_indexes(tstore, "cpu")


def _port_cq(q):
    return tserde.cq_from_json(jserde.cq_to_json(q))


@pytest.fixture(scope="module")
def members(uni):
    ms, _ = reformulate_workload(list(lubm_workload(uni.dictionary)),
                                 uni.schema, uni.type_id, 2048)
    return ms


def _dags(queries):
    jd = j_build_dag({q.name: plan_for_cq(q) for q in queries})
    td = t_build_dag({q.name: t_plan_for_cq(_port_cq(q)) for q in queries})
    return jd, td


def _assert_roots_equal(jroots, troots):
    assert set(jroots) == set(troots)
    for name in jroots:
        j, t = jroots[name], troots[name]
        np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data),
                                      err_msg=name)
        assert int(t.n) == int(j.n) and bool(t.overflow) == bool(j.overflow)


def _answers(roots, to_numpy):
    return {name: {tuple(r) for r in to_numpy(rel).tolist()}
            for name, rel in roots.items()}


def test_plan_buckets_and_capacities_equal(uni, tstore, members):
    jd, td = _dags(members)
    assert [n.key for n in jd.nodes] == [n.key for n in td.nodes]
    assert TB.node_waves(td) == JB.node_waves(jd)
    jplan = JB.plan_capacities(jd, uni.store.stats, {})
    tplan = TB.plan_capacities(td, tstore.stats, {})
    assert jplan == tplan
    caps, scan_specs, join_specs, _ = tplan
    jbk, _ = JB.plan_buckets(jd, *jplan[:3])
    tbk, _ = TB.plan_buckets(td, caps, scan_specs, join_specs)
    assert [(b.kind, b.wave, b.static, b.cap, b.node_ids) for b in jbk] == \
        [(b.kind, b.wave, b.static, b.cap, b.node_ids) for b in tbk]
    assert any(b.kind == "join" for b in tbk)


def test_execute_roots_equal(uni, tstore, tts, members):
    jd, td = _dags(members)
    jtt, ttt = tts
    jprog = JB.BucketedProgram(jd, uni.store.stats, {})
    tprog = TB.BucketedProgram(td, tstore.stats, {}, device="cpu")
    jroots, jown = jprog.execute(jtt, {})
    troots, town = tprog.execute(ttt, {})
    _assert_roots_equal(jroots, troots)
    np.testing.assert_array_equal(town, jown)
    assert tprog.n_buckets == jprog.n_buckets


def test_tiny_capacities_promote_like_jax(uni, tstore, tts):
    """cap_planner -> 8: both drivers overflow, promote the same buckets
    the same number of times, and end with the same exact answers."""
    wl = {q.name: q for q in lubm_workload(uni.dictionary)}
    jd, td = _dags([wl["q2"], wl["q5"]])
    jtt, ttt = tts
    jw = JWorkload(jd, uni.store.stats, {}, cap_planner=lambda n, r: 8,
                   max_retries=24)
    tw = TWorkload(td, tstore.stats, {}, device="cpu",
                   cap_planner=lambda n, r: 8, max_retries=24)
    jroots = jw.run(jtt, {})
    troots = tw.run(ttt, {})
    _assert_roots_equal(jroots, troots)
    assert tw.recompiles == jw.recompiles >= 1
    assert tw.cap_history == jw.cap_history
    assert [b.promotions for b in tw._prog.buckets] == \
        [b.promotions for b in jw._prog.buckets]
    assert tw.learned_caps() == jw.learned_caps()


def _course_scan_workload(uni):
    d = uni.dictionary
    takes = Const(d.lookup("ub:takesCourse"))
    adv = Const(d.lookup("ub:advisor"))
    x, y = Var("x"), Var("y")
    qs = [CQ((x,), (Atom(x, takes, Const(d.lookup(c))),), name=f"takes{i}")
          for i, c in enumerate(["u0.d0.c0", "u0.d0.c1", "u0.d1.c0"])]
    qs.append(CQ((x, y), (Atom(x, adv, y),), name="adv"))
    return qs, takes


def test_overflow_promotes_only_offending_bucket(uni, tstore, tts):
    """Twin of the JAX test of the same name: one overflowing bucket is
    promoted and rebuilt, the other never is — and the counts equal
    the JAX driver's."""
    TB.clear_compile_cache()
    JB.clear_compile_cache()
    qs, takes = _course_scan_workload(uni)
    jd, td = _dags(qs)
    jtt, ttt = tts

    def j_planner(plan, rows):
        if isinstance(plan, TTScan) and plan.atom.p == takes:
            return 2
        return 512

    def t_planner(plan, rows):
        if isinstance(plan, TTTScan) and plan.atom.p.id == takes.id:
            return 2
        return 512

    jw = JWorkload(jd, uni.store.stats, {}, cap_planner=j_planner,
                   max_retries=16)
    tw = TWorkload(td, tstore.stats, {}, device="cpu", cap_planner=t_planner,
                   max_retries=16)
    jroots = jw.run(jtt, {})
    troots = tw.run(ttt, {})
    _assert_roots_equal(jroots, troots)
    assert tw.recompiles == jw.recompiles >= 1
    t = tw.telemetry()
    jt = jw.telemetry()
    assert t["mode"] == "bucketed"
    promoted = [b for b in tw._prog.buckets if b.promotions > 0]
    assert len(promoted) == 1
    assert promoted[0].kind == "scan" and len(promoted[0].node_ids) == 3
    log = t["bucket_compile_log"]
    assert len(log) == t["buckets"] + promoted[0].promotions
    for entry in log[t["buckets"]:]:
        assert entry["kind"] == "scan"
        assert entry["batch"] == 3 and entry["cap"] > 2
    assert sum(1 for e in log if e["batch"] == 1) == 1
    for key in ("buckets", "bucket_signatures", "bucket_compiles",
                "bucket_cache_hits", "bucket_cache_misses",
                "bucket_promotions", "compiles", "runs", "recompiles",
                "grown_nodes"):
        assert t[key] == jt[key], key
    assert [(e["bucket"], e["cap"], e["batch"]) for e in log] == \
        [(e["bucket"], e["cap"], e["batch"]) for e in jt["bucket_compile_log"]]
    stats = TB.compile_cache().stats()
    jstats = JB.compile_cache().stats()
    assert set(stats) == set(jstats)
    for key in ("entries", "hits", "misses", "evictions", "max_entries"):
        assert stats[key] == jstats[key], key


@pytest.mark.parametrize("use_members", [False, True])
def test_unrolled_mode_answers_equal(uni, tstore, tts, members, use_members):
    qs = members if use_members else _course_scan_workload(uni)[0]
    jd, td = _dags(qs)
    jtt, ttt = tts
    ju = JWorkload(jd, uni.store.stats, {}, mode="unrolled").run(jtt, {})
    tu = TWorkload(td, tstore.stats, {}, device="cpu",
                   mode="unrolled").run(ttt, {})
    tb = TWorkload(td, tstore.stats, {}, device="cpu").run(ttt, {})
    want = _answers(ju, JE.to_numpy)
    assert _answers(tu, TE.to_numpy) == want
    assert _answers(tb, TE.to_numpy) == want


def test_unrolled_overflow_regrows_like_jax(uni, tstore, tts):
    qs, _ = _course_scan_workload(uni)
    jd, td = _dags(qs)
    jtt, ttt = tts
    jw = JWorkload(jd, uni.store.stats, {}, mode="unrolled",
                   cap_planner=lambda n, r: 2, max_retries=24)
    tw = TWorkload(td, tstore.stats, {}, device="cpu", mode="unrolled",
                   cap_planner=lambda n, r: 2, max_retries=24)
    _assert_roots_equal(jw.run(jtt, {}), tw.run(ttt, {}))
    assert tw.recompiles == jw.recompiles >= 1
    assert tw.caps == jw.caps and tw.cap_history == jw.cap_history


def test_retry_budget_trips(uni, tstore, tts, members):
    _, td = _dags(members)
    tw = TWorkload(td, tstore.stats, {}, device="cpu",
                   cap_planner=lambda n, r: 2, max_retries=1)
    with pytest.raises(RuntimeError, match="overflow persists"):
        tw.run(tts[1], {})
    assert tw.recompiles == 1


@pytest.mark.parametrize("mode", ["bucketed", "unrolled"])
def test_telemetry_keys_equal(uni, tstore, tts, mode):
    TB.clear_compile_cache()
    JB.clear_compile_cache()
    qs, _ = _course_scan_workload(uni)
    jd, td = _dags(qs)
    jw = JWorkload(jd, uni.store.stats, {}, mode=mode)
    tw = TWorkload(td, tstore.stats, {}, device="cpu", mode=mode)
    jw.run(tts[0], {})
    tw.run(tts[1], {})
    jt, tt = jw.telemetry(), tw.telemetry()
    assert set(tt) == set(jt)
    assert set(tt["compile_cache"]) == set(jt["compile_cache"])
    if mode == "bucketed":
        assert set(tt["bucket_compile_log"][0]) == \
            set(jt["bucket_compile_log"][0])


def test_compile_cache_lru_bound():
    cache = TB.CompileCache(max_entries=2)
    for k in range(3):
        cache.get(k, lambda: (lambda: None))
    body, cached, _ = cache.get(2, lambda: None)
    assert cached and cache.stats()["evictions"] == 1
    assert TB.DEFAULT_CACHE_ENTRIES == JB.DEFAULT_CACHE_ENTRIES == 512
    assert TB.CAP_CEIL == JB.CAP_CEIL
    with pytest.raises(ValueError):
        TB.CompileCache(max_entries=0)
    cache.resize(1)
    assert cache.stats()["entries"] == 1
    assert cache.stats()["evictions"] == 2
    with pytest.raises(ValueError):
        cache.resize(0)
