"""The slice as a whole: the port's `TuningSession` against the JAX
package's on the same store and workload — the tuned search, applied
answers, the delta swap, device materialization, and a tuned state
carried across from the JAX package."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import SearchConfig as JSearch  # noqa: E402
from repro.api import TuningSession as JSession  # noqa: E402
from repro.api import WizardConfig as JConfig  # noqa: E402
from repro.api import serde as jserde  # noqa: E402
from repro.rdf.generator import generate, lubm_workload  # noqa: E402
from repro_torch.api import SearchConfig as TSearch  # noqa: E402
from repro_torch.api import TuningSession as TSession  # noqa: E402
from repro_torch.api import WizardConfig as TConfig  # noqa: E402
from repro_torch.api import from_reference  # noqa: E402
from repro_torch.api import serde as tserde  # noqa: E402
from repro_torch.kernels import join_count as jc  # noqa: E402
from repro_torch.rdf import generator as tgen  # noqa: E402
from repro_torch.views import materializer as tmat  # noqa: E402

NAMES = ["q1", "q2", "q3", "q4", "q5", "q6"]
# the state budget, not the clock, ends the search in both packages
SEARCH = dict(strategy="greedy", max_states=400, max_seconds=1e9)


@pytest.fixture(scope="module")
def unis():
    """The same universe generated by each package from one seed."""
    return generate(n_universities=2, seed=0), \
        tgen.generate(n_universities=2, seed=0)


def _sessions(unis):
    ju, tu = unis
    js = JSession(ju.store, lubm_workload(ju.dictionary), schema=ju.schema,
                  type_id=ju.type_id, cfg=JConfig(search=JSearch(**SEARCH)))
    ts = TSession(tu.store, tgen.lubm_workload(tu.dictionary),
                  schema=tu.schema, type_id=tu.type_id,
                  cfg=TConfig(search=TSearch(**SEARCH)), device="cpu")
    return js, ts


@pytest.fixture(scope="module")
def applied(unis):
    js, ts = _sessions(unis)
    jrep, trep = js.retune(), ts.retune()
    japp, tapp = js.apply(), ts.apply()
    return js, ts, (jrep, trep), (japp, tapp)


def test_same_universe(unis):
    ju, tu = unis
    np.testing.assert_array_equal(tu.store.triples, ju.store.triples)
    assert tu.dictionary._to_str == ju.dictionary._to_str


def test_tuned_search_equal(applied):
    js, ts, (jrep, trep), _ = applied
    assert trep.result.explored == jrep.result.explored
    assert sorted(v.cq.canonical_key() for v in ts.best.views.values()) == \
        sorted(v.cq.canonical_key() for v in js.best.views.values())
    assert tserde.state_to_json(ts.best) == jserde.state_to_json(js.best)
    assert ts.groups == js.groups
    assert trep.result.best_quality.total == jrep.result.best_quality.total


def test_applied_answers_equal(applied):
    js, ts, _, (japp, tapp) = applied
    assert (tapp.materialized, tapp.reused, tapp.dropped, tapp.full) == \
        (japp.materialized, japp.reused, japp.dropped, japp.full)
    for name in NAMES:
        got = ts.answer(name)
        assert got == js.answer(name), name
        assert got == ts.executor.answer_group_direct(name), name
    joins = [b for b in ts.executor.workload._prog.buckets
             if b.kind == "join"]
    assert joins, "the tuned program should keep join buckets"
    t, jt = ts.executor.telemetry(), js.executor.telemetry()
    assert set(t) == set(jt)
    assert t["buckets"] == jt["buckets"]
    assert jc.launches == 0  # the CPU path never launches the kernel


def test_per_query_path_equal(applied):
    js, ts, _, _ = applied
    for name in NAMES:
        assert ts.executor.answer_group_per_query(name) == \
            ts.answer(name), name


def test_delta_swap_equal(unis):
    js, ts = _sessions(unis)
    js.retune(), ts.retune()
    js.apply(), ts.apply()
    for s in (js, ts):
        s.remove_query("q1")
    jrep, trep = js.retune(), ts.retune()
    assert trep.removed == jrep.removed and trep.warm and jrep.warm
    japp, tapp = js.apply(), ts.apply()
    assert not tapp.full
    assert (tapp.materialized, tapp.reused, tapp.dropped) == \
        (japp.materialized, japp.reused, japp.dropped)
    assert "q1" not in ts.groups
    for name in NAMES[1:]:
        got = ts.answer(name)
        assert got == js.answer(name), name
        assert got == ts.executor.answer_group_direct(name), name


def test_snapshot_restore_rolls_back(unis):
    _, ts = _sessions(unis)
    ts.retune()
    ts.apply()
    before = {name: ts.answer(name) for name in NAMES}
    snap = ts.snapshot()
    ts.remove_query("q2")
    ts.retune()
    ts.apply()
    ts.restore(snap)
    assert not ts.pending
    for name in NAMES:
        assert ts.answer(name) == before[name], name


def test_device_materialization_equals_host(applied):
    _, ts, _, _ = applied
    state, store = ts.best, ts.store
    host, _, host_infos = tmat.materialize_state(state, store, device="cpu")
    dev, dev_views, dev_infos = tmat.materialize_state_device(
        state, store, device="cpu")
    assert set(dev) == set(host)
    for vid in host:
        assert dev[vid].cols == host[vid].cols
        assert dev[vid].as_set() == host[vid].as_set(), vid
        assert dev_infos[vid] == host_infos[vid]
        assert dev_views[vid].cap >= len(host[vid].rows)


def test_carry_across_from_reference(applied):
    js, _, _, _ = applied
    ju_store = js.store
    carried = from_reference(
        ju_store.triples, list(ju_store.dictionary._to_str),
        jserde.state_to_json(js.best), js.groups, device="cpu")
    np.testing.assert_array_equal(carried.store.triples, ju_store.triples)
    assert tserde.state_to_json(carried.state) == \
        jserde.state_to_json(js.best)
    jres = js.executor.answer_workload()
    tres = carried.executor.answer_workload()
    assert set(tres) == set(jres)
    for member in jres:
        np.testing.assert_array_equal(tres[member], jres[member],
                                      err_msg=member)
    for name in NAMES:
        assert carried.executor.answer_group(name) == js.answer(name), name


def test_carry_across_rejects_unknown_members(applied):
    js, _, _, _ = applied
    with pytest.raises(ValueError, match="lacks"):
        from_reference(js.store.triples, None, jserde.state_to_json(js.best),
                       {"q1": ["nope"]}, device="cpu")


def test_tune_shim_matches_jax(unis):
    """The deprecated one-shot `tune()` of both packages reaches the same
    state and answers."""
    import warnings

    from repro.core.wizard import tune as j_tune
    from repro_torch.core.wizard import tune as t_tune

    ju, tu = unis
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jrep = j_tune(ju.store, lubm_workload(ju.dictionary), ju.schema,
                      ju.type_id, JConfig(search=JSearch(**SEARCH)))
        trep = t_tune(tu.store, tgen.lubm_workload(tu.dictionary), tu.schema,
                      tu.type_id, TConfig(search=TSearch(**SEARCH)),
                      device="cpu")
    assert tserde.state_to_json(trep.result.best) == \
        jserde.state_to_json(jrep.result.best)
    assert trep.initial_quality.total == jrep.initial_quality.total
    assert trep.groups == jrep.groups
    for name in NAMES:
        assert trep.executor.answer_group(name) == \
            jrep.executor.answer_group(name), name


def test_refresh_keeps_answers_and_learned_caps(unis):
    """`refresh()` re-materializes and rebuilds the program; capacities
    the adaptive driver learned carry into the rebuilt one."""
    from repro_torch.core.executor import QueryExecutor

    _, ts = _sessions(unis)
    ts.retune()
    ex = QueryExecutor(ts.store, ts.best, ts.groups, device="cpu",
                       cap_planner=lambda n, r: 8, max_retries=24)
    before = {name: ex.answer_group(name) for name in NAMES}
    learned = ex.workload.learned_caps()
    assert learned, "tiny capacities must have been grown"
    ex.refresh()
    assert ex.workload.carry_caps == learned
    for name in NAMES:
        assert ex.answer_group(name) == before[name], name
        assert before[name] == ex.answer_group_direct(name), name
    assert ex.workload.recompiles == 0


def test_cartesian_rewriting_takes_the_oracle(unis):
    """A disconnected rewriting is not compiled to the device program:
    both executors answer it through the oracle over the extents."""
    from repro.core.executor import QueryExecutor as JExecutor
    from repro.core.queries import CQ, Atom, Const, Var
    from repro.core.state import State, View
    from repro.query.plan import EquiJoin, ViewRef
    from repro_torch.core.executor import QueryExecutor as TExecutor

    ju, tu = unis
    d = ju.dictionary
    t = Const(ju.type_id)
    x, y = Var("x"), Var("y")
    a_grad = Atom(x, t, Const(d.lookup("ub:GraduateStudent")))
    a_full = Atom(y, t, Const(d.lookup("ub:FullProfessor")))
    q = CQ((x, y), (a_grad, a_full), name="pairs")
    state = State(
        views={0: View(0, CQ((x,), (a_grad,), name="v0")),
               1: View(1, CQ((y,), (a_full,), name="v1"))},
        rewritings={"pairs": EquiJoin(ViewRef(0, ("x",)), ViewRef(1, ("y",)),
                                      ())},
        queries=(q,), next_view_id=2)
    jex = JExecutor(ju.store, state)
    tex = TExecutor(tu.store, tserde.state_from_json(
        jserde.state_to_json(state)), device="cpu")
    assert tex.telemetry()["oracle_fallbacks"] == 1
    got = tex.answer_group("pairs")
    assert got == jex.answer_group("pairs") == tex.answer_group_direct("pairs")
    assert len(got) > 1
