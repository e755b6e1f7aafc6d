"""The port's streaming view maintenance against the JAX package's.

The same store, workload and seeded numpy stream go through the JAX
`TuningSession.ingest` and the port's, on the CPU (`device="cpu"`: the
port's appends and join probes take their kernels' plain versions; the
JAX package runs its Pallas kernels in interpret mode).  After every
batch the two agree exactly: reports, the store, every view's host
extent row for row, the device buffers' capacity classes and valid
prefixes; after the stream, the answers and the extents against full
re-evaluation."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import SearchConfig as JSearch  # noqa: E402
from repro.api import TuningSession as JSession  # noqa: E402
from repro.api import WizardConfig as JConfig  # noqa: E402
from repro.api import serde as jserde  # noqa: E402
from repro.core import queries as jq  # noqa: E402
from repro.maintenance import MaintenanceConfig as JMaintConfig  # noqa: E402
from repro.rdf.triples import TripleStore as JStore  # noqa: E402
from repro_torch.api import MaintenanceConfig as TMaintConfig  # noqa: E402
from repro_torch.api import SearchConfig as TSearch  # noqa: E402
from repro_torch.api import TuningSession as TSession  # noqa: E402
from repro_torch.api import WizardConfig as TConfig  # noqa: E402
from repro_torch.api import from_reference  # noqa: E402
from repro_torch.api import serde as tserde  # noqa: E402
from repro_torch.core import queries as tq  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import scatter_append as sa  # noqa: E402
from repro_torch.query import ref_engine as TR  # noqa: E402
from repro_torch.rdf.triples import TripleStore as TStore  # noqa: E402

PREDS = [1, 2, 3, 4, 5]
# the state budget, not the clock, ends the search in both packages
SEARCH = dict(strategy="greedy", max_states=400, max_seconds=1e9)
REPORT_FIELDS = ("n_inserts", "n_deletes", "eff_inserts", "eff_deletes",
                 "appended", "removed", "delta_candidates", "oracle_views",
                 "extents_scanned", "extent_growths", "tt_grew")
ENGINES = ("host", "device")


def _random_store(rng, n=600, n_ids=60):
    return np.stack([rng.integers(0, n_ids, n), rng.choice(PREDS, n),
                     rng.integers(0, n_ids, n)], axis=1).astype(np.int32)


def _random_batch(rng, n, n_ids=60):
    return np.stack([rng.integers(0, n_ids, n), rng.choice(PREDS, n),
                     rng.integers(0, n_ids, n)], axis=1).astype(np.int32)


def _chain_cq(Q, name, p1, p2):
    x, y, z = Q.Var("x"), Q.Var("y"), Q.Var("z")
    return Q.CQ(name=name, head=(x, y, z),
                atoms=(Q.Atom(x, Q.Const(p1), y), Q.Atom(y, Q.Const(p2), z)))


def _pair(seed, chains=((1, 2), (2, 3)), engine="device", delta_cap=64):
    """A JAX and a port session on one seeded store, tuned, applied and
    given maintainers of the same config.  Returns (rng, js, ts)."""
    rng = np.random.default_rng(seed)
    tt = _random_store(rng)
    names = [f"q{i + 1}" for i in range(len(chains))]
    js = JSession(JStore(tt),
                  [_chain_cq(jq, n, *c) for n, c in zip(names, chains)],
                  cfg=JConfig(search=JSearch(**SEARCH)))
    ts = TSession(TStore(tt),
                  [_chain_cq(tq, n, *c) for n, c in zip(names, chains)],
                  cfg=TConfig(search=TSearch(**SEARCH)), device="cpu")
    for s in (js, ts):
        s.retune()
        s.apply()
    js.maintainer(JMaintConfig(delta_cap=delta_cap, insert_engine=engine))
    ts.maintainer(TMaintConfig(delta_cap=delta_cap, insert_engine=engine))
    assert tserde.state_to_json(ts.best) == jserde.state_to_json(js.best)
    return rng, js, ts


def _assert_same_views(js, ts):
    jex, tex = js.executor, ts.executor
    np.testing.assert_array_equal(tex.store.triples, jex.store.triples)
    assert sorted(tex.extents) == sorted(jex.extents)
    for vid in jex.extents:
        assert tex.extents[vid].cols == jex.extents[vid].cols
        np.testing.assert_array_equal(tex.extents[vid].rows,
                                      jex.extents[vid].rows, err_msg=vid)
        assert tex.device_views[vid].cap == jex.device_views[vid].cap
        js.maintainer().check_alignment(vid)
        ts.maintainer().check_alignment(vid)
    assert ts.maintainer()._ext_keys == js.maintainer()._ext_keys
    assert ts.maintainer().tt_cap == js.maintainer().tt_cap
    for name, t in ts.executor.tt.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(jex.tt[name]))


def _ingest(js, ts, ins, dels):
    jr = js.ingest(ins, dels)
    tr = ts.ingest(ins, dels)
    for f in REPORT_FIELDS:
        assert getattr(tr, f) == getattr(jr, f), f
    assert vars(tr.drift) == vars(jr.drift)
    _assert_same_views(js, ts)
    return jr, tr


def _stream(rng, js, ts, steps, batch=48):
    for _ in range(steps):
        ins = _random_batch(rng, batch)
        cur = ts.store.triples
        n_del = int(rng.integers(0, batch))
        dels = cur[rng.choice(len(cur), min(n_del, len(cur)), replace=False)]
        _ingest(js, ts, ins, dels)


def _assert_final(js, ts):
    ex = ts.executor
    for vid, view in ex.state.views.items():
        want = np.unique(TR.evaluate_cq(view.cq, ex.store).rows, axis=0)
        got = np.unique(ex.extents[vid].rows, axis=0)
        np.testing.assert_array_equal(got.reshape(want.shape), want)
    for q in ts.workload:
        got = ts.answer(q.name)
        assert got == js.answer(q.name) == ex.answer_group_direct(q.name)


# ----------------------------------------------------------------------
# the maintainer, batch for batch
# ----------------------------------------------------------------------
@pytest.mark.parametrize("engine", ENGINES)
def test_stream_matches_jax(engine):
    rng, js, ts = _pair(1234, engine=engine)
    before = sa.launches
    _stream(rng, js, ts, steps=4)
    _assert_final(js, ts)
    jt, tt = js.maintainer().telemetry(), ts.maintainer().telemetry()
    assert set(tt) == set(jt)
    for key in ("batches", "triples_applied", "extent_growths", "tt_growths",
                "tt_cap", "oracle_views", "delete_scans", "delta_plans",
                "delta_leaves", "measured_views", "drift_triggers",
                "insert_engine", "delta_compiles", "delta_recompiles",
                "delta_runs"):
        assert tt[key] == jt[key], key
    assert tt["insert_engine"] == engine
    assert tt["delta_recompiles"] == 0
    if engine == "device":
        assert tt["delta_compiles"] == 1
    assert sa.launches == before  # the CPU path never launches the kernel


@pytest.mark.parametrize("engine", ENGINES)
def test_delete_only_and_insert_only_batches(engine):
    rng, js, ts = _pair(9, chains=((1, 2),), engine=engine)
    jr, tr = _ingest(js, ts, None, ts.store.triples[:64])
    assert tr.eff_deletes > 0 and tr.eff_inserts == 0
    jr, tr = _ingest(js, ts, _random_batch(rng, 64), None)
    assert tr.eff_inserts > 0 and tr.eff_deletes == 0
    _assert_final(js, ts)


def test_extent_growth_matches_jax():
    """A batch far above the extents' headroom grows their capacity
    classes; the device append writes past the old capacity."""
    rng, js, ts = _pair(17, engine="device", delta_cap=64)
    caps = {vid: p.cap for vid, p in ts.executor.device_views.items()}
    jr, tr = _ingest(js, ts, _random_batch(rng, 900), None)
    assert tr.extent_growths
    for vid in tr.extent_growths:
        assert ts.executor.device_views[vid].cap > caps[vid]
    _assert_final(js, ts)


def test_delete_pass_scans_only_inverted_index_candidates():
    rng, js, ts = _pair(21, chains=((1, 2), (3, 4)), engine="host")
    m = ts.maintainer()
    maintained = set(ts.executor.state.views) - m.plans.oracle_vids

    def expected_scans(preds):
        cand = set(m._wild_vids)
        for p in preds:
            cand |= m._pred_vids.get(p, set())
        return len(cand - m.plans.oracle_vids)

    cur = ts.store.triples
    _, r5 = _ingest(js, ts, None, cur[cur[:, 1] == 5][:16])
    assert r5.extents_scanned == expected_scans({5})
    assert r5.extents_scanned < len(maintained)
    cur = ts.store.triples
    _, r1 = _ingest(js, ts, None, cur[cur[:, 1] == 1][:16])
    assert r1.extents_scanned == expected_scans({1})
    assert m.telemetry()["delete_scans"] == \
        r5.extents_scanned + r1.extents_scanned
    _assert_final(js, ts)


def test_property_random_streams():
    pytest.importorskip("hypothesis")
    from hypothesis import HealthCheck, given, settings
    from hypothesis import strategies as st

    # few examples: each tunes two sessions and replays a stream
    @settings(max_examples=3, deadline=None,
              suppress_health_check=[HealthCheck.too_slow])
    @given(seed=st.integers(0, 10**6))
    def run(seed):
        rng, js, ts = _pair(seed, engine="host")
        _stream(rng, js, ts, steps=3, batch=32)
        _assert_final(js, ts)

    run()


def test_append_takes_n_from_the_host_mirror(monkeypatch):
    """The device engine's append reads no count back from the device: it
    takes n from the host mirror, which must equal the device count on
    every append of a seeded stream (growths included), and the new count
    stays an int32 scalar on the buffer's device."""
    rng, js, ts = _pair(1234, engine="device")
    m, ex = ts.maintainer(), ts.executor
    expected, passed = [], []
    real_rows, real_append = m._append_rows, tops.scatter_append

    def spy_rows(vid, rows, report):
        expected.append(int(ex.device_views[vid].n))
        real_rows(vid, rows, report)
        prel = ex.device_views[vid]
        assert prel.n.dtype == torch.int32 and prel.n.dim() == 0
        assert prel.n.device == prel.data.device
        assert int(prel.n) == expected[-1] + len(rows)

    def spy_append(buf, n, rows, k):
        assert isinstance(n, int) and isinstance(k, int)
        passed.append(n)
        return real_append(buf, n, rows, k)

    monkeypatch.setattr(m, "_append_rows", spy_rows)
    monkeypatch.setattr(tops, "scatter_append", spy_append)
    _stream(rng, js, ts, steps=4)
    _, grown = _ingest(js, ts, _random_batch(rng, 900), None)
    assert grown.extent_growths
    assert len(passed) > 0 and passed == expected


# ----------------------------------------------------------------------
# transactions
# ----------------------------------------------------------------------
def test_failed_batch_rolls_back(monkeypatch):
    rng, _js, ts = _pair(5, engine="device")
    m, ex = ts.maintainer(), ts.executor
    before = {
        "store": ex.store, "tt": {k: v.clone() for k, v in ex.tt.items()},
        "views": {vid: (p.data.clone(), int(p.n), bool(p.overflow))
                  for vid, p in ex.device_views.items()},
        "extents": {vid: r.rows.copy() for vid, r in ex.extents.items()},
        "keys": {vid: set(k) for vid, k in m._ext_keys.items()},
        "tt_cap": m.tt_cap,
    }
    # the buffers as they stand, by reference: the append must write a
    # new buffer and leave these (which a snapshot shares) bit for bit
    shared = {vid: p.data for vid, p in ex.device_views.items()}
    appends = []
    real_append = tops.scatter_append

    def counting(*args):
        appends.append(args[3])
        return real_append(*args)

    def boom(report):
        raise RuntimeError("injected after the append")

    monkeypatch.setattr(tops, "scatter_append", counting)
    monkeypatch.setattr(m, "_observe_costs", boom)
    cur = ex.store.triples
    with pytest.raises(RuntimeError, match="injected"):
        ts.ingest(_random_batch(rng, 48), cur[:8])
    assert appends and sum(appends) > 0, "the batch never reached the append"
    assert ex.store is before["store"] and ts.store is before["store"]
    assert m.tt_cap == before["tt_cap"]
    for k, v in ex.tt.items():
        assert torch.equal(v, before["tt"][k])
    assert sorted(ex.device_views) == sorted(before["views"])
    for vid, p in ex.device_views.items():
        data, n, ovf = before["views"][vid]
        assert p.data is shared[vid] and torch.equal(p.data, data)
        assert p.data.dtype == data.dtype and p.data.shape == data.shape
        assert int(p.n) == n and p.n.dtype == torch.int32
        assert bool(p.overflow) == ovf
        np.testing.assert_array_equal(ex.extents[vid].rows,
                                      before["extents"][vid])
        assert m._ext_keys[vid] == before["keys"][vid]
        m.check_alignment(vid)
    monkeypatch.undo()
    # the same batch applies cleanly afterwards
    ts.ingest(_random_batch(rng, 48), cur[:8])
    for vid in ex.device_views:
        m.check_alignment(vid)


# ----------------------------------------------------------------------
# the session: measured costs, rebinding, carrying across
# ----------------------------------------------------------------------
def test_ingest_feeds_measured_costs_into_search():
    rng, js, ts = _pair(6, chains=((1, 2),), engine="host")
    assert ts._search_cfg() is ts.cfg.search
    _ingest(js, ts, _random_batch(rng, 32), ts.store.triples[:16])
    assert len(ts.maintenance_costs) >= 1
    assert ts.maintenance_costs.measured == js.maintenance_costs.measured
    assert ts._search_cfg().maint_model is ts.maintenance_costs
    assert ts.maintainer().costs is ts.maintenance_costs


@pytest.mark.parametrize("engine", ENGINES)
def test_retune_apply_after_ingest_rebinds(engine):
    rng, js, ts = _pair(8, chains=((1, 2),), engine=engine)
    _stream(rng, js, ts, steps=2)
    m = ts.maintainer()
    for s in (js, ts):
        s.add_query(_chain_cq(jq if s is js else tq, "q3", 3, 4))
    jrep, trep = js.retune(), ts.retune()
    assert tserde.state_to_json(ts.best) == jserde.state_to_json(js.best)
    assert trep.result.best_quality.total == jrep.result.best_quality.total
    japp, tapp = js.apply(), ts.apply()
    assert (tapp.materialized, tapp.reused, tapp.dropped) == \
        (japp.materialized, japp.reused, japp.dropped)
    # the same maintainer, rebound to the new view set
    assert ts.maintainer() is m and m.executor is ts.executor
    assert set(m._ext_keys) == set(ts.executor.state.views)
    _assert_same_views(js, ts)
    _stream(rng, js, ts, steps=1)
    _assert_final(js, ts)


def test_from_reference_carries_measured_costs():
    rng, js, ts = _pair(10, engine="host")
    _stream(rng, js, ts, steps=2)
    measured = js.maintenance_costs.measured
    pairs = [(jserde.cq_to_json(v.cq), measured[v.cq.canonical_key()])
             for v in js.best.views.values()
             if v.cq.canonical_key() in measured]
    assert pairs
    carried = from_reference(js.store.triples, None,
                             jserde.state_to_json(js.best), js.groups,
                             device="cpu", measured_costs=pairs)
    assert carried.costs.measured == {
        k: v for k, v in measured.items()
        if k in {v.cq.canonical_key() for v in js.best.views.values()}}
    # a cold retune over the carried store, against the carried costs,
    # reaches the JAX session's result under the same costs
    jcold = JSession(js.store, js.workload,
                     cfg=JConfig(search=JSearch(**SEARCH)))
    jcold.maintenance_costs.measured.update(
        {jq_key: u for jq_key, u in carried.costs.measured.items()})
    tcold = TSession(carried.store, ts.workload,
                     cfg=TConfig(search=TSearch(**SEARCH)), device="cpu")
    tcold.maintenance_costs = carried.costs
    jrep, trep = jcold.retune(), tcold.retune()
    assert tserde.state_to_json(tcold.best) == \
        jserde.state_to_json(jcold.best)
    assert trep.result.best_quality.total == jrep.result.best_quality.total
    assert trep.result.explored == jrep.result.explored
