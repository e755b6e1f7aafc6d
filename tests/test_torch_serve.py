"""The port's `QueryServer` against the JAX package's: batched serving,
telemetry, invalidation, streaming under a staleness budget, drift
auto-retune, measured costs, online retunes behind the endpoint, and the
fault-tolerant serving core (degradation ladder, breaker, supervisor,
chaos injection).

Twins of `tests/test_workload_exec.py` (serving), the serve part of
`tests/test_maintenance.py`, the serving tests of `tests/test_session.py`
and `tests/test_chaos.py`: the same store, workload, seeded stream and
fault schedule go through both packages (the port on the CPU,
`device="cpu"`, where its kernels take their plain versions), and the
port's answers, tiers, flags, health and `ServeStats` counters are held
equal to the JAX server's.

The random-schedule property of `tests/test_chaos.py` is twinned over
fixed seeds, not `@given`: the seeds at which the JAX package misses its
own recovery bound, and its deterministic twin's 4242.  Each batch's
record must be equal in both packages; the port is not asked to be
HEALTHY where the JAX server is not.
"""
import sys
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.api as japi  # noqa: E402
import repro.distributed.fault as jfault  # noqa: E402
import repro.errors as jerrors  # noqa: E402
import repro.maintenance as jmaint  # noqa: E402
import repro.rdf.triples as jtriples  # noqa: E402
import repro.serve.chaos as jchaos  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
import repro_torch.distributed.fault as tfault  # noqa: E402
import repro_torch.errors as terrors  # noqa: E402
import repro_torch.maintenance as tmaint  # noqa: E402
import repro_torch.rdf.triples as ttriples  # noqa: E402
import repro_torch.serve.chaos as tchaos  # noqa: E402
from repro.api import SearchConfig as JSearch  # noqa: E402
from repro.api import TuningSession as JSession  # noqa: E402
from repro.api import WizardConfig as JConfig  # noqa: E402
from repro.core import queries as jq  # noqa: E402
from repro.core.executor import QueryExecutor as JExecutor  # noqa: E402
from repro.maintenance import MaintenanceConfig as JMaintConfig  # noqa: E402
from repro.rdf.generator import generate, lubm_workload  # noqa: E402
from repro.rdf.triples import TripleStore as JStore  # noqa: E402
from repro.serve.query_server import QueryServer as JServer  # noqa: E402
from repro_torch.api import MaintenanceConfig as TMaintConfig  # noqa: E402
from repro_torch.api import SearchConfig as TSearch  # noqa: E402
from repro_torch.api import TuningSession as TSession  # noqa: E402
from repro_torch.api import WizardConfig as TConfig  # noqa: E402
from repro_torch.core import queries as tq  # noqa: E402
from repro_torch.core.executor import QueryExecutor as TExecutor  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.rdf import generator as tgen  # noqa: E402
from repro_torch.rdf.triples import TripleStore as TStore  # noqa: E402
from repro_torch.serve.chaos import FaultInjector  # noqa: E402
from repro_torch.serve.query_server import QueryServer as TServer  # noqa: E402

PREDS = [1, 2, 3, 4, 5]
# the state budget, not the clock, ends the search in both packages; at
# this size the tuned state keeps join buckets
SEARCH = dict(strategy="greedy", max_states=400, max_seconds=1e9)
STREAM_STATS = ("requests", "batches", "device_runs", "retunes",
                "updates_submitted", "updates_applied", "refreshes",
                "backlog_batches", "backlog_triples", "max_staleness_served",
                "drift_retunes", "health", "served_tier", "stale_answers",
                "last_batch", "faults")


@pytest.fixture(scope="module")
def unis():
    """The same universe generated by each package from one seed."""
    return generate(n_universities=2, seed=0), \
        tgen.generate(n_universities=2, seed=0)


def _sessions(unis, n=6):
    ju, tu = unis
    js = JSession(ju.store, lubm_workload(ju.dictionary)[:n],
                  schema=ju.schema, type_id=ju.type_id,
                  cfg=JConfig(search=JSearch(**SEARCH)))
    ts = TSession(tu.store, tgen.lubm_workload(tu.dictionary)[:n],
                  schema=tu.schema, type_id=tu.type_id,
                  cfg=TConfig(search=TSearch(**SEARCH)), device="cpu")
    return js, ts


@pytest.fixture(scope="module")
def applied(unis):
    js, ts = _sessions(unis)
    for s in (js, ts):
        s.retune()
        s.apply()
    return js, ts


def _names(ts):
    return [q.name for q in ts.workload]


# ----------------------------------------------------------------------
# batched serving (tests/test_workload_exec.py)
# ----------------------------------------------------------------------
def test_query_server_batched_requests(applied):
    js, ts = applied
    jsrv, tsrv = JServer(js.executor), TServer(ts.executor)
    names = _names(ts)
    batch = names + names[:2] + ["no_such_query"]
    janswers, answers = jsrv.answer_batch(batch), tsrv.answer_batch(batch)
    assert answers == janswers
    for name, ans in zip(batch, answers):
        if name == "no_such_query":
            assert ans is None
        else:
            assert ans == ts.executor.answer_group_direct(name), name
    assert tsrv.stats.requests == len(batch)
    assert tsrv.stats.unknown == 1
    assert tsrv.stats.device_runs >= 1
    runs = tsrv.stats.device_runs
    tsrv.answer_batch(names)              # repeat: served from the cache
    assert tsrv.stats.device_runs == runs
    # invalidate() rebuilds the program (its run count starts at 0) and
    # forces exactly one rerun
    tsrv.invalidate()
    assert ts.executor.workload.runs == 0
    assert tsrv.answer_batch(names) == janswers[:len(names)]
    assert tsrv.stats.device_runs == 1
    tsrv.answer_batch(names)
    assert tsrv.stats.device_runs == 1


def test_bucket_telemetry_reaches_server_stats(applied):
    js, ts = applied
    srv = TServer(ts.executor)
    srv.answer_batch(_names(ts))
    t = ts.executor.telemetry()
    assert t["mode"] == "bucketed"
    assert t["buckets"] >= 1
    assert t["bucket_compiles"] + t["bucket_cache_hits"] >= t["buckets"]
    assert t["compile_cache"]["entries"] >= 1
    s = srv.stats
    assert s.buckets == t["buckets"] == js.executor.telemetry()["buckets"]
    assert s.bucket_compiles == t["bucket_compiles"]
    assert s.bucket_cache_hits == t["bucket_cache_hits"]
    assert s.bucket_cache_misses == t["bucket_compiles"]
    assert s.bucket_compile_seconds == t["bucket_compile_seconds"]
    assert s.compile_cache_entries == t["compile_cache"]["entries"]
    assert set(s.as_dict()) == set(JServer(js.executor).stats.as_dict())


def test_server_invalidate_refreshes_after_maintenance(unis, applied):
    """invalidate(new_store) re-materializes views + re-uploads the TT:
    answers reflect the maintained store, not stale device snapshots."""
    (ju, tu), (js, ts) = unis, applied
    jsrv = JServer(JExecutor(ju.store, js.best, js.groups))
    tsrv = TServer(TExecutor(tu.store, ts.best, ts.groups, device="cpu"))
    name = "q1"
    assert tsrv.answer(name) == tsrv.executor.answer_group_direct(name)
    t = tu.store.triples
    cut = int(len(t) * 0.7)
    jsrv.invalidate(JStore(ju.store.triples[:cut], ju.dictionary))
    tsrv.invalidate(TStore(t[:cut], tu.dictionary))
    after = tsrv.answer(name)
    assert after == tsrv.executor.answer_group_direct(name)
    assert after == jsrv.answer(name)


def test_per_query_tier_probes_through_the_kernel_wrapper(unis,
                                                         monkeypatch):
    """Tier 1 runs each member's operator tree alone; its join probes go
    through `ops.join_count` as the fused program's do."""
    _, ts = _sessions(unis)
    ts.retune()
    ts.apply()
    assert [b for b in ts.executor.workload._prog.buckets
            if b.kind == "join"]
    calls = [0]
    real = tops.join_count

    def counting(probe, build):
        calls[0] += 1
        return real(probe, build)

    monkeypatch.setattr(tops, "join_count", counting)
    chaos = FaultInjector()
    srv = TServer(ts.executor, chaos=chaos)
    srv.invalidate()                     # drop the cached results
    chaos.arm("device_call", count=2)   # defeats both fused attempts
    names = _names(ts)
    got = srv.answer_batch(names)
    assert srv.stats.served_tier == 1 and srv.stats.health == "DEGRADED"
    assert calls[0] > 0
    for name, ans in zip(names, got):
        assert ans == ts.executor.answer_group_direct(name), name


def _port_session(unis, stream: bool):
    """A port session on the CPU, applied: the LUBM workload (join
    buckets, so the probes run), or for streaming a chain query over a
    random store whose inserts reach its view through `scatter_append`."""
    if not stream:
        _, ts = _sessions(unis)
    else:
        rng = np.random.default_rng(5)
        ts = TSession(TStore(_random_store(rng)),
                      workload=[_chain_cq(tq, "q1", 1, 2)], device="cpu")
    ts.retune()
    ts.apply()
    return ts


@pytest.mark.parametrize("where", ["fused", "per_query", "maintenance"])
def test_kernel_failure_surfaces_instead_of_degrading(unis, monkeypatch,
                                                      where):
    """A kernel that fails to launch is never hidden by a lower tier: the
    batch raises `KernelError` (the error the launch check raises), the
    server goes DOWN, the host reference engine never answers, and the
    next batch after the kernel recovers serves tier 0 exactly."""
    from repro_torch.kernels._build import KernelError, check_launch

    ts = _port_session(unis, stream=where == "maintenance")
    chaos = FaultInjector()
    # the device insert engine, the card's: on the CPU "auto" picks host
    srv = ts.serve(maintenance=TMaintConfig(staleness_budget=0,
                                            insert_engine="device")
                   if where == "maintenance" else None, chaos=chaos)
    ex = srv.executor
    names = _names(ts)
    srv.answer_batch(names)
    ex.note_maintenance(ex.store)        # drop the cached results
    direct_calls = [0]
    real_direct = ex.answer_group_direct

    def direct(name):
        direct_calls[0] += 1
        return real_direct(name)

    monkeypatch.setattr(ex, "answer_group_direct", direct)
    kernel = "scatter_append" if where == "maintenance" else "join_count"
    real_kernel = getattr(tops, kernel)

    def failed_launch(*args):
        check_launch(kernel, 700)        # cudaErrorIllegalAddress

    monkeypatch.setattr(tops, kernel, failed_launch)
    if where == "per_query":
        chaos.arm("device_call", count=2)   # tier 0 fails by injection
    if where == "maintenance":
        srv.submit(inserts=_random_batch(np.random.default_rng(6), 32))
    with pytest.raises(KernelError, match=f"{kernel} launch failed"):
        srv.answer_batch(names)
    assert direct_calls[0] == 0
    assert srv.stats.health == "DOWN" and not srv.readiness()["ready"]
    assert srv.stats.served_tier == -1
    assert srv.stats.ref_engine_failures == 0
    assert srv.stats.faults[-1].startswith(f"device: {kernel} launch failed")
    if where == "maintenance":
        assert srv.stream.pending_triples == 32     # the delta requeued
        assert srv.stats.maintenance_failures == 0
    monkeypatch.setattr(tops, kernel, real_kernel)
    got = srv.answer_batch(names)
    assert srv.stats.last_batch["tier"] == 0 and srv.stats.health == "HEALTHY"
    assert direct_calls[0] == 0
    for name, ans in zip(names, got):
        assert ans == real_direct(name), name


@pytest.mark.parametrize("where", ["fused", "per_query", "maintenance",
                                   "integrity"])
def test_device_fault_at_readback_takes_server_down(unis, monkeypatch,
                                                    where):
    """A fault the card reports after a launch that went through — an
    illegal address, raised as PyTorch raises it at a later call or
    read-back, not by the launch check — is not absorbed either.  It
    surfaces at the workload's read-back (tier 0, and tier 1 after
    injected tier-0 failures), inside a maintenance pass after its
    append, or at the integrity probe that follows a pass; each takes the
    server DOWN and re-raises, and the host reference engine never
    answers.  The fault is sticky, as on the card, until cleared."""
    stream = where in ("maintenance", "integrity")
    ts = _port_session(unis, stream=stream)
    chaos = FaultInjector()
    srv = ts.serve(maintenance=TMaintConfig(staleness_budget=0,
                                            insert_engine="device")
                   if stream else None, chaos=chaos)
    ex = srv.executor
    names = _names(ts)
    srv.answer_batch(names)
    ex.note_maintenance(ex.store)        # drop the cached results
    direct_calls = [0]
    real_direct = ex.answer_group_direct

    def direct(name):
        direct_calls[0] += 1
        return real_direct(name)

    monkeypatch.setattr(ex, "answer_group_direct", direct)
    kernel = "scatter_append" if stream else "join_count"
    real_kernel = getattr(tops, kernel)
    fault = {"armed": True, "on": False, "site": None}

    def illegal_address(site):
        fault["site"] = fault["site"] or site
        return getattr(torch, "AcceleratorError", RuntimeError)(
            "CUDA error: an illegal memory access was encountered")

    def launched(*args, **kwargs):
        out = real_kernel(*args, **kwargs)   # the launch itself succeeds
        if fault["armed"]:
            fault["armed"], fault["on"] = False, True
        return out

    real_cpu = torch.Tensor.cpu

    def read_back(self, *args, **kwargs):
        if fault["on"]:
            raise illegal_address(sys._getframe(1).f_code.co_name)
        return real_cpu(self, *args, **kwargs)

    monkeypatch.setattr(tops, kernel, launched)
    monkeypatch.setattr(torch.Tensor, "cpu", read_back)
    if where == "per_query":
        chaos.arm("device_call", count=2)   # tier 0 fails by injection
    if where == "maintenance":
        # the pass's next call into the card after its append
        real_observe = srv.maintainer._observe_costs

        def observe(report):
            if fault["on"]:
                raise illegal_address("maintainer.apply")
            return real_observe(report)

        monkeypatch.setattr(srv.maintainer, "_observe_costs", observe)
    if stream:
        srv.submit(inserts=_random_batch(np.random.default_rng(6), 32))
    with pytest.raises(RuntimeError, match="illegal memory access"):
        srv.answer_batch(names)
    assert not fault["armed"] and fault["site"] is not None
    assert direct_calls[0] == 0
    assert srv.stats.health == "DOWN" and not srv.readiness()["ready"]
    assert srv.stats.served_tier == -1
    assert srv.stats.ref_engine_failures == 0
    assert srv.stats.per_query_failures == 0
    assert srv.stats.maintenance_failures == 0
    assert srv.stats.faults[-1].startswith("device: CUDA error")
    if where == "fused":
        assert srv.stats.fused_failures == 0
    if where == "maintenance":
        assert fault["site"] == "maintainer.apply"
        assert srv.stream.pending_triples == 32     # the delta requeued
    if where == "integrity":
        assert fault["site"] == "_integrity_ok"
        assert srv.stream.pending_triples == 0      # the pass completed
    fault["on"] = False                             # the card recovers
    got = srv.answer_batch(names)
    assert srv.stats.last_batch["tier"] == 0 and srv.stats.health == "HEALTHY"
    assert direct_calls[0] == 0
    for name, ans in zip(names, got):
        assert ans == real_direct(name), name


# ----------------------------------------------------------------------
# streaming serving (tests/test_maintenance.py)
# ----------------------------------------------------------------------
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


def _pair(seed, chains=((1, 2),)):
    """The same random store and chain workload in both packages,
    retuned and applied; returns (jax session, port session, rng)."""
    rng = np.random.default_rng(seed)
    tt = _random_store(rng)
    out = []
    for Session, Store, Q, kw in ((JSession, JStore, jq, {}),
                                  (TSession, TStore, tq, {"device": "cpu"})):
        s = Session(Store(tt.copy()),
                    workload=[_chain_cq(Q, f"q{i + 1}", a, b)
                              for i, (a, b) in enumerate(chains)], **kw)
        s.retune()
        s.apply()
        out.append(s)
    return out[0], out[1], rng


def _stream_stats(srv) -> dict:
    d = srv.stats.as_dict()
    return {k: d[k] for k in STREAM_STATS}


def test_staleness_budget_bounds_served_lag():
    js, ts, rng = _pair(3)
    budget = 40
    jsrv = js.serve(maintenance=JMaintConfig(staleness_budget=budget))
    srv = ts.serve(maintenance=TMaintConfig(staleness_budget=budget))
    for _ in range(6):
        b = _random_batch(rng, 16)
        for s in (jsrv, srv):
            s.submit(inserts=b)
        assert srv.answer("q1") == jsrv.answer("q1")
        assert srv.stream.pending_triples <= budget
        assert _stream_stats(srv) == _stream_stats(jsrv)
    assert srv.stats.max_staleness_served <= budget
    assert srv.stats.refreshes >= 1  # the budget forced maintenance
    srv.flush()
    jsrv.flush()
    assert srv.stream.pending_triples == 0
    assert srv.answer("q1") == ts.executor.answer_group_direct("q1") \
        == jsrv.answer("q1")
    assert _stream_stats(srv) == _stream_stats(jsrv)


def test_zero_budget_serves_fresh():
    js, ts, rng = _pair(4)
    jsrv, srv = js.serve(maintenance=True), ts.serve(maintenance=True)
    for _ in range(2):
        b = _random_batch(rng, 8)
        jsrv.submit(inserts=b)
        srv.submit(inserts=b)
    assert srv.answer("q1") == jsrv.answer("q1") == \
        ts.executor.answer_group_direct("q1")
    assert srv.stats.max_staleness_served == 0
    assert srv.stats.backlog_triples == 0
    assert _stream_stats(srv) == _stream_stats(jsrv)


def test_drift_triggers_auto_retune():
    js, ts, rng = _pair(5, chains=((1, 2), (2, 3)))
    cfg = dict(staleness_budget=0, drift_window=3, drift_rate_factor=2.0,
               drift_min_triples=32)
    jsrv = js.serve(maintenance=JMaintConfig(**cfg))
    srv = ts.serve(maintenance=TMaintConfig(**cfg))
    batches = [_random_batch(rng, 4) for _ in range(4)]   # baseline rate
    for _ in range(6):                   # drift: 40x the rate, one predicate
        b = _random_batch(rng, 160)
        b[:, 1] = 5
        batches.append(b)
    for b in batches:
        for s in (jsrv, srv):
            s.submit(inserts=b)
        assert srv.answer("q1") == jsrv.answer("q1")
    assert srv.stats.drift_retunes >= 1
    assert _stream_stats(srv) == _stream_stats(jsrv)
    assert srv.answer("q2") == ts.executor.answer_group_direct("q2")
    assert ts.best.key() == js.best.key()


def test_auto_retune_off_leaves_drift_unacted():
    js, ts, rng = _pair(5, chains=((1, 2), (2, 3)))
    srv = ts.serve(maintenance=TMaintConfig(
        staleness_budget=0, drift_window=3, drift_rate_factor=2.0,
        drift_min_triples=32, auto_retune=False))
    for n in (4, 4, 4, 4, 160, 160, 160, 160):
        b = _random_batch(rng, n)
        b[:, 1] = 5 if n > 4 else b[:, 1]
        srv.submit(inserts=b)
        srv.answer("q1")
    assert srv.stats.drift_retunes == 0 and srv.stats.retunes == 0
    assert srv.answer("q2") == ts.executor.answer_group_direct("q2")
    with pytest.raises(ValueError, match="staleness_budget"):
        TMaintConfig(staleness_budget=-1)


def test_measured_costs_flow_into_retune_objective():
    from repro_torch.core.quality import (MaintenanceCostModel,
                                          QualityWeights, quality)

    js, ts, rng = _pair(6)
    ins = _random_batch(rng, 32)
    for s in (js, ts):
        s.ingest(inserts=ins, deletes=s.store.triples[:16])
    assert len(ts.maintenance_costs) >= 1
    assert ts.maintenance_costs.measured == js.maintenance_costs.measured
    assert ts._search_cfg().maint_model is ts.maintenance_costs
    stats = ts.store.stats
    state = ts.best
    base = quality(state, stats, QualityWeights())
    loaded = MaintenanceCostModel()
    for v in state.views.values():
        loaded.observe(v.cq, 1e4)
    heavy = quality(state, stats, QualityWeights(), loaded)
    assert heavy.total != base.total


def test_rebind_survives_retune_hot_swap():
    js, ts, rng = _pair(8)
    jsrv, srv = js.serve(maintenance=True), ts.serve(maintenance=True)
    b1, b2 = _random_batch(rng, 16), _random_batch(rng, 16)
    for s, Q in ((jsrv, jq), (srv, tq)):
        s.submit(inserts=b1)
        s.answer("q1")
        s.retune_online(add=[_chain_cq(Q, "q3", 3, 4)])
        s.submit(inserts=b2)
    assert srv.answer("q3") == ts.executor.answer_group_direct("q3") \
        == jsrv.answer("q3")
    for vid in ts.executor.state.views:
        srv.maintainer.check_alignment(vid)
    assert _stream_stats(srv) == _stream_stats(jsrv)


# ----------------------------------------------------------------------
# online serving through the session (tests/test_session.py)
# ----------------------------------------------------------------------
def test_serve_retunes_online_behind_batched_endpoint(unis):
    js, ts = _sessions(unis, n=5)
    jsrv, srv = js.serve(), ts.serve()
    ex = srv.executor
    names = _names(ts)
    assert srv.answer_batch(names) == jsrv.answer_batch(names)
    for name, ans in zip(names, srv.answer_batch(names)):
        assert ans == ex.answer_group_direct(name), name
    q6 = tgen.lubm_workload(unis[1].dictionary)[5]
    out = srv.retune_online(add=[q6])
    jsrv.retune_online(add=[lubm_workload(unis[0].dictionary)[5]])
    assert out["retune"].warm and not out["apply"].full
    assert srv.executor is ex  # hot swap: same executor object serves on
    assert srv.stats.retunes == 1
    answers = srv.answer_batch(names + ["q6"])
    assert answers == jsrv.answer_batch(names + ["q6"])
    assert answers[-1] == ex.answer_group_direct("q6")
    srv.retune_online(remove=["q1"])
    assert srv.answer("q1") is None  # unknown now
    assert srv.answer("q6") == ex.answer_group_direct("q6")


def test_retune_online_validates_before_mutating(unis):
    _, ts = _sessions(unis, n=3)
    wl = tgen.lubm_workload(unis[1].dictionary)
    srv = ts.serve()
    with pytest.raises(ValueError, match="duplicate"):
        srv.retune_online(remove=["q1"], add=[wl[1]])
    assert {q.name for q in ts.workload} == {"q1", "q2", "q3"}
    with pytest.raises(KeyError):
        srv.retune_online(remove=["never_there"])
    assert srv.stats.retunes == 0
    srv.retune_online(remove=["q1"], add=[wl[0]])
    assert srv.stats.retunes == 1


def test_invalidate_keeps_session_on_serving_store(unis):
    _, ts = _sessions(unis, n=3)
    tu = unis[1]
    srv = ts.serve()
    t = tu.store.triples
    smaller = TStore(t[: int(len(t) * 0.8)], tu.dictionary)
    srv.invalidate(smaller)
    assert ts.store is smaller  # retune stats + save() follow the server
    srv.retune_online(add=[tgen.lubm_workload(tu.dictionary)[3]])
    for name in ("q1", "q2", "q3", "q4"):
        assert srv.answer(name) == srv.executor.answer_group_direct(name)


def test_from_tuned_honors_subclass(unis):
    tu = unis[1]

    class SubServer(TServer):
        pass

    srv = SubServer.from_tuned(tu.store, tgen.lubm_workload(tu.dictionary)[:2],
                               tu.schema, tu.type_id,
                               TConfig(search=TSearch(**SEARCH)),
                               device="cpu")
    assert isinstance(srv, SubServer)
    assert srv.session is not None and srv.executor.device.type == "cpu"
    assert srv.answer("q1") == srv.executor.answer_group_direct("q1")


# ======================================================================
# the fault-tolerant serving core (tests/test_chaos.py)
# ======================================================================
def _pkg(api, q, fault, errors, maint, triples, chaos, **session_kw):
    return SimpleNamespace(
        Session=api.TuningSession, MaintenanceConfig=maint.MaintenanceConfig,
        ViewMaintainer=maint.ViewMaintainer, Delta=maint.Delta,
        Store=triples.TripleStore, Q=q, RetryPolicy=fault.RetryPolicy,
        CircuitBreaker=fault.CircuitBreaker,
        ServingSupervisor=fault.ServingSupervisor,
        ServiceUnavailable=errors.ServiceUnavailable,
        FaultInjector=chaos.FaultInjector, FaultSpec=chaos.FaultSpec,
        InjectedFault=chaos.InjectedFault, session_kw=session_kw)


JAX = _pkg(japi, jq, jfault, jerrors, jmaint, jtriples, jchaos)
PORT = _pkg(tapi, tq, tfault, terrors, tmaint, ttriples, tchaos,
            device="cpu")

# ServeStats fields both packages must agree on after every scenario
STATS = ("requests", "batches", "unknown", "device_runs", "compiles",
         "recompiles", "retunes", "updates_submitted", "updates_applied",
         "refreshes", "backlog_batches", "backlog_triples",
         "max_staleness_served", "drift_retunes", "health", "served_tier",
         "degraded_answers", "stale_answers", "fused_failures",
         "per_query_failures", "ref_engine_failures", "maintenance_failures",
         "integrity_failures", "repairs", "retune_failures",
         "retune_rollbacks", "breaker_state", "breaker_opens", "last_batch",
         "faults")
# the seeds at which tests/test_chaos.py's random-schedule property misses
# the JAX package's recovery bound (ROADMAP, faults of the JAX package)
JAX_FAILING_SEEDS = (492817, 743334, 440183, 615798, 191708, 996289, 114344,
                     475100, 981728, 644353, 187798, 737198)


def _session(P, store, workload):
    s = P.Session(store, workload=workload, **P.session_kw)
    s.retune()
    s.apply()
    return s


def _streaming_server(P, rng, queries=(("q1", 1, 2),), chaos=None,
                      policy=None, cfg=None):
    sess = _session(P, P.Store(_random_store(rng)),
                    [_chain_cq(P.Q, n, a, b) for n, a, b in queries])
    srv = sess.serve(maintenance=cfg or P.MaintenanceConfig(), chaos=chaos,
                     policy=policy)
    return sess, srv


def _oracle(srv, name):
    return srv.executor.answer_group_direct(name)


def _stats(srv) -> dict:
    d = srv.stats.as_dict()
    return {k: d[k] for k in STATS}


def _both(scenario):
    """Run `scenario(P)` in both packages; the port's stats must equal
    the JAX server's.  Returns the port's server and scenario result."""
    jsrv, _ = scenario(JAX)
    tsrv, out = scenario(PORT)
    assert _stats(tsrv) == _stats(jsrv)
    return tsrv, out


# ----------------------------------------------------------------------
# primitives: breaker, supervisor, injector
# ----------------------------------------------------------------------
def test_circuit_breaker_opens_probes_and_backs_off():
    traces = []
    for P in (JAX, PORT):
        b = P.CircuitBreaker(P.RetryPolicy(failure_threshold=2,
                                           cooldown_batches=2,
                                           backoff_factor=2.0,
                                           max_cooldown=4))
        trace = [b.allow(), b.state]
        for step in ("f", "f", "a", "a", "f", "a", "a", "a", "a", "s", "a"):
            if step == "f":
                b.record_failure()
            elif step == "s":
                b.record_success()
            else:
                trace.append(b.allow())
            trace += [b.state, b.opens]
        traces.append(trace)
    assert traces[1] == traces[0]
    assert traces[1] == [True, "closed", "closed", 0, "open", 1, False,
                         "open", 1, True, "half_open", 1, "open", 2, False,
                         "open", 2, False, "open", 2, False, "open", 2, True,
                         "half_open", 2, "closed", 2, True, "closed", 2]


def test_supervisor_health_transitions_logged_and_bounded():
    logs = []
    for P in (JAX, PORT):
        sup = P.ServingSupervisor()
        seen = []
        for tier, stale, degraded in ((0, False, False), (1, False, False),
                                      (0, False, True), (3, True, False),
                                      (None, False, False),
                                      (0, False, False)):
            sup.begin_batch()
            seen.append((sup.observe(tier, stale=stale, degraded=degraded),
                         sup.ready()))
        for _ in range(3 * sup.MAX_TRANSITIONS):
            sup.observe(1, stale=False)
            sup.observe(0, stale=False)
        assert len(sup.transitions) <= sup.MAX_TRANSITIONS
        logs.append((seen, [(t.batch, t.previous, t.health, t.reason)
                            for t in sup.transitions]))
    assert logs[1] == logs[0]
    assert [h for h, _ in logs[1][0]] == ["HEALTHY", "DEGRADED", "DEGRADED",
                                          "STALE_ONLY", "DOWN", "HEALTHY"]


def test_fault_injector_schedule_and_autoclear():
    chaos = tchaos.FaultInjector()
    chaos.arm("device_call", after=1, count=2)
    chaos.fire("device_call")  # clean (after=1)
    with pytest.raises(tchaos.InjectedFault):
        chaos.fire("device_call")
    with pytest.raises(tchaos.InjectedFault):
        chaos.fire("device_call")
    chaos.fire("device_call")  # exhausted: auto-cleared
    assert not chaos.armed("device_call") and chaos.injected == 2
    assert chaos.log == [("device_call", 2), ("device_call", 3)]
    with pytest.raises(ValueError):
        tchaos.FaultSpec(site="nonsense")
    assert tchaos.SITES == jchaos.SITES


def test_bucket_cache_misses_wired_from_real_key():
    def scenario(P):
        rng = np.random.default_rng(0)
        sess = _session(P, P.Store(_random_store(rng)),
                        [_chain_cq(P.Q, "q1", 1, 2)])
        srv = sess.serve()
        srv.answer("q1")
        t = sess.executor.telemetry()
        assert "bucket_cache_misses" in t
        assert srv.stats.bucket_cache_misses == t["bucket_cache_misses"]
        return srv, None

    _both(scenario)


# ----------------------------------------------------------------------
# ladder: one fault class at a time
# ----------------------------------------------------------------------
def test_single_device_fault_masked_by_in_batch_retry():
    def scenario(P):
        rng = np.random.default_rng(1)
        chaos = P.FaultInjector()
        sess, srv = _streaming_server(P, rng, chaos=chaos)
        srv.submit(inserts=_random_batch(rng, 8))
        chaos.arm("device_call", count=1)  # one failure < max_attempts
        got = srv.answer("q1")
        assert got == _oracle(srv, "q1")
        assert srv.stats.health == "HEALTHY"
        assert srv.stats.last_batch == {"tier": 0, "degraded": False,
                                        "stale": False}
        assert chaos.injected == 1  # the fault really fired
        return srv, got

    _both(scenario)


def test_device_fault_degrades_to_per_query_then_recovers():
    def scenario(P):
        rng = np.random.default_rng(2)
        chaos = P.FaultInjector()
        sess, srv = _streaming_server(P, rng, chaos=chaos)
        srv.submit(inserts=_random_batch(rng, 8))
        chaos.arm("device_call", count=2)  # defeats both in-batch attempts
        got = srv.answer("q1")
        assert got == _oracle(srv, "q1")  # tier 1 is exact
        assert srv.stats.served_tier == 1
        assert srv.stats.health == "DEGRADED"
        assert srv.stats.fused_failures == 1
        assert srv.stats.breaker_opens == 1
        assert srv.readiness()["ready"]
        srv.submit(inserts=_random_batch(rng, 8))
        got = srv.answer("q1")
        assert got == _oracle(srv, "q1")
        assert srv.stats.served_tier == 0 and srv.stats.health == "HEALTHY"
        assert srv.stats.breaker_state == "closed"
        return srv, got

    _both(scenario)


def test_timeout_fault_counts_as_failure():
    def scenario(P):
        rng = np.random.default_rng(3)
        chaos = P.FaultInjector()
        sess, srv = _streaming_server(P, rng, chaos=chaos)
        srv.submit(inserts=_random_batch(rng, 8))
        chaos.arm("device_call", count=2, kind="timeout")
        assert srv.answer("q1") == _oracle(srv, "q1")
        assert srv.stats.health == "DEGRADED" and srv.stats.served_tier == 1
        return srv, None

    _both(scenario)


def test_capacity_overflow_storm_degrades_and_recovers():
    def scenario(P):
        rng = np.random.default_rng(4)
        chaos = P.FaultInjector()
        sess, srv = _streaming_server(P, rng, chaos=chaos)
        srv.submit(inserts=_random_batch(rng, 8))
        chaos.arm("capacity_overflow", count=2)
        assert srv.answer("q1") == _oracle(srv, "q1")
        assert srv.stats.health == "DEGRADED"
        srv.submit(inserts=_random_batch(rng, 8))
        assert srv.answer("q1") == _oracle(srv, "q1")
        assert srv.stats.health == "HEALTHY"
        return srv, None

    _both(scenario)


def test_compile_fault_on_hot_swapped_program():
    def scenario(P):
        rng = np.random.default_rng(5)
        chaos = P.FaultInjector()
        sess, srv = _streaming_server(P, rng, chaos=chaos)
        assert srv.answer("q1") == _oracle(srv, "q1")
        srv.invalidate()             # fresh program: next run must compile
        chaos.arm("compile", count=2)
        assert srv.answer("q1") == _oracle(srv, "q1")
        assert srv.stats.served_tier == 1 and srv.stats.health == "DEGRADED"
        assert srv.answer("q1") == _oracle(srv, "q1")
        assert srv.stats.health == "HEALTHY"
        return srv, None

    _both(scenario)


def test_maintenance_fault_requeues_delta_and_serves_stale():
    def scenario(P):
        rng = np.random.default_rng(6)
        chaos = P.FaultInjector()
        sess, srv = _streaming_server(P, rng, chaos=chaos)
        pre = srv.answer("q1")                  # healthy baseline
        delta = _random_batch(rng, 16)
        srv.submit(inserts=delta)
        chaos.arm("maintenance_apply", count=1)
        got = srv.answer("q1")
        assert got == pre == _oracle(srv, "q1")
        assert srv.stats.maintenance_failures == 1
        assert srv.stats.last_batch["stale"] is True
        assert srv.stats.health == "DEGRADED"
        assert srv.stream.pending_triples == len(delta)  # requeued, not lost
        got = srv.answer("q1")
        assert srv.stream.pending_triples == 0
        assert got == _oracle(srv, "q1")
        assert srv.stats.health == "HEALTHY"
        assert srv.stats.last_batch["stale"] is False
        return srv, got

    _both(scenario)


def test_mid_pass_maintenance_failure_rolls_back_executor():
    def scenario(P):
        rng = np.random.default_rng(7)
        sess = _session(P, P.Store(_random_store(rng)),
                        [_chain_cq(P.Q, "q1", 1, 2)])
        m = P.ViewMaintainer(sess.executor, P.MaintenanceConfig())
        before = {vid: rel.rows.copy()
                  for vid, rel in sess.executor.extents.items()}
        store_before = sess.executor.store

        class Boom(RuntimeError):
            pass

        def explode(*a, **k):
            raise Boom("mid-pass device failure")

        m._insert_pass = explode    # fail AFTER the delete pass + TT upload
        with pytest.raises(Boom):
            m.apply(P.Delta.of(_random_batch(rng, 16), None))
        assert sess.executor.store is store_before  # bindings rolled back
        for vid, rows in before.items():
            np.testing.assert_array_equal(sess.executor.extents[vid].rows,
                                          rows)
        got = sess.answer("q1")
        assert got == sess.executor.answer_group_direct("q1")
        return sess, got

    _, jgot = scenario(JAX)
    _, tgot = scenario(PORT)
    assert tgot == jgot


def test_corrupted_extent_detected_repaired_never_served():
    def scenario(P):
        rng = np.random.default_rng(8)
        chaos = P.FaultInjector()
        sess, srv = _streaming_server(P, rng, chaos=chaos)
        assert srv.answer("q1") == _oracle(srv, "q1")
        vid = chaos.corrupt_extent(srv.executor)
        assert len(srv.executor.extents[vid].rows) != \
            int(srv.executor.device_views[vid].n)
        assert not srv._integrity_ok()
        got = srv.answer("q1")
        assert got == _oracle(srv, "q1")   # repaired BEFORE serving: exact
        assert srv.stats.integrity_failures == 1
        assert srv.stats.repairs == 1
        assert srv.stats.health == "DEGRADED"  # repair marks the batch
        assert srv._integrity_ok()
        assert srv.answer("q1") == _oracle(srv, "q1")
        assert srv.stats.health == "HEALTHY"
        return srv, vid

    _both(scenario)


def test_integrity_probe_reads_every_count_in_one_transfer(monkeypatch):
    """The port's probe stacks the device counts and copies them to the
    host once, whatever the number of views."""
    rng = np.random.default_rng(8)
    sess, srv = _streaming_server(PORT, rng, queries=(("q1", 1, 2),
                                                      ("q2", 2, 3),
                                                      ("q3", 3, 4)))
    views = srv.executor.device_views
    assert len(views) >= 2
    copies = []
    real = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda t, *a, **k: copies.append(t.shape)
                        or real(t, *a, **k))
    assert srv._integrity_ok()
    assert copies == [torch.Size([len(views)])]


# ----------------------------------------------------------------------
# transactional retunes
# ----------------------------------------------------------------------
def test_retune_online_rolls_back_on_retune_failure():
    def scenario(P):
        rng = np.random.default_rng(9)
        chaos = P.FaultInjector()
        sess, srv = _streaming_server(P, rng, chaos=chaos)
        baseline = srv.answer("q1")
        names_before = {q.name for q in sess.workload}
        best_before = sess.best
        chaos.arm("retune", count=1)
        with pytest.raises(P.InjectedFault):
            srv.retune_online(add=[_chain_cq(P.Q, "q9", 2, 3)])
        assert {q.name for q in sess.workload} == names_before
        assert sess.best is best_before
        assert srv.stats.retune_rollbacks == 1 and srv.stats.retunes == 0
        assert srv.answer("q1") == baseline == _oracle(srv, "q1")
        assert "q9" not in srv.executor.groups
        return srv, baseline

    _both(scenario)


def test_retune_online_rolls_back_on_apply_failure():
    def scenario(P):
        rng = np.random.default_rng(10)
        chaos = P.FaultInjector()
        sess, srv = _streaming_server(P, rng, chaos=chaos)
        srv.answer("q1")
        best_before = sess.best
        chaos.arm("apply", count=1)   # retune succeeds, the hot swap dies
        with pytest.raises(P.InjectedFault):
            srv.retune_online(add=[_chain_cq(P.Q, "q9", 2, 3)])
        assert sess.best is best_before   # retune result rolled back too
        assert "q9" not in {q.name for q in sess.workload}
        assert srv.answer("q1") == _oracle(srv, "q1")  # old program serves
        srv.retune_online(add=[_chain_cq(P.Q, "q9", 2, 3)])
        assert srv.stats.retunes == 1
        got = srv.answer("q9")
        assert got == _oracle(srv, "q9")
        return srv, got

    _both(scenario)


def test_drift_retune_failure_never_takes_serving_down():
    def scenario(P):
        rng = np.random.default_rng(11)
        chaos = P.FaultInjector()
        sess = _session(P, P.Store(_random_store(rng)),
                        [_chain_cq(P.Q, "q1", 1, 2),
                         _chain_cq(P.Q, "q2", 2, 3)])
        srv = sess.serve(maintenance=P.MaintenanceConfig(
            staleness_budget=0, drift_window=3, drift_rate_factor=2.0,
            drift_min_triples=32), chaos=chaos)
        for _ in range(4):
            srv.submit(inserts=_random_batch(rng, 4))
            srv.answer("q1")
        chaos.arm("retune", count=None)  # sticky: every drift retune dies
        for _ in range(6):
            b = _random_batch(rng, 160)
            b[:, 1] = 5
            srv.submit(inserts=b)
            assert srv.answer("q1") == _oracle(srv, "q1")
        assert srv.stats.retune_failures >= 1
        assert srv.stats.drift_retunes == 0
        chaos.clear()
        got = srv.answer("q2")
        assert got == _oracle(srv, "q2")
        assert srv.stats.health == "HEALTHY"
        return srv, got

    _both(scenario)


# ----------------------------------------------------------------------
# deep ladder: last-known-good and DOWN
# ----------------------------------------------------------------------
def _arm_all_exact_tiers(chaos):
    chaos.arm("device_call", count=None)
    chaos.arm("per_query_call", count=None)
    chaos.arm("ref_engine_call", count=None)


def test_last_known_good_serves_stale_when_all_tiers_fail():
    def scenario(P):
        rng = np.random.default_rng(12)
        chaos = P.FaultInjector()
        sess, srv = _streaming_server(P, rng, chaos=chaos)
        lkg = srv.answer("q1")
        _arm_all_exact_tiers(chaos)
        srv.submit(inserts=_random_batch(rng, 16))
        got = srv.answer("q1")
        assert got == lkg
        assert srv.stats.served_tier == 3
        assert srv.stats.health == "STALE_ONLY"
        assert srv.stats.last_batch["stale"] is True
        assert srv.readiness()["ready"]
        chaos.clear()
        got = srv.answer("q1")
        assert got == _oracle(srv, "q1")
        assert srv.stats.health == "HEALTHY"
        return srv, srv.readiness()

    _both(scenario)


def test_service_unavailable_when_no_tier_and_no_lkg():
    def scenario(P):
        rng = np.random.default_rng(13)
        chaos = P.FaultInjector()
        sess, srv = _streaming_server(P, rng, chaos=chaos)
        srv.invalidate()
        _arm_all_exact_tiers(chaos)
        with pytest.raises(P.ServiceUnavailable):
            srv.answer("q1")
        assert srv.stats.health == "DOWN"
        assert not srv.readiness()["ready"]
        chaos.clear()
        assert srv.answer("q1") == _oracle(srv, "q1")
        assert srv.stats.health == "HEALTHY" and srv.readiness()["ready"]
        return srv, None

    _both(scenario)


# ----------------------------------------------------------------------
# random fault schedules: the port's record equals the JAX server's
# ----------------------------------------------------------------------
def _chaos_record(P, seed, steps=6):
    """`_chaos_invariant_stream` of tests/test_chaos.py, recording each
    batch's tier, degraded / stale flags, health and answers instead of
    asserting the recovery bound.  The no-silently-wrong-answers
    invariant is asserted on every batch.  Returns (record, server)."""
    rng = np.random.default_rng(seed)
    chaos = P.FaultInjector()
    sess, srv = _streaming_server(P, rng, queries=(("q1", 1, 2),
                                                   ("q2", 2, 3)),
                                  chaos=chaos)
    record = []

    def batch(site=None):
        try:
            out = srv.answer_batch(["q1", "q2"])
        except P.ServiceUnavailable:
            assert srv.stats.health == "DOWN"
            record.append(("unavailable", srv.stats.health))
            return
        last = srv.stats.last_batch
        record.append((last["tier"], last["degraded"], last["stale"],
                       srv.stats.health, [sorted(a) for a in out]))
        for name, got in zip(["q1", "q2"], out):
            if not (last["degraded"] or last["stale"]):
                assert got == srv.executor.answer_group_direct(name), \
                    f"silently wrong answer for {name} under {site}"
        if srv.stats.health == "HEALTHY":
            assert not last["degraded"] and not last["stale"]

    batch()  # healthy start: LKG populated
    sites = ["device_call", "capacity_overflow", "compile",
             "maintenance_apply", "per_query_call", "ref_engine_call"]
    for _ in range(steps):
        site = sites[int(rng.integers(0, len(sites)))]
        chaos.arm(site, count=int(rng.integers(1, 4)))
        if int(rng.integers(0, 2)):
            chaos.arm(sites[int(rng.integers(0, len(sites)))],
                      count=int(rng.integers(1, 3)))
        srv.submit(inserts=_random_batch(rng, int(rng.integers(4, 24))))
        batch(site)
        chaos.clear()
    for _ in range(3):  # recovery: no faults armed
        batch()
    return record, srv


@pytest.mark.parametrize("seed", JAX_FAILING_SEEDS)
def test_chaos_known_seed_records_equal_jax(seed):
    """The seeds at which the JAX package misses its own recovery bound
    (`test_chaos_property_random_fault_schedules`, steps=4): the port
    goes through the same batches, so its record (final health
    included) equals the JAX server's, whatever that health is."""
    jrec, jsrv = _chaos_record(JAX, seed, steps=4)
    trec, tsrv = _chaos_record(PORT, seed, steps=4)
    assert trec == jrec
    assert _stats(tsrv) == _stats(jsrv)


def test_chaos_deterministic_twin():
    jrec, jsrv = _chaos_record(JAX, 4242)
    trec, tsrv = _chaos_record(PORT, 4242)
    assert trec == jrec and _stats(tsrv) == _stats(jsrv)
    # the JAX twin recovers at this seed (tests/test_chaos.py), so must
    # the port
    assert tsrv.stats.health == "HEALTHY"
    assert tsrv.answer("q1") == _oracle(tsrv, "q1")
    assert tsrv.stats.batches >= 10
    assert tsrv.stats.faults  # the schedule really injected something
