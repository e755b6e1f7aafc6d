"""The port's async serving frontend and load generator against the JAX
package's.

The stub-server tests of `tests/test_frontend.py` run against the port's
copies (`repro_torch.serve.frontend`, `repro_torch.serve.loadgen`, the
shard rollup of `repro_torch.distributed.fault`), on the VIRTUAL clock,
deterministic under a fixed seed.  Parity tests hold the port's
schedules and traffic reports equal to the JAX package's, and
`TuningSession.serve_async` over a real executor (the port on the CPU,
`device="cpu"`) answers as the JAX session's does; the sharded backend
is not ported yet and must refuse rather than serve from one device.
"""
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

from repro_torch.distributed.fault import (DEGRADED, DOWN,  # noqa: E402
                                           HEALTHY, STALE_ONLY,
                                           ServingSupervisor)
from repro_torch.serve.frontend import (BEST_EFFORT,  # noqa: E402
                                        FixedServiceModel, FrontendConfig,
                                        QueryClass, ServingFrontend,
                                        VirtualClock)
from repro_torch.serve.loadgen import (ClassSpec,  # noqa: E402
                                       TrafficConfig, generate_schedule,
                                       run_open_loop)


class StubServer:
    """Duck-typed batched server: records batches, applies a fake
    update backlog inside answer_batch (like QueryServer._refresh)."""

    def __init__(self):
        self.stats = SimpleNamespace(updates_applied=0, frontend={})
        self.batches: list[list[str]] = []
        self._pending = 0

    def answer_batch(self, names):
        self.batches.append(list(names))
        self.stats.updates_applied += self._pending
        self._pending = 0
        return [set() for _ in names]

    def submit(self, inserts=None, deletes=None):
        self._pending += len(inserts or [])

    def readiness(self):
        return {"ready": True, "health": "HEALTHY"}


def make_frontend(classes=None, server=None, **cfg):
    cfg.setdefault("queue_cap", 8)
    cfg.setdefault("batching_window", 0.01)
    cfg.setdefault("max_batch", 4)
    model = cfg.pop("service_model", FixedServiceModel(0.01, 0.01))
    fe = ServingFrontend(
        server or StubServer(),
        classes or [QueryClass("c")],
        FrontendConfig(**cfg),
        clock=VirtualClock(),
        service_model=model)
    return fe


class RecordingFrontend(ServingFrontend):
    """Keeps completed Request objects so tests can inspect per-request
    arrival/dispatch/finish times."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.records = []

    def _complete_inflight(self):
        self.records.extend(self._inflight)
        super()._complete_inflight()


# ----------------------------------------------------------------------
# deterministic twin: one schedule's exact batch boundaries
# ----------------------------------------------------------------------
def test_batch_boundaries_pinned():
    fe = make_frontend()
    # 4 arrivals fill the batch at t=0.003 -> immediate dispatch
    for i, t in enumerate((0.000, 0.001, 0.002, 0.003)):
        assert fe.offer("q", t=t)
    # two stragglers queue behind the in-flight batch
    assert fe.offer("q", t=0.010)
    assert fe.offer("q", t=0.030)
    end = fe.flush()
    # batch 1: full at 0.003, service 0.01 + 4*0.01 = 0.05 -> done 0.053
    # batch 2: dispatches the moment the server frees (0.053; its window
    # deadline 0.020 already passed), service 0.03 -> done 0.083
    assert fe.batch_log == [(pytest.approx(0.003), 4),
                            (pytest.approx(0.053), 2)]
    assert end == pytest.approx(0.083)
    rec = fe.stats.latency["c"]
    assert rec.count == 6
    assert rec.worst == pytest.approx(0.083 - 0.010)
    assert fe.stats.batch_occupancy == pytest.approx(3.0)
    assert fe.stats.completed == 6 and fe.stats.shed == 0


def test_partial_batch_waits_out_the_window():
    fe = make_frontend()
    fe.offer("q", t=0.0)
    fe.advance_to(0.005)
    assert fe.stats.batches == 0          # window not yet elapsed
    fe.advance_to(0.02)
    assert fe.batch_log == [(pytest.approx(0.01), 1)]


def test_virtual_clock_never_runs_backwards():
    from repro_torch.errors import InvariantViolation

    clock = VirtualClock(5.0)
    with pytest.raises(InvariantViolation):
        clock.advance_to(4.0)
    fe = make_frontend()
    fe.offer("q", t=1.0)
    with pytest.raises(InvariantViolation):
        fe.offer("q", t=0.5)


# ----------------------------------------------------------------------
# hypothesis property: the micro-batcher's wait bound
# ----------------------------------------------------------------------
def test_wait_bound_property():
    """With queue_cap <= max_batch, every dispatched request waits at
    most batching_window + max_batch_service_time from arrival: the
    whole queue fits in one dispatch, so a request is dispatched no
    later than one window plus one full batch service after arriving."""
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    window, base, per_req, max_batch = 0.01, 0.005, 0.002, 4
    s_max = base + per_req * max_batch

    # no example database and a fixed draw order: the test stores no
    # example for later runs to replay, and every run draws the same
    @hyp.settings(deadline=None, max_examples=60, database=None,
                  derandomize=True)
    @hyp.given(gaps=st.lists(st.floats(0.0, 0.05, allow_nan=False),
                             min_size=0, max_size=60))
    def run(gaps):
        fe = RecordingFrontend(
            StubServer(), [QueryClass("c")],
            FrontendConfig(queue_cap=max_batch, batching_window=window,
                           max_batch=max_batch, admission="none"),
            clock=VirtualClock(),
            service_model=FixedServiceModel(base, per_req))
        t = 0.0
        for g in gaps:
            t += g
            fe.offer("q", t=t)
        fe.flush()
        for r in fe.records:
            wait = r.dispatch - r.arrival
            assert wait <= window + s_max + 1e-9, \
                f"request waited {wait} > {window + s_max}"

    run()


# ----------------------------------------------------------------------
# admission control
# ----------------------------------------------------------------------
def test_slo_admission_sheds_when_estimate_breaches():
    fe = make_frontend(
        classes=[QueryClass("gold", priority=1, slo=0.05)],
        batching_window=0.0, max_batch=1, queue_cap=10,
        service_model=FixedServiceModel(0.02, 0.0))
    assert fe.offer("q", "gold", t=0.0)      # est 0.02 <= 0.05, dispatches
    assert fe.offer("q", "gold", t=0.0)      # est 0.04 <= 0.05, queues
    assert not fe.offer("q", "gold", t=0.0)  # est 0.06 > 0.05 -> shed
    assert fe.stats.shed == 1
    assert fe.stats.shed_by_class == {"gold": 1}
    fe.flush()
    assert fe.stats.completed == 2


def test_downgrade_mode_reroutes_to_best_effort():
    fe = make_frontend(
        classes=[QueryClass("gold", priority=1, slo=0.05)],
        batching_window=0.0, max_batch=1, queue_cap=10,
        admission="downgrade",
        service_model=FixedServiceModel(0.02, 0.0))
    assert BEST_EFFORT in fe.classes         # auto-created floor class
    fe.offer("q", "gold", t=0.0)
    fe.offer("q", "gold", t=0.0)
    assert fe.offer("q", "gold", t=0.0)      # admitted, downgraded
    assert fe.stats.shed == 0
    assert fe.stats.downgraded == 1
    assert fe.stats.downgraded_by_class == {"gold": 1}
    fe.flush()
    assert fe.stats.latency[BEST_EFFORT].count == 1
    assert fe.stats.latency["gold"].count == 2


def test_full_queue_evicts_lower_priority_for_higher():
    fe = make_frontend(
        classes=[QueryClass("gold", priority=2), QueryClass("bulk")],
        batching_window=0.0, max_batch=2, queue_cap=2,
        service_model=FixedServiceModel(0.05, 0.0))
    srv = fe.server
    fe.offer("a", "bulk", t=0.000)           # dispatches alone; busy 0.05
    fe.offer("b", "bulk", t=0.001)
    fe.offer("c", "bulk", t=0.002)           # queue now full (cap 2)
    assert not fe.offer("d", "bulk", t=0.003)  # same priority: shed at door
    assert fe.offer("g", "gold", t=0.004)    # evicts the newest bulk (c)
    assert fe.stats.evicted == 1
    assert fe.stats.shed_by_class == {"bulk": 2}   # d at door + c evicted
    fe.flush()
    # gold rode the next batch ahead of the surviving bulk request
    assert srv.batches[1] == ["g", "b"]
    assert fe.stats.completed == 3


def test_queue_bound_is_hard_without_admission():
    fe = make_frontend(batching_window=5.0, max_batch=100, queue_cap=3,
                       admission="none")
    # first 3 fill the cap and dispatch as one batch (a cap-full queue
    # cannot grow, so it never waits out the window); next 3 queue
    # behind the in-flight batch; the rest hit the hard bound
    admitted = [fe.offer("q", t=0.0) for _ in range(10)]
    assert admitted.count(True) == 6 and fe.stats.shed == 4
    assert fe.stats.max_queue_depth == 3
    fe.flush()
    assert fe.stats.completed == 6


def test_priority_dispatch_orders_batches():
    fe = make_frontend(
        classes=[QueryClass("gold", priority=2), QueryClass("bulk")],
        batching_window=0.0, max_batch=2, queue_cap=8,
        service_model=FixedServiceModel(0.05, 0.0))
    srv = fe.server
    fe.offer("a", "bulk", t=0.000)           # dispatches alone; busy
    fe.offer("b", "bulk", t=0.001)
    fe.offer("c", "bulk", t=0.002)
    fe.offer("d", "bulk", t=0.003)
    fe.offer("g", "gold", t=0.004)           # arrives last, dispatches next
    fe.flush()
    assert srv.batches[1] == ["g", "b"]
    assert srv.batches[2] == ["c", "d"]


# ----------------------------------------------------------------------
# update stream passthrough: maintenance backpressure in latency
# ----------------------------------------------------------------------
def test_update_backlog_stretches_batch_service():
    model = FixedServiceModel(0.01, 0.0, per_maint_triple=0.001)
    fe = make_frontend(batching_window=0.0, max_batch=1, queue_cap=4,
                       service_model=model)
    fe.offer("q", t=0.0)
    fe.flush()
    clean = fe.stats.latency["c"].worst
    fe.submit_update(inserts=[(1, 2, 3)] * 20, t=1.0)
    assert fe.stats.updates_submitted == 1
    fe.offer("q", t=1.0)
    fe.flush()
    # the drained 20-triple backlog cost 20 * 0.001 extra virtual time
    assert fe.stats.latency["c"].worst == pytest.approx(clean + 0.02)


def test_telemetry_mirrors_into_server_stats_and_readiness():
    fe = make_frontend()
    fe.offer("q", t=0.0)
    fe.flush()
    mirrored = fe.server.stats.frontend
    assert mirrored["completed"] == 1 and mirrored["latency"]["c"]["count"] == 1
    probe = fe.readiness()
    assert probe["ready"] and probe["queue_depth"] == 0
    assert probe["virtual_time"] == fe.clock.now()


# ----------------------------------------------------------------------
# per-shard health rollup (distributed/fault.py)
# ----------------------------------------------------------------------
def test_one_degraded_shard_rolls_up_degraded_not_down():
    sup = ServingSupervisor()
    for d in range(4):
        sup.observe_shard(d, 0)
    assert sup.rollup() == HEALTHY
    sup.observe_shard(2, 2)                  # host-fallback tier
    assert sup.worst() == DEGRADED
    assert sup.quorum()
    assert sup.rollup() == DEGRADED          # NOT DOWN
    sup.observe_shard(2, 0)                  # shard restored
    assert sup.rollup() == HEALTHY


def test_quorum_loss_degrades_to_stale_then_down():
    sup = ServingSupervisor()
    for d in range(4):
        sup.observe_shard(d, None)           # all shards unservable
    assert sup.worst() == DOWN and not sup.quorum()
    assert sup.rollup() == DOWN
    sup.observe_shard(0, 3)                  # one shard: stale cache only
    assert sup.rollup() == STALE_ONLY
    # two exact shards of four is NOT a strict majority yet
    sup.observe_shard(1, 1)
    sup.observe_shard(2, 1)
    assert not sup.quorum() and sup.rollup() == STALE_ONLY
    # third exact shard restores the quorum -> DEGRADED
    sup.observe_shard(3, 1)
    assert sup.quorum() and sup.rollup() == DEGRADED
    assert sup.quorum(minimum=4) is False


def test_empty_shard_map_is_healthy():
    sup = ServingSupervisor()
    assert sup.worst() == HEALTHY and sup.quorum()


# ----------------------------------------------------------------------
# load generator
# ----------------------------------------------------------------------
CLASSES = (ClassSpec("gold", 0.2, ("q1", "q2"), priority=2, slo=0.05),
           ClassSpec("bulk", 0.8, ("q3", "q4"), priority=0, slo=1.0))


def loaded_frontend(admission="shed", priority_dispatch=True,
                    queue_cap=64):
    return ServingFrontend(
        StubServer(),
        [QueryClass(c.name, priority=c.priority, slo=c.slo)
         for c in CLASSES],
        FrontendConfig(queue_cap=queue_cap, batching_window=0.005,
                       max_batch=16, admission=admission,
                       priority_dispatch=priority_dispatch),
        clock=VirtualClock(),
        service_model=FixedServiceModel(0.004, 0.001))


def test_schedule_is_deterministic_and_open_loop():
    cfg = TrafficConfig(rate=500.0, duration=1.0, classes=CLASSES, seed=3,
                        update_rate=20.0, update_size=5)
    s1, s2 = generate_schedule(cfg), generate_schedule(cfg)
    assert s1 == s2
    assert generate_schedule(
        TrafficConfig(rate=500.0, duration=1.0, classes=CLASSES,
                      seed=4)) != s1
    ts = [a.t for a in s1]
    assert ts == sorted(ts) and ts[-1] < 1.0
    kinds = {a.kind for a in s1}
    assert kinds == {"query", "update"}
    # open loop: arrival count tracks rate, not server speed
    nq = sum(a.kind == "query" for a in s1)
    assert 400 < nq < 600


def test_overload_admission_holds_top_class_slo():
    """The BENCH_serve acceptance story, miniature: under ~1.5x offered
    overload, admission control sheds load and keeps the gold p99 SLO;
    the no-admission FIFO baseline breaches it."""
    cfg = TrafficConfig(rate=1200.0, duration=1.5, classes=CLASSES, seed=7)
    adm = run_open_loop(loaded_frontend(), cfg)
    base = run_open_loop(
        loaded_frontend(admission="none", priority_dispatch=False,
                        queue_cap=1 << 16), cfg)
    assert adm.shed_rate > 0
    assert adm.per_class["gold"].slo_met is True
    assert base.shed_rate == 0
    assert base.per_class["gold"].slo_met is False
    # determinism: same seed, same report
    again = run_open_loop(loaded_frontend(), cfg)
    assert again.as_dict() == adm.as_dict()


def test_update_events_flow_to_server():
    cfg = TrafficConfig(rate=100.0, duration=0.5, classes=CLASSES, seed=1,
                        update_rate=30.0, update_size=4)
    fe = loaded_frontend()
    rep = run_open_loop(
        fe, cfg, update_fn=lambda rng: ([(1, 2, 3)] * 4, None))
    assert fe.stats.updates_submitted > 0
    assert rep.completed == fe.stats.completed > 0


# ----------------------------------------------------------------------
# parity with the JAX package's copies
# ----------------------------------------------------------------------
def _jax_loaded_frontend(admission="shed", priority_dispatch=True,
                         queue_cap=64):
    from repro.serve import frontend as jfe

    return jfe.ServingFrontend(
        StubServer(),
        [jfe.QueryClass(c.name, priority=c.priority, slo=c.slo)
         for c in CLASSES],
        jfe.FrontendConfig(queue_cap=queue_cap, batching_window=0.005,
                           max_batch=16, admission=admission,
                           priority_dispatch=priority_dispatch),
        clock=jfe.VirtualClock(),
        service_model=jfe.FixedServiceModel(0.004, 0.001))


def _jax_traffic(cfg):
    from repro.serve import loadgen as jlg

    return jlg.TrafficConfig(
        rate=cfg.rate, duration=cfg.duration, seed=cfg.seed,
        update_rate=cfg.update_rate, update_size=cfg.update_size,
        classes=tuple(jlg.ClassSpec(c.name, c.weight, c.queries,
                                    priority=c.priority, slo=c.slo)
                      for c in cfg.classes))


def test_schedule_equals_jax():
    from repro.serve import loadgen as jlg

    cfg = TrafficConfig(rate=500.0, duration=1.0, classes=CLASSES, seed=3,
                        update_rate=20.0, update_size=5)
    got = [(a.t, a.kind, a.cls, a.name) for a in generate_schedule(cfg)]
    want = [(a.t, a.kind, a.cls, a.name)
            for a in jlg.generate_schedule(_jax_traffic(cfg))]
    assert got == want


@pytest.mark.parametrize("admission", ["shed", "none"])
def test_open_loop_report_equals_jax(admission):
    from repro.serve import loadgen as jlg

    cfg = TrafficConfig(rate=1200.0, duration=0.5, classes=CLASSES, seed=7,
                        update_rate=30.0, update_size=4)
    upd = lambda rng: ([(1, 2, 3)] * int(rng.integers(1, 5)), None)  # noqa
    fe = loaded_frontend(admission=admission)
    jfe = _jax_loaded_frontend(admission=admission)
    rep = run_open_loop(fe, cfg, update_fn=upd)
    jrep = jlg.run_open_loop(jfe, _jax_traffic(cfg), update_fn=upd)
    assert rep.as_dict() == jrep.as_dict()
    assert fe.stats.summary() == jfe.stats.summary()
    assert fe.batch_log == jfe.batch_log
    assert fe.server.batches == jfe.server.batches


# ----------------------------------------------------------------------
# API integration: TuningSession.serve_async over a real executor
# ----------------------------------------------------------------------
UNI = dict(n_universities=1, seed=0, dept_per_univ=2, prof_per_dept=4,
           stud_per_dept=12, course_per_dept=5)


@pytest.fixture(scope="module")
def tuned_sessions():
    """The same workload tuned and applied by each package."""
    from repro.api import SearchConfig as JSearch
    from repro.api import TuningSession as JSession
    from repro.api import WizardConfig as JConfig
    from repro.rdf.generator import generate, lubm_workload
    from repro_torch.api import SearchConfig, TuningSession, WizardConfig
    from repro_torch.rdf import generator as tgen

    ju, tu = generate(**UNI), tgen.generate(**UNI)
    js = JSession(ju.store, lubm_workload(ju.dictionary)[:4],
                  schema=ju.schema, type_id=ju.type_id,
                  cfg=JConfig(search=JSearch(strategy="greedy",
                                             max_states=60)))
    ts = TuningSession(tu.store, tgen.lubm_workload(tu.dictionary)[:4],
                       schema=tu.schema, type_id=tu.type_id,
                       cfg=WizardConfig(search=SearchConfig(
                           strategy="greedy", max_states=60)),
                       device="cpu")
    for s in (js, ts):
        s.retune()
        s.apply()
    return js, ts


def _drive(s, fe_mod):
    fe = s.serve_async(
        classes=[fe_mod.QueryClass("gold", priority=1, slo=10.0),
                 fe_mod.QueryClass("bulk")],
        frontend=fe_mod.FrontendConfig(queue_cap=16, batching_window=0.005,
                                       max_batch=8),
        service_model=fe_mod.FixedServiceModel(0.002, 0.0005))
    names = [q.name for q in s.workload]
    for i, n in enumerate(names * 2):
        fe.offer(n, "gold" if i % 2 else "bulk", t=i * 0.001)
    fe.flush()
    return fe, names


def test_serve_async_answers_match_session(tuned_sessions):
    from repro.serve import frontend as jfe_mod
    from repro_torch.serve import frontend as tfe_mod

    js, s = tuned_sessions
    jfe, _ = _drive(js, jfe_mod)
    fe, names = _drive(s, tfe_mod)
    assert fe.stats.completed == len(names) * 2
    assert fe.server.stats.frontend["completed"] == len(names) * 2
    assert fe.stats.summary() == jfe.stats.summary()
    assert fe.batch_log == jfe.batch_log
    probe = fe.server.readiness()
    assert probe["ready"] and "frontend" in probe
    assert fe.readiness()["health"] == "HEALTHY"
    assert fe.readiness() == jfe.readiness()
    got = fe.server.answer_batch(names)
    assert got == [s.answer(n) for n in names]
    assert got == jfe.server.answer_batch(names)


def test_serve_async_streams_updates_through_the_server(tuned_sessions):
    from repro_torch.api import MaintenanceConfig

    _, s = tuned_sessions
    fe = s.serve_async(classes=[QueryClass("gold", priority=1, slo=10.0)],
                       maintenance=MaintenanceConfig(),
                       service_model=FixedServiceModel(0.002, 0.0005))
    names = [q.name for q in s.workload]
    for i, n in enumerate(names):
        fe.offer(n, "gold", t=i * 0.001)
    fe.submit_update(inserts=s.store.triples[:3] + 1, t=0.01)
    fe.offer(names[0], "gold", t=0.02)
    fe.flush()
    assert fe.stats.completed == fe.stats.admitted == len(names) + 1
    assert fe.server.stats.updates_submitted == 3
    assert fe.server.stats.backlog_triples == 0
    for n in names:
        assert fe.server.answer(n) == fe.server.executor.answer_group_direct(n)


def test_serve_async_sharded_rejects_maintenance(tuned_sessions):
    _, s = tuned_sessions
    with pytest.raises(ValueError, match="static-store"):
        s.serve_async(sharded=True, maintenance=True)


def test_serve_async_sharded_is_not_served_from_one_device(tuned_sessions):
    """`sharded=True` is served by the sharded backend, not by the
    single-device `QueryServer`; with no mesh given it takes one shard a
    visible device on the executor's device (here the CPU: one)."""
    from repro_torch.serve.query_server import QueryServer
    from repro_torch.serve.sharded import ShardedBackend

    _, s = tuned_sessions
    fe = s.serve_async(sharded=True)
    assert isinstance(fe.server, ShardedBackend)
    assert not isinstance(fe.server, QueryServer)
    assert fe.server.mesh.device == s.executor.device
    assert fe.server.ndev == 1
    names = [q.name for q in s.workload]
    for i, n in enumerate(names):
        fe.offer(n, t=i * 0.001)
    fe.flush()
    assert fe.stats.completed == fe.stats.admitted == len(names)
    assert fe.server.stats.served_tier == 0
    for n in names:
        assert fe.server.answer(n) == s.executor.answer_group_direct(n)
