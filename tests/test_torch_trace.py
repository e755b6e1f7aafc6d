"""The port's spans and phases (`repro_torch.trace`) on one university:
nothing is recorded without a profiler; under one, a fused request
records its run, every bucket, every blocking transfer and every copy
to the host, on the profiler's timeline; set-up phases are always
timed; answers do not change."""
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import profile  # noqa: E402

from repro_torch import trace  # noqa: E402
from repro_torch.api import SearchConfig, TuningSession, WizardConfig  # noqa: E402
from repro_torch.query import engine as E  # noqa: E402
from repro_torch.rdf import generator as tgen  # noqa: E402
from repro_torch.views import materializer  # noqa: E402

SEARCH = dict(strategy="greedy", max_states=400, max_seconds=1e9)
SETUP_PHASES = ("store.dedupe", "store.sort", "views.materialize",
                "views.extent", "store.upload", "workload.warm")


@pytest.fixture(scope="module")
def session():
    """A tuned, applied session and the phases its set-up recorded."""
    uni = tgen.generate(n_universities=1, seed=0)
    s = TuningSession(uni.store, tgen.lubm_workload(uni.dictionary),
                      schema=uni.schema, type_id=uni.type_id,
                      cfg=WizardConfig(search=SearchConfig(**SEARCH)),
                      device="cpu")
    s.retune()
    s.apply()
    return s, trace.phases()


def _request(ex):
    """One fused request as the benchmark sends it: the run, then every
    member's rows to the host."""
    roots = ex.workload.run(ex.tt, ex.device_views)
    return {m: E.to_numpy(rel) for m, rel in roots.items()}


def _profiled(ex):
    """A request without a profiler (as the benchmark's warm-up), then
    one under it: the profiled window's spans, and its events' names."""
    _request(ex)
    with profile() as prof:
        rows = _request(ex)
    return rows, trace.spans(), {e.name for e in prof.events()}


def test_off_path_records_nothing_and_returns_one_object(session):
    s, _ = session
    assert trace.span("a") is trace.span("b", rows=3) is trace.OFF
    with trace.span("a") as sp:
        sp.set(bytes=1)
    _profiled(s.executor)
    before = [(sp.name, sp.start_ns) for sp in trace.spans()]
    assert before
    _request(s.executor)
    assert [(sp.name, sp.start_ns) for sp in trace.spans()] == before


def test_a_profiled_request_records_its_spans(session):
    s, _ = session
    ex = s.executor
    prog = ex.workload._program()
    rows, spans, events = _profiled(ex)
    names = [sp.name for sp in spans]
    assert names.count("workload.run") == 1
    run = next(sp for sp in spans if sp.name == "workload.run")
    assert run.attrs == {"attempts": 1} and run.parent is None

    buckets = [sp for sp in spans if sp.name.startswith("bucket.")]
    assert len(buckets) == prog.n_buckets
    assert [sp.name for sp in buckets] == \
        ["bucket." + b.kind for b in prog.buckets]
    for sp, b in zip(buckets, prog.buckets):
        assert sp.parent is run
        assert sp.attrs == {"wave": b.wave, "cap": b.cap,
                            "batch": len(b.node_ids), "built": False}

    flags = [sp for sp in spans if sp.name == "sync.flags"]
    assert len(flags) == 1 and flags[0].parent is run
    # one bool a bucket member and a view node
    views = sum(node.kind == "view" for node in prog.dag.nodes)
    assert flags[0].attrs == {"bytes": views + sum(
        len(b.node_ids) for b in prog.buckets)}

    # the count, then the rows where there are any: an empty copy moves
    # nothing and does not block
    copies = [sp for sp in spans if sp.name == "engine.to_numpy"]
    assert len(copies) == len(rows)
    for sp, out in zip(copies, rows.values()):
        assert sp.parent is None
        assert sp.attrs == {"rows": len(out), "bytes": out.nbytes}
        kids = [k for k in spans if k.parent is sp]
        assert [k.name for k in kids] == \
            ["sync.count", "sync.rows"][: 1 + (out.nbytes > 0)]
        assert [k.attrs for k in kids] == \
            [{"bytes": 4}, {"bytes": out.nbytes}][: len(kids)]
    filled = sum(out.nbytes > 0 for out in rows.values())
    assert 0 < filled < len(rows)
    assert sum(n.startswith("sync.") for n in names) == \
        1 + len(rows) + filled

    for sp in spans:
        assert sp.end_ns >= sp.start_ns
    assert set(names) <= events


def test_a_second_window_holds_none_of_the_first(session):
    """As in a second traced run of one process."""
    s, _ = session
    _, first, _ = _profiled(s.executor)
    _, second, _ = _profiled(s.executor)
    assert first and second
    assert min(sp.start_ns for sp in second) > \
        max(sp.end_ns for sp in first)
    assert [sp.name for sp in first] == [sp.name for sp in second]


def test_a_window_keeps_its_spans_out_of_the_collectors_count():
    """A traced window keeps tens of thousands of spans: as objects the
    garbage collector counts, they would set off collections inside the
    window that the untraced program never makes."""
    trace.span("off")   # the next span under a profiler starts a stretch
    with profile():
        gc.disable()
        try:
            before = gc.get_count()[0]
            for _ in range(100):
                with trace.span("sync.count", bytes=4):
                    with trace.span("sync.rows") as s:
                        s.set(bytes=8, rows=1)
            grown = gc.get_count()[0] - before
        finally:
            gc.enable()
    assert grown < 20
    spans = trace.spans()
    assert len(spans) == 200
    assert [sp.name for sp in spans[:2]] == ["sync.count", "sync.rows"]
    assert spans[1].parent is spans[0] and spans[0].parent is None
    assert spans[0].attrs == {"bytes": 4}
    assert spans[1].attrs == {"bytes": 8, "rows": 1}


def test_record_function_stands_in_where_the_fast_span_is_missing(
        session, monkeypatch):
    s, _ = session
    monkeypatch.setattr(trace, "_FAST", None)
    _, spans, events = _profiled(s.executor)
    assert {sp.name for sp in spans} <= events


def test_answers_equal_with_and_without_the_profiler(session):
    s, _ = session
    plain = _request(s.executor)
    traced, _, _ = _profiled(s.executor)
    assert plain.keys() == traced.keys()
    for m in plain:
        np.testing.assert_array_equal(plain[m], traced[m], err_msg=m)


def test_set_up_phases_are_timed_without_a_profiler(session):
    s, phases = session
    assert set(SETUP_PHASES) <= set(phases)
    for name in SETUP_PHASES:
        assert phases[name].seconds >= 0
    n = len(s.store)
    assert phases["store.sort"].attrs == {"rows": n}
    assert phases["store.upload"].attrs["bytes"] == 6 * n * 3 * 4
    mat = phases["views.materialize"]
    assert mat.attrs["views"] == len(mat.children) \
        == len(s.executor.device_views)
    assert [c.name for c in mat.children] == ["views.extent"] * len(
        mat.children)
    assert mat.attrs["rows"] == sum(c.attrs["rows"] for c in mat.children)
    for c in mat.children:
        assert c.parent is mat
        assert c.attrs["cap"] == s.executor.device_views[c.attrs["vid"]].cap


@pytest.mark.parametrize("path", ["host", "device"])
def test_both_materializers_record_their_extents(session, path):
    s, _ = session
    ex = s.executor
    if path == "host":
        extents, _, _ = materializer.materialize_state(
            ex.state, ex.store, device="cpu")
    else:
        extents, _, _ = materializer.materialize_state_device(
            ex.state, ex.store, device="cpu")
    mat = trace.phases()["views.materialize"]
    assert {c.attrs["vid"]: c.attrs["rows"] for c in mat.children} == \
        {vid: len(e.rows) for vid, e in extents.items()}
    assert mat.attrs["rows"] == sum(len(e.rows) for e in extents.values())


def test_phases_under_a_profiler_are_spans_too(session):
    s, _ = session
    _request(s.executor)
    with profile() as prof:
        s.executor.warmup()
    names = [sp.name for sp in trace.spans()]
    assert names[0] == "workload.warm" and "workload.run" in names
    assert "workload.warm" in {e.name for e in prof.events()}
    warm, first = trace.phases()["workload.warm"], trace.spans()[0]
    assert (warm.start_ns, warm.end_ns) == (first.start_ns, first.end_ns)
