"""The static verification stack: the port's `repro_torch.analysis`
against the JAX package's `repro.analysis` on the same inputs.

Findings compare as (family, rule, severity, location) with the JAX
lint's `jaxpr` family read as the port's `body` family (`jaxpr/callback`
as `body/host-sync`); `checked` counts compare exactly, except `files`
(each package's repo rules walk their own tree).  Every seeded hazard of
`tests/test_analysis.py` and of the analysis tests of
`tests/test_maintenance.py` is caught by its port counterpart.
"""
import dataclasses
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.analysis as JA  # noqa: E402
import repro_torch.analysis as TA  # noqa: E402
from repro.analysis import cli as jcli  # noqa: E402
from repro.analysis import maintenance_check as jmc  # noqa: E402
from repro.analysis import repo_rules as jrules  # noqa: E402
from repro.api import SearchConfig as JSearch  # noqa: E402
from repro.api import TuningSession as JSession  # noqa: E402
from repro.api import WizardConfig as JConfig  # noqa: E402
from repro.core import queries as jq  # noqa: E402
from repro.maintenance import MaintenanceConfig as JMaintConfig  # noqa: E402
from repro.query import buckets as jbuckets  # noqa: E402
from repro.query import dag as jdag  # noqa: E402
from repro.query import plan as jplan  # noqa: E402
from repro.query.workload import WorkloadExecutor as JWorkload  # noqa: E402
from repro.rdf.generator import generate, lubm_workload  # noqa: E402
from repro.rdf.triples import TripleStore as JStore  # noqa: E402
from repro_torch.analysis import cli as tcli  # noqa: E402
from repro_torch.analysis import maintenance_check as tmc  # noqa: E402
from repro_torch.api import MaintenanceConfig as TMaintConfig  # noqa: E402
from repro_torch.api import SearchConfig as TSearch  # noqa: E402
from repro_torch.api import TuningSession as TSession  # noqa: E402
from repro_torch.api import WizardConfig as TConfig  # noqa: E402
from repro_torch.core import queries as tq  # noqa: E402
from repro_torch.errors import InvariantViolation  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.query import buckets as tbuckets  # noqa: E402
from repro_torch.query import cost as tcost  # noqa: E402
from repro_torch.query import dag as tdag  # noqa: E402
from repro_torch.query import engine as TE  # noqa: E402
from repro_torch.query import plan as tplan  # noqa: E402
from repro_torch.query import ref_engine as TR  # noqa: E402
from repro_torch.query.workload import \
    WorkloadExecutor as TWorkload  # noqa: E402
from repro_torch.rdf import generator as tgen  # noqa: E402
from repro_torch.rdf.triples import TripleStore as TStore  # noqa: E402

# the JAX lint's rule ids as the port's
RULE_MAP = {"jaxpr/callback": "body/host-sync"}
PREDS = [1, 2, 3, 4, 5]
SEARCH = dict(strategy="greedy", max_states=400, max_seconds=1e9)
PORT_ROOT = os.path.dirname(TA.__path__[0])


def _port_rule(rule: str) -> str:
    return RULE_MAP.get(rule, rule.replace("jaxpr/", "body/"))


def _keys(findings) -> list[tuple]:
    """Findings as (family, rule, severity, location), JAX ids mapped."""
    return sorted(("body" if f.analyzer == "jaxpr" else f.analyzer,
                   _port_rule(f.rule), f.severity, f.location)
                  for f in findings)


def _rules(findings) -> set[str]:
    return {f.rule for f in findings}


def _same(jfindings, tfindings) -> list[tuple]:
    assert _keys(tfindings) == _keys(jfindings)
    return _keys(tfindings)


def _same_report(jrep, trep) -> None:
    _same(jrep.findings, trep.findings)
    drop = {"files"}
    assert {k: v for k, v in trep.checked.items() if k not in drop} == \
        {k: v for k, v in jrep.checked.items() if k not in drop}


# ----------------------------------------------------------------------
# the small store and DAG of tests/test_analysis.py, in both packages
# ----------------------------------------------------------------------
def _triples() -> np.ndarray:
    triples = [(s, 1, 10 + s % 3) for s in range(6)]
    triples += [(s, 2, s - 9) for s in range(10, 14)]
    return np.array(triples, np.int32)


def _plans(Q, P):
    x, y, z = Q.Var("x"), Q.Var("y"), Q.Var("z")
    scan1 = P.TTScan(Q.Atom(x, Q.Const(1), y))
    scan2 = P.TTScan(Q.Atom(y, Q.Const(2), z))
    return {"q_join": P.EquiJoin(scan1, scan2, (("y", "y"),)),
            "q_filt": P.Filter(scan1, "y", 10)}


def _dags():
    return (jdag.build_dag(_plans(jq, jplan)),
            tdag.build_dag(_plans(tq, tplan)))


def _width(dag):
    jid = dag.roots["q_join"]
    dag.nodes[jid] = dataclasses.replace(dag.nodes[jid],
                                         width=dag.nodes[jid].width + 2)


def _cycle(dag):
    fid = dag.roots["q_filt"]
    dag.nodes[fid] = dataclasses.replace(dag.nodes[fid], child_ids=(fid,))


def _collision(dag):
    dup = dataclasses.replace(dag.nodes[0], id=len(dag.nodes),
                              key=("scan", ("corrupt",)))
    dag.nodes.append(dup)
    dag.consumers[dup.id] = 0


def _key_structure(dag):
    fid = dag.roots["q_filt"]
    node = dag.nodes[fid]
    ci, value = node.spec
    dag.nodes[fid] = dataclasses.replace(
        node, key=("filter", node.child_ids[0], ci + 1, value))


def _consumer_drift(dag):
    dag.consumers[0] += 1


# (corruption, expected members, rules the JAX test requires)
IR_CASES = {
    "clean": (None, {"q_join", "q_filt"}, set()),
    "width": (_width, None, {"ir/width"}),
    "cycle": (_cycle, None, {"ir/cycle"}),
    "key-collision": (_collision, None, {"ir/key-collision"}),
    "key-structure": (_key_structure, None, {"ir/key-structure"}),
    "missing-root": (None, {"q_join", "q_gone"}, {"ir/root-coverage"}),
    "consumer-drift": (_consumer_drift, None, {"ir/consumers"}),
}


# ----------------------------------------------------------------------
# IR verifier
# ----------------------------------------------------------------------
@pytest.mark.parametrize("case", list(IR_CASES))
def test_ir_verifier_matches_jax(case):
    corrupt, members, want = IR_CASES[case]
    jd, td = _dags()
    if corrupt is not None:
        corrupt(jd)
        corrupt(td)
    keys = _same(JA.verify_dag(jd, members), TA.verify_dag(td, members))
    assert want <= {k[1] for k in keys}
    if case == "clean":
        assert keys == []


def test_renamed_plans_intern_to_one_node():
    plans = _plans(tq, tplan)
    store = TStore(_triples())
    renamed = {n: tplan.rename_columns(p, {"x": "a", "y": "b", "z": "c"})
               for n, p in plans.items()}
    dag = tdag.build_dag({**plans,
                          **{f"{n}_renamed": p for n, p in renamed.items()}})
    for name, plan in plans.items():
        assert dag.roots[name] == dag.roots[f"{name}_renamed"]
        got = sorted(map(tuple, TR.execute(plan, store).rows.tolist()))
        want = sorted(map(tuple,
                          TR.execute(renamed[name], store).rows.tolist()))
        assert got == want
    assert TA.verify_dag(dag) == []


# ----------------------------------------------------------------------
# capacity analyzer
# ----------------------------------------------------------------------
def _hazard_caps(dag, case):
    n = len(dag.nodes)
    scan_ids = [nd.id for nd in dag.nodes if nd.kind == "scan"]
    join_id = dag.roots["q_join"]
    caps, demands = [128] * n, [10.0] * n
    if case == "invalid-ceiling":
        caps[scan_ids[0]] = 100           # not a power of two
        demands[join_id] = float(1 << 23)  # beyond the ceiling
    else:
        demands[join_id] = 1000.0          # overflow predicted on first run
        demands[scan_ids[1]] = 100.0       # < 2x headroom
    return caps, demands


@pytest.mark.parametrize("case", ["planned", "invalid-ceiling",
                                  "undersized-headroom"])
def test_capacity_matches_jax(case):
    jd, td = _dags()
    jstats, tstats = JStore(_triples()).stats, TStore(_triples()).stats
    if case == "planned":
        keys = _same(JA.analyze_capacity(jd, jstats, {}),
                     TA.analyze_capacity(td, tstats, {}))
        assert keys == []
        return
    jc, jdm = _hazard_caps(jd, case)
    tc, tdm = _hazard_caps(td, case)
    keys = _same(JA.analyze_capacity(jd, jstats, {}, caps=jc, demands=jdm),
                 TA.analyze_capacity(td, tstats, {}, caps=tc, demands=tdm))
    rules = {k[1] for k in keys}
    if case == "invalid-ceiling":
        assert {"cap/invalid", "cap/ceiling"} <= rules
    else:
        assert {"cap/undersized", "cap/headroom"} <= rules
        assert all(k[2] == "warning" for k in keys)


def test_promotion_chain_bounded():
    chain = tcost.promotion_chain(128)
    assert chain[0] == 256 and chain[-1] == 1 << 22
    assert all(b == 2 * a for a, b in zip([128] + chain, chain))
    assert tcost.promotion_chain(1 << 22) == []


# ----------------------------------------------------------------------
# body lint
# ----------------------------------------------------------------------
def _programs(use_kernels):
    jd, td = _dags()
    jp = jbuckets.BucketedProgram(jd, JStore(_triples()).stats, {})
    tp = tbuckets.BucketedProgram(td, TStore(_triples()).stats, {},
                                  device="cpu", use_kernels=use_kernels)
    return jp, tp


@pytest.mark.parametrize("use_kernels", [True, False])
def test_lint_clean_on_real_buckets(use_kernels, monkeypatch):
    jp, tp = _programs(use_kernels)
    seen = []
    real = ops.join_count

    def spy(probe, build):
        seen.append((probe.device.type, probe.dtype, tuple(probe.shape)))
        return real(probe, build)

    monkeypatch.setattr(ops, "join_count", spy)
    n_tt = len(_triples())
    keys = _same(JA.lint_program(jp, n_tt=n_tt),
                 TA.lint_program(tp, n_tt=n_tt))
    assert keys == []
    joins = [b for b in tp.buckets if b.kind == "join"]
    assert joins
    # with the kernel the join body reaches join_count's meta shape rule
    assert len(seen) == (len(joins) if use_kernels else 0)
    assert all(s[0] == "meta" and s[1] == torch.int32 for s in seen)


def _meta(shape=(4,)):
    return torch.empty(shape, dtype=torch.int32, device="meta")


def test_lint_catches_float64_promotion():
    spec = jax.ShapeDtypeStruct((4,), jnp.int32)
    jax.config.update("jax_enable_x64", True)
    try:
        jf = JA.lint_traced(lambda x: x.astype(jnp.float64) * 2.0, (spec,))
    finally:
        jax.config.update("jax_enable_x64", False)
    tf = TA.lint_traced(lambda x: x.to(torch.float64) * 2.0, (_meta(),))
    assert "body/float64" in _rules(tf)
    assert "body/float64" in {_port_rule(r) for r in _rules(jf)}


def test_lint_catches_float_in_engine_body():
    spec = jax.ShapeDtypeStruct((4,), jnp.int32)
    jf = JA.lint_traced(lambda x: (x * 1.5).astype(jnp.int32), (spec,))
    tf = TA.lint_traced(lambda x: (x * 1.5).to(torch.int32), (_meta(),))
    assert _rules(tf) == {"body/weak-float"}
    assert {k[1] for k in _same(jf, tf)} == {"body/weak-float"}
    assert TA.lint_traced(lambda x: (x * 1.5).to(torch.int32), (_meta(),),
                          forbid_floats=False) == []


HOST_READS = {
    "item": lambda x: x.sum().item(),
    "int": lambda x: int(x.sum()) + 1,
    "tolist": lambda x: x.tolist(),
    "cpu": lambda x: x.cpu().numpy(),
    "to-cpu": lambda x: x.to("cpu") + 1,
}


@pytest.mark.parametrize("read", list(HOST_READS))
def test_lint_catches_host_sync(read):
    findings = TA.lint_traced(HOST_READS[read], (_meta(),))
    assert _rules(findings) == {"body/host-sync"}, findings
    assert all(f.severity == "error" for f in findings)


def test_host_sync_stands_for_the_jax_callback():
    spec = jax.ShapeDtypeStruct((4,), jnp.int32)

    def body(x):
        return jax.pure_callback(
            lambda a: a, jax.ShapeDtypeStruct(x.shape, x.dtype), x)

    jf = JA.lint_traced(body, (spec,))
    tf = TA.lint_traced(HOST_READS["item"], (_meta(),))
    assert {k[1] for k in _same(jf, tf)} == {"body/host-sync"}


DYNAMIC = {
    "nonzero": lambda x: x.nonzero(),
    "unique": lambda x: torch.unique(x) + 1,
    "masked_select": lambda x: x.masked_select(x > 0),
    "bool-index": lambda x: x[x > 0] * 2,
    "repeat_interleave": lambda x: torch.repeat_interleave(x, x),
    "bincount": lambda x: torch.bincount(x),
}


@pytest.mark.parametrize("op", list(DYNAMIC))
def test_lint_catches_dynamic_shape(op):
    findings = TA.lint_traced(DYNAMIC[op], (_meta(),))
    assert _rules(findings) == {"body/dynamic-shape"}, findings


def test_lint_records_every_hazard_of_one_body():
    def body(x):
        n = int(x.sum())                       # a host read ...
        return x.nonzero()[:n], x * 0.5        # ... a dynamic shape, a float

    assert _rules(TA.lint_traced(body, (_meta(),))) == {
        "body/host-sync", "body/dynamic-shape", "body/weak-float"}


def test_lint_reports_trace_failure():
    def broken(x):
        raise ValueError("boom")

    jf = JA.lint_traced(broken, (jax.ShapeDtypeStruct((2,), jnp.int32),))
    tf = TA.lint_traced(broken, (_meta((2,)),))
    assert {k[1] for k in _same(jf, tf)} == {"body/trace-error"}
    assert "boom" in tf[0].message and "ValueError" in tf[0].message


@pytest.mark.parametrize("case", ["good", "collide", "unhashable"])
def test_cache_key_checks_match_jax(case):
    keyed = {
        "good": [(("sig_a",), ("key_a",), "a"), (("sig_b",), ("key_b",), "b")],
        "collide": [(("sig_a",), ("key",), "a"), (("sig_b",), ("key",), "b")],
        "unhashable": [(("sig",), ["list", "key"], "c")],
    }[case]
    keys = _same(JA.check_cache_keys(keyed), TA.check_cache_keys(keyed))
    want = {"good": set(), "collide": {"body/key-collision"},
            "unhashable": {"body/key-unhashable"}}[case]
    assert {k[1] for k in keys} == want


def _recorded_keys(program, run):
    """The cache keys `_run_bucket` uses while `run()` executes, with
    the operands they were taken over."""
    seen = []
    real = program.cache_key

    def record(bucket, args):
        seen.append((bucket, tuple(args), real(bucket, args)))
        return real(bucket, args)

    program.cache_key = record
    try:
        run()
    finally:
        del program.cache_key
    return seen


def _assert_abstract_keys(program, seen, n_tt, view_caps=None):
    eff = program.static_eff_caps(view_caps)
    assert [b.label for b, _, _ in seen] == \
        [b.label for b in program.buckets]
    for bucket, args, key in seen:
        specs = program.abstract_args(bucket, n_tt, eff)
        assert all(s.device.type == "meta" for s in specs)
        assert [(tuple(s.shape), s.dtype) for s in specs] == \
            [(tuple(a.shape), a.dtype) for a in args], bucket.label
        assert program.cache_key(bucket, specs) == key, bucket.label


def test_abstract_args_match_real_operands():
    _, tp = _programs(True)
    store = TStore(_triples())
    tt = TE.tt_device_indexes(store, "cpu")
    seen = _recorded_keys(tp, lambda: tp.execute(tt, {}))
    _assert_abstract_keys(tp, seen, len(store))


# ----------------------------------------------------------------------
# the wrappers on meta: each has a shape rule
# ----------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(7,), (3, 5)])
def test_join_count_shape_rule_on_meta(shape):
    probe = torch.empty(shape, dtype=torch.int32, device="meta")
    build = torch.empty(shape[:-1] + (11,), dtype=torch.int32, device="meta")
    lo, count = ops.join_count(probe, build)
    for t in (lo, count):
        assert t.device.type == "meta" and t.dtype == torch.int32
        assert t.shape == probe.shape
    # the operand checks still run first
    with pytest.raises(TypeError, match="probe must be"):
        ops.join_count(probe.to(torch.int64), build)
    with pytest.raises(ValueError, match="rows"):
        ops.join_count(torch.empty((2, 5), dtype=torch.int32, device="meta"),
                       torch.empty((3, 5), dtype=torch.int32, device="meta"))


def test_other_wrappers_raise_on_meta():
    """The other wrappers gained shape rules on `meta` (the dry-run
    traces LM steps there): on meta they raise only where an operand
    breaks the contract, as on the CPU; otherwise they return what
    their shape rules give (`tests/test_torch_kernels.py` holds those
    against the plain versions)."""
    m = torch.empty((8, 3), dtype=torch.int32, device="meta")
    with pytest.raises(TypeError, match="rows must be"):
        ops.filter_mask(m.to(torch.int64), ((0, 1),))
    with pytest.raises(ValueError, match="out of range"):
        ops.filter_mask(m, ((3, 1),))
    with pytest.raises(ValueError, match="overflows capacity"):
        ops.scatter_append(m, 7, m[:2].contiguous(), 2)
    q = torch.empty((1, 4, 2, 16), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q[..., :12].contiguous(), q[..., :12].contiguous(),
                            q[..., :12].contiguous())
    assert ops.filter_mask(m, ((0, 1),))[0].device.type == "meta"
    assert ops.scatter_append(m, 0, m[:2].contiguous(), 1).device.type \
        == "meta"
    assert ops.flash_attention(q, q, q).device.type == "meta"


# ----------------------------------------------------------------------
# repo rules
# ----------------------------------------------------------------------
RULE_SOURCES = {
    "bare-assert": ("def f(x):\n    assert x > 0\n    return x\n", "m.py"),
    "assert-opt-out": ("def f(x):\n    assert x > 0  # lint: allow-assert\n",
                       "m.py"),
    "mutable-default": ("def f(x, acc=[]):\n    return acc\n", "m.py"),
    "mutable-kw-default": ("def f(x, *, acc=dict()):\n    return acc\n",
                           "m.py"),
    "none-default": ("def f(x, acc=None):\n    return acc\n", "m.py"),
    "unhashable-static": (
        "from functools import partial\nimport jax\n\n"
        "@partial(jax.jit, static_argnames=('cfg',))\n"
        "def f(x, cfg={}):\n    return x\n", "m.py"),
    "swallow": ("def f():\n    try:\n        g()\n    except Exception:\n"
                "        pass\n", "serve/m.py"),
    "swallow-out-of-scope": ("try:\n    g()\nexcept Exception:\n    pass\n",
                             "query/m.py"),
    "swallow-opt-out": ("try:\n    g()\nexcept Exception:  "
                        "# lint: allow-swallow\n    pass\n", "api/m.py"),
    "unbounded": ("from collections import deque\nclass S:\n"
                  "    def __init__(self):\n        self.q = deque()\n"
                  "        self.log = []\n    def push(self, x):\n"
                  "        self.q.append(x)\n        self.log.append(x)\n",
                  "serve/m.py"),
    "unbounded-opt-out": ("class S:\n    def push(self, x):\n"
                          "        self.log.append(x)  "
                          "# lint: allow-unbounded\n", "serve/m.py"),
}


@pytest.mark.parametrize("case", list(RULE_SOURCES))
def test_rules_match_jax(case):
    src, path = RULE_SOURCES[case]
    keys = _same(jrules.check_source(src, path), TA.check_source(src, path))
    assert bool(keys) == ("opt-out" not in case and case != "none-default"
                          and "out-of-scope" not in case)


def test_repo_rules_clean_on_the_port():
    report = TA.analyze_repo()
    assert report.clean(), report.format()
    assert report.checked["files"] > 20
    # the JAX package's own rules agree over the port's tree
    findings, n_files = jrules.run_repo_rules(PORT_ROOT)
    assert findings == [] and n_files == report.checked["files"]


def test_unbounded_opt_out_on_the_batched_server():
    path = os.path.join(PORT_ROOT, "serve", "serve_step.py")
    with open(path, encoding="utf-8") as f:
        source = f.read()
    assert TA.check_source(source, "serve/serve_step.py") == []
    stripped = source.replace("  # lint: allow-unbounded", "")
    assert _rules(TA.check_source(stripped, "serve/serve_step.py")) == \
        {"rules/unbounded-queue"}


# ----------------------------------------------------------------------
# maintenance analyzer (tests/test_maintenance.py's analysis tests)
# ----------------------------------------------------------------------
def _random_store(rng, n):
    return np.stack([rng.integers(0, 60, n), rng.choice(PREDS, n),
                     rng.integers(0, 60, n)], axis=1).astype(np.int32)


def _chain_cq(Q, name, p1, p2):
    x, y, z = Q.Var("x"), Q.Var("y"), Q.Var("z")
    return Q.CQ(name=name, head=(x, y, z),
                atoms=(Q.Atom(x, Q.Const(p1), y), Q.Atom(y, Q.Const(p2), z)))


def _pair(seed, n, chains):
    rng = np.random.default_rng(seed)
    tt = _random_store(rng, n)
    js = JSession(JStore(tt), [_chain_cq(jq, f"q{i + 1}", *c)
                               for i, c in enumerate(chains)])
    ts = TSession(TStore(tt), [_chain_cq(tq, f"q{i + 1}", *c)
                               for i, c in enumerate(chains)], device="cpu")
    for s in (js, ts):
        s.retune()
        s.apply()
    return rng, js, ts


def test_maintenance_static_and_hazards_match_jax():
    _, js, ts = _pair(11, 2000, ((1, 2), (2, 3)))
    assert _same(JA.analyze_maintenance(js.best, js.store.stats),
                 TA.analyze_maintenance(ts.best, ts.store.stats)) == []
    bad = SimpleNamespace(delta_cap=100, expected_batch=8)
    keys = _same(jmc._check_delta_cap(bad), tmc._check_delta_cap(bad))
    assert ("maint", "maint/delta-cap", "error", "") in keys
    split = _same(
        JA.analyze_maintenance(js.best, js.store.stats, JMaintConfig(
            delta_cap=128, expected_batch=4096)),
        TA.analyze_maintenance(ts.best, ts.store.stats, TMaintConfig(
            delta_cap=128, expected_batch=4096)))
    assert ("maint", "maint/delta-cap", "warning", "") in split
    hot = _same(JA.analyze_maintenance(js.best, js.store.stats,
                                       update_rate=1e9),
                TA.analyze_maintenance(ts.best, ts.store.stats,
                                       update_rate=1e9))
    assert {"maint/extent-headroom", "maint/tt-headroom"} <= \
        {k[1] for k in hot}


def test_maintenance_live_mode_matches_jax():
    rng, js, ts = _pair(13, 2000, ((1, 2),))
    jm, tm = js.maintainer(), ts.maintainer()
    batch = _random_store(rng, 32)
    js.ingest(inserts=batch)
    ts.ingest(inserts=batch)
    assert _same(JA.analyze_maintenance(maintainer=jm),
                 TA.analyze_maintenance(maintainer=tm)) == []
    hot = _same(JA.analyze_maintenance(maintainer=jm, update_rate=1e9),
                TA.analyze_maintenance(maintainer=tm, update_rate=1e9))
    assert "maint/tt-headroom" in {k[1] for k in hot}
    report = ts.verify(strict=True)
    assert report.checked["maint_views"] >= 1


# ----------------------------------------------------------------------
# executor, session and CLI entry points on the seeded LUBM universe
# ----------------------------------------------------------------------
def test_workload_executor_analyze_matches_jax():
    jd, td = _dags()
    n_tt = len(_triples())
    jrep = JWorkload(jd, JStore(_triples()).stats, {}).analyze(n_tt=n_tt)
    trep = TWorkload(td, TStore(_triples()).stats, {},
                     device="cpu").analyze(n_tt=n_tt)
    _same_report(jrep, trep)
    assert trep.clean() and trep.checked["buckets"] > 0


@pytest.fixture(scope="module")
def lubm():
    """JAX and port sessions on `generate(2, seed=0)` and the LUBM
    workload, verified unapplied, applied, and with a live maintainer
    after one seeded batch; then one view's device count bumped."""
    ju = generate(n_universities=2, seed=0)
    tu = tgen.generate(n_universities=2, seed=0)
    js = JSession(ju.store, lubm_workload(ju.dictionary), schema=ju.schema,
                  type_id=ju.type_id, cfg=JConfig(search=JSearch(**SEARCH)))
    ts = TSession(tu.store, tgen.lubm_workload(tu.dictionary),
                  schema=tu.schema, type_id=tu.type_id,
                  cfg=TConfig(search=TSearch(**SEARCH)), device="cpu")
    out = {}
    for s in (js, ts):
        s.retune()
    out["unapplied"] = (JA.verify_session(js), TA.verify_session(ts))
    out["state"] = (JA.analyze_state(js.best, js.store.stats),
                    TA.analyze_state(ts.best, ts.store.stats,
                                     device="cpu"))
    for s in (js, ts):
        s.apply()
    out["applied"] = (JA.verify_session(js), TA.verify_session(ts))

    # the program's real operands against abstract_args, cache key too
    ex = ts.executor
    prog = ex.workload._program()
    seen = _recorded_keys(prog, lambda: ex.workload.run(ex.tt,
                                                        ex.device_views))
    out["keys"] = (prog, seen, int(ex.tt["spo"].shape[0]),
                   {vid: rel.cap for vid, rel in ex.device_views.items()})

    rng = np.random.default_rng(7)
    triples = ts.store.triples
    ins = triples[rng.choice(len(triples), 48, replace=False)].copy()
    ins[:, 0] = rng.choice(triples[:, 0], 48)
    dels = triples[rng.choice(len(triples), 24, replace=False)]
    for s in (js, ts):
        s.maintainer()
        rep = s.ingest(ins, dels)
        assert sum(rep.appended.values()) > 0
        assert sum(rep.removed.values()) > 0
    out["maintained"] = (JA.verify_session(js), TA.verify_session(ts))

    # a planted fault: one view's device count off by one
    oracle = ts.maintainer().plans.oracle_vids
    vid = min(v for v in ex.device_views if v not in oracle)
    jrel = js.executor.device_views[vid]
    js.executor.device_views[vid] = jrel._replace(n=jrel.n + 1)
    trel = ts.executor.device_views[vid]
    trel.n.add_(1)
    try:
        out["fault"] = (JA.verify_session(js), TA.verify_session(ts), vid)
        with pytest.raises(InvariantViolation, match="maint/alignment"):
            ts.verify(strict=True)
    finally:
        js.executor.device_views[vid] = jrel
        trel.n.sub_(1)
    out["healed"] = ts.verify(strict=True)
    return out


@pytest.mark.parametrize("stage", ["unapplied", "state", "applied",
                                   "maintained"])
def test_verify_session_matches_jax(lubm, stage):
    jrep, trep = lubm[stage]
    _same_report(jrep, trep)
    assert trep.clean(), trep.format()
    assert trep.checked["nodes"] > 0 and trep.checked["buckets"] > 0
    assert trep.checked["maint_views"] > 0


def test_planted_alignment_fault_is_reported(lubm):
    jrep, trep, vid = lubm["fault"]
    _same_report(jrep, trep)
    assert _keys(trep.findings) == [
        ("maint", "maint/alignment", "error", f"view {vid}")]
    assert lubm["healed"].clean()


def test_abstract_args_match_the_sessions_program(lubm):
    prog, seen, n_tt, view_caps = lubm["keys"]
    assert any(b.kind == "join" for b in prog.buckets)
    _assert_abstract_keys(prog, seen, n_tt, view_caps)


def test_session_verify_before_retune_raises():
    ts = TSession(TStore(_triples()), [], device="cpu")
    with pytest.raises(RuntimeError, match="retune"):
        ts.verify()


def test_cli_rules_only_passes(capsys):
    assert tcli.run(["--rules-only", "--strict"]) == 0
    assert "analysis: clean" in capsys.readouterr().out


def test_cli_gate_matches_jax(capsys):
    assert tcli.run(["--strict", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "analysis: clean" in out
    args = ["--no-rules", "--json", "--max-states", "20"]
    assert jcli.run(args) == 0
    jout = capsys.readouterr().out
    assert tcli.run(args + ["--device", "cpu"]) == 0
    tout = capsys.readouterr().out
    jrep, trep = json.loads(jout), json.loads(tout)
    assert trep["checked"] == jrep["checked"]
    assert trep["findings"] == jrep["findings"] == []


def test_cli_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-CUDA error cannot show")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.run(["--no-rules"])
