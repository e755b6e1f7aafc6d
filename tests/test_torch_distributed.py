"""The port's sharded engine and `ShardedBackend` against the JAX package's.

Twins of `tests/test_distributed_query.py` and `tests/test_sharded_serve.py`.
The JAX side runs once, in a subprocess whose host platform shows eight
devices (as those tests run it), and writes every per-shard output (data,
`n`, `overflow`), every gathered set and the backend's record to a
directory.  The port runs here, in-process, over `make_host_mesh(8,
device="cpu")`: eight shards stacked on the CPU, where `join_count` takes
its plain version.  Each case is held equal per shard, row for row, and
its gathered set equal to the port's `ref_engine`.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import QueryClass, SearchConfig, TuningSession, WizardConfig  # noqa: E402
from repro_torch.core.queries import CQ, Atom, Const, Var  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.query import distributed as D  # noqa: E402
from repro_torch.query import ref_engine as R  # noqa: E402
from repro_torch.query.cost import RelInfo  # noqa: E402
from repro_torch.query.plan import EquiJoin, Project, ViewRef, plan_for_cq  # noqa: E402
from repro_torch.rdf.generator import generate, lubm_workload  # noqa: E402
from repro_torch.rdf.triples import TripleStore  # noqa: E402
from repro_torch.serve.frontend import FixedServiceModel  # noqa: E402
from repro_torch.serve.sharded import ShardedBackend  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
NDEV = 8
QUERIES = ("q1", "q2", "q3", "q4", "q5", "q6")
SMALL = dict(n_universities=1, seed=0, dept_per_univ=2, prof_per_dept=4,
             stud_per_dept=12, course_per_dept=5)
SEARCH = dict(strategy="greedy", max_states=60)
STEPS = ("healthy", "corrupt", "restore")

# The JAX side: every case of the two JAX tests, with its per-shard
# outputs, written to OUT.  Plan cases build their views exactly as
# tests/test_distributed_query.py does.
SCRIPT = r"""
import dataclasses, json, os, re, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax

from repro.api import QueryClass, SearchConfig, TuningSession, WizardConfig
from repro.core.queries import CQ, Atom, Const, Var
from repro.launch.mesh import make_mesh
from repro.query import distributed as D
from repro.query import ref_engine as R
from repro.query.cost import RelInfo
from repro.query.plan import EquiJoin, Project, ViewRef, plan_for_cq
from repro.rdf.generator import generate, lubm_workload
from repro.rdf.triples import TripleStore
from repro.serve.frontend import FixedServiceModel
from repro.serve.sharded import ShardedBackend

OUT = sys.argv[1]
SMALL = json.loads(sys.argv[2])
SEARCH = json.loads(sys.argv[3])
mesh = make_mesh((8,), ("data",))
arrays, record = {}, {}


def keep(key, rel, lowered=None):
    arrays[key + "/data"] = np.asarray(rel.data)
    arrays[key + "/n"] = np.asarray(rel.n)
    arrays[key + "/overflow"] = np.asarray(rel.overflow)
    record[key] = {
        "set": sorted(map(list, {tuple(r) for r in
                                 D.gather_result(rel).tolist()})),
        # HLO spells the op all-to-all, StableHLO all_to_all
        "all_to_all": None if lowered is None
        else re.search(r"all[-_]to[-_]all", lowered.as_text()) is not None}


def run(key, fn, tt, views):
    keep(key, jax.jit(fn)(tt, views), lowered=jax.jit(fn).lower(tt, views))


uni = generate(n_universities=2, seed=0)
tt = D.shard_store_by_subject(uni.store, mesh)
for q in lubm_workload(uni.dictionary):
    fn = D.build_distributed_executor(plan_for_cq(q), uni.store.stats, {},
                                      mesh)
    run(q.name, fn, tt, {})

d = uni.dictionary
x, y, z = Var("x"), Var("y"), Var("z")
cq_a = CQ((x, y), (Atom(x, Const(d.lookup("ub:takesCourse")), y),), name="va")
cq_b = CQ((z, y), (Atom(z, Const(d.lookup("ub:teacherOf")), y),), name="vb")
cq_c = CQ((x, y), (Atom(x, Const(d.lookup("ub:memberOf")), y),), name="vc")
ext_a = R.evaluate_cq(cq_a, uni.store)
ext_b = R.evaluate_cq(cq_b, uni.store)
ext_c = R.evaluate_cq(cq_c, uni.store)
views = {0: D.shard_prel_rows(ext_a.rows, 0, mesh),
         1: D.shard_prel_rows(ext_b.rows, 0, mesh)}
infos = {0: RelInfo(float(len(ext_a.rows)), {"x": 300.0, "y": 60.0}),
         1: RelInfo(float(len(ext_b.rows)), {"z": 40.0, "y": 60.0})}
plan = Project(EquiJoin(ViewRef(0, ("x", "y")), ViewRef(1, ("z", "y")),
                        (("y", "y"),)), ("x", "z"))
run("view_join", D.build_distributed_executor(
    plan, uni.store.stats, infos, mesh, partition_cols={0: "x", 1: "z"}),
    tt, views)
views2 = {0: D.shard_prel_rows(ext_a.rows, 0, mesh),
          1: D.shard_prel_rows(ext_c.rows, 0, mesh)}
infos2 = {0: RelInfo(float(len(ext_a.rows)), {"x": 300.0, "y": 60.0}),
          1: RelInfo(float(len(ext_c.rows)), {"x": 300.0, "y": 6.0})}
plan2 = EquiJoin(ViewRef(0, ("x", "y")), ViewRef(1, ("x", "w")), (("x", "x"),))
run("copartition", D.build_distributed_executor(
    plan2, uni.store.stats, infos2, mesh, partition_cols={0: "x", 1: "x"}),
    tt, views2)

# empty shards
tiny = TripleStore(np.array([[0, 1, 2], [8, 1, 3]], np.int32))
tt_t, shards_t = D.shard_store_by_subject(tiny, mesh, with_shards=True)
record["tiny_shards"] = [len(s) for s in shards_t]
q = CQ((x, y), (Atom(x, Const(1), y),), name="tiny")
run("ndev_gt_subjects", D.build_distributed_executor(
    plan_for_cq(q), tiny.stats, {}, mesh), tt_t, {})
empty = TripleStore(np.zeros((0, 3), np.int32))
run("empty_store", D.build_distributed_executor(
    plan_for_cq(q), empty.stats, {}, mesh),
    D.shard_store_by_subject(empty, mesh), {})
for key, rows in (("degenerate_1d", np.array([], np.int32)),
                  ("degenerate_2d", np.zeros((0, 3), np.int32))):
    keep(key, D.shard_prel_rows(rows, 0, mesh, width=3))

# the backend: healthy -> corrupt_shard(3) -> restore_shard(3)
small = generate(**SMALL)
s = TuningSession(small.store, lubm_workload(small.dictionary)[:4],
                  schema=small.schema, type_id=small.type_id,
                  cfg=WizardConfig(search=SearchConfig(**SEARCH)))
s.retune()
s.apply()
names = [q.name for q in s.workload]
be = ShardedBackend(s.executor, mesh=mesh)
steps = {}
for step in ("healthy", "corrupt", "restore"):
    if step == "corrupt":
        be.corrupt_shard(3)
    if step == "restore":
        be.restore_shard(3)
    got = be.answer_batch(names + ["no_such_query"])
    steps[step] = {
        "answers": [None if a is None else sorted(map(list, a)) for a in got],
        "health": be.supervisor.health, "readiness": be.readiness(),
        "stats": dataclasses.asdict(be.stats)}
record["backend"] = steps
fe = s.serve_async(sharded=True, mesh=mesh, classes=[QueryClass("c")],
                   service_model=FixedServiceModel(0.002, 0.0005))
for i, n in enumerate(names * 2):
    fe.offer(n, t=i * 0.001)
fe.flush()
record["serve_async"] = {
    "completed": fe.stats.completed, "admitted": fe.stats.admitted,
    "readiness": fe.readiness(),
    "answers": [sorted(map(list, fe.server.answer(n))) for n in names]}
np.savez(os.path.join(OUT, "arrays.npz"), **arrays)
with open(os.path.join(OUT, "record.json"), "w") as f:
    json.dump(record, f, default=str)
"""


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX package's outputs of every case, computed once."""
    out = tmp_path_factory.mktemp("jax_sharded")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(out), json.dumps(SMALL),
         json.dumps(SEARCH)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert res.returncode == 0, f"STDOUT:\n{res.stdout}\nSTDERR:\n{res.stderr}"
    arrays = np.load(out / "arrays.npz")
    return {k: arrays[k] for k in arrays.files}, \
        json.loads((out / "record.json").read_text())


def _json(obj):
    return json.loads(json.dumps(obj, default=str))


def _rows(rel) -> list:
    return sorted(map(list, {tuple(r) for r in D.gather_result(rel).tolist()}))


def _same_per_shard(rel, jax_side, key):
    """Data, counts and flags of every shard equal the JAX package's."""
    arrays, record = jax_side
    ndev, cap, w = rel.data.shape
    np.testing.assert_array_equal(rel.data.numpy().reshape(ndev * cap, w),
                                  arrays[key + "/data"])
    np.testing.assert_array_equal(rel.n.numpy(), arrays[key + "/n"])
    np.testing.assert_array_equal(
        np.broadcast_to(rel.overflow.numpy(), (ndev,)),
        np.broadcast_to(arrays[key + "/overflow"], (ndev,)))
    assert _rows(rel) == record[key]["set"]


@pytest.fixture(scope="module")
def mesh():
    return make_host_mesh(NDEV, device="cpu")


@pytest.fixture(scope="module")
def uni():
    return generate(n_universities=2, seed=0)


@pytest.fixture(scope="module")
def tt(uni, mesh):
    return D.shard_store_by_subject(uni.store, mesh)


# ----------------------------------------------------------------------
# the engine (tests/test_distributed_query.py)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", QUERIES)
def test_lubm_query_per_shard(jax_side, uni, mesh, tt, name):
    q = {q.name: q for q in lubm_workload(uni.dictionary)}[name]
    fn = D.build_distributed_executor(plan_for_cq(q), uni.store.stats, {},
                                      mesh)
    out = fn(tt, {})
    assert not bool(out.overflow.any()), f"{name} overflowed"
    _same_per_shard(out, jax_side, name)
    assert _rows(out) == sorted(map(list, R.evaluate_cq(q, uni.store).as_set()))
    # an exchange in the port where the JAX program has an all_to_all
    assert (fn.exchanges > 0) == jax_side[1][name]["all_to_all"]


def _view_case(uni, mesh, case):
    d = uni.dictionary
    x, y, z = Var("x"), Var("y"), Var("z")
    cq_a = CQ((x, y), (Atom(x, Const(d.lookup("ub:takesCourse")), y),),
              name="va")
    ext_a = R.evaluate_cq(cq_a, uni.store)
    if case == "view_join":
        # extent A sharded by x, B by z: the join on y repartitions both
        cq_b = CQ((z, y), (Atom(z, Const(d.lookup("ub:teacherOf")), y),),
                  name="vb")
        ext_b = R.evaluate_cq(cq_b, uni.store)
        infos = {0: RelInfo(float(len(ext_a.rows)), {"x": 300.0, "y": 60.0}),
                 1: RelInfo(float(len(ext_b.rows)), {"z": 40.0, "y": 60.0})}
        plan = Project(EquiJoin(ViewRef(0, ("x", "y")),
                                ViewRef(1, ("z", "y")), (("y", "y"),)),
                       ("x", "z"))
        parts = {0: "x", 1: "z"}
    else:
        # two subject-sharded views joined on the subject: no exchange
        cq_c = CQ((x, y), (Atom(x, Const(d.lookup("ub:memberOf")), y),),
                  name="vc")
        ext_b = R.evaluate_cq(cq_c, uni.store)
        infos = {0: RelInfo(float(len(ext_a.rows)), {"x": 300.0, "y": 60.0}),
                 1: RelInfo(float(len(ext_b.rows)), {"x": 300.0, "y": 6.0})}
        plan = EquiJoin(ViewRef(0, ("x", "y")), ViewRef(1, ("x", "w")),
                        (("x", "x"),))
        parts = {0: "x", 1: "x"}
    views = {0: D.shard_prel_rows(ext_a.rows, 0, mesh),
             1: D.shard_prel_rows(ext_b.rows, 0, mesh)}
    fn = D.build_distributed_executor(plan, uni.store.stats, infos, mesh,
                                      partition_cols=parts)
    want = R.execute(plan, uni.store, {0: ext_a, 1: ext_b}).as_set()
    return fn, views, want


@pytest.mark.parametrize("case", ("view_join", "copartition"))
def test_view_plan_per_shard(jax_side, uni, mesh, tt, case):
    fn, views, want = _view_case(uni, mesh, case)
    out = fn(tt, views)
    assert not bool(out.overflow.any())
    _same_per_shard(out, jax_side, case)
    assert _rows(out) == sorted(map(list, want))
    assert (fn.exchanges > 0) == jax_side[1][case]["all_to_all"]
    if case == "copartition":
        assert (fn.exchanges, fn.elided) == (0, 2)
    else:
        assert (fn.exchanges, fn.elided) == (2, 0)


def test_join_probes_launch_once_for_all_shards(uni, mesh, tt, monkeypatch):
    """The sharded program's join probes go through the kernel wrapper,
    one call for all shards (B = ndev), with the executor's default
    `use_kernels=True`."""
    shapes = []
    real = tops.join_count

    def counting(probe, build):
        shapes.append((tuple(probe.shape), tuple(build.shape)))
        return real(probe, build)

    monkeypatch.setattr(tops, "join_count", counting)
    fn, views, want = _view_case(uni, mesh, "view_join")
    assert _rows(fn(tt, views)) == sorted(map(list, want))
    assert len(shapes) == 1
    assert shapes[0][0][0] == shapes[0][1][0] == NDEV


@pytest.mark.parametrize("case", ("ndev_gt_subjects", "empty_store",
                                  "degenerate_1d", "degenerate_2d"))
def test_empty_shards(jax_side, mesh, case):
    x, y = Var("x"), Var("y")
    q = CQ((x, y), (Atom(x, Const(1), y),), name="tiny")
    if case.startswith("degenerate"):
        rows = np.array([], np.int32) if case == "degenerate_1d" \
            else np.zeros((0, 3), np.int32)
        pr = D.shard_prel_rows(rows, 0, mesh, width=3)
        assert pr.data.shape == (NDEV, 128, 3)
        assert int(pr.n.sum()) == 0 and not bool(pr.overflow.any())
        _same_per_shard(pr, jax_side, case)
        return
    if case == "ndev_gt_subjects":
        # both triples hash to shard 0; shards 1-7 are empty but valid
        store = TripleStore(np.array([[0, 1, 2], [8, 1, 3]], np.int32))
        tt_s, shards = D.shard_store_by_subject(store, mesh, with_shards=True)
        assert [len(s) for s in shards] == jax_side[1]["tiny_shards"] \
            == [2, 0, 0, 0, 0, 0, 0, 0]
    else:
        store = TripleStore(np.zeros((0, 3), np.int32))
        tt_s = D.shard_store_by_subject(store, mesh)
    out = D.build_distributed_executor(plan_for_cq(q), store.stats, {},
                                       mesh)(tt_s, {})
    assert not bool(out.overflow.any())
    _same_per_shard(out, jax_side, case)
    assert _rows(out) == sorted(map(list, R.evaluate_cq(q, store).as_set()))


# ----------------------------------------------------------------------
# the backend (tests/test_sharded_serve.py)
# ----------------------------------------------------------------------
def _small_session():
    small = generate(**SMALL)
    s = TuningSession(small.store, lubm_workload(small.dictionary)[:4],
                      schema=small.schema, type_id=small.type_id,
                      cfg=WizardConfig(search=SearchConfig(**SEARCH)),
                      device="cpu")
    s.retune()
    s.apply()
    return s


@pytest.fixture(scope="module")
def session():
    return _small_session()


@pytest.fixture(scope="module")
def backend_steps(session, mesh):
    """healthy -> corrupt_shard(3) -> restore_shard(3) on the port."""
    names = [q.name for q in session.workload]
    be = ShardedBackend(session.executor, mesh=mesh)
    steps = {}
    for step in STEPS:
        if step == "corrupt":
            be.corrupt_shard(3)
        if step == "restore":
            be.restore_shard(3)
        got = be.answer_batch(names + ["no_such_query"])
        steps[step] = {
            "answers": [None if a is None else sorted(map(list, a))
                        for a in got],
            "health": be.supervisor.health, "readiness": be.readiness(),
            "stats": dataclasses.asdict(be.stats)}
    return steps


@pytest.mark.parametrize("step", STEPS)
def test_backend_sequence_equals_jax(jax_side, session, backend_steps, step):
    got, want = _json(backend_steps[step]), jax_side[1]["backend"][step]
    names = [q.name for q in session.workload]
    direct = [sorted(map(list, session.executor.answer_group_direct(n)))
              for n in names]
    assert got["answers"] == want["answers"] == _json(direct) + [None]
    assert got["health"] == want["health"] == \
        {"healthy": "HEALTHY", "corrupt": "DEGRADED",
         "restore": "HEALTHY"}[step]
    assert got["readiness"] == want["readiness"]
    assert got["stats"] == want["stats"]
    if step == "corrupt":
        r = got["readiness"]
        assert r["ready"] and r["quorum"] and r["shards"]["3"] == "DEGRADED"
        assert all(h == "HEALTHY" for d, h in r["shards"].items() if d != "3")


def test_serve_async_sharded(jax_side, session, mesh):
    fe = session.serve_async(sharded=True, mesh=mesh,
                             classes=[QueryClass("c")],
                             service_model=FixedServiceModel(0.002, 0.0005))
    assert isinstance(fe.server, ShardedBackend)
    names = [q.name for q in session.workload]
    for i, n in enumerate(names * 2):
        fe.offer(n, t=i * 0.001)
    fe.flush()
    got = _json({
        "completed": fe.stats.completed, "admitted": fe.stats.admitted,
        "readiness": fe.readiness(),
        "answers": [sorted(map(list, fe.server.answer(n))) for n in names]})
    assert got == jax_side[1]["serve_async"]
    assert got["completed"] == got["admitted"] == 2 * len(names)
    r = got["readiness"]
    assert r["health"] == "HEALTHY" and r["quorum"] and r["queue_depth"] == 0


def test_sharded_serving_rejects_maintenance(session, mesh):
    with pytest.raises(ValueError, match="static-store"):
        session.serve_async(sharded=True, mesh=mesh, maintenance=True)


@pytest.mark.parametrize("where", ("program", "probe"))
def test_device_fault_at_readback_takes_server_down(mesh, monkeypatch, where):
    """A fault of the card, raised as PyTorch raises it at a read-back
    (of the sharded program's result, or of the integrity probe's
    counts), takes every shard and the server DOWN and is re-raised; the
    host reference engine never answers."""
    s = _small_session()
    ex = s.executor
    be = ShardedBackend(ex, mesh=mesh)
    names = [q.name for q in s.workload]
    be.answer_batch(names)
    direct_calls = [0]
    real_direct = ex.answer_group_direct

    def direct(name):
        direct_calls[0] += 1
        return real_direct(name)

    monkeypatch.setattr(ex, "answer_group_direct", direct)
    fault = {"on": where == "probe", "hit": 0}
    real_cpu = torch.Tensor.cpu

    def read_back(self, *args, **kwargs):
        if fault["on"]:
            fault["hit"] += 1
            raise getattr(torch, "AcceleratorError", RuntimeError)(
                "CUDA error: an illegal memory access was encountered")
        return real_cpu(self, *args, **kwargs)

    real_probe = be._probe

    def probe():
        out = real_probe()
        fault["on"] = True        # the program runs next; its read-back faults
        return out

    monkeypatch.setattr(torch.Tensor, "cpu", read_back)
    if where == "program":
        monkeypatch.setattr(be, "_probe", probe)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        be.answer_batch(names)
    assert fault["hit"] == 1
    assert direct_calls[0] == 0
    assert be.supervisor.health == "DOWN" and be.stats.health == "DOWN"
    assert be.stats.served_tier == -1 and be.stats.fused_failures == 0
    r = be.readiness()
    assert not r["ready"] and not r["quorum"]
    assert set(r["shards"].values()) == {"DOWN"}


def test_make_host_mesh_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-CUDA error cannot show")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_host_mesh()
    m = make_host_mesh(device="cpu")
    assert m.shape == {"data": 1} and m.axis_names == ("data",)
    assert make_host_mesh(NDEV, "x", device="cpu").shape["x"] == NDEV
