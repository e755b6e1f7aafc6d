"""Persistence in the port against the JAX package: the array
checkpointer (`repro_torch.checkpoint`), the wizard config's JSON and
`TuningSession.save` / `load` (twins of the persistence cases of
tests/test_session.py).  A session saved by either package loads in the
other with the same workload, best state, groups, config and objective,
and after `apply()` gives the same answers."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import QualityWeights as JWeights  # noqa: E402
from repro.api import SearchConfig as JSearch  # noqa: E402
from repro.api import TuningSession as JSession  # noqa: E402
from repro.api import WizardConfig as JConfig  # noqa: E402
from repro.api import serde as jserde  # noqa: E402
from repro.checkpoint import checkpoint as jckpt  # noqa: E402
from repro.rdf.generator import generate, lubm_workload  # noqa: E402
from repro_torch.api import QualityWeights as TWeights  # noqa: E402
from repro_torch.api import SearchConfig as TSearch  # noqa: E402
from repro_torch.api import TuningSession as TSession  # noqa: E402
from repro_torch.api import WizardConfig as TConfig  # noqa: E402
from repro_torch.api import serde as tserde  # noqa: E402
from repro_torch.checkpoint import checkpoint as tckpt  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.rdf import generator as tgen  # noqa: E402


# ----------------------------------------------------------------------
# the array checkpointer
# ----------------------------------------------------------------------
def _state(rng):
    return {"triples": rng.integers(0, 9, (7, 3)).astype(np.int32),
            "b": rng.standard_normal((2, 3)).astype(np.float32),
            "a": np.zeros((0, 2), np.int64)}


def test_paths_spelled_as_jax_keystr():
    state = _state(np.random.default_rng(0))
    jpaths, jleaves, _ = jckpt._flatten_with_paths(state)
    tpaths, tleaves = tckpt._flatten_with_paths(state)
    assert tpaths == jpaths == ["['a']", "['b']", "['triples']"]
    for a, b in zip(tleaves, jleaves):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_round_trip_across_packages(tmp_path, writer):
    state = _state(np.random.default_rng(1))
    save, restore = ((tckpt.save, jckpt.restore) if writer == "port"
                     else (jckpt.save, tckpt.restore))
    path = save(str(tmp_path), 3, state)
    assert path.endswith("step_00000003")
    assert sorted(os.listdir(path)) == ["arrays.npz", "manifest.json"]
    back = restore(str(tmp_path), 3, {k: np.zeros(0) for k in state})
    assert sorted(back) == sorted(state)
    for k, v in state.items():
        np.testing.assert_array_equal(np.asarray(back[k]), v)
        assert np.asarray(back[k]).dtype == v.dtype
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest == {"step": 3, "paths": ["['a']", "['b']", "['triples']"],
                        "shapes": [[0, 2], [2, 3], [7, 3]],
                        "dtypes": ["int64", "float32", "int32"]}


def test_tree_mismatch_and_shardings_refused(tmp_path):
    d = str(tmp_path)
    tckpt.save(d, 0, {"triples": np.arange(6, dtype=np.int32).reshape(2, 3)})
    with pytest.raises(ValueError, match="tree mismatch"):
        tckpt.restore(d, 0, {"other": np.zeros(1)})
    with pytest.raises(ValueError, match="tree mismatch"):
        tckpt.restore(d, 0, {"triples": None, "extra": None})
    # a None sharding is no leaf, as in `jax.tree.leaves`: 0 against 1
    with pytest.raises(ValueError,
                       match="shardings tree has 0 leaves, checkpoint has 1"):
        tckpt.restore(d, 0, {"triples": None}, shardings={"triples": None})


def test_keep_and_latest_step(tmp_path):
    d = str(tmp_path)
    assert tckpt.latest_step(d) is None and tckpt.list_steps(d) == []
    for step in range(5):
        tckpt.save(d, step, {"x": np.full(2, step)}, keep=2)
    assert tckpt.list_steps(d) == [3, 4] == jckpt.list_steps(d)
    assert tckpt.latest_step(d) == 4 == jckpt.latest_step(d)
    np.testing.assert_array_equal(
        tckpt.restore(d, 4, {"x": None})["x"], [4, 4])
    # the target by keyword, under the JAX package's name
    np.testing.assert_array_equal(
        tckpt.restore(d, 3, target_tree={"x": np.zeros(2)})["x"],
        jckpt.restore(d, 3, target_tree={"x": np.zeros(2)})["x"])


def test_atomic_commit_ignores_a_torn_write(tmp_path):
    d = str(tmp_path)
    tckpt.save(d, 0, {"x": np.arange(3)})
    # a write that died before its rename leaves only the .tmp directory
    os.makedirs(os.path.join(d, "step_00000001.tmp"))
    assert tckpt.list_steps(d) == [0] and tckpt.latest_step(d) == 0
    # the next save of that step commits over the leftover
    tckpt.save(d, 1, {"x": np.arange(3) + 1})
    assert sorted(os.listdir(d)) == ["step_00000000", "step_00000001"]
    np.testing.assert_array_equal(
        tckpt.restore(d, 1, {"x": None})["x"], [1, 2, 3])


def _nested(rng):
    """A training-state-like tree: nested dicts, an fp32, a bf16 and an
    int32 0-d leaf; as numpy for JAX (`ml_dtypes` bf16) and as tensors
    for the port, the same values."""
    import ml_dtypes

    w = rng.standard_normal((3, 4)).astype(np.float32)
    h = rng.standard_normal((2, 5)).astype(np.float32)
    h_bf = h.astype(ml_dtypes.bfloat16)
    jtree = {"params": {"w": w, "0:attn": {"h": h_bf}},
             "opt": {"step": np.int32(7), "m": {"w": np.zeros_like(w)}}}
    ttree = {"params": {"w": torch.from_numpy(w),
                        "0:attn": {"h": torch.from_numpy(
                            h_bf.astype(np.float32)).to(torch.bfloat16)}},
             "opt": {"step": torch.tensor(7, dtype=torch.int32),
                     "m": {"w": torch.zeros(3, 4)}}}
    return jtree, ttree


def test_nested_tree_round_trips_with_the_jax_layout(tmp_path):
    """A nested tree with a bf16 leaf and an int32 scalar: the port writes
    the manifest and the npz words JAX writes for the same tree, restores
    its own and JAX's files as tensors (bf16 and int32 kept), and JAX
    restores the port's."""
    jtree, ttree = _nested(np.random.default_rng(4))
    jpath = jckpt.save(str(tmp_path / "jax"), 2, jtree)
    tpath = tckpt.save(str(tmp_path / "port"), 2, ttree)
    manifests = []
    for path in (jpath, tpath):
        with open(os.path.join(path, "manifest.json")) as f:
            manifests.append(json.load(f))
    assert manifests[0] == manifests[1]
    assert manifests[1]["paths"] == [
        "['opt']['m']['w']", "['opt']['step']", "['params']['0:attn']['h']",
        "['params']['w']"]
    assert manifests[1]["dtypes"] == ["float32", "int32", "bfloat16",
                                      "float32"]
    assert manifests[1]["shapes"][1] == []
    jz = np.load(os.path.join(jpath, "arrays.npz"))
    tz = np.load(os.path.join(tpath, "arrays.npz"))
    for i in range(4):
        assert jz[f"a{i}"].tobytes() == tz[f"a{i}"].tobytes()
    for d in (str(tmp_path / "jax"), str(tmp_path / "port")):
        back = tckpt.restore(d, 2, ttree)
        got = dict(zip(*tckpt._flatten_with_paths(back)))
        want = dict(zip(*tckpt._flatten_with_paths(ttree)))
        for path, x in want.items():
            y = got[path]
            assert isinstance(y, torch.Tensor) and y.dtype == x.dtype, path
            assert y.shape == x.shape and torch.equal(y, x), path
    jback = jckpt.restore(str(tmp_path / "port"), 2, jtree)
    np.testing.assert_array_equal(jback["params"]["w"], jtree["params"]["w"])
    assert jback["opt"]["step"].dtype == np.int32 and jback["opt"]["step"] == 7


# ----------------------------------------------------------------------
# the wizard config's JSON
# ----------------------------------------------------------------------
def _search(pkg_search, pkg_weights):
    # weights under which the navigator genuinely iterates (fusion pays)
    return pkg_search(strategy="greedy", max_states=3000,
                      weights=pkg_weights(w_exec=1.0, w_maint=1.0,
                                          w_space=1.0))


def _jcfg(use_pallas=False):
    return JConfig(search=_search(JSearch, JWeights), use_pallas=use_pallas)


def _tcfg(use_kernels=True):
    return TConfig(search=_search(TSearch, TWeights), use_kernels=use_kernels)


@pytest.mark.parametrize("kernels", [False, True])
def test_cfg_json_is_the_jax_packages(kernels):
    tj = tserde.cfg_to_json(_tcfg(kernels))
    jj = jserde.cfg_to_json(_jcfg(kernels))
    assert tj == jj                     # same keys, `use_pallas` included
    assert tserde.cfg_from_json(jj) == _tcfg(kernels)
    assert jserde.cfg_from_json(tj) == _jcfg(kernels)


# ----------------------------------------------------------------------
# sessions saved by either package, loaded by the other
# ----------------------------------------------------------------------
UNI = dict(n_universities=1, seed=0, dept_per_univ=2, prof_per_dept=4,
           stud_per_dept=12, course_per_dept=5)


@pytest.fixture(scope="module")
def uni():
    """The same universe generated by each package from one seed."""
    return generate(**UNI), tgen.generate(**UNI)


@pytest.fixture(scope="module")
def cold_full(uni):
    """Cold tune over the FULL workload — the warm path's baseline."""
    tu = uni[1]
    s = TSession(tu.store, tgen.lubm_workload(tu.dictionary),
                 schema=tu.schema, type_id=tu.type_id, cfg=_tcfg(),
                 device="cpu")
    return s.retune()


def _jsession(ju, n, use_pallas=False):
    return JSession(ju.store, lubm_workload(ju.dictionary)[:n],
                    schema=ju.schema, type_id=ju.type_id,
                    cfg=_jcfg(use_pallas))


def _tsession(tu, n, use_kernels=True):
    return TSession(tu.store, tgen.lubm_workload(tu.dictionary)[:n],
                    schema=tu.schema, type_id=tu.type_id,
                    cfg=_tcfg(use_kernels), device="cpu")


@pytest.fixture
def counted_probes(monkeypatch):
    """Count `ops.join_count` calls (the kernel's wrapper; on the CPU it
    takes the plain version)."""
    calls = [0]
    real = ops.join_count

    def counting(probe, build):
        calls[0] += 1
        return real(probe, build)

    monkeypatch.setattr(ops, "join_count", counting)
    return calls


def _same_session(t, j):
    """A port session `t` and a JAX session `j` hold the same state."""
    assert [tserde.cq_to_json(q) for q in t.workload] == \
        [jserde.cq_to_json(q) for q in j.workload]
    assert tserde.state_to_json(t.best) == jserde.state_to_json(j.best)
    assert t.groups == j.groups
    assert t.best_quality.total == j.best_quality.total
    assert tserde.cfg_to_json(t.cfg) == jserde.cfg_to_json(j.cfg)
    assert t.cfg.use_kernels == j.cfg.use_pallas
    np.testing.assert_array_equal(t.store.triples, j.store.triples)
    assert t.store.dictionary._to_str == j.store.dictionary._to_str


def _same_answers(t, j):
    t.apply()
    j.apply()
    for q in j.workload:
        got = t.answer(q.name)
        assert got == j.answer(q.name), q.name
        assert got == t.executor.answer_group_direct(q.name), q.name


@pytest.mark.parametrize("kernels", [False, True])
def test_jax_saved_session_loads_in_the_port(uni, tmp_path, counted_probes,
                                             kernels):
    js = _jsession(uni[0], 5, use_pallas=kernels)
    js.retune()
    path = js.save(str(tmp_path))
    assert path.endswith("step_00000000")
    ts = TSession.load(str(tmp_path), device="cpu")
    assert ts.device == torch.device("cpu") and ts.executor is None
    _same_session(ts, js)
    assert ts.cfg == _tcfg(kernels)
    _same_answers(ts, js)
    # `use_pallas` says whether the port's probes take the kernel's wrapper
    assert (counted_probes[0] > 0) == kernels


@pytest.mark.parametrize("kernels", [False, True])
def test_port_saved_session_loads_in_jax(uni, tmp_path, kernels):
    ts = _tsession(uni[1], 5, use_kernels=kernels)
    ts.retune()
    path = ts.save(str(tmp_path))
    with open(os.path.join(path, "session.json")) as f:
        payload = json.load(f)
    assert payload["version"] == 1
    assert payload["cfg"]["use_pallas"] is kernels
    assert payload["dictionary"] == list(uni[1].dictionary._to_str)
    back = JSession.load(str(tmp_path))
    _same_session(ts, back)
    assert back.cfg == _jcfg(kernels)
    _same_answers(ts, back)


def test_save_load_roundtrip_resumes_retuning(uni, tmp_path, cold_full):
    tu = uni[1]
    wl = tgen.lubm_workload(tu.dictionary)
    s = _tsession(tu, 5)
    s.retune()
    path = s.save(str(tmp_path))
    assert (tmp_path / "step_00000000" / "session.json").exists()
    assert path.endswith("step_00000000")
    s2 = TSession.load(str(tmp_path), cfg=_tcfg(), device="cpu")
    assert [q.name for q in s2.workload] == [q.name for q in s.workload]
    assert s2.best.key() == s.best.key()
    assert np.array_equal(s2.store.triples, tu.store.triples)
    assert s2.store.dictionary.lookup("ub:takesCourse") == \
        tu.dictionary.lookup("ub:takesCourse")
    # resumed session warm-starts: strictly fewer states than cold
    s2.add_query(wl[5])
    rep = s2.retune()
    assert rep.warm
    assert rep.result.explored < cold_full.result.explored
    s2.apply()
    for q in wl:
        assert s2.answer(q.name) == s2.executor.answer_group_direct(q.name), \
            q.name


def test_saves_keep_the_newest_three_steps(uni, tmp_path):
    s = _tsession(uni[1], 3)
    s.retune()
    d = str(tmp_path)
    for step in range(4):
        assert s.save(d).endswith(f"step_{step:08d}")
    assert tckpt.list_steps(d) == [1, 2, 3]     # the checkpointer's keep=3
    assert TSession.load(d, device="cpu").best.key() == s.best.key()


def test_load_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        TSession.load(str(tmp_path / "void"), device="cpu")


def test_load_restores_config_and_objective(uni, tmp_path):
    s = _tsession(uni[1], 3)
    s.retune()
    s.save(str(tmp_path))
    s2 = TSession.load(str(tmp_path), device="cpu")  # no cfg=: saved one
    w = s2.cfg.search.weights
    assert (w.w_exec, w.w_maint, w.w_space) == (1.0, 1.0, 1.0)
    assert s2.cfg.search.strategy == "greedy"
    assert s2.cfg.search.max_states == 3000
    assert s2.cfg.use_kernels is True
    # same objective => identical recomputed quality for the saved best
    assert abs(s2.best_quality.total - s.best_quality.total) < 1e-6


def test_load_defaults_to_the_card(uni, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-CUDA error cannot show")
    s = _tsession(uni[1], 3)
    s.retune()
    s.save(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TSession.load(str(tmp_path))
