"""The port's logical-axis sharding (`repro_torch.distributed.sharding`),
the train-state and batch sharding trees, and `checkpoint.restore(
shardings=)` against the JAX package's, on the CPU.

The JAX side runs once, in a subprocess whose host platform shows eight
devices: `spec_for`, `mesh_axes_of`, `param_shardings`,
`train_state_shardings` and `batch_shardings` for every smoke config's
template under every rule table on the meshes (8,) data, (2, 4)
data/model and (2, 2, 2) pod/data/model, written as lists of spec
entries; `data_axis_names`; and the checkpoint cases: a checkpoint JAX
writes (read here onto the port's shardings), the port's checkpoint
restored by JAX onto its NamedShardings, and the errors JAX raises for
a dimension that does not divide and for a shardings tree of another
leaf count.  JAX's restore cannot place a bf16 leaf on a sharding at all
(`device_put` refuses the stored `|V2` words, whichever package wrote
them), so the port-to-JAX case holds fp32 and int32 leaves; the port
restores bf16 leaves bitwise.  The port's meshes are shards stacked on
the CPU (`make_mesh(..., device="cpu")`); every spec is held equal to
JAX's entry for entry.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import checkpoint as C  # noqa: E402
from repro_torch.configs import get_smoke_config, list_archs  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.distributed.fault import TrainSupervisor  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402
from repro_torch.train.train_step import (TrainConfig,  # noqa: E402
                                          batch_shardings,
                                          train_state_shardings)

ROOT = Path(__file__).resolve().parents[1]
RULES = ("DEFAULT_RULES", "FSDP_RULES", "SEQ_RULES", "DECODE_RULES",
         "LONG_RULES")
MESHES = {"8": ((8,), ("data",)), "2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
# logical axes beyond the templates': conflicts, repeats, unknown names
EXTRA_AXES = [("batch", "batch"), ("embed", "embed"), ("batch", "seq", "embed"),
              ("seq_cache", "batch"), ("heads", "mlp"), (None, "vocab"),
              ("expert", "embed", "mlp"), ("unknown",), ("state_feat", "kv_heads"),
              ("batch", "seq", "vocab"), ("seq", "batch"), ()]
LOGICAL = ("batch", "seq", "embed", "heads", "kv", "kv_heads", "mlp", "vocab",
           "expert", "layer", "seq_cache", "state_feat", "unknown")
BATCH = {"tokens": (4, 16), "labels": (4, 16), "positions": (4, 16, 3),
         "enc_frames": (4, 8, 80)}
JAX_TIMEOUT_S = 300

SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.checkpoint import checkpoint as C
from repro.configs import get_smoke_config, list_archs
from repro.distributed import sharding as SH
from repro.launch.mesh import data_axis_names, make_mesh
from repro.models.model import build_model
from repro.models.params import is_spec
from repro.train.train_step import (TrainConfig, batch_shardings,
                                    train_state_shardings)

OUT, PORT_CKPT = sys.argv[1:3]
RULES, MESHES, EXTRA, LOGICAL, BATCH = (json.loads(a) for a in sys.argv[3:8])


def spec(p):
    return [list(e) if isinstance(e, tuple) else e for e in p]


def specs(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda s: isinstance(s, NamedSharding))[0]
    return {jax.tree_util.keystr(k): spec(s.spec) for k, s in flat}


meshes = {n: make_mesh(tuple(s), tuple(a)) for n, (s, a) in MESHES.items()}
rec = {"data_axis_names": {n: list(data_axis_names(m))
                           for n, m in meshes.items()},
       "spec_for": {}, "mesh_axes_of": {}, "params": {}, "state": {},
       "batch": {}}
axes_seen = {tuple(a) for a in EXTRA}
models = {arch: build_model(get_smoke_config(arch)) for arch in list_archs()}
for model in models.values():
    for _, s in jax.tree_util.tree_flatten_with_path(
            model.template, is_leaf=is_spec)[0]:
        axes_seen.add(tuple(s.axes))
axes_seen = sorted(axes_seen, key=repr)
rec["axes"] = [list(a) for a in axes_seen]
tc = TrainConfig()
batch = {k: np.zeros(s, np.int32) for k, s in BATCH.items()}
for rn in RULES:
    rules = getattr(SH, rn)
    for mn, mesh in meshes.items():
        key = f"{rn}/{mn}"
        rec["spec_for"][key] = [spec(SH.spec_for(a, rules, mesh))
                                for a in axes_seen]
        with SH.axis_ctx(mesh, rules):
            rec["mesh_axes_of"][key] = {a: list(SH.mesh_axes_of(a))
                                        for a in LOGICAL}
        rec["batch"][key] = specs(batch_shardings(mesh, batch, rules))
        for arch, model in models.items():
            rec["params"][f"{key}/{arch}"] = specs(
                SH.param_shardings(model.template, rules, mesh))
            rec["state"][f"{key}/{arch}"] = specs(
                train_state_shardings(model, tc, mesh, rules))

# checkpoints: JAX writes one for the port; JAX restores the port's
state = {"params": {"w": np.arange(32, dtype=np.float32).reshape(8, 4) / 3,
                    "b": (np.arange(8, dtype=np.float32) / 7).astype(
                        jnp.bfloat16)},
         "opt": {"step": np.asarray(5, np.int32)}}
C.save(os.path.join(OUT, "jax_ckpt"), 2, state)
target = {"params": {"w": np.zeros((8, 4), np.float32),
                     "v": np.zeros((4, 8), np.float32)},
          "opt": {"step": np.zeros((), np.int32)}}
rec["from_port"] = {}
arrays = {}
for n in (2, 4):
    mesh = make_mesh((n,), ("data",))
    sh = {"params": {"w": NamedSharding(mesh, P("data")),
                     "v": NamedSharding(mesh, P(None, "data"))},
          "opt": {"step": NamedSharding(mesh, P())}}
    got = C.restore(PORT_CKPT, 3, target, sh)
    for k, v in (("w", got["params"]["w"]), ("v", got["params"]["v"]),
                 ("step", got["opt"]["step"])):
        arrays[f"{n}/{k}"] = np.asarray(v)
        rec["from_port"][f"{n}/{k}"] = {
            "spec": spec(v.sharding.spec), "dtype": str(v.dtype),
            "shard": list(v.addressable_shards[0].data.shape)}
mesh2 = make_mesh((2,), ("data",))
try:
    jax.device_put(np.zeros((3, 4), np.float32), NamedSharding(mesh2, P("data")))
except ValueError as e:
    rec["indivisible"] = str(e)
try:
    C.restore(PORT_CKPT, 3, target, {"params": {"w": NamedSharding(mesh2, P())}})
except ValueError as e:
    rec["leaf_count"] = str(e)
np.savez(os.path.join(OUT, "from_port.npz"), **arrays)
with open(os.path.join(OUT, "record.json"), "w") as f:
    json.dump(rec, f)
"""

PORT_STATE = {"params": {"w": np.arange(32, dtype=np.float32).reshape(8, 4) * 1.5,
                         "v": np.linspace(-1, 1, 32, dtype=np.float32).reshape(4, 8)},
              "opt": {"step": np.asarray(7, np.int32)}}


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX package's specs and checkpoint cases, computed once; the
    port's checkpoint (step 3 of PORT_STATE) is written first."""
    out = tmp_path_factory.mktemp("jax_sharding")
    C.save(str(out / "port_ckpt"), 3, PORT_STATE)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    meshes = {n: [list(s), list(a)] for n, (s, a) in MESHES.items()}
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(out), str(out / "port_ckpt"),
         json.dumps(RULES), json.dumps(meshes), json.dumps(EXTRA_AXES),
         json.dumps(LOGICAL), json.dumps(BATCH)],
        capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=JAX_TIMEOUT_S)
    assert res.returncode == 0, f"STDOUT:\n{res.stdout}\nSTDERR:\n{res.stderr}"
    arrays = np.load(out / "from_port.npz")
    return (json.loads((out / "record.json").read_text()),
            {k: arrays[k] for k in arrays.files}, out)


def _mesh(name: str):
    shape, axes = MESHES[name]
    return M.make_mesh(shape, axes, device="cpu")


def _spec(p) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in p]


def _specs(tree) -> dict:
    """{keystr path: spec entries} of a NamedSharding tree."""
    paths, leaves = C._flatten_with_paths(tree)
    return {p: _spec(s.spec) for p, s in zip(paths, leaves)}


CELLS = [(r, m) for r in RULES for m in MESHES]


@pytest.mark.parametrize("rules,mesh", CELLS)
def test_spec_for_matches_jax(jax_side, rules, mesh):
    """Every logical-axes tuple of every smoke template, and the conflict
    cases, resolve to JAX's PartitionSpec; `mesh_axes_of` likewise."""
    rec, _, _ = jax_side
    table, m = getattr(SH, rules), _mesh(mesh)
    got = [_spec(SH.spec_for(tuple(a), table, m)) for a in rec["axes"]]
    assert got == rec["spec_for"][f"{rules}/{mesh}"]
    with SH.axis_ctx(m, table):
        axes = {a: list(SH.mesh_axes_of(a)) for a in LOGICAL}
    assert axes == rec["mesh_axes_of"][f"{rules}/{mesh}"]
    assert SH.active_ctx() is None and SH.mesh_axes_of("batch") == ()


@pytest.mark.parametrize("arch", sorted(list_archs()))
def test_param_and_train_state_shardings_match_jax(jax_side, arch):
    """`param_shardings` of the template and `train_state_shardings` of
    the model, leaf for leaf, under every rule table on every mesh."""
    rec, _, _ = jax_side
    model = build_model(get_smoke_config(arch), device="cpu")
    for rules, mesh in CELLS:
        table, m = getattr(SH, rules), _mesh(mesh)
        key = f"{rules}/{mesh}/{arch}"
        assert _specs(SH.param_shardings(model.template, table, m)) \
            == rec["params"][key], key
        state = train_state_shardings(model, TrainConfig(), m, table)
        assert _specs(state) == rec["state"][key], key
        assert all(s.mesh is m for _, s in tree_leaves(state))


@pytest.mark.parametrize("rules,mesh", CELLS)
def test_batch_shardings_match_jax(jax_side, rules, mesh):
    rec, _, _ = jax_side
    batch = {k: torch.zeros(s, dtype=torch.int32) for k, s in BATCH.items()}
    got = batch_shardings(_mesh(mesh), batch, getattr(SH, rules))
    assert _specs(got) == rec["batch"][f"{rules}/{mesh}"]


def test_defaults_and_data_axis_names(jax_side):
    rec, _, _ = jax_side
    m = _mesh("2x4")
    model = build_model(get_smoke_config("granite-moe-1b-a400m"),
                        device="cpu")
    assert _specs(train_state_shardings(model, TrainConfig(), m)) == \
        _specs(train_state_shardings(model, TrainConfig(), m,
                                     SH.DEFAULT_RULES))
    for name in MESHES:
        assert list(M.data_axis_names(_mesh(name))) == \
            rec["data_axis_names"][name]


def test_rule_tables_live_in_sharding():
    """`launch/shapes.py` takes its tables from `distributed/sharding.py`,
    as the JAX module imports them."""
    from repro_torch.launch import shapes

    for name in RULES:
        assert getattr(shapes, name) is getattr(SH, name)


def test_partition_spec_and_shard_shape():
    P = SH.PartitionSpec
    assert P("data", None) == P("data") == ("data",)
    assert P(None, None) == P() == ()
    assert P(None, ("pod", "data")) == (None, ("pod", "data"))
    with pytest.raises(TypeError):
        P("data")[0] = "model"
    m = _mesh("2x2x2")
    assert SH.NamedSharding(m, P(("pod", "data"), "model")).shard_shape(
        (8, 6)) == (2, 3)
    assert SH.NamedSharding(m, P()).shard_shape((3, 5)) == (3, 5)
    with pytest.raises(ValueError, match="divisible by 4"):
        SH.NamedSharding(m, P(None, ("pod", "data"))).shard_shape((2, 6))
    with pytest.raises(ValueError, match="lacks"):
        SH.NamedSharding(_mesh("8"), P("model")).shard_shape((8,))
    with pytest.raises(ValueError, match="rank"):
        SH.NamedSharding(m, P("data", "model")).shard_shape((8,))


def test_shard_act_is_the_identity():
    """Outside a context `shard_act` returns its input; inside one it
    resolves the spec and returns the input unchanged (the same
    tensor); the contexts nest and unwind."""
    x = torch.randn(2, 3, 4)
    assert SH.shard_act(x, ("batch", "seq", "embed")) is x
    outer, inner = _mesh("2x4"), _mesh("8")
    with SH.axis_ctx(outer, SH.DEFAULT_RULES):
        assert SH.shard_act(x, ("batch", "seq", "embed")) is x
        with SH.axis_ctx(inner, SH.LONG_RULES):
            assert SH.active_ctx() == (inner, SH.LONG_RULES)
            assert SH.mesh_axes_of("seq_cache") == ("data",)
        assert SH.active_ctx() == (outer, SH.DEFAULT_RULES)
        with pytest.raises(ValueError, match="does not fit"):
            SH.shard_act(torch.zeros(4), ("batch", "heads"))
    assert SH.active_ctx() is None


def _bf16_state():
    g = torch.Generator().manual_seed(3)
    return {"params": {"w": torch.randn(4, 4, generator=g),
                       "e": torch.randn(8, 6, generator=g).to(torch.bfloat16)},
            "opt": {"step": torch.tensor(2, dtype=torch.int32)}}


@pytest.mark.parametrize("ndev", [1, 2, 4])
def test_elastic_restore_new_mesh(tmp_path, ndev):
    """Twin of `test_elastic_restore_new_mesh`: save unsharded, restore
    onto a mesh of 1, 2 or 4 shards stacked on the CPU; every leaf comes
    back bitwise (fp32 and bf16), a tensor on the mesh's device."""
    state = _bf16_state()
    d = str(tmp_path / "elastic")
    C.save(d, 1, state)
    mesh = M.make_host_mesh(ndev, device="cpu")
    sh = {"params": {"w": SH.NamedSharding(mesh, SH.P("data")),
                     "e": SH.NamedSharding(mesh, SH.P(None, "data"))},
          "opt": {"step": SH.NamedSharding(mesh, SH.P())}}
    if ndev == 4:   # 6 columns do not divide over 4 shards
        with pytest.raises(ValueError, match="divisible by 4"):
            C.restore(d, 1, state, sh)
        sh["params"]["e"] = SH.NamedSharding(mesh, SH.P("data"))
    got = C.restore(d, 1, state, sh)
    for (path, want), (_, x) in zip(tree_leaves(state), tree_leaves(got)):
        assert x.dtype == want.dtype and x.device == mesh.device, path
        assert torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16
                           else x, want.view(torch.int16)
                           if want.dtype == torch.bfloat16 else want), path


def test_restore_errors_are_jaxs(jax_side, tmp_path):
    """A dimension of 3 on a 2-shard axis and a shardings tree of another
    leaf count raise JAX's ValueError, message for message (the
    sharding's own text aside)."""
    rec, _, out = jax_side
    C.save(str(tmp_path), 1, {"x": np.zeros((3, 4), np.float32)})
    mesh2 = M.make_host_mesh(2, device="cpu")
    with pytest.raises(ValueError) as e:
        C.restore(str(tmp_path), 1, {"x": None},
                  {"x": SH.NamedSharding(mesh2, SH.P("data"))})
    tail = "implies that the global size of"
    assert str(e.value).split(tail)[1] == rec["indivisible"].split(tail)[1]
    target = {"params": {"w": None, "v": None}, "opt": {"step": None}}
    with pytest.raises(ValueError) as e:
        C.restore(str(out / "port_ckpt"), 3, target,
                  {"params": {"w": SH.NamedSharding(mesh2, SH.P())}})
    assert str(e.value) == rec["leaf_count"]


def test_jax_checkpoint_restores_onto_port_shardings(jax_side):
    """What JAX saved (fp32, bf16, int32) comes back bitwise onto the
    port's shardings of a (4, 2) mesh."""
    _, _, out = jax_side
    mesh = M.make_mesh((4, 2), ("data", "model"), device="cpu")
    sh = {"params": {"w": SH.NamedSharding(mesh, SH.P("data", "model")),
                     "b": SH.NamedSharding(mesh, SH.P("data"))},
          "opt": {"step": SH.NamedSharding(mesh, SH.P())}}
    target = {"params": {"w": None, "b": None}, "opt": {"step": None}}
    got = C.restore(str(out / "jax_ckpt"), 2, target, sh)
    w = np.arange(32, dtype=np.float32).reshape(8, 4) / 3
    assert torch.equal(got["params"]["w"], torch.from_numpy(w))
    b = torch.from_numpy(np.arange(8, dtype=np.float32) / 7).to(torch.bfloat16)
    assert got["params"]["b"].dtype == torch.bfloat16
    assert torch.equal(got["params"]["b"].view(torch.int16),
                       b.view(torch.int16))
    assert got["opt"]["step"].dtype == torch.int32
    assert int(got["opt"]["step"]) == 5


def test_port_checkpoint_restores_onto_jax_shardings(jax_side):
    """What the port saved comes back in JAX onto NamedShardings of 2 and
    4 devices, equal to the saved values, with the shard shapes the
    port's `shard_shape` gives for the same specs."""
    rec, arrays, _ = jax_side
    for n in (2, 4):
        mesh = M.make_host_mesh(n, device="cpu")
        specs = {"w": SH.P("data"), "v": SH.P(None, "data"), "step": SH.P()}
        for k, want in (("w", PORT_STATE["params"]["w"]),
                        ("v", PORT_STATE["params"]["v"]),
                        ("step", PORT_STATE["opt"]["step"])):
            np.testing.assert_array_equal(arrays[f"{n}/{k}"], want)
            got = rec["from_port"][f"{n}/{k}"]
            assert got["dtype"] == str(want.dtype)
            assert got["spec"] == _spec(specs[k])
            assert got["shard"] == list(SH.NamedSharding(
                mesh, specs[k]).shard_shape(want.shape))


def test_resume_or_init_takes_shardings(tmp_path):
    """`TrainSupervisor.resume_or_init(shardings=)` restores the last
    committed train state onto `train_state_shardings` of another mesh
    shape."""
    model = build_model(get_smoke_config("granite-moe-1b-a400m"),
                        device="cpu")
    tc = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2, total_steps=10))
    from repro_torch.train.train_step import init_train_state

    state = init_train_state(model, tc)
    sup = TrainSupervisor(str(tmp_path), save_every=2)
    sup.maybe_save(2, state)
    mesh = M.make_mesh((4, 2), ("data", "model"), device="cpu")
    got, step = sup.resume_or_init(
        lambda: init_train_state(model, tc),
        shardings=train_state_shardings(model, tc, mesh))
    assert step == 2
    for (path, want), (_, x) in zip(tree_leaves(state), tree_leaves(got)):
        assert torch.equal(x, want), path
