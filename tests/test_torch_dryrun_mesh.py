"""The port's dry-run on the production meshes, as one device's program,
against the JAX dry-run on 512 pinned host devices.

`launch.mesh.per_device(mesh)` makes rank 0 of a fake process group of
256 (pod1) or 512 (pod2) ranks; a cell's arguments are its meta DTensor
shards and `flops_audit.count` counts its local ops and collectives.  The
JAX side runs once, in a subprocess that pins 512 host devices as
`repro/launch/dryrun.py` does (`jax_ref`): `make_production_mesh`, the
per-device argument bytes of every smoke template (the sums of
`NamedSharding.shard_shape`, no compile), the light cases of
`tests/test_dryrun.py` at batch 32 compiled (`memory_analysis`,
`parse_collectives`), the sharded sum of that test and the paper cell
at 2^24 triples.  Held exactly: argument bytes, prefill and decode
output bytes, the sharded sum's collectives, the paper cell's argument
bytes and collectives.  Flops, temp bytes and the LM cells' collectives
are the port's own partitioning (DTensor's, not GSPMD's); both are
printed.  Where `jax.jit` refuses an argument sharding (a dimension that
does not divide: the smoke MoE, zamba2 and gemma3's decode cache on a
16-wide model axis), the port's `NamedSharding.local` raises too.

Two programs are also run by value on real gloo CPU ranks (spawned, a
file store, 120 s): the paper program over 4 ranks against
`paper_reference` and the stacked program, and the expert-parallel MoE
of granite-moe-smoke over 8 ranks of (2, 4) against the stacked
`_moe_expert_parallel`.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import torch.distributed as dist  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.configs import get_smoke_config, list_archs  # noqa: E402
from repro_torch.distributed.sharding import (DEFAULT_RULES,  # noqa: E402
                                              NamedSharding, P, axis_ctx,
                                              placements, shard_act)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import flops_audit as FA  # noqa: E402
from repro_torch.launch import shapes as S  # noqa: E402
from repro_torch.launch.mesh import (make_production_mesh,  # noqa: E402
                                     per_device)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = ("pod1", "pod2")
KINDS = {"train": "train_4k", "prefill": "prefill_32k",
         "decode": "decode_32k"}
SMOKE = dict(seq=64, batch=32)
# tests/test_dryrun.py's light CASES, at batch 32 (it divides 16 and 32)
CASES = [("qwen2.5-32b", "train_4k", 64), ("zamba2-1.2b", "decode_32k", 128),
         ("whisper-base", "prefill_32k", 64),
         ("granite-moe-1b-a400m", "train_4k", 64)]
PAPER_N = 1 << 24

JAX_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import json, math, sys
import jax, jax.numpy as jnp, numpy as np
import repro.launch.dryrun as JD
from repro.launch.mesh import make_production_mesh
from repro.launch import shapes as JS, roofline as RL
from repro.configs import get_smoke_config, list_archs

KINDS, SMOKE, CASES, PAPER_N = json.loads(sys.argv[1])
out = {"mesh": {}, "tmpl": {}, "case": {}, "paper": {}}


def cell(arch, shape, mesh, seq, batch):
    saved = dict(JS.SHAPES[shape])
    JS.SHAPES[shape].update(seq=seq, batch=batch)
    try:
        return JS.make_cell(arch, shape, mesh, cfg=get_smoke_config(arch))
    finally:
        JS.SHAPES[shape] = saved


for pod in ("pod1", "pod2"):
    mesh = make_production_mesh(multi_pod=pod == "pod2")
    out["mesh"][pod] = [list(mesh.axis_names),
                        [int(mesh.shape[a]) for a in mesh.axis_names]]
    for arch in list_archs():
        for kind, shape in KINDS.items():
            c = cell(arch, shape, mesh, SMOKE["seq"], SMOKE["batch"])
            try:
                out["tmpl"][f"{arch} {kind} {pod}"] = sum(
                    math.prod(sh.shard_shape(x.shape))
                    * np.dtype(x.dtype).itemsize
                    for x, sh in zip(jax.tree.leaves(c.args),
                                     jax.tree.leaves(c.in_shardings)))
            except ValueError as e:
                out["tmpl"][f"{arch} {kind} {pod}"] = "refused: " + str(e)
    for arch, shape, seq in CASES:
        c = cell(arch, shape, mesh, seq, SMOKE["batch"])
        try:
            comp = jax.jit(c.fn, in_shardings=c.in_shardings,
                           donate_argnums=c.donate).lower(*c.args).compile()
        except ValueError as e:
            out["case"][f"{arch} {shape} {pod}"] = "refused: " + str(e)
            continue
        mem = comp.memory_analysis()
        coll = RL.parse_collectives(comp.as_text())
        out["case"][f"{arch} {shape} {pod}"] = dict(
            args=int(mem.argument_size_in_bytes),
            out=int(mem.output_size_in_bytes),
            temp=int(mem.temp_size_in_bytes), coll=coll.bytes_by_op,
            count=coll.count_by_op)
    r = JD.run_paper_cell(pod == "pod2", n_triples=PAPER_N)
    out["paper"][pod] = dict(memory=r["memory"],
                             coll=r["roofline"]["collective_detail"],
                             flops=r["roofline"]["flops_per_device"],
                             bytes=r["roofline"]["hbm_bytes_per_device"])

from jax.sharding import NamedSharding, PartitionSpec as P
mesh = make_production_mesh()
def f(x):
    return jax.lax.with_sharding_constraint(
        x.sum(axis=0, keepdims=True), NamedSharding(mesh, P()))
x = jax.ShapeDtypeStruct((64, 128), jnp.float32)
comp = jax.jit(f, in_shardings=NamedSharding(mesh, P("data", "model"))
               ).lower(x).compile()
st = RL.parse_collectives(comp.as_text())
out["sum"] = dict(coll=st.bytes_by_op, count=st.count_by_op)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_ref():
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    arg = json.dumps([KINDS, SMOKE, CASES, PAPER_N])
    res = subprocess.run([sys.executable, "-c", JAX_SCRIPT, arg], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.splitlines()[-1])


@pytest.fixture(autouse=True)
def no_group_left():
    """Every trace leaves no process group behind."""
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


@pytest.fixture
def smoke_shapes():
    saved = {k: dict(v) for k, v in S.SHAPES.items()}
    yield
    for k, v in saved.items():
        S.SHAPES[k].clear()
        S.SHAPES[k].update(v)


def _cell(arch, shape, pod, seq, batch, cfg=None):
    """(mesh, cell) of a smoke config at (seq, batch); the caller holds
    the mesh's per_device context."""
    S.SHAPES[shape].update(seq=seq, batch=batch)
    mesh = DR.production(pod)
    return mesh, cfg or get_smoke_config(arch)


# ----------------------------------------------------------------------
# meshes and argument shards
# ----------------------------------------------------------------------
def test_production_meshes_as_jax(jax_ref):
    for pod in MESHES:
        mesh = make_production_mesh(multi_pod=pod == "pod2", device="cpu")
        assert [list(mesh.axis_names), list(mesh.shape.values())] \
            == jax_ref["mesh"][pod]
        with per_device(mesh) as dm:
            assert dm.mesh_dim_names == mesh.axis_names
            assert tuple(dm.shape) == tuple(mesh.shape.values())
            assert dist.get_world_size() == math.prod(mesh.shape.values())
            assert dist.get_rank() == 0 and mesh.root_mesh is dm
            lay = mesh.device_mesh
            if pod == "pod1":
                assert lay is dm
            else:
                assert lay.mesh_dim_names == ("pod.data", "model")
                assert tuple(lay.shape) == (32, 16)
        assert mesh.device_mesh is None and mesh.root_mesh is None


def test_per_device_refuses_a_live_group(tmp_path):
    mesh = make_production_mesh(device="cpu")
    dist.init_process_group("gloo", rank=0, world_size=1,
                            init_method=f"file://{tmp_path}/store")
    try:
        with pytest.raises(RuntimeError, match="already"):
            with per_device(mesh):
                pass
    finally:
        dist.destroy_process_group()


def test_placements_split_major_to_minor():
    """("pod", "data") on one dimension: Shard on both mesh dims, pod
    major (DTensor's order when the axes come in mesh order)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = make_production_mesh(multi_pod=True, device="cpu")
    with per_device(mesh) as dm:
        assert placements(P(("pod", "data"), None, "model"), dm) == [
            Shard(0), Shard(0), Shard(2)]
        assert placements(P(), dm) == [Replicate()] * 3
        with pytest.raises(ValueError, match="order"):
            placements(P(("data", "pod")), dm)
        x = NamedSharding(mesh, P(("pod", "data"), "model")).local(
            (64, 32), torch.bfloat16)
        assert tuple(x.shape) == (64, 32)
        assert tuple(x.to_local().shape) == (2, 2)
        with pytest.raises(ValueError, match="divisible"):
            NamedSharding(mesh, P(None, "model")).local((4, 4), torch.float32)


@pytest.mark.parametrize("pod", MESHES)
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("arch", list_archs())
def test_template_argument_bytes_equal_jax(arch, kind, pod, jax_ref,
                                           smoke_shapes):
    """Every argument of the smoke cell laid out as JAX lays it: the
    sum of rank 0's shard bytes equals the sum of JAX's `shard_shape`s
    (a decode cell's position, a host int here, is JAX's 4-byte scalar).
    Where JAX refuses a sharding, the port raises ValueError."""
    want = jax_ref["tmpl"][f"{arch} {kind} {pod}"]
    shape = KINDS[kind]
    mesh, cfg = _cell(arch, shape, pod, **SMOKE)
    with per_device(mesh):
        if isinstance(want, str):
            assert want.startswith("refused")
            with pytest.raises(ValueError, match="divisible"):
                S.make_cell(arch, shape, mesh, cfg=cfg)
            return
        cell = S.make_cell(arch, shape, mesh, cfg=cfg)
        got = FA.tree_bytes(cell.args)
    assert got + (DR.POSITION_BYTES if kind == "decode" else 0) == want


def test_mesh_dims_of_the_merged_layout():
    """pod2's DTensors lie on ("pod.data", "model"): an entry splits
    whole dims of it, in order; pod or data alone is refused."""
    from repro_torch.distributed.sharding import mesh_dims

    mesh = make_production_mesh(multi_pod=True, device="cpu")
    with per_device(mesh) as root:
        lay = mesh.device_mesh
        assert mesh_dims(lay, ("pod", "data")) == [0]
        assert mesh_dims(lay, ("pod", "data", "model")) == [0, 1]
        assert mesh_dims(lay, ("model",)) == [1]
        assert mesh_dims(root, ("pod", "data")) == [0, 1]
        for bad in (("data",), ("model", "pod", "data")):
            with pytest.raises(ValueError):
                mesh_dims(lay, bad)


@pytest.mark.parametrize("shape,size,shards,moved", [
    ((32, 64, 64), [32, 64, 4, 16], {2: 16}, {2}),       # 4 % 16
    ((32, 64, 64), [32, 64, 16, 4], {2: 16}, set()),     # 16 % 16
    ((32, 64, 4, 16), [32, 64, 64], {2: 16}, {2}),       # 4 % 16
    ((2, 3, 4), [6, 4], {1: 3}, {1}),                    # into dim 0
    ((2, 3, 4), [6, 4], {0: 2}, set()),                  # outermost
    ((2, 3, 4), [2, -1], {1: 3}, set()),
    ((8, 1, 5), [8, 5], {0: 8}, set()),                  # kept whole
    ((32, 64, 4, 16), [32, 64, 64], {0: 16, 3: 16}, {3}),
])
def test_reshaped_dims(shape, size, shards, moved):
    """The split dims a reshape must gather first (`view_gathers`),
    decided from the shard counts and the target size alone: a split
    dim flattened into an outer one, or flattened or unflattened where
    it or its leading part does not divide by its shard count."""
    from repro_torch.distributed.sharding import view_gathers

    assert view_gathers(shape, size, shards) == moved


def test_uneven_view_gathers_are_counted():
    """On pod1, an unflatten of a model-split dim into 4 x 16 (4 does not
    divide by 16) is taken after one all-gather of that dim, counted by
    `count` as a view gather whose bytes `coll` includes; an unflatten
    into 16 x 4 keeps the split and issues nothing; a size that is no
    view of the shape raises."""
    mesh = make_production_mesh(device="cpu")
    with per_device(mesh):
        x = NamedSharding(mesh, P("data", None, "model")).local(
            (32, 64, 64), torch.float32)

        def fn(x, size):
            with axis_ctx(mesh, DEFAULT_RULES):
                return x.view(*size)

        kept = FA.count(fn, x, (32, 64, 16, 4))
        gathered = FA.count(fn, x, (32, 64, 4, 16))
        with pytest.raises((RuntimeError, ValueError)):
            fn(x, (32, 64, 5, 16))
    assert kept["view_gathers"] == 0 and kept["coll"] == 0
    local = 2 * 64 * 64 * 4          # rank 0's (2, 64, 64) after the gather
    assert gathered["view_gathers"] == 1
    assert gathered["view_gather_bytes"] == local
    assert gathered["coll_by_op"] == {"all-gather": local}
    assert gathered["coll_count_by_op"] == {"all-gather": 1}


def test_expert_parallel_train_step_per_device(smoke_shapes):
    """A granite-moe-smoke train step with 16 experts on pod1: the EP
    body runs under `local_map` on rank 0's expert (its router logits
    gathered, its output summed over the model axis, both backwards
    too), and the per-group decomposition equals the full trace."""
    base = get_smoke_config("granite-moe-1b-a400m")
    cfg = dataclasses.replace(base, n_layers=3 * len(base.block_pattern),
                              moe=dataclasses.replace(base.moe,
                                                      n_experts=16))
    S.SHAPES["train_4k"].update(seq=64, batch=32)
    mesh = make_production_mesh(device="cpu")
    with per_device(mesh):
        cell = S.make_cell("granite-moe-1b-a400m", "train_4k", mesh, cfg=cfg)
        full = FA.count(cell.fn, *cell.args)
        got = FA.corrected_costs("granite-moe-1b-a400m", "train_4k", mesh,
                                 cfg=cfg)
    assert {"all-gather", "all-reduce"} <= set(full["coll_by_op"])
    for k in ("flops", "bytes", "coll"):
        assert got[k] == full[k] > 0, k


# ----------------------------------------------------------------------
# compiled light cases
# ----------------------------------------------------------------------
@pytest.mark.parametrize("pod", MESHES)
@pytest.mark.parametrize("arch,shape,seq", CASES)
def test_light_cases_against_compiled_jax(arch, shape, seq, pod, jax_ref,
                                          smoke_shapes, capsys):
    """Argument bytes (the shards the program reads) equal JAX's
    `memory_analysis()`; prefill and decode output bytes too; both
    packages issue collectives (the port's and JAX's bytes printed).
    Where `jax.jit` refuses the shardings, the port refuses them."""
    want = jax_ref["case"][f"{arch} {shape} {pod}"]
    mesh, cfg = _cell(arch, shape, pod, seq, SMOKE["batch"])
    with per_device(mesh):
        if isinstance(want, str):
            assert want.startswith("refused")
            with pytest.raises(ValueError, match="divisible"):
                S.make_cell(arch, shape, mesh, cfg=cfg)
            return
        cell = S.make_cell(arch, shape, mesh, cfg=cfg)
        got = FA.count(cell.fn, *cell.args)
    kind = S.SHAPES[shape]["kind"]
    args = got["args_read"] + (DR.POSITION_BYTES if kind == "decode" else 0)
    assert args == want["args"]
    if kind != "train":
        assert got["out"] == want["out"]
    assert got["coll"] > 0 and sum(want["coll"].values()) > 0
    assert got["flops"] > 0 and got["bytes"] > 0
    assert set(got["coll_by_op"]) == set(got["coll_count_by_op"])
    with capsys.disabled():
        print(f"\n{arch} {shape} {pod}: port coll {got['coll_by_op']} "
              f"{got['coll_count_by_op']}, temp {got['temp']:.0f}; JAX coll "
              f"{want['coll']} {want['count']}, temp {want['temp']}")


def test_sharded_sum_collectives_equal_jax(jax_ref):
    """tests/test_dryrun.py's sharded sum on (16, 16), constrained to be
    replicated: the partial sum over `data` all-reduced on rank 0's 8
    columns (32 bytes), then the `model` split gathered (512), as XLA
    partitions it (`sharding.redistribute` reduces before it gathers)."""
    mesh = make_production_mesh(device="cpu")

    def f(x):
        with axis_ctx(mesh, DEFAULT_RULES):
            return shard_act(x.sum(dim=0, keepdim=True), (None, None))

    with per_device(mesh):
        x = NamedSharding(mesh, P("data", "model")).local((64, 128),
                                                          torch.float32)
        got = FA.count(f, x)
    assert got["coll_by_op"] == jax_ref["sum"]["coll"]
    assert got["coll_count_by_op"] == jax_ref["sum"]["count"]


def test_matmul_flops_are_the_local_shards():
    """One matmul on (16, 16): rank 0 multiplies its (B/16, K) rows by
    its (K, N/16) columns, global / 256 flops; FlopCounterMode around
    the DTensor op would count the global product."""
    mesh = make_production_mesh(device="cpu")
    B, K, N = 256, 512, 1024
    with per_device(mesh):
        x = NamedSharding(mesh, P("data")).local((B, K), torch.bfloat16)
        w = NamedSharding(mesh, P(None, "model")).local((K, N),
                                                        torch.bfloat16)
        got = FA.count(lambda a, b: a @ b, x, w)
        with FlopCounterMode(display=False) as fc:
            x @ w
    assert got["flops"] * 256 == 2 * B * K * N == fc.get_total_flops()
    assert got["coll"] == 0 and got["args_read"] == (B * K + K * N) * 2 / 16


def test_grad_norm_reduces_over_the_mesh():
    """`clip_by_global_norm` on DTensor gradients: each leaf's sum of
    squares is a partial sum over the mesh dims that split it, reduced
    (4-byte all-reduces) before the square root, so the norm and the
    scale are replicated, as in JAX's jitted step."""
    from torch.distributed.tensor import Replicate

    from repro_torch.train.optimizer import clip_by_global_norm

    mesh = make_production_mesh(device="cpu")
    with per_device(mesh):
        grads = {"a": NamedSharding(mesh, P("data", "model")).local(
                     (64, 128), torch.float32),
                 "b": NamedSharding(mesh, P(None, "model")).local(
                     (32, 32), torch.float32)}
        got = FA.count(lambda g: clip_by_global_norm(g, 1.0), grads)
        clipped, norm = clip_by_global_norm(grads, 1.0)
        assert list(norm.placements) == [Replicate(), Replicate()]
        assert clipped["a"].placements == grads["a"].placements
    assert set(got["coll_by_op"]) == {"all-reduce"}
    assert got["coll_by_op"]["all-reduce"] == \
        4 * got["coll_count_by_op"]["all-reduce"]


def test_chunked_attention_runs_on_each_devices_heads(smoke_shapes):
    """`flash_attention` under a production mesh: its DTensor rule runs
    the kernel's op on rank 0's shard.  gemma3-smoke's 4 / 2 heads do
    not divide the 16-wide model axis, so heads are gathered and the
    batch stays split: each layer's op sees (32 / 16, 64, 4, hd)."""
    B, S_ = 32, 64
    cfg = dataclasses.replace(get_smoke_config("gemma3-12b"),
                              attn_impl="chunked", attn_chunk=16)
    mesh, cfg = _cell("gemma3-12b", "prefill_32k", "pod1", S_, B, cfg)
    seen = []
    with per_device(mesh):
        cell = S.make_cell("gemma3-12b", "prefill_32k", mesh, cfg=cfg)
        real = torch.ops.repro_torch.flash_attention.default
        got = FA.count(cell.fn, *cell.args)
        with _OpShapes(real, seen):
            cell.fn(*cell.args)
    per_layer = [ops.attention_flops(B // 16, S_, cfg.n_heads, cfg.hd,
                                     cfg.window if k == "swa" else 0)
                 for k in cfg.block_pattern]
    assert len(seen) == cfg.n_layers
    assert all(s == (B // 16, S_, cfg.n_heads, cfg.hd) for s in seen), seen
    assert got["flops"] >= cfg.n_groups * sum(per_layer) > 0


class _OpShapes(torch.utils._python_dispatch.TorchDispatchMode):
    """Records the local shapes `op` is called with."""

    def __init__(self, op, into):
        super().__init__()
        self.op, self.into = op, into

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if func is self.op:
            self.into.append(tuple(args[0].shape))
        return func(*args, **(kwargs or {}))


# ----------------------------------------------------------------------
# the paper cell
# ----------------------------------------------------------------------
@pytest.mark.parametrize("pod", MESHES)
def test_paper_cell_per_device_equals_jax(pod, jax_ref):
    """The star join at 2^24 triples: rank 0 reads 2 of the 6 TT
    indexes (26,443,776 bytes, JAX's argument bytes), exchanges once
    (`all_to_all_single`) and ORs its overflow flag once (a 4-byte
    `all_reduce`), as JAX's program does.  XLA's CPU all-to-all is a
    tuple of 16 operands and `parse_collectives` reads the first, one
    destination's bucket: the port counts the whole output, 16 times
    it.  JAX's output bytes add the 8-byte index table of its 3-leaf
    output tuple."""
    want = jax_ref["paper"][pod]
    res = DR.run_paper_cell(mesh=pod, n_triples=PAPER_N)
    assert res["chips"] == (256 if pod == "pod1" else 512)
    assert res["mesh"] == pod and res["shards"] == 16
    mem = res["memory"]
    assert mem["argument_bytes"] == want["memory"]["argument_bytes"] \
        == 2 * res["rows_per_shard"] * 3 * 4 == 26_443_776
    assert mem["output_bytes"] + 3 * 8 == want["memory"]["output_bytes"]
    det = res["roofline"]["collective_detail"]
    assert det["count"] == want["coll"]["count"] == {"all-to-all": 1,
                                                     "all-reduce": 1}
    assert det["bytes"]["all-reduce"] == want["coll"]["bytes"]["all-reduce"] \
        == 4
    assert det["bytes"]["all-to-all"] == 16 * want["coll"]["bytes"][
        "all-to-all"] == 16 * 1_572_864
    assert res["exchanges"] == 1 and res["elided"] == 3


# ----------------------------------------------------------------------
# by value on gloo ranks
# ----------------------------------------------------------------------
WORKER = r"""
import os, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

OUT = sys.argv[2]


def paper(rank, world):
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import Mesh
    from repro_torch.query import distributed as D
    from repro_torch.rdf.triples import TripleStore
    from torch.distributed.device_mesh import init_device_mesh

    n = 1 << 16
    triples = DR.paper_triples(n, seed=0)
    stacked = Mesh({"data": world}, torch.device("cpu"))
    tt = D.shard_store_by_subject(TripleStore(triples), stacked)
    mesh = Mesh({"data": world}, torch.device("cpu"))
    mesh.device_mesh = init_device_mesh("cpu", (world,),
                                        mesh_dim_names=("data",))
    fn, ndev, _ = DR.paper_program(n, torch.device("cpu"), mesh)
    assert ndev == world
    out = fn({k: v[rank] for k, v in tt.items()}, {})
    np.savez(os.path.join(OUT, f"paper{rank}.npz"), data=out.data.numpy(),
             n=out.n.numpy(), overflow=out.overflow.numpy())


def moe(rank, world):
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import (DEFAULT_RULES, axis_ctx,
                                                  placements, spec_for)
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import layers as L
    from repro_torch.models.params import init_params, tree_map
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    dm = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    cpu = torch.device("cpu")
    base = get_smoke_config("granite-moe-1b-a400m")
    for cf in (8.0, 0.5):
        cfg = dataclasses.replace(base, moe=dataclasses.replace(
            base.moe, capacity_factor=cf))
        tmpl = L.moe_template(cfg)
        p = init_params(tmpl, torch.Generator().manual_seed(0),
                        torch.float32, cpu)
        x = torch.randn((4, 16, cfg.d_model),
                        generator=torch.Generator().manual_seed(1))
        with axis_ctx(Mesh({"data": 2, "model": 4}, cpu), DEFAULT_RULES):
            want = L.moe(p, cfg, x)
        mesh = Mesh({"data": 2, "model": 4}, cpu, dm)

        def shard(t, axes):
            return distribute_tensor(t, dm, placements(
                spec_for(axes, DEFAULT_RULES, mesh), dm))

        pd = tree_map(lambda s, t: shard(t, s.axes), tmpl, p)
        with axis_ctx(mesh, DEFAULT_RULES):
            got = L.moe(pd, cfg, shard(x, ("batch", None, None)))
        got = got.full_tensor()
        if rank == 0:
            np.save(os.path.join(OUT, f"moe_{cf}.npy"),
                    np.stack([got.numpy(), want.numpy()]))


def main(rank, world, which):
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            init_method="file://" + os.path.join(OUT, "store"))
    try:
        {"paper": paper, "moe": moe}[which](rank, world)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    which, world = sys.argv[1], int(sys.argv[3])
    mp.spawn(main, args=(world, which), nprocs=world, join=True)
"""


def _spawn(which: str, world: int, tmp_path) -> None:
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, str(script), which, str(tmp_path),
                          str(world)], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]


def test_paper_program_on_gloo_ranks(tmp_path):
    """The per-device paper program at 2^16 triples over 4 gloo ranks
    (data 4): the ranks' outputs gathered equal `paper_reference` and
    the stacked program's answer; no overflow."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.query import distributed as D
    from repro_torch.query.engine import PRel
    from repro_torch.rdf.triples import TripleStore

    world = 4
    _spawn("paper", world, tmp_path)
    outs = [np.load(tmp_path / f"paper{r}.npz") for r in range(world)]
    assert not any(o["overflow"].any() for o in outs)
    rel = PRel(torch.from_numpy(np.stack([o["data"] for o in outs])),
               torch.from_numpy(np.concatenate([o["n"] for o in outs])),
               torch.zeros(world, dtype=torch.bool))
    got = D.gather_result(rel)
    n = 1 << 16
    triples = DR.paper_triples(n, seed=0)
    want = DR.paper_reference(triples)
    assert len(want) > 1000
    np.testing.assert_array_equal(got, want)
    stacked = Mesh({"data": world}, torch.device("cpu"))
    fn, _, _ = DR.paper_program(n, torch.device("cpu"), stacked)
    tt = D.shard_store_by_subject(TripleStore(triples), stacked)
    np.testing.assert_array_equal(D.gather_result(fn(tt, {})), got)


def test_expert_parallel_on_gloo_ranks(tmp_path):
    """granite-moe-smoke's MoE layer over 8 gloo ranks of (data 2, model
    4): the per-device EP body under `local_map`, its router logits
    gathered and its output summed by collectives, equals the stacked
    `_moe_expert_parallel` at capacity factors 8.0 and 0.5 to 1e-6."""
    _spawn("moe", 8, tmp_path)
    for cf in (8.0, 0.5):
        got, want = np.load(tmp_path / f"moe_{cf}.npy")
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
