"""The port's dry-run tooling (`repro_torch.launch.{shapes, roofline,
flops_audit, dryrun, report}`) against the JAX package's, on the CPU
and the `meta` device: cells leaf for leaf, matmul flops against the
jaxpr's, the per-group decomposition against the full trace, the
kernels' shape rules and flop formula inside a trace, the paper cell,
the artifacts and the report.  JAX builds its cells on a (1, 1) mesh and
traces jaxprs; nothing is compiled.
"""
import dataclasses
import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.launch.roofline as JRL  # noqa: E402
import repro.launch.shapes as JS  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.configs import get_smoke_config, list_archs  # noqa: E402
from repro_torch.kernels import join_count as jc  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import flops_audit as FA  # noqa: E402
from repro_torch.launch import report as RP  # noqa: E402
from repro_torch.launch import roofline as RL  # noqa: E402
from repro_torch.launch import shapes as S  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import (tree_leaves, tree_map,  # noqa: E402
                                       tree_shapes)
from repro_torch.models.ssm import mamba2_dims, rwkv6_dims  # noqa: E402
from repro_torch.query import distributed as D  # noqa: E402
from repro_torch.rdf.triples import TripleStore  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def shapes_override():
    """Override `SHAPES` entries (for both packages) for one test, as
    `tests/test_dryrun.py` does, and restore them after it."""
    saved = {k: dict(v) for k, v in S.SHAPES.items()}
    jsaved = {k: dict(v) for k, v in JS.SHAPES.items()}

    def override(shape, **kw):
        S.SHAPES[shape].update(kw)
        JS.SHAPES[shape].update(kw)

    yield override
    for k, v in saved.items():
        S.SHAPES[k].clear()
        S.SHAPES[k].update(v)
    for k, v in jsaved.items():
        JS.SHAPES[k].clear()
        JS.SHAPES[k].update(v)


# ----------------------------------------------------------------------
# the twin of test_dryrun_light_subprocess: one cell per kind, smoke
# configs, small shapes, in process
# ----------------------------------------------------------------------
CASES = [
    ("qwen2.5-32b", "train_4k", dict(seq=64, batch=8)),
    ("zamba2-1.2b", "decode_32k", dict(seq=128, batch=8)),
    ("whisper-base", "prefill_32k", dict(seq=64, batch=4)),
    ("granite-moe-1b-a400m", "train_4k", dict(seq=64, batch=8)),
]


@pytest.mark.parametrize("arch,shape,override", CASES)
def test_dryrun_light(arch, shape, override, shapes_override):
    shapes_override(shape, **override)
    cell = S.make_cell(arch, shape, cfg=get_smoke_config(arch))
    counts = FA.count(cell.fn, *cell.args)
    roof = RL.extract(counts, 1, model_flops=1e9)
    assert roof.flops > 0, (arch, shape)
    assert roof.hbm_bytes > 0, (arch, shape)
    assert roof.bottleneck in ("compute", "memory", "collective")
    assert roof.collective_bytes == 0 and counts["temp"] > 0


# ----------------------------------------------------------------------
# cells leaf for leaf against the JAX package's
# ----------------------------------------------------------------------
def _jax_leaves(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            (tuple(x.shape), np.dtype(x.dtype).name) for path, x in flat}


def _port_leaves(tree) -> dict:
    return {path: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for path, x in tree_leaves(tree)}


@pytest.fixture(scope="module")
def jax_mesh():
    return make_mesh((1, 1), ("data", "model"))


@pytest.mark.parametrize("arch,shape", [(a, s) for a in list_archs()
                                        for s in S.SHAPES])
def test_cells_match_jax_leaf_for_leaf(arch, shape, jax_mesh):
    """Every argument leaf of the port's cell (params, train state with
    `m`, `v` and `step`, batch, cache) has the JAX cell's shape and
    dtype; `applicable`, the rule table and `model_flops_for` agree.
    The decode position is a host int in the port (the last cache
    slot), a 0-d int32 in JAX."""
    assert S.applicable(arch, shape) == JS.applicable(arch, shape)
    assert S.rules_for(arch, shape) == JS.rules_for(arch, shape)
    assert S._FSDP_ARCHS == JS._FSDP_ARCHS
    spec = S.SHAPES[shape]
    assert spec == JS.SHAPES[shape]
    jcell = JS.make_cell(arch, shape, jax_mesh)
    cell = S.make_cell(arch, shape)
    assert cell.kind == jcell.kind and cell.donate == jcell.donate
    assert len(cell.args) == len(jcell.args)
    for mine, theirs in zip(cell.args, jcell.args):
        if isinstance(mine, int):
            assert mine == spec["seq"] - 1
            assert theirs.shape == () and np.dtype(theirs.dtype).name == "int32"
        elif isinstance(mine, torch.Tensor):
            assert _port_leaves({"x": mine}) == _jax_leaves({"x": theirs})
        else:
            assert _port_leaves(mine) == _jax_leaves(theirs)
    assert all(t.device.type == "meta" for a in cell.args
               if not isinstance(a, int) for _, t in tree_leaves({"x": a}))
    cfg = cell.model.cfg
    assert RL.model_flops_for(cfg, spec["kind"], spec["batch"], spec["seq"]) \
        == JRL.model_flops_for(jcell.model.cfg, spec["kind"], spec["batch"],
                               spec["seq"])


def test_rule_tables_are_the_jax_tables():
    from repro.distributed import sharding as JSH

    for name in ("DEFAULT_RULES", "FSDP_RULES", "SEQ_RULES", "DECODE_RULES",
                 "LONG_RULES"):
        assert getattr(S, name) == getattr(JSH, name), name


def test_env_overrides_as_jax(monkeypatch, shapes_override):
    """REPRO_ATTN / REPRO_ATTN_CHUNK / REPRO_OPT_{M,V}_DTYPE /
    REPRO_REMAT, read as the JAX cell reads them."""
    monkeypatch.setenv("REPRO_ATTN", "chunked")
    monkeypatch.setenv("REPRO_ATTN_CHUNK", "16")
    monkeypatch.setenv("REPRO_OPT_M_DTYPE", "bf16")
    monkeypatch.setenv("REPRO_REMAT", "dots")
    shapes_override("train_4k", seq=32, batch=2)
    cell = S.make_cell("qwen2.5-32b", "train_4k",
                       cfg=get_smoke_config("qwen2.5-32b"))
    cfg = cell.model.cfg
    assert (cfg.attn_impl, cfg.attn_chunk) == ("chunked", 16)
    state = cell.args[0]
    assert state["opt"]["m"]["embed"].dtype == torch.bfloat16
    assert state["opt"]["v"]["embed"].dtype == torch.float32
    jcell = JS.make_cell("qwen2.5-32b", "train_4k", make_mesh(
        (1, 1), ("data", "model")), cfg=jax_smoke("qwen2.5-32b"))
    assert _port_leaves(state) == _jax_leaves(jcell.args[0])


# ----------------------------------------------------------------------
# matmul flops of the port's trace against the jaxpr's dot_generals
# ----------------------------------------------------------------------
def _subjaxprs(eqn):
    for v in eqn.params.values():
        for x in (v if isinstance(v, (tuple, list)) else (v,)):
            if hasattr(x, "eqns"):
                yield x
            elif hasattr(x, "jaxpr") and hasattr(x.jaxpr, "eqns"):
                yield x.jaxpr


def _dot_flops(jaxpr) -> int:
    """2 * |out| * K for each dot_general (K the product of the lhs
    contracting dims), a scan's body times its length."""
    total = 0
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        assert name not in ("while", "cond"), name  # trip counts unknown
        if name == "dot_general":
            (lc, _), _ = eqn.params["dimension_numbers"]
            lhs = eqn.invars[0].aval.shape
            k = math.prod(lhs[d] for d in lc)
            total += 2 * math.prod(eqn.outvars[0].aval.shape) * k
        mult = eqn.params["length"] if name == "scan" else 1
        for sub in _subjaxprs(eqn):
            total += mult * _dot_flops(sub)
    return total


def _outer_products(cfg, B: int, S_: int) -> int:
    """Flops the jaxpr counts that FlopCounterMode does not: products
    with no contracted dimension, which `jnp.einsum` writes as a
    `dot_general` (counted 2 * |out| * 1) and the port as an elementwise
    `mul` (a matmul-free op, counted 0).  The results are equal.

    RWKV6: each of the S steps of each layer's WKV scan forms
    kv = einsum("bhk,bhv->bhkv", k_t, v_t), |out| = B * nh * hd^2, so
    2 * B * S * nh * hd^2 per layer (the port: `k_t[..., :, None] *
    v_t[..., None, :]`, `ssm.rwkv6_time_mix_train`).  rwkv6-smoke
    (B 2, S 128, nh 4, hd 16, 2 layers): 2^20.

    Mamba2: two three-operand einsums of `ssm.mamba2_train` take their
    uncontracted pair first — Bc's partner state_decay (b,z,s,h) with xc
    (b,z,s,h,p), |out| = B * S * nh * P, and Cc (b,z,t,n) with in_decay
    (b,z,t,h), |out| = B * S * N * nh — so 2 * B * S * nh * (P + N) per
    block; torch.einsum multiplies that pair elementwise.  zamba2-smoke
    (B 2, S 128, nh 8, P 16, N 8, 4 Mamba2 blocks): 3 * 2^17.

    No counting rule can take these without taking others: the rotary
    angles (`positions[..., None] * freqs`) are the same broadcast
    product in both packages, a multiply in JAX too, counted by neither.
    So the parity test asserts this exact difference."""
    total = 0
    if "rwkv6" in cfg.block_pattern:
        nh, hd = rwkv6_dims(cfg)
        n = cfg.block_pattern.count("rwkv6") * cfg.n_groups
        total += n * 2 * B * S_ * nh * hd * hd
    n = sum(cfg.block_pattern.count(k) for k in ("mamba2", "mamba2_shared")) \
        * cfg.n_groups
    if n:
        _, nh, _ = mamba2_dims(cfg)
        total += n * 2 * B * S_ * nh * (cfg.ssm.head_dim + cfg.ssm.state_dim)
    return total


@pytest.mark.parametrize("arch", list_archs())
def test_forward_matmul_flops_equal_the_jaxprs(arch):
    """The forward of each smoke config under dense attention at B=2,
    S=128: FlopCounterMode's count on `meta` equals the jaxpr's
    dot_general flops, less `_outer_products` (0 but for rwkv6 and
    zamba2: 2^20 and 3 * 2^17)."""
    B, S_ = 2, 128
    jcfg = dataclasses.replace(jax_smoke(arch), attn_impl="dense")
    cfg = dataclasses.replace(get_smoke_config(arch), attn_impl="dense")
    jmodel = jax_build(jcfg)
    jnp = jax.numpy
    kw = {}
    tok = jax.ShapeDtypeStruct((B, S_), jnp.int32)
    if jcfg.encoder is not None:
        kw["enc_frames"] = jax.ShapeDtypeStruct(
            (B, jcfg.encoder.max_len, jcfg.encoder.d_input), jnp.float32)
    jaxpr = jax.make_jaxpr(lambda p, t, k: jmodel.forward(p, tokens=t, **k))(
        jmodel.param_shapes(jnp.float32), tok, kw)
    want = _dot_flops(jaxpr.jaxpr)

    model = Model(cfg, torch.device("meta"))
    model.load_params(S._meta(tree_map(lambda s: (s, torch.float32),
                                       tree_shapes(model.template))))
    tkw = {k: torch.empty(v.shape, dtype=torch.float32, device="meta")
           for k, v in kw.items()}
    with FlopCounterMode(display=False) as fc:
        model.forward(tokens=torch.empty((B, S_), dtype=torch.int32,
                                         device="meta"), **tkw)
    got = fc.get_total_flops()
    assert got > 0
    assert want - got == _outer_products(cfg, B, S_), (want, got)
    if arch == "rwkv6-3b":
        assert want - got == 2 ** 20
    elif arch == "zamba2-1.2b":
        assert want - got == 3 * 2 ** 17
    else:
        assert want == got


# ----------------------------------------------------------------------
# the per-group decomposition against the full trace
# ----------------------------------------------------------------------
FAMILIES = ["qwen2.5-32b", "granite-moe-1b-a400m", "rwkv6-3b", "zamba2-1.2b",
            "whisper-base"]
KIND_SHAPES = {"train": "train_4k", "prefill": "prefill_32k",
               "decode": "decode_32k"}


@pytest.mark.parametrize("kind", list(KIND_SHAPES))
@pytest.mark.parametrize("arch", FAMILIES)
def test_corrected_costs_equal_the_full_trace(arch, kind, shapes_override,
                                             monkeypatch):
    """stem + G * per_group [+ E * per_enc_layer] from traces of 1 and 2
    groups (and encoder layers) equals the trace of all of them, flops,
    bytes and collective bytes exactly (dense, MoE, RWKV6, the Mamba2
    hybrid, the encoder-decoder).  At S = 64 an rwkv6 cell is also
    extrapolated in S (from 16 and 32): `measure` equals the trace."""
    monkeypatch.setattr(FA, "SEQ_PROBE", 16)
    shape = KIND_SHAPES[kind]
    shapes_override(shape, seq=64, batch=2)
    cfg = get_smoke_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=3 * len(cfg.block_pattern))
    if cfg.encoder is not None:
        cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
            cfg.encoder, n_layers=3))
    cell = S.make_cell(arch, shape, cfg=cfg)
    full = FA.count(cell.fn, *cell.args)
    got = FA.corrected_costs(arch, shape, cfg=cfg)
    for k in ("flops", "bytes", "coll"):
        assert got[k] == full[k], (k, got[k], full[k])
    assert got["loop_correction"] == {"flops": 0.0, "bytes": 0.0}
    assert set(got["stem"]) == set(got["per_group"]) == {"flops", "bytes",
                                                         "coll"}
    assert ("per_enc_layer" in got) == (cfg.encoder is not None)
    measured = FA.measure(arch, shape, S.rules_for(arch, shape), cfg)
    assert ("seq_probes" in measured) == (arch == "rwkv6-3b" and
                                          kind != "decode")
    for k in ("flops", "bytes", "coll", "out"):
        assert measured[k] == full[k], (k, measured[k], full[k])


# ----------------------------------------------------------------------
# flash_attention inside a trace: the op and its formula
# ----------------------------------------------------------------------
@pytest.mark.parametrize("window", [0, 24])
def test_chunked_attention_flops_are_the_formula(window, shapes_override):
    """A chunked prefill of gemma3-smoke (five window layers, one global)
    counts, under the op `repro_torch.flash_attention`, exactly
    4 * hd * B * H * pairs per layer, pairs = sum over s of
    min(s + 1, w) or S(S + 1)/2 at w = 0; the train step's forward and
    its remat recompute count it twice."""
    B, S_ = 2, 64
    shapes_override("prefill_32k", seq=S_, batch=B)
    shapes_override("train_4k", seq=S_, batch=B)
    cfg = dataclasses.replace(get_smoke_config("gemma3-12b"),
                              attn_impl="chunked", attn_chunk=16,
                              window=window)
    per_group = sum(ops.attention_flops(
        B, S_, cfg.n_heads, cfg.hd, window if k == "swa" else 0)
        for k in cfg.block_pattern)
    if window == 0:
        assert per_group == 6 * 4 * cfg.hd * B * cfg.n_heads * S_ * (S_ + 1) // 2
    for shape, times in (("prefill_32k", 1), ("train_4k", 2)):
        cell = S.make_cell("gemma3-12b", shape, cfg=cfg)
        with FlopCounterMode(display=False) as fc:
            cell.fn(*cell.args)
        got = fc.get_flop_counts()["Global"][
            torch.ops.repro_torch.flash_attention]
        assert got == times * cfg.n_groups * per_group


# ----------------------------------------------------------------------
# roofline
# ----------------------------------------------------------------------
HLO = """
  %ag = bf16[256,4096,5120]{2,1,0} all-gather(bf16[16,4096,5120] %x), dimensions={0}
  %ar.1 = f32[1024]{0} all-reduce(f32[1024]{0} %g), to_apply=%add
  %rs = (f32[64,128]{1,0}, s32[]) reduce-scatter(f32[1024,128] %y), dimensions={0}
  %a2a = s32[16,4096,3]{2,1,0} all-to-all(s32[16,4096,3]{2,1,0} %t), dimensions={0}
  %cp-start = (bf16[8,8], bf16[8,8]) collective-permute-start(bf16[8,8] %z)
  %add = f32[1024]{0} add(f32[1024] %a, f32[1024] %b)
  ROOT %t.2 = (s32[], f32[]) tuple(%i, %f)
"""


def test_parse_collectives_as_jax():
    mine, theirs = RL.parse_collectives(HLO), JRL.parse_collectives(HLO)
    assert mine.bytes_by_op == theirs.bytes_by_op
    assert mine.count_by_op == theirs.count_by_op
    assert mine.total_bytes == theirs.total_bytes > 0


def test_roofline_terms_and_peaks():
    """The Roofline arithmetic is the JAX module's; only the peaks are
    the H100 SXM5's."""
    assert (RL.PEAK_FLOPS, RL.HBM_BW, RL.LINK_BW) == (989.4e12, 3.35e12,
                                                      450e9)
    kw = dict(flops=2e12, hbm_bytes=3e9, collective_bytes=1e6, chips=1,
              model_flops=1e12)
    mine, theirs = RL.Roofline(**kw), JRL.Roofline(**kw)
    assert mine.t_compute == 2e12 / RL.PEAK_FLOPS
    assert mine.t_memory == 3e9 / RL.HBM_BW
    assert mine.t_collective == 1e6 / RL.LINK_BW
    scale = RL.PEAK_FLOPS / JRL.PEAK_FLOPS
    assert math.isclose(mine.t_compute * scale, theirs.t_compute)
    assert set(mine.as_dict()) == set(theirs.as_dict())
    assert mine.useful_flops_ratio == theirs.useful_flops_ratio
    r = RL.extract({"flops": 2e12, "bytes": 3e10, "coll": 0.0}, 1, 1e12)
    assert r.bottleneck == "memory" and r.collective_bytes == 0


# ----------------------------------------------------------------------
# the paper cell
# ----------------------------------------------------------------------
def test_paper_cell_at_1e9_triples_on_meta():
    """The JAX dry-run's paper cell: the 3-atom star join over 1e9
    triples, 16 data shards of a 16x16 mesh stacked on one card, traced
    on `meta`; its probes go through `join_count`'s shape rule (one op
    each, whose operands the bytes count)."""
    before = jc.launches
    res = DR.run_paper_cell()
    assert jc.launches == before
    assert res["status"] == "ok" and res["chips"] == 1 and res["shards"] == 16
    assert res["shape"] == "star3_1000000000" and res["mesh"] == "h100"
    per_dev = res["rows_per_shard"]
    assert per_dev % 1024 == 0 and per_dev >= 1e9 / 16 * 1.05
    assert res["memory"]["argument_bytes"] == 6 * 16 * per_dev * 3 * 4
    r = res["roofline"]
    assert r["hbm_bytes_per_device"] > res["memory"]["argument_bytes"] / 6
    assert r["collective_bytes_per_device"] == 0
    assert r["bottleneck"] == "memory"


def test_paper_program_equals_numpy_on_the_cpu():
    """The paper program at 2^16 triples drawn to fit its Statistics, on
    the CPU: the answer equals the numpy evaluation, with no overflow."""
    n = 1 << 16
    triples = DR.paper_triples(n, seed=0)
    fn, ndev, _ = DR.paper_program(n, torch.device("cpu"))
    tt = D.shard_store_by_subject(TripleStore(triples),
                                  Mesh(dict(DR.PAPER_MESH), torch.device("cpu")))
    assert ndev == 16 and all(t.shape[0] == 16 for t in tt.values())
    out = fn(tt, {})
    assert not bool(out.overflow.any())
    want = DR.paper_reference(triples)
    assert len(want) > 1000
    np.testing.assert_array_equal(D.gather_result(out), want)


# ----------------------------------------------------------------------
# artifacts, report, refusals
# ----------------------------------------------------------------------
def test_artifacts_and_report(tmp_path, capsys):
    """`--audit --mesh h100` writes one artifact per one-card cell
    (running the cell first) under --art-dir and nothing under
    artifacts/dryrun/; the report renders them."""
    jax_art = os.path.join(ROOT, "artifacts", "dryrun")
    existed = os.path.isdir(jax_art)
    art = str(tmp_path)
    DR.main(["--audit", "--arch", "whisper-base", "--mesh", "h100",
             "--art-dir", art])
    DR.main(["--audit", "--arch", "qwen2.5-32b", "--shape", "long_500k",
             "--mesh", "h100", "--art-dir", art])
    names = sorted(os.listdir(art))
    assert names == sorted([f"whisper-base__{s}__h100.json" for s in S.SHAPES]
                           + ["qwen2.5-32b__long_500k__h100.json"])
    with open(os.path.join(art, "whisper-base__prefill_32k__h100.json")) as f:
        res = json.load(f)
    assert res["status"] == "ok" and res["chips"] == 1
    assert set(res["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "generated_code_bytes"}
    assert res["roofline_corrected"]["flops_per_device"] == \
        res["roofline"]["flops_per_device"]
    assert set(res["audit_detail"]) == {"stem", "per_group", "loop_correction"}
    with open(os.path.join(art, "whisper-base__decode_32k__h100.json")) as f:
        decode = json.load(f)["roofline_corrected"]
    assert FA.corrected_roofline("whisper-base", "decode_32k").as_dict() \
        == decode
    with open(os.path.join(art, "whisper-base__long_500k__h100.json")) as f:
        assert json.load(f)["status"] == "skipped"
    assert os.path.isdir(jax_art) == existed

    cells = RP.load_all(art=art)
    table = RP.dryrun_table(cells)
    assert len(table.splitlines()) == 2 + 5
    assert table.count("| h100 | ok |") == 3
    assert table.count("| skipped |") == 2
    roof = RP.roofline_table(cells, "h100")
    assert len(roof.splitlines()) == 2 + 3
    assert "whisper-base | prefill_32k | h100" in roof
    pick = RP.picks(cells)
    assert pick["worst_fraction"][0] == "whisper-base"
    capsys.readouterr()
    RP.main(["--art-dir", art])
    assert "## Roofline (h100, per-group corrected)" in capsys.readouterr().out


@pytest.mark.parametrize("flag", ["--multi-pod", "--both-meshes"])
def test_mesh_flags_write_pod_artifacts(flag, tmp_path, monkeypatch,
                                        shapes_override, capsys):
    """The JAX CLI's mesh flags: --multi-pod writes the pod2 artifact of a
    cell, --both-meshes pod1's and pod2's, each with its chips and mesh
    shape (a smoke config at seq 64, batch 32, per device); --paper
    with the same flag writes the paper cell's; nothing under
    artifacts/dryrun/; the report has one table a mesh."""
    jax_art = os.path.join(ROOT, "artifacts", "dryrun")
    existed = os.path.isdir(jax_art)
    monkeypatch.setattr(DR, "get_config", get_smoke_config)
    monkeypatch.setattr(FA, "get_config", get_smoke_config)
    shapes_override("prefill_32k", seq=64, batch=32)
    art = str(tmp_path)
    DR.main([flag, "--audit", "--arch", "qwen2.5-32b", "--shape",
             "prefill_32k", "--art-dir", art])
    DR.main([flag, "--paper", "--art-dir", art])
    pods = ["pod2"] if flag == "--multi-pod" else ["pod1", "pod2"]
    assert sorted(os.listdir(art)) == sorted(
        [f"qwen2.5-32b__prefill_32k__{p}.json" for p in pods]
        + [f"rdfviews-query-step__star3__{p}.json" for p in pods])
    for p in pods:
        with open(os.path.join(art, f"qwen2.5-32b__prefill_32k__{p}.json")
                  ) as f:
            res = json.load(f)
        chips = 256 if p == "pod1" else 512
        assert res["status"] == "ok" and res["mesh"] == p
        assert res["chips"] == res["roofline"]["chips"] == chips
        assert math.prod(res["mesh_shape"].values()) == chips
        r = res["roofline_corrected"]
        for key in ("flops_per_device", "hbm_bytes_per_device",
                    "collective_bytes_per_device"):
            assert r[key] == res["roofline"][key] > 0
        with open(os.path.join(art, f"rdfviews-query-step__star3__{p}.json")
                  ) as f:
            paper = json.load(f)
        assert paper["chips"] == chips and paper["shards"] == 16
    assert os.path.isdir(jax_art) == existed
    assert "AUDIT qwen2.5-32b prefill_32k pod2" in capsys.readouterr().out
    RP.main(["--art-dir", art])
    out = capsys.readouterr().out
    for p in pods:
        chips = 256 if p == "pod1" else 512
        assert f"## Dry-run ({p}, {chips} chips, per device)" in out
        assert f"## Roofline ({p}, per-group corrected)" in out
        assert f"| qwen2.5-32b | prefill_32k | {p} | ok |" in out
