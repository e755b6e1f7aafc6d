"""The port's expert-parallel MoE and sharded train step against the JAX
package's, on the CPU.

Twin of `tests/test_moe_ep.py`.  The JAX side runs once, in a subprocess
whose host platform shows eight devices (as that test runs it): `moe`
under `axis_ctx` on a (data 2, model 4) mesh for the granite-moe and
llama4 smoke configs at capacity factor 8.0 (nothing dropped) and 0.5
(pairs dropped: each shard's capacity decides which), its gradients,
the dense fallbacks on (1, 3) (4 experts do not divide over 3) and on
(8,) (no expert axis), and two train steps of granite-moe jitted with
`train_state_shardings`.  It writes parameters, inputs and results to a
directory; the port runs here on `make_mesh(..., device="cpu")`, its
shards stacked on the CPU.

Tolerances: outputs and gradients rtol 2e-4 / atol 2e-5, the JAX EP
test's (float reordering: the port sums the expert shards in one
reduction where XLA's psum adds them pairwise; a gradient leaf's atol
in units of its largest entry where that exceeds 1).  The train steps:
loss, grad_norm and lr 1e-5 and the first step's gradients leaf for
leaf 1e-4, as `test_torch_train_parity`; each parameter's change over
the two steps to 2e-5 absolute, 1/50 of the second step's lr (an AdamW
update moves an element by about lr, so every leaf moves by more than
1e-3 and one left unchanged, or a second update 10 % off, fails; the
largest difference seen on the CPU is 6.4e-6, in w_down).  The kept (token, expert) pairs are read from each package's
output with probe weights: expert e writes only feature e (w_down[e]
zero but for one entry) and the shared expert is zeroed, so feature e
of token t is nonzero exactly where the pair (t, e) was kept; routing
(norm and router) is the layer's own."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api.convert import model_params_from_reference  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.distributed.sharding import DEFAULT_RULES, axis_ctx  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_mesh  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.params import tree_from_leaves, tree_leaves  # noqa: E402
from repro_torch.train.optimizer import OptConfig, init_opt_state  # noqa: E402
from repro_torch.train.train_step import (TrainConfig, make_train_step,  # noqa: E402
                                          value_and_grad)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["granite-moe-1b-a400m", "llama4-maverick-400b-a17b"]
CAPACITY = [8.0, 0.5]
FALLBACK = {"1x3": ((1, 3), ("data", "model")), "8": ((8,), ("data",))}
RTOL, ATOL = 2e-4, 2e-5
LR = 1e-3
METRIC_TOL, GRAD_TOL, DELTA_TOL = 1e-5, 1e-4, 2e-5
TRAIN_ARCH = "granite-moe-1b-a400m"
JAX_TIMEOUT_S = 300
SEP = "|"

SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_smoke_config
from repro.distributed.sharding import DEFAULT_RULES, axis_ctx, param_shardings
from repro.launch.mesh import make_mesh
from repro.models import layers as L
from repro.models.model import build_model
from repro.models.params import init_params
from repro.train.optimizer import OptConfig
from repro.train.train_step import (TrainConfig, batch_shardings,
                                    init_train_state, loss_fn,
                                    make_train_step, train_state_shardings)

OUT, ARCHS, CAPACITY, FALLBACK, LR, SEP = sys.argv[1:7]
ARCHS, CAPACITY, FALLBACK = (json.loads(a) for a in (ARCHS, CAPACITY, FALLBACK))
LR = float(LR)
out = {}


def flat(prefix, tree):
    for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = SEP.join(str(k.key) for k in path)
        out[prefix + SEP + key] = np.asarray(v, np.float32)


mesh = make_mesh((2, 4), ("data", "model"))
xsh = NamedSharding(mesh, P("data"))
for arch in ARCHS:
    base = get_smoke_config(arch)
    tpl = L.moe_template(base)
    params = init_params(tpl, jax.random.key(0))
    x = jax.random.normal(jax.random.key(1), (4, 8, base.d_model), jnp.float32)
    flat(arch + SEP + "params", params)
    out[arch + SEP + "x"] = np.asarray(x)
    E = base.moe.n_experts
    probe = dict(params)
    probe["w_down"] = jnp.zeros_like(params["w_down"]).at[
        jnp.arange(E), 0, jnp.arange(E)].set(1.0)
    if "ws_down" in params:
        probe["ws_down"] = jnp.zeros_like(params["ws_down"])
    psh = param_shardings(tpl, DEFAULT_RULES, mesh)
    for cf in CAPACITY:
        cfg = dataclasses.replace(base, moe=dataclasses.replace(
            base.moe, capacity_factor=cf))

        def f(p, xx):
            with axis_ctx(mesh, DEFAULT_RULES):
                return L.moe(p, cfg, xx)

        def loss(p, xx):
            return jnp.sum(f(p, xx) ** 2)

        run = jax.jit(f, in_shardings=(psh, xsh))
        tag = f"{arch}{SEP}{cf}"
        out[tag + SEP + "ep"] = np.asarray(run(jax.device_put(params, psh),
                                               jax.device_put(x, xsh)))
        out[tag + SEP + "probe"] = np.asarray(run(
            jax.device_put(probe, psh), jax.device_put(x, xsh)))
        gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)),
                         in_shardings=(psh, xsh))(
            jax.device_put(params, psh), jax.device_put(x, xsh))
        flat(tag + SEP + "grad", gp)
        out[tag + SEP + "grad_x"] = np.asarray(gx)
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, capacity_factor=0.5))
    for name, (shape, axes) in FALLBACK.items():
        fm = make_mesh(tuple(shape), tuple(axes))

        def g(p, xx, fm=fm):
            with axis_ctx(fm, DEFAULT_RULES):
                return L.moe(p, cfg, xx)

        out[f"{arch}{SEP}fallback{SEP}{name}"] = np.asarray(jax.jit(g)(params, x))
    out[f"{arch}{SEP}dense"] = np.asarray(L._moe_dense(params, cfg, x))

# whole smoke models: the chunked forward under the mesh, and without it
for arch in ARCHS:
    base = get_smoke_config(arch)
    cfg = dataclasses.replace(base, attn_impl="chunked", attn_chunk=8,
                              moe=dataclasses.replace(base.moe,
                                                      capacity_factor=0.5))
    model = build_model(cfg)
    params = model.init(jax.random.key(0))
    flat(f"{arch}{SEP}model", params)
    t = np.random.default_rng(7).integers(0, cfg.vocab, size=(4, 16)).astype(
        np.int32)
    out[f"{arch}{SEP}tokens"] = t

    def fwd(p, tt, model=model):
        with axis_ctx(mesh, DEFAULT_RULES):
            return model.forward(p, tokens=tt)

    out[f"{arch}{SEP}logits"] = np.asarray(jax.jit(fwd)(params, t))
    out[f"{arch}{SEP}logits_dense"] = np.asarray(jax.jit(
        lambda p, tt, model=model: model.forward(p, tokens=tt))(params, t))

# two train steps under the mesh, jitted with the state's shardings
cfg = get_smoke_config("granite-moe-1b-a400m")
model = build_model(cfg)
tc = TrainConfig(opt=OptConfig(lr=LR, warmup_steps=2, total_steps=10,
                               m_dtype=jnp.float32), remat="full")
state = init_train_state(model, tc, jax.random.key(0))
flat("train" + SEP + "init", state["params"])
rng = np.random.default_rng(5)
ssh = train_state_shardings(model, tc, mesh)
step = None
metrics_of = {"loss": [], "grad_norm": [], "lr": []}
for i in range(2):
    t = rng.integers(8, cfg.vocab, size=(4, 16)).astype(np.int32)
    batch = {"tokens": t, "labels": np.roll(t, -1, axis=1)}
    out[f"train{SEP}batch{i}"] = t
    bsh = batch_shardings(mesh, batch)
    if step is None:
        step = jax.jit(make_train_step(model, tc, mesh, DEFAULT_RULES),
                       in_shardings=(ssh, bsh), out_shardings=(ssh, None))
        state = jax.device_put(state, ssh)

        def grads(p, b):
            with axis_ctx(mesh, DEFAULT_RULES):
                return jax.grad(lambda q: loss_fn(model, q, b, tc))(p)

        flat("train" + SEP + "grad", jax.jit(
            grads, in_shardings=(ssh["params"], bsh))(
                state["params"], jax.device_put(batch, bsh)))
    state, metrics = step(state, jax.device_put(batch, bsh))
    for key in metrics_of:
        metrics_of[key].append(float(metrics[key]))
flat("train" + SEP + "params", state["params"])
np.savez(os.path.join(OUT, "jax.npz"), **out)
with open(os.path.join(OUT, "jax.json"), "w") as f:
    json.dump(metrics_of, f)
"""


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """Every JAX result, computed once in a subprocess."""
    out = tmp_path_factory.mktemp("jax_moe_ep")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    fallback = {k: [list(s), list(a)] for k, (s, a) in FALLBACK.items()}
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(out), json.dumps(ARCHS),
         json.dumps(CAPACITY), json.dumps(fallback), str(LR), SEP],
        capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=JAX_TIMEOUT_S)
    assert res.returncode == 0, f"STDOUT:\n{res.stdout}\nSTDERR:\n{res.stderr}"
    arrays = np.load(out / "jax.npz")
    return ({k: arrays[k] for k in arrays.files},
            json.loads((out / "jax.json").read_text()))


def _tree(arrays: dict, prefix: str) -> dict:
    """The nested tensor tree stored under `prefix`."""
    head = prefix + SEP
    return tree_from_leaves(
        (tuple(k[len(head):].split(SEP)), torch.from_numpy(v.copy()))
        for k, v in arrays.items() if k.startswith(head))


def _cfg(arch: str, cf: float):
    base = get_smoke_config(arch)
    return dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, capacity_factor=cf))


def _mesh(shape=(2, 4), axes=("data", "model")):
    return make_mesh(shape, axes, device="cpu")


def _inputs(jax_side, arch: str):
    arrays, _ = jax_side
    return (_tree(arrays, f"{arch}{SEP}params"),
            torch.from_numpy(arrays[f"{arch}{SEP}x"].copy()))


def _close(got, want, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL, err_msg=msg)


def _probe(p: dict) -> dict:
    """The probe weights: expert e writes w_down[e, 0, e] times its first
    hidden unit into feature e, the shared expert nothing."""
    q = dict(p)
    E = p["w_down"].shape[0]
    q["w_down"] = torch.zeros_like(p["w_down"])
    q["w_down"][torch.arange(E), 0, torch.arange(E)] = 1.0
    if "ws_down" in p:
        q["ws_down"] = torch.zeros_like(p["ws_down"])
    return q


def _kept_from_probe(out: np.ndarray, E: int) -> set:
    feats = out.reshape(-1, out.shape[-1])[:, :E]
    return {(int(t), int(e)) for t, e in zip(*np.nonzero(feats))}


@pytest.mark.parametrize("cf", CAPACITY)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ep_matches_jax(jax_side, arch, cf):
    """`moe` under `axis_ctx` on (data 2, model 4): the JAX EP output."""
    arrays, _ = jax_side
    p, x = _inputs(jax_side, arch)
    cfg = _cfg(arch, cf)
    with axis_ctx(_mesh(), DEFAULT_RULES):
        got = L.moe(p, cfg, x)
    want = arrays[f"{arch}{SEP}{cf}{SEP}ep"]
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got, want)
    if cf == 0.5:   # a different answer from the dense path, not a rounding
        dense = L._moe_dense(p, cfg, x).numpy()
        assert np.abs(dense - want).max() > 0.1


@pytest.mark.parametrize("cf", CAPACITY)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ep_keeps_jax_pairs(jax_side, arch, cf, monkeypatch):
    """The (token, expert) pairs each shard keeps: JAX's, read through the
    probe weights, equal to the port's (probe and `_ep_route`'s own
    kept mask); at 0.5 some pairs drop, at 8.0 none."""
    arrays, _ = jax_side
    p, x = _inputs(jax_side, arch)
    cfg = _cfg(arch, cf)
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    seen = []
    real = L._ep_route

    def recording(lay, idx, gates):
        res = real(lay, idx, gates)
        seen.append((lay, res))
        return res

    monkeypatch.setattr(L, "_ep_route", recording)
    with axis_ctx(_mesh(), DEFAULT_RULES):
        got = L.moe(_probe(p), cfg, x)
    want = _kept_from_probe(arrays[f"{arch}{SEP}{cf}{SEP}probe"], E)
    assert _kept_from_probe(got.numpy(), E) == want
    (lay, (shard, se, st_, _, keep, _)), = seen
    lo = (shard % lay.n_ep) * lay.E_loc
    routed = {(int(t), int(e)) for t, e, kp in zip(
        st_.tolist(), (lo + se).tolist(), keep.tolist()) if kp}
    assert routed == want
    T = x.shape[0] * x.shape[1]
    assert (len(want) < T * k) if cf == 0.5 else (len(want) == T * k)


@pytest.mark.parametrize("cf", CAPACITY)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ep_grads_match_jax(jax_side, arch, cf):
    """The gradient of sum(moe(p, x)^2) for every parameter and for x:
    JAX's EP gradient (its `shard_map` runs with check_vma=False)."""
    arrays, _ = jax_side
    p, x = _inputs(jax_side, arch)
    cfg = _cfg(arch, cf)
    leaves = [(path, v.requires_grad_()) for path, v in tree_leaves(p)]
    x = x.requires_grad_()
    with axis_ctx(_mesh(), DEFAULT_RULES):
        loss = (L.moe(tree_from_leaves(leaves), cfg, x) ** 2).sum()
    grads = torch.autograd.grad(loss, [v for _, v in leaves] + [x])
    tag = f"{arch}{SEP}{cf}{SEP}"
    wants = [arrays[tag + "grad" + SEP + SEP.join(path)] for path, _ in leaves]
    for name, g, want in zip([pth for pth, _ in leaves] + [("x",)], grads,
                             wants + [arrays[tag + "grad_x"]]):
        # atol in units of the leaf's largest entry (at least 1): a sum of
        # squares over 2,048 outputs gives gradients up to ~10^2, where
        # one fp32 rounding is ~1e-5
        np.testing.assert_allclose(
            g.numpy(), want, rtol=RTOL,
            atol=ATOL * max(1.0, float(np.abs(want).max())),
            err_msg="/".join(name))
    if arch == "granite-moe-1b-a400m":   # top-2: the router takes gradient
        assert float(grads[[pth for pth, _ in leaves].index(("router",))]
                     .abs().max()) > 0


@pytest.mark.parametrize("mesh_name", sorted(FALLBACK))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_dense_fallbacks(jax_side, arch, mesh_name, monkeypatch):
    """(1, 3): 4 experts do not divide over 3 shards; (8,): no expert
    axis.  Both take the dense path, as JAX does (capacity 0.5, where the
    two paths differ), and give JAX's output."""
    arrays, _ = jax_side
    p, x = _inputs(jax_side, arch)
    cfg = _cfg(arch, 0.5)
    monkeypatch.setattr(L, "_ep_route", lambda *a: pytest.fail("EP routed"))
    shape, axes = FALLBACK[mesh_name]
    with axis_ctx(_mesh(shape, axes), DEFAULT_RULES):
        got = L.moe(p, cfg, x)
    _close(got, arrays[f"{arch}{SEP}fallback{SEP}{mesh_name}"])
    _close(got, arrays[f"{arch}{SEP}dense"])


@pytest.mark.parametrize("cf", CAPACITY)
@pytest.mark.parametrize("arch", ARCHS)
def test_stacked_ep_matches_the_per_shard_body(jax_side, arch, cf):
    """The stacked computation against JAX's body run shard by shard
    (`_moe_ep_loop`), on (2, 4), (4, 2) and (1, 4)."""
    p, x = _inputs(jax_side, arch)
    cfg = _cfg(arch, cf)
    for shape in ((2, 4), (4, 2), (1, 4)):
        mesh = _mesh(shape)
        with axis_ctx(mesh, DEFAULT_RULES):
            got = L.moe(p, cfg, x)
            lay = L._ep_layout(cfg, mesh, x.shape[0] * x.shape[1])
            want = L._moe_ep_loop(p, cfg, x, lay)
        _close(got, want.numpy(), str(shape))


def test_ep_refuses_what_shard_map_refuses():
    """Tokens that do not split over the batch axes, and tokens on another
    device than the mesh's, raise."""
    cfg = _cfg("granite-moe-1b-a400m", 1.0)
    p = {k: torch.zeros(v) for k, v in (
        ("router", (64, 4)), ("w_gate", (4, 64, 32)), ("w_up", (4, 64, 32)),
        ("w_down", (4, 32, 64)))}
    p["norm"] = {"scale": torch.ones(64)}
    with axis_ctx(_mesh((4, 2)), DEFAULT_RULES):
        with pytest.raises(ValueError, match="do not split"):
            L.moe(p, cfg, torch.zeros(1, 3, 64))
    meta = Mesh({"data": 2, "model": 4}, torch.device("meta"))
    with axis_ctx(meta, DEFAULT_RULES):
        with pytest.raises(ValueError, match="the mesh on meta"):
            L.moe(p, cfg, torch.zeros(2, 4, 64))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_stacked_ep_matches_the_per_shard_body_on_the_card(arch):
    """On the card, fp32 at a pair-dropping capacity: the stacked EP
    against the per-shard body."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.models.params import init_params

    cfg = _cfg(arch, 0.5)
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = init_params(L.moe_template(cfg), gen, device="cuda")
    x = torch.randn(4, 64, cfg.d_model, generator=gen, device="cuda")
    mesh = make_mesh((2, 4), ("data", "model"), device="cuda")
    with axis_ctx(mesh, DEFAULT_RULES):
        got = L.moe(p, cfg, x)
        want = L._moe_ep_loop(p, cfg, x, L._ep_layout(cfg, mesh, 256))
    _close(got.cpu(), want.cpu().numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_under_the_mesh_matches_jax(jax_side, arch, monkeypatch):
    """A whole smoke model (chunked attention, capacity factor 0.5) under
    `axis_ctx` on (2, 4): every MoE layer expert-parallel, the logits
    JAX's `Model.forward` under the same context gives (1e-4, the
    forward tolerance of `tests/test_torch_moe_ssm.py`), and not the
    dense path's."""
    arrays, _ = jax_side
    base = get_smoke_config(arch)
    cfg = dataclasses.replace(base, attn_impl="chunked", attn_chunk=8,
                              moe=dataclasses.replace(base.moe,
                                                      capacity_factor=0.5))
    tree = {path: v.numpy() for path, v in
            tree_leaves(_tree(arrays, f"{arch}{SEP}model"))}
    tm = model_params_from_reference(tree_from_leaves(tree.items()), cfg,
                                     device="cpu")
    t = torch.from_numpy(arrays[f"{arch}{SEP}tokens"].copy())
    calls = []
    real = L._ep_route
    monkeypatch.setattr(L, "_ep_route",
                        lambda *a: calls.append(1) or real(*a))
    with axis_ctx(_mesh(), DEFAULT_RULES):
        got = tm.forward(tokens=t)
    assert len(calls) == cfg.n_layers
    want = arrays[f"{arch}{SEP}logits"]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert np.abs(want - arrays[f"{arch}{SEP}logits_dense"]).max() > 1e-2


def test_sharded_train_steps_match_jax(jax_side):
    """Two steps of `make_train_step(model, tc, mesh, rules)` on the
    granite-moe smoke config (its MoE layers expert-parallel) against
    JAX's step jitted with `train_state_shardings`: the first step's
    gradients leaf for leaf (taken under `axis_ctx`, as the step takes
    them), each step's loss, grad_norm and lr, and each parameter's
    change over the two steps."""
    arrays, record = jax_side
    cfg = get_smoke_config(TRAIN_ARCH)
    init = dict(tree_leaves(_tree(arrays, "train" + SEP + "init")))
    tm = model_params_from_reference(
        tree_from_leaves((p, v.numpy()) for p, v in init.items()), cfg,
        device="cpu")
    tc = TrainConfig(opt=OptConfig(lr=LR, warmup_steps=2, total_steps=10),
                     remat="full")
    state = {"params": tm.params, "opt": init_opt_state(tm.params, tc.opt)}
    mesh = _mesh()
    step = make_train_step(tm, tc, mesh, DEFAULT_RULES)
    calls = []
    real = L._ep_route
    L._ep_route = lambda *a: calls.append(1) or real(*a)
    try:
        got_metrics = {key: [] for key in record}
        for i in range(2):
            t = torch.from_numpy(arrays[f"train{SEP}batch{i}"].copy())
            batch = {"tokens": t, "labels": torch.roll(t, -1, 1)}
            if i == 0:
                with axis_ctx(mesh, DEFAULT_RULES):
                    _, grads = value_and_grad(tm, state["params"], batch, tc)
            state, metrics = step(state, batch)
            for key in got_metrics:
                got_metrics[key].append(float(metrics[key]))
    finally:
        L._ep_route = real
    # the forward and the recomputed forward of remat="full", each MoE
    # layer, in the first step's gradient and in each of the two steps
    assert len(calls) == 3 * 2 * cfg.n_layers
    for key, want in record.items():
        np.testing.assert_allclose(got_metrics[key], want, rtol=METRIC_TOL,
                                   atol=METRIC_TOL, err_msg=key)
    want = dict(tree_leaves(_tree(arrays, "train" + SEP + "grad")))
    got = dict(tree_leaves(grads))
    assert sorted(got) == sorted(want)
    for path, g in want.items():
        np.testing.assert_allclose(got[path].numpy(), g.numpy(),
                                   rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg="/".join(path))
    want = dict(tree_leaves(_tree(arrays, "train" + SEP + "params")))
    got = dict(tree_leaves(state["params"]))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        moved = (w - init[path]).numpy()
        # a leaf left at its initial values must fail the comparison
        assert np.abs(moved).max() > 10 * DELTA_TOL, "/".join(path)
        np.testing.assert_allclose((got[path] - init[path]).numpy(), moved,
                                   rtol=0, atol=DELTA_TOL,
                                   err_msg="/".join(path))
