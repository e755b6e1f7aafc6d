"""The port's MoE and SSM serving path against the JAX package's, on the
CPU: granite-moe, llama4 (MoE with a shared expert), zamba2 (Mamba2 with
the shared attention block) and rwkv6.

JAX parameters from `Model.init(jax.random.key(0))` are carried across
with `model_params_from_reference`; the same seeded numpy inputs go
through both packages.  fp32 throughout, so the tolerances state float
reordering: layer outputs and recurrent states to 1e-5; forward and
prefill logits to 1e-4; the bf16 attention cache to one bf16 ulp (2^-7
relative), the fp32 SSM states to 1e-5; decode logits, which read the
bf16 cache, to 1e-3.  Every decode-against-forward check of an MoE
family runs at `capacity_factor = n_experts / top_k`, where the
capacity holds every (token, expert) pair, so a teacher-forced decode
drops what the forward drops: nothing.  The chunked path runs the
`flash_attention` wrapper, whose plain version stands in on the CPU."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api.convert import model_params_from_reference  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.params import tree_leaves, tree_map  # noqa: E402
from repro_torch.serve.serve_step import (BatchedServer,  # noqa: E402
                                          ServeConfig)

MOE = ["granite-moe-1b-a400m", "llama4-maverick-400b-a17b"]
SSM_ARCHS = ["zamba2-1.2b", "rwkv6-3b"]
FAMILIES = MOE + SSM_ARCHS
LAYER_TOL = 1e-5
LOGITS_TOL = 1e-4
STATE_TOL = 1e-5
DECODE_TOL = 1e-3
BF16_ULP = 2.0 ** -7
CHUNK = 8

_CACHE: dict = {}


def _no_drop(cfg):
    """`cfg` with `capacity_factor = n_experts / top_k` (cap >= T: no
    pair is dropped) for an MoE config; other configs unchanged."""
    if cfg.moe is None:
        return cfg
    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k))


def _cfgs(arch: str, impl: str, no_drop: bool = False):
    """(JAX config, port config) with `attn_impl=impl`, chunk 8."""
    from repro.configs import get_smoke_config as jax_smoke

    kw = {"attn_impl": impl, "attn_chunk": CHUNK}
    jcfg = dataclasses.replace(jax_smoke(arch), **kw)
    tcfg = dataclasses.replace(get_smoke_config(arch), **kw)
    return (_no_drop(jcfg), _no_drop(tcfg)) if no_drop else (jcfg, tcfg)


def _pair(arch: str, impl: str = "chunked", no_drop: bool = False):
    """The JAX model and params and the port's model holding the same
    params, built once per (arch, impl, no_drop)."""
    key = (arch, impl, no_drop)
    if key not in _CACHE:
        jax = pytest.importorskip("jax")
        from repro.models.model import build_model as jax_build

        jcfg, tcfg = _cfgs(arch, impl, no_drop)
        jm = jax_build(jcfg)
        params = jm.init(jax.random.key(0))
        tm = model_params_from_reference(jax.tree.map(np.asarray, params),
                                         tcfg, device="cpu")
        _CACHE[key] = (jm, params, tm)
    return _CACHE[key]


def _tokens(cfg, B: int, S: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)


def _np(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _close(got, want, tol, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                               err_msg=msg)


# ----------------------------------------------------------------------
# layer level
# ----------------------------------------------------------------------
def _layer_params(arch: str, key: str, seed: int = 3):
    """Group 0's parameters of layer `key` ("<layer>/<block>") from the
    JAX init, with the zero-initialised decay, bias and bonus leaves set
    to seeded values so they take part; as (JAX tree, port tree)."""
    import jax.numpy as jnp

    _, params, _ = _pair(arch)
    layer, sub = key.split("/")
    p_np = tree_map(lambda v: np.array(v[0]), params["groups"][layer][sub])
    rng = np.random.default_rng(seed)
    for name in ("a_log", "dt_bias", "w_base", "u_bonus", "conv_b"):
        if name in p_np:
            p_np[name] = (0.5 * rng.standard_normal(p_np[name].shape)
                          ).astype(np.float32)
    return tree_map(jnp.asarray, p_np), tree_map(torch.from_numpy, p_np)


def _h(B, S, d, seed=5) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((B, S, d)).astype(
        np.float32)


def _jax_kept(cfg, p, x) -> set:
    """The (token, expert) pairs that JAX's `_moe_dense` keeps
    (`repro/models/layers.py:362-381`, step for step)."""
    import jax
    import jax.numpy as jnp
    from repro.models import layers as JL

    m = cfg.moe
    B, S, d = x.shape
    T, k, E = B * S, m.top_k, m.n_experts
    y = JL.rmsnorm(p["norm"], x, cfg.norm_eps).reshape(T, d)
    logits = jnp.einsum("td,de->te", y, p["router"].astype(x.dtype))
    _, idx = jax.lax.top_k(logits, k)
    cap = int(max(1, round(T * k / E * m.capacity_factor)))
    pair_e = idx.reshape(T * k)
    pair_t = jnp.repeat(jnp.arange(T, dtype=jnp.int32), k)
    order = jnp.argsort(pair_e)
    se, st_ = pair_e[order], pair_t[order]
    rank = jnp.arange(T * k) - jnp.searchsorted(se, se, side="left")
    keep = np.asarray(rank < cap)
    return {(int(t), int(e)) for t, e, kp in zip(np.asarray(st_),
                                                  np.asarray(se), keep) if kp}


def _port_moe(monkeypatch, p, cfg, x):
    """The port's `moe` output and the (token, expert) pairs it kept."""
    seen = []
    real = L._route

    def recording(cfg_, logits, dtype):
        out = real(cfg_, logits, dtype)
        seen.append(out)
        return out

    monkeypatch.setattr(L, "_route", recording)
    y = L.moe(p, cfg, x)
    se, st_, _, keep, _, _ = seen[0]
    kept = {(int(t), int(e)) for t, e, kp in zip(st_.tolist(), se.tolist(),
                                                  keep.tolist()) if kp}
    return y, kept


@pytest.mark.parametrize("capacity", ["config", 0.5])
@pytest.mark.parametrize("arch", MOE)
def test_moe_matches_jax(monkeypatch, arch, capacity):
    """`moe` at the config's capacity factor and at 0.5, where pairs are
    dropped: JAX's kept pairs and outputs (1e-5)."""
    import jax.numpy as jnp
    from repro.models import layers as JL

    jcfg, tcfg = _cfgs(arch, "dense")
    if capacity != "config":
        jcfg, tcfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=capacity)) for c in (jcfg, tcfg))
    jp, tp = _layer_params(arch, "0:attn/ffn")
    x = _h(2, 12, tcfg.d_model)
    want = JL.moe(jp, jcfg, jnp.asarray(x))
    got, kept = _port_moe(monkeypatch, tp, tcfg, torch.from_numpy(x))
    assert kept == _jax_kept(jcfg, jp, jnp.asarray(x))
    T, k = 24, tcfg.moe.top_k
    if capacity == 0.5:
        assert len(kept) < T * k
    else:
        assert len(kept) == T * k
    assert got.shape == (2, 12, tcfg.d_model) and got.dtype == torch.float32
    _close(got, want, LAYER_TOL)


@pytest.mark.parametrize("arch", MOE)
def test_moe_ties_take_the_lowest_experts(monkeypatch, arch):
    """Zero router weights make every logit equal: JAX's `top_k` keeps
    experts 0..k-1 of every token, and so does the port."""
    import jax.numpy as jnp
    from repro.models import layers as JL

    jcfg, tcfg = _cfgs(arch, "dense")
    jp, tp = _layer_params(arch, "0:attn/ffn")
    jp["router"] = jnp.zeros_like(jp["router"])
    tp["router"] = torch.zeros_like(tp["router"])
    x = _h(2, 8, tcfg.d_model, seed=9)
    want = JL.moe(jp, jcfg, jnp.asarray(x))
    got, kept = _port_moe(monkeypatch, tp, tcfg, torch.from_numpy(x))
    k = tcfg.moe.top_k
    assert kept == {(t, e) for t in range(16) for e in range(k)}
    assert kept == _jax_kept(jcfg, jp, jnp.asarray(x))
    _close(got, want, LAYER_TOL)


def test_mamba2_train_and_decode_match_jax():
    """`mamba2_train(return_state=True)`: output, `ssm` and `conv`
    states; then three `mamba2_decode` steps from that state."""
    import jax.numpy as jnp
    from repro.models import ssm as JS

    jcfg, tcfg = _cfgs("zamba2-1.2b", "dense")
    jp, tp = _layer_params("zamba2-1.2b", "0:mamba2/mamba")
    x = _h(2, 16, tcfg.d_model)
    jout, jst = JS.mamba2_train(jp, jcfg, jnp.asarray(x), return_state=True)
    tout, tst = SSM.mamba2_train(tp, tcfg, torch.from_numpy(x),
                                 return_state=True)
    _close(tout, jout, LAYER_TOL)
    assert sorted(tst) == sorted(jst) == ["conv", "ssm"]
    for name in jst:
        assert tst[name].dtype == torch.float32
        assert tuple(tst[name].shape) == tuple(jst[name].shape)
        _close(tst[name], jst[name], STATE_TOL, name)
    plain = SSM.mamba2_train(tp, tcfg, torch.from_numpy(x))
    torch.testing.assert_close(plain, tout, rtol=0, atol=0)
    for step in range(3):
        h1 = _h(2, 1, tcfg.d_model, seed=20 + step)
        jd, jst = JS.mamba2_decode(jp, jcfg, jnp.asarray(h1), jst)
        passed = dict(tst)
        held = {n: v.clone() for n, v in tst.items()}
        td, tst = SSM.mamba2_decode(tp, tcfg, torch.from_numpy(h1), passed)
        for n, v in held.items():
            # pure: the tensors passed in are unchanged, and the step
            # returns a new state
            assert torch.equal(passed[n], v), n
            assert not torch.equal(tst[n], v), n
        _close(td, jd, LAYER_TOL, f"step {step}")
        for name in jst:
            _close(tst[name], jst[name], STATE_TOL, f"{name}, step {step}")


def test_mamba2_needs_whole_chunks():
    _, tcfg = _cfgs("zamba2-1.2b", "dense")
    _, tp = _layer_params("zamba2-1.2b", "0:mamba2/mamba")
    with pytest.raises(ValueError, match="seq 12 must be a multiple of "
                                         "chunk 8"):
        SSM.mamba2_train(tp, tcfg, torch.zeros((1, 12, tcfg.d_model)))


def test_rwkv6_time_and_channel_mix_match_jax():
    """`rwkv6_time_mix_train` (output, last normed x, WKV state; from
    zero state and from a carried one) and `rwkv6_channel_mix`."""
    import jax.numpy as jnp
    from repro.models import ssm as JS

    jcfg, tcfg = _cfgs("rwkv6-3b", "dense")
    jp, tp = _layer_params("rwkv6-3b", "0:rwkv6/rwkv")
    x = _h(2, 16, tcfg.d_model)
    jo, jx, jw = JS.rwkv6_time_mix_train(jp, jcfg, jnp.asarray(x))
    to, tx, tw = SSM.rwkv6_time_mix_train(tp, tcfg, torch.from_numpy(x))
    _close(to, jo, LAYER_TOL, "out")
    _close(tx, jx, LAYER_TOL, "last x")
    assert tuple(tw.shape) == tuple(jw.shape) and tw.dtype == torch.float32
    _close(tw, jw, STATE_TOL, "wkv")
    x2 = _h(2, 5, tcfg.d_model, seed=6)
    jo2, _, jw2 = JS.rwkv6_time_mix_train(jp, jcfg, jnp.asarray(x2),
                                          shift_state=jx, wkv_state=jw)
    to2, _, tw2 = SSM.rwkv6_time_mix_train(tp, tcfg, torch.from_numpy(x2),
                                           shift_state=tx, wkv_state=tw)
    _close(to2, jo2, LAYER_TOL, "carried out")
    _close(tw2, jw2, STATE_TOL, "carried wkv")
    jc, jcx = JS.rwkv6_channel_mix(jp, jcfg, jnp.asarray(x))
    tc, tcx = SSM.rwkv6_channel_mix(tp, tcfg, torch.from_numpy(x))
    _close(tc, jc, LAYER_TOL, "channel mix")
    _close(tcx, jcx, LAYER_TOL, "channel mix last x")


def test_rwkv6_decode_matches_jax():
    """Three `rwkv6_decode` steps from the state a time mix left."""
    import jax.numpy as jnp
    from repro.models import ssm as JS

    jcfg, tcfg = _cfgs("rwkv6-3b", "dense")
    jp, tp = _layer_params("rwkv6-3b", "0:rwkv6/rwkv")
    x = _h(2, 8, tcfg.d_model)
    _, jx, jw = JS.rwkv6_time_mix_train(jp, jcfg, jnp.asarray(x))
    _, jxc = JS.rwkv6_channel_mix(jp, jcfg, jnp.asarray(x))
    jst = {"wkv": jw, "shift_t": jx, "shift_c": jxc}
    tst = {n: torch.from_numpy(np.array(v)) for n, v in jst.items()}
    for step in range(3):
        h1 = _h(2, 1, tcfg.d_model, seed=30 + step)
        jd, jst = JS.rwkv6_decode(jp, jcfg, jnp.asarray(h1), jst)
        td, tst = SSM.rwkv6_decode(tp, tcfg, torch.from_numpy(h1), tst)
        _close(td, jd, LAYER_TOL, f"step {step}")
        assert sorted(tst) == sorted(jst)
        for name in jst:
            assert tst[name].dtype == torch.float32
            _close(tst[name], jst[name], STATE_TOL, f"{name}, step {step}")


# ----------------------------------------------------------------------
# model level
# ----------------------------------------------------------------------
@pytest.mark.parametrize("impl", ["dense", "chunked"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_matches_jax(arch, impl):
    import jax.numpy as jnp

    jm, params, tm = _pair(arch, impl)
    toks = _tokens(tm.cfg, 2, 16)
    want = jm.forward(params, tokens=jnp.asarray(toks))
    got = tm.forward(tokens=torch.from_numpy(toks))
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got, want, LOGITS_TOL)


def _prefill_both(arch, S0=16, cache_len=24, no_drop=False):
    import jax.numpy as jnp

    jm, params, tm = _pair(arch, no_drop=no_drop)
    toks = _tokens(tm.cfg, 2, S0 + 4, seed=1)
    lj, cj = jm.prefill_with_cache(params, tokens=jnp.asarray(toks[:, :S0]),
                                   cache_len=cache_len)
    lt, ct = tm.prefill_with_cache(tokens=torch.from_numpy(toks[:, :S0]),
                                   cache_len=cache_len)
    return jm, params, tm, toks, (lj, cj), (lt, ct)


def _cache_close(ct, cj, what="", state_tol=STATE_TOL):
    """Every cache leaf: the JAX tree's keys, shapes and dtypes; bf16
    leaves to one bf16 ulp, fp32 state leaves to `state_tol`."""
    want = dict(tree_leaves(cj))
    got = dict(tree_leaves(ct))
    assert sorted(got) == sorted(want)
    for path, x in want.items():
        y = got[path]
        assert tuple(y.shape) == tuple(x.shape), path
        assert str(y.dtype).replace("torch.", "") == str(x.dtype), path
        msg = f"{'/'.join(path)} {what}"
        if y.dtype == torch.bfloat16:
            np.testing.assert_allclose(y.float().numpy(), _np(x),
                                       rtol=BF16_ULP, atol=1e-6, err_msg=msg)
        else:
            _close(y, x, state_tol, msg)


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_with_cache_matches_jax(arch):
    *_, (lj, cj), (lt, ct) = _prefill_both(arch)
    _close(lt, lj, LOGITS_TOL)
    _cache_close(ct, cj)


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_after_prefill_matches_jax(arch):
    """Teacher-forced decode steps after the prefill, step for step (MoE
    at capacity_factor = n_experts / top_k); then the cache against
    JAX's, its states to the decode tolerance: a state written after
    an attention layer read the bf16 cache."""
    import jax.numpy as jnp

    jm, params, tm, toks, (_, cj), (_, ct) = _prefill_both(arch,
                                                           no_drop=True)
    for t in range(16, 20):
        lj, cj = jm.decode_step(params, jnp.asarray(toks[:, t:t + 1]),
                                jnp.int32(t), cj)
        lt, ct = tm.decode_step(torch.from_numpy(toks[:, t:t + 1]), t, ct)
        assert lt.shape == (2, 1, tm.cfg.vocab_padded)
        _close(lt, lj, DECODE_TOL, f"position {t}")
    _cache_close(ct, cj, "after decode", state_tol=DECODE_TOL)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_decode_writes_the_callers_cache(arch):
    """Decode writes each SSM state into the cache tensors the caller
    holds (and returns that same tree): two steps change them twice."""
    _, _, tm = _pair(arch)
    toks = torch.from_numpy(_tokens(tm.cfg, 2, 18, seed=4))
    _, cache = tm.prefill_with_cache(tokens=toks[:, :16], cache_len=20)
    held = dict(tree_leaves(cache))
    states = {p: x for p, x in held.items()
              if p[-1] in ("ssm", "conv", "wkv", "shift_t", "shift_c")}
    assert states
    snaps = [{p: x.clone() for p, x in held.items()}]
    for t in (16, 17):
        _, out = tm.decode_step(toks[:, t:t + 1], t, cache)
        assert all(x is held[p] for p, x in tree_leaves(out))
        snaps.append({p: x.clone() for p, x in held.items()})
    for p in states:
        assert not torch.equal(snaps[0][p], snaps[1][p]), p
        assert not torch.equal(snaps[1][p], snaps[2][p]), p


@pytest.mark.parametrize("arch", FAMILIES)
def test_templates_match_jax(arch):
    """Parameter template leaf for leaf (shapes and logical axes),
    parameter counts, and the cache template's shapes and dtypes."""
    from repro.models import transformer as JT
    from repro.models.params import count_params as jax_count
    from repro.models.params import tree_axes as jax_axes
    from repro.models.params import tree_shapes as jax_shapes

    jcfg, tcfg = _cfgs(arch, "dense")
    tm = build_model(tcfg, device="cpu")
    jt = JT.model_template(jcfg)
    jp = {p: (tuple(s.shape), a) for (p, s), (_, a) in zip(
        tree_leaves(jax_shapes(jt)), tree_leaves(jax_axes(jt)))}
    tp = {p: (tuple(s.shape), s.axes) for p, s in tree_leaves(tm.template)}
    assert tp == jp
    assert tm.param_count() == jax_count(jt)
    assert tcfg.param_count() == jcfg.param_count()
    jc = {p: (tuple(s.shape), str(s.dtype)) for p, s in tree_leaves(
        JT.cache_template(jcfg, 2, 12))}
    tc = {p: (shape, str(dt).replace("torch.", ""))
          for p, (shape, dt) in tree_leaves(tm.cache_shapes(2, 12))}
    assert tc == jc
    cache = tm.init_cache(2, 12)
    assert all(not x.any() for _, x in tree_leaves(cache))


@pytest.mark.parametrize("arch", FAMILIES)
def test_greedy_serving_matches_jax(arch):
    """Greedy `BatchedServer.run(8)` (batch 4, max_new 4): the JAX
    server's token sequences."""
    from repro.serve.serve_step import BatchedServer as JaxServer
    from repro.serve.serve_step import ServeConfig as JaxServeConfig

    jm, params, tm = _pair(arch)
    js = JaxServer(jm, params, JaxServeConfig(cache_len=16), batch=4,
                   max_new=4)
    ts = BatchedServer(tm, ServeConfig(cache_len=16), batch=4, max_new=4)
    want = js.run(8)
    got = ts.run(8)
    assert len(got) == len(want) == 8 and got == want
    assert all(0 <= t < tm.cfg.vocab for seq in got for t in seq)


@pytest.mark.parametrize("arch", FAMILIES)
def test_build_model_serves_the_family(arch):
    """`build_model` accepts the config (published and smoke) and the
    model's parameter tree carries the family's leaves."""
    from repro.configs import get_config as jax_config
    from repro.models import transformer as JT
    from repro.models.params import count_params as jax_count
    from repro_torch.configs import get_config

    tm = build_model(get_smoke_config(arch), device="cpu")
    full = build_model(get_config(arch), device="cpu")   # no parameters yet
    assert full.param_count() == jax_count(JT.model_template(
        jax_config(arch)))
    paths = {"/".join(p) for p, _ in tree_leaves(tm.template)}
    want = {"granite-moe-1b-a400m": "groups/0:attn/ffn/router",
            "llama4-maverick-400b-a17b": "groups/0:attn/ffn/ws_gate",
            "zamba2-1.2b": "shared/attn/wq",
            "rwkv6-3b": "groups/0:rwkv6/rwkv/u_bonus"}[arch]
    assert want in paths
