"""The port's LM serving path against the JAX package's, on the CPU.

JAX parameters from `Model.init(jax.random.key(0))` are carried across
with `model_params_from_reference`; the same seeded numpy tokens go
through both packages.  fp32 throughout, so the tolerances state float
reordering: forward and prefill logits agree to 1e-4 (measured ~1e-5);
the bf16 decode cache to one bf16 ulp (2^-7 relative: a float32 value a
few ulps from a bf16 rounding boundary may round the other way); decode
logits, which read that cache, to 1e-3.  The chunked path runs the
`flash_attention` wrapper, whose plain version stands in on the CPU."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api.convert import model_params_from_reference  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.params import (count_params, init_params,  # noqa: E402
                                       tree_leaves)
from repro_torch.serve.serve_step import (BatchedServer,  # noqa: E402
                                          ServeConfig, make_prefill,
                                          make_serve_step)

DENSE = ["qwen2.5-32b", "deepseek-67b", "gemma3-12b", "granite-20b",
         "qwen2-vl-2b"]
FAMILIES = ["granite-moe-1b-a400m", "llama4-maverick-400b-a17b",
            "qwen2.5-32b", "deepseek-67b", "gemma3-12b", "granite-20b",
            "rwkv6-3b", "qwen2-vl-2b", "whisper-base", "zamba2-1.2b"]
LOGITS_TOL = 1e-4
DECODE_TOL = 1e-3
BF16_ULP = 2.0 ** -7
CHUNK = 8

_CACHE: dict = {}


def _cfgs(arch: str, impl: str):
    """(JAX config, port config) with `attn_impl=impl`, chunk 8."""
    from repro.configs import get_smoke_config as jax_smoke

    kw = {"attn_impl": impl, "attn_chunk": CHUNK}
    return (dataclasses.replace(jax_smoke(arch), **kw),
            dataclasses.replace(get_smoke_config(arch), **kw))


def _pair(arch: str, impl: str = "chunked"):
    """The JAX model and params and the port's model holding the same
    params, built once per (arch, impl)."""
    if (arch, impl) not in _CACHE:
        jax = pytest.importorskip("jax")
        from repro.models.model import build_model as jax_build

        jcfg, tcfg = _cfgs(arch, impl)
        jm = jax_build(jcfg)
        params = jm.init(jax.random.key(0))
        params_np = jax.tree.map(np.asarray, params)
        tm = model_params_from_reference(params_np, tcfg, device="cpu")
        _CACHE[(arch, impl)] = (jm, params, tm)
    return _CACHE[(arch, impl)]


def _tokens(cfg, B: int, S: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)


def _np(x) -> np.ndarray:
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("impl", ["dense", "chunked"])
@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_jax(arch, impl):
    import jax.numpy as jnp

    jm, params, tm = _pair(arch, impl)
    toks = _tokens(tm.cfg, 2, 32)
    want = _np(jm.forward(params, tokens=jnp.asarray(toks)))
    got = tm.forward(tokens=torch.from_numpy(toks))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=LOGITS_TOL,
                               atol=LOGITS_TOL)


def _prefill_both(arch, S0=16, cache_len=24):
    import jax.numpy as jnp

    jm, params, tm = _pair(arch)
    toks = _tokens(tm.cfg, 2, S0 + 4, seed=1)
    lj, cj = jm.prefill_with_cache(params, tokens=jnp.asarray(toks[:, :S0]),
                                   cache_len=cache_len)
    lt, ct = tm.prefill_with_cache(tokens=torch.from_numpy(toks[:, :S0]),
                                   cache_len=cache_len)
    return jm, params, tm, toks, (lj, cj), (lt, ct)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_with_cache_matches_jax(arch):
    """Logits and every cache leaf: the same tree keys, shapes and dtype
    (bf16), the values compared in fp32."""
    *_, (lj, cj), (lt, ct) = _prefill_both(arch)
    np.testing.assert_allclose(lt.numpy(), _np(lj), rtol=LOGITS_TOL,
                               atol=LOGITS_TOL)
    want = dict(tree_leaves(cj))
    got = dict(tree_leaves(ct))
    assert sorted(got) == sorted(want)
    for path, x in want.items():
        y = got[path]
        assert tuple(y.shape) == tuple(x.shape), path
        assert y.dtype == torch.bfloat16 and str(x.dtype) == "bfloat16", path
        np.testing.assert_allclose(y.float().numpy(), _np(x), rtol=BF16_ULP,
                                   atol=1e-6, err_msg="/".join(path))


@pytest.mark.parametrize("arch", DENSE)
def test_decode_after_prefill_matches_jax(arch):
    """Teacher-forced decode steps after the prefill, step for step,
    including rolling-window slots (gemma3's window is 8 < 20)."""
    import jax.numpy as jnp

    jm, params, tm, toks, (_, cj), (_, ct) = _prefill_both(arch)
    for t in range(16, 20):
        lj, cj = jm.decode_step(params, jnp.asarray(toks[:, t:t + 1]),
                                jnp.int32(t), cj)
        lt, ct = tm.decode_step(torch.from_numpy(toks[:, t:t + 1]), t, ct)
        assert lt.shape == (2, 1, tm.cfg.vocab_padded)
        np.testing.assert_allclose(lt.numpy(), _np(lj), rtol=DECODE_TOL,
                                   atol=DECODE_TOL, err_msg=f"position {t}")


def test_decode_reproduces_forward():
    """The port's own handoff: prefill 8 tokens, then teacher-forced
    decode reproduces the forward's logits at the continued positions
    (the JAX handoff test's tolerance, 3e-2: the cache is bf16)."""
    _, _, tm = _pair("gemma3-12b")
    toks = torch.from_numpy(_tokens(tm.cfg, 1, 12, seed=7))
    full = tm.forward(tokens=toks)
    logits0, cache = tm.prefill_with_cache(tokens=toks[:, :8], cache_len=16)
    torch.testing.assert_close(logits0, full[:, :8], rtol=3e-2, atol=3e-2)
    for t in range(8, 12):
        logits, cache = tm.decode_step(toks[:, t:t + 1], t, cache)
        torch.testing.assert_close(logits[:, 0], full[:, t], rtol=3e-2,
                                   atol=3e-2)


def _count_flash(monkeypatch) -> list:
    calls = []
    real = ops.flash_attention

    def counting(q, k, v, window=0):
        calls.append(window)
        return real(q, k, v, window)

    monkeypatch.setattr(ops, "flash_attention", counting)
    return calls


def test_chunked_runs_flash_attention_in_every_layer(monkeypatch):
    """With attn_impl="chunked" every causal self-attention of a prefill
    goes through `ops.flash_attention` (the window of each layer
    passed), and decode never does."""
    _, _, tm = _pair("gemma3-12b")
    calls = _count_flash(monkeypatch)
    toks = torch.from_numpy(_tokens(tm.cfg, 2, 16))
    _, cache = tm.prefill_with_cache(tokens=toks, cache_len=20)
    cfg = tm.cfg
    assert calls == [cfg.window if kind == "swa" else 0
                     for kind in cfg.block_pattern] * cfg.n_groups
    tm.decode_step(toks[:, :1], 16, cache)
    assert len(calls) == cfg.n_layers


def test_chunked_fallback_on_indivisible_seq(monkeypatch):
    """Sequences not divisible by the chunk take the dense path, as in
    the JAX package (tests/test_chunked_attention.py), with its output."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as jax_smoke
    from repro.models.model import build_model as jax_build

    jcfg = dataclasses.replace(jax_smoke("qwen2.5-32b"), attn_impl="chunked",
                               attn_chunk=64)
    jm = jax_build(jcfg)
    params = jm.init(jax.random.key(4))
    tcfg = dataclasses.replace(get_smoke_config("qwen2.5-32b"),
                               attn_impl="chunked", attn_chunk=64)
    tm = model_params_from_reference(jax.tree.map(np.asarray, params), tcfg,
                                     device="cpu")
    calls = _count_flash(monkeypatch)
    toks = _tokens(tcfg, 1, 10, seed=5)
    got = tm.forward(tokens=torch.from_numpy(toks))
    assert calls == []
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(
        got.numpy(), _np(jm.forward(params, tokens=jnp.asarray(toks))),
        rtol=LOGITS_TOL, atol=LOGITS_TOL)


def test_greedy_serving_matches_jax():
    """`make_serve_step` greedy and `BatchedServer.run(8)` (gemma3 smoke,
    batch 4, max_new 4) give the JAX server's token sequences."""
    from repro.serve.serve_step import BatchedServer as JaxServer
    from repro.serve.serve_step import ServeConfig as JaxServeConfig

    jm, params, tm = _pair("gemma3-12b")
    js = JaxServer(jm, params, JaxServeConfig(cache_len=16), batch=4,
                   max_new=4)
    ts = BatchedServer(tm, ServeConfig(cache_len=16), batch=4, max_new=4)
    want = js.run(8)
    got = ts.run(8)
    assert len(got) == 8 and got == want
    assert all(0 <= t < tm.cfg.vocab for seq in got for t in seq)


def test_serve_step_greedy_after_prefill_matches_jax():
    """Six greedy steps from a prompt, the tokens fed back, through both
    packages' `make_serve_step`."""
    import jax
    import jax.numpy as jnp
    from repro.serve.serve_step import ServeConfig as JaxServeConfig
    from repro.serve.serve_step import make_serve_step as jax_step

    jm, params, tm = _pair("qwen2.5-32b")
    toks = _tokens(tm.cfg, 3, 8, seed=3)
    _, cj = jm.prefill_with_cache(params, tokens=jnp.asarray(toks),
                                  cache_len=16)
    _, ct = tm.prefill_with_cache(tokens=torch.from_numpy(toks),
                                  cache_len=16)
    jstep = jax_step(jm, JaxServeConfig(cache_len=16))
    tstep = make_serve_step(tm, ServeConfig(cache_len=16))
    jt = jnp.asarray(toks[:, -1:])
    tt = torch.from_numpy(toks[:, -1:])
    for pos in range(8, 14):
        jt, cj = jstep(params, cj, jt, jnp.int32(pos), jax.random.key(pos))
        tt, ct = tstep(ct, tt, pos)
        assert tt.dtype == torch.int32 and tt.shape == (3, 1)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_argmax_takes_the_first_maximum(monkeypatch):
    """Greedy ties resolve to the lowest token id, as `jnp.argmax`."""
    _, _, tm = _pair("gemma3-12b")
    step = make_serve_step(tm, ServeConfig())
    logits = torch.zeros((2, 1, tm.cfg.vocab_padded))
    logits[:, :, 5] = logits[:, :, 9] = 1.0
    monkeypatch.setattr(tm, "decode_step",
                        lambda token, pos, cache: (logits, cache))
    nxt, _ = step({}, torch.zeros((2, 1), dtype=torch.int32), 0)
    assert nxt.tolist() == [[5], [5]]


def test_sampling_follows_the_generator():
    """temperature > 0 samples with the caller's generator: the same seed
    gives the same tokens, all in the vocabulary."""
    _, _, tm = _pair("deepseek-67b")
    runs = []
    for _ in range(2):
        srv = BatchedServer(tm, ServeConfig(temperature=1.0, cache_len=8),
                            batch=3, max_new=2)
        runs.append(srv.run(4, generator=torch.Generator().manual_seed(11)))
    assert runs[0] == runs[1] and len(runs[0]) == 6
    assert all(0 <= t < tm.cfg.vocab for seq in runs[0] for t in seq)


def test_make_prefill_is_forward():
    _, _, tm = _pair("granite-20b")
    toks = torch.from_numpy(_tokens(tm.cfg, 1, 8))
    torch.testing.assert_close(make_prefill(tm)(toks), tm.forward(tokens=toks))


@pytest.mark.parametrize("arch", DENSE)
def test_templates_match_jax(arch):
    """Parameter and cache templates: the JAX trees' paths, shapes and
    dtypes, and parameter counts; the model's one parameter tree, `params`,
    has the template's paths and shapes."""
    from repro.models import transformer as JT
    from repro.models.params import tree_shapes as jax_shapes

    jcfg, tcfg = _cfgs(arch, "dense")
    tm = build_model(tcfg, device="cpu")
    jp = {p: tuple(s.shape)
          for p, s in tree_leaves(jax_shapes(JT.model_template(jcfg)))}
    tp = {p: tuple(s.shape) for p, s in tree_leaves(tm.template)}
    assert tp == jp
    from repro.models.params import count_params as jax_count

    assert count_params(tm.template) == jax_count(JT.model_template(jcfg))
    assert tm.param_count() == count_params(tm.template)
    assert tcfg.param_count() == jcfg.param_count()
    jc = {p: (tuple(s.shape), str(s.dtype)) for p, s in tree_leaves(
        JT.cache_template(jcfg, 2, 12))}
    tc = {p: (shape, str(dt).replace("torch.", ""))
          for p, (shape, dt) in tree_leaves(tm.cache_shapes(2, 12))}
    assert tc == jc
    tm.init(torch.Generator().manual_seed(0))
    assert {p: tuple(x.shape) for p, x in tree_leaves(tm.params)} == tp
    cache = tm.init_cache(2, 12)
    assert all(x.dtype == torch.bfloat16 and not x.any()
               for _, x in tree_leaves(cache))


def test_init_params_draws_the_jax_initializers():
    """zeros / ones / fan-in `scaled` / normal(0.02): shapes, dtype, and
    the std of each kind; the same seed gives the same parameters."""
    tcfg = get_smoke_config("qwen2.5-32b")
    a = build_model(tcfg, device="cpu").init(torch.Generator().manual_seed(3),
                                             dtype=torch.bfloat16)
    b = build_model(tcfg, device="cpu").init(torch.Generator().manual_seed(3),
                                             dtype=torch.bfloat16)
    pa = dict(tree_leaves(a.params))
    for path, x in tree_leaves(b.params):
        assert x.dtype == torch.bfloat16 and torch.equal(x, pa[path])
    attn = a.params["groups"]["0:attn"]["attn"]
    assert not attn["bq"].any() and bool((attn["norm"]["scale"] == 1).all())
    d = tcfg.d_model
    assert abs(float(attn["wq"].float().std()) - d ** -0.5) < 0.1 * d ** -0.5
    assert abs(float(a.params["embed"].float().std()) - 0.02) < 0.002
    with pytest.raises(ValueError, match="generator"):
        init_params(a.template, torch.Generator(), device="meta")


def test_params_from_reference_in_bf16():
    """bf16 weights cross as float32 numpy and are cast on the way in."""
    _, params, tm = _pair("granite-20b")
    import jax

    m = model_params_from_reference(jax.tree.map(np.asarray, params), tm.cfg,
                                    device="cpu", dtype=torch.bfloat16)
    for path, x in tree_leaves(m.params):
        assert x.dtype == torch.bfloat16 and not x.requires_grad
    with pytest.raises(ValueError, match="differs from the template"):
        model_params_from_reference({"embed": np.zeros((128, 64))}, tm.cfg,
                                    device="cpu")


def test_model_without_params_raises():
    tm = build_model(get_smoke_config("deepseek-67b"), device="cpu")
    with pytest.raises(RuntimeError, match="no parameters"):
        tm.forward(tokens=torch.zeros((1, 4), dtype=torch.int32))


@pytest.mark.parametrize("arch", FAMILIES)
def test_build_model_accepts_every_family(arch):
    """`build_model` takes each of the ten published configs; its template
    equals the JAX package's leaf for leaf (path, shape, logical axes,
    initializer), and so does the parameter count."""
    from repro.configs import get_config as jax_config
    from repro.models import transformer as JT

    from repro_torch.configs import get_config

    tm = build_model(get_config(arch), device="cpu")
    jt = {p: (tuple(s.shape), tuple(s.axes), s.init) for p, s in
          tree_leaves(JT.model_template(jax_config(arch)))}
    tt = {p: (tuple(s.shape), tuple(s.axes), s.init) for p, s in
          tree_leaves(tm.template)}
    assert tt == jt
    assert tm.param_count() == count_params(T.model_template(tm.cfg))
    assert tm.cfg.param_count() == jax_config(arch).param_count()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 3e-3),
                                       (torch.bfloat16, 5e-2)])
def test_chunked_forward_on_card_matches_dense(dtype, tol):
    """On the card the chunked path launches the kernel once per layer
    and agrees with the dense path (3e-3 in fp32, the JAX test's; 5e-2
    in bf16, where the dense path rounds its scores to bf16 and the
    kernel keeps them in fp32: the plain version, which keeps them in
    fp32 too, differs from the dense path by 0.010-0.013 on the CPU);
    decode launches nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import flash_attn as fa

    cfg = dataclasses.replace(get_smoke_config("gemma3-12b"),
                              attn_impl="chunked", attn_chunk=CHUNK)
    chunked = build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0), dtype=dtype)
    dense = build_model(dataclasses.replace(cfg, attn_impl="dense")
                        ).load_params(chunked.params)
    toks = torch.from_numpy(_tokens(cfg, 2, 32)).cuda()
    before = fa.launches
    got = chunked.forward(tokens=toks)
    assert fa.launches == before + cfg.n_layers
    want = dense.forward(tokens=toks)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    _, cache = chunked.prefill_with_cache(tokens=toks, cache_len=40)
    chunked.decode_step(toks[:, :1], 32, cache)
    assert fa.launches == before + 2 * cfg.n_layers
