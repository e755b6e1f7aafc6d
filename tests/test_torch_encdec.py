"""The port's encoder-decoder (whisper) serving path against the JAX
package's, on the CPU.

JAX parameters of the whisper smoke config from
`Model.init(jax.random.key(0))` are carried across with
`model_params_from_reference`; the same seeded numpy tokens and encoder
frames go through both packages.  fp32 throughout unless a test says
otherwise, so the tolerances state float reordering: encoder output,
forward and prefill logits agree to 1e-4; the bf16 cache (self- and
cross-attention keys and values) to one bf16 ulp (2^-7 relative);
decode logits, which read that cache, to 1e-3.  With bf16 weights and
fp32 frames (the mixed promotion: the encoder runs in fp32, the decoder
in bf16 until its first cross-attention promotes it) the encoder output
and a decoder layer agree to 1e-3 (measured 1.2e-6: both packages round
the same bf16 products)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api.convert import model_params_from_reference  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.serve.serve_step import (BatchedServer,  # noqa: E402
                                          ServeConfig, make_prefill)

ARCH = "whisper-base"
LOGITS_TOL = 1e-4
DECODE_TOL = 1e-3
BF16_ULP = 2.0 ** -7
MIXED_TOL = 1e-3
CHUNK = 8
ENC_T = 12

_CACHE: dict = {}


def _cfgs(impl: str):
    from repro.configs import get_smoke_config as jax_smoke

    kw = {"attn_impl": impl, "attn_chunk": CHUNK}
    return (dataclasses.replace(jax_smoke(ARCH), **kw),
            dataclasses.replace(get_smoke_config(ARCH), **kw))


def _pair(impl: str = "chunked"):
    """The JAX model and params and the port's model holding the same
    params, built once per impl."""
    if impl not in _CACHE:
        jax = pytest.importorskip("jax")
        from repro.models.model import build_model as jax_build

        jcfg, tcfg = _cfgs(impl)
        jm = jax_build(jcfg)
        params = jm.init(jax.random.key(0))
        tm = model_params_from_reference(jax.tree.map(np.asarray, params),
                                         tcfg, device="cpu")
        _CACHE[impl] = (jm, params, tm)
    return _CACHE[impl]


def _inputs(cfg, B: int, S: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    frames = rng.normal(size=(B, ENC_T, cfg.encoder.d_input)
                        ).astype(np.float32)
    return toks, frames


def _np(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def test_templates_match_jax():
    """Parameter template leaf for leaf (shape, axes, initializer), the
    encoder and the `xattn` blocks among them; the cache template with
    its cross-attention leaves of `enc_len` positions."""
    from repro.models import transformer as JT

    jcfg, tcfg = _cfgs("dense")
    jt = {p: (tuple(s.shape), tuple(s.axes), s.init) for p, s in
          tree_leaves(JT.model_template(jcfg))}
    tt = {p: (tuple(s.shape), tuple(s.axes), s.init) for p, s in
          tree_leaves(T.model_template(tcfg))}
    assert tt == jt
    assert ("encoder", "frontend") in tt
    assert ("groups", "0:attn", "xattn", "wq") in tt
    jc = {p: (tuple(s.shape), str(s.dtype)) for p, s in tree_leaves(
        JT.cache_template(jcfg, 2, 12, 8))}
    tc = {p: (shape, str(dt).replace("torch.", "")) for p, (shape, dt) in
          tree_leaves(T.cache_template(tcfg, 2, 12, 8))}
    assert tc == jc and ("0:attn", "xk") in tc


def test_encode_matches_jax():
    import jax.numpy as jnp
    from repro.models import transformer as JT

    jm, params, tm = _pair()
    _, frames = _inputs(tm.cfg, 2, 16)
    want = _np(JT.encode(jm.cfg, params, jnp.asarray(frames)))
    got = T.encode(tm.cfg, tm.params, torch.from_numpy(frames))
    assert got.shape == want.shape == (2, ENC_T, tm.cfg.d_model)
    np.testing.assert_allclose(got.numpy(), want, rtol=LOGITS_TOL,
                               atol=LOGITS_TOL)


@pytest.mark.parametrize("impl", ["dense", "chunked"])
def test_forward_matches_jax(impl):
    import jax.numpy as jnp

    jm, params, tm = _pair(impl)
    toks, frames = _inputs(tm.cfg, 2, 32)
    want = _np(jm.forward(params, tokens=jnp.asarray(toks),
                          enc_frames=jnp.asarray(frames)))
    got = tm.forward(tokens=torch.from_numpy(toks),
                     enc_frames=torch.from_numpy(frames))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=LOGITS_TOL,
                               atol=LOGITS_TOL)
    # make_prefill is the forward, encoder frames included
    torch.testing.assert_close(
        make_prefill(tm)(torch.from_numpy(toks),
                         enc_frames=torch.from_numpy(frames)), got)


def _prefill_both(S0=16, cache_len=24):
    import jax.numpy as jnp

    jm, params, tm = _pair()
    toks, frames = _inputs(tm.cfg, 2, S0 + 4, seed=1)
    lj, cj = jm.prefill_with_cache(params, tokens=jnp.asarray(toks[:, :S0]),
                                   enc_frames=jnp.asarray(frames),
                                   cache_len=cache_len)
    lt, ct = tm.prefill_with_cache(tokens=torch.from_numpy(toks[:, :S0]),
                                   enc_frames=torch.from_numpy(frames),
                                   cache_len=cache_len)
    return jm, params, tm, toks, (lj, cj), (lt, ct)


def test_prefill_with_cache_matches_jax():
    """Logits, then every cache leaf (`k`, `v`, `xk`, `xv`): the same tree
    keys, shapes and dtype (bf16), the values to one bf16 ulp."""
    *_, (lj, cj), (lt, ct) = _prefill_both()
    np.testing.assert_allclose(lt.numpy(), _np(lj), rtol=LOGITS_TOL,
                               atol=LOGITS_TOL)
    want = dict(tree_leaves(cj))
    got = dict(tree_leaves(ct))
    assert sorted(got) == sorted(want)
    assert {p[-1] for p in got} == {"k", "v", "xk", "xv"}
    for path, x in want.items():
        y = got[path]
        assert tuple(y.shape) == tuple(x.shape), path
        assert y.dtype == torch.bfloat16 and str(x.dtype) == "bfloat16", path
        np.testing.assert_allclose(y.float().numpy(), _np(x), rtol=BF16_ULP,
                                   atol=1e-6, err_msg="/".join(path))


def test_decode_after_prefill_matches_jax():
    """Teacher-forced decode steps after the prefill, step for step; the
    cross-attention cache is read and never written."""
    import jax.numpy as jnp

    jm, params, tm, toks, (_, cj), (_, ct) = _prefill_both()
    xk = ct["0:attn"]["xk"].clone()
    for t in range(16, 20):
        lj, cj = jm.decode_step(params, jnp.asarray(toks[:, t:t + 1]),
                                jnp.int32(t), cj)
        lt, ct = tm.decode_step(torch.from_numpy(toks[:, t:t + 1]), t, ct)
        assert lt.shape == (2, 1, tm.cfg.vocab_padded)
        np.testing.assert_allclose(lt.numpy(), _np(lj), rtol=DECODE_TOL,
                                   atol=DECODE_TOL, err_msg=f"position {t}")
    assert torch.equal(ct["0:attn"]["xk"], xk)


def test_greedy_serving_matches_jax():
    """`BatchedServer.run(8)` (batch 4, max_new 4, a zero cross-attention
    cache of 8 encoder positions) gives the JAX server's token
    sequences."""
    from repro.serve.serve_step import BatchedServer as JaxServer
    from repro.serve.serve_step import ServeConfig as JaxServeConfig

    jm, params, tm = _pair()
    js = JaxServer(jm, params, JaxServeConfig(cache_len=16), batch=4,
                   max_new=4)
    ts = BatchedServer(tm, ServeConfig(cache_len=16), batch=4, max_new=4)
    assert tuple(ts.cache["0:attn"]["xk"].shape)[2] == 8
    want = js.run(8)
    got = ts.run(8)
    assert got == want and got


def test_fp32_frames_with_bf16_weights_match_jax():
    """bf16 weights against fp32 frames: the encoder runs in fp32 (the
    frontend cast to the frames' dtype); in a decoder layer the
    cross-attention keys and values promote to fp32 as `jnp.einsum`
    promotes, and so does the residual after it; the prefill's `xk` /
    `xv` are stored in bf16.  Held against JAX layer by layer: JAX's
    whole forward scans the groups with `lax.scan`, which refuses the
    carry's change from bf16 to fp32, while the port's loop takes it
    (finite fp32 logits)."""
    import jax
    import jax.numpy as jnp
    from repro.models import transformer as JT

    jm, params, _ = _pair("dense")
    bf = jax.tree.map(lambda x: x.astype(jnp.bfloat16), params)
    cfg = _cfgs("dense")[1]
    tm = model_params_from_reference(
        jax.tree.map(lambda x: np.asarray(x, np.float32), bf), cfg,
        device="cpu", dtype=torch.bfloat16)
    toks, frames = _inputs(cfg, 2, 16, seed=2)
    enc_j = JT.encode(jm.cfg, bf, jnp.asarray(frames))
    enc_t = T.encode(cfg, tm.params, torch.from_numpy(frames))
    assert str(enc_j.dtype) == "float32" and enc_t.dtype == torch.float32
    np.testing.assert_allclose(enc_t.numpy(), _np(enc_j), rtol=MIXED_TOL,
                               atol=MIXED_TOL)

    rng = np.random.default_rng(3)
    h = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    h_j = jnp.asarray(h).astype(jnp.bfloat16)
    h_t = torch.from_numpy(h).to(torch.bfloat16)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16)).copy()
    gp_j = jax.tree.map(lambda x: x[0], bf["groups"])["0:attn"]
    gp_t = T._groups(tm.params["groups"], 1)[0]["0:attn"]
    want = JT._apply_layer_train(jm.cfg, "attn", gp_j, h_j, jnp.asarray(pos),
                                 enc_out=enc_j)
    got = T._apply_layer_train(cfg, "attn", gp_t, h_t, torch.from_numpy(pos),
                               enc_out=torch.tensor(_np(enc_j)))
    assert str(want.dtype) == "float32" and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=MIXED_TOL,
                               atol=MIXED_TOL)
    _, ej = JT._apply_layer_prefill(jm.cfg, "attn", gp_j, h_j,
                                    jnp.asarray(pos), 20, enc_out=enc_j)
    _, et = T._apply_layer_prefill(cfg, "attn", gp_t, h_t,
                                   torch.from_numpy(pos), 20,
                                   enc_out=torch.tensor(_np(enc_j)))
    for name in ("xk", "xv"):
        assert et[name].dtype == torch.bfloat16
        np.testing.assert_allclose(et[name].float().numpy(), _np(ej[name]),
                                   rtol=BF16_ULP, atol=1e-6, err_msg=name)
    logits = tm.forward(tokens=torch.from_numpy(toks),
                        enc_frames=torch.from_numpy(frames))
    assert logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all())
