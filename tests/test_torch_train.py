"""The port's training substrate on the CPU: twins of
`tests/test_train_substrate.py` and `tests/test_grad_compression.py`
(with their sizes and tolerances), remat, and the gradient of the
`flash_attention` autograd Function.  Parity of whole train steps with
the JAX package, and checkpoints across the two, are in
`tests/test_torch_train_parity.py`.

The attention gradient is held to 1e-4 against autograd of the plain
version and against `jax.grad` of JAX's chunked attention (fp32; the
measured gap is about 1e-6); a train step through the Function to 1e-4
against the dense path.  The twin of `test_elastic_restore_new_mesh`
is in `tests/test_torch_sharding.py`."""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import checkpoint as C  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import (PipelineConfig,  # noqa: E402
                                       RDFTokenPipeline, SyntheticPipeline)
from repro_torch.distributed.fault import (StragglerMonitor,  # noqa: E402
                                           TrainSupervisor)
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.params import tree_leaves, tree_map  # noqa: E402
from repro_torch.train.optimizer import (OptConfig, lr_at,  # noqa: E402
                                         opt_state_shapes)
from repro_torch.train.train_step import (TrainConfig,  # noqa: E402
                                          init_train_state, make_train_step,
                                          train_state_shapes, value_and_grad)

GRAD_TOL = 1e-4
ATTN_TOL = 1e-4


def _gen(seed: int = 0) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _batch(rng, B: int = 4, S: int = 16, lo: int = 8, hi: int = 100):
    t = rng.integers(lo, hi, size=(B, S)).astype(np.int32)
    return {"tokens": t, "labels": np.roll(t, -1, axis=1)}


def _torch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


@pytest.fixture(scope="module")
def setup():
    cfg = get_smoke_config("qwen2.5-32b")
    model = build_model(cfg, device="cpu")
    tc = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2, total_steps=50),
                     remat="none")
    state = init_train_state(model, tc, _gen(0))
    return model, tc, state, make_train_step(model, tc)


# ----------------------------------------------------------------------
# twins of tests/test_train_substrate.py
# ----------------------------------------------------------------------
def test_loss_decreases_over_steps(setup):
    model, tc, state, step = setup
    # memorize one small batch: loss must drop steeply
    batch = _torch(_batch(np.random.default_rng(0)))
    losses = []
    for _ in range(20):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] * 0.7, losses[:3] + losses[-3:]
    assert all(np.isfinite(losses))


def test_grad_accumulation_matches_full_batch():
    cfg = get_smoke_config("granite-20b")
    model = build_model(cfg, device="cpu")
    base = TrainConfig(opt=OptConfig(lr=1e-3, clip_norm=1e9), remat="none")
    accum = TrainConfig(opt=OptConfig(lr=1e-3, clip_norm=1e9), remat="none",
                        accum_steps=2)
    state0 = init_train_state(model, base, _gen(1))
    batch = _torch(_batch(np.random.default_rng(1)))
    s1, m1 = make_train_step(model, base)(state0, batch)
    s2, m2 = make_train_step(model, accum)(state0, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-5)
    for (_, a), (_, b) in zip(tree_leaves(s1["params"]),
                              tree_leaves(s2["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=2e-6)


def test_lr_schedule():
    oc = OptConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    i32 = lambda n: torch.tensor(n, dtype=torch.int32)  # noqa: E731
    assert float(lr_at(oc, i32(0))) == 0.0
    assert abs(float(lr_at(oc, i32(10))) - 1.0) < 1e-6
    assert float(lr_at(oc, i32(100))) == pytest.approx(0.1, rel=1e-3)


def test_checkpoint_restart_bitwise(tmp_path, setup):
    """Preemption drill: train 6 steps with saves, 'crash', resume from
    step 4, replay -> final state identical to the uninterrupted run."""
    model, tc, state0, step = setup
    rng = np.random.default_rng(2)
    batches = [_torch(_batch(rng)) for _ in range(6)]

    ckpt = str(tmp_path / "ckpts")
    sup = TrainSupervisor(ckpt, save_every=2, keep=5)
    state = state0
    for i, b in enumerate(batches, start=1):
        state, _ = step(state, b)
        sup.maybe_save(i, state)
    final_uninterrupted = state

    state_r, start = sup.resume_or_init(lambda: state0)
    assert start == 6
    for (_, a), (_, b) in zip(tree_leaves(final_uninterrupted),
                              tree_leaves(state_r)):
        assert isinstance(b, torch.Tensor) and torch.equal(a, b)
    state4 = C.restore(ckpt, 4, state0)
    assert state4["opt"]["step"].dtype == torch.int32
    assert int(state4["opt"]["step"]) == 4
    for b in batches[4:]:
        state4, _ = step(state4, b)
    for (_, a), (_, b) in zip(tree_leaves(final_uninterrupted),
                              tree_leaves(state4)):
        assert torch.equal(a, b)


def test_checkpoint_gc_and_atomicity(tmp_path):
    ckpt = str(tmp_path / "gc")
    for s in [1, 2, 3, 4, 5]:
        C.save(ckpt, s, {"x": torch.ones((4,)) * s}, keep=2)
    assert C.list_steps(ckpt) == [4, 5]
    assert not any(p.endswith(".tmp") for p in os.listdir(ckpt))


def test_straggler_monitor():
    mon = StragglerMonitor(window=10, threshold=2.0)
    for _ in range(10):
        for host in range(8):
            mon.record(host, 1.0 + 0.01 * host)
        mon.record(8, 5.0)  # slow host
    assert mon.check() == {8}


def test_rdf_pipeline_feeds_training():
    """End-to-end paper->trainer integration: wizard-tuned views feed
    token batches; the port's token stream equals the JAX package's over
    the same generated store."""
    from repro.core.search import SearchConfig as JSearch
    from repro.core.wizard import WizardConfig as JWizard
    from repro.core.wizard import tune as jtune
    from repro.data.pipeline import PipelineConfig as JPipeCfg
    from repro.data.pipeline import RDFTokenPipeline as JPipe
    from repro.rdf.generator import generate as jgenerate
    from repro.rdf.generator import lubm_workload as jworkload

    from repro_torch.core.search import SearchConfig
    from repro_torch.core.wizard import WizardConfig, tune
    from repro_torch.rdf.generator import generate, lubm_workload

    small = dict(dept_per_univ=1, prof_per_dept=3, stud_per_dept=8,
                 course_per_dept=4)
    uni = generate(1, seed=0, **small)
    rep = tune(uni.store, lubm_workload(uni.dictionary), uni.schema,
               uni.type_id,
               WizardConfig(search=SearchConfig(strategy="greedy",
                                                max_states=100)),
               device="cpu")
    cfg = get_smoke_config("rwkv6-3b")
    pcfg = PipelineConfig(seq_len=16, batch_size=2, vocab=cfg.vocab)
    pipe_t = RDFTokenPipeline(rep.executor, pcfg)
    juni = jgenerate(1, seed=0, **small)
    jrep = jtune(juni.store, jworkload(juni.dictionary), juni.schema,
                 juni.type_id,
                 JWizard(search=JSearch(strategy="greedy", max_states=100)))
    pipe_j = JPipe(jrep.executor, JPipeCfg(seq_len=16, batch_size=2,
                                           vocab=cfg.vocab))
    np.testing.assert_array_equal(pipe_t.stream, pipe_j.stream)

    model = build_model(cfg, device="cpu")
    tc = TrainConfig(remat="none")
    state = init_train_state(model, tc, _gen(3))
    step = make_train_step(model, tc)
    it = iter(pipe_t)
    for _ in range(3):
        state, metrics = step(state, _torch(next(it)))
        assert np.isfinite(float(metrics["loss"]))


# ----------------------------------------------------------------------
# twins of tests/test_grad_compression.py
# ----------------------------------------------------------------------
def _vocab_batch(cfg, seed=0):
    return _torch(_batch(np.random.default_rng(seed), hi=cfg.vocab))


def test_bf16_gradient_reduction_tracks_fp32():
    cfg = get_smoke_config("granite-20b")
    model = build_model(cfg, device="cpu")
    batch = _vocab_batch(cfg)
    ref_tc = TrainConfig(opt=OptConfig(lr=1e-3), remat="none")
    cmp_tc = TrainConfig(opt=OptConfig(lr=1e-3), remat="none",
                         grad_dtype=torch.bfloat16)
    state = init_train_state(model, ref_tc, _gen(0))
    s_ref, m_ref = make_train_step(model, ref_tc)(state, batch)
    s_cmp, m_cmp = make_train_step(model, cmp_tc)(state, batch)
    assert abs(float(m_ref["loss"]) - float(m_cmp["loss"])) < 1e-5
    # parameters after one step stay close (bf16 grads ~1e-2 relative)
    for (_, a), (_, b) in zip(tree_leaves(s_ref["params"]),
                              tree_leaves(s_cmp["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0.05, atol=5e-4)


def test_bf16_moments_training_stable():
    cfg = get_smoke_config("rwkv6-3b")
    model = build_model(cfg, device="cpu")
    tc = TrainConfig(opt=OptConfig(lr=1e-3, m_dtype=torch.bfloat16,
                                   v_dtype=torch.bfloat16), remat="none")
    state = init_train_state(model, tc, _gen(1))
    assert state["opt"]["m"]["embed"].dtype == torch.bfloat16
    step = make_train_step(model, tc)
    batch = _vocab_batch(cfg, seed=1)
    losses = []
    for _ in range(10):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_same_gradients(remat):
    """Checkpointing each group recomputes it in the backward pass and
    changes no number: the gradients equal those without remat."""
    cfg = get_smoke_config("gemma3-12b")
    model = build_model(cfg, device="cpu")
    base = TrainConfig(remat="none")
    params = init_train_state(model, base, _gen(6))["params"]
    batch = _vocab_batch(cfg, seed=6)
    _, g0 = value_and_grad(model, params, batch, base)
    _, g1 = value_and_grad(model, params, batch,
                           dataclasses.replace(base, remat=remat))
    for (path, a), (_, b) in zip(tree_leaves(g0), tree_leaves(g1)):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-7,
                                   msg=lambda m: f"{path}: {m}")


def test_chunked_train_step_matches_dense():
    """A train step through `flash_attention` (its autograd Function, the
    plain version forward on the CPU) gives the dense path's gradients
    and update; the Function is really on the path."""
    cfg = dataclasses.replace(get_smoke_config("gemma3-12b"),
                              attn_impl="chunked", attn_chunk=8)
    chunked = build_model(cfg, device="cpu")
    dense = build_model(dataclasses.replace(cfg, attn_impl="dense"),
                        device="cpu")
    tc = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=1), remat="full")
    state = init_train_state(chunked, tc, _gen(4))
    batch = _vocab_batch(cfg, seed=4)
    calls = []
    real = ops._FlashAttention.backward

    def counting(ctx, dout):
        calls.append(dout.shape)
        return real(ctx, dout)

    ops._FlashAttention.backward = staticmethod(counting)
    try:
        lc, gc = value_and_grad(chunked, state["params"], batch, tc)
    finally:
        ops._FlashAttention.backward = staticmethod(real)
    assert len(calls) == cfg.n_layers
    ld, gd = value_and_grad(dense, state["params"], batch, tc)
    np.testing.assert_allclose(float(lc), float(ld), rtol=1e-5)
    for (path, a), (_, b) in zip(tree_leaves(gc), tree_leaves(gd)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg="/".join(path))
    sc, mc = make_train_step(chunked, tc)(state, batch)
    sd, md = make_train_step(dense, tc)(state, batch)
    np.testing.assert_allclose(float(mc["grad_norm"]), float(md["grad_norm"]),
                               rtol=1e-5)


def test_train_state_shapes():
    model = build_model(get_smoke_config("granite-20b"), device="cpu")
    tc = TrainConfig(opt=OptConfig(m_dtype=torch.bfloat16))
    shapes = train_state_shapes(model, tc)
    state = init_train_state(model, tc, _gen(0))
    got = {p: sd for p, sd in tree_leaves(shapes)}
    for path, x in tree_leaves(state):
        shape, dtype = got[path]
        assert tuple(x.shape) == shape, path
        if path[0] == "opt":
            assert x.dtype == dtype, path
    assert shapes["opt"] == opt_state_shapes(shapes["params"], tc.opt)
    assert got[("opt", "step")] == ((), torch.int32)


# ----------------------------------------------------------------------
# the attention gradient
# ----------------------------------------------------------------------
ATTN_CASES = [(2, 37, 4, 2, 16, 0), (2, 37, 4, 2, 16, 5),
              (1, 40, 4, 4, 32, 0), (1, 40, 4, 4, 32, 11)]


@pytest.mark.parametrize("B,S,H,Hkv,hd,window", ATTN_CASES)
def test_attention_backward_matches_autograd_of_plain(B, S, H, Hkv, hd,
                                                      window, monkeypatch):
    """The Function's gradient (blocks of 16 positions: S = 37 and 40 end
    in a ragged block) against autograd through the plain version."""
    monkeypatch.setattr(ops, "ATTN_BWD_BLOCK", 16)
    rng = np.random.default_rng(S + window)
    q, k, v = (torch.tensor(rng.normal(size=shape).astype(np.float32),
                            requires_grad=True)
               for shape in ((B, S, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd)))
    dout = torch.tensor(rng.normal(size=(B, S, H, hd)).astype(np.float32))
    got = torch.autograd.grad(ops.flash_attention(q, k, v, window), (q, k, v),
                              dout)
    want = torch.autograd.grad(ref.flash_attention_ref(q, k, v, window),
                               (q, k, v), dout)
    for name, a, b in zip("qkv", got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=ATTN_TOL, atol=ATTN_TOL,
                                   msg=lambda m: f"d{name}: {m}")


@pytest.mark.parametrize("n_kv,window", [(2, 0), (2, 5), (4, 0), (4, 9)])
def test_attention_grad_matches_jax_chunked(n_kv, window, monkeypatch):
    """`jax.grad` of JAX's `attention_train` with attn_impl="chunked"
    (its chunked online softmax, differentiated by XLA) against the
    port's through the `flash_attention` Function, for the layer's
    parameters and input; GQA 4/2 and MHA 4/4, window 0 and a window,
    S = 24 over backward blocks of 16 (a ragged last block)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as jax_smoke
    from repro.models import layers as JL
    from repro.models.params import init_params as jinit

    monkeypatch.setattr(ops, "ATTN_BWD_BLOCK", 16)
    kw = dict(attn_impl="chunked", attn_chunk=8, n_heads=4, n_kv_heads=n_kv)
    jcfg = dataclasses.replace(jax_smoke("qwen2.5-32b"), **kw)
    tcfg = dataclasses.replace(get_smoke_config("qwen2.5-32b"), **kw)
    p = jinit(JL.attention_template(jcfg), jax.random.key(window + n_kv))
    rng = np.random.default_rng(window)
    x = rng.normal(size=(2, 24, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24)).copy()
    w_out = rng.normal(size=(2, 24, jcfg.d_model)).astype(np.float32)

    def jloss(p, x):
        y = JL.attention_train(p, jcfg, x, jnp.asarray(pos), window=window)
        return jnp.sum(y * w_out)

    gp_j, gx_j = jax.grad(jloss, argnums=(0, 1))(p, jnp.asarray(x))
    pt = tree_map(lambda a: torch.tensor(np.asarray(a), requires_grad=True),
                  jax.tree.map(np.asarray, p))
    xt = torch.tensor(x, requires_grad=True)
    y = L.attention_train(pt, tcfg, xt, torch.from_numpy(pos), window=window)
    loss = torch.sum(y * torch.from_numpy(w_out))
    leaves = [a for _, a in tree_leaves(pt)]
    grads = torch.autograd.grad(loss, leaves + [xt])
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(gx_j),
                               rtol=ATTN_TOL, atol=ATTN_TOL)
    want = dict(tree_leaves(jax.tree.map(np.asarray, gp_j)))
    for (path, _), g in zip(tree_leaves(pt), grads[:-1]):
        np.testing.assert_allclose(g.numpy(), want[path], rtol=ATTN_TOL,
                                   atol=ATTN_TOL, err_msg="/".join(path))


def test_kernel_launcher_refuses_inputs_that_require_grad():
    """The bare CUDA launcher records no gradient: it raises for an input
    that requires one while grad mode is on (before touching a device)."""
    from repro_torch.kernels import flash_attn as fa

    q = torch.zeros((1, 4, 2, 16), requires_grad=True)
    k = torch.zeros((1, 4, 2, 16))
    with pytest.raises(RuntimeError, match="kernels.ops.flash_attention"):
        fa.flash_attention_cuda(q, k, k, 0)


def test_synthetic_pipeline_is_the_jax_packages():
    """The copied pipeline draws the JAX package's batches from a seed."""
    from repro.data.pipeline import PipelineConfig as JPipeCfg
    from repro.data.pipeline import SyntheticPipeline as JPipe

    a = iter(SyntheticPipeline(PipelineConfig(seq_len=8, batch_size=2,
                                              vocab=50, seed=3)))
    b = iter(JPipe(JPipeCfg(seq_len=8, batch_size=2, vocab=50, seed=3)))
    for _ in range(3):
        x, y = next(a), next(b)
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(x[key], y[key])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-3),
                                       (torch.bfloat16, 3e-2)])
def test_gradient_through_the_kernel_on_card(dtype, tol):
    """On the card the Function launches the kernel once and its gradient
    agrees with autograd of the plain version (2e-3 in fp32, the kernel
    tests' tolerance; 3e-2 in bf16, where both round q, k, v and the
    gradients to bf16); the bare launcher refuses inputs that require a
    gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import flash_attn as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda", dtype=dtype
                           ).requires_grad_()
               for shape in ((2, 200, 8, 64), (2, 200, 2, 64),
                             (2, 200, 2, 64)))
    dout = torch.randn(q.shape, generator=gen, device="cuda", dtype=dtype)
    before = fa.launches
    got = torch.autograd.grad(ops.flash_attention(q, k, v, 50), (q, k, v),
                              dout)
    assert fa.launches == before + 1
    want = torch.autograd.grad(ref.flash_attention_ref(q, k, v, 50),
                               (q, k, v), dout)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)
    with pytest.raises(RuntimeError, match="kernels.ops.flash_attention"):
        fa.flash_attention_cuda(q, k, v, 0)
