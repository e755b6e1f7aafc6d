"""The port's train step against the JAX package's, and training
checkpoints resumed across the two, on the CPU.

JAX parameters from `Model.init(jax.random.key(0))` are carried across
with `model_params_from_reference`; the same seeded numpy batches (with
encoder frames for whisper) go through both packages' `make_train_step`,
in fp32.  Tolerances: loss, grad_norm and lr to 1e-5; the first step's
gradients leaf for leaf to 1e-4; parameters after three steps to 6 * lr
absolute (+1e-4 relative): AdamW divides by sqrt(v) + eps, so a leaf
whose gradient is float noise moves by up to about lr a step in either
package, in whichever direction its noise points (two steps' worth
apart, three steps).  One jitted JAX program per configuration gives
both the gradients and the step, so each compiles once."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api.convert import model_params_from_reference  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.distributed.fault import TrainSupervisor  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.train.optimizer import OptConfig, init_opt_state  # noqa: E402
from repro_torch.train.train_step import (TrainConfig,  # noqa: E402
                                          make_train_step, value_and_grad)

METRIC_TOL = 1e-5
GRAD_TOL = 1e-4
LR = 1e-3
PARITY = [("qwen2.5-32b", 1, "full"), ("granite-20b", 2, "none"),
          ("rwkv6-3b", 1, "none"), ("whisper-base", 1, "none")]

_JAX: dict = {}


def _torch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _np(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _setup(arch: str, accum: int, remat: str):
    """(JAX model, JAX params, port model holding the same params, three
    seeded batches, port TrainConfig, jitted JAX `(state, batch) ->
    (grads of the loss, (state, metrics))`), built once per
    configuration."""
    key = (arch, accum, remat)
    if key not in _JAX:
        jax = pytest.importorskip("jax")
        import jax.numpy as jnp
        from repro.configs import get_smoke_config as jax_smoke
        from repro.models.model import build_model as jax_build
        from repro.train.optimizer import OptConfig as JOpt
        from repro.train.train_step import TrainConfig as JTrain
        from repro.train.train_step import loss_fn as jloss
        from repro.train.train_step import make_train_step as jstep

        jm = jax_build(jax_smoke(arch))
        params = jm.init(jax.random.key(0))
        tm = model_params_from_reference(jax.tree.map(np.asarray, params),
                                         get_smoke_config(arch), device="cpu")
        rng = np.random.default_rng(5)
        batches = []
        for _ in range(3):
            t = rng.integers(8, tm.cfg.vocab, size=(4, 16)).astype(np.int32)
            b = {"tokens": t, "labels": np.roll(t, -1, axis=1)}
            if tm.cfg.encoder is not None:
                b["enc_frames"] = rng.normal(
                    size=(4, 8, tm.cfg.encoder.d_input)).astype(np.float32)
            batches.append(b)
        opt = dict(lr=LR, warmup_steps=2, total_steps=10)
        jtc = JTrain(opt=JOpt(**opt, m_dtype=jnp.float32), remat=remat,
                     accum_steps=accum)
        ttc = TrainConfig(opt=OptConfig(**opt), remat=remat,
                          accum_steps=accum)
        step = jstep(jm, jtc)

        def grads_and_step(state, batch):
            g = jax.grad(lambda p: jloss(jm, p, batch, jtc))(state["params"])
            return g, step(state, batch)

        _JAX[key] = (jm, params, tm, batches, ttc, jax.jit(grads_and_step))
    return _JAX[key]


def _states(jm, params, tm, ttc):
    """The two packages' initial train states over the same params."""
    import jax
    import jax.numpy as jnp

    zeros = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
    sj = {"params": params, "opt": {"m": zeros, "v": zeros,
                                    "step": jnp.zeros((), jnp.int32)}}
    st = {"params": tm.params, "opt": init_opt_state(tm.params, ttc.opt)}
    return sj, st


@pytest.mark.parametrize("arch,accum,remat", PARITY)
def test_train_steps_match_jax(arch, accum, remat):
    """One step's gradients leaf for leaf, then three steps' metrics and
    parameters, through both packages' `make_train_step`."""
    import jax
    import jax.numpy as jnp

    jm, params, tm, batches, ttc, fj = _setup(arch, accum, remat)
    sj, st = _states(jm, params, tm, ttc)
    ft = make_train_step(tm, ttc)
    for i, b in enumerate(batches):
        gj, (sj, mj) = fj(sj, {k: jnp.asarray(v) for k, v in b.items()})
        if i == 0:
            _, gt = value_and_grad(tm, st["params"], _torch(b), ttc)
            want = dict(tree_leaves(jax.tree.map(np.asarray, gj)))
            got = dict(tree_leaves(gt))
            assert sorted(got) == sorted(want)
            for path, g in want.items():
                np.testing.assert_allclose(got[path].numpy(), g,
                                           rtol=GRAD_TOL, atol=GRAD_TOL,
                                           err_msg="/".join(path))
        st, mt = ft(st, _torch(b))
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(mt[key]), float(mj[key]),
                                       rtol=METRIC_TOL, atol=METRIC_TOL,
                                       err_msg=f"step {i + 1} {key}")
    assert int(st["opt"]["step"]) == 3
    want = dict(tree_leaves(jax.tree.map(np.asarray, sj["params"])))
    for path, x in tree_leaves(st["params"]):
        np.testing.assert_allclose(x.numpy(), want[path], rtol=GRAD_TOL,
                                   atol=6 * LR, err_msg="/".join(path))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_train_checkpoint_resumes_across_packages(tmp_path, writer):
    """A step saved by one package's `TrainSupervisor` resumes in the
    other's (the nested state, its int32 step among the leaves); both then
    take the same next step (1e-5)."""
    import jax
    import jax.numpy as jnp
    from repro.distributed.fault import TrainSupervisor as JSup

    jm, params, tm, batches, ttc, fj = _setup(*PARITY[0])
    sj, st = _states(jm, params, tm, ttc)
    ft = make_train_step(tm, ttc)
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    tb = [_torch(b) for b in batches]
    ckpt = str(tmp_path / "ck")
    if writer == "jax":
        _, (sj, _) = fj(sj, jb[0])
        JSup(ckpt, save_every=1).maybe_save(1, sj)
        init = st
        st, start = TrainSupervisor(ckpt, save_every=1).resume_or_init(
            lambda: init)
        assert all(isinstance(x, torch.Tensor) for _, x in tree_leaves(st))
        assert st["opt"]["step"].dtype == torch.int32
    else:
        st, _ = ft(st, tb[0])
        TrainSupervisor(ckpt, save_every=1).maybe_save(1, st)
        init = sj
        sj, start = JSup(ckpt, save_every=1).resume_or_init(lambda: init)
    assert start == 1 and int(st["opt"]["step"]) == int(sj["opt"]["step"]) == 1
    _, (sj, mj) = fj(sj, jb[1])
    st, mt = ft(st, tb[1])
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(mt[key]), float(mj[key]),
                                   rtol=METRIC_TOL, atol=METRIC_TOL,
                                   err_msg=key)
    want = dict(tree_leaves(jax.tree.map(np.asarray, sj)))
    for path, x in tree_leaves(st):
        np.testing.assert_allclose(_np(x.numpy()), _np(want[path]),
                                   rtol=METRIC_TOL, atol=METRIC_TOL,
                                   err_msg="/".join(path))
