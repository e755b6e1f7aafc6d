"""Training step: CE loss, remat, microbatch gradient accumulation,
mixed precision, logical-axis sharding.

Twin of `repro/train/train_step.py`.  `make_train_step` returns
`step(state, batch) -> (state, metrics)` over the nested state
`{"params": ..., "opt": {"m", "v", "step"}}`, as the JAX package's does;
where JAX takes `jax.value_and_grad` of the loss, `value_and_grad` here
takes `torch.autograd.grad` over the parameter leaves, and the update is
functional (new tensors, as JAX returns new arrays).  Given a `mesh`
(`repro_torch.launch.mesh.Mesh`: shards stacked on one device), the step
runs inside `axis_ctx(mesh, rules)`, so the MoE layers take the
expert-parallel path; `train_state_shardings` and `batch_shardings` are
the NamedSharding trees of the state and the batch, which
`checkpoint.restore(shardings=)` places leaves by.  Under a production
mesh's `per_device` context the same step runs on one device's DTensor
shards unchanged: the gradient norm's sum of squares is a partial sum
that DTensor reduces over the mesh before its square root, as JAX's
jitted step does.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.distributed.sharding import (DEFAULT_RULES, NamedSharding,
                                              PartitionSpec, axis_ctx,
                                              param_shardings, spec_for)
from repro_torch.models import transformer as T
from repro_torch.models.model import Model
from repro_torch.models.params import (init_params, tree_from_leaves,
                                       tree_leaves, tree_map, tree_shapes)
from repro_torch.train.optimizer import (OptConfig, adamw_update,
                                         clip_by_global_norm, init_opt_state,
                                         opt_state_shapes)


@dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = field(default_factory=OptConfig)
    remat: str = "full"          # none | full | dots
    accum_steps: int = 1         # microbatch gradient accumulation
    grad_dtype: torch.dtype = torch.float32  # bf16 = compressed gradients
    z_loss: float = 0.0


def cross_entropy(logits, labels, z_loss: float = 0.0):
    lp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(lp, -1, labels[..., None].long())[..., 0]
    loss = nll.mean()
    if z_loss > 0.0:
        zl = torch.square(torch.logsumexp(logits.float(), dim=-1)).mean()
        loss = loss + z_loss * zl
    return loss


def loss_fn(model: Model, params, batch: dict, tc: TrainConfig):
    """The batch's mean cross-entropy under `params` (a tree shaped as
    `model.template`), through `model`'s forward with `tc.remat`."""
    kw = {}
    if "positions" in batch:
        kw["positions"] = batch["positions"]
    if "enc_frames" in batch:
        kw["enc_frames"] = batch["enc_frames"]
    logits = T.forward(model.cfg, params, tokens=batch["tokens"],
                       remat=tc.remat, **kw)
    return cross_entropy(logits, batch["labels"], tc.z_loss)


def value_and_grad(model: Model, params, batch: dict, tc: TrainConfig):
    """(loss, grads): the loss and its gradient with respect to every leaf
    of `params` (zero for a leaf the loss does not reach, as JAX gives),
    each in its leaf's dtype; the loss is detached."""
    leaves = [(path, x.detach().requires_grad_()) for path, x in
              tree_leaves(params)]
    tree = tree_from_leaves(leaves)
    with torch.enable_grad():
        loss = loss_fn(model, tree, batch, tc)
        grads = torch.autograd.grad(loss, [x for _, x in leaves],
                                    allow_unused=True)
    return loss.detach(), tree_from_leaves(
        (path, torch.zeros_like(x) if g is None else g)
        for (path, x), g in zip(leaves, grads))


def make_train_step(model: Model, tc: TrainConfig, mesh=None,
                    rules: dict | None = None):
    """Returns step(state, batch) -> (state, metrics), metrics the loss,
    the global gradient norm before clipping and the learning rate (0-d
    fp32 tensors on the state's device).  When `mesh` is given, the step
    runs inside `axis_ctx(mesh, rules or DEFAULT_RULES)`."""
    rules = rules or DEFAULT_RULES

    def step(state: dict, batch: dict):
        if mesh is None:
            return _step(state, batch)
        with axis_ctx(mesh, rules):
            return _step(state, batch)

    def _step(state: dict, batch: dict):
        params = state["params"]
        if tc.accum_steps > 1:
            n = tc.accum_steps
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=tc.grad_dtype,
                                                   device=p.device), params)
            for i in range(n):
                mb = {k: x.reshape((n, x.shape[0] // n) + x.shape[1:])[i]
                      for k, x in batch.items()}
                loss_i, grads_i = value_and_grad(model, params, mb, tc)
                loss = loss + loss_i
                grads = tree_map(lambda a, g: a + g.to(tc.grad_dtype), grads,
                                 grads_i)
            loss = loss / n
            grads = tree_map(lambda g: g / n, grads)
        else:
            loss, grads = value_and_grad(model, params, batch, tc)
            grads = tree_map(lambda g: g.to(tc.grad_dtype), grads)

        grads, gnorm = clip_by_global_norm(grads, tc.opt.clip_norm)
        new_params, new_opt, lr = adamw_update(params, grads, state["opt"],
                                               tc.opt)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return {"params": new_params, "opt": new_opt}, metrics

    return step


def init_train_state(model: Model, tc: TrainConfig,
                     generator: torch.Generator | None = None,
                     dtype: torch.dtype = torch.float32) -> dict:
    """Parameters drawn as `Model.init` draws them (from `generator`, on
    the model's device; seed 0 when None) and a zero optimizer state."""
    if generator is None:
        generator = torch.Generator(device=model.device).manual_seed(0)
    params = init_params(model.template, generator, dtype, model.device)
    return {"params": params, "opt": init_opt_state(params, tc.opt)}


def train_state_shapes(model: Model, tc: TrainConfig,
                       dtype: torch.dtype = torch.bfloat16) -> dict:
    """The full train state as `(shape, dtype)` pairs, without
    allocating."""
    pshapes = tree_map(lambda s: (s, dtype), tree_shapes(model.template))
    return {"params": pshapes, "opt": opt_state_shapes(pshapes, tc.opt)}


def train_state_shardings(model: Model, tc: TrainConfig, mesh,
                          rules: dict | None = None) -> dict:
    """The NamedSharding tree of the train state: each parameter and its
    two moments by the parameter's logical axes, the step replicated."""
    rules = rules or DEFAULT_RULES
    ps = param_shardings(model.template, rules, mesh)
    return {"params": ps, "opt": {"m": ps, "v": ps,
                                  "step": NamedSharding(mesh, PartitionSpec())}}


def batch_shardings(mesh, batch_tree, rules: dict | None = None):
    """The NamedSharding tree of a batch: every leaf (anything with a
    `.shape`) split over the batch axes on its first dimension."""
    rules = rules or DEFAULT_RULES

    def for_leaf(x):
        axes = ("batch",) + (None,) * (len(x.shape) - 1)
        return NamedSharding(mesh, spec_for(axes, rules, mesh))

    return tree_map(for_leaf, batch_tree)

