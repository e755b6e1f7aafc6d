"""AdamW with configurable moment dtypes + global-norm clipping.

Twin of `repro/train/optimizer.py`: functional updates over nested dicts
of tensors (no `torch.optim`), in the JAX package's arithmetic, so a
step here follows a step there.  Moment dtypes are a memory knob (bf16 m
/ fp32 v roughly halves the optimizer's memory).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.models.params import tree_leaves, tree_map


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    m_dtype: torch.dtype = torch.float32
    v_dtype: torch.dtype = torch.float32
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def lr_at(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay, in fp32 on the step's device."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


def init_opt_state(params, cfg: OptConfig) -> dict:
    """Zero moments shaped as `params` on their devices, and `step` an
    int32 0-d tensor (on the first leaf's device)."""
    first = next(tree_leaves(params))[1]
    return {
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=cfg.m_dtype,
                                            device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=cfg.v_dtype,
                                            device=p.device), params),
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
    }


def opt_state_shapes(param_shapes, cfg: OptConfig) -> dict:
    """The optimizer state as `(shape, dtype)` pairs, from the parameters'
    `(shape, dtype)` tree, without allocating."""
    return {
        "m": tree_map(lambda sd: (sd[0], cfg.m_dtype), param_shapes),
        "v": tree_map(lambda sd: (sd[0], cfg.v_dtype), param_shapes),
        "step": ((), torch.int32),
    }


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most `max_norm`, the global
    norm): the squares summed in fp32 over the leaves in sorted-key order,
    as `jax.tree.leaves` visits them."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for _, g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gnorm


def adamw_update(params, grads, opt_state: dict, cfg: OptConfig):
    """(new params, new optimizer state, lr): one AdamW step with the
    bias corrections `1 - b ** step` in fp32 for the int32 step."""
    step = opt_state["step"] + 1
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()

    def upd(p, g, m, v):
        g32 = g.float()
        m32 = m.float() * b1 + g32 * (1 - b1)
        v32 = v.float() * b2 + torch.square(g32) * (1 - b2)
        update = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        update = update + cfg.weight_decay * p.float()
        new_p = p.float() - lr * update
        return new_p.to(p.dtype), m32.to(cfg.m_dtype), v32.to(cfg.v_dtype)

    out = tree_map(upd, params, grads, opt_state["m"], opt_state["v"])
    new_p, new_m, new_v = (tree_map(lambda o, i=i: o[i], out)
                           for i in range(3))
    return new_p, {"m": new_m, "v": new_v, "step": step}, lr
