"""Dry-run cell definitions: (architecture x input shape) -> traced step.

Twin of `repro/launch/shapes.py`.  Shapes (assigned):
  train_4k     seq=4096   global_batch=256   train_step
  prefill_32k  seq=32768  global_batch=32    prefill (forward)
  decode_32k   seq=32768  global_batch=128   serve decode (1 token, KV=32k)
  long_500k    seq=524288 global_batch=1     long-context decode
               (runs only for long_context archs: gemma3/rwkv6/zamba2)

`make_cell(arch, shape)` returns a `Cell` whose `args` are tensors on
the `meta` device (shapes and dtypes, no allocation) and whose `fn` is
the port's own entry point: `Model.forward` (prefill),
`Model.decode_step` (decode) or the step of `make_train_step` (train).
The JAX module returns `ShapeDtypeStruct`s and shardings for a jit; the
port traces `fn(*args)` eagerly on `meta` (`launch/flops_audit.py`).

The logical-axis rule tables come from `distributed/sharding.py`, as
the JAX module imports them.  With `mesh=None` a cell is the program of
one card holding every shard, traced outside `axis_ctx`; it records its
table (the dry-run writes it into the artifact).  With a production
mesh (`launch.mesh.make_production_mesh`, inside `per_device(mesh)`)
the cell is one device's program: its arguments are rank 0's meta
DTensors, laid out by the JAX module's shardings (`param_shardings`,
`train_state_shardings`, `batch_shardings` and the cache's by
`Model.cache_axes`), and its step runs in `axis_ctx(mesh, rules)`.
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.distributed.sharding import (DECODE_RULES, DEFAULT_RULES,
                                              FSDP_RULES, LONG_RULES,
                                              SEQ_RULES, NamedSharding,
                                              axis_ctx, param_shardings,
                                              spec_for)
from repro_torch.models.model import Model
from repro_torch.models.params import tree_map, tree_shapes
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import (TrainConfig, batch_shardings,
                                          make_train_step, train_state_shapes,
                                          train_state_shardings)

META = torch.device("meta")

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

# >=20B-param configs need FSDP so optimizer state fits 16 GB/chip
_FSDP_ARCHS = {"llama4-maverick-400b-a17b", "qwen2.5-32b", "deepseek-67b",
               "granite-20b"}

def applicable(arch: str, shape: str) -> tuple[bool, str]:
    cfg = get_config(arch)
    if shape == "long_500k" and not cfg.long_context:
        return False, ("pure full-attention architecture: 500k decode needs "
                       "sub-quadratic attention / windowed KV (see DESIGN.md)")
    return True, ""


def rules_for(arch: str, shape: str) -> dict:
    if SHAPES[shape]["kind"] == "decode":
        return LONG_RULES if SHAPES[shape]["batch"] == 1 else DECODE_RULES
    if SHAPES[shape]["kind"] == "train" and arch in _FSDP_ARCHS:
        return FSDP_RULES
    return DEFAULT_RULES


@dataclass
class Cell:
    arch: str
    shape: str
    kind: str
    fn: Any                  # the entry point to trace
    args: tuple              # trees of meta tensors (decode: pos a host int)
    model: Model
    rules: dict              # the layout (recorded only, with mesh=None)
    donate: tuple = ()


def _meta(tree):
    """Meta tensors for a tree of `(shape, dtype)` pairs."""
    return tree_map(lambda sd: torch.empty(sd[0], dtype=sd[1], device=META),
                    tree)


def _local(tree, shardings):
    """Rank 0's meta DTensors for a tree of `(shape, dtype)` pairs laid
    out by a parallel tree of `NamedSharding`s."""
    return tree_map(lambda sd, sh: sh.local(sd[0], sd[1]), tree, shardings)


def _shapes(tree):
    """The `(shape, dtype)` pairs of a tree of tensors."""
    return tree_map(lambda t: (tuple(t.shape), t.dtype), tree)


def _batch_specs(cfg, batch: int, seq: int, with_labels: bool) -> dict:
    b = {"tokens": ((batch, seq), torch.int32)}
    if with_labels:
        b["labels"] = ((batch, seq), torch.int32)
    if cfg.mrope:
        b["positions"] = ((batch, seq, 3), torch.int32)
    if cfg.encoder is not None:
        b["enc_frames"] = ((batch, cfg.encoder.max_len, cfg.encoder.d_input),
                           torch.bfloat16)
    return _meta(b)


def env_cfg(cfg):
    """Apply perf-iteration overrides from the environment:
    REPRO_ATTN=chunked|dense, REPRO_ATTN_CHUNK=<int>."""
    impl = os.environ.get("REPRO_ATTN")
    if impl:
        cfg = dataclasses.replace(cfg, attn_impl=impl)
    ck = os.environ.get("REPRO_ATTN_CHUNK")
    if ck:
        cfg = dataclasses.replace(cfg, attn_chunk=int(ck))
    return cfg


_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def make_cell(arch: str, shape: str, mesh=None, rules: dict | None = None,
              tc: TrainConfig | None = None, cfg=None,
              param_dtype: torch.dtype = torch.bfloat16) -> Cell:
    """The cell of `arch` at `shape` (read from `SHAPES` when called, so a
    caller may override its seq and batch).  `mesh`: None for one card,
    or a production mesh whose `per_device` context is open, for rank
    0's program.  Parameters are `param_dtype` (bf16 as in the JAX
    dry-run); a train cell's optimizer moments follow REPRO_OPT_M_DTYPE /
    REPRO_OPT_V_DTYPE (f32 | bf16) and its remat REPRO_REMAT (default
    full), as the JAX cell's do."""
    if mesh is not None and mesh.device_mesh is None:
        raise ValueError("make_cell's mesh needs its per_device context "
                         "(launch.mesh.per_device)")
    cfg = cfg if cfg is not None else get_config(arch)
    cfg = env_cfg(cfg)
    model = Model(cfg, META)
    spec = SHAPES[shape]
    rules = rules or rules_for(arch, shape)
    kind = spec["kind"]
    seq, batch = spec["seq"], spec["batch"]

    def place(tree, shardings):
        return _meta(tree) if mesh is None else _local(tree, shardings)

    def batch_args(with_labels: bool):
        b = _batch_specs(cfg, batch, seq, with_labels)
        if mesh is None:
            return b
        return _local(_shapes(b), batch_shardings(mesh, b, rules))

    def in_ctx(fn):
        if mesh is None:
            return fn

        def run(*args):
            with axis_ctx(mesh, rules):
                return fn(*args)
        return run

    if kind == "train":
        m_dt = _DTYPES[os.environ.get("REPRO_OPT_M_DTYPE", "f32")]
        v_dt = _DTYPES[os.environ.get("REPRO_OPT_V_DTYPE", "f32")]
        tc = tc or TrainConfig(opt=OptConfig(m_dtype=m_dt, v_dtype=v_dt),
                               remat=os.environ.get("REPRO_REMAT", "full"))
        step = make_train_step(model, tc, mesh, rules)
        state = place(train_state_shapes(model, tc, dtype=param_dtype),
                      mesh and train_state_shardings(model, tc, mesh, rules))
        args = (state, batch_args(with_labels=True))
        return Cell(arch, shape, kind, step, args, model, rules, donate=(0,))

    params = place(tree_map(lambda s: (s, param_dtype),
                            tree_shapes(model.template)),
                   mesh and param_shardings(model.template, rules, mesh))

    if kind == "prefill":
        def prefill(params, batch):
            kw = {k: v for k, v in batch.items() if k != "tokens"}
            return model.load_params(params).forward(tokens=batch["tokens"],
                                                     **kw)

        args = (params, batch_args(with_labels=False))
        return Cell(arch, shape, kind, in_ctx(prefill), args, model, rules)

    # decode: one token against a cache of length `seq`, written at its
    # last slot (the port's decode takes the position as a host int)
    enc_len = cfg.encoder.max_len if cfg.encoder is not None else 0
    cache_sh = mesh and tree_map(
        lambda axes: NamedSharding(mesh, spec_for(axes, rules, mesh)),
        model.cache_axes())
    cache = place(model.cache_shapes(batch, seq, enc_len), cache_sh)
    tok = place(((batch, 1), torch.int32),
                mesh and NamedSharding(mesh, spec_for(("batch", None), rules,
                                                      mesh)))

    def decode(params, token, pos, cache):
        return model.load_params(params).decode_step(token, pos, cache)

    args = (params, tok, seq - 1, cache)
    return Cell(arch, shape, kind, in_ctx(decode), args, model, rules,
                donate=(3,))


def all_cells() -> list[tuple[str, str]]:
    return [(a, s) for a in list_archs() for s in SHAPES]
