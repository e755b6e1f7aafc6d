"""Checkpointing: atomic, manifest-driven, over nested dicts of arrays.

The counterpart of `repro/checkpoint/checkpoint.py` with the same
layout, so either package reads what the other wrote:
    <dir>/step_<N>/manifest.json     leaf paths + shapes + dtypes
    <dir>/step_<N>/arrays.npz        the leaves by index (`a<i>`)
Writes go to `step_<N>.tmp` then rename (atomic commit: a crashed write
never yields a loadable-but-corrupt checkpoint).

A state is a nested dict whose leaves are numpy arrays or torch tensors:
a training state (`{"params", "opt": {"m", "v", "step"}}`) or the flat
dict `TuningSession.save` writes.  Its leaves are stored in sorted key
order with each path spelled as `jax.tree_util.keystr` spells it
(`"['opt']['step']"`), as the JAX package flattens the same tree.  A
bf16 leaf is stored as JAX stores an `ml_dtypes.bfloat16` array (raw
2-byte words, "bfloat16" in the manifest) and restored as a bf16 tensor.
`restore(shardings=)` places every leaf by a NamedSharding tree
(`repro_torch.distributed.sharding`) onto its mesh's device, whatever
mesh saved it: the elastic path, as in the JAX package.
"""
from __future__ import annotations

import json
import os
import re
import shutil

import numpy as np
import torch

_BF16 = "bfloat16"


def _flatten_with_paths(state: dict, prefix: str = ""
                        ) -> tuple[list[str], list]:
    """(keystr paths, leaves) in sorted key order; a leaf is anything that
    is not a dict."""
    paths, leaves = [], []
    for k in sorted(state):
        path = f"{prefix}[{k!r}]"
        if isinstance(state[k], dict):
            sub_paths, sub_leaves = _flatten_with_paths(state[k], path)
            paths += sub_paths
            leaves += sub_leaves
        else:
            paths.append(path)
            leaves.append(state[k])
    return paths, leaves


def _to_numpy(x) -> tuple[np.ndarray, str]:
    """(the array stored for leaf `x`, its manifest dtype)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.dtype("V2")), _BF16
        x = x.numpy()
    a = np.asarray(x)
    return a, str(a.dtype)


def save(ckpt_dir: str, step: int, state: dict, keep: int = 3) -> str:
    paths, leaves = _flatten_with_paths(state)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    stored = [_to_numpy(x) for x in leaves]
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{f"a{i}": a for i, (a, _) in enumerate(stored)})
    manifest = {
        "step": step,
        "paths": paths,
        "shapes": [list(a.shape) for a, _ in stored],
        "dtypes": [dt for _, dt in stored],
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(list_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)


def list_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def _leaf(a: np.ndarray, dtype: str, shape: list, like):
    """A stored array back as the target leaf's kind: a tensor on the
    target tensor's device, else a numpy array; bf16 words as a bf16
    tensor."""
    if dtype == _BF16:
        words = torch.from_numpy(np.frombuffer(a.tobytes(), np.int16).copy())
        t = words.view(torch.bfloat16).reshape(shape)
    elif isinstance(like, torch.Tensor):
        t = torch.from_numpy(np.ascontiguousarray(a)).reshape(shape)
    else:
        return a
    return t.to(like.device) if isinstance(like, torch.Tensor) else t


def restore(ckpt_dir: str, step: int, target_tree: dict,
            shardings=None) -> dict:
    """Restore into the structure of `target_tree`: each leaf the stored
    array, a tensor on the target leaf's device where that leaf is a
    tensor (a bf16 leaf always as a tensor), else a numpy array.  The
    target's values are read only for that.  `shardings` (optional tree
    of NamedSharding, leaf for leaf in the target's order) re-shards:
    every leaf becomes a tensor on its sharding's mesh device, after the
    sharding's even-division check (`NamedSharding.shard_shape`)."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(d, "arrays.npz"))
    paths, likes = _flatten_with_paths(target_tree)
    if paths != manifest["paths"]:
        raise ValueError(
            "checkpoint tree mismatch: "
            f"{set(paths) ^ set(manifest['paths'])}")
    if shardings is not None:
        _, sh_leaves = _flatten_with_paths(shardings)
        sh_leaves = [s for s in sh_leaves if s is not None]
        if len(sh_leaves) != len(likes):
            raise ValueError(
                f"shardings tree has {len(sh_leaves)} leaves, "
                f"checkpoint has {len(likes)}")
        leaves = iter(_placed(data[f"a{i}"], manifest["dtypes"][i],
                              manifest["shapes"][i], s)
                      for i, s in enumerate(sh_leaves))
        return _fill(target_tree, leaves)
    leaves = iter(_leaf(data[f"a{i}"], manifest["dtypes"][i],
                        manifest["shapes"][i], like)
                  for i, like in enumerate(likes))
    return _fill(target_tree, leaves)


def _placed(a: np.ndarray, dtype: str, shape: list, sharding) -> torch.Tensor:
    """A stored array as a tensor on `sharding`'s mesh device, once the
    sharding has checked that its shape splits evenly."""
    sharding.shard_shape(shape)
    t = _leaf(a, dtype, shape, None)
    if not isinstance(t, torch.Tensor):
        t = torch.from_numpy(np.ascontiguousarray(t)).reshape(shape)
    return t.to(sharding.mesh.device)


def _fill(tree: dict, leaves) -> dict:
    """`tree`'s structure with its leaves taken in sorted key order from
    the iterator `leaves`."""
    return {k: _fill(tree[k], leaves) if isinstance(tree[k], dict)
            else next(leaves) for k in sorted(tree)}
