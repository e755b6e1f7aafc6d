"""Checkpointing: atomic, manifest-driven, over a flat dict of arrays.

The counterpart of `repro/checkpoint/checkpoint.py` with the same
layout, so either package reads what the other wrote:
    <dir>/step_<N>/manifest.json     leaf paths + shapes + dtypes
    <dir>/step_<N>/arrays.npz        the leaves by index (`a<i>`)
Writes go to `step_<N>.tmp` then rename (atomic commit: a crashed write
never yields a loadable-but-corrupt checkpoint).

A state here is a flat dict of numpy arrays (what `TuningSession.save`
writes).  Its leaves are stored in sorted key order, with each key's path
spelled as `jax.tree_util.keystr` spells it (`"['triples']"`), as the JAX
package flattens the same dict.  Re-sharding on restore (the JAX
package's `shardings=`) is not ported.
"""
from __future__ import annotations

import json
import os
import re
import shutil

import numpy as np


def _flatten_with_paths(state: dict) -> tuple[list[str], list]:
    keys = sorted(state)
    return [f"[{k!r}]" for k in keys], [state[k] for k in keys]


def save(ckpt_dir: str, step: int, state: dict, keep: int = 3) -> str:
    paths, leaves = _flatten_with_paths(state)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    arrays = {f"a{i}": np.asarray(x) for i, x in enumerate(leaves)}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "paths": paths,
        "shapes": [list(a.shape) for a in arrays.values()],
        "dtypes": [str(a.dtype) for a in arrays.values()],
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


def restore(ckpt_dir: str, step: int, target_tree: dict,
            shardings=None) -> dict:
    """Restore the arrays of `target_tree`'s keys (its values are ignored) as
    numpy arrays."""
    if shardings is not None:
        raise NotImplementedError(
            "restoring onto shardings is not ported: the shardings are "
            "those of the training substrate's trees, ROADMAP A11")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(d, "arrays.npz"))
    paths, _ = _flatten_with_paths(target_tree)
    if paths != manifest["paths"]:
        raise ValueError(
            "checkpoint tree mismatch: "
            f"{set(paths) ^ set(manifest['paths'])}")
    return {k: data[f"a{i}"] for i, k in enumerate(sorted(target_tree))}
