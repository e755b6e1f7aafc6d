"""Wrappers the query engine calls: operand checks, then the kernel.

A wrapper takes the plain version (`kernels/ref.py`) for tensors on the
CPU and launches the CUDA kernel for tensors on the card; it never falls
back from one to the other.  Operands are checked up front, with a typed
error naming the operand, as `repro/kernels/ops.py` does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.join_count import join_count_cuda

_MAX_GRID_Y = 65535


def _check(x, name: str, ndim: int | tuple[int, ...],
           dtype: torch.dtype | None = None) -> None:
    """Operand contract: a tensor of the given rank and (optionally)
    dtype."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(x).__name__}")
    ranks = (ndim,) if isinstance(ndim, int) else ndim
    if x.dim() not in ranks:
        raise ValueError(
            f"{name} must be {' or '.join(f'{r}-D' for r in ranks)}, "
            f"got shape {tuple(x.shape)}")
    if dtype is not None and x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")


def join_count(probe: torch.Tensor, build_sorted: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo, count) per probe key against the ascending build column.

    probe: `(L,)` or `(B, L)` int32, invalid slots -1;
    build_sorted: `(S,)` or `(B, S)` int32 ascending, padded with
    SENTINEL_HI — one build row per probe row.  Both on one device and
    contiguous.  Returns two int32 tensors shaped like `probe`.
    """
    _check(probe, "probe", (1, 2), torch.int32)
    _check(build_sorted, "build_sorted", probe.dim(), torch.int32)
    if probe.dim() == 2 and probe.shape[0] != build_sorted.shape[0]:
        raise ValueError(
            f"probe has {probe.shape[0]} rows but build_sorted has "
            f"{build_sorted.shape[0]}")
    if probe.device != build_sorted.device:
        raise ValueError(
            f"probe on {probe.device} but build_sorted on "
            f"{build_sorted.device}")
    if not (probe.is_contiguous() and build_sorted.is_contiguous()):
        raise ValueError("probe and build_sorted must be contiguous")
    if probe.device.type == "cpu":
        return ref.join_count_ref(probe, build_sorted)
    if probe.device.type != "cuda":
        raise ValueError(f"join_count runs on cpu or cuda, not {probe.device}")
    if probe.numel() == 0:
        return torch.empty_like(probe), torch.empty_like(probe)
    p2 = probe.view(1, -1) if probe.dim() == 1 else probe
    b2 = build_sorted.view(1, -1) if build_sorted.dim() == 1 else build_sorted
    if p2.shape[0] > _MAX_GRID_Y:
        raise ValueError(
            f"join_count takes at most {_MAX_GRID_Y} rows, got {p2.shape[0]}")
    lo, count = join_count_cuda(p2, b2)
    return lo.view_as(probe), count.view_as(probe)
