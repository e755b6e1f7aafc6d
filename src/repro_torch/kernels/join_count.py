"""CUDA join probe: launch `csrc/join_count.cu`.

The kernel replaces the Pallas TPU kernel
`repro/kernels/join_count.py::join_count_pallas`; the source says how and
what bounds it.  `kernels/_build.py` compiles it at first launch.
`plan` picks each launch's grid and sample of the build row.

`launches` counts kernel launches, so a run can show that its joins
went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build

NAME = "join_count"
SOURCE = _build.source(NAME)
THREADS = 1024           # a block; one block an SM (its 128 KB sample)
MAX_SAMPLES = 32768      # build keys a block keeps in shared memory
_ARGTYPES = (ctypes.c_void_p,) * 7


class Shape(ctypes.Structure):
    """`JoinShape` of the C launcher: one launch's shape and plan."""
    _fields_ = [(name, ctypes.c_int) for name in
                ("B", "L", "S", "stride", "blocks", "device")]


launches = 0


def build() -> Path:
    """Compile the kernel library unless this source's build exists."""
    return _build.build(NAME)


@functools.lru_cache(maxsize=4096)
def plan(B: int, L: int, S: int, sms: int) -> tuple[int, int, bool]:
    """(blocks a member, D, pre-pass) for B rows of L probes against S
    keys on a card of `sms` SMs.  The grid fills the card once (or covers
    L).  Each block stages every D-th build key, D the least power of two
    that leaves at most 8 keys a probe of the block when a pre-pass writes
    the sample for several blocks of a member (a block then reads it
    coalesced), 1 when a lone block gathers it from the row itself (a
    sector a key), and never more than MAX_SAMPLES.  `chip_smoke.py` times
    the D this picks against D/4 .. 4D at the maintenance stream's shapes
    (PERF.md)."""
    blocks = max(1, min(-(-L // THREADS), -(-sms // B)))
    per_block = -(-L // blocks)
    cap = min(MAX_SAMPLES,
              1 << ((8 if blocks > 1 else 1) * per_block - 1).bit_length())
    stride = 1 << max(-(-S // cap) - 1, 0).bit_length()
    return blocks, stride, stride > 1 and blocks > 1


@functools.cache
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=4096)
def launch_shape(B: int, L: int, S: int, device: int
                 ) -> tuple[int, int, Shape]:
    """(scratch words, address, Shape) of a launch on `device`: the
    `plan`'s shape, built once; the cache keeps the structure alive."""
    blocks, stride, prepass = plan(B, L, S, _sm_count(device))
    shape = Shape(B, L, S, stride, blocks, device)
    return (B * -(-S // stride) if prepass else 0), ctypes.addressof(shape), \
        shape


def join_count_cuda(probe: torch.Tensor, build_sorted: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on `(B, L)` or `(L,)` probes against `(B, S)` or
    `(S,)` sorted build rows of the same rank, both contiguous int32 on one
    CUDA device with `B, L >= 1` (checked by `kernels.ops.join_count`).
    Returns `(lo, count)`, each shaped like `probe`, on the current
    stream."""
    global launches
    L, S = probe.shape[-1], build_sorted.shape[-1]
    device = probe.get_device()
    n_scratch, shape, _ = launch_shape(probe.numel() // L, L, S, device)
    # two empty_like cost less host time than one (2, *shape) tensor and
    # the views that split it
    lo = torch.empty_like(probe)
    count = torch.empty_like(probe)
    scratch = probe.new_empty(n_scratch) if n_scratch else None
    err = _build.launch(
        _build.launcher(NAME, _ARGTYPES), device, probe.data_ptr(),
        build_sorted.data_ptr(),
        None if scratch is None else scratch.data_ptr(), lo.data_ptr(),
        count.data_ptr(), shape)
    _build.check_launch(NAME, err)
    launches += 1
    return lo, count
