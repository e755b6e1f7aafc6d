"""CUDA join probe: launch `csrc/join_count.cu`.

The kernel replaces the Pallas TPU kernel
`repro/kernels/join_count.py::join_count_pallas`; the source says how and
what bounds it.  `kernels/_build.py` compiles it at first launch.

`launches` counts kernel launches, so a run can show that its joins
went through the kernel.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

NAME = "join_count"
SOURCE = _build.source(NAME)
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p)

launches = 0


def build() -> Path:
    """Compile the kernel library unless this source's build exists."""
    return _build.build(NAME)


def join_count_cuda(probe: torch.Tensor, build_sorted: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on `(B, L)` probes and `(B, S)` sorted build rows,
    both contiguous int32 on one CUDA device with `B, L >= 1` (checked by
    `kernels.ops.join_count`).  Returns `(lo, count)`, each `(B, L)` int32,
    on the current stream."""
    global launches
    B, L = probe.shape
    S = build_sorted.shape[1]
    lo = torch.empty_like(probe)
    count = torch.empty_like(probe)
    with torch.cuda.device(probe.device):
        stream = torch.cuda.current_stream(probe.device).cuda_stream
        err = _build.launcher(NAME, _ARGTYPES)(
            probe.data_ptr(), build_sorted.data_ptr(), lo.data_ptr(),
            count.data_ptr(), B, L, S, stream)
    _build.check_launch(NAME, err)
    launches += 1
    return lo, count
