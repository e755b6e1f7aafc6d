"""CUDA filter mask: launch `csrc/filter_mask.cu`.

The kernel replaces the Pallas TPU kernel
`repro/kernels/filter_compact.py::filter_mask_pallas`; the source says
how and what bounds it.  `kernels/_build.py` compiles it at first launch.

`launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build

NAME = "filter_mask"
SOURCE = _build.source(NAME)
ROWS_PER_BLOCK = 512
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
             ctypes.c_void_p)

launches = 0


def build() -> Path:
    """Compile the kernel library unless this source's build exists."""
    return _build.build(NAME)


@functools.lru_cache(maxsize=256)
def _conds_tensor(conds: tuple[tuple[int, int], ...],
                  device: torch.device) -> torch.Tensor:
    """The static pairs as an `(n, 2)` int32 device tensor, copied to the
    device once per `(conds, device)`."""
    return torch.tensor(conds, dtype=torch.int32,
                        device=device).reshape(len(conds), 2)


def filter_mask_cuda(rows: torch.Tensor, conds: tuple[tuple[int, int], ...]
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on contiguous `(N, W)` int32 rows on a CUDA device
    with `N, W >= 1` and checked pairs (`kernels.ops.filter_mask`).
    Returns `(mask (N,), counts (ceil(N / 512),))` int32, on the current
    stream."""
    global launches
    n, w = rows.shape
    mask = torch.empty(n, dtype=torch.int32, device=rows.device)
    counts = torch.empty(-(-n // ROWS_PER_BLOCK), dtype=torch.int32,
                         device=rows.device)
    cond_ptr = _conds_tensor(conds, rows.device).data_ptr() if conds else None
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = _build.launcher(NAME, _ARGTYPES)(
            rows.data_ptr(), cond_ptr, len(conds), mask.data_ptr(),
            counts.data_ptr(), n, w, stream)
    _build.check_launch(NAME, err)
    launches += 1
    return mask, counts
