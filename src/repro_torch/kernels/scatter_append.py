"""CUDA scatter-append: launch `csrc/scatter_append.cu`.

The kernel replaces the Pallas TPU kernel
`repro/kernels/scatter_append.py::scatter_append_pallas`; the source says
how and what bounds it.  `kernels/_build.py` compiles it at first launch.
It has two entry points: `scatter_append_cuda` reads the counts from a
device tensor, as the TPU kernel does (the launch can be captured in a
CUDA graph); `scatter_append_counts_cuda` takes them by value, so a caller
holding them on the host builds no device tensor (a host-to-device copy,
which synchronises the stream).

`launches` counts kernel launches of either entry, so a run can show that
its appends went through the kernel.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

NAME = "scatter_append"
SOURCE = _build.source(NAME)
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p)
_COUNTS_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                    ctypes.c_void_p)

launches = 0


def build() -> Path:
    """Compile the kernel library unless this source's build exists."""
    return _build.build(NAME)


def scatter_append_cuda(buf: torch.Tensor, rows: torch.Tensor,
                        nk: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on a `(cap, W)` buffer, `(dcap, W)` delta rows and
    the `(1, 2)` device counts `[[n, k]]`, all contiguous int32 on one CUDA
    device with `cap, W >= 1` (checked by `kernels.ops.scatter_append`).
    Returns a new `(cap, W)` buffer, on the current stream."""
    global launches
    cap, w = buf.shape
    out = torch.empty_like(buf)
    device = buf.get_device()
    err = _build.launch(_build.launcher(NAME, _ARGTYPES), device,
                        buf.data_ptr(), rows.data_ptr(), nk.data_ptr(),
                        out.data_ptr(), cap, w, rows.shape[0], device)
    _build.check_launch(NAME, err)
    launches += 1
    return out


def scatter_append_counts_cuda(buf: torch.Tensor, rows: torch.Tensor,
                               n: int, k: int) -> torch.Tensor:
    """`scatter_append_cuda` with host ints `n`, `k` passed by value
    (checked against the capacities by `kernels.ops.scatter_append`)."""
    global launches
    cap, w = buf.shape
    out = torch.empty_like(buf)
    device = buf.get_device()
    err = _build.launch(
        _build.launcher(NAME, _COUNTS_ARGTYPES,
                        "scatter_append_counts_launch"),
        device, buf.data_ptr(), rows.data_ptr(), out.data_ptr(), cap, w,
        rows.shape[0], n, k, device)
    _build.check_launch(NAME, err)
    launches += 1
    return out
