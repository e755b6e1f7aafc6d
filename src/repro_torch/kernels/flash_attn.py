"""CUDA flash attention: launch `csrc/flash_attn.cu`.

The kernel replaces the Pallas TPU kernel
`repro/kernels/flash_attn.py::flash_attention_pallas`; the source says
how and what bounds it.  `kernels/_build.py` compiles it at first launch.

`launches` counts kernel launches, so a run can show that its prefill
attention went through the kernel.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

NAME = "flash_attn"
SOURCE = _build.source(NAME)
HEAD_DIMS = (16, 32, 64, 128, 256)   # the source's instantiations
QUERY_TILE = 64                      # query rows per thread block
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p)

launches = 0


def build() -> Path:
    """Compile the kernel library unless this source's build exists."""
    return _build.build(NAME)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         window: int) -> torch.Tensor:
    """Launch the kernel on contiguous q `(B, S, H, hd)` and k, v
    `(B, S, Hkv, hd)` of one dtype in `DTYPES` on one CUDA device, with
    `hd` in `HEAD_DIMS`, `B, S >= 1` and `H % Hkv == 0` (checked by
    `kernels.ops.flash_attention`).  Returns `(B, S, H, hd)` in q's dtype,
    on the current stream.  A window of S or more is no window; it
    reaches the kernel as S, within a C int."""
    global launches
    B, S, H, hd = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _build.launcher(NAME, _ARGTYPES)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
            H, k.shape[2], hd, min(window, S), DTYPES[q.dtype], stream)
    _build.check_launch(NAME, err)
    launches += 1
    return out
