"""CUDA flash attention: launch `csrc/flash_attn.cu`.

The kernels replace the Pallas TPU kernel
`repro/kernels/flash_attn.py::flash_attention_pallas`; the sources say
how and what bounds them.  `kernels/_build.py` compiles them at first
launch.  The source holds two designs, and `design(dtype, hd)` picks one
from the operands' type and head width:

- `"tensor_core"` (bf16 at hd 64, 128, 256): TMA-fed bf16 tiles and
  wgmma (`csrc/flash_attn_wgmma.cuh`), with P V issued on the two bf16
  halves of P (`SPLIT_P`);
- `"cuda_core"` (fp32, and bf16 at hd 16 and 32): fp32 products on the
  CUDA cores.

`launches` counts kernel launches of either design, and
`design_launches` each design's, so a run can show that its prefill
attention went through the tensor-core kernel.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

NAME = "flash_attn"
SOURCE = _build.source(NAME)
HEAD_DIMS = (16, 32, 64, 128, 256)       # the CUDA-core instantiations
TENSOR_CORE_HEAD_DIMS = (64, 128, 256)   # the tensor-core ones (bf16)
QUERY_TILE = 64                      # query rows per block (128: tensor core)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
DESIGNS = {"cuda_core": 0, "tensor_core": 1}
SPLIT_P = True   # P V as bf16(p) and bf16(p - bf16(p)): one bf16 ulp holds
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p)

launches = 0
design_launches = dict.fromkeys(DESIGNS, 0)


def design(dtype: torch.dtype, hd: int) -> str:
    """The design that serves operands of `dtype` and head width `hd`."""
    if dtype == torch.bfloat16 and hd in TENSOR_CORE_HEAD_DIMS:
        return "tensor_core"
    return "cuda_core"


def reset_launches() -> None:
    """Set every launch count to 0."""
    global launches
    launches = 0
    for key in design_launches:
        design_launches[key] = 0


def build() -> Path:
    """Compile the kernel library unless this source's build exists."""
    return _build.build(NAME)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         window: int, *, use: str | None = None,
                         split_p: bool = SPLIT_P) -> torch.Tensor:
    """Launch the kernel on contiguous q `(B, S, H, hd)` and k, v
    `(B, S, Hkv, hd)` of one dtype in `DTYPES` on one CUDA device, with
    `hd` in `HEAD_DIMS`, `B, S >= 1` and `H % Hkv == 0` (checked by
    `kernels.ops.flash_attention`).  Returns `(B, S, H, hd)` in q's dtype,
    on the current stream.  A window of S or more is no window; it
    reaches the kernel as S, within a C int.  `use` names another design
    than `design(q.dtype, hd)` and `split_p=False` issues P V as one bf16
    product: both only to measure the alternatives beside the path's.

    The launch records no gradient, so an input that requires one is
    refused while grad mode is on: `kernels.ops.flash_attention`, whose
    autograd Function calls this with grad mode off, is the
    differentiable entry."""
    global launches
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash_attention_cuda records no gradient: call "
            "kernels.ops.flash_attention for inputs that require one")
    B, S, H, hd = q.shape
    use = design(q.dtype, hd) if use is None else use
    if use == "tensor_core" and (q.dtype != torch.bfloat16
                                 or hd not in TENSOR_CORE_HEAD_DIMS):
        raise ValueError(f"the tensor_core design takes bf16 at hd "
                         f"{TENSOR_CORE_HEAD_DIMS}, got {q.dtype} hd {hd}")
    if use == "tensor_core" and any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("the tensor_core design reads q, k and v by TMA, "
                         "which needs 16-byte aligned data")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _build.launcher(NAME, _ARGTYPES)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
            H, k.shape[2], hd, min(window, S), DTYPES[q.dtype], DESIGNS[use],
            int(split_p), stream)
    _build.check_launch(NAME, err)
    launches += 1
    design_launches[use] += 1
    return out
