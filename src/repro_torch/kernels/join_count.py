"""CUDA join probe: build, load and launch `csrc/join_count.cu`.

The kernel replaces the Pallas TPU kernel
`repro/kernels/join_count.py::join_count_pallas`; the source says how and
what bounds it.  It is compiled with `nvcc` for `sm_90a` into
`build/repro_torch/` at the repository root the first time it is
launched, under a file name keyed by a hash of the source, and loaded
with `ctypes` (a plain C launcher, no PyTorch headers, so the build
takes seconds).  Nothing is built or loaded when this module is
imported.

`launches` counts kernel launches, so a run can show that its joins
went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "join_count.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

launches = 0


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the join_count kernel is "
            "built from source at first use")
    return found


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"join_count-{digest}.so"


def build() -> Path:
    """Compile the kernel library unless this source's build exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {SOURCE.name}:\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: concurrent builders agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    fn = lib.join_count_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


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
        err = _library().join_count_launch(
            probe.data_ptr(), build_sorted.data_ptr(), lo.data_ptr(),
            count.data_ptr(), B, L, S, stream)
    if err != 0:
        raise RuntimeError(f"join_count launch failed: CUDA error {err}")
    launches += 1
    return lo, count
