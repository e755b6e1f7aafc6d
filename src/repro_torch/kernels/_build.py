"""Build and load the port's CUDA kernels.

Each kernel is one source `csrc/<name>.cu` with a plain C launcher (no
PyTorch headers, so `nvcc` takes seconds).  It is compiled for `sm_90a`
into its own `build/repro_torch/<name>-<hash>.so` at the repository
root the first time it is launched; the hash covers that source and
the flags, so editing one kernel rebuilds only that one.  The library
is loaded with `ctypes` once per process.  Nothing is built or loaded
when a kernel module is imported.
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def source(name: str) -> Path:
    return CSRC / f"{name}.cu"


def _nvcc(name: str) -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (set CUDA_HOME); the {name} kernel is built "
            "from source at first use")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256(source(name).read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` unless this source's build exists."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(name), *NVCC_FLAGS, "-o", tmp, str(source(name))],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {name}.cu:\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: concurrent builders agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.cache
def launcher(name: str, argtypes: tuple):
    """`<name>_launch` from the kernel's library, typed: every launcher
    returns the `cudaGetLastError()` after its launch as an int."""
    fn = getattr(ctypes.CDLL(str(build(name))), f"{name}_launch")
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
