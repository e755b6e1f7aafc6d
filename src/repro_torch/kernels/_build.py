"""Build and load the port's CUDA kernels.

Each kernel is one source `csrc/<name>.cu` with a plain C launcher (no
PyTorch headers, so `nvcc` takes seconds), which may include local
headers `csrc/*.cuh`.  It is compiled for `sm_90a` into its own
`build/repro_torch/<name>-<hash>.so` at the repository root the first
time it is launched; the hash covers that source, every local header it
includes and the flags, so editing one kernel rebuilds only that one.
`ptxas -v` (registers, shared memory, spills per kernel) is kept beside
the library as `<name>-<hash>.ptxas.txt`.  The library is loaded with
`ctypes` once per process.  Nothing is built or loaded when a kernel
module is imported.  A kernel that cannot be built, loaded or launched
raises `KernelError`.  `is_device_fault` tells such an error, and a
fault the card reports later, from every other failure: callers that
degrade on other failures (the serving ladder) let these through.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


class KernelError(RuntimeError):
    """A kernel of the port could not be built, loaded or launched."""


_ACCELERATOR_ERROR = getattr(torch, "AcceleratorError", KernelError)


def is_device_fault(exc: BaseException) -> bool:
    """True for a failure of the card rather than of one request: a
    `KernelError`, or a fault that CUDA reports after the launch, at the
    next call or read-back (an illegal address, a trap, a device-side
    assert).  PyTorch raises the latter as its accelerator error, or in
    older versions as a `RuntimeError` whose message starts with
    "CUDA error"."""
    return (isinstance(exc, (KernelError, _ACCELERATOR_ERROR))
            or (isinstance(exc, RuntimeError)
                and str(exc).startswith("CUDA error")))


def source(name: str) -> Path:
    return CSRC / f"{name}.cu"


def sources(name: str) -> list[Path]:
    """`csrc/<name>.cu`, then the local headers it includes (with
    `#include "..."`, resolved beside the including file), recursively,
    each once, in the order they are first met."""
    seen: list[Path] = []
    todo = [source(name)]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [path.parent / inc
                 for inc in _INCLUDE.findall(path.read_text())
                 if (path.parent / inc).is_file()]
    return seen


def _nvcc(name: str) -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelError(
            f"nvcc not found (set CUDA_HOME); the {name} kernel is built "
            "from source at first use")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in sources(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def command(name: str, out: str) -> list[str]:
    """The nvcc command line that builds `csrc/<name>.cu` into `out`."""
    return [_nvcc(name), *NVCC_FLAGS, "-o", out, str(source(name))]


def ptxas_log(name: str) -> str:
    """What ptxas reported when this source's library was built."""
    return library_path(name).with_suffix(".ptxas.txt").read_text()


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` unless this source's build exists."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(command(name, tmp), capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise KernelError(
                f"nvcc failed to build {name}.cu:\n{proc.stderr}")
        out.with_suffix(".ptxas.txt").write_text(proc.stderr)
        os.replace(tmp, out)  # atomic: concurrent builders agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.cache
def _library(name: str) -> ctypes.CDLL:
    path = build(name)
    try:
        return ctypes.CDLL(str(path))
    except OSError as exc:
        raise KernelError(f"cannot load the {name} kernel: {exc}") from exc


@functools.cache
def launcher(name: str, argtypes: tuple, symbol: str | None = None):
    """`symbol` (default `<name>_launch`) from the kernel's library, typed:
    every launcher returns the `cudaGetLastError()` after its launch as an
    int."""
    fn = getattr(_library(name), symbol or f"{name}_launch")
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def launch(fn, device_index: int, *args) -> int:
    """Call the C launcher `fn(*args, stream)` on PyTorch's current stream
    of device `device_index`, entering `torch.cuda.device` only when that
    is not the current device: on every call it is host time the launch
    does not need."""
    # the tensor lives on the card, so CUDA is initialised already
    if device_index == torch._C._cuda_getDevice():
        return fn(*args, torch._C._cuda_getCurrentRawStream(device_index))
    with torch.cuda.device(device_index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(device_index))


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise KernelError(f"{name} launch failed: CUDA error {err}")
