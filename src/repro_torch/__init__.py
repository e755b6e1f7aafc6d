"""RDFViewS on PyTorch and CUDA: the storage tuning wizard for one H100.

A second implementation of the `repro` package, module for module
(`repro_torch/query/engine.py` is the counterpart of
`repro/query/engine.py`).  It imports `torch` and numpy and nothing of
JAX or of `repro`: the pure-Python modules it shares with `repro` are
kept here as copies.

Entry points run on the card.  `device()` resolves the device every
entry point takes: CUDA unless the caller asks for the CPU by name, and
an error (never a silent move to the CPU) when there is no CUDA device.
"""
from __future__ import annotations

import torch


def device(name: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on.

    `None` means the card (`cuda`).  A CUDA device raises `RuntimeError`
    when CUDA is unavailable; only an explicit `"cpu"` runs on the CPU.
    """
    dev = torch.device("cuda" if name is None else name)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
