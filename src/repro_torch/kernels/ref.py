"""Plain PyTorch versions of the port's kernels (the CPU path and the
reference each kernel is held against on the card)."""
from __future__ import annotations

import torch


def join_count_ref(probe: torch.Tensor, build_sorted: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """lo = #{s < l}, count = #{s == l} via binary search.  Takes `(L,)`
    against `(S,)` or `(B, L)` against `(B, S)`."""
    lo = torch.searchsorted(build_sorted, probe, side="left", out_int32=True)
    hi = torch.searchsorted(build_sorted, probe, side="right", out_int32=True)
    return lo, hi - lo
