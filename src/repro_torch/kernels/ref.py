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


def scatter_append_ref(buf: torch.Tensor, rows: torch.Tensor,
                       nk: torch.Tensor) -> torch.Tensor:
    """A new `(cap, W)` buffer: `rows[r - n]` for `n <= r < n + k`, else
    `buf[r]`, with `(n, k) = nk[0]` read on the tensors' device.  A slot
    past the delta buffer (`k > dcap`) reads 0, as the TPU kernel's."""
    cap, dcap = buf.shape[0], rows.shape[0]
    slot = torch.arange(cap, dtype=torch.int64, device=buf.device) \
        - nk[0, 0].long()
    take = (slot >= 0) & (slot < nk[0, 1].long())
    if dcap:
        picked = rows[slot.clamp(0, dcap - 1)]
    else:
        picked = torch.zeros_like(buf)
    picked = torch.where((slot < dcap)[:, None], picked, 0)
    return torch.where(take[:, None], picked, buf)


def filter_mask_ref(rows: torch.Tensor, conds: tuple[tuple[int, int], ...],
                    block: int = 512) -> tuple[torch.Tensor, torch.Tensor]:
    """`(mask, counts)`: mask[i] = rows[i, 0] >= 0 and every
    `rows[i, col] == value`, as int32; counts = the mask summed over each
    `block`-row block (rows past N count 0)."""
    n = rows.shape[0]
    mask = rows[:, 0] >= 0
    for col, value in conds:
        mask = mask & (rows[:, col] == value)
    mask = mask.to(torch.int32)
    padded = torch.zeros(-(-n // block) * block, dtype=torch.int32,
                         device=rows.device)
    padded[:n] = mask
    return mask, padded.view(-1, block).sum(dim=1, dtype=torch.int32)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        window: int = 0) -> torch.Tensor:
    """Dense causal GQA attention in fp32, cast back to q's dtype.
    q: `(B, S, H, hd)`; k, v: `(B, S, Hkv, hd)`; query head h reads kv
    head `h // (H // Hkv)`; with `window > 0` a query at s sees the keys
    `s - window < t <= s`.  Masked scores are -1e30, as the JAX oracle's."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, S, Hkv, G, hd).float()
    s_ = torch.einsum("bskgh,btkh->bkgst", qg, k.float()) / (hd ** 0.5)
    i = torch.arange(S, device=q.device)[:, None]
    j = torch.arange(S, device=q.device)[None, :]
    mask = j <= i
    if window > 0:
        mask = mask & (j > i - window)
    s_ = torch.where(mask, s_, -1e30)
    p = torch.softmax(s_, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", p, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)
