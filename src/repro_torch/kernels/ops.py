"""Wrappers the engine, the maintainer and the LM call: operand checks,
then the kernel.

A wrapper takes the plain version (`kernels/ref.py`) for tensors on the
CPU and launches the CUDA kernel for tensors on the card; it never falls
back from one to the other.  Operands are checked up front, with a typed
error naming the operand, as `repro/kernels/ops.py` does.

Every wrapper also has a shape rule for tensors on the `meta` device:
outputs of the plain version's shapes and dtypes, with no data.  The
static body lint (`repro_torch.analysis.body_lint`) runs the bucket
bodies there (the joins reach `join_count`), and the dry-run
(`repro_torch.launch.dryrun`) traces whole LM steps there.

`flash_attention` is differentiable: an autograd Function whose forward
is the op `torch.ops.repro_torch.flash_attention` (the kernel on the
card, its plain version on the CPU, `empty_like(q)` on `meta`) and whose
backward is `attention_backward`, the gradient of causal GQA attention
in torch ops (the JAX package differentiates its chunked attention
through XLA, outside any Pallas kernel).  The op carries a flop formula
(`attention_flops`) that `torch.utils.flop_counter.FlopCounterMode`
reads, so a trace counts the kernel's work.
"""
from __future__ import annotations

import math

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import ref
from repro_torch.kernels.filter_mask import ROWS_PER_BLOCK, filter_mask_cuda
from repro_torch.kernels.flash_attn import (DTYPES, HEAD_DIMS, QUERY_TILE,
                                            flash_attention_cuda)
from repro_torch.kernels.join_count import join_count_cuda
from repro_torch.kernels.scatter_append import (scatter_append_counts_cuda,
                                                 scatter_append_cuda)

_MAX_GRID_Y = 65535
ATTN_BWD_BLOCK = 512   # query and key positions a block of attention_backward


def _check(x, name: str, ndim: int | tuple[int, ...],
           dtype: torch.dtype | None = None) -> None:
    """Operand contract: a tensor of the given rank and (optionally)
    dtype."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(x).__name__}")
    ranks = (ndim,) if isinstance(ndim, int) else ndim
    if x.dim() not in ranks:
        raise ValueError(
            f"{name} must be {' or '.join(f'{r}-D' for r in ranks)}, "
            f"got shape {tuple(x.shape)}")
    if dtype is not None and x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")


def _device_of(x: torch.Tensor, name: str, meta: bool = False) -> str:
    """'cpu' (take the plain version), 'cuda' (launch the kernel), or,
    for a wrapper with a shape rule (`meta=True`), 'meta' (abstract
    evaluation: shapes and dtypes only)."""
    if x.is_cuda:
        return "cuda"
    if x.device.type == "cpu":
        return "cpu"
    if meta and x.device.type == "meta":
        return "meta"
    raise ValueError(f"{name} runs on cpu or cuda, not {x.device}")


def join_count(probe: torch.Tensor, build_sorted: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo, count) per probe key against the ascending build column.

    probe: `(L,)` or `(B, L)` int32, invalid slots -1;
    build_sorted: `(S,)` or `(B, S)` int32 ascending, padded with
    SENTINEL_HI — one build row per probe row.  Both on one device and
    contiguous.  Returns two int32 tensors shaped like `probe`.
    """
    # the common case first, in as few tensor queries as it takes; any
    # miss goes through _check for the error that names the operand
    nd = probe.dim() if isinstance(probe, torch.Tensor) else 0
    if not (nd in (1, 2) and isinstance(build_sorted, torch.Tensor)
            and build_sorted.dim() == nd and probe.dtype == torch.int32
            and build_sorted.dtype == torch.int32):
        _check(probe, "probe", (1, 2), torch.int32)
        _check(build_sorted, "build_sorted", probe.dim(), torch.int32)
    if nd == 2 and probe.shape[0] != build_sorted.shape[0]:
        raise ValueError(
            f"probe has {probe.shape[0]} rows but build_sorted has "
            f"{build_sorted.shape[0]}")
    if probe.device != build_sorted.device:
        raise ValueError(
            f"probe on {probe.device} but build_sorted on "
            f"{build_sorted.device}")
    if not (probe.is_contiguous() and build_sorted.is_contiguous()):
        raise ValueError("probe and build_sorted must be contiguous")
    where = _device_of(probe, "join_count", meta=True)
    if where == "cpu":
        return ref.join_count_ref(probe, build_sorted)
    if where == "meta":  # shape rule: (lo, count) are shaped like probe
        return torch.ops.repro_torch.join_count(probe, build_sorted)
    if probe.numel() == 0:
        return torch.empty_like(probe), torch.empty_like(probe)
    if nd == 2 and probe.shape[0] > _MAX_GRID_Y:
        raise ValueError(
            f"join_count takes at most {_MAX_GRID_Y} rows, got {probe.shape[0]}")
    return join_count_cuda(probe, build_sorted)


# The probe as one op on `meta`, so that a trace sees its operands and
# results (the dry-run counts their bytes).  Registered once a process,
# as `flash_attention`'s op below.
if not hasattr(torch.ops.repro_torch, "join_count"):
    @torch.library.custom_op("repro_torch::join_count", mutates_args=())
    def _join_count_op(probe: torch.Tensor, build_sorted: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
        """The plain version; `join_count` calls the op on `meta` only."""
        return ref.join_count_ref(probe, build_sorted)

    @_join_count_op.register_fake
    def _(probe, build_sorted):
        return torch.empty_like(probe), torch.empty_like(probe)


def filter_mask(rows: torch.Tensor, conds: tuple[tuple[int, int], ...]
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(mask, block_counts) for a static conjunction of equalities.

    rows: `(N, W)` int32, contiguous, invalid rows with -1 in column 0;
    conds: static `((col, value), ...)` int pairs.  Returns the `(N,)`
    int32 mask and one int32 popcount per 512-row block.
    """
    _check(rows, "rows", 2, torch.int32)
    width = rows.shape[1]
    for k, cond in enumerate(conds):
        if len(cond) != 2 or not all(isinstance(c, int) for c in cond):
            raise TypeError(
                f"conds[{k}] must be a static (col, value) int pair, "
                f"got {cond!r}")
        col, _value = cond
        if not (0 <= col < width):
            raise ValueError(
                f"conds[{k}] column {col} out of range for rows of "
                f"width {width}")
    if width < 1:
        raise ValueError("rows must have at least one column")
    if not rows.is_contiguous():
        raise ValueError("rows must be contiguous")
    conds = tuple(tuple(c) for c in conds)   # hashable: the device copy
    #                                           is cached per conds
    where = _device_of(rows, "filter_mask", meta=True)
    if where == "cpu":
        return ref.filter_mask_ref(rows, conds)
    if where == "meta":  # shape rule: the mask, one count per block
        n = rows.shape[0]
        return (rows.new_empty((n,)),
                rows.new_empty((-(-n // ROWS_PER_BLOCK),)))
    if rows.shape[0] == 0:
        empty = torch.empty(0, dtype=torch.int32, device=rows.device)
        return empty, empty.clone()
    return filter_mask_cuda(rows, conds)


def scatter_append(buf: torch.Tensor, n, rows: torch.Tensor, k
                   ) -> torch.Tensor:
    """Append `rows[:k]` at position `n` of the `(cap, W)` buffer without
    changing its shape: the streaming-maintenance extent append.  Returns
    a new buffer; `buf` is left as it was.

    `n` and `k` are host ints (checked against `cap` and the delta
    capacity here, and passed to the kernel by value: no device tensor is
    built for them, so the call makes no host-device copy and does not
    synchronise) or int32 scalar tensors on the buffer's device, taken as
    they are and read by the kernel on the device as `[[n, k]]`.
    """
    if not (isinstance(buf, torch.Tensor) and isinstance(rows, torch.Tensor)
            and buf.dim() == 2 and rows.dim() == 2
            and buf.dtype == torch.int32 and rows.dtype == torch.int32):
        _check(buf, "buf", 2, torch.int32)
        _check(rows, "rows", 2, torch.int32)
    cap, width = buf.shape
    dcap, rows_width = rows.shape
    if width != rows_width:
        raise ValueError(f"buf width {width} != rows width {rows_width}")
    if buf.device != rows.device:
        raise ValueError(f"buf on {buf.device} but rows on {rows.device}")
    if not (buf.is_contiguous() and rows.is_contiguous()):
        raise ValueError("buf and rows must be contiguous")
    on_host = isinstance(n, int) and isinstance(k, int)
    if on_host:
        if n < 0 or k < 0:
            raise ValueError(f"n and k must be non-negative, got {n}, {k}")
        if n + k > cap:
            raise ValueError(
                f"append overflows capacity: n={n} + k={k} > cap={cap} — "
                f"grow the capacity class first")
        if k > dcap:
            raise ValueError(f"k={k} exceeds delta buffer capacity {dcap}")
    else:
        nk = torch.stack([torch.as_tensor(v, dtype=torch.int32,
                                          device=buf.device).reshape(())
                          for v in (n, k)]).reshape(1, 2)
    where = _device_of(buf, "scatter_append", meta=True)
    if where == "cpu":
        if on_host:
            nk = torch.tensor([[n, k]], dtype=torch.int32)
        return ref.scatter_append_ref(buf, rows, nk)
    if where == "meta":  # shape rule: a new buffer shaped like buf
        return torch.empty_like(buf)
    if buf.numel() == 0:
        return buf.clone()
    if on_host:
        return scatter_append_counts_cuda(buf, rows, n, k)
    return scatter_append_cuda(buf, rows, nk)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: int = 0) -> torch.Tensor:
    """Causal flash attention (GQA, sliding window if `window > 0`),
    differentiable: the forward is the kernel, the gradient
    `attention_backward`.

    q: `(B, S, H, hd)`; k, v: `(B, S, Hkv, hd)`, contiguous, one dtype
    (float32 or bfloat16) and one device; `hd` one of `HEAD_DIMS`.
    Returns `(B, S, H, hd)` in q's dtype.  Any `S >= 1`: the kernel masks
    its tail tile, so the Pallas kernel's `S % 128` rule does not apply.
    On the card, `flash_attn.design(dtype, hd)` picks the kernel: the
    tensor-core design for bf16 at hd 64, 128 and 256, the CUDA-core one
    otherwise.
    """
    _check(q, "q", 4)
    _check(k, "k", 4)
    _check(v, "v", 4)
    if k.shape != v.shape:
        raise ValueError(
            f"k and v must agree, got {tuple(k.shape)} vs {tuple(v.shape)}")
    if q.shape[0] != k.shape[0] or q.shape[1] != k.shape[1] \
            or q.shape[3] != k.shape[3]:
        raise ValueError(
            f"q {tuple(q.shape)} incompatible with kv {tuple(k.shape)}: "
            "batch, sequence and head dims must agree (q: (B,S,H,hd), "
            "kv: (B,S,Hkv,hd))")
    if k.shape[2] < 1 or q.shape[2] % k.shape[2] != 0:
        raise ValueError(
            f"query heads {q.shape[2]} must be a multiple of kv heads "
            f"{k.shape[2]} (GQA grouping)")
    if not isinstance(window, int) or window < 0:
        raise ValueError(f"window must be a non-negative int, got {window!r}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"q, k and v must share one dtype of {sorted(map(str, DTYPES))},"
            f" got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(
            f"head dim {q.shape[3]} has no kernel; supported: {HEAD_DIMS}")
    if not (q.device == k.device == v.device):
        raise ValueError(
            f"q, k and v must be on one device, got {q.device}, {k.device}, "
            f"{v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    on_card = _device_of(q, "flash_attention", meta=True) == "cuda"
    if on_card and -(-q.shape[1] // QUERY_TILE) > _MAX_GRID_Y:
        raise ValueError(
            f"flash_attention takes at most {_MAX_GRID_Y * QUERY_TILE} "
            f"positions, got {q.shape[1]}")
    return _FlashAttention.apply(q, k, v, window)


def attention_pairs(S: int, window: int) -> int:
    """Unmasked (query, key) pairs of one head: keys t <= s, and
    t > s - window when window > 0, i.e. the sum over s of
    min(s + 1, window)."""
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def attention_flops(B: int, S: int, H: int, hd: int, window: int) -> int:
    """The forward's flops: 4 * hd per unmasked pair per head (the QK^T
    and PV products, a multiply and an add each)."""
    return 4 * hd * B * H * attention_pairs(S, window)


# The forward as one op, so that a dispatch mode sees it whole and
# FlopCounterMode counts it by `attention_flops`.  A copy of this module
# imported from another tree in the same process (a parent tree timed
# beside this one) finds the op registered and uses it as it is.
if not hasattr(torch.ops.repro_torch, "flash_attention"):
    @torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
    def _flash_attention_op(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, window: int) -> torch.Tensor:
        """The kernel for tensors on the card, its plain version on the
        CPU (operands checked by `flash_attention`)."""
        if _device_of(q, "flash_attention") == "cpu":
            return ref.flash_attention_ref(q, k, v, window)
        if q.numel() == 0:
            return torch.empty_like(q)
        return flash_attention_cuda(q, k, v, window)

    @_flash_attention_op.register_fake
    def _(q, k, v, window):
        """The shape rule (`meta` and fake tensors): out shaped and typed
        like q."""
        return torch.empty_like(q)

    @register_flop_formula(torch.ops.repro_torch.flash_attention)
    def _(q_shape, k_shape, v_shape, window, *args, **kwargs) -> int:
        B, S, H, hd = q_shape
        return attention_flops(B, S, H, hd, window)


def register_partitioning() -> None:
    """Give `repro_torch::flash_attention` its DTensor sharding rule
    (`distributed.sharding.register_rules` calls it once a process).
    The kernel runs on each device's shard when q, k and v are split
    alike by batch
    (dim 0) or by heads (dim 2; both head counts divide by the shards of
    every mesh dim q splits them over), as q's placements say; S is
    never split.  Any other layout is replicated first, as GSPMD does
    for a custom call."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.repro_torch.flash_attention.default)
    def _(q, k, v, window):
        dims = [p.dim for p in q.placements if p.is_shard()]
        split = math.prod(n for n, p in zip(q.mesh.shape, q.placements)
                          if p.is_shard(2))
        heads_split = (q.shape[2] % split == 0 and k.shape[2] % split == 0)
        opts = [Replicate()]
        if 0 in dims:
            opts.append(Shard(0))
        if 2 in dims and heads_split:
            opts.append(Shard(2))
        return [([p], [p, p, p, None]) for p in opts]


class _FlashAttention(torch.autograd.Function):
    """`torch.ops.repro_torch.flash_attention` with `attention_backward`
    as its gradient; q, k, v and the output are saved for the
    backward."""

    @staticmethod
    def forward(ctx, q, k, v, window: int):
        out = torch.ops.repro_torch.flash_attention(q, k, v, window)
        ctx.save_for_backward(q, k, v, out)
        ctx.window = window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, out, dout, ctx.window)
        return dq, dk, dv, None


def attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       out: torch.Tensor, dout: torch.Tensor, window: int = 0
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of causal GQA attention with an optional window, given
    its inputs, its output `out` and the output's gradient `dout` (shapes
    and masking as `flash_attention`).  fp32 throughout, over query and key
    blocks of `ATTN_BWD_BLOCK` positions (only the pairs the mask lets
    through), so no S x S tensor is live: per query block, the
    log-sum-exp of its scores first; then per key block
    P = exp(s - lse) (0 where masked),
    dV += P^T dO, dS = P * (dO V^T - D) with D = rowsum(dO * O),
    dQ += dS K / sqrt(hd), dK += dS^T Q / sqrt(hd), dK and dV summed over
    the G query heads of each kv head.  Returns the gradients in the
    dtypes of q, k and v."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(hd)
    block = ATTN_BWD_BLOCK
    # head-major fp32 views: q, o, do (B, Hkv, G, S, hd); k, v (B, Hkv, S, hd)
    qf = q.reshape(B, S, Hkv, G, hd).permute(0, 2, 3, 1, 4).float()
    of = out.reshape(B, S, Hkv, G, hd).permute(0, 2, 3, 1, 4).float()
    dof = dout.reshape(B, S, Hkv, G, hd).permute(0, 2, 3, 1, 4).float()
    kf = k.permute(0, 2, 1, 3).float()
    vf = v.permute(0, 2, 1, 3).float()
    delta = (dof * of).sum(-1)                              # (B,Hkv,G,S)
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for i0 in range(0, S, block):
        i1 = min(S, i0 + block)
        lo = 0 if window <= 0 else max(0, i0 - window + 1)
        spans = [(j0, min(i1, j0 + block))
                 for j0 in range(lo - lo % block, i1, block)]
        qi = qf[:, :, :, i0:i1] * scale
        rows = torch.arange(i0, i1, device=q.device)[:, None]

        def scores(j0, j1):
            """The block's scaled scores, -inf where masked."""
            s = torch.einsum("bkgsh,bkth->bkgst", qi, kf[:, :, j0:j1])
            cols = torch.arange(j0, j1, device=q.device)[None, :]
            keep = cols <= rows
            if window > 0:
                keep = keep & (cols > rows - window)
            return s.masked_fill(~keep, -math.inf)

        lse = torch.full(qi.shape[:-1], -math.inf, device=q.device)
        for j0, j1 in spans:
            lse = torch.logaddexp(lse, torch.logsumexp(scores(j0, j1), -1))
        doi = dof[:, :, :, i0:i1]
        di = delta[:, :, :, i0:i1]
        for j0, j1 in spans:
            p = torch.exp(scores(j0, j1) - lse[..., None])
            dv[:, :, j0:j1] += torch.einsum("bkgst,bkgsh->bkth", p, doi)
            dp = torch.einsum("bkgsh,bkth->bkgst", doi, vf[:, :, j0:j1])
            ds = p * (dp - di[..., None])
            dq[:, :, :, i0:i1] += torch.einsum(
                "bkgst,bkth->bkgsh", ds, kf[:, :, j0:j1]) * scale
            dk[:, :, j0:j1] += torch.einsum("bkgst,bkgsh->bkth", ds, qi)
    dq = dq.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).to(q.dtype)
    dk = dk.permute(0, 2, 1, 3).to(k.dtype)
    dv = dv.permute(0, 2, 1, 3).to(v.dtype)
    return dq, dk, dv
