"""Transformer building blocks: RMSNorm, RoPE/M-RoPE, GQA attention
(global + sliding-window, train + cached decode), the SwiGLU MLP and
capacity-bucketed MoE.

Twin of `repro/models/layers.py`.  Functions are
pure apart from `attention_decode`, which writes the new key and value
into the cache in place (one slot per step, where JAX copies the
buffer).  The chunked attention path of JAX (`_chunked_attention`, the
Pallas kernel's schedule in XLA loops) is the `flash_attention` kernel
here (`kernels/ops.py`), differentiable through its autograd Function.
`torch.einsum` and `torch.matmul` do not promote mixed dtypes as
`jnp.einsum` does, so the operands are promoted explicitly where JAX
relies on it (fp32 activations against the bf16 decode cache; an fp32
encoder output against bf16 cross-attention weights).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamSpec

NEG_INF = -1e30


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`jnp.einsum` on two operands: promote to their common dtype."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`a @ b` in the operands' common dtype, as `jnp.einsum` promotes."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def _sqrt_as(n: int, dtype: torch.dtype) -> float:
    """`jnp.sqrt(n).astype(dtype)` as a host float: the float32 root
    rounded to `dtype`.  A host scalar, so using it copies nothing to the
    device (a copy would synchronize the host once per layer)."""
    return float(torch.tensor(math.sqrt(n), dtype=torch.float32).to(dtype))


# ----------------------------------------------------------------------
# norm
# ----------------------------------------------------------------------
def rmsnorm_template(d: int) -> dict:
    return {"scale": ParamSpec((d,), ("embed",), init="ones")}


def rmsnorm(p, x: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


# ----------------------------------------------------------------------
# rotary embeddings
# ----------------------------------------------------------------------
def _rope_freqs(hd: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def _rotate_pairs(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B,S,H,hd); positions: (B,S) -> rotated x."""
    freqs = _rope_freqs(x.shape[-1], theta, x.device)       # (hd/2,)
    return _rotate_pairs(x, positions[..., None].float() * freqs)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: tuple[int, int, int]) -> torch.Tensor:
    """M-RoPE (qwen2-vl): positions (B,S,3) = (t,h,w); the half-dim rotary
    frequency bands are split into three sections, one per coordinate.
    For text tokens all three coordinates are equal -> reduces to RoPE."""
    hd = x.shape[-1]
    half = hd // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {sections} must sum to {half}")
    freqs = _rope_freqs(hd, theta, x.device)                # (half,)
    band = torch.arange(half, device=x.device)
    sec_id = (band >= sections[0]).long() \
        + (band >= sections[0] + sections[1]).long()       # (half,) in {0,1,2}
    pos = positions.float()[:, :, sec_id]                   # (B,S,half)
    return _rotate_pairs(x, pos * freqs)


def _rotate(cfg: ModelConfig, x, positions, theta):
    if cfg.mrope and positions.dim() == 3:
        return apply_mrope(x, positions, theta, cfg.mrope_sections)
    if positions.dim() == 3:
        positions = positions[..., 0]
    return apply_rope(x, positions, theta)


# ----------------------------------------------------------------------
# attention
# ----------------------------------------------------------------------
def attention_template(cfg: ModelConfig, cross: bool = False) -> dict:
    d, hd = cfg.d_model, cfg.hd
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    t = {
        "norm": rmsnorm_template(d),
        "wq": ParamSpec((d, nq), ("embed", "heads"), init="scaled"),
        "wk": ParamSpec((d, nkv), ("embed", "kv"), init="scaled"),
        "wv": ParamSpec((d, nkv), ("embed", "kv"), init="scaled"),
        "wo": ParamSpec((nq, d), ("heads", "embed"), init="scaled"),
    }
    if cfg.qkv_bias:
        t["bq"] = ParamSpec((nq,), ("heads",), init="zeros")
        t["bk"] = ParamSpec((nkv,), ("kv",), init="zeros")
        t["bv"] = ParamSpec((nkv,), ("kv",), init="zeros")
    return t


def _qkv(p, cfg: ModelConfig, x, kv_src=None):
    B, S, _ = x.shape
    hd = cfg.hd
    kv_src = x if kv_src is None else kv_src
    q = x @ p["wq"].to(x.dtype)
    k = _mm(kv_src, p["wk"].to(x.dtype))
    v = _mm(kv_src, p["wv"].to(x.dtype))
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = q.reshape(B, S, cfg.n_heads, hd)
    k = k.reshape(B, kv_src.shape[1], cfg.n_kv_heads, hd)
    v = v.reshape(B, kv_src.shape[1], cfg.n_kv_heads, hd)
    return q, k, v


def _gqa_scores(q, k):
    """q: (B,S,H,hd), k: (B,T,Hkv,hd) -> scores (B,Hkv,G,S,T)."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, S, Hkv, H // Hkv, hd)
    s = _einsum("bskgh,btkh->bkgst", qg, k)
    return s / _sqrt_as(hd, q.dtype)


def _gqa_out(probs, v):
    """probs: (B,Hkv,G,S,T), v: (B,T,Hkv,hd) -> (B,S,H*hd)."""
    B, Hkv, G, S, T = probs.shape
    out = _einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(B, S, Hkv * G * v.shape[-1])


def attention_train(p, cfg: ModelConfig, x, positions, window: int = 0,
                    theta: float | None = None, kv_src=None, causal=True,
                    return_kv: bool = False):
    """Full-sequence attention; window>0 = sliding window; kv_src set =
    cross attention (no mask, no rope).

    cfg.attn_impl == "chunked" runs the `flash_attention` kernel where
    the JAX package runs its chunked online-softmax path, under the same
    condition; elsewhere the dense path runs, as there."""
    y = rmsnorm(p["norm"], x, cfg.norm_eps)
    kv_in = rmsnorm(p["norm"], kv_src, cfg.norm_eps) if kv_src is not None else None
    q, k, v = _qkv(p, cfg, y, kv_in)
    th = theta if theta is not None else cfg.rope_theta
    cross = kv_src is not None
    if not cross:
        q = _rotate(cfg, q, positions, th)
        k = _rotate(cfg, k, positions, th)
    if (cfg.attn_impl == "chunked" and not cross and causal
            and q.shape[1] == k.shape[1] and q.shape[1] % cfg.attn_chunk == 0):
        B, S, H, hd = q.shape
        out = ops.flash_attention(q, k, v, window).reshape(B, S, H * hd)
    else:
        scores = _gqa_scores(q, k).float()
        S, T = scores.shape[-2], scores.shape[-1]
        if causal and not cross:
            i = torch.arange(S, device=x.device)[:, None]
            j = torch.arange(T, device=x.device)[None, :]
            mask = j <= i
            if window > 0:
                mask = mask & (j > i - window)
            scores = torch.where(mask, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        out = _gqa_out(probs, v)
    proj = _mm(out, p["wo"].to(x.dtype))
    if return_kv:
        return proj, (k, v)
    return proj


def kv_into_cache(k, v, cache_len: int, window: int = 0):
    """Pack full-sequence K/V (B,S,kv,hd) into a decode cache buffer.

    Full attention: positions [0,S) land at slots [0,S) of a cache of
    length cache_len >= S.  Sliding window (rolling cache of length
    T=min(window, cache_len)): slot p % T holds position p, keeping the
    last T positions — exactly the decode-side convention."""
    B, S, kv, hd = k.shape
    if window > 0:
        T = min(window, cache_len)
        take = min(T, S)
        idx = torch.arange(S - take, S, device=k.device) % T
        ck = torch.zeros((B, T, kv, hd), dtype=torch.bfloat16, device=k.device)
        cv = torch.zeros_like(ck)
        ck[:, idx] = k[:, S - take:].to(torch.bfloat16)
        cv[:, idx] = v[:, S - take:].to(torch.bfloat16)
        return ck, cv
    if cache_len < S:
        raise ValueError(f"cache_len {cache_len} cannot hold {S} positions")
    pad = cache_len - S
    ck = F.pad(k.to(torch.bfloat16), (0, 0, 0, 0, 0, pad))
    cv = F.pad(v.to(torch.bfloat16), (0, 0, 0, 0, 0, pad))
    return ck, cv


def attention_decode(p, cfg: ModelConfig, x, pos: int, cache: dict,
                     window: int = 0, theta: float | None = None):
    """One-token decode with a (possibly rolling) KV cache.

    x: (B,1,d); pos: host int (current position, 0-based)
    cache: {"k","v": (B, T_cache, Hkv, hd)}; rolling iff window>0
    (slot = pos % T_cache holds position pos).  The new key and value
    are written into `cache` in place; it is returned as the new cache.
    """
    y = rmsnorm(p["norm"], x, cfg.norm_eps)
    q, k, v = _qkv(p, cfg, y)
    th = theta if theta is not None else cfg.rope_theta
    B = x.shape[0]
    pos_b = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    if cfg.mrope:
        pos_b = pos_b[..., None].expand(B, 1, 3)
    q = _rotate(cfg, q, pos_b, th)
    k = _rotate(cfg, k, pos_b, th)
    ck, cv = cache["k"], cache["v"]
    T = ck.shape[1]
    slot = pos % T
    ck[:, slot:slot + 1] = k.to(ck.dtype)
    cv[:, slot:slot + 1] = v.to(cv.dtype)
    scores = _gqa_scores(q, ck).float()                     # (B,Hkv,G,1,T)
    j = torch.arange(T, device=x.device)
    if window > 0:
        # slot t holds position pos - ((pos - t) mod T); valid if within window
        cache_pos = pos - torch.remainder(pos - j, T)
        valid = (cache_pos >= 0) & (cache_pos > pos - window) & (cache_pos <= pos)
    else:
        valid = j <= pos
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = _gqa_out(probs, cv)
    proj = out @ p["wo"].to(x.dtype)
    return proj, {"k": ck, "v": cv}


# ----------------------------------------------------------------------
# MLP (SwiGLU)
# ----------------------------------------------------------------------
def mlp_template(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "norm": rmsnorm_template(d),
        "w_gate": ParamSpec((d, f), ("embed", "mlp"), init="scaled"),
        "w_up": ParamSpec((d, f), ("embed", "mlp"), init="scaled"),
        "w_down": ParamSpec((f, d), ("mlp", "embed"), init="scaled"),
    }


def mlp(p, cfg: ModelConfig, x):
    y = rmsnorm(p["norm"], x, cfg.norm_eps)
    g = y @ p["w_gate"].to(x.dtype)
    u = y @ p["w_up"].to(x.dtype)
    return (F.silu(g) * u) @ p["w_down"].to(x.dtype)


# ----------------------------------------------------------------------
# MoE (token-choice top-k, capacity-bucketed dispatch)
# ----------------------------------------------------------------------
def moe_template(cfg: ModelConfig) -> dict:
    d, f, m = cfg.d_model, cfg.d_ff, cfg.moe
    t = {
        "norm": rmsnorm_template(d),
        "router": ParamSpec((d, m.n_experts), ("embed", "expert"), init="scaled"),
        "w_gate": ParamSpec((m.n_experts, d, f), ("expert", "embed", "mlp"), init="scaled"),
        "w_up": ParamSpec((m.n_experts, d, f), ("expert", "embed", "mlp"), init="scaled"),
        "w_down": ParamSpec((m.n_experts, f, d), ("expert", "mlp", "embed"), init="scaled"),
    }
    if m.n_shared_experts:
        fs = f * m.n_shared_experts
        t["ws_gate"] = ParamSpec((d, fs), ("embed", "mlp"), init="scaled")
        t["ws_up"] = ParamSpec((d, fs), ("embed", "mlp"), init="scaled")
        t["ws_down"] = ParamSpec((fs, d), ("mlp", "embed"), init="scaled")
    return t


def moe(p, cfg: ModelConfig, x):
    """Token-choice top-k MoE: the single-device capacity-bucketed
    dispatch (sort by expert, rank, scatter, batched expert products).

    JAX takes this path outside a distribution context; inside one it
    runs explicit expert parallelism over a mesh of devices
    (`_moe_expert_parallel`, shard_map), which needs several cards and is
    not ported (ROADMAP A11)."""
    return _moe_dense(p, cfg, x)


def _route(cfg: ModelConfig, logits: torch.Tensor, dtype: torch.dtype):
    """Route the `(T, E)` router logits: the top-k experts of each token
    in `jax.lax.top_k`'s order (ties to the lower expert index), gates by
    a float32 softmax over them cast to `dtype`, and the `(token, k)`
    pairs sorted stably by expert.  A pair is kept when its rank within
    its expert is below the capacity `cap`; kept pairs go to slot
    `expert * cap + rank`, dropped ones to slot `E * cap`.

    Returns (se, st_, sg, keep, slot, cap): expert, token and gate of each
    sorted pair, the kept mask, the slots and the capacity."""
    m = cfg.moe
    T, E = logits.shape
    k = m.top_k
    # a stable descending sort: equal logits keep the lower index first
    top, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates = torch.softmax(top[:, :k].float(), dim=-1).to(dtype)   # (T,k)
    cap = int(max(1, round(T * k / E * m.capacity_factor)))
    pair_e = idx[:, :k].reshape(T * k)
    pair_t = torch.arange(T, device=logits.device)[:, None].expand(
        T, k).reshape(T * k)
    pair_g = gates.reshape(T * k)

    order = torch.argsort(pair_e, stable=True)
    se, st_, sg = pair_e[order], pair_t[order], pair_g[order]
    grp_start = torch.searchsorted(se, se, side="left")
    rank = torch.arange(T * k, device=logits.device) - grp_start
    keep = rank < cap
    slot = torch.where(keep, se * cap + rank, E * cap)
    return se, st_, sg, keep, slot, cap


def _moe_dense(p, cfg: ModelConfig, x):
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    E = m.n_experts
    y = rmsnorm(p["norm"], x, cfg.norm_eps)
    flat = y.reshape(T, d)

    logits = flat @ p["router"].to(x.dtype)
    _, st_, sg, keep, slot, cap = _route(cfg, logits, x.dtype)

    # the (E, cap, d) buffer, expert-major; row E*cap takes the dropped
    # pairs and is cut off
    xbuf = torch.zeros((E * cap + 1, d), dtype=x.dtype, device=x.device)
    xbuf[slot] = flat[st_]
    xbuf = xbuf[:-1].reshape(E, cap, d)
    g = torch.bmm(xbuf, p["w_gate"].to(x.dtype))
    u = torch.bmm(xbuf, p["w_up"].to(x.dtype))
    out = torch.bmm(F.silu(g) * u, p["w_down"].to(x.dtype))
    out_flat = out.reshape(E * cap, d)
    gathered = out_flat[torch.clamp(slot, 0, E * cap - 1)]
    contrib = torch.where(keep[:, None], gathered * sg[:, None], 0)
    combined = torch.zeros((T, d), dtype=x.dtype, device=x.device)
    combined.index_add_(0, st_, contrib)

    if m.n_shared_experts:
        gs = flat @ p["ws_gate"].to(x.dtype)
        us = flat @ p["ws_up"].to(x.dtype)
        combined = combined + (F.silu(gs) * us) @ p["ws_down"].to(x.dtype)
    return combined.reshape(B, S, d)
