"""Transformer building blocks: RMSNorm, RoPE/M-RoPE, GQA attention
(global + sliding-window, train + cached decode), the SwiGLU MLP and
capacity-bucketed MoE (single-device, and expert-parallel under
`axis_ctx`: over a mesh stacked on one device, or as one device's
program of a production mesh).

Twin of `repro/models/layers.py`, its `shard_act` constraints included
(`distributed/sharding.py`: they change no value on a stacked mesh).  Functions are
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
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (active_ctx, mesh_axes_of,
                                              mesh_dims, shard_act)
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
    """probs: (B,Hkv,G,S,T), v: (B,T,Hkv,hd) -> (B,S,H*hd).  The product
    keeps probs' (G, S) order, so its batched matmul reads probs as they
    lie (no copy; G, when split over the mesh, leads the merged rows)
    and copies v once; the output is permuted after."""
    B, Hkv, G, S, T = probs.shape
    out = _einsum("bkgst,btkh->bkgsh", probs, v)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, Hkv * G * v.shape[-1])


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
    """Token-choice top-k MoE.

    Two paths with identical routing semantics, as in the JAX package:
      * outside a distribution context: single-device capacity-bucketed
        dispatch (sort by expert, rank, scatter, batched expert products),
      * inside `axis_ctx` whose rules map 'expert' onto mesh axes:
        expert parallelism (`_moe_expert_parallel`), every (data, expert)
        shard routing ITS token block to its local experts with its own
        capacity, the shards summed over the expert axes.  The port's
        mesh stacks its shards on one device, so every shard is computed
        at once.
    """
    ctx = active_ctx()
    if ctx is not None and mesh_axes_of("expert"):
        return _moe_expert_parallel(p, cfg, x, ctx)
    return _moe_dense(p, cfg, x)


def _top_k(logits: torch.Tensor, k: int, dtype: torch.dtype):
    """`jax.lax.top_k` over the last axis (ties to the lower expert index)
    and the gates: a float32 softmax over the k logits cast to `dtype`.
    Returns (gates, idx), each `logits.shape[:-1] + (k,)`."""
    # a stable descending sort: equal logits keep the lower index first
    top, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates = torch.softmax(top[..., :k].float(), dim=-1).to(dtype)
    return gates, idx[..., :k]


def _route(cfg: ModelConfig, logits: torch.Tensor, dtype: torch.dtype):
    """Route the `(T, E)` router logits: the top-k experts of each token
    (`_top_k`) and the `(token, k)` pairs sorted stably by expert.  A pair
    is kept when its rank within its expert is below the capacity `cap`;
    kept pairs go to slot `expert * cap + rank`, dropped ones to slot
    `E * cap`.

    Returns (se, st_, sg, keep, slot, cap): expert, token and gate of each
    sorted pair, the kept mask, the slots and the capacity."""
    m = cfg.moe
    T, E = logits.shape
    k = m.top_k
    gates, idx = _top_k(logits, k, dtype)                   # (T,k)
    cap = int(max(1, round(T * k / E * m.capacity_factor)))
    pair_e = idx.reshape(T * k)
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
    logits = shard_act(logits, ("batch", None))
    _, st_, sg, keep, slot, cap = _route(cfg, logits, x.dtype)

    # the (E, cap, d) buffer, expert-major; row E*cap takes the dropped
    # pairs and is cut off
    xbuf = torch.zeros((E * cap + 1, d), dtype=x.dtype, device=x.device)
    xbuf[slot] = flat[st_]
    xbuf = shard_act(xbuf[:-1].reshape(E, cap, d), ("expert", None, None))
    g = torch.bmm(xbuf, p["w_gate"].to(x.dtype))
    u = torch.bmm(xbuf, p["w_up"].to(x.dtype))
    h = shard_act(F.silu(g) * u, ("expert", None, None))
    out = torch.bmm(h, p["w_down"].to(x.dtype))
    out = shard_act(out, ("expert", None, None))
    out_flat = out.reshape(E * cap, d)
    gathered = out_flat[torch.clamp(slot, 0, E * cap - 1)]
    contrib = torch.where(keep[:, None], gathered * sg[:, None], 0)
    combined = torch.zeros((T, d), dtype=x.dtype, device=x.device)
    combined.index_add_(0, st_, contrib)
    combined = shard_act(combined, ("batch", None))

    if m.n_shared_experts:
        gs = flat @ p["ws_gate"].to(x.dtype)
        us = flat @ p["ws_up"].to(x.dtype)
        combined = combined + (F.silu(gs) * us) @ p["ws_down"].to(x.dtype)
    return combined.reshape(B, S, d)


# ----------------------------------------------------------------------
# expert-parallel MoE over a stacked mesh
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class EPLayout:
    """How one expert-parallel MoE call lays out over the mesh: `n_dp`
    token blocks (the shards of the batch axes) of `T_loc` tokens each,
    `n_ep` expert shards (those of the expert axes) of `E_loc` experts
    each, and `cap`, a local expert's capacity within one shard."""

    n_dp: int
    n_ep: int
    E_loc: int
    T_loc: int
    cap: int


def _ep_layout(cfg: ModelConfig, mesh, T: int) -> EPLayout | None:
    """The layout of `T` tokens under the active rules, or None where the
    experts do not divide over the expert shards (`moe` then takes the
    dense path, as JAX does).  A shard's capacity is JAX's
    `-(-T_loc * k * cf // E)`, a float ceiling division, where the dense
    path rounds `T * k / E * cf`."""
    m = cfg.moe
    ep_axes = mesh_axes_of("expert")
    batch_axes = mesh_axes_of("batch")
    if set(ep_axes) & set(batch_axes):
        raise ValueError(f"the expert axes {ep_axes} and the batch axes "
                         f"{batch_axes} share a mesh axis")
    n_ep = math.prod(mesh.shape[a] for a in ep_axes)
    n_dp = math.prod(mesh.shape[a] for a in batch_axes)
    E = m.n_experts
    if E % n_ep != 0:
        return None
    if T % n_dp:
        raise ValueError(f"{T} tokens do not split into {n_dp} blocks over "
                         f"the batch axes {batch_axes}")
    T_loc = max(T // n_dp, 1)
    k = m.top_k
    cap = int(max(1, -(-T_loc * k * m.capacity_factor // E)))
    return EPLayout(n_dp, n_ep, E // n_ep, T_loc, cap)


def _ep_route(lay: EPLayout, idx: torch.Tensor, gates: torch.Tensor):
    """Route every (data, expert) shard at once.  `idx`, `gates`: the
    `(n_dp, T_loc, k)` top-k experts and gates of each token block.  In
    shard s = dp * n_ep + ep a pair's local expert `le` is its expert
    minus ep * E_loc when the shard holds that expert, else the drop
    bucket E_loc; one stable sort of `s * (E_loc + 1) + le` sorts every
    shard's pairs by `le` as JAX's per-shard `argsort(le)` does, and a
    pair is kept when it is local and its rank within its expert is
    below `lay.cap`.  Kept pairs go to the expert-major slot
    `((ep * E_loc + le) * n_dp + dp) * cap + rank`, so the slots of one
    expert over all token blocks are contiguous; dropped ones to the
    slot past the end.

    Returns (shard, se, st_, sg, keep, slot) of each sorted pair: its
    shard, local expert, token (a row of the flat `(n_dp * T_loc, d)`
    tokens) and gate, the kept mask and the slot."""
    n_dp, T_loc, k = idx.shape
    n_ep, E_loc, cap = lay.n_ep, lay.E_loc, lay.cap
    n_pairs = T_loc * k
    dev = idx.device
    lo = torch.arange(n_ep, device=dev)[:, None] * E_loc
    le = idx.reshape(n_dp, 1, n_pairs) - lo                 # (n_dp,n_ep,P)
    le = torch.where((le >= 0) & (le < E_loc), le, E_loc)
    base = torch.arange(n_dp * n_ep, device=dev) * (E_loc + 1)
    key = (base.reshape(n_dp, n_ep, 1) + le).reshape(-1)
    order = torch.argsort(key, stable=True)
    sk = key[order]
    rank = torch.arange(sk.numel(), device=dev) - torch.searchsorted(
        sk, sk, side="left")
    shard = order // n_pairs
    pair = order - shard * n_pairs
    se = sk - shard * (E_loc + 1)
    dp = shard // n_ep
    st_ = dp * T_loc + pair // k
    sg = gates.reshape(-1)[dp * n_pairs + pair]
    keep = (se < E_loc) & (rank < cap)
    expert = (shard - dp * n_ep) * E_loc + se
    slot = torch.where(keep, (expert * n_dp + dp) * cap + rank,
                       n_ep * E_loc * n_dp * cap)
    return shard, se, st_, sg, keep, slot


def _moe_expert_parallel(p, cfg: ModelConfig, x, ctx):
    """Expert parallelism: JAX's `shard_map` body
    (`repro/models/layers.py::_moe_expert_parallel`) for all
    `n_dp x n_ep` shards of the stacked mesh at once.

    Each token block's router logits are the full `(T_loc, E)` ones (JAX
    gathers each shard's column block with a tiled `all_gather`);
    `_ep_route` routes every shard with its own capacity; the kept
    tokens are gathered into the expert-major slot buffer `(E, n_dp *
    cap, d)` (a shard's `(E_loc, cap, d)` buffers, side by side) for one
    batched product per weight; each shard's outputs are scatter-added
    into its own `(T_loc, d)` rows; the shared experts are split by
    `d_ff` columns over the expert shards, each shard adding its partial
    down-projection; and JAX's `psum` over the expert axes is the sum
    over the expert index.  `_moe_ep_shard` is the body as written, one
    shard at a time."""
    mesh, _ = ctx
    m = cfg.moe
    B, S, d = x.shape
    lay = _ep_layout(cfg, mesh, B * S)
    if lay is None:
        return _moe_dense(p, cfg, x)
    if mesh.device_mesh is not None:
        return _moe_ep_local(p, cfg, x, mesh, lay)
    if x.device.type != mesh.device.type:
        raise ValueError(f"tokens on {x.device}, the mesh on {mesh.device}")
    n_dp, n_ep, E_loc, T_loc, cap = (lay.n_dp, lay.n_ep, lay.E_loc,
                                     lay.T_loc, lay.cap)
    E, k, dt = m.n_experts, m.top_k, x.dtype
    T = n_dp * T_loc
    y = rmsnorm(p["norm"], x.reshape(n_dp, T_loc, d), cfg.norm_eps)
    logits = y @ p["router"].to(dt)                         # (n_dp,T_loc,E)
    gates, idx = _top_k(logits, k, dt)
    _, _, st_, sg, _, slot = _ep_route(lay, idx, gates)

    n_slots = E * n_dp * cap
    tok_fs = torch.full((n_slots + 1,), T, dtype=st_.dtype,
                        device=x.device).index_put((slot,), st_)[:-1]
    gate_fs = torch.zeros((n_slots + 1,), dtype=dt,
                          device=x.device).index_put((slot,), sg)[:-1]
    filled = tok_fs < T
    yflat = y.reshape(T, d)
    xbuf = torch.where(filled[:, None], yflat[tok_fs.clamp(max=T - 1)], 0)
    xbuf = xbuf.reshape(E, n_dp * cap, d)
    g = torch.bmm(xbuf, p["w_gate"].to(dt))
    u = torch.bmm(xbuf, p["w_up"].to(dt))
    out = torch.bmm(F.silu(g) * u, p["w_down"].to(dt)).reshape(n_slots, d)
    contrib = torch.where(filled[:, None], out * gate_fs[:, None], 0)
    # slot j holds expert j // (n_dp * cap) of token block (j // cap) % n_dp:
    # its row in the (n_dp, n_ep, T_loc) stack of the shards' outputs
    j = torch.arange(n_slots, device=x.device)
    j_dp = (j // cap) % n_dp
    j_ep = j // (n_dp * cap * E_loc)
    tok = torch.where(filled, tok_fs, j_dp * T_loc)
    rows = (j_dp * n_ep + j_ep) * T_loc + tok - j_dp * T_loc
    combined = torch.zeros((n_dp * n_ep * T_loc, d), dtype=dt,
                           device=x.device).index_add(0, rows, contrib)
    combined = combined.reshape(n_dp, n_ep, T_loc, d)

    if m.n_shared_experts:
        fs = p["ws_gate"].shape[1]
        if fs % n_ep:
            raise ValueError(f"the shared experts' {fs} columns do not split "
                             f"over {n_ep} expert shards")
        hs = F.silu(y @ p["ws_gate"].to(dt)) * (y @ p["ws_up"].to(dt))
        hs = hs.reshape(n_dp, T_loc, n_ep, fs // n_ep)
        wsd = p["ws_down"].to(dt).reshape(n_ep, fs // n_ep, d)
        combined = combined + torch.einsum("ntef,efd->netd", hs, wsd)
    return combined.sum(dim=1).reshape(B, S, d)


def _ep_weights(p, lay: EPLayout, ep: int) -> dict:
    """Expert shard `ep`'s blocks of the MoE weights, as JAX's
    `shard_map` in_specs hand them to the body: the norm whole, the
    router's and the experts' block of E_loc experts, and the shared
    experts' ep-th block of d_ff columns."""
    lo, hi = ep * lay.E_loc, (ep + 1) * lay.E_loc
    w = {"norm": p["norm"], "router": p["router"][:, lo:hi]}
    for n in ("w_gate", "w_up", "w_down"):
        w[n] = p[n][lo:hi]
    if "ws_gate" in p:
        fl = p["ws_gate"].shape[1] // lay.n_ep
        cols = slice(ep * fl, (ep + 1) * fl)
        w["ws_gate"] = p["ws_gate"][:, cols]
        w["ws_up"] = p["ws_up"][:, cols]
        w["ws_down"] = p["ws_down"][cols]
    return w


def _moe_ep_shard(w, cfg: ModelConfig, xin, lay: EPLayout, ep: int,
                  router_logits, psum):
    """One (data, expert) shard of JAX's `shard_map` body, step for step:
    `w` the shard's weights (`_ep_weights`), `xin` its `(T_loc, d)`
    tokens, `ep` its rank over the expert axes; `router_logits(y)` gives
    the full `(T_loc, E)` logits of the normed tokens (JAX's tiled
    `all_gather` of each shard's column block) and `psum` sums the
    combined output over the expert axes.  Per device it is the body
    `local_map` runs (`_moe_ep_local`); shard by shard, the reference
    `_moe_expert_parallel` is held against (`_moe_ep_loop`)."""
    m = cfg.moe
    T, d = xin.shape
    k, E_loc, cap, dt = m.top_k, lay.E_loc, lay.cap, xin.dtype
    lo = ep * E_loc
    y = rmsnorm(w["norm"], xin, cfg.norm_eps)
    logits = router_logits(y)
    gates, idx = _top_k(logits, k, dt)
    pair_e = idx.reshape(T * k)
    pair_t = torch.arange(T, device=xin.device).repeat_interleave(k)
    pair_g = gates.reshape(T * k)
    local = (pair_e >= lo) & (pair_e < lo + E_loc)
    le = torch.where(local, pair_e - lo, E_loc)
    order = torch.argsort(le, stable=True)
    se, st_, sg = le[order], pair_t[order], pair_g[order]
    grp = torch.searchsorted(se, se, side="left")
    rank = torch.arange(T * k, device=xin.device) - grp
    keep = (se < E_loc) & (rank < cap)
    slot = torch.where(keep, se * cap + rank, E_loc * cap)

    n_slots = E_loc * cap
    tok_fs = torch.full((n_slots + 1,), T, dtype=st_.dtype,
                        device=xin.device).index_put((slot,), st_)[:-1]
    gate_fs = torch.zeros((n_slots + 1,), dtype=dt,
                          device=xin.device).index_put((slot,), sg)[:-1]
    filled = tok_fs < T
    xbuf = torch.where(filled[:, None], y[tok_fs.clamp(0, T - 1)], 0)
    xbuf = xbuf.reshape(E_loc, cap, d)
    g = torch.bmm(xbuf, w["w_gate"].to(dt))
    u = torch.bmm(xbuf, w["w_up"].to(dt))
    out = torch.bmm(F.silu(g) * u, w["w_down"].to(dt))
    contrib = out.reshape(n_slots, d) * gate_fs[:, None]
    combined = torch.zeros((T, d), dtype=dt, device=xin.device).index_add(
        0, tok_fs.clamp(0, T - 1), torch.where(filled[:, None], contrib, 0))

    if "ws_gate" in w:
        gs = y @ w["ws_gate"].to(dt)
        us = y @ w["ws_up"].to(dt)
        combined = combined + (F.silu(gs) * us) @ w["ws_down"].to(dt)
    return psum(combined)


def _moe_ep_loop(p, cfg: ModelConfig, x, lay: EPLayout):
    """`_moe_expert_parallel`'s result computed shard by shard: each
    token block's `_moe_ep_shard` outputs summed over the expert ranks."""
    B, S, d = x.shape
    blocks = x.reshape(lay.n_dp, lay.T_loc, d)

    def logits(y):
        return torch.cat([y @ _ep_weights(p, lay, r)["router"].to(y.dtype)
                          for r in range(lay.n_ep)], dim=1)

    return torch.stack([
        torch.stack([_moe_ep_shard(_ep_weights(p, lay, ep), cfg, blocks[dp],
                                   lay, ep, logits, lambda c: c)
                     for ep in range(lay.n_ep)]).sum(dim=0)
        for dp in range(lay.n_dp)]).reshape(B, S, d)


class _PSum(torch.autograd.Function):
    """JAX's `psum` over one mesh dim; with replicated results (its
    `check_vma=False`) the gradient is a `psum` too (the functional
    collectives have no all-reduce with a gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        from torch.distributed import _functional_collectives as funcol

        ctx.group = group
        return funcol.wait_tensor(funcol.all_reduce(x, "sum", group=group))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed import _functional_collectives as funcol

        return funcol.wait_tensor(
            funcol.all_reduce(g.contiguous(), "sum", group=ctx.group)), None


def _moe_ep_local(p, cfg: ModelConfig, x, mesh, lay: EPLayout):
    """Expert parallelism in one device's program (`per_device`): the
    body `_moe_ep_shard` under `local_map` with JAX's `shard_map` specs
    (the norm replicated; the router's columns, the experts and the
    shared experts' d_ff columns split over the expert axes; the tokens
    over the batch axes), the router logits gathered and the output
    summed over each expert mesh dim by collectives."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    dm = mesh.device_mesh
    ep_dims = mesh_dims(dm, mesh_axes_of("expert"))
    dp_dims = mesh_dims(dm, mesh_axes_of("batch"))

    def split(dim, over):
        return tuple(Shard(dim) if i in over else Replicate()
                     for i in range(dm.ndim))

    rep = split(0, ())
    w = {"norm": rep, "router": split(1, ep_dims)}
    for n in ("w_gate", "w_up", "w_down"):
        w[n] = split(0, ep_dims)
    if "ws_gate" in p:
        w.update(ws_gate=split(1, ep_dims), ws_up=split(1, ep_dims),
                 ws_down=split(0, ep_dims))
    ep = 0
    for i in ep_dims:
        ep = ep * dm.size(i) + dm.get_local_rank(i)

    def body(wl, xin):
        from torch.distributed import _functional_collectives as funcol

        def router_logits(y):
            # JAX's tiled all_gather; its gradient is a reduce-scatter
            out = y @ wl["router"].to(y.dtype)
            for i in ep_dims:
                out = funcol.all_gather_tensor_autograd(out, gather_dim=1,
                                                        group=(dm, i))
            return out

        def psum(c):
            for i in ep_dims:
                c = _PSum.apply(c, (dm, i))
            return c

        return _moe_ep_shard(wl, cfg, xin, lay, ep, router_logits, psum)

    names_w = list(w)
    B, S, d = x.shape
    run = local_map(
        lambda xin, *ws: body({**dict(zip(names_w, ws)),
                               "norm": {"scale": ws[0]}}, xin),
        out_placements=list(split(0, dp_dims)),
        in_placements=(split(0, dp_dims),) + tuple(w[n] for n in names_w),
        device_mesh=dm, redistribute_inputs=True)
    out = run(x.reshape(B * S, d), *(p[n]["scale"] if n == "norm" else p[n]
                                     for n in names_w))
    return out.reshape(B, S, d)
