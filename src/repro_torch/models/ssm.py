"""Attention-free blocks: Mamba2 (SSD, chunked) and RWKV6 (Finch).

Twin of `repro/models/ssm.py`.  Mamba2 uses the chunked SSD algorithm
(intra-chunk quadratic products + an inter-chunk state recurrence);
where JAX scans over the chunks with `lax.scan`, the port loops over
them.  RWKV6's per-channel data-dependent decay does not factor into
chunk products, so its time mix runs a loop over time (JAX: a
`lax.scan`); decode is O(1)-state for both.  Every function is pure:
decode returns new state tensors, which the caller writes into its cache
(`transformer._apply_layer_decode`).

Decode state, as `(shape, dtype)` templates:
  mamba2: {"ssm": (B, nh, N, P), "conv": (B, d_conv-1, conv_dim)}
  rwkv6:  {"wkv": (B, H, hd, hd), "shift_t": (B, d), "shift_c": (B, d)}
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rmsnorm, rmsnorm_template
from repro_torch.models.params import ParamSpec


# ======================================================================
# Mamba2
# ======================================================================
def mamba2_dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = s.n_heads or d_in // s.head_dim
    conv_dim = d_in + 2 * s.state_dim
    return d_in, nh, conv_dim


def mamba2_template(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    s = cfg.ssm
    d_in, nh, conv_dim = mamba2_dims(cfg)
    return {
        "norm": rmsnorm_template(d),
        # in_proj -> [z, x, B, C, dt]
        "w_in": ParamSpec((d, 2 * d_in + 2 * s.state_dim + nh),
                          ("embed", "mlp"), init="scaled"),
        "conv_w": ParamSpec((s.d_conv, conv_dim), (None, "mlp"), init="scaled"),
        "conv_b": ParamSpec((conv_dim,), ("mlp",), init="zeros"),
        "a_log": ParamSpec((nh,), (None,), init="zeros"),
        "dt_bias": ParamSpec((nh,), (None,), init="zeros"),
        "d_skip": ParamSpec((nh,), (None,), init="ones"),
        "gate_norm": rmsnorm_template(d_in),
        "w_out": ParamSpec((d_in, d), ("mlp", "embed"), init="scaled"),
    }


def _split_in(cfg, proj):
    s = cfg.ssm
    d_in, nh, _ = mamba2_dims(cfg)
    z, x, Bm, Cm, dt = torch.split(
        proj, [d_in, d_in, s.state_dim, s.state_dim, nh], dim=-1)
    return z, x, Bm, Cm, dt


def _softplus(x):
    """`jax.nn.softplus`: logaddexp(x, 0), a pointwise op that DTensor
    partitions as it is (its `softplus` is decomposed, differently on a
    first call than on later ones, in some torch versions)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv_train(x, w, b):
    """x: (B,S,C) depthwise causal conv, window K."""
    K = w.shape[0]
    pad = torch.cat([x.new_zeros((x.shape[0], K - 1, x.shape[2])), x],
                    dim=1)
    out = torch.zeros_like(x)
    for k in range(K):
        out = out + pad[:, k: k + x.shape[1], :] * w[k]
    return out + b


def mamba2_train(p, cfg: ModelConfig, h, return_state: bool = False):
    """h: (B,S,d) -> (B,S,d) via chunked SSD.

    return_state=True also returns the decode-ready recurrent state
    ({"ssm": final state, "conv": last d_conv-1 raw conv inputs})."""
    s = cfg.ssm
    d_in, nh, conv_dim = mamba2_dims(cfg)
    P, N, C = s.head_dim, s.state_dim, s.chunk
    B, S, _ = h.shape
    if S % C != 0:
        raise ValueError(f"seq {S} must be a multiple of chunk {C}")
    nc = S // C

    y0 = rmsnorm(p["norm"], h, cfg.norm_eps)
    proj = y0 @ p["w_in"].to(h.dtype)
    z, x, Bm, Cm, dt = _split_in(cfg, proj)
    xbc_raw = torch.cat([x, Bm, Cm], dim=-1)
    xbc = F.silu(_causal_conv_train(xbc_raw, p["conv_w"].to(h.dtype),
                                    p["conv_b"].to(h.dtype)))
    x, Bm, Cm = torch.split(xbc, [d_in, N, N], dim=-1)

    dt = _softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["a_log"].float())                   # (nh,) < 0
    la = dt * A                                          # log decay (B,S,nh)

    xh = x.reshape(B, S, nh, P)
    xdt = xh.float() * dt[..., None]                     # B(t) x(t) dt(t)

    # chunk
    xc = xdt.reshape(B, nc, C, nh, P)
    lac = la.reshape(B, nc, C, nh)
    Bc = Bm.float().reshape(B, nc, C, N)
    Cc = Cm.float().reshape(B, nc, C, N)
    cum = torch.cumsum(lac, dim=2)                       # inclusive (B,nc,C,nh)

    # ---- intra-chunk: y[t] += sum_{s<=t} exp(cum_t - cum_s) (C_t.B_s) x_s
    scores = torch.einsum("bztn,bzsn->bzts", Cc, Bc)     # (B,nc,C,C)
    decay = torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :])
    tri = torch.tril(torch.ones((C, C), dtype=torch.bool, device=h.device))
    # masked before the product: above the diagonal decay overflows to inf
    M = scores[..., None] * torch.where(tri[None, None, :, :, None], decay,
                                        0.0)
    y_intra = torch.einsum("bztsh,bzshp->bzthp", M, xc)

    # ---- chunk states: S_z = sum_s exp(cum_last - cum_s) B_s x_s^T
    state_decay = torch.exp(cum[:, :, -1:, :] - cum)     # (B,nc,C,nh)
    states = torch.einsum("bzsn,bzsh,bzshp->bzhnp", Bc, state_decay, xc)

    # ---- inter-chunk recurrence: h_z = exp(cum_last) h_{z-1} + S_z
    chunk_decay = torch.exp(cum[:, :, -1, :])            # (B,nc,nh)
    carry = torch.zeros((B, nh, N, P), dtype=torch.float32, device=h.device)
    prev = []
    # the chunks' slices by one unbind each (one stack in the backward)
    for dec, st in zip(chunk_decay.unbind(1), states.unbind(1)):
        prev.append(carry)                               # the PREVIOUS state
        carry = carry * dec[:, :, None, None] + st
    final_state = carry
    prev_states = torch.stack(prev, dim=1)               # (B,nc,nh,N,P)

    # ---- inter-chunk contribution: y[t] += exp(cum_t) C_t . h_{prev}
    in_decay = torch.exp(cum)                            # (B,nc,C,nh)
    y_inter = torch.einsum("bztn,bzth,bzhnp->bzthp", Cc, in_decay,
                           prev_states)

    y = (y_intra + y_inter).reshape(B, S, nh, P)
    y = y + xh.float() * p["d_skip"].float()[None, None, :, None]
    y = y.reshape(B, S, d_in).to(h.dtype)
    y = rmsnorm(p["gate_norm"], y * F.silu(z), cfg.norm_eps)
    out = y @ p["w_out"].to(h.dtype)
    if return_state:
        tail = xbc_raw[:, -(s.d_conv - 1):].float()
        return out, {"ssm": final_state, "conv": tail}
    return out


def mamba2_state_template(cfg: ModelConfig, batch: int) -> dict:
    s = cfg.ssm
    d_in, nh, conv_dim = mamba2_dims(cfg)
    return {
        "ssm": ((batch, nh, s.state_dim, s.head_dim), torch.float32),
        "conv": ((batch, s.d_conv - 1, conv_dim), torch.float32),
    }


def mamba2_decode(p, cfg: ModelConfig, h, state):
    """h: (B,1,d); O(1) recurrent update.  Returns (out, new state); the
    state tensors passed in are not written."""
    s = cfg.ssm
    d_in, nh, conv_dim = mamba2_dims(cfg)
    P, N = s.head_dim, s.state_dim
    B = h.shape[0]
    y0 = rmsnorm(p["norm"], h, cfg.norm_eps)
    proj = y0 @ p["w_in"].to(h.dtype)
    z, x, Bm, Cm, dt = _split_in(cfg, proj)
    xbc = torch.cat([x, Bm, Cm], dim=-1)[:, 0]          # (B, conv_dim)
    window = torch.cat([state["conv"], xbc[:, None, :].float()], dim=1)
    conv_out = torch.einsum("bkc,kc->bc", window, p["conv_w"].float())
    conv_out = F.silu(conv_out + p["conv_b"].float())
    x, Bm, Cm = torch.split(conv_out, [d_in, N, N], dim=-1)

    dt = _softplus(dt[:, 0].float() + p["dt_bias"].float())
    A = -torch.exp(p["a_log"].float())
    a = torch.exp(dt * A)                                # (B,nh)
    xh = x.reshape(B, nh, P).float() * dt[..., None]
    new_ssm = state["ssm"] * a[:, :, None, None] + torch.einsum(
        "bn,bhp->bhnp", Bm, xh)
    y = torch.einsum("bn,bhnp->bhp", Cm, new_ssm)
    y = y + x.reshape(B, nh, P).float() * p["d_skip"].float()[None, :, None]
    y = y.reshape(B, 1, d_in).to(h.dtype)
    y = rmsnorm(p["gate_norm"], y * F.silu(z), cfg.norm_eps)
    out = y @ p["w_out"].to(h.dtype)
    new_state = {"ssm": new_ssm, "conv": window[:, 1:]}
    return out, new_state


# ======================================================================
# RWKV6 (Finch)
# ======================================================================
RWKV_LORA = 64


def rwkv6_dims(cfg: ModelConfig):
    hd = cfg.ssm.head_dim if cfg.ssm else 64
    nh = cfg.d_model // hd
    return nh, hd


def rwkv6_template(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    nh, hd = rwkv6_dims(cfg)
    return {
        "norm_t": rmsnorm_template(d),
        "mu": ParamSpec((5, d), (None, "embed")),        # shift mix (r,k,v,g,w)
        "wr": ParamSpec((d, d), ("embed", "heads"), init="scaled"),
        "wk": ParamSpec((d, d), ("embed", "heads"), init="scaled"),
        "wv": ParamSpec((d, d), ("embed", "heads"), init="scaled"),
        "wg": ParamSpec((d, d), ("embed", "heads"), init="scaled"),
        "w_lora_a": ParamSpec((d, RWKV_LORA), ("embed", None), init="scaled"),
        "w_lora_b": ParamSpec((RWKV_LORA, d), (None, "heads"), init="scaled"),
        "w_base": ParamSpec((d,), ("heads",), init="zeros"),
        "u_bonus": ParamSpec((nh, hd), (None, None), init="zeros"),
        "ln_out": rmsnorm_template(d),
        "wo": ParamSpec((d, d), ("heads", "embed"), init="scaled"),
        # channel mix
        "norm_c": rmsnorm_template(d),
        "mu_c": ParamSpec((2, d), (None, "embed")),
        "wk_c": ParamSpec((d, f), ("embed", "mlp"), init="scaled"),
        "wv_c": ParamSpec((f, d), ("mlp", "embed"), init="scaled"),
        "wr_c": ParamSpec((d, d), ("embed", "embed"), init="scaled"),
    }


def _shift(x, prev=None):
    """Token shift: x_{t-1} (zero / `prev` for t=0). x: (B,S,d)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    else:
        prev = prev[:, None, :]
    return torch.cat([prev, x[:, :-1]], dim=1)


def _rwkv_mix(p, cfg, x, shifted):
    """Projections with token-shift lerp; returns r,k,v,g,w (log decay)."""
    mu = p["mu"].to(x.dtype)                             # (5,d)

    def lerp(i):
        return x + (shifted - x) * mu[i]
    r = lerp(0) @ p["wr"].to(x.dtype)
    k = lerp(1) @ p["wk"].to(x.dtype)
    v = lerp(2) @ p["wv"].to(x.dtype)
    g = lerp(3) @ p["wg"].to(x.dtype)
    lora = torch.tanh(lerp(4) @ p["w_lora_a"].to(x.dtype))
    w_raw = p["w_base"].float() + (lora @ p["w_lora_b"].to(x.dtype)).float()
    # data-dependent per-channel decay in (0,1): w = exp(-exp(w_raw))
    log_w = -torch.exp(w_raw - 3.0)                      # (B,S,d) log decay <= 0
    return r, k, v, g, log_w


def rwkv6_time_mix_train(p, cfg: ModelConfig, h, shift_state=None,
                         wkv_state=None):
    """(B,S,d) -> (out (B,S,d), last normed x (B,d), WKV state
    (B,nh,hd,hd)); a sequential WKV loop over time."""
    nh, hd = rwkv6_dims(cfg)
    B, S, d = h.shape
    x = rmsnorm(p["norm_t"], h, cfg.norm_eps)
    shifted = _shift(x, shift_state)
    r, k, v, g, log_w = _rwkv_mix(p, cfg, x, shifted)
    rh = r.reshape(B, S, nh, hd).float()
    kh = k.reshape(B, S, nh, hd).float()
    vh = v.reshape(B, S, nh, hd).float()
    wh = torch.exp(log_w.reshape(B, S, nh, hd))          # decay in (0,1)
    u = p["u_bonus"].float()[None, :, :, None]           # (1,nh,hd,1)

    state = (torch.zeros((B, nh, hd, hd), dtype=torch.float32,
                         device=h.device)
             if wkv_state is None else wkv_state)
    # one step per position, four kernels each: kv = k v^T, out = r (S +
    # u kv), S' = S w + kv (no output written in place: autograd takes
    # the loop as it is).  The steps' slices come from one `unbind` a
    # tensor, whose backward is one stack; indexing each step would give
    # each a full-size gradient, S^2 bytes in the backward.
    rs, ks, vs, ws = (a.transpose(0, 1).unbind(0) for a in (rh, kh, vh, wh))
    outs = []
    for t in range(S):
        kv = ks[t][..., :, None] * vs[t][..., None, :]    # (B,nh,hd,hd)
        outs.append(torch.matmul(rs[t][..., None, :],
                                 torch.addcmul(state, u, kv)))
        state = torch.addcmul(kv, state, ws[t][..., None])
    out = torch.stack(outs).reshape(S, B, d).transpose(0, 1).to(h.dtype)
    out = rmsnorm(p["ln_out"], out, cfg.norm_eps) * F.silu(g)
    out = out @ p["wo"].to(h.dtype)
    return out, x[:, -1], state


def rwkv6_channel_mix(p, cfg: ModelConfig, h, shift_state=None):
    x = rmsnorm(p["norm_c"], h, cfg.norm_eps)
    shifted = _shift(x, shift_state)
    mu = p["mu_c"].to(x.dtype)
    xk = x + (shifted - x) * mu[0]
    xr = x + (shifted - x) * mu[1]
    k = torch.square(torch.relu(xk @ p["wk_c"].to(x.dtype)))
    kv = k @ p["wv_c"].to(x.dtype)
    r = torch.sigmoid(xr @ p["wr_c"].to(x.dtype))
    return r * kv, x[:, -1]


def rwkv6_state_template(cfg: ModelConfig, batch: int) -> dict:
    nh, hd = rwkv6_dims(cfg)
    d = cfg.d_model
    return {
        "wkv": ((batch, nh, hd, hd), torch.float32),
        "shift_t": ((batch, d), torch.float32),
        "shift_c": ((batch, d), torch.float32),
    }


def rwkv6_decode(p, cfg: ModelConfig, h, state):
    """h: (B,1,d) one-step; returns (delta_out_pair, new_state); the
    state tensors passed in are not written."""
    x = rmsnorm(p["norm_t"], h, cfg.norm_eps)
    shifted = state["shift_t"][:, None, :].to(x.dtype)
    r, k, v, g, log_w = _rwkv_mix(p, cfg, x, shifted)
    nh, hd = rwkv6_dims(cfg)
    B = h.shape[0]
    rt = r.reshape(B, nh, hd).float()
    kt = k.reshape(B, nh, hd).float()
    vt = v.reshape(B, nh, hd).float()
    wt = torch.exp(log_w.reshape(B, nh, hd))
    u = p["u_bonus"].float()
    kv = kt[..., :, None] * vt[..., None, :]
    out = torch.einsum("bhk,bhkv->bhv", rt,
                       state["wkv"] + u[None, :, :, None] * kv)
    new_wkv = state["wkv"] * wt[..., None] + kv
    out = out.reshape(B, 1, cfg.d_model).to(h.dtype)
    out = rmsnorm(p["ln_out"], out, cfg.norm_eps) * F.silu(g)
    t_out = out @ p["wo"].to(h.dtype)
    h1 = h + t_out
    xc = rmsnorm(p["norm_c"], h1, cfg.norm_eps)
    shifted_c = state["shift_c"][:, None, :].to(xc.dtype)
    mu = p["mu_c"].to(xc.dtype)
    xk = xc + (shifted_c - xc) * mu[0]
    xr = xc + (shifted_c - xc) * mu[1]
    kc = torch.square(torch.relu(xk @ p["wk_c"].to(xc.dtype)))
    kvc = kc @ p["wv_c"].to(xc.dtype)
    rc = torch.sigmoid(xr @ p["wr_c"].to(xc.dtype))
    h2 = h1 + rc * kvc
    new_state = {
        "wkv": new_wkv,
        "shift_t": x[:, -1].float(),
        "shift_c": xc[:, -1].float(),
    }
    # h2 - h, not t_out + rc * kvc: in bf16 the two round differently
    return h2 - h, new_state
