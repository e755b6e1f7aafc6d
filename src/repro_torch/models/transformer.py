"""The composable stack: layer groups over stacked parameters.

Twin of `repro/models/transformer.py`: the block kinds `attn` and `swa`
(dense or MoE feed-forward, with cross-attention to an encoder output in
the encoder-decoder family), `mamba2`, `mamba2_shared` and `rwkv6`, and
the whisper-style encoder.  One `group` = one instance of
cfg.block_pattern; the stack is `n_groups` groups whose parameters (and
cache entries) carry a leading group axis, as in the JAX package, so both
compare leaf for leaf.  Where JAX scans over that axis with `lax.scan`,
the port loops over the group slices (`_groups`; the encoder's stacked
layers likewise).  Shared blocks (zamba2) live outside the
stacked tree (`params["shared"]`) and are applied inside each group.

Three entry points:
  forward(...)              logits for a full sequence (training / prefill)
  prefill_with_cache(...)   forward + KV cache construction
  decode_step(...)          one-token serving step updating the cache
                            (in place: attention slots and SSM states)
"""
from __future__ import annotations

import functools
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt

from repro_torch.distributed.sharding import shard_act
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamSpec, tree_map

ATTN_KINDS = ("attn", "swa")
REMAT = ("none", "full", "dots")


# ----------------------------------------------------------------------
# templates
# ----------------------------------------------------------------------
def layer_template(cfg: ModelConfig, kind: str) -> dict:
    if kind in ATTN_KINDS:
        t = {"attn": L.attention_template(cfg)}
        if cfg.encoder is not None:
            t["xattn"] = L.attention_template(cfg, cross=True)
        t["ffn"] = L.moe_template(cfg) if cfg.moe else L.mlp_template(cfg)
        return t
    if kind in ("mamba2", "mamba2_shared"):
        return {"mamba": SSM.mamba2_template(cfg)}  # shared attn is global
    if kind == "rwkv6":
        return {"rwkv": SSM.rwkv6_template(cfg)}
    raise ValueError(kind)


def group_template(cfg: ModelConfig) -> dict:
    return {
        f"{i}:{kind}": layer_template(cfg, kind)
        for i, kind in enumerate(cfg.block_pattern)
    }


def _stack_specs(t, n: int):
    return tree_map(
        lambda s: ParamSpec((n,) + s.shape, ("layer",) + s.axes, s.init,
                            s.scale), t)


def encoder_template(cfg: ModelConfig) -> dict:
    e = cfg.encoder
    layer = {
        "attn": L.attention_template(cfg),
        "ffn": L.mlp_template(cfg),
    }
    return {
        "frontend": ParamSpec((e.d_input, cfg.d_model), (None, "embed"),
                              init="scaled"),
        "pos": ParamSpec((e.max_len, cfg.d_model), (None, "embed")),
        "layers": _stack_specs(layer, e.n_layers),
        "final_norm": L.rmsnorm_template(cfg.d_model),
    }


def model_template(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    t: dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab_padded, d), ("vocab", "embed")),
        "groups": _stack_specs(group_template(cfg), cfg.n_groups),
        "final_norm": L.rmsnorm_template(d),
    }
    if not cfg.tie_embeddings:
        t["lm_head"] = ParamSpec((d, cfg.vocab_padded), ("embed", "vocab"),
                                 init="scaled")
    if "mamba2_shared" in cfg.block_pattern:
        t["shared"] = {
            "attn": L.attention_template(cfg),
            "ffn": L.mlp_template(cfg),
        }
    if cfg.encoder is not None:
        t["encoder"] = encoder_template(cfg)
    return t


def _layer_window_theta(cfg: ModelConfig, kind: str) -> tuple[int, float]:
    window = cfg.window if kind == "swa" else 0
    theta = cfg.rope_theta if kind == "attn" else getattr(
        cfg, "rope_theta_local", cfg.rope_theta)
    return window, theta


def _groups(tree, n: int) -> list:
    """The `n` group slices of a stacked parameter or cache tree (views).
    One `unbind` a leaf: its backward stacks the slices' gradients in one
    pass, where indexing each slice would add `n` full-size gradients."""
    parts = tree_map(lambda x: x.unbind(0), tree)
    return [tree_map(lambda xs, g=g: xs[g], parts) for g in range(n)]


def _embed_in(cfg: ModelConfig, params, tokens=None, embeds=None):
    if embeds is None:
        # one op whose DTensor rule splits the table by vocab (its
        # gradient an embedding backward, not an indexed scatter)
        embeds = F.embedding(tokens, params["embed"])
        embeds = embeds * L._sqrt_as(cfg.d_model, embeds.dtype)
    return shard_act(embeds, ("batch", "seq", "embed"))


def _unembed(cfg: ModelConfig, params, h):
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = h @ head.to(h.dtype)
    if cfg.vocab_padded != cfg.vocab:
        pad_mask = torch.arange(cfg.vocab_padded, device=h.device) < cfg.vocab
        logits = torch.where(pad_mask, logits, L.NEG_INF)
    return shard_act(logits, ("batch", "seq", "vocab"))


def _positions(cfg: ModelConfig, B: int, Sq: int, device) -> torch.Tensor:
    positions = torch.arange(Sq, dtype=torch.int32, device=device).expand(B, Sq)
    if cfg.mrope:
        positions = positions[..., None].expand(B, Sq, 3)
    return positions


def _apply_layer_train(cfg: ModelConfig, kind: str, p, h, positions,
                       shared=None, enc_out=None):
    if kind in ATTN_KINDS:
        window, theta = _layer_window_theta(cfg, kind)
        h = h + L.attention_train(p["attn"], cfg, h, positions,
                                  window=window, theta=theta)
        h = shard_act(h, ("batch", "seq", "embed"))
        if enc_out is not None and "xattn" in p:
            h = h + L.attention_train(p["xattn"], cfg, h, positions,
                                      kv_src=enc_out, causal=False)
        ffn = L.moe if cfg.moe else L.mlp
        return shard_act(h + ffn(p["ffn"], cfg, h), ("batch", "seq", "embed"))
    if kind in ("mamba2", "mamba2_shared"):
        h = h + SSM.mamba2_train(p["mamba"], cfg, h)
        h = shard_act(h, ("batch", "seq", "embed"))
        if kind == "mamba2_shared":
            h = h + L.attention_train(shared["attn"], cfg, h, positions)
            h = h + L.mlp(shared["ffn"], cfg, h)
            h = shard_act(h, ("batch", "seq", "embed"))
        return h
    if kind == "rwkv6":
        t_out, _, _ = SSM.rwkv6_time_mix_train(p["rwkv"], cfg, h)
        h = h + t_out
        c_out, _ = SSM.rwkv6_channel_mix(p["rwkv"], cfg, h)
        return shard_act(h + c_out, ("batch", "seq", "embed"))
    raise ValueError(kind)


def encode(cfg: ModelConfig, params, frames):
    """Whisper-style encoder over stub frame embeddings (B,T,d_input):
    the frontend in the frames' dtype, learned positions, then each
    stacked layer's non-causal (dense) self-attention and MLP."""
    e = params["encoder"]
    h = frames @ e["frontend"].to(frames.dtype)
    h = h + e["pos"][: h.shape[1]].to(h.dtype)
    h = shard_act(h, ("batch", "seq", "embed"))
    positions = torch.arange(h.shape[1], dtype=torch.int32,
                             device=h.device).expand(h.shape[:2])
    for lp in _groups(e["layers"], cfg.encoder.n_layers):
        h = h + L.attention_train(lp["attn"], cfg, h, positions, causal=False)
        h = shard_act(h + L.mlp(lp["ffn"], cfg, h), ("batch", "seq", "embed"))
    return L.rmsnorm(e["final_norm"], h, cfg.norm_eps)


def _saved_dots(ctx, op, *args, **kwargs):
    """The `remat="dots"` policy, JAX's `dots_with_no_batch_dims_saveable`:
    keep the outputs of matrix products without batch dimensions (the
    projections, `aten.mm` / `aten.addmm`) and recompute the rest."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(body, remat: str):
    """`body` checkpointed per group as `remat` says: "none" saves every
    activation, "full" recomputes the group in the backward pass, "dots"
    recomputes all but the saved matrix products."""
    if remat == "none":
        return body
    if remat == "full":
        return functools.partial(_ckpt.checkpoint, body, use_reentrant=False)
    if remat == "dots":
        return functools.partial(
            _ckpt.checkpoint, body, use_reentrant=False,
            context_fn=functools.partial(
                _ckpt.create_selective_checkpoint_contexts, _saved_dots))
    raise ValueError(f"remat must be one of {REMAT}, got {remat!r}")


def forward(cfg: ModelConfig, params, tokens=None, embeds=None,
            positions=None, enc_frames=None, remat: str = "none"):
    """Full-sequence logits.  remat: none|full|dots (checkpoint each
    group)."""
    h = _embed_in(cfg, params, tokens, embeds)
    B, Sq = h.shape[:2]
    if positions is None:
        positions = _positions(cfg, B, Sq, h.device)
    enc_out = encode(cfg, params, enc_frames) if enc_frames is not None else None
    shared = params.get("shared")

    def group_body(x, gp):
        for i, kind in enumerate(cfg.block_pattern):
            x = _apply_layer_train(cfg, kind, gp[f"{i}:{kind}"], x, positions,
                                   shared=shared, enc_out=enc_out)
        return x

    body = _remat(group_body, remat)
    for gp in _groups(params["groups"], cfg.n_groups):
        h = body(h, gp)
    return _unembed(cfg, params, h)


def _apply_layer_prefill(cfg: ModelConfig, kind: str, p, h, positions,
                         cache_len: int, shared=None, enc_out=None):
    """Like _apply_layer_train but also emits the decode-ready cache
    entry for this layer (keys match _layer_cache_template)."""
    if kind in ATTN_KINDS:
        window, theta = _layer_window_theta(cfg, kind)
        att, (k, v) = L.attention_train(p["attn"], cfg, h, positions,
                                        window=window, theta=theta,
                                        return_kv=True)
        h = h + att
        ck, cv = L.kv_into_cache(k, v, cache_len, window)
        entry = {"k": ck, "v": cv}
        if enc_out is not None and "xattn" in p:
            h = h + L.attention_train(p["xattn"], cfg, h, positions,
                                      kv_src=enc_out, causal=False)
            # cross-attention KV is computed once from the encoder output
            kv_in = L.rmsnorm(p["xattn"]["norm"], enc_out, cfg.norm_eps)
            xk = L._mm(kv_in, p["xattn"]["wk"].to(h.dtype))
            xv = L._mm(kv_in, p["xattn"]["wv"].to(h.dtype))
            B, T = xk.shape[:2]
            entry["xk"] = xk.reshape(B, T, cfg.n_kv_heads, cfg.hd).to(
                torch.bfloat16)
            entry["xv"] = xv.reshape(B, T, cfg.n_kv_heads, cfg.hd).to(
                torch.bfloat16)
        ffn = L.moe if cfg.moe else L.mlp
        h = h + ffn(p["ffn"], cfg, h)
        return h, entry
    if kind in ("mamba2", "mamba2_shared"):
        out, state = SSM.mamba2_train(p["mamba"], cfg, h, return_state=True)
        h = h + out
        entry = dict(state)
        if kind == "mamba2_shared":
            att, (k, v) = L.attention_train(shared["attn"], cfg, h, positions,
                                            return_kv=True)
            h = h + att
            h = h + L.mlp(shared["ffn"], cfg, h)
            entry["shared_k"], entry["shared_v"] = L.kv_into_cache(
                k, v, cache_len, 0)
        return h, entry
    if kind == "rwkv6":
        t_out, x_last_t, wkv = SSM.rwkv6_time_mix_train(p["rwkv"], cfg, h)
        h = h + t_out
        c_out, x_last_c = SSM.rwkv6_channel_mix(p["rwkv"], cfg, h)
        h = h + c_out
        return h, {"wkv": wkv, "shift_t": x_last_t.float(),
                   "shift_c": x_last_c.float()}
    raise ValueError(kind)


def prefill_with_cache(cfg: ModelConfig, params, tokens=None, embeds=None,
                       positions=None, enc_frames=None, cache_len: int = 0):
    """Forward pass that ALSO builds the decode cache (the production
    prefill->decode handoff).  Returns (logits, cache), every cache leaf
    stacked over the groups."""
    h = _embed_in(cfg, params, tokens, embeds)
    B, Sq = h.shape[:2]
    if cache_len < Sq:
        raise ValueError(f"cache_len {cache_len} must hold the prefill "
                         f"({Sq} positions)")
    if positions is None:
        positions = _positions(cfg, B, Sq, h.device)
    enc_out = encode(cfg, params, enc_frames) if enc_frames is not None else None
    shared = params.get("shared")
    entries: list[dict] = []
    for gp in _groups(params["groups"], cfg.n_groups):
        ge = {}
        for i, kind in enumerate(cfg.block_pattern):
            key = f"{i}:{kind}"
            h, ge[key] = _apply_layer_prefill(cfg, kind, gp[key], h,
                                              positions, cache_len,
                                              shared=shared, enc_out=enc_out)
        entries.append(ge)
    cache = tree_map(lambda *xs: torch.stack(xs), *entries)
    return _unembed(cfg, params, h), cache


# ----------------------------------------------------------------------
# serving: cache templates, decode
# ----------------------------------------------------------------------
def _layer_cache_template(cfg: ModelConfig, kind: str, batch: int,
                          cache_len: int, enc_len: int = 0) -> dict:
    kv_shape = (batch, cache_len, cfg.n_kv_heads, cfg.hd)
    if kind in ATTN_KINDS:
        if kind == "swa" and cfg.window:
            kv_shape = (batch, min(cfg.window, cache_len), cfg.n_kv_heads,
                        cfg.hd)
        t = {"k": (kv_shape, torch.bfloat16),
             "v": (kv_shape, torch.bfloat16)}
        if cfg.encoder is not None:
            x_shape = (batch, enc_len, cfg.n_kv_heads, cfg.hd)
            t["xk"] = (x_shape, torch.bfloat16)
            t["xv"] = (x_shape, torch.bfloat16)
        return t
    if kind == "mamba2":
        return SSM.mamba2_state_template(cfg, batch)
    if kind == "mamba2_shared":
        return {**SSM.mamba2_state_template(cfg, batch),
                "shared_k": (kv_shape, torch.bfloat16),
                "shared_v": (kv_shape, torch.bfloat16)}
    if kind == "rwkv6":
        return SSM.rwkv6_state_template(cfg, batch)
    raise ValueError(kind)


def cache_template(cfg: ModelConfig, batch: int, cache_len: int,
                   enc_len: int = 0) -> dict:
    """`{layer key: {name: (shape, dtype)}}`, each shape led by the group
    axis, as `repro.models.transformer.cache_template` gives them;
    `enc_len` encoder positions in the cross-attention cache of an
    encoder-decoder."""
    return {
        f"{i}:{kind}": {
            name: ((cfg.n_groups,) + shape, dtype)
            for name, (shape, dtype) in _layer_cache_template(
                cfg, kind, batch, cache_len, enc_len).items()}
        for i, kind in enumerate(cfg.block_pattern)
    }


def cache_logical_axes(cfg: ModelConfig) -> dict:
    """Logical axes parallel to `cache_template` (for the dry-run's
    shardings), as `repro.models.transformer.cache_logical_axes`."""
    def axes_for(name: str, ndim: int):
        if name in ("k", "v", "xk", "xv", "shared_k", "shared_v"):
            return ("layer", "batch", "seq_cache", "kv_heads", None)
        if name in ("wkv", "ssm"):
            return ("layer", "batch", "kv_heads", None, "state_feat")
        if name == "conv":
            return ("layer", "batch", None, "mlp")
        if name in ("shift_t", "shift_c"):
            return ("layer", "batch", "embed")
        return ("layer",) + (None,) * (ndim - 1)

    return {lk: {name: axes_for(name, len(shape))
                 for name, (shape, _) in entries.items()}
            for lk, entries in cache_template(cfg, 1, 2).items()}


def _write(cache: dict, new: dict) -> None:
    """Copy each new state tensor into the cache's tensor of that name
    (the caller's view into the stacked cache)."""
    for name, x in new.items():
        cache[name].copy_(x)


def _apply_layer_decode(cfg: ModelConfig, kind: str, p, h, pos: int, cache,
                        shared=None):
    """One layer's decode; every cache entry of the layer is written in
    place, where JAX returns a new one."""
    if kind in ATTN_KINDS:
        window, theta = _layer_window_theta(cfg, kind)
        att, _ = L.attention_decode(p["attn"], cfg, h, pos, cache,
                                    window=window, theta=theta)
        h = h + att
        if cfg.encoder is not None and "xattn" in p:
            # cross attention against the prefilled encoder KV (read only)
            y = L.rmsnorm(p["xattn"]["norm"], h, cfg.norm_eps)
            q = y @ p["xattn"]["wq"].to(h.dtype)
            q = q.reshape(h.shape[0], 1, cfg.n_heads, cfg.hd)
            scores = L._gqa_scores(q, cache["xk"].to(h.dtype))
            probs = torch.softmax(scores.float(), dim=-1).to(h.dtype)
            out = L._gqa_out(probs, cache["xv"].to(h.dtype))
            h = h + out @ p["xattn"]["wo"].to(h.dtype)
        ffn = L.moe if cfg.moe else L.mlp
        return h + ffn(p["ffn"], cfg, h)
    if kind in ("mamba2", "mamba2_shared"):
        out, new_state = SSM.mamba2_decode(
            p["mamba"], cfg, h, {"ssm": cache["ssm"], "conv": cache["conv"]})
        _write(cache, new_state)
        h = h + out
        if kind == "mamba2_shared":
            att, _ = L.attention_decode(
                shared["attn"], cfg, h, pos,
                {"k": cache["shared_k"], "v": cache["shared_v"]})
            h = h + att
            h = h + L.mlp(shared["ffn"], cfg, h)
        return h
    if kind == "rwkv6":
        delta, new_state = SSM.rwkv6_decode(p["rwkv"], cfg, h, cache)
        _write(cache, new_state)
        return h + delta
    raise ValueError(kind)


def decode_step(cfg: ModelConfig, params, token, pos: int, cache):
    """One serving step: token (B,1) int, pos a host int, cache tree with
    leading n_groups dim on every leaf.  Returns (logits, cache); the
    cache is updated in place (slot `pos` of every attention layer, the
    state of every SSM layer)."""
    h = _embed_in(cfg, params, token)
    shared = params.get("shared")
    for gp, gc in zip(_groups(params["groups"], cfg.n_groups),
                      _groups(cache, cfg.n_groups)):
        for i, kind in enumerate(cfg.block_pattern):
            key = f"{i}:{kind}"
            h = _apply_layer_decode(cfg, kind, gp[key], h, pos, gc[key],
                                    shared=shared)
    return _unembed(cfg, params, h), cache
