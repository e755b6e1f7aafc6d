"""The composable stack: layer groups over stacked parameters.

Twin of `repro/models/transformer.py` for the decoder-only families: the
block kinds `attn` and `swa` (dense or MoE feed-forward), `mamba2`,
`mamba2_shared` and `rwkv6`.  One `group` = one instance of
cfg.block_pattern; the stack is `n_groups` groups whose parameters (and
cache entries) carry a leading group axis, as in the JAX package, so both
compare leaf for leaf.  Where JAX scans over that axis with `lax.scan`,
the port loops over it and indexes the stacked tensors.  Shared blocks
(zamba2) live outside the stacked tree (`params["shared"]`) and are
applied inside each group.  The encoder-decoder (whisper) is not ported
yet (ROADMAP A11).

Three entry points:
  forward(...)              logits for a full sequence (prefill)
  prefill_with_cache(...)   forward + KV cache construction
  decode_step(...)          one-token serving step updating the cache
                            (in place: attention slots and SSM states)
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamSpec, tree_map

ATTN_KINDS = ("attn", "swa")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP A11)")


# ----------------------------------------------------------------------
# templates
# ----------------------------------------------------------------------
def layer_template(cfg: ModelConfig, kind: str) -> dict:
    if kind in ATTN_KINDS:
        if cfg.encoder is not None:
            raise _not_ported("the encoder-decoder (cross-attention) block")
        return {"attn": L.attention_template(cfg),
                "ffn": L.moe_template(cfg) if cfg.moe else L.mlp_template(cfg)}
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
    return t


def _layer_window_theta(cfg: ModelConfig, kind: str) -> tuple[int, float]:
    window = cfg.window if kind == "swa" else 0
    theta = cfg.rope_theta if kind == "attn" else getattr(
        cfg, "rope_theta_local", cfg.rope_theta)
    return window, theta


def _group(tree, g: int):
    """Group `g`'s slice of a stacked parameter or cache tree (views)."""
    return tree_map(lambda x: x[g], tree)


def _embed_in(cfg: ModelConfig, params, tokens=None, embeds=None):
    if embeds is None:
        embeds = params["embed"][tokens]
        embeds = embeds * L._sqrt_as(cfg.d_model, embeds.dtype)
    return embeds


def _unembed(cfg: ModelConfig, params, h):
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = h @ head.to(h.dtype)
    if cfg.vocab_padded != cfg.vocab:
        pad_mask = torch.arange(cfg.vocab_padded, device=h.device) < cfg.vocab
        logits = torch.where(pad_mask, logits, L.NEG_INF)
    return logits


def _positions(cfg: ModelConfig, B: int, Sq: int, device) -> torch.Tensor:
    positions = torch.arange(Sq, dtype=torch.int32, device=device).expand(B, Sq)
    if cfg.mrope:
        positions = positions[..., None].expand(B, Sq, 3)
    return positions


def _apply_layer_train(cfg: ModelConfig, kind: str, p, h, positions,
                       shared=None):
    if kind in ATTN_KINDS:
        window, theta = _layer_window_theta(cfg, kind)
        h = h + L.attention_train(p["attn"], cfg, h, positions,
                                  window=window, theta=theta)
        ffn = L.moe if cfg.moe else L.mlp
        return h + ffn(p["ffn"], cfg, h)
    if kind in ("mamba2", "mamba2_shared"):
        h = h + SSM.mamba2_train(p["mamba"], cfg, h)
        if kind == "mamba2_shared":
            h = h + L.attention_train(shared["attn"], cfg, h, positions)
            h = h + L.mlp(shared["ffn"], cfg, h)
        return h
    if kind == "rwkv6":
        t_out, _, _ = SSM.rwkv6_time_mix_train(p["rwkv"], cfg, h)
        h = h + t_out
        c_out, _ = SSM.rwkv6_channel_mix(p["rwkv"], cfg, h)
        return h + c_out
    raise ValueError(kind)


def forward(cfg: ModelConfig, params, tokens=None, embeds=None,
            positions=None):
    """Full-sequence logits."""
    h = _embed_in(cfg, params, tokens, embeds)
    B, Sq = h.shape[:2]
    if positions is None:
        positions = _positions(cfg, B, Sq, h.device)
    shared = params.get("shared")
    for g in range(cfg.n_groups):
        gp = _group(params["groups"], g)
        for i, kind in enumerate(cfg.block_pattern):
            h = _apply_layer_train(cfg, kind, gp[f"{i}:{kind}"], h, positions,
                                   shared=shared)
    return _unembed(cfg, params, h)


def _apply_layer_prefill(cfg: ModelConfig, kind: str, p, h, positions,
                         cache_len: int, shared=None):
    """Like _apply_layer_train but also emits the decode-ready cache
    entry for this layer (keys match _layer_cache_template)."""
    if kind in ATTN_KINDS:
        window, theta = _layer_window_theta(cfg, kind)
        att, (k, v) = L.attention_train(p["attn"], cfg, h, positions,
                                        window=window, theta=theta,
                                        return_kv=True)
        h = h + att
        ck, cv = L.kv_into_cache(k, v, cache_len, window)
        ffn = L.moe if cfg.moe else L.mlp
        h = h + ffn(p["ffn"], cfg, h)
        return h, {"k": ck, "v": cv}
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
                       positions=None, cache_len: int = 0):
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
    shared = params.get("shared")
    entries: list[dict] = []
    for g in range(cfg.n_groups):
        gp = _group(params["groups"], g)
        ge = {}
        for i, kind in enumerate(cfg.block_pattern):
            key = f"{i}:{kind}"
            h, ge[key] = _apply_layer_prefill(cfg, kind, gp[key], h,
                                              positions, cache_len,
                                              shared=shared)
        entries.append(ge)
    cache = tree_map(lambda *xs: torch.stack(xs), *entries)
    return _unembed(cfg, params, h), cache


# ----------------------------------------------------------------------
# serving: cache templates, decode
# ----------------------------------------------------------------------
def _layer_cache_template(cfg: ModelConfig, kind: str, batch: int,
                          cache_len: int) -> dict:
    kv_shape = (batch, cache_len, cfg.n_kv_heads, cfg.hd)
    if kind in ATTN_KINDS:
        if kind == "swa" and cfg.window:
            kv_shape = (batch, min(cfg.window, cache_len), cfg.n_kv_heads,
                        cfg.hd)
        return {"k": (kv_shape, torch.bfloat16),
                "v": (kv_shape, torch.bfloat16)}
    if kind == "mamba2":
        return SSM.mamba2_state_template(cfg, batch)
    if kind == "mamba2_shared":
        return {**SSM.mamba2_state_template(cfg, batch),
                "shared_k": (kv_shape, torch.bfloat16),
                "shared_v": (kv_shape, torch.bfloat16)}
    if kind == "rwkv6":
        return SSM.rwkv6_state_template(cfg, batch)
    raise ValueError(kind)


def cache_template(cfg: ModelConfig, batch: int, cache_len: int) -> dict:
    """`{layer key: {name: (shape, dtype)}}`, each shape led by the group
    axis, as `repro.models.transformer.cache_template` gives them."""
    return {
        f"{i}:{kind}": {
            name: ((cfg.n_groups,) + shape, dtype)
            for name, (shape, dtype) in _layer_cache_template(
                cfg, kind, batch, cache_len).items()}
        for i, kind in enumerate(cfg.block_pattern)
    }


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
    for g in range(cfg.n_groups):
        gp = _group(params["groups"], g)
        gc = _group(cache, g)
        for i, kind in enumerate(cfg.block_pattern):
            key = f"{i}:{kind}"
            h = _apply_layer_decode(cfg, kind, gp[key], h, pos, gc[key],
                                    shared=shared)
    return _unembed(cfg, params, h), cache
