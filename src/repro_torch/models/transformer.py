"""The composable stack: layer groups over stacked parameters.

Twin of `repro/models/transformer.py` for the block kinds `attn` and
`swa`.  One `group` = one instance of cfg.block_pattern; the stack is
`n_groups` groups whose parameters (and cache entries) carry a leading
group axis, as in the JAX package, so both compare leaf for leaf.  Where
JAX scans over that axis with `lax.scan`, the port loops over it and
indexes the stacked tensors.

Three entry points:
  forward(...)              logits for a full sequence (prefill)
  prefill_with_cache(...)   forward + KV cache construction
  decode_step(...)          one-token serving step updating the cache
                            (in place)
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import layers as L
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
        if cfg.moe is not None:
            raise _not_ported("the MoE block")
        return {"attn": L.attention_template(cfg), "ffn": L.mlp_template(cfg)}
    if kind in ("mamba2", "mamba2_shared", "rwkv6"):
        raise _not_ported(f"the {kind} block")
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


def _apply_layer_train(cfg: ModelConfig, kind: str, p, h, positions):
    if kind not in ATTN_KINDS:
        raise _not_ported(f"the {kind} block")
    window, theta = _layer_window_theta(cfg, kind)
    h = h + L.attention_train(p["attn"], cfg, h, positions, window=window,
                              theta=theta)
    ffn = L.moe if cfg.moe else L.mlp
    return h + ffn(p["ffn"], cfg, h)


def forward(cfg: ModelConfig, params, tokens=None, embeds=None,
            positions=None):
    """Full-sequence logits."""
    h = _embed_in(cfg, params, tokens, embeds)
    B, Sq = h.shape[:2]
    if positions is None:
        positions = _positions(cfg, B, Sq, h.device)
    for g in range(cfg.n_groups):
        gp = _group(params["groups"], g)
        for i, kind in enumerate(cfg.block_pattern):
            h = _apply_layer_train(cfg, kind, gp[f"{i}:{kind}"], h, positions)
    return _unembed(cfg, params, h)


def _apply_layer_prefill(cfg: ModelConfig, kind: str, p, h, positions,
                         cache_len: int):
    """Like _apply_layer_train but also emits the decode-ready cache
    entry for this layer (keys match _layer_cache_template)."""
    if kind not in ATTN_KINDS:
        raise _not_ported(f"the {kind} block")
    window, theta = _layer_window_theta(cfg, kind)
    att, (k, v) = L.attention_train(p["attn"], cfg, h, positions,
                                    window=window, theta=theta,
                                    return_kv=True)
    h = h + att
    ck, cv = L.kv_into_cache(k, v, cache_len, window)
    ffn = L.moe if cfg.moe else L.mlp
    h = h + ffn(p["ffn"], cfg, h)
    return h, {"k": ck, "v": cv}


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
    entries: list[dict] = []
    for g in range(cfg.n_groups):
        gp = _group(params["groups"], g)
        ge = {}
        for i, kind in enumerate(cfg.block_pattern):
            key = f"{i}:{kind}"
            h, ge[key] = _apply_layer_prefill(cfg, kind, gp[key], h,
                                              positions, cache_len)
        entries.append(ge)
    cache = tree_map(lambda *xs: torch.stack(xs), *entries)
    return _unembed(cfg, params, h), cache


# ----------------------------------------------------------------------
# serving: cache templates, decode
# ----------------------------------------------------------------------
def _layer_cache_template(cfg: ModelConfig, kind: str, batch: int,
                          cache_len: int) -> dict:
    if kind not in ATTN_KINDS:
        raise _not_ported(f"the {kind} block's cache")
    T = min(cfg.window, cache_len) if kind == "swa" and cfg.window else cache_len
    shape = (batch, T, cfg.n_kv_heads, cfg.hd)
    return {"k": (shape, torch.bfloat16), "v": (shape, torch.bfloat16)}


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


def _apply_layer_decode(cfg: ModelConfig, kind: str, p, h, pos: int, cache):
    if kind not in ATTN_KINDS:
        raise _not_ported(f"the {kind} block")
    window, theta = _layer_window_theta(cfg, kind)
    att, _ = L.attention_decode(p["attn"], cfg, h, pos, cache,
                                window=window, theta=theta)
    h = h + att
    ffn = L.moe if cfg.moe else L.mlp
    return h + ffn(p["ffn"], cfg, h)


def decode_step(cfg: ModelConfig, params, token, pos: int, cache):
    """One serving step: token (B,1) int, pos a host int, cache tree with
    leading n_groups dim on every leaf.  Returns (logits, cache); the
    cache is updated in place (slot `pos` of every layer)."""
    h = _embed_in(cfg, params, token)
    for g in range(cfg.n_groups):
        gp = _group(params["groups"], g)
        gc = _group(cache, g)
        for i, kind in enumerate(cfg.block_pattern):
            key = f"{i}:{kind}"
            h = _apply_layer_decode(cfg, kind, gp[key], h, pos, gc[key])
    return _unembed(cfg, params, h), cache
