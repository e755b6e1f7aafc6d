"""Model configuration: a copy of `repro/models/config.py` (pure
dataclasses), one composable decoder framework, ten architectures.

`block_pattern` describes one *layer group*; the stack is
`n_groups = n_layers / len(block_pattern)` groups over stacked group
parameters (the JAX package scans them with `lax.scan`, the port loops
over the group axis).  Block types:

  attn          global causal attention (GQA)
  swa           sliding-window causal attention (window=cfg.window)
  mamba2        Mamba2 SSD block (chunked scan)
  rwkv6         RWKV6 (Finch) time-mix + channel-mix
  mamba2_shared mamba2 block followed by the SHARED attention block
                (zamba2: one weight copy applied at every occurrence)

The port runs every block kind, and the encoder-decoder (`encoder` set:
whisper).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    n_shared_experts: int = 0  # always-active experts (llama4-style)


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64       # mamba2 N
    head_dim: int = 64        # mamba2 P / rwkv6 head size
    n_heads: int = 0          # 0 -> derived: d_inner // head_dim
    expand: int = 2           # d_inner = expand * d_model
    d_conv: int = 4           # mamba2 depthwise conv window
    chunk: int = 64           # chunked-scan block length


@dataclass(frozen=True)
class EncoderConfig:
    n_layers: int = 6
    d_input: int = 80         # mel bins (stub frontend projects to d_model)
    max_len: int = 1500


@dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                      # 0 -> d_model // n_heads
    block_pattern: tuple[str, ...] = ("attn",)
    window: int = 0                        # swa window
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    encoder: EncoderConfig | None = None   # enc-dec (whisper)
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    rope_theta_local: float = 10_000.0  # swa layers (gemma3: 10k vs 1M)
    mrope: bool = False                    # 3-section M-RoPE (qwen2-vl)
    mrope_sections: tuple[int, int, int] = (16, 24, 24)
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    max_seq: int = 8192                    # serving cache default
    attn_impl: str = "dense"               # dense | chunked (flash-style
                                           # online softmax, O(S*C) memory)
    attn_chunk: int = 1024                 # kv/q chunk for attn_impl=chunked
    # which families support >=500k decode (sub-quadratic / windowed)
    long_context: bool = False
    notes: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 128 so the embedding /
        lm_head shard evenly on any production mesh axis; padded logit
        columns are masked to -inf (standard vocab padding)."""
        return -(-self.vocab // 128) * 128

    @property
    def n_groups(self) -> int:
        assert self.n_layers % len(self.block_pattern) == 0, (
            self.name, self.n_layers, self.block_pattern)
        return self.n_layers // len(self.block_pattern)

    def param_count(self) -> int:
        """Analytic parameter count (drives MODEL_FLOPS in the roofline)."""
        d, hd = self.d_model, self.hd
        n_q = self.n_heads * hd
        n_kv = self.n_kv_heads * hd
        per_type: dict[str, int] = {}
        attn = d * n_q + 2 * d * n_kv + n_q * d
        if self.qkv_bias:
            attn += n_q + 2 * n_kv
        if self.moe is not None:
            ff = self.moe.n_experts * 3 * d * self.d_ff + d * self.moe.n_experts
            ff += self.moe.n_shared_experts * 3 * d * self.d_ff
        else:
            ff = 3 * d * self.d_ff
        per_type["attn"] = attn + ff + 2 * d
        per_type["swa"] = per_type["attn"]
        if self.ssm is not None:
            s = self.ssm
            d_in = s.expand * d
            nh = s.n_heads or d_in // s.head_dim
            conv_dim = d_in + 2 * s.state_dim
            # mamba2: in_proj (z,x,B,C,dt) + conv(w,b) + A/dt/D + norms + out
            per_type["mamba2"] = (
                d * (2 * d_in + 2 * s.state_dim + nh)
                + (s.d_conv + 1) * conv_dim + 3 * nh + d_in + d + d_in * d
            )
            per_type["mamba2_shared"] = per_type["mamba2"]
        if "rwkv6" in self.block_pattern:
            # time-mix (r,k,v,g,o + decay lora) + relu^2 channel-mix
            per_type["rwkv6"] = 6 * d * d + 2 * d * 64 + 2 * d * self.d_ff + 12 * d
        total = 0
        for b in self.block_pattern:
            total += per_type[b]
        total *= self.n_groups
        if "mamba2_shared" in self.block_pattern:
            total += per_type["attn"]  # one shared attention+mlp block
        total += self.vocab_padded * d  # embedding
        if not self.tie_embeddings:
            total += self.vocab_padded * d
        if self.encoder is not None:
            e = self.encoder
            total += e.n_layers * (4 * d * d + 3 * d * self.d_ff + 2 * d)
            total += e.d_input * d + e.max_len * d  # frontend stub + positions
            # decoder cross-attention (added per decoder layer)
            total += self.n_layers * (4 * d * d + d)
        return int(total)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only top-k experts)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        full_ff = self.moe.n_experts * 3 * d * self.d_ff
        active_ff = (self.moe.top_k + self.moe.n_shared_experts) * 3 * d * self.d_ff
        return int(self.param_count() - self.n_layers * (full_ff - active_ff))
