"""qwen2-vl-2b [vlm]: 28L d=1536 12H (GQA kv=2) d_ff=8960 vocab=151936,
M-RoPE + dynamic resolution (vision tower stubbed: input_specs provide
precomputed patch embeddings).  [arXiv:2409.12191; hf]
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b",
        n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
        d_ff=8960, vocab=151936, head_dim=128,
        qkv_bias=True, mrope=True, mrope_sections=(16, 24, 24),
        rope_theta=1_000_000.0,
        notes="M-RoPE (t/h/w) backbone; patch-embedding frontend is a stub",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=128, head_dim=16,
        qkv_bias=True, mrope=True, mrope_sections=(2, 3, 3),
    )
