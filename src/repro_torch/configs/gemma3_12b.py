"""gemma3-12b [dense]: 48L d=3840 16H (GQA kv=8) d_ff=15360 vocab=262144,
5:1 local:global attention, 128k context, head_dim=256.
[hf:google/gemma-3-1b-pt; unverified]
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b",
        n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8,
        d_ff=15360, vocab=262144, head_dim=256,
        block_pattern=("swa", "swa", "swa", "swa", "swa", "attn"),
        window=1024,
        rope_theta=1_000_000.0, rope_theta_local=10_000.0,
        tie_embeddings=True,
        long_context=True,  # windowed KV for 5/6 layers => 500k decode runs
        notes="5 sliding-window layers per global layer; window=1024",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-smoke",
        n_layers=6, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=128, head_dim=16,
        block_pattern=("swa", "swa", "swa", "swa", "swa", "attn"),
        window=8, tie_embeddings=True, long_context=True,
    )
