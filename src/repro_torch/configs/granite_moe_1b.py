"""granite-moe-1b-a400m [moe]: 24L d=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""
from repro_torch.models.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
        d_ff=512, vocab=49155,
        moe=MoEConfig(n_experts=32, top_k=8),
        tie_embeddings=True,
        notes="granite 3.0 MoE; per-expert d_ff=512, top-8 routing",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=32, vocab=128,
        moe=MoEConfig(n_experts=4, top_k=2, capacity_factor=4.0),
        tie_embeddings=True,
    )
