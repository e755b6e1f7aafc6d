"""llama4-maverick-400b-a17b [moe]: 48L d=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 128 experts top-1 + one shared expert, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
"""
from repro_torch.models.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=8192, vocab=202048, head_dim=128,
        moe=MoEConfig(n_experts=128, top_k=1, n_shared_experts=1),
        rope_theta=500_000.0,
        notes=("top-1 routed + always-on shared expert (llama4); early "
               "fusion = text+image tokens share the backbone (vision "
               "frontend stubbed per assignment)"),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=64, vocab=128, head_dim=16,
        moe=MoEConfig(n_experts=4, top_k=1, n_shared_experts=1, capacity_factor=4.0),
        rope_theta=500_000.0,
    )
