"""qwen2.5-32b [dense]: 64L d=5120 40H (GQA kv=8) d_ff=27648 vocab=152064,
QKV bias.  [hf:Qwen/Qwen2.5-0.5B; hf]
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-32b",
        n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=27648, vocab=152064, head_dim=128,
        qkv_bias=True, rope_theta=1_000_000.0,
        notes="dense GQA with QKV bias",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=128, head_dim=16, qkv_bias=True,
    )
