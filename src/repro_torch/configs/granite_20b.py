"""granite-20b [dense]: 52L d=6144 48H (MQA kv=1) d_ff=24576 vocab=49152,
llama-arch, code model.  [arXiv:2405.04324; hf]
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-20b",
        n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1,
        d_ff=24576, vocab=49152, head_dim=128,
        notes="multi-query attention (single KV head)",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-20b-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
        d_ff=128, vocab=128, head_dim=16,
    )
