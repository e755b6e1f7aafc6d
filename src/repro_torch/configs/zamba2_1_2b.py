"""zamba2-1.2b [hybrid]: 38L d=2048 32H (kv=32) d_ff=8192 ssm_state=64,
Mamba2 blocks + ONE shared attention block applied every second block.
[arXiv:2411.15242; hf]
"""
from repro_torch.models.config import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b",
        n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab=32000, head_dim=64,
        block_pattern=("mamba2", "mamba2_shared"),
        ssm=SSMConfig(state_dim=64, head_dim=64, expand=2),
        long_context=True,  # constant SSM state; shared attn is 1-in-2
        notes=("19 groups of (mamba2, mamba2+shared-attn); the attention "
               "block weights are shared across all 19 applications"),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=128, head_dim=16,
        block_pattern=("mamba2", "mamba2_shared"),
        ssm=SSMConfig(state_dim=8, head_dim=16, expand=2, chunk=8),
        long_context=True,
    )
