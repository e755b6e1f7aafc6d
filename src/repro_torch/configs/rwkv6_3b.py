"""rwkv6-3b (Finch) [ssm]: 32L d=2560 attention-free d_ff=8960 vocab=65536,
data-dependent per-channel decay.  [arXiv:2404.05892; hf]
"""
from repro_torch.models.config import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b",
        n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,
        d_ff=8960, vocab=65536,
        block_pattern=("rwkv6",),
        ssm=SSMConfig(head_dim=64),
        long_context=True,  # O(1) recurrent state
        notes="RWKV6 Finch: time-mix WKV recurrence + relu^2 channel-mix",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=128,
        block_pattern=("rwkv6",),
        ssm=SSMConfig(head_dim=16),
        long_context=True,
    )
