"""whisper-base [audio]: 6L enc + 6L dec, d=512 8H d_ff=2048 vocab=51865,
encoder-decoder with conv frontend STUB (input_specs provide precomputed
frame embeddings).  [arXiv:2212.04356; unverified]

Adaptation note: whisper uses LayerNorm + learned positions; this
framework uses RMSNorm + RoPE for the decoder self-attention and learned
positions in the encoder — recorded in DESIGN.md.
"""
from repro_torch.models.config import EncoderConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base",
        n_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
        d_ff=2048, vocab=51865,
        encoder=EncoderConfig(n_layers=6, d_input=80, max_len=1536),
        notes="enc-dec; conv frontend stubbed to frame embeddings",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=128,
        encoder=EncoderConfig(n_layers=2, d_input=16, max_len=64),
    )
