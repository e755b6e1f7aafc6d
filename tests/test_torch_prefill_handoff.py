"""Prefill -> decode cache handoff on the port: prefill S0 tokens, then
teacher-forced decode must reproduce the parallel forward's logits at
every continued position, for every cache family (full KV,
rolling-window KV, SSM state, WKV state, shared-attention hybrid, MoE,
M-RoPE, and the encoder-decoder's cross-attention cache).  The twin of
`tests/test_prefill_handoff.py`, with its shapes, its encoder frames
and its tolerance (3e-2: the attention cache is bf16).  The MoE
smoke configs' capacity factor (4.0) is at least n_experts / top_k, so
the capacity holds every (token, expert) pair in the forward, the
prefill and each decode step alike.  Parameters are the port's own,
drawn from a seeded `torch.Generator`."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

ARCHS = ["qwen2.5-32b", "gemma3-12b", "rwkv6-3b", "zamba2-1.2b",
         "granite-moe-1b-a400m", "whisper-base", "qwen2-vl-2b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_forward(arch):
    cfg = get_smoke_config(arch)
    if cfg.moe is not None:
        assert cfg.moe.capacity_factor >= cfg.moe.n_experts / cfg.moe.top_k
    model = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    B, S0, S1 = 1, 8, 12  # prefill 8, decode 4 more
    if cfg.ssm is not None:
        # full-sequence reference + prefill both need chunk-divisible seqs
        S0 = max(S0, cfg.ssm.chunk)
        S1 = 2 * S0
    cache_len = S1 + 4
    rng = np.random.default_rng(7)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab, size=(B, S1)).astype(np.int32))
    kw = {}
    if cfg.encoder is not None:
        kw["enc_frames"] = torch.from_numpy(
            rng.normal(size=(B, 8, cfg.encoder.d_input)).astype(np.float32))

    ref = model.forward(tokens=tokens, **kw)

    logits0, cache = model.prefill_with_cache(tokens=tokens[:, :S0],
                                              cache_len=cache_len, **kw)
    np.testing.assert_allclose(logits0.numpy(), ref[:, :S0].numpy(),
                               rtol=3e-2, atol=3e-2)

    for t in range(S0, S1):
        logits, cache = model.decode_step(tokens[:, t: t + 1], t, cache)
        np.testing.assert_allclose(
            logits[:, 0].numpy(), ref[:, t].numpy(), rtol=3e-2, atol=3e-2,
            err_msg=f"{arch}: divergence at position {t}")
