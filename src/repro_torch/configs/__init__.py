"""Architecture registry (a copy of `repro/configs`): one module per
assigned architecture.

`get_config(name)` -> full published ModelConfig;
`get_smoke_config(name)` -> reduced same-family config for CPU smoke tests.
"""
from __future__ import annotations

import importlib

ARCHS = [
    "granite_moe_1b",
    "llama4_maverick",
    "qwen2_5_32b",
    "deepseek_67b",
    "gemma3_12b",
    "granite_20b",
    "rwkv6_3b",
    "qwen2_vl_2b",
    "whisper_base",
    "zamba2_1_2b",
]

# canonical ids from the assignment -> module names
ALIASES = {
    "granite-moe-1b-a400m": "granite_moe_1b",
    "llama4-maverick-400b-a17b": "llama4_maverick",
    "qwen2.5-32b": "qwen2_5_32b",
    "deepseek-67b": "deepseek_67b",
    "gemma3-12b": "gemma3_12b",
    "granite-20b": "granite_20b",
    "rwkv6-3b": "rwkv6_3b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "whisper-base": "whisper_base",
    "zamba2-1.2b": "zamba2_1_2b",
}


def _module(name: str):
    mod_name = ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_config(name: str):
    return _module(name).config()


def get_smoke_config(name: str):
    return _module(name).smoke_config()


def list_archs() -> list[str]:
    return list(ALIASES)
