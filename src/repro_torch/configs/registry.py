"""Architecture registry: --arch <id> -> ModelConfig."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "dbrx-132b": "dbrx_132b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
    "rwkv6-7b": "rwkv6_7b",
    "command-r-35b": "command_r_35b",
    "qwen3-14b": "qwen3_14b",
    "qwen2.5-14b": "qwen2_5_14b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "musicgen-medium": "musicgen_medium",
    "zamba2-2.7b": "zamba2_2_7b",
}

ARCHS = list(_MODULES)


def get(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG
