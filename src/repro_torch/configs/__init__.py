"""Model registry of the port (counterpart of ``repro.configs``): the ten
architectures of the reference, each module defining ``CONFIG`` with the
published dimensions; ``reduced()`` variants drive the CPU tests.
"""

from __future__ import annotations

import importlib

from ..models.config import ModelConfig, reduced

ARCHS = [
    "qwen2_moe_a2_7b",
    "qwen3_moe_235b_a22b",
    "llama3_8b",
    "phi3_medium_14b",
    "deepseek_67b",
    "qwen2_5_32b",
    "llava_next_mistral_7b",
    "zamba2_7b",
    "mamba2_2_7b",
    "whisper_small",
]

# Architecture names (with dashes and dots) -> module names.
ALIASES = {
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "llama3-8b": "llama3_8b",
    "phi3-medium-14b": "phi3_medium_14b",
    "deepseek-67b": "deepseek_67b",
    "qwen2.5-32b": "qwen2_5_32b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "zamba2-7b": "zamba2_7b",
    "mamba2-2.7b": "mamba2_2_7b",
    "whisper-small": "whisper_small",
}


def get_config(name: str) -> ModelConfig:
    mod_name = ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    if mod_name not in ARCHS:
        raise KeyError(f"no configuration {name!r}; known: {list(ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG


def get_reduced(name: str, **overrides) -> ModelConfig:
    return reduced(get_config(name), **overrides)


def list_archs() -> list[str]:
    return list(ALIASES.keys())
