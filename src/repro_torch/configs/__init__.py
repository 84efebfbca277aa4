"""Model registry of the port (counterpart of ``repro.configs``).

Each module defines ``CONFIG`` with the published dimensions.  The dense,
SSM and hybrid families are ported, and with them ``llama3-8b``,
``mamba2-2.7b`` and ``zamba2-7b``; the other architectures come with their
families.
"""

from __future__ import annotations

import importlib

from ..models.config import ModelConfig, reduced

ALIASES = {
    "llama3-8b": "llama3_8b",
    "mamba2-2.7b": "mamba2_2_7b",
    "zamba2-7b": "zamba2_7b",
}


def get_config(name: str) -> ModelConfig:
    mod_name = ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    if mod_name not in ALIASES.values():
        raise KeyError(f"no port configuration {name!r}; ported: {list(ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG


def get_reduced(name: str, **overrides) -> ModelConfig:
    return reduced(get_config(name), **overrides)

