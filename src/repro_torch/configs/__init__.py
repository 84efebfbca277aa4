"""Model registry of the port (counterpart of ``repro.configs``).

Each module defines ``CONFIG`` with the published dimensions.  Only the
dense family is ported, and with it ``llama3-8b``; the other
architectures come with their families.
"""

from __future__ import annotations

import importlib

from ..models.config import ModelConfig, reduced

ALIASES = {
    "llama3-8b": "llama3_8b",
}


def get_config(name: str) -> ModelConfig:
    mod_name = ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    if mod_name not in ALIASES.values():
        raise KeyError(f"no port configuration {name!r}; ported: {list(ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG


def get_reduced(name: str, **overrides) -> ModelConfig:
    return reduced(get_config(name), **overrides)

