from .config import ModelConfig, reduced
from .lm import (
    CALLS,
    KV_CACHE_FAMILIES,
    decode_chunk,
    decode_step,
    forward,
    init_cache,
    init_params,
    logits_at,
    prefill_ragged,
    reset_calls,
)

__all__ = [
    "CALLS",
    "KV_CACHE_FAMILIES",
    "ModelConfig",
    "decode_chunk",
    "decode_step",
    "forward",
    "init_cache",
    "init_params",
    "logits_at",
    "prefill_ragged",
    "reduced",
    "reset_calls",
]
