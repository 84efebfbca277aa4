# Serving of the port: the LM serving engine (continuous batching over
# decode_step), the search service over a persistent batched async engine
# (its fused device ring by default), and the shared admission path.
from .admission import PromptTooLongError, pack_prompts, validate_prompts
from .engine import ServeConfig, ServingEngine
from .search_service import InvalidSearchActionError, SearchService, ServeStats

__all__ = [
    "InvalidSearchActionError",
    "PromptTooLongError",
    "SearchService",
    "ServeConfig",
    "ServeStats",
    "ServingEngine",
    "pack_prompts",
    "validate_prompts",
]
