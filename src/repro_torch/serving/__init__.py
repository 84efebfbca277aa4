# Search serving of the port: the host-paced SearchService over a persistent
# batched async engine, and the shared admission path.  LM serving
# (ServingEngine, ServeConfig) is not ported yet (ROADMAP.md §1, item 5).
from .admission import PromptTooLongError, pack_prompts, validate_prompts
from .search_service import InvalidSearchActionError, SearchService, ServeStats

__all__ = [
    "InvalidSearchActionError",
    "PromptTooLongError",
    "SearchService",
    "ServeStats",
    "pack_prompts",
    "validate_prompts",
]
