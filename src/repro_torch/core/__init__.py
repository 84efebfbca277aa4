# The WU-UCT engines of the port (wave and async); describe a search with
# `SearchSpec` and build it with `build_searcher(env, spec)`.
from .api import SearchSpec, as_search_config, build_searcher, make_config
from .async_search import AsyncTickTrace
from .batched_async_search import BatchedAsyncEngine
from .batched_tree import BatchedTree, init_batched_tree
from .evaluators import (
    CachedModelEvaluator,
    Evaluator,
    FrontierModelEvaluator,
    ModelEvaluator,
    PagedCachedModelEvaluator,
    PagedFrontierModelEvaluator,
    RolloutEvaluator,
)
from .policies import PolicyConfig
from .tree import Tree, init_tree
from .wu_uct import SearchConfig, SearchResult, play_episode

__all__ = [
    "SearchSpec",
    "as_search_config",
    "build_searcher",
    "make_config",
    "BatchedAsyncEngine",
    "Evaluator",
    "RolloutEvaluator",
    "ModelEvaluator",
    "CachedModelEvaluator",
    "PagedCachedModelEvaluator",
    "FrontierModelEvaluator",
    "PagedFrontierModelEvaluator",
    "AsyncTickTrace",
    "PolicyConfig",
    "SearchConfig",
    "SearchResult",
    "Tree",
    "init_tree",
    "BatchedTree",
    "init_batched_tree",
    "play_episode",
]
