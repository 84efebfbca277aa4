# The rollout-evaluated WU-UCT wave engine of the port; describe a search
# with `SearchSpec` and build it with `build_searcher(env, spec)`.
from .api import SearchSpec, as_search_config, build_searcher
from .batched_tree import BatchedTree, init_batched_tree
from .evaluators import Evaluator, RolloutEvaluator
from .policies import PolicyConfig
from .wu_uct import SearchConfig, SearchResult, play_episode

__all__ = [
    "SearchSpec",
    "as_search_config",
    "build_searcher",
    "Evaluator",
    "RolloutEvaluator",
    "PolicyConfig",
    "SearchConfig",
    "SearchResult",
    "BatchedTree",
    "init_batched_tree",
    "play_episode",
]
