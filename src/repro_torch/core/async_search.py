"""Async-slot WU-UCT, one search (counterpart of ``repro.core.async_search``).

The paper's master–worker interleaving: ``wave_size`` slots model the
worker pool, every master tick advances each busy slot by one environment
step, and a slot whose rollout finishes settles and is refilled at once.

The port has one async engine, :class:`~repro_torch.core.batched_async_search
.BatchedAsyncEngine`; a single search is its ``B = 1`` view (lift the root
state and key to ``[1]``, run, squeeze).  The reference's batched async
engine equals ``vmap`` of its single one, so this view makes the
reference single engine's decisions.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..envs.base import Environment, map_state
from .batched_async_search import run_async_search_batched
from .evaluators import EXPAND, FREE, SIM, Evaluator
from .wu_uct import SearchConfig, SearchResult

__all__ = ["EXPAND", "FREE", "SIM", "run_async_search"]

State = Any


def run_async_search(env: Environment, cfg: SearchConfig, root_state: State,
                     rng_key: torch.Tensor,
                     evaluator: Optional[Evaluator] = None) -> SearchResult:
    """One async-slot search from ``root_state`` (leaves without a batch
    axis) with key data ``rng_key[2]``."""
    res = run_async_search_batched(env, cfg, map_state(lambda x: x[None], root_state),
                                   rng_key[None], evaluator=evaluator)
    return SearchResult(*(x[0] for x in res))
