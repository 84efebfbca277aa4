"""Async-slot WU-UCT, one search (counterpart of ``repro.core.async_search``).

The paper's master–worker interleaving: ``wave_size`` slots model the
worker pool, every master tick advances each busy slot by one environment
step, and a slot whose rollout finishes settles and is refilled at once.

The port has one async engine, :class:`~repro_torch.core.batched_async_search
.BatchedAsyncEngine`; a single search is its ``B = 1`` view (lift the root
state and key to ``[1]``, run, squeeze).  The reference's batched async
engine equals ``vmap`` of its single one, so this view makes the
reference single engine's decisions.

**Trace mode** (``trace_ticks > 0``): the engine runs exactly
``trace_ticks`` master ticks, frozen ones after every tree has settled
included, and snapshots each tick in an :class:`AsyncTickTrace`, the
record the invariant checks read (``O`` conservation, cache depth against
the slot's prefix, the pool's working set, the serving occupancy).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from ..envs.base import Environment, map_state
from .batched_async_search import run_async_search_batched
from .evaluators import EXPAND, FREE, SIM, Evaluator
from .wu_uct import SearchConfig, SearchResult

__all__ = ["EXPAND", "FREE", "SIM", "AsyncTickTrace", "run_async_search",
           "stack_ticks", "tick_snapshot"]

State = Any


class AsyncTickTrace(NamedTuple):
    """Per-master-tick engine snapshots (trace mode; invariant tests).

    The leading axis is the tick index ``K``; the batched engine adds a tree
    axis ``B`` after it.  ``alive`` marks ticks that advanced the search
    (``t_done < T`` at tick entry); later snapshots are frozen copies.  The
    optional fields are ``None`` where the evaluator keeps no such state:
    ``state_len`` (slot token-prefix length) and ``cache_len`` (evaluator
    cache depth) for the token environment and the cached evaluators,
    ``blocks_in_use`` for the paged pool.
    """

    O: torch.Tensor          # f32[K, M]    in-flight counts after the tick
    parent: torch.Tensor     # i64[K, M]    parent pointers
    kind: torch.Tensor       # i64[K, W]    slot phase (FREE / EXPAND / SIM)
    sim_node: torch.Tensor   # i64[K, W]    node each slot's rollout is charged to
    t_done: torch.Tensor     # i64[K]       completed simulations so far
    alive: torch.Tensor      # bool[K]
    state_len: Optional[torch.Tensor] = None      # i32[K, W] slot prefix length
    cache_len: Optional[torch.Tensor] = None      # i32[K, W] evaluator cache depth
    blocks_in_use: Optional[torch.Tensor] = None  # i64[K] paged-pool working set
    frontier_hits: Optional[torch.Tensor] = None  # i64[K] cumulative refill hits
    busy_slots: Optional[torch.Tensor] = None     # i64[K] (+[B]) non-FREE slots
    active_trees: Optional[torch.Tensor] = None   # i64[K] trees still searching


def tick_snapshot(carry, alive: torch.Tensor, cache_len=None, blocks=None,
                  frontier_hits=None) -> AsyncTickTrace:
    """One :class:`AsyncTickTrace` row from a master-loop carry
    ``(tree, slots, rng, t_launch, t_done, ...)``, taken after the tick with
    ``alive`` taken at its entry.

    The engine updates its buffers in place, so every field is a copy.
    ``busy_slots`` counts each tree's non-FREE slots (zero for a settled
    tree) and ``active_trees`` the trees still searching: the occupancy
    counters the serving layer turns into its slot-idle fraction.
    """
    tree, slots = carry[0], carry[1]
    alive_i = alive.to(torch.int64)
    busy = (slots.kind != FREE).sum(dim=-1) * alive_i
    state_len = getattr(slots.state, "length", None)

    def copy(x):
        return None if x is None else x.clone()

    return AsyncTickTrace(
        O=tree.O.clone(), parent=tree.parent.clone(), kind=slots.kind.clone(),
        sim_node=slots.sim_node.clone(), t_done=carry[4].clone(), alive=alive.clone(),
        state_len=copy(state_len), cache_len=copy(cache_len), blocks_in_use=copy(blocks),
        frontier_hits=copy(frontier_hits), busy_slots=busy,
        active_trees=alive_i.reshape(-1).sum(),
    )


def stack_ticks(snaps) -> AsyncTickTrace:
    """Stack per-tick snapshots along a new leading ``K`` axis."""
    return AsyncTickTrace(*(None if f[0] is None else torch.stack(f) for f in zip(*snaps)))


def run_async_search(env: Environment, cfg: SearchConfig, root_state: State,
                     rng_key: torch.Tensor, trace_ticks: int = 0,
                     evaluator: Optional[Evaluator] = None):
    """One async-slot search from ``root_state`` (leaves without a batch
    axis) with key data ``rng_key[2]``.

    With ``trace_ticks > 0`` returns ``(SearchResult, AsyncTickTrace)``, the
    trace ``[K, ...]`` with no tree axis.
    """
    out = run_async_search_batched(env, cfg, map_state(lambda x: x[None], root_state),
                                   rng_key[None], trace_ticks=trace_ticks,
                                   evaluator=evaluator)
    res, trace = out if trace_ticks > 0 else (out, None)
    res = SearchResult(*(x[0] for x in res))
    if trace is None:
        return res
    # blocks_in_use and active_trees carry no tree axis.
    per_tree = {f: None if x is None else x[:, 0] for f, x in trace._asdict().items()
                if f not in ("blocks_in_use", "active_trees")}
    return res, trace._replace(**per_tree)
