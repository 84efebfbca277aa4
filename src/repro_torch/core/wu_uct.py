"""WU-UCT — wave-scheduled parallel MCTS (counterpart of
``repro.core.wu_uct``).

The port has one engine, the batched lockstep engine of
:mod:`repro_torch.core.batched_search`; a single search is its ``B = 1``
view (lift the root state and key to ``[1]``, run, squeeze).  The
reference's batched engine equals ``vmap`` of its single engine, so this
view makes the reference single engine's decisions.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from .. import rng
from ..envs.base import Environment, map_state
from .evaluators import Evaluator
from .policies import PolicyConfig

State = Any


class SearchConfig(NamedTuple):
    num_simulations: int = 128      # T_max
    wave_size: int = 16             # W — number of in-flight workers
    max_depth: int = 100            # d_max
    max_sim_steps: int = 100        # simulation rollout cap (App. D: 100)
    max_width: int = 20             # search-width cap (paper: 5 tap / 20 Atari)
    gamma: float = 0.99
    policy: PolicyConfig = PolicyConfig()
    stat_mode: str = "wu"           # wu | vl | none  (in-flight bookkeeping)
    expand_coin: float = 0.5        # traversal rule (iii) stop probability
    value_mix: float = 0.0          # R = (1-m)·R_simu + m·V(s)   (App. D: 0.5)
    deterministic_expansion: bool = False  # first-untried action (tests/oracle)


class SearchResult(NamedTuple):
    action: torch.Tensor          # i64 chosen root action
    root_n: torch.Tensor          # f32[A] root child visit counts
    root_v: torch.Tensor          # f32[A] root child values
    tree_size: torch.Tensor       # i64
    dup_selections: torch.Tensor  # f32 avg duplicate stop-nodes per wave
    max_o: torch.Tensor           # f32 peak O at root (in-flight pressure)
    overflowed: torch.Tensor      # bool tree capacity was hit during search
    ticks: torch.Tensor           # i64 master iterations (waves)


KIND_SIM = 0       # simulate from an existing node (no expansion)
KIND_EXPAND = 1    # expand a new child, then simulate from it
KIND_TERMINAL = 2  # traversal hit a terminal node: complete with return 0


def _lift(x: torch.Tensor) -> torch.Tensor:
    return x[None]


def traverse(tree, rng_key: torch.Tensor, cfg: SearchConfig) -> torch.Tensor:
    """Walk one tree from its root by the configured tree policy.

    ``tree`` is a single tree: a ``BatchedTree`` whose fields carry no
    batch axis.  The walk is the ``B = 1`` view of
    :func:`repro_torch.core.batched_search.traverse_batched`.
    """
    from .batched_search import traverse_batched
    from .batched_tree import BatchedTree

    lifted = BatchedTree(*(
        map_state(_lift, f) if isinstance(f, tuple) else _lift(f) for f in tree
    ))
    return traverse_batched(lifted, rng_key[None], cfg)[0]


def run_search(env: Environment, cfg: SearchConfig, root_state: State,
               rng_key: torch.Tensor,
               evaluator: Optional[Evaluator] = None,
               constrain: Optional[Callable[[Any], Any]] = None) -> SearchResult:
    """Full search from ``root_state`` (leaves without a batch axis) with
    key data ``rng_key[2]``; returns the move decision + stats.
    ``constrain`` is phase 2's hook on the ``W`` slots (the reference's
    ``_phase2_work``; here the batched engine's at ``B = 1``)."""
    from .batched_search import run_search_batched

    res = run_search_batched(env, cfg, map_state(_lift, root_state), rng_key[None],
                             evaluator=evaluator, constrain=constrain)
    return SearchResult(*(x[0] for x in res))


def play_episode(env: Environment, cfg: SearchConfig, rng_key: torch.Tensor,
                 max_moves: int = 64,
                 searcher: Optional[Callable[[State, torch.Tensor], SearchResult]] = None,
                 device=None):
    """Play one episode, searching before every move.

    ``searcher(state, key)`` defaults to :func:`run_search` with this
    config.  The episode runs on ``device`` (default ``"cuda"``; raises
    without a card unless the caller asks for the CPU).  Returns
    (episode_return, moves_used, done) — ``moves_used`` is the paper's
    "game step" metric for the tap game.
    """
    from .api import resolve_device

    dev = resolve_device(device)
    if searcher is None:
        def searcher(state, key):
            return run_search(env, cfg, state, key)

    rng_key, k_init = rng.split(rng_key.to(dev))
    state = map_state(lambda x: x[0], env.init(k_init[None]))
    total, moves, done = 0.0, 0, False
    for _ in range(max_moves):
        rng_key, k = rng.split(rng_key)
        k_search, _ = rng.split(k)
        res = searcher(state, k_search)
        nxt, r, d = env.step(map_state(_lift, state), res.action.reshape(1).to(dev))
        state = map_state(lambda x: x[0], nxt)
        total += float(r[0])
        moves += 1
        if bool(d[0]):
            done = True
            break
    return total, moves, done
