"""Synthetic tree MDP with a known optimum (counterpart of
``repro.envs.bandit_tree``).

Edge rewards are ``uniform(fold_in(PRNGKey(seed), child))`` with the heap
index ``child = node * A + action + 1``, so the exact optimum follows by
dynamic programming (:func:`solve_bandit_tree`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import rng
from .base import Environment


class BanditTreeState(NamedTuple):
    node: torch.Tensor   # i32[N] implicit node id
    depth: torch.Tensor  # i32[N]
    done: torch.Tensor   # bool[N]


def _edge_reward(seed: int, child: torch.Tensor) -> torch.Tensor:
    """Per-edge reward in [0, 1) for heap indices ``child`` (int32)."""
    key = rng.fold_in(rng.PRNGKey(seed, device=child.device), child)
    return rng.uniform(key)


def make_bandit_tree(depth: int = 5, num_actions: int = 4, seed: int = 0) -> Environment:
    def init(keys: torch.Tensor) -> BanditTreeState:
        zeros = torch.zeros((keys.shape[0],), dtype=torch.int32, device=keys.device)
        return BanditTreeState(zeros, zeros.clone(), zeros.to(torch.bool))

    def step(state: BanditTreeState, action: torch.Tensor):
        child = state.node * num_actions + action.to(torch.int32) + 1
        r = _edge_reward(seed, child)
        new_depth = state.depth + 1
        done = new_depth >= depth
        nxt = BanditTreeState(
            node=torch.where(state.done, state.node, child),
            depth=torch.where(state.done, state.depth, new_depth),
            done=state.done | done,
        )
        return nxt, torch.where(state.done, 0.0, r), nxt.done

    def observe(state: BanditTreeState) -> torch.Tensor:
        return torch.stack(
            [state.node.to(torch.float32), state.depth.to(torch.float32)], dim=-1
        )

    return Environment(
        name=f"bandit_tree(d={depth},a={num_actions},seed={seed})",
        num_actions=num_actions,
        init=init,
        step=step,
        observe=observe,
    )


def solve_bandit_tree(
    depth: int, num_actions: int, seed: int, gamma: float = 1.0
) -> tuple[float, int, np.ndarray]:
    """Exact DP solution: (optimal return, optimal first action, Q_root).

    Level by level instead of by recursion; every sum is the reference's
    float64 ``r(edge) + gamma * value(child)`` on float32 edge rewards, so
    the results are equal to ``repro.envs.bandit_tree.solve_bandit_tree``.
    """
    a = num_actions
    level_sizes = [a ** d for d in range(depth + 1)]
    total = sum(level_sizes)
    ids = torch.arange(1, total, dtype=torch.int32)
    rewards = np.zeros(total, np.float64)
    rewards[1:] = _edge_reward(seed, ids).numpy().astype(np.float64)

    value = np.zeros(level_sizes[depth], np.float64)     # leaves
    start = total - level_sizes[depth]                   # first leaf id
    for d in range(depth - 1, -1, -1):
        child_start = start
        start = child_start - level_sizes[d]
        q = rewards[child_start:child_start + level_sizes[d + 1]] + gamma * value
        q = q.reshape(level_sizes[d], a)
        if d == 0:
            return float(q[0].max()), int(q[0].argmax()), q[0].copy()
        value = q.max(axis=1)
    raise ValueError("depth must be >= 1")
