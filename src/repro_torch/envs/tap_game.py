"""Tap-elimination game (counterpart of ``repro.envs.tap_game``).

A ``G×G`` grid of colours; tapping a cell whose same-colour region has at
least two cells removes the region, the rest falls down (gravity) and the
holes at the top are refilled from the key carried in the state.  Every
function works on a batch ``[N]`` of boards.

Loops: the flood fill dilates until the region stops growing.  It runs
four dilations between checks (dilating a converged region changes
nothing), so one fill costs ``ceil(iterations / 4)`` host syncs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import rng
from ..sync import host_any
from .base import Environment

EMPTY = -1
_DILATIONS_PER_CHECK = 4


class TapGameState(NamedTuple):
    grid: torch.Tensor        # i8[N, G, G]  (row 0 = top)
    steps_left: torch.Tensor  # i32[N]
    goal_left: torch.Tensor   # i32[N]  remaining goal-colour cells
    key: torch.Tensor         # i64[N, 2] chance key for refills
    done: torch.Tensor        # bool[N]


def _dilate(mask: torch.Tensor, same: torch.Tensor) -> torch.Tensor:
    out = mask.clone()
    out[:, :-1, :] |= mask[:, 1:, :]
    out[:, 1:, :] |= mask[:, :-1, :]
    out[:, :, :-1] |= mask[:, :, 1:]
    out[:, :, 1:] |= mask[:, :, :-1]
    return out & same


def _flood_fill(grid: torch.Tensor, r: torch.Tensor, c: torch.Tensor,
                inside: torch.Tensor) -> torch.Tensor:
    """Mask of the same-colour region holding ``(r, c)`` on each board.

    ``r``/``c`` are already clamped into the board; ``inside`` is False
    where the action was off the board, which seeds no region (JAX drops
    the out-of-range seed write).
    """
    n = torch.arange(grid.shape[0], device=grid.device)
    color = grid[n, r, c]
    same = (grid == color[:, None, None]) & (grid != EMPTY)
    seed = torch.zeros_like(same)
    seed[n, r, c] = inside
    mask = seed & same
    while True:
        prev = mask
        for _ in range(_DILATIONS_PER_CHECK):
            mask = _dilate(mask, same)
        if not host_any(mask != prev):
            return mask


def _gravity(grid: torch.Tensor) -> torch.Tensor:
    """Compact non-empty cells downward per column (stable)."""
    filled = (grid != EMPTY).to(torch.uint8)          # empties (0) sort first
    order = torch.sort(filled, dim=1, stable=True).indices
    return torch.gather(grid, 1, order)


def make_tap_game(
    grid_size: int = 6,
    num_colors: int = 4,
    goal_color: int = 0,
    goal_count: int = 12,
    step_budget: int = 20,
    refill: bool = True,
) -> Environment:
    g = grid_size

    def init(keys: torch.Tensor) -> TapGameState:
        ks = rng.split(keys)
        n = keys.shape[0]
        grid = rng.randint(ks[:, 0], (g, g), 0, num_colors, torch.int8)
        return TapGameState(
            grid=grid,
            steps_left=torch.full((n,), step_budget, dtype=torch.int32, device=keys.device),
            goal_left=torch.full((n,), goal_count, dtype=torch.int32, device=keys.device),
            key=ks[:, 1],
            done=torch.zeros((n,), dtype=torch.bool, device=keys.device),
        )

    def step(state: TapGameState, action: torch.Tensor):
        grid = state.grid
        n = torch.arange(grid.shape[0], device=grid.device)
        action = action.to(torch.int64)
        r, c = action // g, action % g
        # JAX clamps the gather at (r, c); the port clamps explicitly.
        inside = (r >= 0) & (r < g)
        r, c = r.clamp(0, g - 1), c.clamp(0, g - 1)
        mask = _flood_fill(grid, r, c, inside)
        size = mask.sum(dim=(1, 2))
        tapped_valid = (grid[n, r, c] != EMPTY) & (size >= 2)

        eliminated = tapped_valid[:, None, None] & mask
        goal_hit = (eliminated & (grid == goal_color)).sum(dim=(1, 2)).to(torch.int32)
        new_grid = torch.where(eliminated, torch.full_like(grid, EMPTY), grid)
        new_grid = _gravity(new_grid)
        ks = rng.split(state.key)
        key, k_fill = ks[:, 0], ks[:, 1]
        if refill:
            fresh = rng.randint(k_fill, (g, g), 0, num_colors, torch.int8)
            new_grid = torch.where(new_grid == EMPTY, fresh, new_grid)

        goal_left = torch.clamp_min(state.goal_left - goal_hit, 0)
        steps_left = state.steps_left - 1
        won = goal_left == 0
        done = won | (steps_left <= 0)

        # Progress toward the goal, a small per-step penalty and a win bonus,
        # in float32 and in the reference's order of operations.
        bonus = (won & ~state.done).to(torch.float32)
        reward = goal_hit.to(torch.float32) / float(goal_count) - 0.01 + bonus
        was_done = state.done
        nxt = TapGameState(
            grid=torch.where(was_done[:, None, None], grid, new_grid),
            steps_left=torch.where(was_done, state.steps_left, steps_left),
            goal_left=torch.where(was_done, state.goal_left, goal_left),
            key=key,
            done=was_done | done,
        )
        return nxt, torch.where(was_done, 0.0, reward), nxt.done

    def rollout_policy(keys: torch.Tensor, state: TapGameState) -> torch.Tensor:
        """Tap a random cell that has a same-colour neighbour, biased toward
        the goal colour; uniform when no pair exists."""
        grid = state.grid
        up = torch.full_like(grid, -2)
        down = torch.full_like(grid, -2)
        left = torch.full_like(grid, -2)
        right = torch.full_like(grid, -2)
        up[:, :-1] = grid[:, 1:]
        down[:, 1:] = grid[:, :-1]
        left[:, :, :-1] = grid[:, :, 1:]
        right[:, :, 1:] = grid[:, :, :-1]
        has_pair = (
            (grid == up) | (grid == down) | (grid == left) | (grid == right)
        ) & (grid != EMPTY)
        is_goal = grid == goal_color
        logits = (
            torch.where(has_pair, 0.0, -1e9) + torch.where(is_goal, 2.0, 0.0)
        ).reshape(grid.shape[0], -1)
        any_pair = has_pair.flatten(1).any(dim=1, keepdim=True)
        logits = torch.where(any_pair, logits, torch.zeros_like(logits))
        return rng.categorical(keys, logits)

    def observe(state: TapGameState) -> torch.Tensor:
        colors = torch.arange(num_colors, device=state.grid.device)
        onehot = (state.grid.to(torch.int64)[..., None] == colors).to(torch.float32)
        extras = torch.stack(
            [
                state.steps_left.to(torch.float32) / step_budget,
                state.goal_left.to(torch.float32) / goal_count,
            ],
            dim=-1,
        )
        return torch.cat([onehot.flatten(1), extras], dim=-1)

    return Environment(
        name=f"tap_game(g={g},colors={num_colors})",
        num_actions=g * g,
        init=init,
        step=step,
        rollout_policy=rollout_policy,
        observe=observe,
    )
