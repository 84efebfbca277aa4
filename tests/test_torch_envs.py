"""The port's environments against ``repro.envs``.

Both sides start from the same states (JAX's ``init`` on numpy key data,
carried across with ``repro_torch.convert``) and step through the same
numpy-drawn action sequences.  Grids, counters, keys, ``done``, node and
depth must be equal; rewards agree within 1 ulp; the rollout policies
draw the same actions; ``solve_bandit_tree`` gives the same optimum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.envs import make_bandit_tree as jax_bandit_tree
from repro.envs import make_tap_game as jax_tap_game
from repro.envs.bandit_tree import solve_bandit_tree as jax_solve
from repro_torch import convert
from repro_torch.envs import make_bandit_tree, make_tap_game, solve_bandit_tree

torch.set_num_threads(2)

N = 16


def _key_data(seed, n=N):
    return np.random.default_rng(seed).integers(0, 2 ** 32, size=(n, 2), dtype=np.uint32)


def _assert_state_equal(jax_state, state):
    for field in state._fields:
        ref = np.asarray(getattr(jax_state, field))
        if ref.dtype == np.uint32:
            ref = ref.astype(np.int64)
        np.testing.assert_array_equal(getattr(state, field).numpy(), ref, err_msg=field)


def _run_pair(jax_env, env, kd, actions):
    """Init from key data, then step both sides through ``actions[T, N]``."""
    j_init = jax.jit(jax.vmap(jax_env.init))
    j_step = jax.jit(jax.vmap(jax_env.step))
    j_state = j_init(jnp.asarray(kd))
    state = env.init(convert.keys_from_numpy(kd, device="cpu"))
    _assert_state_equal(j_state, state)
    for t in range(actions.shape[0]):
        j_state, j_r, j_done = j_step(j_state, jnp.asarray(actions[t]))
        state, r, done = env.step(state, torch.from_numpy(actions[t]))
        _assert_state_equal(j_state, state)
        np.testing.assert_array_max_ulp(r.numpy(), np.asarray(j_r), maxulp=1)
        np.testing.assert_array_equal(done.numpy(), np.asarray(j_done))
    return j_state, state


@pytest.mark.parametrize("grid,colors,goal,budget", [(6, 4, 10, 20), (7, 5, 14, 30)])
def test_tap_game_steps_match(grid, colors, goal, budget):
    jax_env = jax_tap_game(grid, colors, goal_count=goal, step_budget=budget)
    env = make_tap_game(grid, colors, goal_count=goal, step_budget=budget)
    rs = np.random.default_rng(grid)
    steps = budget + 3                                   # run past the budget
    actions = rs.integers(0, grid * grid, size=(steps, N)).astype(np.int32)
    j_state, state = _run_pair(jax_env, env, _key_data(grid), actions)
    assert bool(state.done.all())
    np.testing.assert_array_equal(
        env.observe(state).numpy(), np.asarray(jax.vmap(jax_env.observe)(j_state))
    )


@pytest.mark.parametrize("grid,colors", [(6, 4), (7, 5)])
def test_tap_rollout_policy_matches(grid, colors):
    """The goal-biased categorical policy, on boards mid-episode."""
    jax_env = jax_tap_game(grid, colors)
    env = make_tap_game(grid, colors)
    rs = np.random.default_rng(100 + grid)
    actions = rs.integers(0, grid * grid, size=(4, N)).astype(np.int32)
    j_state, state = _run_pair(jax_env, env, _key_data(200 + grid), actions)
    kd = _key_data(300 + grid)
    ref = jax.jit(jax.vmap(jax_env.policy))(jnp.asarray(kd), j_state)
    out = env.policy(convert.keys_from_numpy(kd, device="cpu"), state)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("depth,actions,seed", [(4, 4, 0), (6, 3, 5)])
def test_bandit_tree_steps_match(depth, actions, seed):
    jax_env = jax_bandit_tree(depth=depth, num_actions=actions, seed=seed)
    env = make_bandit_tree(depth=depth, num_actions=actions, seed=seed)
    acts = np.random.default_rng(seed).integers(0, actions, size=(depth + 2, N)).astype(np.int32)
    _, state = _run_pair(jax_env, env, _key_data(seed), acts)
    assert bool(state.done.all())
    kd = _key_data(seed + 1)
    ref = jax.jit(jax.vmap(jax_env.policy))(jnp.asarray(kd),
                                            jax.vmap(jax_env.init)(jnp.asarray(kd)))
    out = env.policy(convert.keys_from_numpy(kd, device="cpu"),
                     env.init(convert.keys_from_numpy(kd, device="cpu")))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("depth,actions,seed,gamma", [(4, 4, 0, 1.0), (3, 5, 7, 0.9)])
def test_solve_bandit_tree_matches(depth, actions, seed, gamma):
    ref_v, ref_a, ref_q = jax_solve(depth, actions, seed, gamma)
    v, a, q = solve_bandit_tree(depth, actions, seed, gamma)
    assert (v, a) == (ref_v, ref_a)
    np.testing.assert_array_equal(q, ref_q)
