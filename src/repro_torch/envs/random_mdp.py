"""Tabular stochastic MDP, Garnet-style (counterpart of
``repro.envs.random_mdp``).

Transitions are categorical draws from a fixed table; each draw consumes
the key carried in the state, so ``step`` is deterministic given the state
while the environment itself is stochastic.

The tables are the reference's draws from ``PRNGKey(seed)``: successors
(``randint``) and rewards (``uniform``) bit for bit, transition
probabilities from :func:`repro_torch.rng.dirichlet`, which differs from
``jax.random.dirichlet`` where a ``log``/``exp`` rounds an ulp apart
(``tests/test_torch_random_mdp.py`` pins the share).  They are drawn on
the CPU once and copied to each device a state arrives on.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import rng
from .base import Environment


class RandomMDPState(NamedTuple):
    s: torch.Tensor     # i32[N] current tabular state
    t: torch.Tensor     # i32[N] timestep
    key: torch.Tensor   # i64[N, 2] chance key
    done: torch.Tensor  # bool[N]


def mdp_tables(num_states: int, num_actions: int, branching: int, seed: int):
    """``(succ i32[S, A, K], probs f32[S, A, K], rewards f32[S, A])`` on the
    CPU, drawn as the reference draws them."""
    k_p, k_r, k_succ = rng.split(rng.PRNGKey(seed), 3)
    succ = rng.randint(k_succ, (num_states, num_actions, branching), 0, num_states)
    probs = rng.dirichlet(k_p, torch.ones(branching), (num_states, num_actions))
    rewards = rng.uniform(k_r, (num_states, num_actions))
    return succ, probs, rewards


def make_random_mdp(num_states: int = 32, num_actions: int = 4, horizon: int = 20,
                    branching: int = 4, seed: int = 0) -> Environment:
    cpu = mdp_tables(num_states, num_actions, branching, seed)
    cached = {}

    def tables(device):
        if device not in cached:
            succ, probs, rewards = (x.to(device) for x in cpu)
            cached[device] = (succ.to(torch.int64), torch.log(probs), rewards)
        return cached[device]

    def init(keys: torch.Tensor) -> RandomMDPState:
        zeros = torch.zeros((keys.shape[0],), dtype=torch.int32, device=keys.device)
        return RandomMDPState(zeros, zeros.clone(), rng.fold_in(keys, 7),
                              zeros.to(torch.bool))

    def step(state: RandomMDPState, action: torch.Tensor):
        succ, log_probs, rewards = tables(state.s.device)
        s, a = state.s.to(torch.int64), action.to(torch.int64)
        ks = rng.split(state.key)
        branch = rng.categorical(ks[:, 1], log_probs[s, a])
        s_next = succ[s, a, branch].to(torch.int32)
        t = state.t + 1
        nxt = RandomMDPState(
            s=torch.where(state.done, state.s, s_next),
            t=torch.where(state.done, state.t, t),
            key=ks[:, 0],
            done=state.done | (t >= horizon),
        )
        return nxt, torch.where(state.done, 0.0, rewards[s, a]), nxt.done

    def observe(state: RandomMDPState) -> torch.Tensor:
        return torch.nn.functional.one_hot(state.s.to(torch.int64),
                                           num_states).to(torch.float32)

    return Environment(
        name=f"random_mdp(s={num_states},a={num_actions},h={horizon})",
        num_actions=num_actions,
        init=init,
        step=step,
        observe=observe,
    )
