"""Evaluators: the pluggable leaf-evaluation side of parallel MCTS
(counterpart of ``repro.core.evaluators``, part 1: the protocol and the
classic rollout evaluator).

Engines drive their in-flight slots through an :class:`Evaluator` instead
of calling ``env.policy``/``env.step`` themselves.  The port's methods
take a batch ``[N]`` of slots where the reference's are ``vmap``\\ ped:

* ``tick(cfg, kind, act, state, rollout_done, acc, disc, steps, keys, aux)``
  advances ``N`` in-flight slots by one environment step;
* ``rollout(cfg, state, already_done, keys)`` returns the discounted
  simulation return ``f32[N]`` of ``N`` independent rollouts.

Rollouts are masked lockstep loops: all ``N`` slots step together until
none is live, which is what ``vmap`` of the reference's per-slot
``while_loop`` computes.  Each step costs one host sync.

The slot-aux hooks and ``init_state`` come with the async engines that
call them; the model evaluators (``ModelEvaluator`` and the KV-cached
ones), and the protocol's default tick-driven ``rollout`` that they use,
with the model-guided slice; the serving hooks with serving.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from .. import rng
from ..envs.base import Environment, where_state
from ..sync import host_any

State = Any

# Slot phases, shared with the async engines.
FREE, EXPAND, SIM = 0, 1, 2


def slot_accounting(gamma, kind, nxt, state, r, done, rollout_done, acc, disc,
                    steps):
    """Per-slot discounted-return bookkeeping after one environment step:
    only live SIM slots accumulate, FREE slots keep their state, EXPAND
    slots report the edge transition."""
    is_sim = kind == SIM
    live = is_sim & ~rollout_done
    acc = acc + torch.where(live, disc * r, 0.0)
    disc = torch.where(live, disc * gamma, disc)
    busy = kind != FREE
    steps = steps + busy.to(steps.dtype)
    new_state = where_state(busy, nxt, state)
    rollout_done = torch.where(kind == EXPAND, done, rollout_done | (is_sim & done))
    return new_state, r, done, acc, disc, steps, rollout_done


class Evaluator:
    """Protocol for environment/model evaluation inside a search engine.

    ``cfg`` is the engine's ``SearchConfig`` (only ``gamma``,
    ``max_sim_steps`` and ``value_mix`` are read).  ``aux`` is the
    evaluator-owned per-slot state of the async engines; stateless
    evaluators pass it through.
    """

    env: Optional[Environment] = None

    def tick(self, cfg, kind, act, state, rollout_done, acc, disc, steps, keys,
             aux=()):
        raise NotImplementedError

    def value(self, state: State) -> torch.Tensor:
        return torch.zeros(state[0].shape[0], dtype=torch.float32,
                           device=state[0].device)

    def has_value(self) -> bool:
        """Whether :meth:`value` is a real estimator; gates the truncation
        bootstrap and ``value_mix`` blending."""
        return False

    def rollout(self, cfg, state, already_done, keys) -> torch.Tensor:
        raise NotImplementedError


class RolloutEvaluator(Evaluator):
    """Classic rollout evaluation: ``env.policy`` acts, ``env.step``
    advances; the reference's default, draw for draw."""

    def __init__(self, env: Environment):
        self.env = env

    def tick(self, cfg, kind, act, state, rollout_done, acc, disc, steps, keys,
             aux=()):
        env = self.env
        pol_act = env.policy(keys, state).to(torch.int64)
        a = torch.where(kind == EXPAND, act.to(torch.int64), pol_act)
        nxt, r, done = env.step(state, a)
        out = slot_accounting(cfg.gamma, kind, nxt, state, r, done, rollout_done,
                              acc, disc, steps)
        return out, aux

    def rollout(self, cfg, state, already_done, keys) -> torch.Tensor:
        """Discounted simulation returns with optional value bootstrap and
        mixing (paper Fig. 1(a) "simulation"; App. D truncation)."""
        env = self.env
        n = already_done.shape[0]
        device = already_done.device
        st, done = state, already_done.clone()
        acc = torch.zeros((n,), dtype=torch.float32, device=device)
        disc = torch.ones((n,), dtype=torch.float32, device=device)
        steps = torch.zeros((n,), dtype=torch.int32, device=device)
        while True:
            live = ~done & (steps < cfg.max_sim_steps)
            if not host_any(live):
                break
            ks = rng.split(keys)
            a = env.policy(ks[:, 1], st)
            nxt, r, d = env.step(st, a)
            acc = torch.where(live, acc + disc * r, acc)
            disc = torch.where(live, disc * cfg.gamma, disc)
            st = where_state(live, nxt, st)
            done = torch.where(live, done | d, done)
            keys = torch.where(live[:, None], ks[:, 0], keys)
            steps = steps + live.to(torch.int32)

        if env.value_fn is not None:
            # Truncation bootstrap: R_simu = Σ γ^i r_i + γ^T V(s_T) (App. D).
            acc = acc + disc * torch.where(done, 0.0, env.value_fn(st))
            if cfg.value_mix > 0.0:
                v0 = torch.where(already_done, 0.0, env.value_fn(state))
                acc = (1.0 - cfg.value_mix) * acc + cfg.value_mix * v0
        return acc

    def value(self, state: State) -> torch.Tensor:
        if self.env.value_fn is None:
            return super().value(state)
        return self.env.value_fn(state)

    def has_value(self) -> bool:
        return self.env.value_fn is not None
