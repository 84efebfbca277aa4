"""Token-generation environment (counterpart of ``repro.envs.token_env``):
WU-UCT searches over LM continuations.

State = (tokens so far, length, done); actions = ranks into the top-K
tokens under the policy LM at the current position; reward = the token's
log-likelihood under a reward model (the policy model unless another is
given).  Terminal at EOS or max length.

The port writes the batch axis out: every function takes states whose
leaves lead with ``[N]``, and ``step`` and ``rollout_policy`` run **one**
``forward`` over ``[N, max_len]`` for the whole batch (a second one only
for a distinct reward model).  Top-K ties go to the lower token id, as
``jax.lax.top_k`` breaks them (:func:`sorted_top_k`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import rng
from ..models import logits_at
from ..models.config import ModelConfig
from ..models.layers import sorted_top_k
from .base import Environment


class TokenEnvState(NamedTuple):
    tokens: torch.Tensor   # i32[N, max_len]
    length: torch.Tensor   # i32[N]
    done: torch.Tensor     # bool[N]


def apply_token(state: TokenEnvState, token: torch.Tensor, logp: torch.Tensor,
                eos_token: int) -> tuple[TokenEnvState, torch.Tensor, torch.Tensor]:
    """Transition core shared by ``step`` and the model evaluators: append
    ``token`` at each row's current position, reward its ``logp``,
    terminate at EOS or max length, freeze finished rows."""
    max_len = state.tokens.shape[-1]
    token = token.to(torch.int32)
    at_pos = torch.arange(max_len, device=token.device) == state.length[..., None]
    new_tokens = torch.where(at_pos, token[..., None], state.tokens)
    new_len = state.length + 1
    hit_end = (token == eos_token) | (new_len >= max_len)
    nxt = TokenEnvState(
        tokens=torch.where(state.done[..., None], state.tokens, new_tokens),
        length=torch.where(state.done, state.length, new_len),
        done=state.done | hit_end,
    )
    reward = torch.where(state.done, 0.0, logp)
    return nxt, reward, nxt.done


def position_logits(params, cfg: ModelConfig, state: TokenEnvState) -> torch.Tensor:
    """Each row's logits at its last token (``length - 1``; a reference
    ``length`` of 0 reads the last position, as JAX's negative index
    does).

    The reference runs one forward per row (``vmap``); an MoE layer routes
    the tokens of a call together, so for the moe family each row is its
    own forward here too."""
    pos = torch.remainder(state.length.to(torch.int64) - 1, state.tokens.shape[-1])
    if cfg.family == "moe":
        return torch.cat([logits_at(params, cfg, state.tokens[i:i + 1], pos[i:i + 1])
                          for i in range(pos.shape[0])])
    return logits_at(params, cfg, state.tokens, pos)


def make_token_env(
    policy_cfg: ModelConfig,
    policy_params,
    prompt: torch.Tensor,        # i32[P]
    max_len: int = 64,
    top_k: int = 8,
    eos_token: int = 0,
    reward_cfg: Optional[ModelConfig] = None,
    reward_params=None,
) -> Environment:
    """Actions = ranks into the policy model's top-K at the current state."""
    k = top_k
    prompt = torch.as_tensor(prompt).to(torch.int32)
    prompt_len = int(prompt.shape[0])
    if not 0 < prompt_len < max_len:
        raise ValueError(f"prompt length {prompt_len} must be in [1, max_len={max_len})")
    same_reward = reward_params is None
    reward_cfg = reward_cfg or policy_cfg

    def rewards_logits(state, pol):
        if same_reward:
            return pol
        return position_logits(reward_params, reward_cfg, state)

    def init(keys: torch.Tensor) -> TokenEnvState:
        n, dev = keys.shape[0], keys.device
        tokens = torch.zeros((n, max_len), dtype=torch.int32, device=dev)
        tokens[:, :prompt_len] = prompt.to(dev)
        return TokenEnvState(
            tokens,
            torch.full((n,), prompt_len, dtype=torch.int32, device=dev),
            torch.zeros((n,), dtype=torch.bool, device=dev),
        )

    def step(state: TokenEnvState, action: torch.Tensor):
        pol = position_logits(policy_params, policy_cfg, state)
        _, top_idx = sorted_top_k(pol, k)
        # Actions come from the search (ranks in [0, K)); the clamp is a
        # gather guard, as in the reference.
        rank = torch.clamp(action.to(torch.int64), 0, k - 1)
        token = top_idx.gather(1, rank[:, None])[:, 0]
        rew = rewards_logits(state, pol)
        logp = torch.log_softmax(rew.float(), dim=-1).gather(1, token[:, None])[:, 0]
        return apply_token(state, token, logp, eos_token)

    def rollout_policy(keys: torch.Tensor, state: TokenEnvState) -> torch.Tensor:
        # Sample an action rank ∝ the policy's top-K probabilities.
        pol = position_logits(policy_params, policy_cfg, state)
        top_vals, _ = sorted_top_k(pol, k)
        return rng.categorical(keys, top_vals).to(torch.int32)

    def observe(state: TokenEnvState) -> torch.Tensor:
        return state.tokens.to(torch.float32)

    return Environment(
        name=f"token_env({policy_cfg.name},k={k})",
        num_actions=k,
        init=init,
        step=step,
        rollout_policy=rollout_policy,
        observe=observe,
    )
