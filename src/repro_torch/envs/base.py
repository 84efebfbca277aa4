"""Environment protocol of the port (counterpart of ``repro.envs.base``).

The contract is the reference's: a finite action space and a ``step`` that
is deterministic given the state (chance is a key carried in the state).
The port writes the batch axis out instead of relying on ``vmap``: every
function takes and returns states whose leaves lead with ``[N]``:

* ``init(keys[N, 2]) -> state[N]``;
* ``step(state[N], actions[N]) -> (state[N], reward f32[N], done bool[N])``;
* ``policy(keys[N, 2], state[N]) -> actions[N]``.

States are ``NamedTuple``\\ s of tensors; :func:`map_state` and
:func:`where_state` are the pytree helpers the engines need.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from .. import rng

State = Any
StepFn = Callable[[State, torch.Tensor], tuple[State, torch.Tensor, torch.Tensor]]


def map_state(fn: Callable, *states: State) -> State:
    """Apply ``fn`` leaf by leaf across states of one ``NamedTuple`` type."""
    return type(states[0])(*(fn(*leaves) for leaves in zip(*states)))


def where_state(mask: torch.Tensor, a: State, b: State) -> State:
    """Leafwise ``where(mask, a, b)``; ``mask`` covers the leading axes."""

    def pick(x, y):
        m = mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim()))
        return torch.where(m, x, y)

    return map_state(pick, a, b)


@dataclasses.dataclass(frozen=True)
class Environment:
    """Bundle of batched functions describing one environment."""

    name: str
    num_actions: int
    init: Callable[[torch.Tensor], State]            # keys[N, 2] -> state[N]
    step: StepFn                                     # (state, a) -> (state', r, done)
    # Default (simulation) policy: keys, state -> actions.  Uniform unless
    # the environment supplies one.
    rollout_policy: Optional[Callable[[torch.Tensor, State], torch.Tensor]] = None
    # Optional value bootstrap V(s) used to truncate simulations (App. D).
    value_fn: Optional[Callable[[State], torch.Tensor]] = None
    # Optional observation extractor for policy/value networks.
    observe: Optional[Callable[[State], torch.Tensor]] = None

    def policy(self, keys: torch.Tensor, state: State) -> torch.Tensor:
        if self.rollout_policy is not None:
            return self.rollout_policy(keys, state)
        return rng.randint(keys, (), 0, self.num_actions, torch.int32)
