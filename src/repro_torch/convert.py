"""Carry state across from the JAX package, handed over as numpy arrays.

With these a test can start both implementations from the same root
states, keys or mid-search tree:

* :func:`keys_from_numpy` — raw key data ``uint32[..., 2]`` (what
  ``jax.random.key_data``, or a legacy ``PRNGKey`` array, holds) becomes
  the port's ``int64`` key tensor;
* :func:`state_from_numpy` — a root-state ``NamedTuple`` of arrays
  (``TapGameState``, ``BanditTreeState``, ``TokenEnvState``,
  ``RandomMDPState``) becomes the
  port's state class of the same name;
* :func:`tree_from_numpy` — a whole ``BatchedTree`` (its fields as numpy)
  becomes the port's ``BatchedTree``, index buffers widened to ``int64``;
* :func:`params_from_numpy` — the reference's LM parameter pytree (nested
  dicts of numpy arrays, bfloat16 ones included) becomes the port's
  parameter dict of the same layout, in the model's dtype except the
  leaves the reference keeps in float32 (an SSM block's ``A_log``,
  ``dt_bias``, ``D`` and the MoE ``router``);
* :func:`opt_state_from_numpy` — the reference's ``AdamWState`` (``step``,
  ``m``, ``v``, ``master`` as numpy) becomes the port's: float32 moments
  and master weights of the parameters' layout and an int32 step.

Every function copies its input and takes an explicit ``device``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .core.batched_tree import BatchedTree
from .envs.bandit_tree import BanditTreeState
from .envs.random_mdp import RandomMDPState
from .envs.tap_game import TapGameState
from .envs.token_env import TokenEnvState
from .models.config import ModelConfig
from .models.lm import FLOAT32_LEAVES
from .training.optimizer import AdamWState

STATE_TYPES = {cls.__name__: cls for cls in (TapGameState, BanditTreeState, TokenEnvState,
                                             RandomMDPState)}
_INDEX_FIELDS = ("parent", "action", "children", "depth", "size")


def _tensor(x, device) -> torch.Tensor:
    # A copy: the port updates trees in place, and numpy views of JAX
    # arrays are read-only buffers JAX still owns.
    arr = np.array(x, dtype=np.int64 if np.asarray(x).dtype == np.uint32 else None)
    return torch.from_numpy(arr).to(device)


def keys_from_numpy(data, *, device) -> torch.Tensor:
    """Key data ``uint32[..., 2]`` -> ``int64[..., 2]``."""
    arr = np.asarray(data)
    if arr.dtype != np.uint32 or arr.shape[-1:] != (2,):
        raise ValueError(f"expected uint32[..., 2] key data, got {arr.dtype}{arr.shape}")
    return _tensor(arr, device)


def state_from_numpy(state: Any, *, device, cls=None):
    """A reference state ``NamedTuple`` -> the port's state of the same
    name (or ``cls``).  ``uint32`` leaves (keys) become ``int64``."""
    cls = cls or STATE_TYPES.get(type(state).__name__)
    if cls is None:
        raise TypeError(f"no port state type for {type(state).__name__}")
    return cls(**{f: _tensor(getattr(state, f), device) for f in cls._fields})


def tree_from_numpy(tree: Any, *, device, state_cls=None) -> BatchedTree:
    """A reference ``BatchedTree`` -> the port's ``BatchedTree``."""
    fields = {}
    for f in BatchedTree._fields:
        if f == "states":
            fields[f] = state_from_numpy(tree.states, device=device, cls=state_cls)
            continue
        x = _tensor(getattr(tree, f), device)
        fields[f] = x.to(torch.int64) if f in _INDEX_FIELDS else x
    return BatchedTree(**fields)


def _param_tensor(x, dtype: torch.dtype, device) -> torch.Tensor:
    arr = np.ascontiguousarray(np.asarray(x))
    if arr.dtype.name == "bfloat16":     # ml_dtypes' bfloat16: same bits
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    if not t.is_floating_point():
        raise TypeError(f"parameter leaves are floating point, got {arr.dtype}")
    return t.to(device=device, dtype=dtype)


def params_from_numpy(params: Any, cfg: ModelConfig, *, device) -> dict:
    """The reference's parameter pytree (nested dicts, numpy leaves) ->
    the port's parameter dict: same keys and shapes, on ``device``, leaves
    in ``cfg.dtype`` except those the reference holds in float32 whatever
    the model's dtype (:data:`repro_torch.models.lm.FLOAT32_LEAVES`),
    which stay float32."""
    _check_layout(params, cfg)
    return _convert(params, lambda name: torch.float32 if name in FLOAT32_LEAVES
                    else cfg.dtype, device)


def _check_layout(params: Any, cfg: ModelConfig) -> None:
    if not isinstance(params, dict) or "embed" not in params:
        raise TypeError("expected the reference's LM parameter dict (with 'embed')")
    embed = np.shape(params["embed"])
    if tuple(embed) != (cfg.vocab_size, cfg.d_model):
        raise ValueError(f"embed has shape {tuple(embed)}, the config wants "
                         f"{(cfg.vocab_size, cfg.d_model)}")


def _convert(tree, dtype_of, device, name=None):
    if isinstance(tree, dict):
        return {k: _convert(v, dtype_of, device, k) for k, v in tree.items()}
    return _param_tensor(tree, dtype_of(name), device)


def opt_state_from_numpy(state: Any, cfg: ModelConfig, *, device) -> AdamWState:
    """The reference's ``AdamWState`` (``step`` a scalar, ``m``, ``v`` and
    ``master`` parameter trees of numpy arrays) -> the port's: the trees in
    float32, as the reference keeps them, on ``device``; the step int32.
    Each tree's layout is checked against ``cfg`` as
    :func:`params_from_numpy` checks it."""
    trees = {}
    for field in ("m", "v", "master"):
        tree = getattr(state, field)
        _check_layout(tree, cfg)
        trees[field] = _convert(tree, lambda name: torch.float32, device)
    step = torch.tensor(int(np.asarray(state.step)), dtype=torch.int32, device=device)
    return AdamWState(step=step, **trees)
