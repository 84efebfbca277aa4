"""The search cell: one WU-UCT wave step of the paper's technique on a mesh
(counterpart of ``repro.launch.search_cell``).

The master-worker split maps onto the mesh as in the reference:

* tree statistics and the master's bookkeeping (phases 1 and 3) are
  replicated: every rank runs them on the same tree and draws the same
  numbers, so they need no communication;
* the wave's in-flight slots (phase 2) split over the ``(pod, data)``
  axes: :func:`repro_torch.distributed.sharding.constrain_search_batch`
  hands each rank its slots and brings the results back to every rank;
* the rollout policy is a tap-game MLP, tensor-parallel over ``model``:
  ``w1`` split on its columns, ``b1`` and ``w2`` on their rows, each
  rank's partial logits summed by one all-reduce over ``model``.

The step is the port's batched wave engine at ``B = 1``
(``batched_search._phase1_select`` / ``_phase2_work`` /
``_phase3_settle``), whose decisions are the reference's single engine's.
On plain (unplaced) parameters the same step runs on one device, with no
hook.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from .. import rng
from ..core.api import make_config
from ..core.batched_search import _phase1_select, _phase2_work, _phase3_settle, _split_each
from ..core.batched_tree import init_batched_tree
from ..core.wu_uct import SearchConfig
from ..distributed.sharding import (
    P,
    _is_device_mesh,
    constrain_search_batch,
    is_placed,
    spec_placements,
    use_mesh,
)
from ..envs import Environment, make_tap_game
from ..envs.base import map_state

PARAM_SPECS = {"w1": P(None, "model"), "b1": P("model"), "w2": P("model", None)}


def _policy_net_env(base_env: Environment, params) -> Environment:
    """Tap env whose default policy is an MLP over observations (the role the
    distilled PPO net plays in the paper's Atari setup).  Placed parameters
    (DTensors over ``model``) run tensor-parallel on this rank's blocks;
    the observation is float32 and the product upcasts the weights, as the
    reference's type promotion does."""
    placed = is_placed(params["w1"])
    if placed:
        import torch.distributed as dist

        mesh = params["w1"].device_mesh
        group = mesh.get_group("model")
        w1, b1, w2 = (params[k].to_local() for k in ("w1", "b1", "w2"))
    else:
        w1, b1, w2 = params["w1"], params["b1"], params["w2"]

    def rollout_policy(keys: torch.Tensor, state) -> torch.Tensor:
        obs = base_env.observe(state)
        h = torch.relu(obs @ w1.float() + b1.float())
        logits = h @ w2.float()
        if placed:
            dist.all_reduce(logits, group=group)
        return rng.categorical(keys, logits).to(torch.int32)

    return Environment(
        name=base_env.name + "+mlp",
        num_actions=base_env.num_actions,
        init=base_env.init,
        step=base_env.step,
        rollout_policy=rollout_policy,
        observe=base_env.observe,
    )


class SearchCell(NamedTuple):
    fn: Callable                 # search_wave(params, tree, rng) -> tree
    arg_specs: tuple             # (params, tree, rng) as meta tensors
    in_shardings: tuple          # placements (a DeviceMesh) or specs
    out_shardings: Any
    cfg: SearchConfig
    env: Environment             # the tap game the policy plays


def build_search_cell(mesh, wave_size: int = 256, num_simulations: int = 1024,
                      d_mlp: int = 8192, dtype: torch.dtype = torch.bfloat16) -> SearchCell:
    """The cell on ``mesh`` (a ``DeviceMesh``, or an abstract mesh for its
    specs only).  ``fn(params, tree, rng)`` runs one wave on a
    ``BatchedTree`` of one tree with key data ``rng [2]`` and returns the
    tree; its parameters are ``{"w1": [obs, d_mlp], "b1": [d_mlp], "w2":
    [d_mlp, A]}``, placed by :func:`place_params` or plain."""
    base_env = make_tap_game(grid_size=6, num_colors=4, goal_count=12, step_budget=20)
    meta = torch.device("meta")
    root = base_env.init(rng.PRNGKey(0, device="cpu")[None])
    obs_dim = int(base_env.observe(root).shape[-1])
    cfg = make_config("wu_uct", num_simulations=num_simulations, wave_size=wave_size,
                      max_depth=10, max_sim_steps=20, max_width=5, gamma=1.0)

    def search_wave(params, tree, key):
        env = _policy_net_env(base_env, params)
        keys, k_sel, k_sim = _split_each(key[None], 3)
        tree, slots, _ = _phase1_select(tree, k_sel, cfg)
        if is_placed(params["w1"]):
            with use_mesh(params["w1"].device_mesh):
                out = _phase2_work(env, cfg, tree, slots, k_sim,
                                   constrain=constrain_search_batch)
        else:
            out = _phase2_work(env, cfg, tree, slots, k_sim)
        return _phase3_settle(tree, cfg, slots, *out)

    params_abs = {
        "w1": torch.empty((obs_dim, d_mlp), dtype=dtype, device=meta),
        "b1": torch.empty((d_mlp,), dtype=dtype, device=meta),
        "w2": torch.empty((d_mlp, base_env.num_actions), dtype=dtype, device=meta),
    }
    capacity = num_simulations + wave_size + 1
    tree_abs = init_batched_tree(map_state(lambda x: x.to(meta), root), capacity,
                                 base_env.num_actions)
    rng_abs = torch.empty((2,), dtype=torch.int64, device=meta)

    if _is_device_mesh(mesh):
        pshard = {k: spec_placements(s, mesh) for k, s in PARAM_SPECS.items()}
        replicated = spec_placements(P(), mesh)
    else:
        pshard, replicated = dict(PARAM_SPECS), P()
    tshard = type(tree_abs)(*(type(f)(*(replicated for _ in f)) if isinstance(f, tuple)
                              else replicated for f in tree_abs))
    return SearchCell(fn=search_wave, arg_specs=(params_abs, tree_abs, rng_abs),
                      in_shardings=(pshard, tshard, replicated), out_shardings=tshard,
                      cfg=cfg, env=base_env)


def place_params(params: dict, mesh) -> dict:
    """The policy parameters (whole on every rank) placed on ``mesh`` as
    :data:`PARAM_SPECS` says."""
    from ..distributed.sharding import distribute_params

    return distribute_params(params, PARAM_SPECS, mesh)
