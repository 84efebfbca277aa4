"""The paper's baseline parallel MCTS algorithms (Sec. 4, App. B;
counterpart of ``repro.core.baselines``).

* sequential UCT   — eq. (2), one rollout at a time (the wave engine, W=1);
* LeafP  (Alg. 4)  — one selection a round, ``W`` simulations of that node;
* TreeP  (Alg. 5)  — shared tree + virtual loss ``r_VL`` (the wave engine);
* TreeP-VC (App. E) — virtual loss + virtual pseudo-count, eq. (7);
* RootP  (Alg. 6)  — ``K`` independent trees, root statistics merged.

All reuse the port's engines, so comparisons isolate the algorithm.  Every
traversal, LeafP's single tree and RootP's ``K``-tree forest alike, is one
launch of the ``tree_descend`` kernel on a GPU.
"""

from __future__ import annotations

import functools
from typing import Any, Optional

import torch

from .. import rng
from ..envs.base import Environment, map_state
from ..sync import host_any
from . import tree as tree_lib
from .batched_search import _expansion_actions, run_search_batched
from .evaluators import Evaluator, RolloutEvaluator
from .wu_uct import SearchConfig, SearchResult, run_search, traverse

State = Any


# ---------------------------------------------------------------------------
# LeafP — Algorithm 4.  One traversal per round; all W workers simulate the
# same node; each return is backed up on its own.
# ---------------------------------------------------------------------------


def _backup_each(tree: tree_lib.Tree, node: torch.Tensor, rets: torch.Tensor,
                 gamma: float) -> None:
    """Back up ``rets[0]``, ..., ``rets[W-1]`` from ``node`` (``[1]``) one
    after another (Algorithm 8 ``W`` times, in place).

    All ``W`` back-ups walk the same path, and a return's discounted sum
    ``r̄`` at each node depends only on the path's rewards, so the path is
    walked once; each node's ``N`` and ``V`` then take the ``W`` updates in
    the order ``j = 0 ... W-1``, which fixes the rounding of the running
    means as ``W`` sequential back-ups do.  One host sync reads the depth.
    """
    depth = int(tree.depth[node])
    path = [node]
    for _ in range(depth):
        path.append(tree.parent[path[-1]])
    path = torch.cat(path)                               # leaf -> root
    rewards = tree.R[path]
    r_bar = rets.to(torch.float32)
    sums = []
    for k in range(depth + 1):
        r_bar = rewards[k] + gamma * r_bar
        sums.append(r_bar)
    sums = torch.stack(sums, dim=1)                      # [W, depth + 1]
    for j in range(rets.shape[0]):
        new_n = tree.N[path] + 1.0
        tree.V[path] = ((new_n - 1.0) * tree.V[path] + sums[j]) / new_n
        tree.N[path] = new_n


def run_leafp(env: Environment, cfg: SearchConfig, root_state: State,
              rng_key: torch.Tensor,
              evaluator: Optional[Evaluator] = None) -> SearchResult:
    """LeafP from ``root_state`` (leaves without a batch axis) with key data
    ``rng_key[2]``: ``T / W`` rounds of one traversal, at most one
    expansion, ``W`` rollouts of the same node and ``W`` back-ups.  The
    expansion's branches cost a host sync each (the reference's
    ``lax.cond``)."""
    W = cfg.wave_size
    if cfg.num_simulations % W != 0:
        raise ValueError("num_simulations must be divisible by wave_size")
    num_rounds = cfg.num_simulations // W
    width = min(cfg.max_width, env.num_actions)
    evaluator = evaluator if evaluator is not None else RolloutEvaluator(env)
    tree = tree_lib.init_tree(root_state, num_rounds + 2, env.num_actions)
    forest = tree_lib.lift(tree)
    # LeafP scores with plain UCT: no in-flight statistics exist.
    cfg = cfg._replace(policy=cfg.policy._replace(kind="uct"), stat_mode="none")
    exp_cfg = cfg._replace(deterministic_expansion=False)

    key = rng_key
    for _ in range(num_rounds):
        key, k_t, k_e, k_sim = rng.split(key, 4)
        node = traverse(tree, k_t, cfg)
        n_tried = (tree.children[node] >= 0).sum()
        needs_expand = ~tree.terminal[node] & (tree.depth[node] < cfg.max_depth) & (n_tried < width)
        act = _expansion_actions(forest, node.reshape(1), k_e[None], exp_cfg)[0]
        sim_node = node
        if host_any(needs_expand):
            tree, sim_node, ok = tree_lib.reserve_child(tree, node, act)
            parent = map_state(lambda x: x[None], tree_lib.get_state(tree, node))
            child_state, r_edge, done = env.step(parent, act.reshape(1))
            if host_any(ok):
                tree_lib.finalize_child(tree, sim_node, map_state(lambda x: x[0], child_state),
                                        r_edge[0], done[0])

        # All W workers simulate the same node (LeafP's defining property).
        start = map_state(lambda x: x[sim_node].expand((W,) + tuple(x.shape[1:])).clone(),
                          tree.states)
        start_done = tree.terminal[sim_node].expand(W).clone()
        rets = evaluator.rollout(cfg, start, start_done, rng.split(k_sim, W))
        _backup_each(tree, sim_node.reshape(1), rets, cfg.gamma)

    root_n, root_v = tree_lib.root_action_stats(tree)
    dev = root_n.device
    return SearchResult(
        action=tree_lib.best_root_action(tree),
        root_n=root_n,
        root_v=root_v,
        tree_size=tree.size,
        dup_selections=torch.tensor(float(W - 1), device=dev),   # by construction
        max_o=torch.tensor(0.0, device=dev),
        overflowed=tree.overflowed,
        ticks=torch.tensor(num_rounds, device=dev),
    )


# ---------------------------------------------------------------------------
# TreeP — Algorithm 5 — is the wave engine with stat_mode='vl'.
# ---------------------------------------------------------------------------


def run_treep(env: Environment, cfg: SearchConfig, root_state: State,
              rng_key: torch.Tensor,
              evaluator: Optional[Evaluator] = None) -> SearchResult:
    if cfg.stat_mode != "vl":
        cfg = cfg._replace(stat_mode="vl", policy=cfg.policy._replace(kind="treep"))
    return run_search(env, cfg, root_state, rng_key, evaluator=evaluator)


# ---------------------------------------------------------------------------
# RootP / Ensemble-UCT — Algorithm 6.  K independent sequential-UCT trees
# over the same root (different keys), statistics merged at move time: one
# K-tree forest on the batched engine, each traversal one launch over all K.
# ---------------------------------------------------------------------------


def run_rootp(env: Environment, cfg: SearchConfig, root_state: State,
              rng_key: torch.Tensor,
              evaluator: Optional[Evaluator] = None) -> SearchResult:
    K = cfg.wave_size
    if cfg.num_simulations % K != 0:
        raise ValueError("num_simulations must be divisible by wave_size (=K)")
    sub_cfg = cfg._replace(num_simulations=cfg.num_simulations // K, wave_size=1,
                           stat_mode="none", policy=cfg.policy._replace(kind="uct"))
    roots = map_state(lambda x: x[None].expand((K,) + tuple(x.shape)).clone(), root_state)
    sub = run_search_batched(env, sub_cfg, roots, rng.split(rng_key, K),
                             evaluator=evaluator)
    n_tot = sub.root_n.sum(dim=0)
    finite_v = torch.where(torch.isfinite(sub.root_v), sub.root_v, 0.0)
    v_tot = torch.where(n_tot > 0,
                        (sub.root_n * finite_v).sum(dim=0) / torch.clamp_min(n_tot, 1e-9),
                        float("-inf"))
    return SearchResult(
        action=torch.argmax(n_tot),                   # the first maximum
        root_n=n_tot,
        root_v=v_tot,
        tree_size=sub.tree_size.sum(),
        dup_selections=torch.tensor(0.0, device=n_tot.device),
        max_o=torch.tensor(0.0, device=n_tot.device),
        overflowed=sub.overflowed.any(),
        ticks=sub.ticks.max(),
    )


ALGORITHMS = {
    "wu_uct": run_search,
    "uct": run_search,
    "leafp": run_leafp,
    "treep": run_treep,
    "treep_vc": run_search,
    "rootp": run_rootp,
}


def make_config(algorithm: str, **kw) -> SearchConfig:
    """Per-algorithm :class:`SearchConfig`, lowered through
    :class:`repro_torch.core.api.SearchSpec` (one source of truth for each
    algorithm's policy kind and stat mode)."""
    from .api import make_config as _make_config  # api imports this module

    return _make_config(algorithm, **kw)


def make_algorithm(algorithm: str, env: Environment, cfg: SearchConfig):
    """``search(root_state, rng)`` for ``algorithm``: a plain callable that
    runs where its inputs live (the reference's ``jit`` flag has no
    counterpart)."""
    return functools.partial(ALGORITHMS[algorithm], env, cfg)
