"""Batched multi-root WU-UCT: ``B`` independent searches in lockstep
(counterpart of ``repro.core.batched_search``).

* the forest is a :class:`repro_torch.core.batched_tree.BatchedTree`;
* per traversal level, the child statistics of all ``B`` current nodes are
  gathered into dense ``[B, A]`` tables and scored by **one** call of the
  ``tree_select`` kernel (the hand-written CUDA kernel on a GPU);
* random streams are carried per tree and split exactly as the reference
  splits them (:mod:`repro_torch.rng`), so with the same keys this engine
  makes the reference's decisions, up to float32 ``log`` differences at
  near-ties.

Host syncs: the traversal asks the device once per level whether any tree
is still walking; the path walks once per level plus once; rollouts once
per step; the flood fill of the tap game once per four dilations.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from .. import rng
from ..envs.base import Environment, map_state, where_state
from ..kernels.tree_select.ops import tree_select
from ..sync import host_any
from . import batched_tree as btree
from .batched_tree import BatchedTree, init_batched_tree
from .evaluators import Evaluator, RolloutEvaluator
from .policies import PolicyConfig, gather_children_tables
from .wu_uct import KIND_EXPAND, KIND_SIM, KIND_TERMINAL, SearchConfig, SearchResult

State = Any


class _BatchedSlots(NamedTuple):
    kind: torch.Tensor       # i64[B, W]
    stop_node: torch.Tensor  # i64[B, W]
    sim_node: torch.Tensor   # i64[B, W]
    act: torch.Tensor        # i64[B, W]


def _split_each(rngs: torch.Tensor, num: int) -> tuple[torch.Tensor, ...]:
    """Per-tree ``split(rng, num)``: ``num`` key arrays ``[B, 2]``."""
    ks = rng.split(rngs, num)
    return tuple(ks[:, i] for i in range(num))


def batched_select(tree: BatchedTree, nodes: torch.Tensor,
                   pol: PolicyConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Best child action of each tree's current node via one ``[B, A]``
    ``tree_select`` call.  Returns ``(act i64[B], any_valid bool[B])``."""
    n_c, o_c, v_c, vl_c, n_p, o_p, valid = gather_children_tables(tree, nodes)
    act, _ = tree_select(
        n_c, o_c, v_c, n_p, o_p, valid, vl_c,
        kind=pol.kind, beta=pol.beta, r_vl=pol.r_vl, n_vl=pol.n_vl,
    )
    return act.to(torch.int64), valid.any(dim=1)


# ---------------------------------------------------------------------------
# Selection — all B trees traverse in lockstep; one kernel call per level.
# ---------------------------------------------------------------------------


def traverse_batched(tree: BatchedTree, rngs: torch.Tensor,
                     cfg: SearchConfig) -> torch.Tensor:
    """Walk every tree from its root by the configured tree policy;
    returns the stop node of each tree (``i64[B]``)."""
    width = min(cfg.max_width, tree.num_actions)
    b = torch.arange(tree.batch_size, device=rngs.device)
    nodes = torch.zeros((tree.batch_size,), dtype=torch.int64, device=rngs.device)
    stopped = torch.zeros((tree.batch_size,), dtype=torch.bool, device=rngs.device)
    while True:  # every tree is active at the start: the body runs once
        active = ~stopped
        new_rng, k_coin = _split_each(rngs, 2)
        rngs = torch.where(active[:, None], new_rng, rngs)

        kids = tree.children[b, nodes]                       # [B, A]
        n_tried = (kids >= 0).sum(dim=1)
        is_leaf = n_tried == 0
        at_depth = tree.depth[b, nodes] >= cfg.max_depth
        is_term = tree.terminal[b, nodes]
        not_full = n_tried < width
        coin = rng.uniform(k_coin) < cfg.expand_coin
        stop = is_leaf | at_depth | is_term | (not_full & coin)

        best, any_valid = batched_select(tree, nodes, cfg.policy)
        stop = stop | ~any_valid
        nxt = torch.where(stop, nodes, kids.gather(1, best[:, None])[:, 0])
        nodes = torch.where(active, nxt, nodes)
        stopped = stopped | stop
        if not host_any(~stopped):
            return nodes


def _expansion_actions(tree: BatchedTree, nodes: torch.Tensor, rngs: torch.Tensor,
                       cfg: SearchConfig) -> torch.Tensor:
    """Per-tree untried-action choice (Algorithm 7, uniform prior)."""
    b = torch.arange(tree.batch_size, device=nodes.device)
    kids = tree.children[b, nodes]
    if cfg.deterministic_expansion:
        return torch.argmax((kids < 0).to(torch.uint8), dim=1)
    logits = torch.where(kids >= 0, float("-inf"), 0.0)
    g = rng.gumbel(rngs, (tree.num_actions,))
    return torch.argmax(logits + g, dim=1)


def _mark_in_flight(tree, nodes, cfg: SearchConfig, mask):
    return btree.mark_in_flight(
        tree, nodes, mask, stat_mode=cfg.stat_mode, r_vl=cfg.policy.r_vl
    )


def _settle(tree, nodes, rets, cfg: SearchConfig, mask):
    return btree.settle(
        tree, nodes, rets, mask,
        stat_mode=cfg.stat_mode, gamma=cfg.gamma, r_vl=cfg.policy.r_vl,
    )


# ---------------------------------------------------------------------------
# Wave phases
# ---------------------------------------------------------------------------


def _phase1_select(tree: BatchedTree, rngs: torch.Tensor,
                   cfg: SearchConfig) -> tuple[BatchedTree, _BatchedSlots, torch.Tensor]:
    """Select W slots per tree one after another, with in-flight statistics
    in between; all B trees fill slot j together."""
    B, W = tree.batch_size, cfg.wave_size
    width = min(cfg.max_width, tree.num_actions)
    device = rngs.device
    b = torch.arange(B, device=device)
    cols = {f: torch.zeros((B, W), dtype=torch.int64, device=device)
            for f in _BatchedSlots._fields}
    for j in range(W):
        rngs, k_t, k_e = _split_each(rngs, 3)
        nodes = traverse_batched(tree, k_t, cfg)

        kids = tree.children[b, nodes]
        n_tried = (kids >= 0).sum(dim=1)
        is_term = tree.terminal[b, nodes]
        at_depth = tree.depth[b, nodes] >= cfg.max_depth
        needs_expand = ~is_term & ~at_depth & (n_tried < width)
        act = _expansion_actions(tree, nodes, k_e, cfg)

        tree, child, expanded = btree.reserve_children(tree, nodes, act, mask=needs_expand)
        kind = torch.where(
            is_term, KIND_TERMINAL,
            torch.where(expanded, KIND_EXPAND, KIND_SIM),
        )
        sim_node = torch.where(expanded, child, nodes)

        # Incomplete update as soon as the rollout is initiated (Alg. 1);
        # terminal hits settle immediately with return 0.
        tree = _mark_in_flight(tree, sim_node, cfg, mask=torch.ones_like(is_term))
        tree = _settle(tree, sim_node, torch.zeros((B,), dtype=torch.float32, device=device),
                       cfg, mask=is_term)

        cols["kind"][:, j] = kind
        cols["stop_node"][:, j] = nodes
        cols["sim_node"][:, j] = sim_node
        cols["act"][:, j] = act
    slots = _BatchedSlots(**cols)

    sorted_stops = torch.sort(slots.stop_node, dim=1).values
    dups = (sorted_stops[:, 1:] == sorted_stops[:, :-1]).to(torch.float32).sum(dim=1)
    return tree, slots, dups


def _phase2_work(env: Environment, cfg: SearchConfig, tree: BatchedTree,
                 slots: _BatchedSlots, rngs: torch.Tensor,
                 evaluator: Optional[Evaluator] = None):
    """Expansion env-step + simulation rollout for all B × W slots at once,
    flattened to one ``[B·W]`` batch."""
    B, W = tree.batch_size, cfg.wave_size
    evaluator = evaluator if evaluator is not None else RolloutEvaluator(env)
    keys = rng.split(rngs, W).reshape(B * W, 2)
    b = torch.arange(B, device=rngs.device)[:, None]

    def at(nodes):
        return map_state(lambda x: x[b, nodes].flatten(0, 1), tree.states)

    child_state, r_edge, done_child = env.step(at(slots.stop_node),
                                               slots.act.flatten())
    is_exp = slots.kind.flatten() == KIND_EXPAND
    start_state = where_state(is_exp, child_state, at(slots.sim_node))
    start_done = torch.where(is_exp, done_child, tree.terminal[b, slots.sim_node].flatten())
    rets = evaluator.rollout(cfg, start_state, start_done, keys)

    def unflat(x):
        return x.reshape((B, W) + tuple(x.shape[1:]))

    return (map_state(unflat, child_state), unflat(r_edge), unflat(done_child),
            unflat(rets))


def _phase3_settle(tree: BatchedTree, cfg: SearchConfig, slots: _BatchedSlots,
                   child_states: State, r_edge: torch.Tensor,
                   done_child: torch.Tensor, rets: torch.Tensor) -> BatchedTree:
    """Master-side completion: write expansion results + complete updates."""
    for j in range(cfg.wave_size):
        kind = slots.kind[:, j]
        sim_node = slots.sim_node[:, j]
        st = map_state(lambda x: x[:, j], child_states)
        tree = btree.finalize_children(
            tree, sim_node, st, r_edge[:, j], done_child[:, j],
            mask=kind == KIND_EXPAND,
        )
        tree = _settle(tree, sim_node, rets[:, j], cfg, mask=kind != KIND_TERMINAL)
    return tree


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


def run_search_batched(env: Environment, cfg: SearchConfig, root_states: State,
                       rngs: torch.Tensor,
                       evaluator: Optional[Evaluator] = None) -> SearchResult:
    """Run ``B`` independent searches; every field of the returned
    :class:`SearchResult` carries a leading ``[B]`` axis.

    ``root_states`` leaves lead with ``[B]``; ``rngs`` is key data
    ``[B, 2]`` (e.g. ``rng.split(key, B)``), one stream per tree.  Runs on
    the device the inputs are on.
    """
    if cfg.num_simulations % cfg.wave_size != 0:
        raise ValueError("num_simulations must be divisible by wave_size")
    num_waves = cfg.num_simulations // cfg.wave_size
    capacity = cfg.num_simulations + cfg.wave_size + 1
    B = rngs.shape[0]
    tree = init_batched_tree(root_states, capacity, env.num_actions)
    dup_acc = torch.zeros((B,), dtype=torch.float32, device=rngs.device)
    max_o = torch.zeros((B,), dtype=torch.float32, device=rngs.device)

    for _ in range(num_waves):
        rngs, k_sel, k_sim = _split_each(rngs, 3)
        tree, slots, dups = _phase1_select(tree, k_sel, cfg)
        max_o = torch.maximum(max_o, tree.O[:, 0])
        child_states, r_edge, done_child, rets = _phase2_work(
            env, cfg, tree, slots, k_sim, evaluator
        )
        tree = _phase3_settle(tree, cfg, slots, child_states, r_edge, done_child, rets)
        dup_acc = dup_acc + dups

    root_n, root_v = btree.root_action_stats(tree)
    return SearchResult(
        action=btree.best_root_action(tree),
        root_n=root_n,
        root_v=root_v,
        tree_size=tree.size,
        dup_selections=dup_acc / num_waves,
        max_o=max_o,
        overflowed=tree.overflowed,
        ticks=torch.full((B,), num_waves, dtype=torch.int64, device=rngs.device),
    )
