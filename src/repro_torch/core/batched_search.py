"""Batched multi-root WU-UCT: ``B`` independent searches in lockstep
(counterpart of ``repro.core.batched_search``).

* the forest is a :class:`repro_torch.core.batched_tree.BatchedTree`;
* a traversal is **one** call of ``tree_descend``: on a GPU one launch of
  the hand-written kernel walks every tree from its root to its stop node,
  the coin's threefry draws and the child scoring of every level included;
  on the CPU its plain version walks all ``B`` trees in lockstep, one
  ``[B, A]`` scoring per level, as the reference's ``while_loop`` does;
* random streams are carried per tree and split exactly as the reference
  splits them (:mod:`repro_torch.rng`), so with the same keys this engine
  makes the reference's decisions, up to float32 ``log`` differences at
  near-ties.

Host syncs: on the CPU the traversal asks once per level whether any tree
is still walking (on a GPU it asks nothing); the path walks once per level
plus once; rollouts once per step; the flood fill of the tap game once per
four dilations.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple, Optional

import torch

from .. import rng
from ..envs.base import Environment, map_state, where_state
from ..kernels.tree_select.ops import tree_descend, tree_select
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
# Selection — one descent per traversal: a single kernel launch on a GPU.
# ---------------------------------------------------------------------------


def walk_inputs(tree: BatchedTree, cfg: SearchConfig):
    """``(tensors, params)`` of ``tree_descend`` for ``tree`` under the
    search config ``cfg``; the keys come between them."""
    pol = cfg.policy
    tensors = (tree.children, tree.N, tree.O, tree.V, tree.VL, tree.pending,
               tree.terminal, tree.depth)
    params = dict(width=min(cfg.max_width, tree.num_actions), max_depth=cfg.max_depth,
                  expand_coin=cfg.expand_coin, kind=pol.kind, beta=pol.beta,
                  r_vl=pol.r_vl, n_vl=pol.n_vl)
    return tensors, params


def traverse_batched(tree: BatchedTree, rngs: torch.Tensor,
                     cfg: SearchConfig) -> torch.Tensor:
    """Walk every tree from its root by the configured tree policy;
    returns the stop node of each tree (``i64[B]``)."""
    tensors, params = walk_inputs(tree, cfg)
    return tree_descend(*tensors, rngs, **params)


def mid_search_trees(env: Environment, cfg: SearchConfig, root_states: State,
                     rngs: torch.Tensor, waves: int) -> list[BatchedTree]:
    """The forests a batched wave search walks, as test and timing inputs of
    :func:`traverse_batched`: for ``w = 0 .. waves``, a copy of the forest
    after ``w`` waves and the selection phase of the next, whose
    expansions stay pending (visits, in-flight counts, pending children)."""
    tree = init_batched_tree(root_states, cfg.num_simulations + cfg.wave_size + 1,
                             env.num_actions)
    out = []
    for w in range(waves + 1):
        rngs, k_sel, k_sim = _split_each(rngs, 3)
        tree, slots, _ = _phase1_select(tree, k_sel, cfg)
        out.append(tree._replace(states=map_state(torch.clone, tree.states), **{
            f: getattr(tree, f).clone() for f in tree._fields if f != "states"}))
        if w < waves:
            out_w = _phase2_work(env, cfg, tree, slots, k_sim)
            tree = _phase3_settle(tree, cfg, slots, *out_w)
    return out


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


def _slot_work(env: Environment, cfg: SearchConfig, evaluator: Evaluator, parent_state,
               sim_state, sim_done, kind, act, keys):
    """The parallel part over a flat batch of slots: the expansion env-step
    from each slot's parent, then the simulation rollout from its child
    (expansions) or its node."""
    child_state, r_edge, done_child = env.step(parent_state, act)
    is_exp = kind == KIND_EXPAND
    start_state = where_state(is_exp, child_state, sim_state)
    start_done = torch.where(is_exp, done_child, sim_done)
    rets = evaluator.rollout(cfg, start_state, start_done, keys)
    return child_state, r_edge, done_child, rets


def _phase2_work(env: Environment, cfg: SearchConfig, tree: BatchedTree,
                 slots: _BatchedSlots, rngs: torch.Tensor,
                 evaluator: Optional[Evaluator] = None,
                 constrain: Optional[Callable[[Any], Any]] = None):
    """Expansion env-step + simulation rollout for all B × W slots at once,
    flattened to one ``[B·W]`` batch.

    The master gathers each slot's states from the (replicated) forest;
    ``constrain`` (e.g. ``repro_torch.distributed.sharding.
    constrain_search_batch``) is applied to the slot batch and to the
    results, as the reference applies its sharding constraint: under a
    mesh each rank then runs the rollouts of its own slots
    (``local_apply``) and the results come back to every rank."""
    B, W = tree.batch_size, cfg.wave_size
    evaluator = evaluator if evaluator is not None else RolloutEvaluator(env)
    keys = rng.split(rngs, W).reshape(B * W, 2)
    b = torch.arange(B, device=rngs.device)[:, None]

    def at(nodes):
        return map_state(lambda x: x[b, nodes].flatten(0, 1), tree.states)

    args = (at(slots.stop_node), at(slots.sim_node),
            tree.terminal[b, slots.sim_node].flatten(), slots.kind.flatten(),
            slots.act.flatten(), keys)
    work = functools.partial(_slot_work, env, cfg, evaluator)
    if constrain is None:
        out = work(*args)
    else:
        from ..distributed.sharding import local_apply

        out = constrain(local_apply(work, constrain(args)))
    child_state, r_edge, done_child, rets = out

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
                       evaluator: Optional[Evaluator] = None,
                       constrain: Optional[Callable[[Any], Any]] = None) -> SearchResult:
    """Run ``B`` independent searches; every field of the returned
    :class:`SearchResult` carries a leading ``[B]`` axis.

    ``root_states`` leaves lead with ``[B]``; ``rngs`` is key data
    ``[B, 2]`` (e.g. ``rng.split(key, B)``), one stream per tree.  Runs on
    the device the inputs are on.  ``constrain`` is phase 2's hook
    (:func:`_phase2_work`).
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
            env, cfg, tree, slots, k_sim, evaluator, constrain
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
