"""Single search tree (counterpart of ``repro.core.tree``).

:class:`Tree` has the reference's fields without a batch axis.  Each
function here is the ``B = 1`` view of its batched counterpart in
:mod:`repro_torch.core.batched_tree`: the tree's buffers are lifted to
``[1, ...]`` views, so the batched functions update them **in place**, as
they do for a forest.  LeafP (:mod:`repro_torch.core.baselines`) walks
one such tree.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..envs.base import map_state
from . import batched_tree as btree
from .batched_tree import NO_NODE

State = Any

__all__ = ["NO_NODE", "Tree", "backprop_update", "best_root_action", "finalize_child",
           "get_state", "init_tree", "lift", "reserve_child", "root_action_stats"]


class Tree(NamedTuple):
    """Fixed-capacity SoA search tree (the fields of ``BatchedTree``
    without the batch axis)."""

    parent: torch.Tensor      # i64[M]     parent node index (-1 for root / free)
    action: torch.Tensor      # i64[M]     action on the edge from the parent
    children: torch.Tensor    # i64[M, A]  child index per action (-1 = untried)
    N: torch.Tensor           # f32[M]     completed-visit counts
    O: torch.Tensor           # f32[M]     in-flight visit counts
    V: torch.Tensor           # f32[M]     running mean value
    VL: torch.Tensor          # f32[M]     virtual-loss accumulator
    R: torch.Tensor           # f32[M]     reward on the edge INTO the node
    terminal: torch.Tensor    # bool[M]
    pending: torch.Tensor     # bool[M]    reserved, expansion in flight
    depth: torch.Tensor       # i64[M]
    size: torch.Tensor        # i64[]      allocated nodes
    overflowed: torch.Tensor  # bool[]     a reserve was attempted at capacity
    states: State             # NamedTuple of [M, ...] env state per node

    @property
    def capacity(self) -> int:
        return self.parent.shape[0]

    @property
    def num_actions(self) -> int:
        return self.children.shape[1]


def _field_map(fn, fields):
    return [map_state(fn, f) if isinstance(f, tuple) else fn(f) for f in fields]


def lift(tree: Tree) -> btree.BatchedTree:
    """The ``[1, ...]`` forest viewing ``tree``'s buffers (writes go through)."""
    return btree.BatchedTree(*_field_map(lambda x: x[None], tree))


def _unlift(forest: btree.BatchedTree) -> Tree:
    return Tree(*_field_map(lambda x: x[0], forest))


def _one(x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x).reshape(1)


def init_tree(root_state: State, capacity: int, num_actions: int) -> Tree:
    """Allocate a tree with ``root_state`` (leaves without a batch axis)
    installed at node 0."""
    roots = map_state(lambda x: x[None], root_state)
    return _unlift(btree.init_batched_tree(roots, capacity, num_actions))


def get_state(tree: Tree, node: torch.Tensor) -> State:
    return map_state(lambda x: x[node], tree.states)


def reserve_child(tree: Tree, parent: torch.Tensor,
                  act: torch.Tensor) -> tuple[Tree, torch.Tensor, torch.Tensor]:
    """Allocate a pending child of ``parent`` via ``act`` (in place).
    At capacity nothing is written, ``overflowed`` latches and the returned
    node is ``parent`` with ``ok=False``.  Returns ``(tree, node, ok)``."""
    p = _one(parent).to(tree.parent.device)
    _, child, ok = btree.reserve_children(lift(tree), p, _one(act).to(p.device),
                                          mask=torch.ones_like(p, dtype=torch.bool))
    return tree, child[0], ok[0]


def finalize_child(tree: Tree, idx: torch.Tensor, state: State, reward: torch.Tensor,
                   done: torch.Tensor) -> Tree:
    """Write the expansion result into a reserved child (in place)."""
    i = _one(idx).to(tree.parent.device)
    btree.finalize_children(lift(tree), i, map_state(lambda x: x[None], state),
                            _one(reward), _one(done),
                            mask=torch.ones_like(i, dtype=torch.bool))
    return tree


def backprop_update(tree: Tree, node: torch.Tensor, sim_return: torch.Tensor,
                    gamma: float) -> Tree:
    """Paper Algorithm 8 (sequential backprop; no O bookkeeping), in place."""
    btree.backprop_update(lift(tree), _one(node).to(tree.parent.device),
                          _one(sim_return).to(torch.float32), gamma)
    return tree


def root_action_stats(tree: Tree) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-action (N, V) at the root; untried actions get N=0, V=-inf."""
    n, v = btree.root_action_stats(lift(tree))
    return n[0], v[0]


def best_root_action(tree: Tree) -> torch.Tensor:
    """Most-visited root action (value tiebreak)."""
    return btree.best_root_action(lift(tree))[0]
