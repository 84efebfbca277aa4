"""Batched structure-of-arrays search forest: ``B`` independent trees
(counterpart of ``repro.core.batched_tree``).

Every buffer carries a leading ``[B, ...]`` axis.  Index buffers are
``int64`` (PyTorch's index type); statistics are ``float32`` as in the
reference.  The functions here **update the tree's buffers in place** and
return the same tree, which saves a copy of every buffer per update; the
values written equal the reference's.

Path walks climb all ``B`` parent chains in lockstep.  Each level asks the
device whether any chain is still climbing (:func:`repro_torch.sync.host_any`),
so a walk from nodes of depth ``d`` costs ``d + 2`` host syncs.  A caller
masks a tree out of a walk by passing ``NO_NODE`` as its start node.

Indices are clamped explicitly wherever the reference relies on JAX's
clamped gathers (a ``NO_NODE`` index reads node 0 and writes nothing).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..envs.base import map_state, where_state
from ..sync import host_any

NO_NODE = -1

State = Any


class BatchedTree(NamedTuple):
    """Fixed-capacity SoA forest of ``B`` trees."""

    parent: torch.Tensor      # i64[B, M]
    action: torch.Tensor      # i64[B, M]
    children: torch.Tensor    # i64[B, M, A]
    N: torch.Tensor           # f32[B, M]    completed-visit counts
    O: torch.Tensor           # f32[B, M]    in-flight visit counts
    V: torch.Tensor           # f32[B, M]    running mean value
    VL: torch.Tensor          # f32[B, M]    virtual-loss accumulator
    R: torch.Tensor           # f32[B, M]    reward on the edge INTO the node
    terminal: torch.Tensor    # bool[B, M]
    pending: torch.Tensor     # bool[B, M]
    depth: torch.Tensor       # i64[B, M]
    size: torch.Tensor        # i64[B]       allocated nodes per tree
    overflowed: torch.Tensor  # bool[B]      reserve attempted at capacity
    states: State             # NamedTuple of [B, M, ...] env state per node

    @property
    def batch_size(self) -> int:
        return self.parent.shape[0]

    @property
    def capacity(self) -> int:
        return self.parent.shape[1]

    @property
    def num_actions(self) -> int:
        return self.children.shape[2]


def _bidx(tree: BatchedTree) -> torch.Tensor:
    return torch.arange(tree.batch_size, device=tree.parent.device)


def init_batched_tree(root_states: State, capacity: int, num_actions: int) -> BatchedTree:
    """Allocate ``B`` trees; ``root_states`` leaves carry a leading [B]."""
    leaf = root_states[0]
    batch, device = leaf.shape[0], leaf.device

    def buffer(x):
        buf = torch.zeros((batch, capacity) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=device)
        buf[:, 0] = x
        return buf

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    return BatchedTree(
        parent=full((batch, capacity), NO_NODE, torch.int64),
        action=full((batch, capacity), NO_NODE, torch.int64),
        children=full((batch, capacity, num_actions), NO_NODE, torch.int64),
        N=full((batch, capacity), 0.0, torch.float32),
        O=full((batch, capacity), 0.0, torch.float32),
        V=full((batch, capacity), 0.0, torch.float32),
        VL=full((batch, capacity), 0.0, torch.float32),
        R=full((batch, capacity), 0.0, torch.float32),
        terminal=full((batch, capacity), False, torch.bool),
        pending=full((batch, capacity), False, torch.bool),
        depth=full((batch, capacity), 0, torch.int64),
        size=full((batch,), 1, torch.int64),
        overflowed=full((batch,), False, torch.bool),
        states=map_state(buffer, root_states),
    )


def get_state(tree: BatchedTree, nodes: torch.Tensor) -> State:
    """Per-tree node states; ``nodes`` is i64[B] -> state[B, ...]."""
    b = _bidx(tree)
    return map_state(lambda x: x[b, nodes], tree.states)


def set_state(tree: BatchedTree, nodes: torch.Tensor, state: State,
              mask: torch.Tensor) -> BatchedTree:
    """Write ``state`` (leading [B]) at ``nodes`` where ``mask`` holds
    (in place)."""
    b = _bidx(tree)
    kept = where_state(mask, state, get_state(tree, nodes))
    for buf, x in zip(tree.states, kept):
        buf[b, nodes] = x
    return tree


# ---------------------------------------------------------------------------
# Lockstep path walks (in place).
# ---------------------------------------------------------------------------


def incomplete_update(tree: BatchedTree, nodes: torch.Tensor) -> BatchedTree:
    """Algorithm 2, vectorized: ``O += 1`` along every tree's path."""
    b = _bidx(tree)
    n = nodes
    while host_any(n != NO_NODE):
        active = n != NO_NODE
        safe = n.clamp_min(0)
        tree.O.index_put_((b, safe), active.to(torch.float32), accumulate=True)
        n = torch.where(active, tree.parent[b, safe], NO_NODE)
    return tree


def _mean_update(tree: BatchedTree, nodes: torch.Tensor, sim_returns: torch.Tensor,
                 gamma: float, track_o: bool) -> BatchedTree:
    """Algorithm 3 (``track_o``) or Algorithm 8: ``N += 1``,
    ``r̄ <- R + gamma * r̄``, ``V <- running mean`` from leaf to root."""
    b = _bidx(tree)
    n = nodes
    r_bar = sim_returns.to(torch.float32)
    while host_any(n != NO_NODE):
        active = n != NO_NODE
        safe = n.clamp_min(0)
        old_n = tree.N[b, safe]
        new_n = old_n + 1.0
        new_r = tree.R[b, safe] + gamma * r_bar
        old_v = tree.V[b, safe]
        new_v = ((new_n - 1.0) * old_v + new_r) / new_n
        tree.N[b, safe] = torch.where(active, new_n, old_n)
        if track_o:
            tree.O.index_put_((b, safe), torch.where(active, -1.0, 0.0),
                              accumulate=True)
        tree.V[b, safe] = torch.where(active, new_v, old_v)
        r_bar = torch.where(active, new_r, r_bar)
        n = torch.where(active, tree.parent[b, safe], NO_NODE)
    return tree


def complete_update(tree: BatchedTree, nodes: torch.Tensor,
                    sim_returns: torch.Tensor, gamma: float) -> BatchedTree:
    """Algorithm 3, vectorized: ``N+=1; O-=1; r̄<-R+γ·r̄; V<-mean`` leaf->root."""
    return _mean_update(tree, nodes, sim_returns, gamma, track_o=True)


def backprop_update(tree: BatchedTree, nodes: torch.Tensor,
                    sim_returns: torch.Tensor, gamma: float) -> BatchedTree:
    """Algorithm 8, vectorized (sequential backprop; no O bookkeeping)."""
    return _mean_update(tree, nodes, sim_returns, gamma, track_o=False)


def _shift_virtual_loss(tree: BatchedTree, nodes: torch.Tensor,
                        delta: float) -> BatchedTree:
    b = _bidx(tree)
    n = nodes
    while host_any(n != NO_NODE):
        active = n != NO_NODE
        safe = n.clamp_min(0)
        tree.VL.index_put_((b, safe), torch.where(active, delta, 0.0),
                           accumulate=True)
        n = torch.where(active, tree.parent[b, safe], NO_NODE)
    return tree


def add_virtual_loss(tree: BatchedTree, nodes: torch.Tensor, r_vl: float) -> BatchedTree:
    return _shift_virtual_loss(tree, nodes, r_vl)


def remove_virtual_loss(tree: BatchedTree, nodes: torch.Tensor, r_vl: float) -> BatchedTree:
    return _shift_virtual_loss(tree, nodes, -r_vl)


# ---------------------------------------------------------------------------
# Masked stat-mode dispatch.
# ---------------------------------------------------------------------------


def mark_in_flight(tree: BatchedTree, nodes: torch.Tensor, mask: torch.Tensor, *,
                   stat_mode: str, r_vl: float) -> BatchedTree:
    """Rollout-initiated bookkeeping at ``nodes`` where ``mask`` holds:
    Algorithm 2 (``'wu'``), virtual loss (``'vl'``) or nothing (``'none'``)."""
    targets = torch.where(mask, nodes, NO_NODE)
    if stat_mode == "wu":
        return incomplete_update(tree, targets)
    if stat_mode == "vl":
        return add_virtual_loss(tree, targets, r_vl)
    return tree


def settle(tree: BatchedTree, nodes: torch.Tensor, rets: torch.Tensor,
           mask: torch.Tensor, *, stat_mode: str, gamma: float,
           r_vl: float) -> BatchedTree:
    """Rollout-completed bookkeeping where ``mask`` holds: Algorithm 3
    (``'wu'``), virtual-loss removal + backprop (``'vl'``) or backprop."""
    targets = torch.where(mask, nodes, NO_NODE)
    if stat_mode == "wu":
        return complete_update(tree, targets, rets, gamma)
    if stat_mode == "vl":
        tree = remove_virtual_loss(tree, targets, r_vl)
    return backprop_update(tree, targets, rets, gamma)


# ---------------------------------------------------------------------------
# Allocation (in place).
# ---------------------------------------------------------------------------


def reserve_children(tree: BatchedTree, parents: torch.Tensor, acts: torch.Tensor,
                     mask: torch.Tensor) -> tuple[BatchedTree, torch.Tensor, torch.Tensor]:
    """Allocate a pending child of ``parents`` via ``acts`` where ``mask``
    holds.

    Returns ``(tree, child_nodes[B], ok[B])``; trees at capacity refuse the
    reservation (``ok=False``, child = parent) and latch ``overflowed``.
    """
    b = _bidx(tree)
    has_room = tree.size < tree.capacity
    ok = mask & has_room
    idx = tree.size.clamp_max(tree.capacity - 1)

    def keep(buf, new):
        buf[b, idx] = torch.where(ok, new, buf[b, idx])

    new_depth = tree.depth[b, parents] + 1
    keep(tree.parent, parents)
    keep(tree.action, acts)
    tree.children[b, parents, acts] = torch.where(ok, idx, tree.children[b, parents, acts])
    keep(tree.pending, torch.ones_like(ok))
    keep(tree.depth, new_depth)
    tree.size.add_(ok.to(torch.int64))
    tree.overflowed.logical_or_(mask & ~has_room)
    return tree, torch.where(ok, idx, parents), ok


def finalize_children(tree: BatchedTree, nodes: torch.Tensor, states: State,
                      rewards: torch.Tensor, dones: torch.Tensor,
                      mask: torch.Tensor) -> BatchedTree:
    """Write expansion results into reserved children where ``mask`` holds
    (in place)."""
    b = _bidx(tree)
    set_state(tree, nodes, states, mask)

    def keep(buf, new):
        buf[b, nodes] = torch.where(mask, new, buf[b, nodes])

    keep(tree.R, rewards)
    keep(tree.terminal, dones)
    keep(tree.pending, torch.zeros_like(mask))
    return tree


# ---------------------------------------------------------------------------
# Root statistics
# ---------------------------------------------------------------------------


def root_action_stats(tree: BatchedTree) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tree per-action (N, V) at the root; untried get N=0, V=-inf."""
    kids = tree.children[:, 0]
    valid = kids >= 0
    safe = kids.clamp_min(0)
    b = _bidx(tree)[:, None]
    n = torch.where(valid, tree.N[b, safe], 0.0)
    v = torch.where(valid, tree.V[b, safe], float("-inf"))
    return n, v


def best_root_action(tree: BatchedTree) -> torch.Tensor:
    """Most-visited root action per tree (value tiebreak)."""
    n, v = root_action_stats(tree)
    x = torch.where(torch.isfinite(v), v, -1e9)
    e = torch.exp(x - x.max(dim=-1, keepdim=True).values)
    v_rank = e / e.sum(dim=-1, keepdim=True)
    return torch.argmax(n + 1e-6 * v_rank, dim=-1)
