"""Plain PyTorch versions of the tree-selection kernels.

:func:`tree_select_ref` scores one level: the same math as the CUDA kernel
(``csrc/tree_select.cu``) and as the reference's ``_scores``
(``repro/kernels/tree_select/tree_select.py``), in the same float32 order
of operations.  :func:`tree_descend_ref` is the whole walk from the root:
the reference's lockstep ``traverse_batched`` loop, one
:func:`tree_select_ref` per level.  ``sqrt`` is taken in float64 and
rounded, which is the correctly rounded float32 square root that XLA and
CUDA's ``sqrtf`` give (PyTorch's vectorised CPU ``sqrt`` is not always
correctly rounded).  ``log`` is float32 ``torch.log``, which can differ
from XLA's in the last bit, so actions agree with the reference except
at near-ties.

The wrapper in :mod:`.ops` calls this for CPU tensors; it runs on any
device, which is how ``chip_smoke.py`` compares the kernel with it.
"""

from __future__ import annotations

import torch

from ... import rng
from ...sync import host_any

NEG_INF = -1e30
KINDS = ("wu_uct", "uct", "treep", "treep_vc")


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _explore(log_term, denom, beta):
    explore = beta * _sqrt(2.0 * log_term / torch.clamp_min(denom, 1e-9))
    return torch.where(denom > 0, explore, float("inf"))


def tree_select_scores(n_c, o_c, v_c, n_p, o_p, valid, vl_c=None, *,
                       kind: str = "wu_uct", beta: float = 1.0,
                       r_vl: float = 1.0, n_vl: float = 1.0) -> torch.Tensor:
    """Masked per-child scores ``f32[B, A]``: invalid -> -1e30, unvisited
    -> +inf."""
    n_p = n_p[:, None]
    o_p = o_p[:, None]
    if kind == "wu_uct":
        log_term = torch.log(torch.clamp_min(n_p + o_p, 1.0))
        score = v_c + _explore(log_term, n_c + o_c, beta)
    elif kind in ("uct", "treep"):
        log_term = torch.log(torch.clamp_min(n_p, 1.0))
        value = v_c if kind == "uct" else (
            v_c - (torch.zeros_like(v_c) if vl_c is None else vl_c))
        score = value + _explore(log_term, n_c, beta)
    elif kind == "treep_vc":
        c = o_c
        denom = n_c + c * n_vl
        v_adj = (n_c * v_c - c * r_vl) / torch.clamp_min(denom, 1e-9)
        log_term = torch.log(torch.clamp_min(n_p + o_p, 1.0))
        score = v_adj + _explore(log_term, denom, beta)
    else:
        raise ValueError(f"unknown policy kind: {kind!r}; expected one of {KINDS}")
    return torch.where(valid, score, NEG_INF)


def tree_select_ref(n_c, o_c, v_c, n_p, o_p, valid, vl_c=None, *,
                    kind: str = "wu_uct", beta: float = 1.0,
                    r_vl: float = 1.0, n_vl: float = 1.0):
    """``(act i32[B], best f32[B])``: the first child with the best score."""
    score = tree_select_scores(n_c, o_c, v_c, n_p, o_p, valid, vl_c,
                               kind=kind, beta=beta, r_vl=r_vl, n_vl=n_vl)
    best, act = torch.max(score, dim=1)
    return act.to(torch.int32), best


def children_tables(children, N, O, V, VL, pending, nodes):
    """Dense ``[B, A]`` child-statistics tables at ``nodes`` (one per tree).

    ``children i64[B, M, A]``, ``N, O, V, VL f32[B, M]``, ``pending
    bool[B, M]``.  Untried children (``-1``) read node 0 through a clamped
    index and are masked out by ``valid``; pending children are invalid
    too.  Returns ``(n_c, o_c, v_c, vl_c, n_p, o_p, valid)`` with shapes
    ``[B, A] x 4, [B] x 2, [B, A]``.
    """
    b = torch.arange(nodes.shape[0], device=nodes.device)
    kids = children[b, nodes]                        # i64[B, A]
    safe = kids.clamp_min(0)
    b2 = b[:, None]
    valid = (kids >= 0) & ~pending[b2, safe]
    return (N[b2, safe], O[b2, safe], V[b2, safe], VL[b2, safe],
            N[b, nodes], O[b, nodes], valid)


def tree_descend_ref(children, N, O, V, VL, pending, terminal, depth, rngs, *,
                     width: int, max_depth: int, expand_coin: float = 0.5,
                     kind: str = "wu_uct", beta: float = 1.0, r_vl: float = 1.0,
                     n_vl: float = 1.0) -> torch.Tensor:
    """Stop node ``i64[B]`` of a walk down each of ``B`` trees from the root.

    All ``B`` rows walk in lockstep, one level per pass: split the row's
    key into the next key and a coin key; stop at a leaf, at ``max_depth``,
    at a terminal node, at a node with fewer than ``width`` tried children
    when ``uniform(coin key) < expand_coin``, or where no child is valid;
    else step to the best child.  A stopped row keeps its node and key.
    The loop asks the device once per level whether any row still walks.
    """
    B = children.shape[0]
    b = torch.arange(B, device=rngs.device)
    nodes = torch.zeros((B,), dtype=torch.int64, device=rngs.device)
    stopped = torch.zeros((B,), dtype=torch.bool, device=rngs.device)
    while True:  # every tree is active at the start: the body runs once
        active = ~stopped
        keys = rng.split(rngs, 2)
        new_rng, k_coin = keys[:, 0], keys[:, 1]
        rngs = torch.where(active[:, None], new_rng, rngs)

        kids = children[b, nodes]                            # [B, A]
        n_tried = (kids >= 0).sum(dim=1)
        is_leaf = n_tried == 0
        at_depth = depth[b, nodes] >= max_depth
        is_term = terminal[b, nodes]
        not_full = n_tried < width
        coin = rng.uniform(k_coin) < expand_coin
        stop = is_leaf | at_depth | is_term | (not_full & coin)

        n_c, o_c, v_c, vl_c, n_p, o_p, valid = children_tables(
            children, N, O, V, VL, pending, nodes)
        best, _ = tree_select_ref(n_c, o_c, v_c, n_p, o_p, valid, vl_c, kind=kind,
                                  beta=beta, r_vl=r_vl, n_vl=n_vl)
        stop = stop | ~valid.any(dim=1)
        nxt = torch.where(stop, nodes, kids.gather(1, best.to(torch.int64)[:, None])[:, 0])
        nodes = torch.where(active, nxt, nodes)
        stopped = stopped | stop
        if not host_any(~stopped):
            return nodes
