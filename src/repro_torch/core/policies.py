"""Tree (node-selection) policies (counterpart of ``repro.core.policies``).

The four selection rules of the paper — ``uct`` (eq. 2), ``wu_uct``
(eq. 4), ``treep`` (V − VL) and ``treep_vc`` (eq. 7) — are scored by the
``tree_select`` kernel (:mod:`repro_torch.kernels.tree_select`); this
module holds their configuration and the gather that feeds the kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PolicyConfig(NamedTuple):
    kind: str = "wu_uct"   # uct | wu_uct | treep | treep_vc
    beta: float = 1.0      # exploration constant (paper: β)
    r_vl: float = 1.0      # TreeP virtual loss
    n_vl: float = 1.0      # TreeP virtual pseudo-count (eq. 7)


def gather_children_tables(tree, nodes: torch.Tensor):
    """Dense [B, A] children-statistics tables at ``nodes`` (one per tree).

    ``tree`` is a :class:`repro_torch.core.batched_tree.BatchedTree`.
    Untried children (``-1``) read node 0 through a clamped index and are
    masked out by ``valid``; pending children are invalid too.

    Returns ``(n_c, o_c, v_c, vl_c, n_p, o_p, valid)`` with shapes
    ``[B, A] × 4, [B] × 2, [B, A]``.
    """
    b = torch.arange(nodes.shape[0], device=nodes.device)
    kids = tree.children[b, nodes]                   # i64[B, A]
    safe = kids.clamp_min(0)
    b2 = b[:, None]
    valid = (kids >= 0) & ~tree.pending[b2, safe]
    n_c = tree.N[b2, safe]
    o_c = tree.O[b2, safe]
    v_c = tree.V[b2, safe]
    vl_c = tree.VL[b2, safe]
    n_p = tree.N[b, nodes]
    o_p = tree.O[b, nodes]
    return n_c, o_c, v_c, vl_c, n_p, o_p, valid
