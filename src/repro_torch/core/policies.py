"""Tree (node-selection) policies (counterpart of ``repro.core.policies``).

The four selection rules of the paper — ``uct`` (eq. 2), ``wu_uct``
(eq. 4), ``treep`` (V − VL) and ``treep_vc`` (eq. 7) — are scored inside
the ``tree_descend`` kernel, which walks each tree from root to stop node
in one launch, and by the per-level ``tree_select`` kernel
(:mod:`repro_torch.kernels.tree_select`); this module holds their
configuration and the gather that feeds the per-level kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.tree_select.ref import children_tables


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
    return children_tables(tree.children, tree.N, tree.O, tree.V, tree.VL,
                           tree.pending, nodes)
