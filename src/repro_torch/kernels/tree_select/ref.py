"""Plain PyTorch version of the batched tree-selection kernel.

Same math as the CUDA kernel (``csrc/tree_select.cu``) and as the
reference's ``_scores`` (``repro/kernels/tree_select/tree_select.py``), in
the same float32 order of operations.  ``sqrt`` is taken in float64 and
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
