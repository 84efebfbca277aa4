"""AdamW with float32 master weights, and the learning-rate schedule
(counterpart of ``repro.training.optimizer``).

The state ``(step, m, v, master)`` mirrors the parameter tree (nested
dicts of tensors): ``m``, ``v`` and ``master`` are float32 whatever the
parameters' dtype.  :func:`adamw_update` is the reference's update formula
for formula, in plain tensor ops on the parameters' device (the reference's
AdamW is XLA, not a Pallas kernel); ``torch.optim.AdamW`` keeps no master
copy and rounds in another order.

**In place:** :func:`adamw_update` writes the new ``m``, ``v``, ``master``
and parameters into the tensors it is given and returns them, as the
reference's jitted step does into its donated buffers: at llama3-8b's
width a second copy of the float32 state would not fit the card.  A caller
that needs the old values keeps a copy.

**Placed parameters** (DTensors, ``repro_torch.distributed.sharding``):
the state takes the ZeRO placement of ``opt_state_shardings`` (the
parameter's spec plus a split over the data axes), so each rank keeps and
updates its own slice.  The update reduce-scatters each gradient into its
moment's placement, computes the norm there, and all-gathers the new
parameters back into theirs (in the parameters' dtype); DTensor has no rule
that would do either inside an in-place update, so both are explicit
redistributions.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from ..distributed.sharding import is_placed
from ..models.lm import tree_map

Tree = Any


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32 []
    m: Tree
    v: Tree
    master: Tree         # float32 master copy of the (possibly bf16) params


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``cfg.lr``, then a cosine decay to ``min_lr_ratio``
    of it at ``total_steps``; float32, as the reference computes it."""
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    scale = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * scale


def adamw_init(params: Tree, placements: Tree = None) -> AdamWState:
    """Zero moments and a float32 master copy of ``params`` (a copy, never
    an alias of a float32 parameter: the update writes it in place).

    For placed parameters ``placements`` is the moments' placement tree
    (``opt_state_shardings(...).m``): each rank then allocates its own
    slice, and the master is its block of the parameter upcast (a split,
    no communication)."""
    device = next(iter(leaves(params))).device
    if placements is None:
        placements = tree_map(lambda x: None, params)

    def zeros(x, pl):
        if pl is None:
            return torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        from torch.distributed.tensor import zeros as placed_zeros

        return placed_zeros(x.shape, dtype=torch.float32, device_mesh=x.device_mesh,
                            placements=pl)

    def master(x, pl):
        up = x.detach().to(torch.float32, copy=True)
        return up if pl is None else up.redistribute(x.device_mesh, pl)

    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        m=tree_map(zeros, params, placements),
        v=tree_map(zeros, params, placements),
        master=tree_map(master, params, placements),
    )


def leaves(tree: Tree) -> list:
    """The leaves of nested dicts in the reference's order (sorted keys, as
    ``jax.tree.leaves`` orders a dict)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    total = 0
    for x in leaves(tree):
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads: Tree, state: AdamWState, params: Tree,
                 cfg: AdamWConfig) -> tuple[Tree, AdamWState, dict]:
    """One optimizer step, **in place**: returns ``(params, state,
    metrics)`` with the parameters, moments and master weights written into
    the given tensors; ``metrics`` holds the ``grad_norm`` (before
    clipping) and the ``lr`` as float32 tensors."""
    placed = is_placed(leaves(state.m)[0])
    if placed:
        # Reduce-scatter: each gradient into its moment's (ZeRO) placement.
        grads = tree_map(lambda g, m: g.redistribute(m.device_mesh, m.placements),
                         grads, state.m)
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9), 1.0)
    step = state.step + 1
    lr = cosine_schedule(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** step.to(torch.float32)
    for g, m, v, master, p in zip(leaves(grads), leaves(state.m), leaves(state.v),
                                  leaves(state.master), leaves(params)):
        g = g.to(torch.float32) * scale
        m.mul_(cfg.b1).add_(g * (1.0 - cfg.b1))                  # b1 m + (1 - b1) g
        v.mul_(cfg.b2).add_((g * (1.0 - cfg.b2)).mul_(g))        # b2 v + (1 - b2) g g
        del g
        denom = (v / b2c).sqrt_().add_(cfg.eps)                 # sqrt(vhat) + eps
        step_dir = (m / b1c).div_(denom)                        # mhat / (...)
        del denom
        step_dir.add_(master * cfg.weight_decay)
        master.sub_(step_dir.mul_(lr))                          # master - lr (...)
        if placed:
            # All-gather the new values into the parameter's placement.
            p.copy_(master.to(p.dtype).redistribute(p.device_mesh, p.placements))
        else:
            p.copy_(master)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(step=step, m=state.m, v=state.v, master=state.master), metrics
