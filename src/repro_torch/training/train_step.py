"""The train step: microbatched gradient accumulation, optional gradient
compression, AdamW (counterpart of ``repro.training.train_step``).

``make_train_step(model_cfg, train_cfg)`` returns
``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``.
It takes the gradients of :func:`repro_torch.models.loss_fn` with autograd
(through the hand-written attention backward on the card), accumulates
``microbatches`` of them in float32 zeros and divides by their number, as
the reference's ``lax.scan`` does, and updates the parameters and state
**in place** (:func:`.optimizer.adamw_update`; the reference's
``donate_argnums``).  The metrics leave the device once a step, through
:func:`repro_torch.sync.host_read`: ``loss``, ``grad_norm`` and ``lr`` as
Python floats.

**On placed parameters** (``make_train_step(..., mesh=, strategy=)``,
parameters from ``repro_torch.distributed.sharding.distribute_params`` and
the state from ``adamw_init(params, opt_state_shardings(...).m)``): the
step places a whole batch as ``batch_spec`` says (rows over the data axes,
or over every axis under ``fsdp`` when they divide), runs under
``use_mesh(mesh)``, where DTensor reduces the gradients over the data axes
as it propagates them, and the update reduce-scatters them into the ZeRO
placement of the moments (:func:`.optimizer.adamw_update`).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..models import loss_fn
from ..models.config import ModelConfig
from ..models.lm import tree_map
from ..sync import host_read
from .optimizer import AdamWConfig, adamw_update, leaves

Tree = Any


class TrainConfig(NamedTuple):
    optimizer: AdamWConfig = AdamWConfig()
    microbatches: int = 1
    compress_grads: bool = False   # int8 error-feedback all-reduce emulation


def grad_fn(params: Tree, cfg: ModelConfig, batch) -> tuple[torch.Tensor, Tree]:
    """``(loss + aux, grads)`` of one batch; the grads in the parameters'
    dtypes and tree."""
    live = tree_map(lambda x: x.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss, _ = loss_fn(live, cfg, batch)
        grads = torch.autograd.grad(loss, leaves(live))
    it = iter(grads)
    return loss.detach(), _unflatten(live, it)


def _unflatten(tree: Tree, it) -> Tree:
    """A tree shaped as ``tree`` from the leaves of ``it``, taken in
    :func:`.optimizer.leaves` order."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], it) for k in sorted(tree)}
    return next(it)


def _whole(x: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def make_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig = TrainConfig(),
                    mesh=None, strategy: str = "tp"):
    if mesh is None:
        return _make_step(model_cfg, train_cfg)
    from ..distributed.sharding import batch_shardings, distribute_leaf, use_mesh

    step = _make_step(model_cfg, train_cfg)

    def train_step(params, opt_state, batch):
        pl = batch_shardings(mesh, batch, strategy, batch["tokens"].shape[0])
        placed = {k: distribute_leaf(x, pl[k], mesh) for k, x in batch.items()}
        with use_mesh(mesh):
            return step(params, opt_state, placed)

    return train_step


def _make_step(model_cfg: ModelConfig, train_cfg: TrainConfig):
    opt_cfg = train_cfg.optimizer
    mb = train_cfg.microbatches

    def train_step(params, opt_state, batch):
        if mb == 1:
            loss, grads = grad_fn(params, model_cfg, batch)
        else:
            def split(x):
                b = x.shape[0]
                assert b % mb == 0, (b, mb)
                return x.reshape(mb, b // mb, *x.shape[1:])

            micro = {k: split(x) for k, x in batch.items()}
            loss = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            for i in range(mb):
                loss_i, grads_i = grad_fn(params, model_cfg, {k: x[i] for k, x in micro.items()})
                loss = loss + loss_i
                for acc, g in zip(leaves(grads), leaves(grads_i)):
                    acc.add_(g)
                del grads_i
            loss = loss / mb
            grads = tree_map(lambda g: g / mb, grads)

        if train_cfg.compress_grads:
            from ..distributed.compress import compress_decompress

            grads = compress_decompress(grads)

        params, opt_state, opt_metrics = adamw_update(grads, opt_state, params, opt_cfg)
        del grads
        values = host_read(torch.stack([_whole(loss).to(torch.float32),
                                        _whole(opt_metrics["grad_norm"]),
                                        _whole(opt_metrics["lr"]).to(torch.float32)]))
        metrics = {"loss": float(values[0]), "grad_norm": float(values[1]),
                   "lr": float(values[2])}
        return params, opt_state, metrics

    return train_step
