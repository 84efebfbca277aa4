"""Gradient compression: int8 quantisation with error feedback
(counterpart of ``repro.distributed.compress``).

On several devices the all-reduce would carry the int8 payload; here, as
in the reference, the numerics are emulated — quantise, dequantise — and
the quantisation residual is carried as *error feedback*, so the bias
vanishes over steps (Karimireddy et al., 2019).  Gradients are the port's
parameter trees (nested dicts of tensors).  ``torch.round`` rounds half to
even, as ``jnp.round`` does.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..models.lm import tree_map

Tree = Any


def _quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_decompress(grads: Tree) -> Tree:
    """Stateless quantise -> dequantise round trip of every leaf (the wire
    format's numerics), in each leaf's dtype."""

    def one(g):
        q, s = _quantize(g.to(torch.float32))
        return _dequantize(q, s).to(g.dtype)

    return tree_map(one, grads)


def compress_with_feedback(grads: Tree, error: Optional[Tree]) -> tuple[Tree, Tree]:
    """Error-feedback compression: ``(compressed grads, new residual)``; the
    residual is float32 and starts at zeros when ``error`` is None."""
    if error is None:
        error = tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                               device=g.device), grads)
    def one(g, e):
        corrected = g.to(torch.float32) + e
        q, s = _quantize(corrected)
        deq = _dequantize(q, s)
        return deq.to(g.dtype), corrected - deq

    pairs = tree_map(one, grads, error)          # leaves (grad, residual)
    return tree_map(lambda pair: pair[0], pairs), tree_map(lambda pair: pair[1], pairs)
