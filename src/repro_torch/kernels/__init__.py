"""Hand-written CUDA kernels of the port, with their plain PyTorch versions.

Each wrapper adds one to its entry in :data:`LAUNCHES` where it launches
its kernel, and nowhere else, so a run can show that its main path went
through the kernels.

Two kernels have a backward on the card: ``flash_attention`` (its
autograd function launches ``flash_attention_bwd``) and ``ssd_scan``
without ``return_state`` (``ssd_scan_bwd``).  The other wrappers' kernels,
and ``ssd_scan(return_state=True)``, compute values only: on a CUDA tensor
each calls :func:`refuse_grad` first, so a loss taken through one of them
raises instead of silently losing the gradient.  Their plain versions on
the CPU keep autograd.
"""

from __future__ import annotations

import torch

LAUNCHES: dict[str, int] = {
    "tree_select": 0,
    "tree_descend": 0,
    "decode_attention": 0,
    "flash_attention": 0,
    "flash_attention_bwd": 0,
    "paged_decode_attention": 0,
    "tree_decode_attention": 0,
    "paged_tree_decode_attention": 0,
    "ssd_scan": 0,
    "ssd_scan_bwd": 0,
}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def refuse_grad(name: str, *tensors) -> None:
    """Raise ``RuntimeError`` if autograd would need a gradient through
    kernel ``name``, which has none: grad mode is on and a tensor of
    ``tensors`` (others are ignored) requires grad."""
    if torch.is_grad_enabled() and any(
            isinstance(x, torch.Tensor) and x.requires_grad for x in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and an input requires grad; "
            f"run it under torch.no_grad() or detach the inputs")
