"""The port's host synchronisation points, and their counter.

The reference package runs its data-dependent loops (tree walks, the
traversal, rollouts, the flood fill, the fused serving loop) as
``lax.while_loop``\\ s on the device.  In eager PyTorch each such loop is
a Python loop that asks the device whether any row is still active;
:func:`host_any` is that question, :func:`host_read` fetches a small
tensor of several such answers at once, and :func:`host_copy` copies
several tensors to the host.  On a GPU each waits for the queued work, so
``SYNCS["host_any"]`` counts the host syncs a search costs (all three
add to it) — ``chip_smoke.py`` reports it per search.
"""

from __future__ import annotations

import numpy as np
import torch

SYNCS: dict[str, int] = {"host_any": 0}


def reset_syncs() -> None:
    """Set the host sync count to 0."""
    SYNCS["host_any"] = 0


def host_any(mask: torch.Tensor) -> bool:
    """``bool(mask.any())``, counted in :data:`SYNCS`."""
    SYNCS["host_any"] += 1
    return bool(mask.any())


def host_read(x: torch.Tensor) -> np.ndarray:
    """``x`` copied to the host as a numpy array, counted in :data:`SYNCS`
    as one host sync."""
    SYNCS["host_any"] += 1
    return x.cpu().numpy()


def host_copy(xs) -> tuple:
    """Host copies of the tensors ``xs``, counted in :data:`SYNCS` as one
    host sync (the first copy waits for the queued work, the rest find it
    done)."""
    SYNCS["host_any"] += 1
    return tuple(x.to("cpu", copy=True) for x in xs)
