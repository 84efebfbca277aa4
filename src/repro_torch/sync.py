"""The port's one host synchronisation point, and its counter.

The reference package runs its data-dependent loops (tree walks, the
traversal, rollouts, the flood fill) as ``lax.while_loop``\\ s on the
device.  In eager PyTorch each such loop is a Python loop that asks the
device whether any row is still active; :func:`host_any` is that question.
On a GPU it waits for the queued work, so ``SYNCS["host_any"]`` counts the
host syncs a search costs — ``chip_smoke.py`` reports it per search.
"""

from __future__ import annotations

import torch

SYNCS: dict[str, int] = {"host_any": 0}


def reset_syncs() -> None:
    """Set the host sync count to 0."""
    SYNCS["host_any"] = 0


def host_any(mask: torch.Tensor) -> bool:
    """``bool(mask.any())``, counted in :data:`SYNCS`."""
    SYNCS["host_any"] += 1
    return bool(mask.any())
