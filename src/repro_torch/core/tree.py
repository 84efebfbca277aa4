"""Shared constants of the port's search trees (counterpart of
``repro.core.tree``).

The reference keeps a single-tree ``Tree`` beside the batched forest; the
port has only the forest (:mod:`repro_torch.core.batched_tree`), and its
single-tree engine is the ``B = 1`` view of it.
"""

NO_NODE = -1
