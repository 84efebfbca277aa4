"""PyTorch/CUDA port of the WU-UCT package ``repro``.

A second package beside the JAX reference: it imports ``torch`` and numpy,
never ``jax`` and nothing of ``repro``.  Entry points run on CUDA unless
the caller asks for the CPU; the hand-written kernels live in
``repro_torch/csrc`` and are built with ``nvcc`` at first use.

Ported so far: the rollout-evaluated wave engine (single-root and batched)
behind ``repro_torch.core.build_searcher``, the tap game and bandit tree
environments, a bit-exact twin of the ``jax.random`` functions they use,
and the ``tree_select`` kernels (one level, and ``tree_descend``, the whole
walk from the root in one launch).
"""
