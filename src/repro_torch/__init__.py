"""PyTorch/CUDA port of the WU-UCT package ``repro``.

A second package beside the JAX reference: it imports ``torch`` and numpy,
never ``jax`` and nothing of ``repro``.  Entry points run on CUDA unless
the caller asks for the CPU; the hand-written kernels live in
``repro_torch/csrc`` and are built with ``nvcc`` at first use.

Ported so far: the search engines behind ``repro_torch.core.build_searcher``
(every algo, rollout- and model-guided, dense, paged and frontier
evaluators), the environments, a bit-exact twin of the ``jax.random``
functions they use, every model family and configuration, search and LM
serving, training (``repro_torch.training``, ``repro_torch.launch.train``)
and the reference's examples (``repro_torch.examples``), on the seven
kernels of the reference and the backward of ``flash_attention``.
"""
