"""The reference's examples, ported: each runs as
``python -m repro_torch.examples.<name> [--device cpu]`` (on CUDA unless
asked for the CPU) and its ``main(argv)`` returns what it printed the
numbers of.

* :mod:`.quickstart` — WU-UCT against sequential UCT on the tap game, and
  one episode;
* :mod:`.passrate_prediction` — the paper's App. C pass-rate prediction
  from 10- and 100-rollout bots;
* :mod:`.train_policy` — AdamW, gradient compression, a crash and a
  restore through ``CheckpointManager``;
* :mod:`.serve_search` — a briefly trained LM served by ``ServingEngine``,
  searched over with WU-UCT and served by ``SearchService``.
"""
