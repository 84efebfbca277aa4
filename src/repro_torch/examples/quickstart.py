"""Quickstart: WU-UCT on the tap game, against sequential UCT (the port's
counterpart of ``examples/quickstart.py``).

Everything goes through one front door: describe the search with a
``SearchSpec`` and build it with ``build_searcher``.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

from repro_torch import rng
from repro_torch.core import SearchSpec, build_searcher, play_episode
from repro_torch.core.api import resolve_device
from repro_torch.envs import make_tap_game
from repro_torch.envs.base import map_state


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--simulations", type=int, default=64)
    ap.add_argument("--max-moves", type=int, default=20, help="moves of the episode")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    env = make_tap_game(grid_size=6, num_colors=4, goal_count=10, step_budget=20)
    key = rng.PRNGKey(0, device=device)
    state = map_state(lambda x: x[0], env.init(key[None]))
    print(f"env: {env.name}; initial grid:\n{state.grid.cpu().numpy()}\n")

    actions = {}
    for algo, wave in [("uct", 1), ("wu_uct", 16)]:
        spec = SearchSpec(algo=algo, num_simulations=args.simulations, wave_size=wave,
                          max_depth=10, max_sim_steps=15, max_width=5, gamma=1.0)
        search = build_searcher(env, spec, device=device)
        search(state, key)                         # warm-up
        _sync(device)
        t0 = time.perf_counter()
        res = search(state, rng.PRNGKey(1, device=device))
        _sync(device)
        dt = time.perf_counter() - t0
        cfg = spec.config
        action = int(res.action)
        actions[algo] = action
        print(f"{algo:8s} W={cfg.wave_size:2d}: action={action} (cell {action // 6},"
              f"{action % 6}) tree_size={int(res.tree_size)} wall={dt * 1e3:.1f}ms "
              f"master_rounds={cfg.num_simulations // cfg.wave_size}")

    print("\nplaying one full episode with WU-UCT (16 in-flight workers)...")
    spec = SearchSpec(algo="wu_uct", num_simulations=args.simulations, wave_size=16,
                      max_depth=10, max_sim_steps=15, max_width=5, gamma=1.0)
    ret, moves, done = play_episode(env, spec.config, rng.PRNGKey(7, device=device),
                                    max_moves=args.max_moves,
                                    searcher=build_searcher(env, spec, device=device),
                                    device=device)
    print(f"episode return={ret:.3f}, game steps={moves}, solved={done}")
    return {"actions": actions, "return": ret, "moves": moves, "solved": done}


if __name__ == "__main__":
    main()
