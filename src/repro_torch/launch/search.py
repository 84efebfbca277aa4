"""Search launcher of the port: WU-UCT or one of the paper's baselines on
the GPU.

Everything goes through ``repro_torch.core.build_searcher``; the flags map
onto ``SearchSpec`` fields as in ``repro.launch.search``.

Episode play (one search per move):
  PYTHONPATH=src python -m repro_torch.launch.search --env tap --algo wu_uct \
      --workers 16 --simulations 128 --episodes 2

Batched multi-root mode (B independent searches in lockstep, each
traversal one launch of the tree_descend kernel; reports searches/s of the
second call, and the card's name):
  PYTHONPATH=src python -m repro_torch.launch.search --env tap --batch 256 \
      --workers 16 --simulations 128

The baselines LeafP and RootP search one root at a time (``--batch`` with
them raises ``build_searcher``'s ``ValueError``); ``--env mdp`` is the
random tabular MDP (32 states, 4 actions, horizon 16):
  PYTHONPATH=src python -m repro_torch.launch.search --env mdp --algo rootp \
      --workers 16 --simulations 128 --episodes 1

``--engine async`` runs the async-slot engine (the paper's master–worker
interleaving) instead of the wave engine, in either mode:
  PYTHONPATH=src python -m repro_torch.launch.search --env bandit --batch 32 \
      --workers 16 --simulations 128 --engine async

``--device`` defaults to ``cuda``; without a card the launcher raises
unless ``--device cpu`` is given.  ``--profile`` (batched mode) traces the
timed search with ``torch.profiler`` and prints the device's busy share,
the kernels launched and the host syncs:
  PYTHONPATH=src python -m repro_torch.launch.search --env tap --batch 256 \
      --workers 16 --simulations 16 --profile
"""

from __future__ import annotations

import argparse
import contextlib
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import rng
from repro_torch.core import SearchSpec, build_searcher, play_episode
from repro_torch.core.api import resolve_device
from repro_torch.envs import make_bandit_tree, make_random_mdp, make_tap_game
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.sync import SYNCS, reset_syncs


def make_env(name: str):
    return {
        "tap": lambda: make_tap_game(grid_size=6, num_colors=4, goal_count=10,
                                     step_budget=20),
        "tap_hard": lambda: make_tap_game(grid_size=7, num_colors=5,
                                          goal_count=14, step_budget=30),
        "bandit": lambda: make_bandit_tree(depth=6, num_actions=4),
        "mdp": lambda: make_random_mdp(num_states=32, num_actions=4, horizon=16),
    }[name]()


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _print_profile(prof, wall: float, device: torch.device) -> None:
    """Device busy share and the kernels that took the device time.

    Only device-side events count: the aten ops that launch them carry the
    same device time again.
    """
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        rows.append((evt.self_device_time_total, evt.count, evt.key))
    busy = sum(r[0] for r in rows) * 1e-6
    launches = sum(r[1] for r in rows)
    print(f"profile on {_device_name(device)}: wall {wall!r} s, device busy {busy!r} s "
          f"({busy / wall!r} of wall), {launches} device kernels, "
          f"tree_descend launches {LAUNCHES['tree_descend']}, host syncs {SYNCS['host_any']}")
    for dev_us, count, key in sorted(rows, reverse=True)[:12]:
        print(f"  {dev_us * 1e-3!r} ms  {count} x  {key[:90]}")


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--env", default="tap", choices=["tap", "tap_hard", "bandit", "mdp"])
    ap.add_argument("--algo", default="wu_uct",
                    choices=["wu_uct", "uct", "treep", "treep_vc", "leafp", "rootp"])
    ap.add_argument("--engine", default="wave", choices=["wave", "async"])
    ap.add_argument("--workers", type=int, default=16)
    ap.add_argument("--simulations", type=int, default=128)
    ap.add_argument("--episodes", type=int, default=2)
    ap.add_argument("--max-depth", type=int, default=10)
    ap.add_argument("--width", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=0,
                    help="B>0: run B root states through the batched "
                         "multi-root engine instead of episode play")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    ap.add_argument("--profile", action="store_true",
                    help="batched mode: trace the search with torch.profiler")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    env = make_env(args.env)
    spec = SearchSpec(
        algo=args.algo,
        engine=args.engine,
        batch=args.batch,
        num_simulations=args.simulations,
        wave_size=args.workers,
        max_depth=args.max_depth,
        max_sim_steps=20,
        max_width=min(args.width, env.num_actions),
        gamma=0.99,
    )
    search = build_searcher(env, spec, device=device)

    if args.batch > 0:
        B = args.batch
        roots = env.init(rng.split(rng.PRNGKey(args.seed, device=device), B))
        rngs = rng.split(rng.PRNGKey(args.seed + 1, device=device), B)
        search(roots, rngs)  # warm-up: builds the kernels, initialises the card
        _sync(device)
        reset_launches()
        reset_syncs()
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        tracing = (torch.profiler.profile(activities=activities) if args.profile
                   else contextlib.nullcontext())
        with tracing as prof:
            t0 = time.perf_counter()
            res = search(roots, rngs)
            _sync(device)
            dt = time.perf_counter() - t0
        if args.profile:
            _print_profile(prof, dt, device)
        acts = res.action.cpu().numpy()
        cfg = spec.config
        print(f"{args.algo}[{args.engine}] B={B} W={cfg.wave_size} T={cfg.num_simulations} "
              f"on {_device_name(device)}: {B / dt!r} searches/s  wall={dt!r}s  "
              f"actions={acts[:min(B, 16)].tolist()}{'…' if B > 16 else ''}  "
              f"overflowed={bool(res.overflowed.any())}  "
              f"tree_descend launches {LAUNCHES['tree_descend']}, "
              f"host syncs {SYNCS['host_any']}")
        return

    rets, steps = [], []
    for ep in range(args.episodes):
        t0 = time.perf_counter()
        ret, moves, done = play_episode(
            env, spec.config, rng.PRNGKey(args.seed + ep, device=device),
            max_moves=32, searcher=search, device=device,
        )
        rets.append(ret)
        steps.append(moves)
        print(f"episode {ep}: return={ret:.3f} game_steps={moves} done={done} "
              f"wall={time.perf_counter() - t0:.1f}s on {_device_name(device)}")
    print(f"\n{args.algo} W={args.workers}: return={np.mean(rets):.3f}"
          f"±{np.std(rets):.3f} game_steps={np.mean(steps):.1f}")


if __name__ == "__main__":
    main()
