"""User pass-rate prediction — the paper's production deployment (App. C)
on generated tap-game levels (the port's counterpart of
``examples/passrate_prediction.py``).

1. generate levels of varying difficulty;
2. run a 10-rollout WU-UCT bot (an average player) and a 100-rollout bot
   (a skilled one) on each level, several games each;
3. extract the paper's six features (pass rate, mean and median step
   ratio, per bot);
4. fit a linear (ridge) regressor to synthetic human pass rates;
5. report the mean absolute error (paper: 8.6 % over 130 released levels).

The human pass rates come from a hidden difficulty model with noise: the
system sees only gameplay features.

Run:  PYTHONPATH=src python -m repro_torch.examples.passrate_prediction \
          [--levels 14] [--games 3] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from repro_torch import rng
from repro_torch.core import SearchSpec, build_searcher, play_episode
from repro_torch.core.api import resolve_device
from repro_torch.envs import make_tap_game


def gameplay_features(env, budget, n_games, seed, step_budget, device):
    spec = SearchSpec(algo="wu_uct", num_simulations=budget, wave_size=min(budget, 10),
                      max_depth=10, max_sim_steps=12, max_width=5, gamma=1.0)
    search = build_searcher(env, spec, device=device)
    passes, ratios = [], []
    for g in range(n_games):
        ret, moves, done = play_episode(env, spec.config,
                                        rng.PRNGKey(seed * 977 + g, device=device),
                                        max_moves=step_budget, searcher=search, device=device)
        solved = done and moves < step_budget or ret > 0.9
        passes.append(float(solved))
        ratios.append(moves / step_budget)
    return [np.mean(passes), np.mean(ratios), np.median(ratios)]


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--levels", type=int, default=14)
    ap.add_argument("--games", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    g = np.random.default_rng(0)
    rows, human = [], []
    for lv in range(args.levels):
        # Difficulty knobs: more colours and a higher goal are harder.
        colors = int(g.integers(3, 6))
        goal = int(g.integers(6, 14))
        budget_steps = int(g.integers(16, 26))
        env = make_tap_game(grid_size=6, num_colors=colors, goal_count=goal,
                            step_budget=budget_steps)
        feats = gameplay_features(env, 10, args.games, lv * 2 + 1, budget_steps, device)
        feats += gameplay_features(env, 100, args.games, lv * 2 + 2, budget_steps, device)
        rows.append(feats)
        # Hidden human model: logistic in difficulty, plus noise.
        difficulty = 0.9 * colors + 0.45 * goal - 0.35 * budget_steps
        p = 1.0 / (1.0 + np.exp(0.55 * difficulty))
        human.append(np.clip(p + g.normal(0, 0.05), 0, 1))
        print(f"level {lv:2d}: colors={colors} goal={goal:2d} steps={budget_steps} "
              f"features={[f'{f:.2f}' for f in feats]} human={human[-1]:.2f}")

    x = np.asarray(rows)
    y = np.asarray(human)
    n_train = max(2, int(0.7 * len(y)))
    xd = np.concatenate([x, np.ones((len(y), 1))], axis=1)
    # Ridge regression (the paper fits a linear regressor on 300 levels; at
    # this scale the regularisation stands in for the larger training set).
    lam = 0.05
    a = xd[:n_train]
    w = np.linalg.solve(a.T @ a + lam * np.eye(a.shape[1]), a.T @ y[:n_train])
    pred = np.clip(xd @ w, 0, 1)
    mae_train = float(np.abs(pred[:n_train] - y[:n_train]).mean())
    mae_test = (float(np.abs(pred[n_train:] - y[n_train:]).mean()) if len(y) > n_train
                else float("nan"))
    print(f"\npass-rate prediction MAE: train={100 * mae_train:.1f}% "
          f"test={100 * mae_test:.1f}%  (paper production system: 8.6%)")
    return {"features": x, "human": y, "mae_train": mae_train, "mae_test": mae_test}


if __name__ == "__main__":
    main()
