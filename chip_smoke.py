#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the script exits non-zero):

1. print the card's name and power limit (``nvidia-smi``); require CUDA;
2. build the port's CUDA kernels from ``src/repro_torch/csrc`` with nvcc;
3. hold each kernel against its plain PyTorch version on the card, and
   time both at the main path's shape;
4. the main path: ``build_searcher`` on the tap game answers 256 searches
   (the paper's W=16, T=128) through the ``tree_select`` kernel; its launch
   count must cover every selection, and 8 of the trees are re-searched by
   the port on the CPU with the same keys;
5. the bandit tree at B=1024 for the four algos, against the exact optimum;
6. the single-root path: ``batch=0`` and two moves of ``play_episode``.

The line before the last is a JSON object with each kernel's launches on
the main path, error against its plain version, time, plain time, bound and
library time; the last line is ``{"ok": true, "device": {...}}``.

Imports nothing of JAX.  Without a CUDA device, or without the rest of the
repository beside it, it fails before printing a result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
FP32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
MAIN_B, MAIN_A = 256, 36      # tap game 6x6: 256 trees, 36 actions
BANDIT_B = 1024
KINDS = ("wu_uct", "uct", "treep", "treep_vc")
# Child tables each kind reads (f32[B, A]) besides the validity bytes.
TABLES_READ = {"wu_uct": 3, "uct": 2, "treep": 3, "treep_vc": 3}


def phase(title):
    print(f"== {title}", flush=True)


def card_info(torch):
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    return smi


def select_inputs(torch, rs, b, a, device):
    """Random [b, a] selection tables with exact ties, all-invalid rows and
    unvisited (+inf) children."""
    n_c = np.floor(rs.random((b, a)) * 10).astype(np.float32)
    o_c = np.floor(rs.random((b, a)) * 3).astype(np.float32)
    v_c = rs.normal(size=(b, a)).astype(np.float32)
    vl_c = rs.random((b, a)).astype(np.float32)
    valid = rs.random((b, a)) < 0.7
    tie = rs.random(b) < 0.2                      # duplicate child 0 everywhere
    for x in (n_c, o_c, v_c, vl_c):
        x[tie] = x[tie, :1]
    valid[rs.random(b) < 0.05] = False            # all-invalid rows
    unvisited = rs.random((b, a)) < 0.1
    n_c[unvisited] = 0.0
    o_c[unvisited] = 0.0
    n_p = n_c.sum(1) + 1
    o_p = o_c.sum(1)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return t(n_c), t(o_c), t(v_c), t(n_p), t(o_p), t(valid), t(vl_c)


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(torch, fn, iters):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_tree_select(torch, device):
    """Kernel vs plain version on the card; returns the JSON fields.

    Both run on the card with the same rounding (``_rn`` intrinsics and no
    FMA contraction in the kernel, IEEE ``log``/``sqrt`` on both sides), so
    ``act`` and ``best`` must be equal bit for bit, near-ties included.
    """
    from repro_torch.kernels.tree_select.ops import tree_select
    from repro_torch.kernels.tree_select.ref import tree_select_ref

    max_err = 0.0

    def check(args, params, what):
        nonlocal max_err
        act, best = tree_select(*args, **params)
        sync(device)
        act_r, best_r = tree_select_ref(*args, **params)
        both_inf = torch.isinf(best) & (best == best_r)
        err = torch.where(both_inf, 0.0, (best - best_r).abs())
        max_err = max(max_err, float(err.max()))
        if not torch.equal(act.long(), act_r.long()):
            raise AssertionError(f"tree_select act differs from its plain version: {what}")
        if not torch.equal(best, best_r):
            raise AssertionError(f"tree_select best differs from its plain version: {what}")

    # The grid, plus the shapes the driven paths give the kernel: the tap
    # main path [256, 36], the bandit path [1024, 4], the single root [1, 36].
    shapes = ([(b, a) for b in (1, 257, 4096) for a in (4, 36, 81)]
              + [(MAIN_B, MAIN_A), (BANDIT_B, 4)])
    rs = np.random.default_rng(0)
    for kind in KINDS:
        params = dict(kind=kind, beta=1.3, r_vl=0.7, n_vl=1.5)
        for b, a in shapes:
            check(select_inputs(torch, rs, b, a, device), params, f"{kind} B={b} A={a}")
    print(f"tree_select equals its plain version bit for bit: 4 kinds x B in "
          f"(1, 257, 4096) x A in (4, 36, 81), and [{MAIN_B}, {MAIN_A}], "
          f"[{BANDIT_B}, 4]; max |best - plain| = {max_err!r}")

    times = {}
    for kind in KINDS:
        args = select_inputs(torch, np.random.default_rng(1), MAIN_B, MAIN_A, device)
        check(args, dict(kind=kind), f"{kind} timed inputs")
        k_ms = time_ms(torch, lambda: tree_select(*args, kind=kind), 2000)
        p_ms = time_ms(torch, lambda: tree_select_ref(*args, kind=kind), 200)
        nbytes = (TABLES_READ[kind] * 4 + 1) * MAIN_B * MAIN_A + 2 * 4 * MAIN_B + 2 * 4 * MAIN_B
        # Per child about 12 float32 operations (denominator, two clamps,
        # product, quotient, sqrt, scale, value sum, two selects, the
        # argmax compare); per row the parent sum, clamp and log.
        ops = 12 * MAIN_B * MAIN_A + 4 * MAIN_B
        bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3
        times[kind] = (k_ms, p_ms, bound_ms, nbytes)
        print(f"tree_select {kind} B={MAIN_B} A={MAIN_A}: kernel {k_ms * 1e3!r} us, "
              f"plain {p_ms * 1e3!r} us, bound {bound_ms * 1e3!r} us ({nbytes} bytes)")
    print("no single PyTorch call computes tree_select: library_ms is null")
    k_ms, p_ms, bound_ms, _ = times["wu_uct"]
    return {"max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}


def main_path(torch, device):
    """Phase 4: 256 tap-game searches through build_searcher."""
    from repro_torch import rng
    from repro_torch.core import SearchSpec, build_searcher
    from repro_torch.envs import make_tap_game
    from repro_torch.envs.base import map_state
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.sync import SYNCS, reset_syncs

    env = make_tap_game(6, 4, goal_count=10, step_budget=20)
    spec = SearchSpec(algo="wu_uct", engine="wave", batch=MAIN_B,
                      num_simulations=128, wave_size=16, max_depth=10,
                      max_width=5, max_sim_steps=20)
    search = build_searcher(env, spec, device=device)
    roots = env.init(rng.split(rng.PRNGKey(0, device=device), MAIN_B))
    rngs = rng.split(rng.PRNGKey(1, device=device), MAIN_B)
    sync(device)

    reset_launches()
    reset_syncs()
    t0 = time.perf_counter()
    res = search(roots, rngs)
    sync(device)
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    syncs = SYNCS["host_any"]

    if launches["tree_select"] < spec.num_simulations:
        raise AssertionError(f"tree_select launched {launches['tree_select']} times, "
                             f"fewer than the {spec.num_simulations} selections")
    if bool(res.overflowed.any()):
        raise AssertionError("a tree overflowed its capacity")
    tried = res.root_n > 0
    finite = (torch.isfinite(res.root_n).all() & torch.isfinite(res.max_o).all()
              & torch.isfinite(res.dup_selections).all()
              & torch.isfinite(res.root_v[tried]).all())
    if not bool(finite) or not bool(((res.action >= 0) & (res.action < 36)).all()):
        raise AssertionError("non-finite or out-of-range search results")
    if not bool((res.root_n.sum(1) <= spec.num_simulations).all()):
        raise AssertionError("root visit counts exceed T")

    cpu_search = build_searcher(env, spec._replace(batch=8), device="cpu")
    res_cpu = cpu_search(map_state(lambda x: x[:8].cpu(), roots), rngs[:8].cpu())
    gpu_act = res.action[:8].cpu()
    same = gpu_act == res_cpu.action
    for i in np.flatnonzero(~same.numpy()):
        print(f"tree {i}: GPU action {int(gpu_act[i])}, CPU action "
              f"{int(res_cpu.action[i])} (root_n GPU {res.root_n[i].cpu().tolist()} "
              f"CPU {res_cpu.root_n[i].tolist()})")
    if int(same.sum()) < 7:
        raise AssertionError(f"GPU and CPU actions agree on {int(same.sum())} of 8 trees")

    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"main path: tap 6x6 wu_uct B={MAIN_B} T=128 W=16 on {name}: "
          f"{MAIN_B / wall!r} searches/s (wall {wall!r} s, first call), "
          f"tree_select launches {launches['tree_select']} "
          f"({launches['tree_select'] / MAIN_B!r} per search), host syncs {syncs}; "
          f"CPU re-search agrees on {int(same.sum())}/8 trees")
    return launches


def bandit(torch, device):
    """Phase 5: B=1024 bandit trees, share of exact-optimum actions."""
    from repro_torch import rng
    from repro_torch.core import SearchSpec, build_searcher
    from repro_torch.envs import make_bandit_tree, solve_bandit_tree

    depth, actions, b = 6, 4, BANDIT_B
    env = make_bandit_tree(depth=depth, num_actions=actions)
    _, best_action, q_root = solve_bandit_tree(depth, actions, seed=0)
    roots = env.init(rng.split(rng.PRNGKey(0, device=device), b))
    rngs = rng.split(rng.PRNGKey(1, device=device), b)
    shares = {}
    for algo in KINDS:
        spec = SearchSpec(algo=algo, batch=b, num_simulations=128, wave_size=16,
                          max_depth=depth, max_sim_steps=depth, max_width=actions,
                          gamma=1.0)
        t0 = time.perf_counter()
        res = build_searcher(env, spec, device=device)(roots, rngs)
        sync(device)
        wall = time.perf_counter() - t0
        shares[algo] = float((res.action == best_action).float().mean())
        print(f"bandit d={depth} A={actions} B={b} {algo}: optimal-action share "
              f"{shares[algo]!r} ({b / wall!r} searches/s)")
    print(f"bandit optimum: action {best_action}, Q_root {q_root.tolist()}")
    if not shares["wu_uct"] > 1.0 / actions:
        raise AssertionError(f"wu_uct optimal share {shares['wu_uct']} is not above chance")


def single_root(torch, device):
    """Phase 6: batch=0 and two moves of play_episode on the tap game."""
    from repro_torch import rng
    from repro_torch.core import SearchSpec, build_searcher, play_episode
    from repro_torch.envs import make_tap_game
    from repro_torch.envs.base import map_state

    env = make_tap_game(6, 4, goal_count=10, step_budget=20)
    spec = SearchSpec(algo="wu_uct", batch=0, num_simulations=128, wave_size=16,
                      max_depth=10, max_width=5, max_sim_steps=20)
    search = build_searcher(env, spec, device=device)
    root = map_state(lambda x: x[0], env.init(rng.PRNGKey(3, device=device)[None]))
    res = search(root, rng.PRNGKey(4, device=device))
    if res.root_n.shape != (36,) or not 0 < int(res.root_n.sum()) <= 128:
        raise AssertionError(f"single-root search gave root_n {res.root_n.tolist()}")
    ret, moves, done = play_episode(env, spec.config, rng.PRNGKey(5, device=device),
                                    max_moves=2, searcher=search, device=device)
    if moves < 1 or not math.isfinite(ret):
        raise AssertionError(f"play_episode gave return {ret}, moves {moves}")
    print(f"single root: action {int(res.action)}; play_episode 2 moves: "
          f"return {ret!r}, moves {moves}, done {done}")


def main():
    import torch

    phase("1. card")
    card_info(torch)
    device = torch.device("cuda", 0)

    phase("2. build")
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build(["tree_select"])
    print(f"built tree_select in {time.perf_counter() - t0!r} s")
    for name, log in _build.BUILD_LOGS.items():
        print(f"nvcc {name}:\n{log.strip()}")

    phase("3. kernels against their plain versions")
    fields = check_tree_select(torch, device)

    phase("4. main path")
    launches = main_path(torch, device)

    phase("5. bandit tree")
    bandit(torch, device)

    phase("6. single root")
    single_root(torch, device)

    kernels = [{
        "name": "tree_select",
        "route": "cuda",
        "source": "src/repro_torch/csrc/tree_select.cu",
        "replaces": "src/repro/kernels/tree_select/tree_select.py:139",
        "launches": launches["tree_select"],
        **fields,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
