#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the script exits non-zero):

1. print the card's name and power limit (``nvidia-smi``); require CUDA;
2. build the port's three CUDA kernels from ``src/repro_torch/csrc`` with
   nvcc, one process per kernel, all at once;
3. hold each kernel against its plain PyTorch version on the card (the
   attention kernels in float32 and bfloat16 over a grid of shapes and the
   shapes phases 7-9 drive), and time kernel, plain version and one
   PyTorch library call at the main paths' shapes;
4. the rollout main path: ``build_searcher`` on the tap game answers 256
   searches (the paper's W=16, T=128) through the ``tree_select`` kernel;
   its launch count must cover every selection, and 8 of the trees are
   re-searched by the port on the CPU with the same keys;
5. the bandit tree at B=1024 for the four algos, against the exact optimum;
6. the single-root path: ``batch=0`` and two moves of ``play_episode``;
7. the model-guided main path: llama3-8b at full width and depth (bf16,
   random parameters from a seed), 8 async WU-UCT searches with the
   KV-cached evaluator; every decode step goes through ``decode_attention``
   (32 launches per step); then a warm second call under torch.profiler
   (device activity: busy share and the top kernels);
8. the uncached path: ``ModelEvaluator`` on the wave engine at the same
   width; every forward goes through ``flash_attention`` (32 per forward);
9. agreement on the card: cached prefill vs flash forward vs decode step
   logits (full width, 2 layers, float32), and the reduced model's cached
   search on the GPU against the port on the CPU.

The line before the last is a JSON object with each kernel's launches on
its main path (phase 4, 7 or 8), error against its plain version, time,
plain time, bound and library time; the last line is
``{"ok": true, "device": {...}}``.

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
BF16_OPS_PER_S = 989e12       # H100 SXM dense bf16 tensor cores
MAIN_B, MAIN_A = 256, 36      # tap game 6x6: 256 trees, 36 actions
BANDIT_B = 1024
KINDS = ("wu_uct", "uct", "treep", "treep_vc")
KERNELS = ("tree_select", "decode_attention", "flash_attention")
# The model-guided paths (phases 7 and 8): llama3-8b, a 128-token prompt,
# 160-token sequences, top-8 actions, EOS token 1.
LM_LAYERS = 32                # full depth; cut here first if phase 7 runs long
PROMPT_LEN, MAX_LEN, TOP_K, EOS = 128, 160, 8, 1
ASYNC_B, ASYNC_W = 8, 16
WAVE_B, WAVE_W = 2, 4
REDUCED_MAX_LEN = 20          # phase 9.2's token sequences
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


# ---------------------------------------------------------------------------
# Attention kernels against their plain versions
# ---------------------------------------------------------------------------

# float32: the kernels sum the D products and the keys in another order
# than cuBLAS does for the plain version (errors ~1e-6 of |V|).  bfloat16:
# both compute in float32 from the same bf16 inputs and round the output
# once, so they differ by at most one bf16 ulp (2^-8 relative; 2^-7 taken
# for margin) plus the float32 noise.
ATTN_TOL = {"float32": (5e-5, 5e-5), "bfloat16": (1e-5, 2.0 ** -7)}
# Rows of the plain decode version per call: bounds its float32 copies.
REF_ROWS = 128


def attention_err(torch, out, ref, dtype_name, what):
    """Max |out - ref|; raises where it exceeds atol + rtol * |ref|."""
    atol, rtol = ATTN_TOL[dtype_name]
    diff = (out.float() - ref.float()).abs()
    bad = diff > atol + rtol * ref.float().abs()
    if bool(bad.any()) or not bool(torch.isfinite(out.float()).all()):
        raise AssertionError(f"{what}: kernel differs from its plain version by up to "
                             f"{float(diff.max())!r} ({int(bad.sum())} elements out of "
                             f"atol={atol}, rtol={rtol})")
    return float(diff.max())


def decode_inputs(torch, gen, n, s, hq, hkv, d, dtype, device, min_len=0):
    q = torch.randn((n, hq, d), generator=gen, device=device).to(dtype)
    k = torch.randn((n, s, hkv, d), generator=gen, device=device).to(dtype)
    v = torch.randn((n, s, hkv, d), generator=gen, device=device).to(dtype)
    lens = torch.randint(min_len, s + 1, (n,), generator=gen, device=device,
                         dtype=torch.int32)
    if min_len == 0 and n >= 5:
        # Cover 0, 1, S and lengths off the 32-key tile.
        for i, x in enumerate((0, 1, s, min(s, 33), max(0, s - 1))):
            lens[i] = x
    return q, k, v, lens


def check_decode(torch, device, lm_shapes):
    """decode_attention vs its plain version over the grid and the driven
    shapes, float32 and bfloat16; returns the max error."""
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref

    gen = torch.Generator(device=device).manual_seed(11)
    shapes = [(n, s, hq, hkv, d) for n in (1, 128, 1000) for s in (1, 160, 4096)
              for hq, hkv in ((32, 8), (8, 8), (4, 1)) for d in (64, 128)] + lm_shapes
    max_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for n, s, hq, hkv, d in shapes:
            q, k, v, lens = decode_inputs(torch, gen, n, s, hq, hkv, d, dtype, device)
            out = decode_attention(q, k, v, lens)
            sync(device)
            for r0 in range(0, n, REF_ROWS):
                rows = slice(r0, r0 + REF_ROWS)
                ref = decode_attention_ref(q[rows], k[rows], v[rows], lens[rows])
                what = f"decode_attention {name} N={n} S={s} Hq/Hkv={hq}/{hkv} D={d}"
                max_err = max(max_err, attention_err(torch, out[rows], ref, name, what))
            if not bool((out[lens == 0] == 0).all()):
                raise AssertionError("decode_attention: a kv_len = 0 row is not zero")
            del q, k, v, out
    print(f"decode_attention matches its plain version: {len(shapes)} shapes x "
          f"(float32, bfloat16), N in (1, 128, 1000), S in (1, 160, 4096), Hq/Hkv in "
          f"(32/8, 8/8, 4/1), D in (64, 128), kv_len covering 0, 1, S and off-tile, "
          f"plus the driven shapes {lm_shapes}; max |kernel - plain| = {max_err!r}")
    return max_err


def check_flash(torch, device, lm_shapes):
    """flash_attention vs its plain version; returns the max error."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

    gen = torch.Generator(device=device).manual_seed(12)
    shapes = [(b, s, hq, hkv, d) for b in (1, 8) for s in (1, 7, 160, 1024)
              for hq, hkv in ((32, 8), (8, 8), (4, 1)) for d in (64, 128)] + lm_shapes
    max_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for b, s, hq, hkv, d in shapes:
            q = torch.randn((b, s, hq, d), generator=gen, device=device).to(dtype)
            k = torch.randn((b, s, hkv, d), generator=gen, device=device).to(dtype)
            v = torch.randn((b, s, hkv, d), generator=gen, device=device).to(dtype)
            out = flash_attention(q, k, v)
            sync(device)
            what = f"flash_attention {name} B={b} S={s} Hq/Hkv={hq}/{hkv} D={d}"
            max_err = max(max_err, attention_err(torch, out, flash_attention_ref(q, k, v),
                                                 name, what))
    print(f"flash_attention matches its plain version: {len(shapes)} shapes x "
          f"(float32, bfloat16), B in (1, 8), S in (1, 7, 160, 1024), Hq/Hkv in "
          f"(32/8, 8/8, 4/1), D in (64, 128), plus the driven shapes {lm_shapes}; "
          f"max |kernel - plain| = {max_err!r}")
    return max_err


def time_decode(torch, device):
    """Kernel, plain version and SDPA at phase 7's decode shape: 128 slots,
    32/8 heads, D=128, a 160-entry bf16 cache, lengths 129..160."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref

    n, s, hq, hkv, d = ASYNC_B * ASYNC_W, MAX_LEN, 32, 8, 128
    gen = torch.Generator(device=device).manual_seed(13)
    q, k, v, lens = decode_inputs(torch, gen, n, s, hq, hkv, d, torch.bfloat16, device,
                                  min_len=PROMPT_LEN + 1)
    err = attention_err(torch, decode_attention(q, k, v, lens),
                        decode_attention_ref(q, k, v, lens), "bfloat16", "timed decode")
    k_ms = time_ms(torch, lambda: decode_attention(q, k, v, lens), 500)
    p_ms = time_ms(torch, lambda: decode_attention_ref(q, k, v, lens), 50)
    # The library call: SDPA over [B, H, L, D] views with a per-row length
    # mask and grouped KV heads.
    mask = (torch.arange(s, device=device)[None, :] < lens[:, None])[:, None, None, :]
    qs, ks, vs = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
    lib = lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, enable_gqa=True)
    lib_ms = time_ms(torch, lib, 500)
    valid = int(lens.sum())
    nbytes = 2 * (2 * n * hq * d + 2 * valid * hkv * d) + 4 * n
    ops = 4 * d * hq * valid
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S) * 1e3
    print(f"decode_attention bf16 N={n} S={s} 32/8 D=128 (kv_len sum {valid}): kernel "
          f"{k_ms * 1e3!r} us, plain {p_ms * 1e3!r} us, SDPA {lib_ms * 1e3!r} us, bound "
          f"{bound_ms * 1e3!r} us ({nbytes} bytes, {ops} flops); |kernel - plain| {err!r}")
    return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": lib_ms}


def time_flash(torch, device):
    """Kernel, plain version and SDPA at phase 8's forward shape: 8 rows of
    160 tokens, 32/8 heads, D=128, bf16."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

    b, s, hq, hkv, d = WAVE_B * WAVE_W, MAX_LEN, 32, 8, 128
    gen = torch.Generator(device=device).manual_seed(14)
    q = torch.randn((b, s, hq, d), generator=gen, device=device).to(torch.bfloat16)
    k = torch.randn((b, s, hkv, d), generator=gen, device=device).to(torch.bfloat16)
    v = torch.randn((b, s, hkv, d), generator=gen, device=device).to(torch.bfloat16)
    err = attention_err(torch, flash_attention(q, k, v), flash_attention_ref(q, k, v),
                        "bfloat16", "timed flash")
    k_ms = time_ms(torch, lambda: flash_attention(q, k, v), 200)
    p_ms = time_ms(torch, lambda: flash_attention_ref(q, k, v), 50)
    qs, ks, vs = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    lib = lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)
    lib_ms = time_ms(torch, lib, 200)
    nbytes = 2 * (2 * b * s * hq * d + 2 * b * s * hkv * d)
    ops = 4 * d * (s * (s + 1) // 2) * b * hq          # QK and PV over the causal half
    bound_s = {"bytes": nbytes / HBM_BYTES_PER_S, "operations": ops / BF16_OPS_PER_S}
    bound_by = max(bound_s, key=bound_s.get)
    bound_ms = bound_s[bound_by] * 1e3
    print(f"flash_attention bf16 B={b} S={s} 32/8 D=128: kernel {k_ms * 1e3!r} us, plain "
          f"{p_ms * 1e3!r} us, SDPA {lib_ms * 1e3!r} us, bound {bound_ms * 1e3!r} us "
          f"(by {bound_by}: {nbytes} bytes, {ops} flops); |kernel - plain| {err!r}")
    return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms}


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


# ---------------------------------------------------------------------------
# Model-guided search (phases 7-9)
# ---------------------------------------------------------------------------


def lm_setup(torch, device, layers, dtype, seed):
    """llama3-8b at full width with ``layers`` layers, random parameters
    from the port's ``init_params`` on the card."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = dataclasses.replace(get_config("llama3-8b"), num_layers=layers, dtype=dtype)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(seed))
    sync(device)
    print(f"llama3-8b {layers} layers {dtype}: {cfg.param_count()} parameters made on "
          f"the card in {time.perf_counter() - t0!r} s")
    return cfg, params


def prompt_tokens(torch, vocab, n, seed):
    """A prompt of ``n`` tokens from a seed (no EOS, no padding id)."""
    return torch.from_numpy(np.random.default_rng(seed).integers(2, vocab, size=n)
                            .astype(np.int32))


def search_results_ok(torch, res, spec, what):
    tried = res.root_n > 0
    finite = (torch.isfinite(res.root_n).all() & torch.isfinite(res.max_o).all()
              & torch.isfinite(res.root_v[tried]).all())
    if not bool(finite):
        raise AssertionError(f"{what}: non-finite search results")
    if not bool(((res.action >= 0) & (res.action < TOP_K)).all()):
        raise AssertionError(f"{what}: actions {res.action.tolist()} outside [0, {TOP_K})")
    if not bool((res.root_n.sum(1) <= spec.num_simulations).all()):
        raise AssertionError(f"{what}: root visit counts exceed T")
    if bool(res.overflowed.any()):
        raise AssertionError(f"{what}: a tree overflowed its capacity")


def model_guided(torch, device, cfg, params):
    """Phase 7: 8 async WU-UCT searches over llama3-8b with the KV-cached
    evaluator; one decode step (32 decode_attention launches) per tick."""
    from repro_torch import rng
    from repro_torch.core import CachedModelEvaluator, SearchSpec, build_searcher
    from repro_torch.envs import make_token_env
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import CALLS, reset_calls
    from repro_torch.sync import SYNCS, reset_syncs

    prompt = prompt_tokens(torch, cfg.vocab_size, PROMPT_LEN, seed=2).to(device)
    env = make_token_env(cfg, params, prompt, max_len=MAX_LEN, top_k=TOP_K, eos_token=EOS)
    ev = CachedModelEvaluator(cfg, params, top_k=TOP_K, eos_token=EOS)
    spec = SearchSpec(algo="wu_uct", engine="async", batch=ASYNC_B, num_simulations=64,
                      wave_size=ASYNC_W, max_depth=8, max_sim_steps=8, max_width=8,
                      gamma=1.0)
    search = build_searcher(env, spec, evaluator=ev, device=device)
    roots = env.init(rng.split(rng.PRNGKey(0, device=device), ASYNC_B))
    rngs = rng.split(rng.PRNGKey(1, device=device), ASYNC_B)
    sync(device)
    torch.cuda.reset_peak_memory_stats(device)

    reset_launches()
    reset_calls()
    reset_syncs()
    t0 = time.perf_counter()
    res = search(roots, rngs)
    sync(device)
    wall = time.perf_counter() - t0
    launches, calls, syncs = dict(LAUNCHES), dict(CALLS), SYNCS["host_any"]

    steps = calls["decode_step"]
    if steps == 0 or launches["decode_attention"] < cfg.num_layers * steps:
        raise AssertionError(f"decode_attention launched {launches['decode_attention']} "
                             f"times for {steps} decode steps of {cfg.num_layers} layers")
    search_results_ok(torch, res, spec, "model-guided search")
    peak = torch.cuda.max_memory_allocated(device)
    print(f"model-guided path: llama3-8b {cfg.num_layers} layers bf16, async wu_uct "
          f"B={ASYNC_B} W={ASYNC_W} T={spec.num_simulations}, prompt {PROMPT_LEN}, "
          f"max_len {MAX_LEN}, top_k {TOP_K}: {ASYNC_B / wall!r} searches/s (wall {wall!r} "
          f"s, first call), master ticks {int(res.ticks.max())}, model calls {calls}, "
          f"launches {launches}, host syncs {syncs}, peak memory {peak / 2 ** 30!r} GiB; "
          f"actions {res.action.tolist()}, root_n sums {res.root_n.sum(1).tolist()}")
    profile_call(torch, device, lambda: search(roots, rngs), "model-guided path")
    return launches


def profile_call(torch, device, fn, what, top=10):
    """Run ``fn`` once more (warm) under torch.profiler: wall, the card's
    busy share and the kernels that took the device time.  Only device
    activity is traced: the host-side events of a call that launches
    ~600,000 kernels take minutes to summarise."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync(device)
        wall = time.perf_counter() - t0
    rows = [(evt.self_device_time_total, evt.count, evt.key) for evt in prof.key_averages()
            if evt.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(r[0] for r in rows) * 1e-6
    print(f"{what}, second call under torch.profiler: wall {wall!r} s, device busy "
          f"{busy!r} s ({busy / wall!r} of wall), {sum(r[1] for r in rows)} device kernels")
    for dev_us, count, key in sorted(rows, reverse=True)[:top]:
        print(f"  {dev_us * 1e-3!r} ms  {count} x  {key[:100]}")


def uncached(torch, device, cfg, params):
    """Phase 8: ModelEvaluator on the wave engine; every forward (the
    environment's steps and the tick-driven rollouts) runs flash_attention
    in each of its 32 layers."""
    from repro_torch import rng
    from repro_torch.core import ModelEvaluator, SearchSpec, build_searcher
    from repro_torch.envs import make_token_env
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import CALLS, reset_calls
    from repro_torch.sync import SYNCS, reset_syncs

    prompt = prompt_tokens(torch, cfg.vocab_size, PROMPT_LEN, seed=2).to(device)
    env = make_token_env(cfg, params, prompt, max_len=MAX_LEN, top_k=TOP_K, eos_token=EOS)
    ev = ModelEvaluator(cfg, params, top_k=TOP_K, eos_token=EOS)
    spec = SearchSpec(algo="wu_uct", engine="wave", batch=WAVE_B, num_simulations=8,
                      wave_size=WAVE_W, max_depth=8, max_sim_steps=8, max_width=8,
                      gamma=1.0)
    search = build_searcher(env, spec, evaluator=ev, device=device)
    roots = env.init(rng.split(rng.PRNGKey(0, device=device), WAVE_B))
    rngs = rng.split(rng.PRNGKey(1, device=device), WAVE_B)
    sync(device)

    reset_launches()
    reset_calls()
    reset_syncs()
    t0 = time.perf_counter()
    res = search(roots, rngs)
    sync(device)
    wall = time.perf_counter() - t0
    launches, calls, syncs = dict(LAUNCHES), dict(CALLS), SYNCS["host_any"]

    fwd = calls["forward"]
    if fwd == 0 or launches["flash_attention"] < cfg.num_layers * fwd:
        raise AssertionError(f"flash_attention launched {launches['flash_attention']} "
                             f"times for {fwd} forwards of {cfg.num_layers} layers")
    search_results_ok(torch, res, spec, "uncached search")
    print(f"uncached path: ModelEvaluator, wave wu_uct B={WAVE_B} W={WAVE_W} "
          f"T={spec.num_simulations}: {WAVE_B / wall!r} searches/s (wall {wall!r} s, "
          f"first call), model calls {calls}, launches {launches}, host syncs {syncs}; "
          f"actions {res.action.tolist()}")
    return launches


# Logits of a 2-layer full-width model in float32: the three paths compute
# the same float32 function and differ only in summation order (chunked
# einsum vs the kernels' loops over keys and head dims), ~1e-6 relative
# to logits of magnitude ~1; 1e-4 leaves two orders of margin.
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)


def agreement_full_width(torch, device):
    """Phase 9.1: prefill_ragged (plain chunked attention) vs forward (flash
    kernel) at each row's last position, then one decode_step (decode
    kernel) vs forward of the extended rows; 2 layers, float32, no TF32."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import decode_step, init_cache, logits_at, prefill_ragged

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cfg, params = lm_setup(torch, device, 2, torch.float32, seed=3)
    gen = torch.Generator(device=device).manual_seed(5)
    r, s = 4, 24
    toks = torch.randint(2, cfg.vocab_size, (r, s), generator=gen, device=device,
                         dtype=torch.int32)
    lens = torch.tensor([5, 12, 17, 23], dtype=torch.int32, device=device)
    reset_launches()
    pre, cache = prefill_ragged(params, cfg, toks, lens, init_cache(cfg, r, s, device=device))
    full = logits_at(params, cfg, toks, lens - 1)
    if (LAUNCHES["flash_attention"], LAUNCHES["decode_attention"]) != (2, 0):
        raise AssertionError(f"prefill + forward launched {LAUNCHES}: expected the flash "
                             "kernel in the forward's 2 layers and nothing in the prefill")
    d1 = float((pre - full).abs().max())
    torch.testing.assert_close(pre, full, **LOGIT_TOL)
    nxt = torch.randint(2, cfg.vocab_size, (r,), generator=gen, device=device,
                        dtype=torch.int32)
    dec, _ = decode_step(params, cfg, nxt, cache)
    if LAUNCHES["decode_attention"] != 2:
        raise AssertionError(f"the decode step launched {LAUNCHES}: expected 2 decode kernels")
    ext = toks.clone()
    ext[torch.arange(r, device=device), lens.long()] = nxt
    full2 = logits_at(params, cfg, ext, lens)
    d2 = float((dec - full2).abs().max())
    torch.testing.assert_close(dec, full2, **LOGIT_TOL)
    print(f"full width, 2 layers, float32: max |prefill - forward| = {d1!r}, max |decode "
          f"step - forward| = {d2!r} (logits up to {float(full.abs().max())!r}; "
          f"tolerance {LOGIT_TOL})")


def agreement_reduced(torch, device):
    """Phase 9.2: the reduced model's async cached search on the GPU and on
    the port's CPU path, same keys and parameters."""
    from repro_torch import rng
    from repro_torch.configs import get_reduced
    from repro_torch.core import CachedModelEvaluator, SearchSpec, build_searcher
    from repro_torch.envs import make_token_env
    from repro_torch.models import init_params
    from repro_torch.models.lm import tree_map

    cfg = get_reduced("llama3-8b", vocab_size=64, num_layers=2)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(4))
    spec = SearchSpec(algo="wu_uct", engine="async", batch=8, num_simulations=32,
                      wave_size=4, max_depth=6, max_sim_steps=6, max_width=TOP_K, gamma=1.0)
    results = []
    for dev in (device, torch.device("cpu")):
        p = tree_map(lambda x: x.to(dev), params)
        env = make_token_env(cfg, p, prompt_tokens(torch, 64, 8, seed=6).to(dev),
                             max_len=REDUCED_MAX_LEN, top_k=TOP_K, eos_token=EOS)
        ev = CachedModelEvaluator(cfg, p, top_k=TOP_K, eos_token=EOS)
        roots = env.init(rng.split(rng.PRNGKey(7, device=dev), 8))
        results.append(build_searcher(env, spec, evaluator=ev, device=dev)(
            roots, rng.split(rng.PRNGKey(8, device=dev), 8)))
    gpu, cpu = results
    search_results_ok(torch, gpu, spec, "reduced search on the GPU")
    same = gpu.action.cpu() == cpu.action
    for i in np.flatnonzero(~same.numpy()):
        print(f"reduced search tree {i}: GPU action {int(gpu.action[i])}, CPU action "
              f"{int(cpu.action[i])} (root_n GPU {gpu.root_n[i].cpu().tolist()} CPU "
              f"{cpu.root_n[i].tolist()})")
    if int(same.sum()) < 7:
        raise AssertionError(f"GPU and CPU reduced searches agree on {int(same.sum())} of 8")
    print(f"reduced llama3-8b (vocab 64, 2 layers) async cached search: GPU and CPU port "
          f"agree on {int(same.sum())}/8 trees; root_n equal on "
          f"{int((gpu.root_n.cpu() == cpu.root_n).all(1).sum())}/8")


def main():
    import torch

    phase("1. card")
    card_info(torch)
    device = torch.device("cuda", 0)

    phase("2. build")
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build(list(KERNELS))
    print(f"built {', '.join(KERNELS)} in {time.perf_counter() - t0!r} s (in parallel)")
    for name, log in _build.BUILD_LOGS.items():
        print(f"nvcc {name}:\n{log.strip()}")

    phase("3. kernels against their plain versions")
    fields = {"tree_select": check_tree_select(torch, device)}
    # Driven shapes beyond the grids: phase 9.1 (4 rows, 24 positions, full
    # width) and phase 9.2 (the reduced model's 8 x 4 slots, 4/2 heads, D=16).
    err = check_decode(torch, device, [(4, 24, 32, 8, 128),
                                       (8 * 4, REDUCED_MAX_LEN, 4, 2, 16)])
    fields["decode_attention"] = {"max_abs_err": err, **time_decode(torch, device)}
    err = check_flash(torch, device, [(4, 24, 32, 8, 128)])
    fields["flash_attention"] = {"max_abs_err": err, **time_flash(torch, device)}

    phase("4. main path")
    launches = {"tree_select": main_path(torch, device)["tree_select"]}

    phase("5. bandit tree")
    bandit(torch, device)

    phase("6. single root")
    single_root(torch, device)

    phase("7. model-guided main path (KV-cached async search)")
    cfg, params = lm_setup(torch, device, LM_LAYERS, torch.bfloat16, seed=1)
    launches["decode_attention"] = model_guided(torch, device, cfg, params)["decode_attention"]

    phase("8. uncached path (ModelEvaluator, wave engine)")
    launches["flash_attention"] = uncached(torch, device, cfg, params)["flash_attention"]
    del params
    torch.cuda.empty_cache()

    phase("9. agreement on the card")
    agreement_full_width(torch, device)
    agreement_reduced(torch, device)

    sources = {"tree_select": "src/repro/kernels/tree_select/tree_select.py:139",
               "decode_attention": "src/repro/kernels/decode_attention/decode_attention.py:213",
               "flash_attention": "src/repro/kernels/flash_attention/flash_attention.py:120"}
    kernels = [{
        "name": name,
        "route": "cuda",
        "source": f"src/repro_torch/csrc/{name}.cu",
        "replaces": sources[name],
        "launches": launches[name],
        **fields[name],
    } for name in KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
