#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the script exits non-zero):

1. print the card's name and power limit (``nvidia-smi``); require CUDA;
2. build the port's CUDA libraries from ``src/repro_torch/csrc`` with
   nvcc, one process per library, all at once (ten kernels in eight
   libraries: ``tree_select`` holds the walk and the per-level kernel,
   ``tree_decode_attention`` the dense and the paged tree kernel;
   ``flash_attention_bwd`` the launches of the attention backward,
   ``ssd_scan_bwd`` the launches of the scan's backward),
   and summarise ptxas's registers, spills and static shared memory of
   ``tree_select``, ``flash_attention`` (bf16 on the tensor cores, float32 on the
   CUDA cores), ``decode_attention`` (the key-split body),
   ``tree_decode_attention`` (the body over a shared-memory copy of the
   prefix), ``ssd_scan`` (bf16 B/C on the tensor cores: the chunk kernel
   and the state kernel; float32 on the CUDA cores), ``flash_attention_bwd`` (bf16 on the
   tensor cores, float32 on the CUDA cores) and ``ssd_scan_bwd`` (bf16
   B/C on the tensor cores, float32 on the CUDA cores);
3. hold each kernel against its plain PyTorch version on the card (the
   tree walk ``tree_descend``, bit for bit, on trees the port grows on the
   card: phase 4's tap cell at B=256 and B=1 and phase 5's bandit tree at
   B=1024, two waves and a pending third selection, four kinds; the
   per-level ``tree_select`` bit for bit on adversarial tables; the
   attention kernels in float32 and bfloat16 over a grid of shapes and the
   shapes phases 7-23 drive (the new families' head layouts 40/10, 40/8,
   64/8, 16/16 at D=128 and 64/4, 12/12 at D=64), ``flash_attention``
   also at zamba2's D=112,
   the tree kernels also with prefixes longer than their shared-memory
   copy and A=32; ``decode_attention``'s options for placed caches, its
   log-sum-exp output (``out`` float32 and ``lse`` against the plain
   version, the output without it bit-equal to that ``out`` rounded once)
   and its head window (whole groups, part of a group, across two groups:
   bit-equal to those heads of the whole call);
   ``flash_attention``'s log-sum-exp output and its backward
   ``flash_attention_bwd`` in float32 and bf16 (phase 24's shape among
   them, D=32 at G=8; ``out`` bit-equal with and without the log-sum-exp,
   a second backward bit-equal to the first; the backward timed by kernel),
   ``ssd_scan`` with float32 and bfloat16 B/C over a grid, the driven
   shapes and phase 24(c)'s training shapes, and against the sequential
   recurrence too, and its final state
   (``return_state``) over the grid and phase 20's prefill shapes, timed
   at mamba2's and zamba2's; the forward also timed at both training
   shapes, by kernel (no CUDA-core kernel may run for bf16 B/C); its
   backward ``ssd_scan_bwd`` over the grid
   and phase 24(c)'s training shapes in both types, a second call
   bit-equal, autograd through ``ssd_scan`` (``y`` bit-equal to the
   no-grad call, the backward on the forward's saved states), timed at
   both training shapes beside the float32 body
   on the same B/C upcast, by kernel, with the tensor-core kernels'
   registers and spills, and given the saved states, and
   ``flash_attention_bwd`` also at zamba2's D=112), and time kernel,
   plain version and one PyTorch library call at the main paths' shapes
   (the paged and tree kernels have no single library call: a gather or
   concatenation plus SDPA is timed beside them as a two- or three-call
   yardstick; no PyTorch call computes the SSD scan), each kernel and
   yardstick both paced by the host's enqueue and as device time by
   CUDA-graph replay; ``ssd_scan`` at phase 13's and phase 14's shapes;
   the walk on phase 4's forest as it stands at each of the call's eight
   waves, beside the plain lockstep loop, with its byte bound counted from
   the paths walked and a latency floor from a pointer chase in L2 (the
   kernels line takes the mean per walk over the waves);
4. the rollout main path: ``build_searcher`` on the tap game answers 256
   searches (the paper's W=16, T=128), each traversal one launch of the
   ``tree_descend`` kernel: exactly 128 walks and no per-level
   ``tree_select`` launch; the host syncs are printed, and 8 of the trees
   are re-searched by the port on the CPU with the same keys;
5. the bandit tree at B=1024 for the four algos, against the exact optimum;
6. the single-root path: ``batch=0`` and two moves of ``play_episode``;
7. the model-guided main path: llama3-8b at full width and depth (32
   layers, ``LM_LAYERS``), bf16, random parameters from a seed, 8 async WU-UCT searches with the KV-cached
   evaluator; every decode step goes through ``decode_attention`` (one
   launch per layer and step); then a warm second call under torch.profiler
   (device activity: busy share and the top kernels);
8. the uncached path: ``ModelEvaluator`` on the wave engine at the same
   width; every forward goes through ``flash_attention`` (one per layer);
10. the paged path, while llama3-8b is loaded: phase 7's searches with
    ``PagedCachedModelEvaluator`` (16-token blocks, 1280 blocks: the dense
    equivalent); every paged decode step goes through
    ``paged_decode_attention``;
11. the dense frontier path: phase 7's searches with
    ``FrontierModelEvaluator``; every frontier forward goes through
    ``tree_decode_attention``, every plain step through
    ``decode_attention``; ``tree_decode_attention`` must equal
    ``decode_attention`` with each candidate's entry appended, bit for bit;
    then the same path with the parameters cut to one layer, held to the
    cached search;
12. the paged frontier path: ``PagedFrontierModelEvaluator``; every
    frontier forward goes through ``paged_tree_decode_attention``; then a
    warm second call under torch.profiler;
13. the SSM main path: mamba2-2.7b at full width and depth (64 layers,
    bf16, random parameters from a seed), phase 7's cell with
    ``ModelEvaluator`` (one forward of all 128 slots per master tick);
    every forward goes through ``ssd_scan`` (64 launches per forward); then
    a warm second call under torch.profiler;
14. the hybrid path: zamba2-7b at full width and depth (81 SSM layers and
    14 sites of its shared attention block, bf16), phase 8's wave cell with
    ``ModelEvaluator``; 81 ``ssd_scan`` and 14 ``flash_attention``
    (D=112) launches per forward;
15. the paper's baselines: LeafP and RootP (K = 16) on 8 single roots of
    phase 4's tap game (T=128, W=16, width 5): exactly T/W and T/K
    ``tree_descend`` launches per search and no ``tree_select``, the 8
    roots re-searched on the CPU (at least 7 of 8 actions equal); on 16
    single roots of phase 5's bandit tree, the optimal-action share beside phase
    5's (RootP above chance); wu_uct on the random MDP at B=256 (8 trees
    against the CPU);
16. trace mode: phase 5's bandit tree on the async engine (B=256, W=16)
    traced for T + 2 = 130 ticks (the slowest tree settles in about 33;
    every tree must have settled), O conservation on every
    tick and tree and O = 0 at the end, checked on the host; the
    reduced llama (2 layers, float32) with the cached and paged evaluators:
    every busy slot's cache depth equals its prefix, the pool's working set
    stays within its blocks;
17. host-paced serving, while llama3-8b is loaded (after phase 12), over
    its first 8 layers (``SERVE_LAYERS``; cut from full depth for time):
    ``SearchService(fused=False)`` in phase 7's cell drains 16 ragged
    prompts arriving in two bursts of 8, dense then paged (phase 10's
    pool): one valid action each, one decode-kernel launch per layer and decode
    step, every page free after the paged drain; one warm burst under the
    profiler; the mid-run admissions against a fresh batch are printed;
    17.2 (after phase 9) holds them at 2 float32 layers (7 of 8);
18. fused ring serving, after phase 17: the default ``SearchService()``
    (its request ring) drains phase 17's prompts, dense then paged: the
    same checks, the ring empty and its tables at the sentinel after each
    drain, the actions against phase 17's printed; 18.2 (with 17.2) holds
    fused = host-paced at 2 float32 layers in the four evaluator modes
    (dense, paged, frontier, paged frontier: action, root_n and ticks
    equal, root_v within 1e-6);
19. LM serving: ``ServingEngine`` over phase 17's 8 layers of llama3-8b,
    8 slots, 16 ragged prompts, at most 32 new tokens, greedy, dense then
    paged: one decode-kernel launch per layer and decode step, every request done,
    no block in use after; 19.2 (after 18.2) at 2 float32 layers, at least
    15 of 16 requests equal greedy decoding through ``forward``;
20. recurrent serving: ``ServingEngine`` over mamba2-2.7b (after phase 13)
    and zamba2-7b (after 14), 8 slots, 8 prompts, 16 new tokens: one
    ``ssd_scan`` (with its final state) per layer and prompt prefilled,
    none in a decode step, 14 ``decode_attention`` launches per zamba2
    decode step; 20.2 at 2 float32 layers, ``prefill`` and 3 decode
    steps against ``forward``'s logits;
21. the dense configs (after phase 20's zamba2, one model at a time, bf16):
    ``ServingEngine`` dense, phase 20's cell (8 slots, 8 prompts, 16 new
    tokens, greedy) over phi3-medium-14b and qwen2.5-32b at full depth and
    deepseek-67b at 40 of its 95 layers: every request done, one
    ``decode_attention`` launch per layer and decode step;
22. MoE: qwen2-moe-a2.7b at full width and depth in phase 7's cell with
    the KV-cached evaluator (24 launches per decode step), then
    ``ServingEngine`` dense and paged (no block in use after); then
    qwen3-moe-235b-a22b at 8 of its 94 layers, ``ServingEngine`` dense;
23. the stubs at full depth: llava-next-mistral-7b (8 rows of 576 patch
    embeddings from a seed and a 128-token prompt: ``prefill`` into a
    720-position cache, 16 ``decode_step``\\ s, one ``forward`` over the 704
    positions) and whisper-small (1500 frame embeddings, 64-token
    prompts): ``decode_attention`` once per (self-attention) layer and
    step, ``flash_attention`` once per layer of the forward;
21.2-23.2 (last) at 2 full-width float32 layers: qwen2.5-32b, qwen2-moe,
    qwen3-moe (capacity for every token), llava and whisper ``prefill``
    and 3 decode steps against ``forward``'s logits; qwen2-moe's router
    top-4 on the card against the CPU's; the reduced qwen2-moe's cached,
    frontier and paged frontier searches on the GPU against the CPU;
24. training on the card (after phase 23): (a) llama3-8b at full width,
    8 of its 32 layers, bf16, random weights from a seed, through
    ``launch.train.train``: 7 AdamW steps (1 warm-up, 6 timed) of 8 × 512
    tokens on a repeated ``SyntheticStream`` batch, remat on, the loss
    unchunked: every loss and grad norm finite, the last loss below the
    first, ``flash_attention`` = 2 × 8 launches a step (the forward and its
    recompute) and ``flash_attention_bwd`` = 8; step time, tokens/s, peak
    memory; then one more step under torch.profiler, device ms by group
    (the backward's kernels, the forward flash kernels, GEMMs, AdamW, the
    rest); (c) mamba2-2.7b at full width and depth (64 blocks) and
    zamba2-7b at full width, 24 of its 81 blocks (its shared block at 4
    sites), bf16, 8 × 512 tokens a step, 5 and 3 steps (1 warm-up): the
    same checks, ``ssd_scan`` = 2 × blocks and ``ssd_scan_bwd`` = blocks a
    step (zamba2 also ``flash_attention`` = 2 × 4, ``flash_attention_bwd``
    = 4), then one more mamba2 step profiled by group; (b)
    ``repro_torch.examples.train_policy`` at its default size: the restored
    run reaches its last step; and a grad-requiring input to
    ``ssd_scan(return_state=True)`` and to ``decode_attention`` raises
    (they have no backward); 24.2 one train step at 2 full-width float32
    layers (vocabulary cut to 4096) on the card against the port on the
    CPU; 24.3 (last) the same for mamba2-2.7b and, its gradients only,
    zamba2-7b (its site-0 shared block included);
25. the multi-device layer at world size 1 (last): a one-rank NCCL process
    group (an in-memory store, no sockets) and a ``(1, 1)`` ``('data',
    'model')`` mesh; (a) llama3-8b at 24(a)'s setup (full width, 8 of 32
    layers, bf16, 8 × 512 tokens): one plain train step from a seeded
    init, then the same step from the same seed on parameters placed by
    ``distribute_params`` (AdamW's state in its ZeRO placement) under
    ``tp`` and under ``fsdp``: loss, grad norm and every updated parameter
    bit-equal, the same ``flash_attention``/``flash_attention_bwd``
    launches; (d) mamba2-2.7b at 4 of its 64 blocks under ``tp`` likewise
    (``ssd_scan``/``ssd_scan_bwd``); (b) qwen2-moe-a2.7b's MoE block at
    full width, ``_moe_block_sharded`` on the mesh against
    ``_moe_block_local`` on 8 × 512 bf16 tokens, bit-equal; (c) the search
    cell at its defaults (wave 256, T=1024, d_mlp 8192, bf16 MLP): one
    wave on the mesh against the same wave without one, the tree
    bit-equal, 256 ``tree_descend`` launches; (e), after (a), the decode
    cell: llama3-8b at (a)'s setup over one data rank's share of
    ``decode_32k`` (8 rows of a 32,768-deep bf16 cache at ``len`` 32,767):
    ``decode_step`` plain, then the cell's function on the mesh with its
    arguments placed by ``place_args`` in the ``batch`` and the split-KV
    ``batch+seq_model`` modes, logits and caches bit-equal, 8
    ``decode_attention`` launches a step, 0 wire bytes counted by
    ``CollectiveCounter``; the kernel with its log-sum-exp on 2 and on 4
    parts of S, merged by ``layers.merge_by_lse``, against the unsplit
    kernel (bf16 within one bf16 ulp, float32 within 2e-6 of the row's
    largest |out|); the kernel timed at that shape beside its bound (the
    kernels line's ``decode_attention.decode_32k``); (f) phase 7's cell
    at T=32 (B=8, W=16) over llama3-8b at full width and 2 of 32 layers,
    bf16, in five modes (uncached ``ModelEvaluator``, cached, paged,
    frontier, paged frontier) and over mamba2-2.7b at 2 of 64 blocks with
    ``ModelEvaluator``: ``build_searcher(..., constrain=
    constrain_search_batch)`` on the mesh inside ``CollectiveCounter``
    (the slot aux split over the data ranks, here one rank holding every
    tree), then without it, then on the mesh again under
    ``retrace_guard``: every ``SearchResult`` field bit-equal, the same
    kernel launches, 0 wire bytes, no library load in the guarded call
    and no more host syncs than the first; (g) the request lifecycle of
    (f)'s llama3-8b cell, cached and paged: twelve ragged requests through
    a ring of 4 (``init_ring``, ``stage``, ``serve_segment``) and
    host-paced (``admit``, ``evict``, ``run_segment``), each drain on the
    mesh and without it: each request's ``SearchResult`` bit-equal, the
    same kernel launches, 0 pool blocks in use after the paged drains;
    the paged fused drain on the mesh inside ``CollectiveCounter`` (0
    wire bytes), the paged host-paced one, the second placed paged drain,
    under ``retrace_guard`` (no library load);
9. agreement on the card: cached prefill vs flash forward vs decode step
   logits (full width, 2 layers, float32), the reduced model's cached and
   paged frontier searches on the GPU against the port on the CPU,
   (9.3) phase 7's cell at full width, 2 layers, float32: the paged,
   frontier and paged frontier searches against the cached one, and (9.4)
   mamba2 at full width, 2 layers, float32: ``forward`` through the kernel
   against the same forward with the plain scan, and the reduced mamba2
   (async) and zamba2 (wave) ``ModelEvaluator`` searches on the GPU
   against the port on the CPU.

Phases 15 and 16 run after phase 6; phases 10-12 and 17-19 before phase
9, while phase 7's model is loaded; phases 13 and 14, each followed by its
phase 20, after it is freed, then 21-23 and 24, one model at a time;
17.2 with 18.2, then 19.2, 20.2, 21.2-23.2, 24.2, 24.3 and 25 last.  Phase
10 must choose phase 7's action on at least 7 of 8 trees and phase 12
phase 11's.  Phase 11 prints its agreement with phase 7 without holding
it: in bf16 over 32 random layers the frontier forward, the decode step
and the chunked catch-up round differently, and that changes most rows'
next top-8 tables (phase 11 measures how often).  Phase 11 holds its path
in bf16 with the parameters cut to one layer (top-8 tables kept on at
least 90 % of rows, frontier and paged frontier actions at least 7 of 8
equal to the cached search's), and phase 9.3 holds frontier to cached
decisions in float32.  The line before
the last is a JSON object with each kernel's launches on its main path
(phase 4, 7, 8, 10, 11, 12, 13, 24(a) or 24(c); the ``tree_select`` row reports the
walk that replaced its per-level launches on the main path, and the
per-level kernel under ``level_*`` keys), error against its plain version, time,
plain time, bound, library time and ``bound_share`` (bound / time), and
the device times by graph replay (``device_ms``, ``library_device_ms``,
``device_bound_share``), the launches on phases 21-23's paths
(``family_launches``; phases 24's and 25's too) and ``decode_attention`` timed at qwen2.5-32b's and
qwen3-moe's decode shapes (``family_shapes``); the last line is
``{"ok": true, "device": {...}}``.

Imports nothing of JAX.  Without a CUDA device, or without the rest of the
repository beside it, it fails before printing a result.
"""

from __future__ import annotations

import json
import math
import shutil
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
TRACE_B = 256                 # phase 16's traced bandit forest
KINDS = ("wu_uct", "uct", "treep", "treep_vc")
KERNELS = ("tree_select", "decode_attention", "flash_attention", "paged_decode_attention",
           "tree_decode_attention", "paged_tree_decode_attention", "ssd_scan",
           "flash_attention_bwd", "ssd_scan_bwd")
# The library (``csrc/<name>.cu``) of each kernel, and the TPU kernel it
# replaces (the backwards: the forward's, which has no Pallas backward; the
# reference differentiates XLA's chunked attention and ``ssd_chunked``).
SOURCES = {name: name for name in KERNELS}
SOURCES["paged_tree_decode_attention"] = "tree_decode_attention"
REPLACES = {
    "tree_select": "src/repro/kernels/tree_select/tree_select.py:139",
    "decode_attention": "src/repro/kernels/decode_attention/decode_attention.py:213",
    "flash_attention": "src/repro/kernels/flash_attention/flash_attention.py:120",
    "paged_decode_attention": "src/repro/kernels/decode_attention/decode_attention.py:169",
    "tree_decode_attention":
        "src/repro/kernels/decode_attention/tree_decode_attention.py:161",
    "paged_tree_decode_attention":
        "src/repro/kernels/decode_attention/tree_decode_attention.py:259",
    "ssd_scan": "src/repro/kernels/ssd_scan/ssd_scan.py:99",
    "flash_attention_bwd": "src/repro/kernels/flash_attention/flash_attention.py:120",
    "ssd_scan_bwd": "src/repro/kernels/ssd_scan/ssd_scan.py:99",
}
# The model-guided paths (phases 7 and 8): llama3-8b, a 128-token prompt,
# 160-token sequences, top-8 actions, EOS token 1.
LM_LAYERS = 32                # full depth (phases 7-12)
# Phases 17-19 serve the first 8 of those layers (cut for time: they are
# host-bound, a layer's launches at a time, and the whole run has to fit
# 900 s with phases 24 and 25 added on a slow host; 16 until phase 25(e),
# 12 until phase 25(g)).
SERVE_LAYERS = 8
PROMPT_LEN, MAX_LEN, TOP_K, EOS = 128, 160, 8, 1
ASYNC_B, ASYNC_W = 8, 16
WAVE_B, WAVE_W = 2, 4
# Phases 10 and 12: 16-token blocks, as many as the dense caches' rows.
BLOCK = 16
POOL_BLOCKS = ASYNC_B * ASYNC_W * (-(-MAX_LEN // BLOCK))       # 1280
REDUCED_MAX_LEN = 20          # phase 9.2's and 9.4's token sequences
REDUCED_BLOCK = 4
# Phases 13 and 14: mamba2-2.7b and zamba2-7b at full depth.
SSM_LAYERS, HYBRID_LAYERS = 64, 81
# Phase 4's and phase 5's search settings besides algo and batch (phase 3
# walks their trees).
MAIN_SPEC = dict(num_simulations=128, wave_size=16, max_depth=10, max_width=5,
                 max_sim_steps=20)
BANDIT_SPEC = dict(num_simulations=128, wave_size=16, max_depth=6, max_sim_steps=6,
                   max_width=4, gamma=1.0)
# Child tables each kind reads (f32[B, A]) besides the validity bytes.
TABLES_READ = {"wu_uct": 3, "uct": 2, "treep": 3, "treep_vc": 3}


T0 = time.perf_counter()


def phase(title):
    print(f"== {title} (at {time.perf_counter() - T0:.1f} s)", flush=True)


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


# Libraries whose kernels' ptxas resources are summarised after the build:
# those redesigned for the H100 (the tree walk, bf16 flash and the bf16 SSD
# scan on the tensor cores, the key-split decode, the tree kernels over a
# staged prefix).
PTXAS_SUMMARY = ("tree_select", "flash_attention", "decode_attention", "tree_decode_attention",
                 "ssd_scan", "flash_attention_bwd", "ssd_scan_bwd")


def ptxas_summary(log):
    """One line per kernel of an ``nvcc -Xptxas=-v`` log: registers, spill
    bytes and static shared memory (the dynamic shared memory a launch asks
    for is not in the log)."""
    demangle = shutil.which("c++filt")
    lines, name, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            if demangle:
                name = subprocess.run([demangle, name], capture_output=True, text=True,
                                      timeout=30).stdout.strip() or name
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name:
            used = line.split("Used", 1)[1].strip()
            lines.append(f"  {name}: {used}; {spill}")
            name, spill = None, ""
    return lines


# Hopper instructions a kernel's SASS must hold (cuobjdump): the SSD scan's
# chunk kernel runs its products on wgmma (HGMMA) and loads by TMA (UTMALDG).
SASS_REQUIRED = {"ssd_scan": ("ssd_wgmma_kernel", ("HGMMA", "UTMALDG"))}


def sass_opcodes(path, kernel, opcodes):
    """Counts of ``opcodes`` in the SASS (``cuobjdump -sass``) of every
    function of the library at ``path`` whose mangled name holds
    ``kernel``."""
    from repro_torch.kernels import _build

    cuobjdump = str(Path(_build._nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    counts, inside = dict.fromkeys(opcodes, 0), False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside:
            for op in opcodes:
                if f" {op}" in line:
                    counts[op] += 1
    return counts


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


def device_ms(fn, calls=50):
    """Device time of one ``fn()`` in ms: CUDA-graph replay of ``calls``
    back-to-back calls, so the host's enqueue does not pace it."""
    from repro_torch.launch.attention_sweep import graph_ms

    return graph_ms(fn, calls=calls)


def device_us_by_kernel(torch, device, fn, calls=1):
    """Device µs of one ``fn()`` by kernel: the raw device events of
    ``calls`` calls under torch.profiler, summed per kernel name (its
    template arguments kept, its parameter list dropped)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        sync(device)
    totals: dict[str, float] = {}
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() == torch.autograd.DeviceType.CUDA:
            name = evt.name().replace("(anonymous namespace)::", "").removeprefix("void ")
            name = name.split("(")[0]
            totals[name] = totals.get(name, 0.0) + evt.duration_ns() * 1e-3 / calls
    return totals


def profiled_device_ms(torch, device, fn, calls):
    """Device time of one ``fn()`` in ms: the summed device time of the
    kernels of ``calls`` warm calls under torch.profiler, per call (for
    calls a CUDA graph cannot capture)."""
    fn()
    sync(device)
    return sum(device_us_by_kernel(torch, device, fn, calls).values()) * 1e-3


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
        k_dev = device_ms(lambda: tree_select(*args, kind=kind))
        p_ms = time_ms(torch, lambda: tree_select_ref(*args, kind=kind), 200)
        nbytes = (TABLES_READ[kind] * 4 + 1) * MAIN_B * MAIN_A + 2 * 4 * MAIN_B + 2 * 4 * MAIN_B
        # Per child about 12 float32 operations (denominator, two clamps,
        # product, quotient, sqrt, scale, value sum, two selects, the
        # argmax compare); per row the parent sum, clamp and log.
        ops = 12 * MAIN_B * MAIN_A + 4 * MAIN_B
        bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3
        times[kind] = (k_ms, k_dev, p_ms, bound_ms)
        print(f"tree_select {kind} B={MAIN_B} A={MAIN_A}: kernel {k_ms * 1e3!r} us "
              f"(device {k_dev * 1e3!r} us), plain {p_ms * 1e3!r} us, bound "
              f"{bound_ms * 1e3!r} us ({nbytes} bytes)")
    print("no single PyTorch call computes tree_select: library_ms is null")
    k_ms, k_dev, p_ms, bound_ms = times["wu_uct"]
    return {"max_abs_err": max_err, "level_ms": k_ms, "level_device_ms": k_dev,
            "level_plain_ms": p_ms, "level_bound_ms": bound_ms}


def check_tree_descend(torch, device):
    """The walk (``tree_descend``) against its plain version, bit for bit, on
    trees the port grows on the card: phase 4's tap cell at B=256 and B=1
    and phase 5's bandit tree at B=1024, each after two waves and a third
    selection whose expansions are pending, for the four kinds (UCT walks
    the wu_uct forest: its one simulation per wave grows no tree).

    Then the walk is timed on phase 4's wu_uct forest as it stands at each
    of the call's eight waves (after w = 0..7 waves, the next selection
    pending), beside the plain lockstep loop, with its bound counted from
    the paths it took and its latency floor from a pointer chase in L2.
    Phase 4's 128 walks are 16 per wave, so the kernels line gets the mean
    per walk over the eight waves."""
    from repro_torch import rng
    from repro_torch.core import SearchSpec
    from repro_torch.core.batched_search import mid_search_trees, walk_inputs
    from repro_torch.envs import make_bandit_tree, make_tap_game
    from repro_torch.kernels.tree_select import tree_descend, tree_descend_ref
    from repro_torch.launch.walk_cost import chase_ns, floor_loads, walk_work

    tap = make_tap_game(6, 4, goal_count=10, step_budget=20)
    cases = [("tap", tap, MAIN_SPEC, MAIN_B), ("bandit", make_bandit_tree(6, 4), BANDIT_SPEC,
                                               BANDIT_B), ("tap", tap, MAIN_SPEC, 1)]
    walks = 0
    for name, env, fields, b in cases:
        for kind in KINDS:
            spec = SearchSpec(algo=kind, batch=b, **fields)
            grown_by = spec._replace(algo="wu_uct" if kind == "uct" else kind)
            roots = env.init(rng.split(rng.PRNGKey(0, device=device), b))
            tree = mid_search_trees(env, grown_by.config, roots,
                                    rng.split(rng.PRNGKey(1, device=device), b), waves=2)[-1]
            tensors, params = walk_inputs(tree, spec.config)
            for seed in (2, 3, 4):
                keys = rng.split(rng.PRNGKey(seed, device=device), b)
                stops = tree_descend(*tensors, keys, **params)
                sync(device)
                if not torch.equal(stops, tree_descend_ref(*tensors, keys, **params)):
                    raise AssertionError(f"tree_descend differs from its plain version: "
                                         f"{name} B={b} {kind} keys {seed}")
                walks += 1
    print(f"tree_descend equals its plain version bit for bit: {walks} walks (tap B={MAIN_B}, "
          f"bandit B={BANDIT_B}, tap B=1; 4 kinds; 3 key sets)")

    spec = SearchSpec(algo="wu_uct", batch=MAIN_B, **MAIN_SPEC)
    waves = spec.num_simulations // spec.wave_size
    roots = tap.init(rng.split(rng.PRNGKey(0, device=device), MAIN_B))
    trees = mid_search_trees(tap, spec.config, roots,
                             rng.split(rng.PRNGKey(1, device=device), MAIN_B), waves - 1)
    keys = rng.split(rng.PRNGKey(2, device=device), MAIN_B)
    l2_ns = chase_ns(4 << 20)
    rows = []
    for w, tree in enumerate(trees):
        tensors, params = walk_inputs(tree, spec.config)
        walk = lambda: tree_descend(*tensors, keys, **params)
        plain = lambda: tree_descend_ref(*tensors, keys, **params)
        stops = walk()
        sync(device)
        if not torch.equal(stops, plain()):
            raise AssertionError(f"tree_descend differs from its plain version at wave {w + 1}")
        k_ms, k_dev, p_ms = time_ms(torch, walk, 500), device_ms(walk), time_ms(torch, plain, 20)
        work = walk_work(tree, stops, "wu_uct")
        byte_ms = work["bytes"] / HBM_BYTES_PER_S * 1e3
        op_ms = work["ops"] / FP32_OPS_PER_S * 1e3
        loads = floor_loads(work["max_levels"])
        floor_ms = loads * l2_ns * 1e-6
        rows.append((k_ms, k_dev, p_ms, byte_ms, op_ms, floor_ms))
        print(f"tree_descend wu_uct, phase 4's forest at wave {w + 1} of {waves} (tap "
              f"B={MAIN_B}, A={MAIN_A}): kernel {k_ms * 1e3!r} us (device {k_dev * 1e3!r} us), "
              f"plain lockstep loop {p_ms * 1e3!r} us; levels max {work['max_levels']} mean "
              f"{work['mean_levels']!r}; bound {max(byte_ms, op_ms) * 1e3!r} us "
              f"({work['bytes']} bytes; {work['ops']} operations take {op_ms * 1e3!r} us); "
              f"latency floor {loads} loads x L2 = {floor_ms * 1e3!r} us")
    k_ms, k_dev, p_ms, byte_ms, op_ms, floor_ms = (sum(col) / len(rows) for col in zip(*rows))
    print(f"tree_descend wu_uct, mean per walk over phase 4's {waves} waves: kernel "
          f"{k_ms * 1e3!r} us (device {k_dev * 1e3!r} us), plain lockstep loop "
          f"{p_ms * 1e3!r} us, bound {max(byte_ms, op_ms) * 1e3!r} us, latency floor "
          f"{floor_ms * 1e3!r} us; dependent-load latency (pointer chase, 4 MB, in L2) "
          f"{l2_ns!r} ns")
    return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations", "library_ms": None,
            "device_ms": k_dev, "library_device_ms": None, "latency_floor_ms": floor_ms}


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


# decode_attention's options for placed caches (phase 3): (N, S, model
# heads, KV heads, D) and head windows (first head, heads) of each, whole
# groups, part of a group, across two groups' halves, one head.
DECODE_OPTION_SHAPES = [(9, 160, 32, 8, 128), (9, 70, 8, 1, 64), (5, 33, 4, 4, 16),
                        (128, 160, 32, 8, 128), (8, 4096, 40, 8, 128)]


def decode_windows(nh, hkv):
    g = nh // hkv
    wins = {(0, nh), (0, g), (g // 2, max(1, g // 2)), (g // 2, g), (nh - 1, 1)}
    return sorted((h0, hq) for h0, hq in wins if h0 + hq <= nh)


def check_decode_options(torch, device):
    """decode_attention's log-sum-exp output and head window against the
    plain version, float32 and bf16: ``out`` (float32, unrounded) within
    the float32 bar, ``lse`` within 1e-5 of the plain version's; the bf16
    output without the option bit-equal to the float32 ``out`` rounded once;
    a window's heads bit-equal to those heads of the whole call and within
    the bar of the plain window.  Returns the max errors."""
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref

    gen = torch.Generator(device=device).manual_seed(31)
    err = {"out_f32": 0.0, "lse": 0.0, "window": 0.0}
    windows = 0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for n, s, nh, hkv, d in DECODE_OPTION_SHAPES:
            q, k, v, lens = decode_inputs(torch, gen, n, s, nh, hkv, d, dtype, device)
            out, lse = decode_attention(q, k, v, lens, return_lse=True)
            plain = decode_attention(q, k, v, lens)
            ref, ref_lse = decode_attention_ref(q, k, v, lens, return_lse=True)
            sync(device)
            what = f"decode_attention return_lse {name} N={n} S={s} {nh}/{hkv} D={d}"
            err["out_f32"] = max(err["out_f32"], attention_err(torch, out, ref, "float32", what))
            both_inf = torch.isneginf(lse) & torch.isneginf(ref_lse)
            lse_diff = torch.where(both_inf, 0.0, (lse - ref_lse).abs())
            if bool((lse_diff > 1e-5 + 1e-5 * ref_lse.abs()).any()) or bool(lse_diff.isnan().any()):
                raise AssertionError(f"{what}: lse differs by {float(lse_diff.max())!r}")
            err["lse"] = max(err["lse"], float(lse_diff.max()))
            if not torch.equal(plain, out.to(dtype)):
                raise AssertionError(f"{what}: the output without lse is not the float32 out "
                                     f"rounded once")
            for h0, hq in decode_windows(nh, hkv):
                win = q[:, h0:h0 + hq].contiguous()
                got = decode_attention(win, k, v, lens, q_head0=h0, num_heads=nh)
                sync(device)
                # The kernel's heads compute alone (the CPU rehearsal's plain
                # version batches them differently).
                if device.type == "cuda" and not torch.equal(got, plain[:, h0:h0 + hq]):
                    raise AssertionError(f"{what}: heads {h0}..{h0 + hq - 1} as a window differ "
                                         f"from the whole call's")
                ref_w = decode_attention_ref(win, k, v, lens, q_head0=h0, num_heads=nh)
                err["window"] = max(err["window"], attention_err(
                    torch, got, ref_w, name, f"{what} window {h0}+{hq}"))
                windows += 1
            del q, k, v
    print(f"decode_attention's options match the plain version: {len(DECODE_OPTION_SHAPES)} "
          f"shapes x (float32, bfloat16) with return_lse (out float32 within the float32 bar, "
          f"lse within 1e-5, the output without it = out rounded once, bit for bit) and "
          f"{windows} head windows (whole groups, part of a group, across two groups, one "
          f"head: bit-equal to the whole call's heads); max errors {err}")
    return err


def check_flash(torch, device, lm_shapes):
    """flash_attention vs its plain version; returns the max error."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

    gen = torch.Generator(device=device).manual_seed(12)
    shapes = [(b, s, hq, hkv, d) for b in (1, 8) for s in (1, 7, 160, 1024)
              for hq, hkv in ((32, 8), (8, 8), (4, 1)) for d in (64, 128)]
    # zamba2-7b's shared block: D=112 (three full 32-lane columns and a
    # half one), MHA.
    shapes += [(b, s, 32, 32, 112) for b in (1, 8) for s in (1, 7, 160, 1024)] + lm_shapes
    # An MQA group wider than a 64-row tile (falcon-7b's 71/1 heads, D=64).
    shapes += [(1, s, 71, 1, 64) for s in (7, 160)]
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
          f"(32/8, 8/8, 4/1) with D in (64, 128) and 32/32 with D=112, plus the driven "
          f"shapes {lm_shapes} and 71/1 with D=64; max |kernel - plain| = {max_err!r}")
    return max_err


def time_decode(torch, device, n=ASYNC_B * ASYNC_W, s=MAX_LEN, hq=32, hkv=8, d=128,
                min_len=PROMPT_LEN + 1):
    """Kernel, plain version and SDPA at phase 7's decode shape: 128 slots,
    32/8 heads, D=128, a 160-entry bf16 cache, lengths 129..160; or at
    another ``(n, s, hq, hkv, d)`` with lengths ``min_len..s``."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref

    gen = torch.Generator(device=device).manual_seed(13)
    q, k, v, lens = decode_inputs(torch, gen, n, s, hq, hkv, d, torch.bfloat16, device,
                                  min_len=min_len)
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
    k_dev = device_ms(lambda: decode_attention(q, k, v, lens))
    lib_dev = device_ms(lib)
    valid = int(lens.sum())
    nbytes = 2 * (2 * n * hq * d + 2 * valid * hkv * d) + 4 * n
    ops = 4 * d * hq * valid
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S) * 1e3
    print(f"decode_attention bf16 N={n} S={s} {hq}/{hkv} D={d} (kv_len sum {valid}): kernel "
          f"{k_ms * 1e3!r} us (device {k_dev * 1e3!r} us), plain {p_ms * 1e3!r} us, SDPA "
          f"{lib_ms * 1e3!r} us (device {lib_dev * 1e3!r} us), bound {bound_ms * 1e3!r} us "
          f"({nbytes} bytes, {ops} flops); |kernel - plain| {err!r}")
    return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": lib_ms, "device_ms": k_dev, "library_device_ms": lib_dev}


def time_flash(torch, device, hq=32, hkv=8, d=128):
    """Kernel, plain version and SDPA at phase 8's forward shape: 8 rows of
    160 tokens, 32/8 heads, D=128, bf16; with ``hq=hkv=32, d=112``, phase
    14's (zamba2-7b's shared block)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

    b, s = WAVE_B * WAVE_W, MAX_LEN
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
    k_dev = device_ms(lambda: flash_attention(q, k, v))
    lib_dev = device_ms(lib)
    nbytes = 2 * (2 * b * s * hq * d + 2 * b * s * hkv * d)
    ops = 4 * d * (s * (s + 1) // 2) * b * hq          # QK and PV over the causal half
    bound_s = {"bytes": nbytes / HBM_BYTES_PER_S, "operations": ops / BF16_OPS_PER_S}
    bound_by = max(bound_s, key=bound_s.get)
    bound_ms = bound_s[bound_by] * 1e3
    print(f"flash_attention bf16 B={b} S={s} {hq}/{hkv} D={d}: kernel {k_ms * 1e3!r} us "
          f"(device {k_dev * 1e3!r} us), plain {p_ms * 1e3!r} us, SDPA {lib_ms * 1e3!r} us "
          f"(device {lib_dev * 1e3!r} us), bound {bound_ms * 1e3!r} us (by {bound_by}: "
          f"{nbytes} bytes, {ops} flops); |kernel - plain| {err!r}")
    return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms, "device_ms": k_dev, "library_device_ms": lib_dev}


# flash_attention_bwd against its plain version (phase 3).  float32: the
# kernel and the plain version compute the same float32 formulas, summed in
# another order.  bfloat16: against the float32 plain version on the same
# bf16 inputs (upcast), per tensor: the kernel rounds each gradient once
# to bf16 (2^-9 relative) after the same float32 arithmetic.
FLASH_BWD_F32_TOL = dict(rtol=1e-4, atol=1e-5)
FLASH_BWD_BF16_SHARE = 2.0 ** -6
# Phase 24's training shape: 8 rows of 512 tokens, llama3-8b's 32/8 heads.
TRAIN_B, TRAIN_S = 8, 512


def flash_bwd_inputs(torch, gen, b, s, hq, hkv, d, dtype, device, causal=True):
    """q, k, v, dout (N(0, 1) in ``dtype``) and the forward kernel's
    ``(out, lse)``."""
    from repro_torch.kernels.flash_attention import ops as flash_ops

    q = torch.randn((b, s, hq, d), generator=gen, device=device).to(dtype)
    k = torch.randn((b, s, hkv, d), generator=gen, device=device).to(dtype)
    v = torch.randn((b, s, hkv, d), generator=gen, device=device).to(dtype)
    dout = torch.randn((b, s, hq, d), generator=gen, device=device).to(dtype)
    out, lse = flash_ops._forward(q, k, v, causal, with_lse=True)
    return q, k, v, dout, out, lse


def check_flash_bwd(torch, device):
    """The forward's ``lse`` against ``flash_attention_lse_ref`` and its
    ``out`` bit-equal with and without ``lse``; ``flash_attention_bwd``
    against ``flash_attention_bwd_ref`` (float32 and bf16, causal and not,
    GQA and MHA, D = 16, 32, 64, 112, 128, G up to 71, G = 5 not dividing
    a 64-row tile, ragged tiles), and a second call bit-equal to the first
    (no atomics).  Returns the max errors."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_ref,
        flash_attention_lse_ref)

    gen = torch.Generator(device=device).manual_seed(15)
    shapes = [(TRAIN_B, TRAIN_S, 32, 8, 128, True), (2, 160, 8, 2, 64, True),
              (2, 160, 32, 32, 112, True), (1, 33, 4, 1, 16, True), (2, 7, 8, 8, 64, True),
              (2, 100, 8, 2, 128, False), (2, 96, 16, 2, 32, True), (2, 100, 40, 8, 128, True),
              (2, 96, 16, 1, 64, True), (1, 60, 71, 1, 64, True)]
    errs = {"lse": 0.0, "float32": 0.0, "bfloat16_share": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for b, s, hq, hkv, d, causal in shapes:
            what = (f"flash_attention_bwd {name} B={b} S={s} Hq/Hkv={hq}/{hkv} D={d} "
                    f"causal={causal}")
            q, k, v, dout, out, lse = flash_bwd_inputs(torch, gen, b, s, hq, hkv, d, dtype,
                                                       device, causal)
            if not torch.equal(out, flash_attention(q, k, v, causal=causal)):
                raise AssertionError(f"{what}: out differs with and without lse")
            lse_ref = flash_attention_lse_ref(q, k, causal=causal)
            atol, rtol = ATTN_TOL["float32"]
            diff = (lse - lse_ref).abs()
            if bool((diff > atol + rtol * lse_ref.abs()).any()):
                raise AssertionError(f"{what}: lse differs by up to {float(diff.max())!r}")
            errs["lse"] = max(errs["lse"], float(diff.max()))
            got = flash_attention_bwd(q, k, v, out, dout, lse, causal=causal)
            again = flash_attention_bwd(q, k, v, out, dout, lse, causal=causal)
            sync(device)
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise AssertionError(f"{what}: a second call's gradients differ")
            ref = flash_attention_bwd_ref(q.float(), k.float(), v.float(), out.float(),
                                          dout.float(), lse, causal=causal)
            for grad, x, r in zip(("dq", "dk", "dv"), got, ref):
                if x.dtype != dtype or not bool(torch.isfinite(x).all()):
                    raise AssertionError(f"{what}: {grad} is {x.dtype} or not finite")
                diff = (x.float() - r).abs()
                if dtype == torch.float32:
                    tol = FLASH_BWD_F32_TOL
                    bad = diff > tol["atol"] + tol["rtol"] * r.abs()
                    if bool(bad.any()):
                        raise AssertionError(f"{what}: {grad} differs by up to "
                                             f"{float(diff.max())!r} ({int(bad.sum())} "
                                             f"elements out of {tol})")
                    errs["float32"] = max(errs["float32"], float(diff.max()))
                else:
                    share = float(diff.max()) / max(float(r.abs().max()), 1e-30)
                    if share > FLASH_BWD_BF16_SHARE:
                        raise AssertionError(f"{what}: {grad} differs by {share!r} of its "
                                             f"largest value (bar {FLASH_BWD_BF16_SHARE})")
                    errs["bfloat16_share"] = max(errs["bfloat16_share"], share)
            del q, k, v, dout, out, lse, got, again, ref
    print(f"flash_attention lse and backward match their plain versions: {len(shapes)} "
          f"shapes x (float32, bfloat16) {[sh[:5] for sh in shapes]}, out bit-equal with "
          f"and without lse, a second backward bit-equal to the first; max |lse - plain| "
          f"{errs['lse']!r}, float32 max |d - plain| "
          f"{errs['float32']!r}, bf16 max |d - plain| / max |plain| "
          f"{errs['bfloat16_share']!r}")
    return errs


def time_flash_bwd(torch, device, b=TRAIN_B, s=TRAIN_S, hq=32, hkv=8, d=128):
    """Backward kernel, plain version and SDPA's backward at phase 24's
    shape (bf16, causal): paced and by CUDA-graph replay."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_bwd_ref

    gen = torch.Generator(device=device).manual_seed(16)
    q, k, v, dout, out, lse = flash_bwd_inputs(torch, gen, b, s, hq, hkv, d, torch.bfloat16,
                                               device)
    run = lambda: flash_attention_bwd(q, k, v, out, dout, lse)
    k_ms = time_ms(torch, run, 20)
    k_dev = device_ms(run, calls=10)
    p_ms = time_ms(torch, lambda: flash_attention_bwd_ref(q, k, v, out, dout, lse), 5)
    # The library call: SDPA's backward through autograd (its forward once).
    # The autograd engine's stream cannot be captured in a CUDA graph, so
    # its device time is the sum of its kernels' profiled device times.
    qs, ks, vs = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)
    dout_t = dout.transpose(1, 2)
    lib = lambda: torch.autograd.grad(lib_out, (qs, ks, vs), dout_t, retain_graph=True)
    lib_ms = time_ms(torch, lib, 20)
    lib_dev = profiled_device_ms(torch, device, lib, calls=10)
    # The backward's kernels (bf16: dQ with D, then dK/dV), profiled device time each.
    by_kernel = device_us_by_kernel(torch, device, run, calls=10)
    elems_q, elems_kv = b * s * hq * d, b * s * hkv * d
    nbytes = 2 * (4 * elems_q + 4 * elems_kv) + 4 * b * hq * s
    ops = 10 * d * (s * (s + 1) // 2) * b * hq          # five products over the causal half
    bound_s = {"bytes": nbytes / HBM_BYTES_PER_S, "operations": ops / BF16_OPS_PER_S}
    bound_by = max(bound_s, key=bound_s.get)
    bound_ms = bound_s[bound_by] * 1e3
    print(f"flash_attention_bwd bf16 B={b} S={s} {hq}/{hkv} D={d} causal: kernel "
          f"{k_ms * 1e3!r} us (device {k_dev * 1e3!r} us), plain {p_ms * 1e3!r} us, SDPA "
          f"backward {lib_ms * 1e3!r} us (device {lib_dev * 1e3!r} us), bound "
          f"{bound_ms * 1e3!r} us (by {bound_by}: {nbytes} bytes, {ops} flops); by kernel "
          f"(profiled device us a call): {by_kernel}")
    return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms, "device_ms": k_dev, "library_device_ms": lib_dev,
            "kernels_device_us": by_kernel}


# The paged and tree-batched decode kernels (phases 10-12).

# Their float32 bar: within 1e-5 of the plain version (inputs N(0, 1),
# outputs of magnitude up to ~3; the sums differ only in order).
NEW_F32_TOL = 1e-5


def check_f32(by_type, name):
    if by_type["float32"] > NEW_F32_TOL:
        raise AssertionError(f"{name}: float32 kernel differs from its plain version by "
                             f"{by_type['float32']!r} > {NEW_F32_TOL}")


def paged_inputs(torch, gen, n, bs, n_pages, hq, hkv, d, dtype, device, a=0, min_len=0):
    """Pools of ``n * n_pages`` blocks and a shuffled page table; entries
    past each row's live pages hold the sentinel ``P`` or stale ids, rows 1
    and 2 share a page, and (unless ``min_len``) the lengths cover 0, a full
    row and a length ending mid-page.  With ``a``, ``q`` is ``[n, a, hq,
    d]`` and the speculative tails ``[n, a, hkv, d]`` come too."""
    p = n * n_pages
    q = torch.randn((n, a, hq, d) if a else (n, hq, d), generator=gen, device=device)
    pk = torch.randn((p, bs, hkv, d), generator=gen, device=device).to(dtype)
    pv = torch.randn((p, bs, hkv, d), generator=gen, device=device).to(dtype)
    table = torch.randperm(p, generator=gen, device=device).reshape(n, n_pages)
    full = n_pages * bs
    lens = torch.randint(min_len, full + 1, (n,), generator=gen, device=device,
                         dtype=torch.int32)
    if min_len == 0 and n >= 3:
        lens[:3] = torch.tensor([0, full, max(1, full - bs // 2)], dtype=torch.int32)
    pages = torch.arange(n_pages, device=device)[None, :]
    dead = pages >= ((lens + bs - 1) // bs)[:, None]
    table = torch.where(dead, torch.where(pages % 2 == 0, p, table[0, 0]), table)
    if n >= 3 and min_len == 0:
        table[2, 0] = table[1, 0]
    table = table.to(torch.int32)
    spec = ()
    if a:
        spec = tuple(torch.randn((n, a, hkv, d), generator=gen, device=device).to(dtype)
                     for _ in range(2))
    return q.to(dtype), pk, pv, table, lens, spec


def gathered(torch, pool, table):
    """The dense view ``[n, n_pages * bs, Hkv, D]`` of each row's pages."""
    p, bs = pool.shape[:2]
    idx = table.long().clamp(0, p - 1)
    return pool[idx].reshape(table.shape[0], table.shape[1] * bs, *pool.shape[2:])


def tree_masks(torch, a, device):
    return {"identity": None,
            "lower": torch.tril(torch.ones((a, a), dtype=torch.bool, device=device))}


def check_paged_decode(torch, device, lm_shapes):
    """paged_decode_attention vs its plain version over the grid and the
    driven shapes, float32 and bfloat16; and a pool made by paging a dense
    cache against the dense decode_attention kernel on that cache."""
    from repro_torch.kernels.decode_attention import (
        decode_attention,
        paged_decode_attention,
        paged_decode_attention_ref,
    )

    gen = torch.Generator(device=device).manual_seed(21)
    shapes = [(n, bs, npg, hq, hkv, d) for n in (1, 128) for bs, npg in
              ((1, 37), (3, 11), (4, 40), (16, 10)) for hq, hkv in ((32, 8), (4, 1))
              for d in (64, 128)] + lm_shapes
    by_type, dense_err = {"float32": 0.0, "bfloat16": 0.0}, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for n, bs, npg, hq, hkv, d in shapes:
            q, pk, pv, table, lens, _ = paged_inputs(torch, gen, n, bs, npg, hq, hkv, d,
                                                     dtype, device)
            out = paged_decode_attention(q, pk, pv, table, lens)
            sync(device)
            ref = paged_decode_attention_ref(q, pk, pv, table, lens)
            what = f"paged_decode_attention {name} N={n} bs={bs} pages={npg} " \
                   f"Hq/Hkv={hq}/{hkv} D={d}"
            by_type[name] = max(by_type[name], attention_err(torch, out, ref, name, what))
            if not bool((out[lens == 0] == 0).all()):
                raise AssertionError("paged_decode_attention: a kv_len = 0 row is not zero")
            # Paging a dense cache: the dense kernel on the cache and the
            # paged kernel on its pages read the same keys in the same order.
            kc, vc = gathered(torch, pk, table), gathered(torch, pv, table)
            pages = torch.arange(n * npg, device=device, dtype=torch.int32).reshape(n, npg)
            flat = [x.reshape(n * npg, bs, hkv, d) for x in (kc, vc)]
            out_p = paged_decode_attention(q, *flat, pages, lens)
            out_d = decode_attention(q, kc, vc, lens)
            sync(device)
            dense_err = max(dense_err, attention_err(torch, out_p, out_d, name,
                                                     what + " (paged dense cache)"))
    print(f"paged_decode_attention matches its plain version: {len(shapes)} shapes x "
          f"(float32, bfloat16), N in (1, 128), bs in (1, 3, 4, 16), Hq/Hkv in (32/8, "
          f"4/1), D in (64, 128), lengths covering 0, a full row and mid-page, table "
          f"entries past the live pages the sentinel and stale ids, a page shared by two "
          f"rows, plus the driven shapes {lm_shapes}; max |kernel - plain| = {by_type}; "
          f"on a paged dense cache max |paged - dense decode_attention| = {dense_err!r}")
    check_f32(by_type, "paged_decode_attention")
    return max(by_type.values())


def check_tree(torch, device, dense_shapes, paged_shapes):
    """tree_decode_attention (dense prefix) and paged_tree_decode_attention
    vs their plain versions: A in (1, 4, 8, 16, 32), the identity and a
    lower-triangular tree mask, float32 and bfloat16, prefixes of 512 and
    1024 keys (past the kernels' shared-memory copy of 178 bf16 or 84
    float32 keys at D=128, G=4, A=8: keys from shared and from device
    memory), plus the driven shapes.  Returns the max errors of both."""
    from repro_torch.kernels.decode_attention import (
        paged_tree_decode_attention,
        paged_tree_decode_attention_ref,
        tree_decode_attention,
        tree_decode_attention_ref,
    )

    gen = torch.Generator(device=device).manual_seed(22)
    grid = [(n, a, bs, npg, hq, hkv, d) for n in (1, 128) for a in (1, 4, 8)
            for bs, npg in ((1, 37), (3, 11), (16, 10)) for hq, hkv in ((32, 8), (4, 1))
            for d in (64, 128)] + [(7, 16, 4, 9, 8, 2, 64), (5, 32, 4, 6, 8, 2, 64),
                                   (4, 8, 16, 32, 32, 8, 128), (4, 8, 16, 64, 32, 8, 128)]
    dense_grid = [(n, a, s, hq, hkv, d) for n, a, bs, npg, hq, hkv, d in grid
                  for s in (bs * npg, 1)] + dense_shapes
    err = {name: {"float32": 0.0, "bfloat16": 0.0}
           for name in ("tree_decode_attention", "paged_tree_decode_attention")}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for n, a, bs, npg, hq, hkv, d in grid + paged_shapes:
            q, pk, pv, table, lens, (ks, vs) = paged_inputs(torch, gen, n, bs, npg, hq, hkv,
                                                            d, dtype, device, a=a)
            for mname, mask in tree_masks(torch, a, device).items():
                out = paged_tree_decode_attention(q, pk, pv, table, ks, vs, lens, mask)
                sync(device)
                ref = paged_tree_decode_attention_ref(q, pk, pv, table, ks, vs, lens, mask)
                what = (f"paged_tree_decode_attention {name} N={n} A={a} bs={bs} "
                        f"pages={npg} Hq/Hkv={hq}/{hkv} D={d} mask={mname}")
                e = err["paged_tree_decode_attention"]
                e[name] = max(e[name], attention_err(torch, out, ref, name, what))
        for n, a, s, hq, hkv, d in dense_grid:
            q = torch.randn((n, a, hq, d), generator=gen, device=device).to(dtype)
            kc, vc = (torch.randn((n, s, hkv, d), generator=gen, device=device).to(dtype)
                      for _ in range(2))
            ks, vs = (torch.randn((n, a, hkv, d), generator=gen, device=device).to(dtype)
                      for _ in range(2))
            lens = torch.randint(0, s + 1, (n,), generator=gen, device=device,
                                 dtype=torch.int32)
            lens[0] = 0
            for mname, mask in tree_masks(torch, a, device).items():
                out = tree_decode_attention(q, kc, vc, ks, vs, lens, mask)
                sync(device)
                ref = tree_decode_attention_ref(q, kc, vc, ks, vs, lens, mask)
                what = (f"tree_decode_attention {name} N={n} A={a} S={s} "
                        f"Hq/Hkv={hq}/{hkv} D={d} mask={mname}")
                e = err["tree_decode_attention"]
                e[name] = max(e[name], attention_err(torch, out, ref, name, what))
    print(f"tree_decode_attention and paged_tree_decode_attention match their plain "
          f"versions: A in (1, 4, 8, 16, 32), identity and lower-triangular masks, float32 "
          f"and bfloat16, N in (1, 128), bs in (1, 3, 16), dense S in (1, bs * pages), "
          f"prefixes up to 512 and 1024 keys, Hq/Hkv in (32/8, 4/1, 8/2), D in (64, 128), "
          f"lengths covering 0, plus the driven shapes "
          f"{dense_shapes} (dense) and {paged_shapes} (paged); max |kernel - plain| = {err}")
    for name, by_type in err.items():
        check_f32(by_type, name)
    return {name: max(by_type.values()) for name, by_type in err.items()}


def time_paged_family(torch, device):
    """Kernel, plain version and a library yardstick for the three paged and
    tree kernels at the main path's shapes: 128 slots, a 160-token prefix
    in 10 blocks of 16 (lengths 129-160) of a 1280-block bf16 pool, 32/8
    heads, D=128; the tree kernels with A=8 candidates and the identity
    mask.  No single PyTorch call computes them: the yardstick is a gather
    of the pages plus SDPA (two calls), a concatenation of prefix and tail
    plus masked SDPA (two calls), and gather, concatenation and SDPA
    (three calls), printed and not reported as library_ms."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (
        paged_decode_attention,
        paged_decode_attention_ref,
        paged_tree_decode_attention,
        paged_tree_decode_attention_ref,
        tree_decode_attention,
        tree_decode_attention_ref,
    )

    n, a, hq, hkv, d = ASYNC_B * ASYNC_W, TOP_K, 32, 8, 128
    npg = -(-MAX_LEN // BLOCK)
    gen = torch.Generator(device=device).manual_seed(23)
    q1, pk, pv, table, lens, _ = paged_inputs(torch, gen, n, BLOCK, npg, hq, hkv, d,
                                              torch.bfloat16, device, min_len=PROMPT_LEN + 1)
    qa = torch.randn((n, a, hq, d), generator=gen, device=device).to(torch.bfloat16)
    ks, vs = (torch.randn((n, a, hkv, d), generator=gen, device=device).to(torch.bfloat16)
              for _ in range(2))
    kc, vc = gathered(torch, pk, table), gathered(torch, pv, table)
    s = kc.shape[1]
    valid = int(lens.sum())
    prefix_bytes = 2 * 2 * valid * hkv * d
    pos = torch.arange(s, device=device)
    eye = torch.eye(a, dtype=torch.bool, device=device)

    def sdpa_decode():
        k_, v_ = gathered(torch, pk, table), gathered(torch, pv, table)
        mask = (pos[None, :] < lens[:, None])[:, None, None, :]
        return F.scaled_dot_product_attention(q1[:, :, None, :], k_.transpose(1, 2),
                                              v_.transpose(1, 2), attn_mask=mask,
                                              enable_gqa=True)

    def sdpa_tree(k_, v_):
        kf = torch.cat([k_, ks], dim=1).transpose(1, 2)          # [n, Hkv, S + A, D]
        vf = torch.cat([v_, vs], dim=1).transpose(1, 2)
        mask = torch.cat([(pos[None, :] < lens[:, None])[:, None, :].expand(n, a, s),
                          eye[None].expand(n, a, a)], dim=-1)[:, None]
        return F.scaled_dot_product_attention(qa.transpose(1, 2), kf, vf, attn_mask=mask,
                                              enable_gqa=True)

    def bound(nbytes, ops):
        b_s = {"bytes": nbytes / HBM_BYTES_PER_S, "operations": ops / BF16_OPS_PER_S}
        by = max(b_s, key=b_s.get)
        return b_s[by] * 1e3, by

    fields = {}
    runs = {
        "paged_decode_attention": (
            lambda: paged_decode_attention(q1, pk, pv, table, lens),
            lambda: paged_decode_attention_ref(q1, pk, pv, table, lens), sdpa_decode,
            "gather + SDPA, two calls",
            prefix_bytes + 2 * 2 * n * hq * d + 4 * n * npg + 4 * n, 4 * d * hq * valid),
        "tree_decode_attention": (
            lambda: tree_decode_attention(qa, kc, vc, ks, vs, lens),
            lambda: tree_decode_attention_ref(qa, kc, vc, ks, vs, lens),
            lambda: sdpa_tree(kc, vc), "concat + masked SDPA, two calls",
            prefix_bytes + 2 * 2 * n * a * hq * d + 2 * 2 * n * a * hkv * d + 4 * n,
            4 * d * hq * a * (valid + n)),
        "paged_tree_decode_attention": (
            lambda: paged_tree_decode_attention(qa, pk, pv, table, ks, vs, lens),
            lambda: paged_tree_decode_attention_ref(qa, pk, pv, table, ks, vs, lens),
            lambda: sdpa_tree(gathered(torch, pk, table), gathered(torch, pv, table)),
            "gather + concat + masked SDPA, three calls",
            prefix_bytes + 2 * 2 * n * a * hq * d + 2 * 2 * n * a * hkv * d + 4 * n * npg
            + 4 * n, 4 * d * hq * a * (valid + n)),
    }
    for name, (kern, plain, lib, lib_what, nbytes, ops) in runs.items():
        err = attention_err(torch, kern(), plain(), "bfloat16", f"timed {name}")
        lib_err = float((lib().transpose(1, 2).reshape(kern().shape).float()
                         - plain().float()).abs().max())
        k_ms = time_ms(torch, kern, 300)
        p_ms = time_ms(torch, plain, 30)
        l_ms = time_ms(torch, lib, 300)
        k_dev, l_dev = device_ms(kern), device_ms(lib)
        bound_ms, bound_by = bound(nbytes, ops)
        print(f"{name} bf16 N={n}{' A=%d' % a if 'tree' in name else ''} prefix {s} "
              f"(kv_len sum {valid}) 32/8 D=128: kernel {k_ms * 1e3!r} us (device "
              f"{k_dev * 1e3!r} us), plain {p_ms * 1e3!r} us, {lib_what} {l_ms * 1e3!r} us "
              f"(device {l_dev * 1e3!r} us; |yardstick - plain| {lib_err!r}), bound "
              f"{bound_ms * 1e3!r} us (by {bound_by}: {nbytes} bytes, {ops} flops); "
              f"|kernel - plain| {err!r}")
        fields[name] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": None, "device_ms": k_dev,
                        "library_device_ms": None}
    print("no single PyTorch call computes the paged or tree kernels: library_ms is null")
    return fields


# The SSD scan (phases 13, 14 and 9.4).

# (b, s, h, p, n, Q): the JAX kernel tests' shapes, several chunks of 256,
# an odd single chunk and tiny chunks (the reduced models' S=20, Q=4); Q on
# both sides of the tensor-core body's 16-row tiles and 64-row blocks (1,
# 15, 16, 17, 63, 64, 65, 160, 256), N in (8, 64, 128, 256), P in (16, 64,
# 128), one and several chunks; heads that the block's group does not
# divide (on an H100's 132 SMs: 7 in groups of 4 at 96 rows, the mma.sync
# body; 20 in groups of 3 at 16 rows, the Hopper body, which takes all 13
# heads of the 128-row shape in one group); odd P and N (element-wise loads
# and stores).
SSD_GRID = [(2, 128, 4, 32, 16, 32), (1, 256, 2, 64, 32, 64), (1, 64, 8, 16, 64, 64),
            (2, 96, 3, 16, 8, 32), (1, 512, 4, 64, 128, 256), (1, 81, 2, 16, 8, 81),
            (2, 20, 4, 16, 16, 4),
            (2, 8, 3, 16, 8, 1), (1, 45, 5, 64, 64, 15), (2, 32, 3, 128, 256, 16),
            (1, 34, 9, 16, 128, 17), (1, 126, 3, 64, 8, 63), (2, 128, 2, 128, 64, 64),
            (1, 130, 11, 64, 128, 65), (1, 320, 3, 16, 256, 160),
            (1, 256, 5, 128, 256, 256), (128, 160, 13, 64, 128, 160),
            (96, 256, 7, 16, 64, 128), (2, 33, 3, 18, 12, 11), (16, 160, 20, 64, 128, 160)]
# Kernel against plain version: the same float32 function from the same
# inputs.  The float32 body sums in another order (32-row tiles and a warp
# scan of dA against the plain version's einsums and cumsum), ~1e-6 on
# outputs of magnitude ~1-10; the bf16 body also carries the split
# products' ~2^-17 relative error (~3e-5 at most, CPU model:
# tests/test_torch_ssd_numerics.py).  Against the sequential recurrence:
# the JAX kernel tests' bar.
SSD_TOL = dict(atol=1e-4, rtol=1e-4)
SSD_SEQ_TOL = dict(atol=2e-4, rtol=2e-4)
# The bf16 chunk kernel every driven shape runs: the Hopper body.
SSD_CHUNK_KERNEL = "ssd_wgmma_kernel"


def ssd_inputs(torch, gen, b, s, h, p, n, bc_dtype, device):
    """The JAX kernel tests' distributions: xdt, B, C ~ 0.3 N(0, 1) (B and
    C rounded to ``bc_dtype``), dA = -softplus(N(0, 1))."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    xdt = randn(b, s, h, p) * 0.3
    dA = -torch.nn.functional.softplus(randn(b, s, h))
    return xdt, dA, (randn(b, s, n) * 0.3).to(bc_dtype), (randn(b, s, n) * 0.3).to(bc_dtype)


def ssd_err(torch, out, ref, tol, what):
    """Max |out - ref|; raises where it exceeds atol + rtol * |ref|."""
    diff = (out - ref).abs()
    bad = diff > tol["atol"] + tol["rtol"] * ref.abs()
    if bool(bad.any()) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{what}: differs by up to {float(diff.max())!r} "
                             f"({int(bad.sum())} elements out of {tol})")
    return float(diff.max())


def check_ssd(torch, device, driven):
    """ssd_scan vs its plain version and vs the sequential recurrence, with
    float32 and bfloat16 B/C, over the grid and the driven shapes; returns
    the max error against the plain version."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_ref
    from repro_torch.kernels.ssd_scan.ops import chunk_kernel
    from repro_torch.models.ssm import ssd_sequential_ref

    gen = torch.Generator(device=device).manual_seed(41)
    err = {"float32": 0.0, "bfloat16": 0.0}
    seq_err = 0.0
    bodies = {}
    for b, s, h, p, n, q in SSD_GRID + driven:
        bodies.setdefault(chunk_kernel(p, n, q), []).append((b, s, h, p, n, q))
    if sorted(bodies) != ["ssd_mma_kernel", SSD_CHUNK_KERNEL]:
        raise AssertionError(f"the scan's shapes reach the chunk kernels {sorted(bodies)}")
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for b, s, h, p, n, q in SSD_GRID + driven:
            args = ssd_inputs(torch, gen, b, s, h, p, n, dtype, device)
            out = ssd_scan(*args, chunk=q)
            sync(device)
            what = f"ssd_scan B/C {name} (b, s, h, p, n, Q) = {(b, s, h, p, n, q)}"
            err[name] = max(err[name], ssd_err(torch, out, ssd_scan_ref(*args, chunk=q),
                                               SSD_TOL, what))
            seq, _ = ssd_sequential_ref(*args)
            seq_err = max(seq_err, ssd_err(torch, out, seq, SSD_SEQ_TOL,
                                           what + " vs the sequential recurrence"))
            del args, out, seq
    print(f"ssd_scan matches its plain version (tolerance {SSD_TOL}) and the sequential "
          f"recurrence (tolerance {SSD_SEQ_TOL}): B/C in float32 and bfloat16 over "
          f"(b, s, h, p, n, Q) in {SSD_GRID} and the driven shapes {driven}; max |kernel - "
          f"plain| = {err}, max |kernel - sequential| = {seq_err!r}; bf16 chunk kernel by "
          f"shape {bodies}")
    return max(err.values())


def ssd_bound(b, s, h, p, n, q, bc_bytes, state=False, old=False):
    """(bound_ms, bound_by, bytes, flops) of one scan: xdt read and y
    written in float32, dA read, B and C read once; with ``state``
    (``return_state``) the last chunk's update too, and the final state
    written in float32.  The products run on the tensor cores in bf16, each
    counted as often as the float32 bar makes the kernels form it: per row
    and chunk the lower triangle of C.Bᵀ once (Q(Q+1)N), per (row, head)
    and chunk the causal products with xdt three times (hi.hi, hi.lo,
    lo.hi: 3 Q(Q+1)P), and 2QPN twice (the split operand) for the update of
    every chunk but the last and for the carried-state term of every chunk
    but the first; those take the dense bf16 rate.  The decay (subtract,
    exp, multiply on Q(Q+1)/2 entries per (row, head) and chunk) takes the
    float32 rate.  The bound is the largest of the three times: bytes,
    tensor-core operations, float32 operations, which the card can overlap.
    ``old``: the count before PR 33, every operation once at the float32
    rate (`flops` then the float32 total)."""
    nc = s // q
    updates = nc if state else nc - 1
    nbytes = (2 * 4 * b * s * h * p + 4 * b * s * h + 2 * bc_bytes * b * s * n
              + (4 * b * h * p * n if state else 0))
    decay = nc * b * h * 3 * q * (q + 1) // 2
    if old:
        flops = (nc * b * h * q * (q + 1) * p + decay + nc * b * q * (q + 1) * n
                 + (nc - 1 + updates) * b * h * 2 * q * p * n)
        b_s = {"bytes": nbytes / HBM_BYTES_PER_S, "operations": flops / FP32_OPS_PER_S}
    else:
        tensor = (nc * b * q * (q + 1) * n + 3 * nc * b * h * q * (q + 1) * p
                  + 2 * (nc - 1 + updates) * b * h * 2 * q * p * n)
        flops = tensor + decay
        b_s = {"bytes": nbytes / HBM_BYTES_PER_S,
               "operations": max(tensor / BF16_OPS_PER_S, decay / FP32_OPS_PER_S)}
    by = max(b_s, key=b_s.get)
    return b_s[by] * 1e3, by, nbytes, flops


def ssd_kernels_ran(torch, device, run, shape, state):
    """Device µs by kernel of one bf16 ``run()`` at a driven scan shape;
    raises unless it launched the Hopper chunk kernel, the state kernel
    exactly where ``state`` (more than one chunk, or the final state), and
    neither the mma.sync chunk kernel nor a CUDA-core one."""
    from repro_torch.kernels.ssd_scan.ops import chunk_kernel

    b, s, h, p, n, q = shape
    by_kernel = device_us_by_kernel(torch, device, run, calls=3)
    want = (SSD_CHUNK_KERNEL, "ssd_fwd_state_mma_kernel") if state else (SSD_CHUNK_KERNEL,)
    ran = lambda name: any(name in k for k in by_kernel)
    if chunk_kernel(p, n, q) != SSD_CHUNK_KERNEL or not all(ran(k) for k in want) or \
            ran("ssd_scan_kernel") or ran("ssd_mma_kernel") or \
            (not state and ran("ssd_fwd_state_mma_kernel")):
        raise AssertionError(f"ssd_scan at {shape}, bf16 B/C, ran {sorted(by_kernel)}: expected "
                             f"{want} and no other kernel")
    return by_kernel


def time_ssd(torch, device, shape):
    """Kernel and plain version at a scan shape with bf16 B/C: phase 13's
    (mamba2-2.7b, 128 rows x 160 tokens) or phase 14's (zamba2-7b, 8 rows),
    one chunk, or 24(c)'s training shapes (8 rows x 512 tokens, two chunks
    of 256), where the state kernel runs before the chunk kernel; the
    Hopper chunk kernel and no other must run (``ssd_kernels_ran``); device
    µs by kernel under torch.profiler; the bound beside the count before
    PR 33; no single PyTorch call computes it."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_ref
    from repro_torch.kernels.ssd_scan.ops import heads_per_block

    b, s, h, p, n, q = shape
    gen = torch.Generator(device=device).manual_seed(42)
    args = ssd_inputs(torch, gen, b, s, h, p, n, torch.bfloat16, device)
    run = lambda: ssd_scan(*args, chunk=q)
    err = ssd_err(torch, run(), ssd_scan_ref(*args, chunk=q), SSD_TOL, "timed ssd_scan")
    k_ms = time_ms(torch, run, 20)
    k_dev = device_ms(run, calls=10)
    p_ms = time_ms(torch, lambda: ssd_scan_ref(*args, chunk=q), 5)
    by_kernel = ssd_kernels_ran(torch, device, run, shape, s > q)
    bound_ms, bound_by, nbytes, flops = ssd_bound(b, s, h, p, n, q, 2)
    old_ms, old_by, _, old_flops = ssd_bound(b, s, h, p, n, q, 2, old=True)
    print(f"ssd_scan (b, s, h, p, n, Q) = {shape}, bf16 B/C, "
          f"{heads_per_block(b, s, h, p, n, q, device)} heads per block: kernel "
          f"{k_ms * 1e3!r} us (device {k_dev * 1e3!r} us), plain {p_ms * 1e3!r} us, bound "
          f"{bound_ms * 1e3!r} us (by {bound_by}: {nbytes} bytes, {flops} operations, the "
          f"products at the bf16 rate; before PR 33 {old_ms * 1e3!r} us by {old_by}, "
          f"{old_flops} float32 flops); device bound share {bound_ms / k_dev!r}; by kernel "
          f"(profiled device us a call) {by_kernel}; |kernel - plain| {err!r}; no single "
          f"PyTorch call computes it: library_ms is null")
    return {"shape": list(shape), "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "old_bound_ms": old_ms, "library_ms": None,
            "device_ms": k_dev, "library_device_ms": None, "kernels_device_us": by_kernel}


# ssd_scan's final state (return_state): the prefills phase 20 drives
# (mamba2-2.7b's and zamba2-7b's heads, one prompt of 128 tokens, one
# chunk) and phase 20.2's (2 rows of 128, and of 300 padded to 512: two
# chunks of 256).
SSD_STATE_DRIVEN = [(1, 128, 80, 64, 128, 128), (1, 128, 112, 64, 64, 128),
                    (2, 128, 80, 64, 128, 128), (2, 512, 80, 64, 128, 256),
                    (2, 512, 112, 64, 64, 256)]


def check_ssd_state(torch, device, driven):
    """ssd_scan(return_state=True) against its plain version and the
    sequential recurrence's final state, with float32 and bfloat16 B/C,
    over the grid (one and several chunks) and ``driven``; its ``y`` must
    be the one the scan returns without the state, bit for bit.  Returns
    the max state error against the plain version."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_ref
    from repro_torch.models.ssm import ssd_sequential_ref

    gen = torch.Generator(device=device).manual_seed(43)
    err = {"float32": 0.0, "bfloat16": 0.0}
    seq_err = 0.0
    chunks = set()
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for b, s, h, p, n, q in SSD_GRID + driven:
            args = ssd_inputs(torch, gen, b, s, h, p, n, dtype, device)
            y, state = ssd_scan(*args, chunk=q, return_state=True)
            y0 = ssd_scan(*args, chunk=q)
            sync(device)
            what = f"ssd_scan state, B/C {name} (b, s, h, p, n, Q) = {(b, s, h, p, n, q)}"
            if tuple(state.shape) != (b, h, p, n) or not torch.equal(y, y0):
                raise AssertionError(f"{what}: state {tuple(state.shape)}, y with the state "
                                     "differs from y without it")
            _, ref_state = ssd_scan_ref(*args, chunk=q, return_state=True)
            err[name] = max(err[name], ssd_err(torch, state, ref_state, SSD_TOL, what))
            _, seq_state = ssd_sequential_ref(*args)
            seq_err = max(seq_err, ssd_err(torch, state, seq_state, SSD_SEQ_TOL,
                                           what + " vs the sequential recurrence"))
            chunks.add(s // q)
            del args, y, y0, state, ref_state, seq_state
    if 1 not in chunks or max(chunks) < 2:
        raise AssertionError(f"the state check saw chunk counts {sorted(chunks)}")
    print(f"ssd_scan(return_state=True): the final state matches the plain version's "
          f"(tolerance {SSD_TOL}) and the sequential recurrence's (tolerance {SSD_SEQ_TOL}), "
          f"y equal to the stateless scan's bit for bit; B/C in float32 and bfloat16, "
          f"{sorted(chunks)} chunks, the grid and {driven}; max |state - plain| = {err}, "
          f"max |state - sequential| = {seq_err!r}")
    return max(err.values())


def time_ssd_state(torch, device, shape):
    """ssd_scan(return_state=True) at a prefill shape with bf16 B/C (the
    models' type): kernel, plain version and bound with the state's bytes
    and last update counted."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_ref

    b, s, h, p, n, q = shape
    gen = torch.Generator(device=device).manual_seed(44)
    args = ssd_inputs(torch, gen, b, s, h, p, n, torch.bfloat16, device)
    k_ms = time_ms(torch, lambda: ssd_scan(*args, chunk=q, return_state=True), 20)
    k_dev = device_ms(lambda: ssd_scan(*args, chunk=q, return_state=True), calls=10)
    y_dev = device_ms(lambda: ssd_scan(*args, chunk=q), calls=10)
    p_ms = time_ms(torch, lambda: ssd_scan_ref(*args, chunk=q, return_state=True), 5)
    by_kernel = ssd_kernels_ran(torch, device, lambda: ssd_scan(*args, chunk=q,
                                                                return_state=True), shape, True)
    bound_ms, bound_by, nbytes, flops = ssd_bound(b, s, h, p, n, q, 2, state=True)
    old_ms, old_by, _, _ = ssd_bound(b, s, h, p, n, q, 2, state=True, old=True)
    print(f"ssd_scan return_state (b, s, h, p, n, Q) = {shape}, bf16 B/C: kernel "
          f"{k_ms * 1e3!r} us (device {k_dev * 1e3!r} us; without the state {y_dev * 1e3!r} "
          f"us), plain {p_ms * 1e3!r} us, bound {bound_ms * 1e3!r} us (by {bound_by}: "
          f"{nbytes} bytes, {flops} operations; before PR 33 {old_ms * 1e3!r} us by {old_by}); "
          f"device bound share {bound_ms / k_dev!r}; by kernel (profiled device us a call) "
          f"{by_kernel}")
    return {"shape": list(shape), "ms": k_ms, "device_ms": k_dev, "stateless_device_ms": y_dev,
            "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "old_bound_ms": old_ms, "kernels_device_us": by_kernel}


# ssd_scan_bwd against its plain version (phase 3), per tensor as a share
# of the plain version's largest value: ddA is a difference of row and
# column sums through exp(cum_i - cum_j), which cancels, so an elementwise
# bar says nothing there.  float32: the same float32 formulas summed in
# another order.  bf16 B/C: against the float32 plain version on the same
# (upcast) inputs; dB and dC are rounded once to bf16 (at most 2^-8
# relative).
SSD_BWD_F32_SHARE = 1e-4
SSD_BWD_BF16_SHARE = 2.0 ** -7
# The training shapes of phase 24(c): 8 rows of 512 tokens, two chunks of
# 256 (``models.ssm.kernel_chunk``); mamba2-2.7b (H=80, P=64, N=128) and
# zamba2-7b (H=112, P=64, N=64).
SSD_TRAIN_SHAPES = [(TRAIN_B, TRAIN_S, 80, 64, 128, 256), (TRAIN_B, TRAIN_S, 112, 64, 64, 256)]


def check_ssd_bwd(torch, device):
    """ssd_scan_bwd against ssd_scan_bwd_ref with float32 and bfloat16 B/C
    over the grid and the training shapes, a second call bit-equal to the
    first (no atomics); autograd through ``ssd_scan`` (whose backward takes
    the states the bf16 forward kernel saved, at the training shape) gives
    the forward's ``y`` bit for bit and the direct call's gradients, which
    recompute the states.  Returns the max
    shares of the largest value (float32; bf16 dB/dC) and the float32 max
    absolute error."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd, ssd_scan_bwd_ref

    gen = torch.Generator(device=device).manual_seed(45)
    errs = {"float32_share": 0.0, "bfloat16_share": 0.0, "float32_abs": 0.0}
    worst = {}
    names = ("dxdt", "ddA", "dB", "dC")
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for b, s, h, p, n, q in SSD_GRID + SSD_TRAIN_SHAPES:
            what = f"ssd_scan_bwd B/C {name} (b, s, h, p, n, Q) = {(b, s, h, p, n, q)}"
            args = ssd_inputs(torch, gen, b, s, h, p, n, dtype, device)
            dy = torch.randn((b, s, h, p), generator=gen, device=device)
            before = LAUNCHES["ssd_scan_bwd"]
            got = ssd_scan_bwd(*args, dy, chunk=q)
            again = ssd_scan_bwd(*args, dy, chunk=q)
            sync(device)
            if LAUNCHES["ssd_scan_bwd"] != before + 2:
                raise AssertionError(f"{what}: launches {LAUNCHES['ssd_scan_bwd'] - before}")
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise AssertionError(f"{what}: a second call's gradients differ")
            xdt, dA, bm, cm = args
            ref = ssd_scan_bwd_ref(xdt, dA, bm.float(), cm.float(), dy, chunk=q)
            for grad, x, r, want in zip(names, got, ref, (torch.float32, torch.float32,
                                                          dtype, dtype)):
                if x.dtype != want or not bool(torch.isfinite(x).all()):
                    raise AssertionError(f"{what}: {grad} is {x.dtype} or not finite")
                diff = float((x.float() - r).abs().max())
                share = diff / max(float(r.abs().max()), 1e-30)
                rounded = dtype == torch.bfloat16 and grad in ("dB", "dC")
                bar = SSD_BWD_BF16_SHARE if rounded else SSD_BWD_F32_SHARE
                if share > bar:
                    raise AssertionError(f"{what}: {grad} differs by {share!r} of its "
                                         f"largest value (bar {bar})")
                key = "bfloat16_share" if rounded else "float32_share"
                errs[key] = max(errs[key], share)
                if not rounded:
                    errs["float32_abs"] = max(errs["float32_abs"], diff)
                    worst[grad] = max(worst.get(grad, 0.0), share)
            del args, dy, got, again, ref
    # Autograd through ssd_scan: y bit-equal to the no-grad call, the
    # gradients bit-equal to the direct call's, one launch each way.
    for b, s, h, p, n, q in ((2, 128, 4, 32, 16, 32), SSD_TRAIN_SHAPES[0]):
        xdt, dA, bm, cm = ssd_inputs(torch, gen, b, s, h, p, n, torch.bfloat16, device)
        dy = torch.randn((b, s, h, p), generator=gen, device=device)
        with torch.no_grad():
            y0 = ssd_scan(xdt, dA, bm, cm, chunk=q)
        leaves = [x.detach().clone().requires_grad_() for x in (xdt, dA, bm, cm)]
        before = dict(LAUNCHES)
        y = ssd_scan(*leaves, chunk=q)
        y.backward(dy)
        sync(device)
        direct = ssd_scan_bwd(xdt, dA, bm, cm, dy, chunk=q)
        if not torch.equal(y.detach(), y0):
            raise AssertionError(f"ssd_scan under grad at {(b, s, h, p, n, q)}: y differs")
        if not all(torch.equal(x.grad, d) for x, d in zip(leaves, direct)):
            raise AssertionError(f"ssd_scan autograd at {(b, s, h, p, n, q)}: the gradients "
                                 "differ from ssd_scan_bwd's")
        if (LAUNCHES["ssd_scan"] - before["ssd_scan"],
                LAUNCHES["ssd_scan_bwd"] - before["ssd_scan_bwd"]) != (1, 2):
            raise AssertionError(f"ssd_scan autograd: launches {LAUNCHES} from {before}")
        del xdt, dA, bm, cm, dy, y, y0, leaves, direct
    print(f"ssd_scan_bwd matches its plain version: (b, s, h, p, n, Q) in {SSD_GRID} and the "
          f"training shapes {SSD_TRAIN_SHAPES}, B/C float32 and bfloat16, a second call "
          f"bit-equal; max |d - plain| / max |plain| float32 {errs['float32_share']!r} (bar "
          f"{SSD_BWD_F32_SHARE}; by gradient {worst}), bf16 dB/dC "
          f"{errs['bfloat16_share']!r} (bar {SSD_BWD_BF16_SHARE}); float32 max |d - plain| "
          f"{errs['float32_abs']!r}; autograd through ssd_scan: y bit-equal to the no-grad "
          f"call, gradients bit-equal to the direct call")
    return errs


def ssd_bwd_bound(b, s, h, p, n, q, bc_bytes, per_head=False):
    """(bound_ms, bound_by, bytes, flops) of one ssd_scan_bwd: xdt and dy
    read, dxdt written in float32, dA read and ddA written, B and C read
    and dB and dC written once.  Flops, each product once: D = Σ_h dG is one
    causal [Q, Q] matrix per (row, chunk) and dB, dC are linear in it, so
    per (row, chunk) the lower triangles of G = C·Bᵀ, D·B and Dᵀ·C
    (Q(Q+1)N each); per (row, head) and chunk the causal halves of dM = dy
    xdtᵀ and Mᵀ dy (Q(Q+1)P each) and 8 operations on each entry of the half
    (the decay's subtract and exp, M, dG, dM∘M, its row and column sums, dG
    into D); per (row, head) and chunk boundary the state products h C,
    hᵀ dy, g B, gᵀ xdt and the two state passes (2QPN each), and <g, h>
    (2PN) per chunk with both.  ``per_head``: the count of a body that
    forms dG B and dGᵀ C per head (Q(Q+1)N each; 7 operations an entry), as
    the float32 body does."""
    nc = s // q
    tri = q * (q + 1)
    nbytes = 3 * 4 * b * s * h * p + 2 * 4 * b * s * h + 4 * bc_bytes * b * s * n
    state = (nc - 1) * b * h * 6 * 2 * q * p * n + max(nc - 2, 0) * b * h * 2 * p * n
    if per_head:
        flops = nc * b * tri * n + nc * b * h * (tri * (2 * p + 2 * n) + 7 * tri // 2) + state
    else:
        flops = 3 * nc * b * tri * n + nc * b * h * (2 * tri * p + 8 * tri // 2) + state
    b_s = {"bytes": nbytes / HBM_BYTES_PER_S, "operations": flops / FP32_OPS_PER_S}
    by = max(b_s, key=b_s.get)
    return b_s[by] * 1e3, by, nbytes, flops


def time_ssd_bwd(torch, device, shape):
    """The backward at a training shape (phase 24(c)'s) in one call: the
    tensor-core body on bf16 B/C and the CUDA-core float32 body on the
    same B/C upcast, in turns (bf16, float32, float32, bf16), by CUDA-graph
    replay; paced time, the plain version, the device time by kernel (bf16
    must run the tensor-core kernels, float32 the CUDA-core ones), the
    bound (and the per-head count beside it) and the tensor-core kernels'
    registers and spills; then the bf16 call given the states the forward
    kernel keeps under grad (its state kernel's backward direction alone),
    device time and by kernel; no single PyTorch call computes it."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd, ssd_scan_bwd_ref
    from repro_torch.kernels.ssd_scan.ops import _forward, bwd_heads_per_block

    b, s, h, p, n, q = shape
    gen = torch.Generator(device=device).manual_seed(46)
    args = ssd_inputs(torch, gen, b, s, h, p, n, torch.bfloat16, device)
    dy = torch.randn((b, s, h, p), generator=gen, device=device)
    upcast = (*args[:2], args[2].float(), args[3].float())
    run = lambda: ssd_scan_bwd(*args, dy, chunk=q)
    run_f32 = lambda: ssd_scan_bwd(*upcast, dy, chunk=q)
    k_ms = time_ms(torch, run, 10)
    turns = [(name, device_ms(fn, calls=5)) for name, fn in
             (("bf16", run), ("float32", run_f32), ("float32", run_f32), ("bf16", run))]
    k_dev = min(ms for name, ms in turns if name == "bf16")
    f32_dev = min(ms for name, ms in turns if name == "float32")
    p_ms = time_ms(torch, lambda: ssd_scan_bwd_ref(*args, dy, chunk=q), 3)
    by_kernel = device_us_by_kernel(torch, device, run, calls=3)
    f32_by_kernel = device_us_by_kernel(torch, device, run_f32, calls=1)
    if not any("mma" in k or "finish" in k for k in by_kernel) or \
            any("mma" in k or "finish" in k for k in f32_by_kernel):
        raise AssertionError(f"ssd_scan_bwd at {shape}: bf16 ran {sorted(by_kernel)}, float32 "
                             f"ran {sorted(f32_by_kernel)}")
    _, states = _forward(*args, chunk=q, keep_states=True)
    run_saved = lambda: ssd_scan_bwd(*args, dy, chunk=q, states=states)
    saved_dev = device_ms(run_saved, calls=5)
    saved_by_kernel = device_us_by_kernel(torch, device, run_saved, calls=3)
    bound_ms, bound_by, nbytes, flops = ssd_bwd_bound(b, s, h, p, n, q, 2)
    old_ms, _, _, old_flops = ssd_bwd_bound(b, s, h, p, n, q, 2, per_head=True)
    registers = [line.strip() for line in ptxas_summary(_build.BUILD_LOGS.get("ssd_scan_bwd", ""))
                 if "mma_kernel" in line or "finish_kernel" in line]
    group = bwd_heads_per_block(b, s, h, p, n, q, device)
    print(f"ssd_scan_bwd (b, s, h, p, n, Q) = {shape}: bf16 B/C (tensor-core body, {group} heads "
          f"per chunk block) kernel {k_ms * 1e3!r} us (device {k_dev * 1e3!r} us), the "
          f"float32 body on the upcast B/C device {f32_dev * 1e3!r} us (turns: {turns}), plain "
          f"{p_ms * 1e3!r} us, bound {bound_ms * 1e3!r} us (by {bound_by}: {nbytes} bytes, "
          f"{flops} flops; counted per head {old_flops} flops, {old_ms * 1e3!r} us); device "
          f"bound share {bound_ms / k_dev!r} (float32 body {bound_ms / f32_dev!r}); by kernel "
          f"(profiled device us a call): bf16 {by_kernel}, float32 {f32_by_kernel}; given the "
          f"forward's states: device {saved_dev * 1e3!r} us, by kernel {saved_by_kernel}; "
          f"registers and spills: {registers}; no single PyTorch call computes it: library_ms "
          f"is null")
    return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "device_ms": k_dev, "library_device_ms": None,
            "kernels_device_us": by_kernel, "heads_per_block": group,
            "per_head_count_bound_ms": old_ms, "f32_body_device_ms": f32_dev,
            "f32_body_kernels_device_us": f32_by_kernel, "registers": registers,
            "saved_states_device_ms": saved_dev, "saved_states_kernels_device_us": saved_by_kernel}


def main_path(torch, device):
    """Phase 4: 256 tap-game searches through build_searcher."""
    from repro_torch import rng
    from repro_torch.core import SearchSpec, build_searcher
    from repro_torch.envs import make_tap_game
    from repro_torch.envs.base import map_state
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.sync import SYNCS, reset_syncs

    env = make_tap_game(6, 4, goal_count=10, step_budget=20)
    spec = SearchSpec(algo="wu_uct", engine="wave", batch=MAIN_B, **MAIN_SPEC)
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

    # One walk per selection (W slots in each of T / W waves), no per-level
    # selection launch.
    if (launches["tree_descend"], launches["tree_select"]) != (spec.num_simulations, 0):
        raise AssertionError(f"tree_descend launched {launches['tree_descend']} times and "
                             f"tree_select {launches['tree_select']}, expected "
                             f"{spec.num_simulations} and 0")
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
          f"tree_descend launches {launches['tree_descend']}, tree_select launches "
          f"{launches['tree_select']}, host syncs {syncs}; "
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
        spec = SearchSpec(algo=algo, batch=b, **BANDIT_SPEC)
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
    return shares


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


def lm_setup(torch, device, layers, dtype, seed, name="llama3-8b", **overrides):
    """Model ``name`` at full width with ``layers`` layers (and the
    configuration's ``overrides``), random parameters from the port's
    ``init_params`` on the card."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    full = get_config(name)
    cfg = dataclasses.replace(full, num_layers=layers, dtype=dtype, **overrides)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(seed))
    sync(device)
    depth = ("" if layers == full.num_layers
             else f" (reduced from {full.num_layers}: {full.param_count()} in full)")
    print(f"{name} {layers} layers{depth} {dtype}: {cfg.param_count()} parameters made on "
          f"the card in {time.perf_counter() - t0!r} s")
    return cfg, params


def serve_layers(torch, cfg, params):
    """Phase 7's llama3-8b cut to its first ``SERVE_LAYERS`` layers: views
    of the stacked layer leaves, no copy."""
    import dataclasses

    from repro_torch.models.lm import tree_map

    cut = {**params, "blocks": tree_map(lambda x: x[:SERVE_LAYERS], params["blocks"])}
    print(f"phases 17-19 serve {SERVE_LAYERS} of llama3-8b's {cfg.num_layers} layers")
    return dataclasses.replace(cfg, num_layers=SERVE_LAYERS), cut


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


def guided_cell(torch, device, cfg, params, simulations=64):
    """Phase 7's cell: the token environment over ``cfg``/``params``, the
    async wu_uct spec (B=8, W=16, T=64 unless ``simulations`` says
    otherwise), the roots and the keys."""
    from repro_torch import rng
    from repro_torch.core import SearchSpec
    from repro_torch.envs import make_token_env

    prompt = prompt_tokens(torch, cfg.vocab_size, PROMPT_LEN, seed=2).to(device)
    env = make_token_env(cfg, params, prompt, max_len=MAX_LEN, top_k=TOP_K, eos_token=EOS)
    spec = SearchSpec(algo="wu_uct", engine="async", batch=ASYNC_B, num_simulations=simulations,
                      wave_size=ASYNC_W, max_depth=8, max_sim_steps=8, max_width=8,
                      gamma=1.0)
    roots = env.init(rng.split(rng.PRNGKey(0, device=device), ASYNC_B))
    rngs = rng.split(rng.PRNGKey(1, device=device), ASYNC_B)
    return env, spec, roots, rngs


def counted_run(torch, device, fn):
    """Run ``fn`` once with every launch, model-call and sync count at 0
    before and read after; returns (its result, wall, launches, calls,
    syncs, peak memory in GiB)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import CALLS, reset_calls
    from repro_torch.sync import SYNCS, reset_syncs

    sync(device)
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    reset_calls()
    reset_syncs()
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    wall = time.perf_counter() - t0
    return (out, wall, dict(LAUNCHES), dict(CALLS), SYNCS["host_any"],
            torch.cuda.max_memory_allocated(device) / 2 ** 30)


def model_guided(torch, device, cfg, params, profile=True):
    """Phase 7 (and 22a over qwen2-moe): 8 async WU-UCT searches with the
    KV-cached evaluator; one decode step (one decode_attention launch per
    layer) per tick; then, with ``profile``, a warm call under the
    profiler."""
    from repro_torch.core import CachedModelEvaluator, build_searcher

    env, spec, roots, rngs = guided_cell(torch, device, cfg, params)
    ev = CachedModelEvaluator(cfg, params, top_k=TOP_K, eos_token=EOS)
    search = build_searcher(env, spec, evaluator=ev, device=device)
    res, wall, launches, calls, syncs, peak = counted_run(torch, device,
                                                         lambda: search(roots, rngs))
    launch_identity(launches, calls, "decode_attention", "decode_step", cfg.num_layers)
    search_results_ok(torch, res, spec, f"{cfg.name} model-guided search")
    print(f"model-guided path: {cfg.name} {cfg.num_layers} layers bf16, async wu_uct "
          f"B={ASYNC_B} W={ASYNC_W} T={spec.num_simulations}, prompt {PROMPT_LEN}, "
          f"max_len {MAX_LEN}, top_k {TOP_K}: {ASYNC_B / wall!r} searches/s (wall {wall!r} "
          f"s, first call), master ticks {int(res.ticks.max())}, model calls {calls}, "
          f"launches {launches}, host syncs {syncs}, peak memory {peak!r} GiB; "
          f"actions {res.action.tolist()}, root_n sums {res.root_n.sum(1).tolist()}")
    if profile:
        profile_call(torch, device, lambda: search(roots, rngs), "model-guided path")
    return launches, {"action": res.action.cpu(), "calls": calls, "peak": peak,
                      "wall": wall, "ticks": int(res.ticks.max())}


def engine_search(torch, device, cfg, params, ev):
    """Phase 7's searches with evaluator ``ev``, through the async engine's
    own entry points (``build_searcher`` checks the evaluator first), so the
    evaluator's aux and the per-tree frontier hits can be read after."""
    from repro_torch.core import BatchedAsyncEngine, build_searcher

    env, spec, roots, rngs = guided_cell(torch, device, cfg, params)
    build_searcher(env, spec, evaluator=ev, device=device)
    engine = BatchedAsyncEngine(env, spec.config, ASYNC_B, evaluator=ev)

    def run():
        carry, _, _ = engine.run_segment(engine.init_carry(roots, rngs), 10 ** 9)
        return carry

    carry, wall, launches, calls, syncs, peak = counted_run(torch, device, run)
    res = engine.result(carry)
    search_results_ok(torch, res, spec, type(ev).__name__)
    return dict(engine=engine, carry=carry, res=res, wall=wall, launches=launches,
                calls=calls, syncs=syncs, peak=peak, spec=spec, run=run)


def launch_identity(launches, calls, kernel, call, layers):
    """``kernel`` launched exactly once per layer of every ``call``."""
    if calls[call] == 0 or launches[kernel] != layers * calls[call]:
        raise AssertionError(f"{kernel} launched {launches[kernel]} times for "
                             f"{calls[call]} {call} calls of {layers} layers")


def agree_actions(torch, res, base, what, other="phase 7"):
    """At least 7 of 8 trees choose ``base``'s action; returns how many."""
    same = res.action.cpu() == base["action"]
    for i in np.flatnonzero(~same.numpy()):
        print(f"{what} tree {i}: action {int(res.action[i])}, {other} "
              f"{int(base['action'][i])} (root_n {res.root_n[i].cpu().tolist()})")
    if int(same.sum()) < 7:
        raise AssertionError(f"{what}: actions agree with {other}'s on {int(same.sum())} "
                             "of 8 trees")
    return int(same.sum())


def guided_line(run, cfg, what):
    res = run["res"]
    return (f"{what}: llama3-8b {cfg.num_layers} layers bf16, phase 7's cell: "
            f"{ASYNC_B / run['wall']!r} searches/s (wall {run['wall']!r} s, first call), "
            f"master ticks {int(res.ticks.max())}, model calls "
            f"{ {k: v for k, v in run['calls'].items() if v} }, launches "
            f"{ {k: v for k, v in run['launches'].items() if v} }, host syncs "
            f"{run['syncs']}, peak memory {run['peak']!r} GiB; actions "
            f"{res.action.tolist()}")


def paged_path(torch, device, cfg, params, base):
    """Phase 10: phase 7's searches with the paged evaluator (16-token
    blocks, 1280 of them); every paged decode step launches
    paged_decode_attention once per layer."""
    from repro_torch.core import PagedCachedModelEvaluator

    ev = PagedCachedModelEvaluator(cfg, params, top_k=TOP_K, eos_token=EOS,
                                   block_size=BLOCK, num_blocks=POOL_BLOCKS)
    run = engine_search(torch, device, cfg, params, ev)
    launch_identity(run["launches"], run["calls"], "paged_decode_attention",
                    "paged_decode_step", cfg.num_layers)
    run["engine"].check_exhausted(run["carry"])
    same = agree_actions(torch, run["res"], base, "paged search")
    blocks = int(ev.aux_blocks(run["carry"][7]))
    print(guided_line(run, cfg, "paged path") + f"; blocks in use after the search "
          f"{blocks} of {POOL_BLOCKS}; phase 7's peak memory {base['peak']!r} GiB; phase "
          f"7's action on {same}/8 trees")
    return run["launches"]


def frontier_numerics(torch, device, cfg, params):
    """Where a frontier forward's bf16 logits leave the decode step's, at
    phase 7's width and type and ``cfg``'s depth.  Returns a dict of shares:

    * ``attn``: ``tree_decode_attention`` elements that differ from
      ``decode_attention`` over the cache with each candidate's key
      appended at position ``kv_len`` (128 rows x 8 candidates, random);
    * ``gemm``: elements of a layer's down projection over 1024 rows
      (8 candidates x 128, one call) that differ from the same rows taken
      128 at a time (the decode step's shape);
    * end to end: 128 rows of phase 7's prompt plus 8-24 random tokens,
      each row's top-8 candidates scored by ``decode_frontier`` and, one
      column at a time, by ``decode_step`` (as the cached search scores
      them): the share of logits that differ (``differ``), the max
      difference (``max_diff``) and the share of rows whose next top-8
      table is the same (``top_same``); and the same two shares against
      one ``decode_step`` over the cache repeated 8 times, 1024 rows, the
      frontier's GEMM shapes (``rows_differ``, ``rows_top_same``), which
      leaves only the attention's order of summation between the two.
    """
    from repro_torch.envs.token_env import sorted_top_k
    from repro_torch.kernels.decode_attention import decode_attention, tree_decode_attention
    from repro_torch.models import decode_frontier, decode_step, init_cache, prefill_ragged

    gen = torch.Generator(device=device).manual_seed(31)
    n, a, hq, hkv, d = ASYNC_B * ASYNC_W, TOP_K, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=device).to(cfg.dtype)

    def top_same(x, y):
        return float((sorted_top_k(x, a)[1] == sorted_top_k(y, a)[1]).all(1).float().mean())

    q, kc, vc, ks, vs = (rand(n, a, hq, d), rand(n, MAX_LEN, hkv, d),
                         rand(n, MAX_LEN, hkv, d), rand(n, a, hkv, d), rand(n, a, hkv, d))
    lens = torch.randint(PROMPT_LEN, MAX_LEN - 1, (n,), generator=gen, device=device,
                         dtype=torch.int32)
    tree = tree_decode_attention(q, kc, vc, ks, vs, lens)
    rows = torch.arange(n, device=device)
    out = {"attn": 0.0}
    for j in range(a):
        k2, v2 = kc.clone(), vc.clone()
        k2[rows, lens.long()] = ks[:, j]
        v2[rows, lens.long()] = vs[:, j]
        dec = decode_attention(q[:, j].contiguous(), k2, v2, lens + 1)
        out["attn"] += float((dec != tree[:, j]).float().mean()) / a
    w_down = params["blocks"]["mlp"]["w_down"][0]
    h = rand(n, a, w_down.shape[0])
    whole = (h.reshape(n * a, -1) @ w_down).reshape(n, a, -1)
    out["gemm"] = sum(float((whole[:, j] != h[:, j].contiguous() @ w_down).float().mean())
                      for j in range(a)) / a

    toks = torch.randint(2, cfg.vocab_size, (n, MAX_LEN), generator=gen, device=device,
                         dtype=torch.int32)
    toks[:, :PROMPT_LEN] = prompt_tokens(torch, cfg.vocab_size, PROMPT_LEN, seed=2).to(device)
    lens = torch.randint(PROMPT_LEN + 8, PROMPT_LEN + 25, (n,), generator=gen, device=device,
                         dtype=torch.int32)
    logits, cache = prefill_ragged(params, cfg, toks, lens,
                                   init_cache(cfg, n, MAX_LEN, device=device))
    _, cand = sorted_top_k(logits, a)
    clog, _ = decode_frontier(params, cfg, cand, dict(cache, len=lens))
    out.update(differ=0.0, top_same=0.0, max_diff=0.0)
    for j in range(a):
        step, _ = decode_step(params, cfg, cand[:, j], {
            "kv": {k: v.clone() for k, v in cache["kv"].items()}, "len": lens})
        out["differ"] += float((step != clog[:, j]).float().mean()) / a
        out["max_diff"] = max(out["max_diff"],
                              float((step.float() - clog[:, j].float()).abs().max()))
        out["top_same"] += top_same(step, clog[:, j]) / a
    repeated = {"kv": {k: v.repeat_interleave(a, dim=1) for k, v in cache["kv"].items()},
                "len": lens.repeat_interleave(a)}
    flat, _ = decode_step(params, cfg, cand.reshape(-1), repeated)
    del repeated
    out["rows_differ"] = float((flat != clog.reshape(n * a, -1)).float().mean())
    out["rows_top_same"] = top_same(flat, clog.reshape(n * a, -1))
    return out


def numerics_line(num, cfg):
    dtype = str(cfg.dtype).removeprefix("torch.")
    return (f"frontier numerics, {dtype}, layers {cfg.num_layers}: decode_frontier vs "
            f"decode_step logits of the same candidates, 128 rows x 8: share differing "
            f"{num['differ']!r}, max |difference| {num['max_diff']!r}, next top-8 table "
            f"unchanged on {num['top_same']!r} of rows; against one decode_step over 1024 "
            f"rows (the frontier's GEMM shapes): share differing {num['rows_differ']!r}, "
            f"top-8 unchanged on {num['rows_top_same']!r}")


def frontier_path(torch, device, cfg, params, base):
    """Phase 11: phase 7's searches with the dense frontier evaluator; every
    frontier forward launches tree_decode_attention once per layer, every
    plain step decode_attention.

    Its actions are printed beside phase 7's but not held to them: in
    bf16 over 32 random layers the frontier forward (one GEMM over N * A
    rows), the decode step and the cached evaluator's chunked catch-up are
    three numerical paths, and their one-ulp differences change the next
    top-8 tables of most rows (measured here by :func:`frontier_numerics`).
    The frontier path's decisions are held where one bf16 layer does not
    amplify those differences (:func:`frontier_one_layer`), and in float32
    (phase 9.3); phase 12 is held to this phase's actions."""
    from repro_torch.core import FrontierModelEvaluator

    ev = FrontierModelEvaluator(cfg, params, top_k=TOP_K, eos_token=EOS)
    run = engine_search(torch, device, cfg, params, ev)
    launches, calls = run["launches"], run["calls"]
    launch_identity(launches, calls, "tree_decode_attention", "decode_frontier",
                    cfg.num_layers)
    launch_identity(launches, calls, "decode_attention", "decode_step", cfg.num_layers)
    same = int((run["res"].action.cpu() == base["action"]).sum())
    hits = run["engine"].frontier_hits(run["carry"])
    print(guided_line(run, cfg, "frontier path") + f"; frontier hits per tree "
          f"{hits.tolist()}; model calls against phase 7's "
          f"{ {k: v for k, v in base['calls'].items() if v} }; phase 7's action on "
          f"{same}/8 trees (not held: bf16 numerics)")
    num = frontier_numerics(torch, device, cfg, params)
    print(f"frontier numerics, bf16: tree_decode_attention vs decode_attention with the "
          f"candidate's key appended, share of elements differing {num['attn']!r} (held "
          f"at 0.0); down projection over 1024 rows vs 128 at a time, share differing "
          f"{num['gemm']!r}")
    if num["attn"] != 0.0:
        raise AssertionError(f"tree_decode_attention differs from decode_attention with "
                             f"the candidate's key appended on {num['attn']!r} of elements: "
                             f"the four decode kernels must round alike")
    print(numerics_line(num, cfg))
    frontier_one_layer(torch, device, cfg, params)
    return launches, {"action": run["res"].action.cpu()}


# Phase 11's one-layer check: decode_frontier keeps decode_step's next top-8
# table on at least this share of rows (0.957 on the H100).  A wrong
# position, candidate or K/V row would change nearly every table.
ONE_LAYER_TOP8_FLOOR = 0.9


def frontier_one_layer(torch, device, cfg, params):
    """Phase 11's path held in bf16 where the numerics allow: phase 7's
    parameters cut to their first layer (full width), phase 7's cell.
    ``decode_frontier`` must keep ``decode_step``'s next top-8 table on at
    least :data:`ONE_LAYER_TOP8_FLOOR` of rows, and the frontier and paged
    frontier searches must choose the cached search's action on at least 7
    of 8 trees."""
    import dataclasses

    from repro_torch.core import (
        CachedModelEvaluator,
        FrontierModelEvaluator,
        PagedFrontierModelEvaluator,
        build_searcher,
    )

    cfg1 = dataclasses.replace(cfg, num_layers=1)
    num = frontier_numerics(torch, device, cfg1, params)
    print(numerics_line(num, cfg1))
    if num["top_same"] < ONE_LAYER_TOP8_FLOOR:
        raise AssertionError(f"1 layer bf16: decode_frontier keeps decode_step's top-8 "
                             f"table on {num['top_same']!r} of rows, under "
                             f"{ONE_LAYER_TOP8_FLOOR}")
    env, spec, roots, rngs = guided_cell(torch, device, cfg1, params)
    kw = dict(top_k=TOP_K, eos_token=EOS)
    base = None
    for what, ev in (("cached", CachedModelEvaluator(cfg1, params, **kw)),
                     ("frontier", FrontierModelEvaluator(cfg1, params, **kw)),
                     ("paged frontier", PagedFrontierModelEvaluator(
                         cfg1, params, **kw, block_size=BLOCK, num_blocks=POOL_BLOCKS))):
        res = build_searcher(env, spec, evaluator=ev, device=device)(roots, rngs)
        search_results_ok(torch, res, spec, f"1 layer bf16 {what} search")
        if base is None:
            base = {"action": res.action.cpu()}
            continue
        same = agree_actions(torch, res, base, f"1 layer bf16 {what} search", "cached")
        print(f"full width, 1 layer, bf16, phase 7's cell: {what} search chooses the "
              f"cached search's action on {same}/8 trees")


def paged_frontier_path(torch, device, cfg, params, base, dense_frontier):
    """Phase 12: phase 7's searches with the paged frontier evaluator; every
    frontier forward launches paged_tree_decode_attention once per layer;
    its actions are held to phase 11's (the dense frontier search, the same
    numerical path through paged addressing); then a warm second call under
    torch.profiler."""
    from repro_torch.core import PagedFrontierModelEvaluator

    ev = PagedFrontierModelEvaluator(cfg, params, top_k=TOP_K, eos_token=EOS,
                                     block_size=BLOCK, num_blocks=POOL_BLOCKS)
    run = engine_search(torch, device, cfg, params, ev)
    launches, calls = run["launches"], run["calls"]
    launch_identity(launches, calls, "paged_tree_decode_attention",
                    "paged_decode_frontier", cfg.num_layers)
    launch_identity(launches, calls, "paged_decode_attention", "paged_decode_step",
                    cfg.num_layers)
    run["engine"].check_exhausted(run["carry"])
    same = agree_actions(torch, run["res"], dense_frontier, "paged frontier search",
                         "phase 11")
    same7 = int((run["res"].action.cpu() == base["action"]).sum())
    hits = run["engine"].frontier_hits(run["carry"])
    blocks = int(ev.aux_blocks(run["carry"][7]))
    print(guided_line(run, cfg, "paged frontier path") + f"; frontier hits per tree "
          f"{hits.tolist()}; blocks in use after the search {blocks} of {POOL_BLOCKS}; "
          f"phase 11's action on {same}/8 trees, phase 7's on {same7}/8 (not held)")
    profile_call(torch, device, run["run"], "paged frontier path")
    return launches


# Device-function names of the port's kernels (csrc/), whose profiled time
# profile_call prints whether or not they are among the top entries.
PORT_KERNEL_NAMES = ("tree_select_kernel", "tree_descend_kernel", "split_kernel",
                     "tree_kernel", "flash_wgmma_kernel", "flash_mma_kernel",
                     "flash_attention_kernel", "ssd_wgmma_kernel", "ssd_mma_kernel",
                     "ssd_fwd_state_mma_kernel", "ssd_scan_kernel")


def profile_call(torch, device, fn, what, top=10):
    """Run ``fn`` once more (warm) under torch.profiler: wall, the card's
    busy share, the kernels that took the device time and every kernel of
    the port that ran.  Only device activity is traced, and the raw device
    events are summed by kernel name: ``key_averages()`` first builds a
    Python event tree, which takes minutes for a call that launches
    ~700,000 kernels."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync(device)
        wall = time.perf_counter() - t0
    totals: dict[str, list] = {}
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() == torch.autograd.DeviceType.CUDA:
            row = totals.setdefault(evt.name(), [0.0, 0])
            row[0] += evt.duration_ns() * 1e-3
            row[1] += 1
    rows = [(us, count, key) for key, (us, count) in totals.items()]
    busy = sum(r[0] for r in rows) * 1e-6
    print(f"{what}, second call under torch.profiler: wall {wall!r} s, device busy "
          f"{busy!r} s ({busy / wall!r} of wall), {sum(r[1] for r in rows)} device kernels")
    for dev_us, count, key in sorted(rows, reverse=True)[:top]:
        print(f"  {dev_us * 1e-3!r} ms  {count} x  {key[:100]}")
    print("  the port's kernels:")
    for dev_us, count, key in sorted(rows, reverse=True):
        if any(name in key for name in PORT_KERNEL_NAMES):
            print(f"  {dev_us * 1e-3!r} ms  {count} x  {key[:140]}")


def wave_search(torch, device, cfg, params):
    """Phase 8's cell over ``cfg``/``params``: ``ModelEvaluator`` on the
    wave engine, B=2, W=4, T=8; returns the search's result and
    :func:`counted_run`'s counts."""
    from repro_torch import rng
    from repro_torch.core import ModelEvaluator, SearchSpec, build_searcher
    from repro_torch.envs import make_token_env

    prompt = prompt_tokens(torch, cfg.vocab_size, PROMPT_LEN, seed=2).to(device)
    env = make_token_env(cfg, params, prompt, max_len=MAX_LEN, top_k=TOP_K, eos_token=EOS)
    ev = ModelEvaluator(cfg, params, top_k=TOP_K, eos_token=EOS)
    spec = SearchSpec(algo="wu_uct", engine="wave", batch=WAVE_B, num_simulations=8,
                      wave_size=WAVE_W, max_depth=8, max_sim_steps=8, max_width=8,
                      gamma=1.0)
    search = build_searcher(env, spec, evaluator=ev, device=device)
    roots = env.init(rng.split(rng.PRNGKey(0, device=device), WAVE_B))
    rngs = rng.split(rng.PRNGKey(1, device=device), WAVE_B)
    res, wall, launches, calls, syncs, peak = counted_run(torch, device,
                                                         lambda: search(roots, rngs))
    search_results_ok(torch, res, spec, f"{cfg.name} wave search")
    line = (f"ModelEvaluator, wave wu_uct B={WAVE_B} W={WAVE_W} T={spec.num_simulations}: "
            f"{WAVE_B / wall!r} searches/s (wall {wall!r} s, first call), model calls "
            f"{ {k: v for k, v in calls.items() if v} }, launches "
            f"{ {k: v for k, v in launches.items() if v} }, host syncs {syncs}, peak memory "
            f"{peak!r} GiB; actions {res.action.tolist()}")
    return launches, calls, line


def uncached(torch, device, cfg, params):
    """Phase 8: ModelEvaluator on the wave engine; every forward (the
    environment's steps and the tick-driven rollouts) runs flash_attention
    in each of its layers."""
    launches, calls, line = wave_search(torch, device, cfg, params)
    launch_identity(launches, calls, "flash_attention", "forward", cfg.num_layers)
    print(f"uncached path: llama3-8b {cfg.num_layers} layers bf16, {line}")
    return launches


def ssm_path(torch, device, cfg, params):
    """Phase 13: phase 7's cell (async wu_uct, B=8, W=16, T=64, the
    128-token prompt, max_len 160, top-8) over mamba2-2.7b with
    ``ModelEvaluator``: one forward of all 128 slots per master tick, 64
    ssd_scan launches per forward; then a warm second call under
    torch.profiler."""
    from repro_torch.core import ModelEvaluator, build_searcher

    env, spec, roots, rngs = guided_cell(torch, device, cfg, params)
    ev = ModelEvaluator(cfg, params, top_k=TOP_K, eos_token=EOS)
    search = build_searcher(env, spec, evaluator=ev, device=device)
    res, wall, launches, calls, syncs, peak = counted_run(torch, device,
                                                         lambda: search(roots, rngs))
    launch_identity(launches, calls, "ssd_scan", "forward", cfg.num_layers)
    search_results_ok(torch, res, spec, "SSM search")
    print(f"SSM path: mamba2-2.7b {cfg.num_layers} layers bf16, async wu_uct B={ASYNC_B} "
          f"W={ASYNC_W} T={spec.num_simulations} with ModelEvaluator, prompt {PROMPT_LEN}, "
          f"max_len {MAX_LEN}, top_k {TOP_K}: {ASYNC_B / wall!r} searches/s (wall {wall!r} "
          f"s, first call), master ticks {int(res.ticks.max())}, model calls "
          f"{ {k: v for k, v in calls.items() if v} }, launches "
          f"{ {k: v for k, v in launches.items() if v} }, host syncs {syncs}, peak memory "
          f"{peak!r} GiB; actions {res.action.tolist()}, root_n sums "
          f"{res.root_n.sum(1).tolist()}")
    profile_call(torch, device, lambda: search(roots, rngs), "SSM path")
    return launches


def hybrid_path(torch, device, cfg, params):
    """Phase 14: phase 8's wave cell over zamba2-7b with ``ModelEvaluator``;
    every forward launches ssd_scan in each of its 81 layers and
    flash_attention (D=112) at each of the shared block's 14 sites."""
    from repro_torch.models.lm import _num_attn_sites

    launches, calls, line = wave_search(torch, device, cfg, params)
    launch_identity(launches, calls, "ssd_scan", "forward", cfg.num_layers)
    launch_identity(launches, calls, "flash_attention", "forward", _num_attn_sites(cfg))
    print(f"hybrid path: zamba2-7b {cfg.num_layers} layers ({_num_attn_sites(cfg)} shared "
          f"attention sites) bf16, {line}")
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


def reduced_spec(engine="async"):
    """Phase 9's reduced search: B=8, W=4, T=32, depth and rollouts 6."""
    from repro_torch.core import SearchSpec

    return SearchSpec(algo="wu_uct", engine=engine, batch=8, num_simulations=32,
                      wave_size=4, max_depth=6, max_sim_steps=6, max_width=TOP_K, gamma=1.0)


def gpu_cpu_agree(torch, device, cfg, params, spec, make_ev, what):
    """One search of the reduced token environment (vocab 64, an 8-token
    prompt, max_len 20) on the GPU and on the port's CPU path, same keys
    and parameters; at least 7 of 8 actions equal.  Returns the GPU run's
    launches and model calls."""
    from repro_torch import rng
    from repro_torch.core import build_searcher
    from repro_torch.envs import make_token_env
    from repro_torch.models.lm import tree_map

    results = []
    for dev in (device, torch.device("cpu")):
        p = tree_map(lambda x: x.to(dev), params)
        env = make_token_env(cfg, p, prompt_tokens(torch, 64, 8, seed=6).to(dev),
                             max_len=REDUCED_MAX_LEN, top_k=TOP_K, eos_token=EOS)
        roots = env.init(rng.split(rng.PRNGKey(7, device=dev), 8))
        search = build_searcher(env, spec, evaluator=make_ev(p), device=dev)
        results.append(counted_run(torch, device, lambda: search(
            roots, rng.split(rng.PRNGKey(8, device=dev), 8))))
    (gpu, _, launches, calls, _, _), (cpu, *_) = results
    search_results_ok(torch, gpu, spec, f"{what} on the GPU")
    same = gpu.action.cpu() == cpu.action
    for i in np.flatnonzero(~same.numpy()):
        print(f"{what} tree {i}: GPU action {int(gpu.action[i])}, CPU action "
              f"{int(cpu.action[i])} (root_n GPU {gpu.root_n[i].cpu().tolist()} CPU "
              f"{cpu.root_n[i].tolist()})")
    if int(same.sum()) < 7:
        raise AssertionError(f"GPU and CPU {what}es agree on {int(same.sum())} of 8")
    print(f"{what}: GPU and CPU port agree on {int(same.sum())}/8 trees; root_n equal on "
          f"{int((gpu.root_n.cpu() == cpu.root_n).all(1).sum())}/8")
    return launches, calls


def agreement_reduced(torch, device):
    """Phase 9.2: the reduced model's async search on the GPU and on the
    port's CPU path, same keys and parameters, with the KV-cached evaluator
    and with the paged frontier evaluator."""
    from repro_torch.configs import get_reduced
    from repro_torch.core import CachedModelEvaluator, PagedFrontierModelEvaluator
    from repro_torch.models import init_params

    cfg = get_reduced("llama3-8b", vocab_size=64, num_layers=2)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(4))
    blocks = 8 * 4 * -(-REDUCED_MAX_LEN // REDUCED_BLOCK)
    evaluators = {
        "cached": lambda p: CachedModelEvaluator(cfg, p, top_k=TOP_K, eos_token=EOS),
        "paged frontier": lambda p: PagedFrontierModelEvaluator(
            cfg, p, top_k=TOP_K, eos_token=EOS, block_size=REDUCED_BLOCK, num_blocks=blocks),
    }
    for what, make in evaluators.items():
        gpu_cpu_agree(torch, device, cfg, params, reduced_spec(), make,
                      f"reduced llama3-8b (vocab 64, 2 layers) async {what} search")


def agreement_ssm(torch, device):
    """Phase 9.4: mamba2-2.7b at full width, 2 layers, float32 (no TF32):
    ``forward`` through the ssd_scan kernel against the same forward with
    the plain scan, one chunk (S=160, the main path's) and three (S=384,
    Q=128); then the reduced mamba2 (async engine) and zamba2 (wave engine)
    ``ModelEvaluator`` searches on the GPU against the port on the CPU."""
    import repro_torch.models.ssm as ssm_module
    from repro_torch.configs import get_reduced
    from repro_torch.core import ModelEvaluator
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.ssd_scan import ssd_scan_ref
    from repro_torch.models import forward, init_params
    from repro_torch.models.lm import _num_attn_sites

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cfg, params = lm_setup(torch, device, 2, torch.float32, seed=5, name="mamba2-2.7b")
    gen = torch.Generator(device=device).manual_seed(8)
    for s in (MAX_LEN, 384):
        toks = torch.randint(2, cfg.vocab_size, (4, s), generator=gen, device=device,
                             dtype=torch.int32)
        reset_launches()
        kernel, _ = forward(params, cfg, {"tokens": toks})
        kernel_launches = LAUNCHES["ssd_scan"]
        wrapper, ssm_module.ssd_scan = ssm_module.ssd_scan, ssd_scan_ref
        try:
            plain, _ = forward(params, cfg, {"tokens": toks})
        finally:
            ssm_module.ssd_scan = wrapper
        if (kernel_launches, LAUNCHES["ssd_scan"]) != (2, 2):
            raise AssertionError(f"ssd_scan launched {kernel_launches} times in the kernel "
                                 f"forward and {LAUNCHES['ssd_scan'] - kernel_launches} in "
                                 "the plain one: expected 2 and 0")
        diff = float((kernel - plain).abs().max())
        torch.testing.assert_close(kernel, plain, **LOGIT_TOL)
        print(f"mamba2-2.7b full width, 2 layers, float32, 4 x {s} tokens: max |forward "
              f"through ssd_scan - forward through the plain scan| = {diff!r} (logits up to "
              f"{float(plain.abs().max())!r}; tolerance {LOGIT_TOL})")
    del params, kernel, plain
    torch.cuda.empty_cache()

    for arch, engine in (("mamba2-2.7b", "async"), ("zamba2-7b", "wave")):
        cfg = get_reduced(arch, vocab_size=64)
        params = init_params(cfg, torch.Generator(device=device).manual_seed(4))
        launches, calls = gpu_cpu_agree(
            torch, device, cfg, params, reduced_spec(engine),
            lambda p: ModelEvaluator(cfg, p, top_k=TOP_K, eos_token=EOS),
            f"reduced {arch} (vocab 64, 2 layers) {engine} ModelEvaluator search")
        launch_identity(launches, calls, "ssd_scan", "forward", cfg.num_layers)
        if arch == "zamba2-7b":
            launch_identity(launches, calls, "flash_attention", "forward",
                            _num_attn_sites(cfg))


def agreement_frontier(torch, device):
    """Phase 9.3: frontier-speculative search makes the cached search's
    decisions where the numerics allow it: phase 7's cell (B=8, W=16, T=64,
    the 128-token prompt, max_len 160, top-8) over llama3-8b at full width,
    2 layers, float32 (no TF32), with the cached, paged, frontier and paged
    frontier evaluators; each at least 7 of 8 actions equal to the cached
    search's."""
    from repro_torch.core import (
        CachedModelEvaluator,
        FrontierModelEvaluator,
        PagedCachedModelEvaluator,
        PagedFrontierModelEvaluator,
        build_searcher,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cfg, params = lm_setup(torch, device, 2, torch.float32, seed=1)
    env, spec, roots, rngs = guided_cell(torch, device, cfg, params)
    kw = dict(top_k=TOP_K, eos_token=EOS)
    paged = dict(block_size=BLOCK, num_blocks=POOL_BLOCKS)
    evaluators = {
        "cached": CachedModelEvaluator(cfg, params, **kw),
        "paged": PagedCachedModelEvaluator(cfg, params, **kw, **paged),
        "frontier": FrontierModelEvaluator(cfg, params, **kw),
        "paged frontier": PagedFrontierModelEvaluator(cfg, params, **kw, **paged),
    }
    base = None
    for what, ev in evaluators.items():
        res = build_searcher(env, spec, evaluator=ev, device=device)(roots, rngs)
        search_results_ok(torch, res, spec, f"float32 {what} search")
        if base is None:
            base = {"action": res.action.cpu(), "root_n": res.root_n.cpu()}
            continue
        same = agree_actions(torch, res, base, f"float32 {what} search", "cached")
        print(f"full width, 2 layers, float32, phase 7's cell: {what} search chooses the "
              f"cached search's action on {same}/8 trees; root_n equal on "
              f"{int((res.root_n.cpu() == base['root_n']).all(1).sum())}/8")
    del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The paper's baselines, trace mode and host-paced serving (phases 15-17)
# ---------------------------------------------------------------------------

BASELINE_ROOTS = 4            # phase 15's single tap-game roots per baseline
# Phases 15-19 were cut (from 16 tap and 64, then 32 bandit roots, a
# traced forest of 256 and 24 requests) to keep the whole run within 900 s
# on a slow host with phase 24 added; phase 15's tap roots again from 8 to
# 4 with phase 25(g) added (a whole run took 1122.1 s on a slow host).
BASELINE_BANDIT_ROOTS = 16    # phase 15's single bandit roots per baseline
MDP_B = 256                   # phase 15's random-MDP batch (launcher's --env mdp)
SERVE_R, SERVE_BURST = 16, 8  # phases 17-19: requests, arriving in bursts of 8
PARITY_R = 16                 # phase 17.2: two bursts; the second is compared


def search_each(torch, device, search, roots, keys, n, per_search):
    """``n`` single-root searches; each must launch exactly ``per_search``
    walks and no per-level ``tree_select``.  Returns (results, wall,
    syncs)."""
    from repro_torch.envs.base import map_state
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.sync import SYNCS, reset_syncs

    sync(device)
    reset_syncs()
    out = []
    t0 = time.perf_counter()
    for i in range(n):
        reset_launches()
        out.append(search(map_state(lambda x: x[i], roots), keys[i]))
        got = (LAUNCHES["tree_descend"], LAUNCHES["tree_select"])
        if got != (per_search, 0):
            raise AssertionError(f"search {i} launched tree_descend {got[0]} times and "
                                 f"tree_select {got[1]}, expected {per_search} and 0")
    sync(device)
    return out, time.perf_counter() - t0, SYNCS["host_any"]


def single_results_ok(torch, results, spec, actions, what):
    for i, res in enumerate(results):
        tried = res.root_n > 0
        ok = (bool(torch.isfinite(res.root_n).all()) and bool(torch.isfinite(res.root_v[tried]).all())
              and 0 <= int(res.action) < actions and 0 < float(res.root_n.sum()) <= spec.num_simulations
              and not bool(res.overflowed))
        if not ok:
            raise AssertionError(f"{what} root {i}: action {int(res.action)}, root_n "
                                 f"{res.root_n.tolist()}, root_v {res.root_v.tolist()}")


def baselines(torch, device, bandit_shares):
    """Phase 15: LeafP and RootP (K = W = 16) on phase 4's tap game and
    phase 5's bandit tree, one root per search; wu_uct on the random MDP
    at B = 256."""
    from repro_torch import rng
    from repro_torch.core import SearchSpec, build_searcher
    from repro_torch.envs import make_bandit_tree, make_random_mdp, make_tap_game, solve_bandit_tree
    from repro_torch.envs.base import map_state
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.sync import SYNCS, reset_syncs

    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    env = make_tap_game(6, 4, goal_count=10, step_budget=20)
    roots = env.init(rng.split(rng.PRNGKey(20, device=device), BASELINE_ROOTS))
    keys = rng.split(rng.PRNGKey(21, device=device), BASELINE_ROOTS)
    launches = {}
    for algo in ("leafp", "rootp"):
        spec = SearchSpec(algo=algo, **MAIN_SPEC)
        # LeafP walks once a round (T / W rounds), RootP once a wave of its
        # K = W trees (T / K waves).
        per = spec.num_simulations // spec.wave_size
        res, wall, syncs = search_each(torch, device, build_searcher(env, spec, device=device),
                                       roots, keys, BASELINE_ROOTS, per)
        single_results_ok(torch, res, spec, MAIN_A, f"{algo} tap")
        cpu = build_searcher(env, spec, device="cpu")
        same = 0
        for i in range(BASELINE_ROOTS):
            c = cpu(map_state(lambda x: x[i].cpu(), roots), keys[i].cpu())
            if int(c.action) == int(res[i].action):
                same += 1
            else:
                print(f"{algo} tap root {i}: GPU action {int(res[i].action)}, CPU action "
                      f"{int(c.action)} (root_n GPU {res[i].root_n.tolist()} CPU "
                      f"{c.root_n.tolist()})")
        # One root may flip on a float near-tie, as with 8 roots before.
        if same < BASELINE_ROOTS - 1:
            raise AssertionError(f"{algo}: GPU and CPU actions agree on {same} of "
                                 f"{BASELINE_ROOTS} roots")
        launches[algo] = per
        print(f"{algo} tap 6x6 T={spec.num_simulations} W=K={spec.wave_size} width 5 on {name}: "
              f"{BASELINE_ROOTS} single-root searches, {BASELINE_ROOTS / wall!r} searches/s "
              f"(wall {wall!r} s), tree_descend launches {per} per search, tree_select 0, "
              f"host syncs {syncs / BASELINE_ROOTS!r} per search; CPU re-search agrees on "
              f"{same}/{BASELINE_ROOTS} roots")

    depth, actions = 6, 4
    env = make_bandit_tree(depth=depth, num_actions=actions)
    _, best, _ = solve_bandit_tree(depth, actions, seed=0)
    roots = env.init(rng.split(rng.PRNGKey(0, device=device), BASELINE_BANDIT_ROOTS))
    keys = rng.split(rng.PRNGKey(1, device=device), BASELINE_BANDIT_ROOTS)
    shares = dict(bandit_shares)
    for algo in ("leafp", "rootp"):
        spec = SearchSpec(algo=algo, **BANDIT_SPEC)
        res, wall, _ = search_each(torch, device, build_searcher(env, spec, device=device),
                                   roots, keys, BASELINE_BANDIT_ROOTS,
                                   spec.num_simulations // spec.wave_size)
        single_results_ok(torch, res, spec, actions, f"{algo} bandit")
        shares[algo] = sum(int(r.action) == best for r in res) / BASELINE_BANDIT_ROOTS
        print(f"bandit d={depth} A={actions} {algo}: {BASELINE_BANDIT_ROOTS} single roots, "
              f"optimal-action share {shares[algo]!r} ({BASELINE_BANDIT_ROOTS / wall!r} "
              f"searches/s)")
    print(f"bandit optimal-action shares (phase 5: B={BANDIT_B} batched; phase 15: "
          f"{BASELINE_BANDIT_ROOTS} single roots): {shares}")
    if not shares["rootp"] > 1.0 / actions:
        raise AssertionError(f"rootp optimal share {shares['rootp']} is not above chance")

    env = make_random_mdp(num_states=32, num_actions=4, horizon=16)
    spec = SearchSpec(algo="wu_uct", batch=MDP_B, num_simulations=128, wave_size=16,
                      max_depth=10, max_width=4, max_sim_steps=20, gamma=0.99)
    roots = env.init(rng.split(rng.PRNGKey(0, device=device), MDP_B))
    rngs = rng.split(rng.PRNGKey(1, device=device), MDP_B)
    search = build_searcher(env, spec, device=device)
    sync(device)
    reset_launches()
    reset_syncs()
    t0 = time.perf_counter()
    res = search(roots, rngs)
    sync(device)
    wall = time.perf_counter() - t0
    walks, syncs = LAUNCHES["tree_descend"], SYNCS["host_any"]
    if (walks, LAUNCHES["tree_select"]) != (spec.num_simulations, 0):
        raise AssertionError(f"mdp: tree_descend {walks}, tree_select "
                             f"{LAUNCHES['tree_select']}")
    tried = res.root_n > 0
    if not (bool(torch.isfinite(res.root_v[tried]).all()) and bool((res.action >= 0).all())
            and bool((res.action < 4).all()) and not bool(res.overflowed.any())):
        raise AssertionError("mdp: non-finite or out-of-range search results")
    cpu = build_searcher(env, spec._replace(batch=8), device="cpu")(
        map_state(lambda x: x[:8].cpu(), roots), rngs[:8].cpu())
    same = res.action[:8].cpu() == cpu.action
    if int(same.sum()) < 7:
        raise AssertionError(f"mdp: GPU and CPU actions agree on {int(same.sum())} of 8")
    print(f"random MDP (32 states, 4 actions, horizon 16) wu_uct B={MDP_B} T=128 W=16 on "
          f"{name}: {MDP_B / wall!r} searches/s (wall {wall!r} s, first call), tree_descend "
          f"launches {walks}, host syncs {syncs}; CPU re-search "
          f"agrees on {int(same.sum())}/8 trees, root_n equal on "
          f"{int((res.root_n[:8].cpu() == cpu.root_n).all(1).sum())}/8")
    return launches


def check_o_conservation(trace, T):
    """The reference's O-conservation check on a ``[K, B, ...]`` trace,
    on the host: at every tick, each node's ``O`` equals the busy slots
    whose charged node's root path passes through it, and ``O`` is zero at
    the end.  Returns the busy slot-ticks walked."""
    O, parent = trace.O.cpu().numpy(), trace.parent.cpu().numpy()
    kind, sim_node = trace.kind.cpu().numpy(), trace.sim_node.cpu().numpy()
    if not (trace.t_done[-1] == T).all():
        raise AssertionError("trace bound too small: not every tree settled")
    counts = np.zeros(O.shape, np.float32)
    kk, bb, ww = np.nonzero(kind != 0)             # FREE == 0
    walked = kk.size
    n = sim_node[kk, bb, ww]
    while n.size:
        np.add.at(counts, (kk, bb, n), 1.0)
        n = parent[kk, bb, n]
        live = n >= 0
        kk, bb, n = kk[live], bb[live], n[live]
    bad = np.argwhere((O != counts).any(-1))
    if bad.size:
        k, b = bad[0]
        raise AssertionError(f"O != busy-slot subtree count at tick {k}, tree {b} "
                             f"({len(bad)} (tick, tree) pairs)")
    if (O[-1] != 0).any():
        raise AssertionError("O mass left at termination")
    return walked


def trace_phase(torch, device):
    """Phase 16: trace mode on the card.  Phase 5's bandit tree on the async
    engine (B = 256, W = 16) for T + 2 ticks, with O conservation checked
    on the host; then the reduced llama (2 layers,
    float32) with the cached and the paged evaluator, cache depth against
    each busy slot's prefix and the pool's working set."""
    import dataclasses

    from repro_torch import rng
    from repro_torch.configs import get_reduced
    from repro_torch.core import CachedModelEvaluator, PagedCachedModelEvaluator, SearchSpec
    from repro_torch.core.batched_async_search import run_async_search_batched
    from repro_torch.envs import make_bandit_tree, make_token_env
    from repro_torch.models import init_params

    env = make_bandit_tree(depth=6, num_actions=4)
    spec = SearchSpec(algo="wu_uct", engine="async", batch=TRACE_B, **BANDIT_SPEC)
    cfg = spec.config
    # T + 2 ticks, cut for time from the reference's worst-case bound
    # T * (max_sim_steps + 2) + 2 = 1026: the slowest tree settles in about
    # 33, and each frozen tick after that costs 60-80 ms on the host.
    ticks = cfg.num_simulations + 2
    roots = env.init(rng.split(rng.PRNGKey(0, device=device), TRACE_B))
    rngs = rng.split(rng.PRNGKey(1, device=device), TRACE_B)
    sync(device)
    t0 = time.perf_counter()
    res, trace = run_async_search_batched(env, cfg, roots, rngs, trace_ticks=ticks)
    sync(device)
    wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    walked = check_o_conservation(trace, cfg.num_simulations)
    alive = trace.alive.cpu().numpy()
    print(f"trace: bandit d=6 A=4 async wu_uct B={TRACE_B} W={cfg.wave_size} "
          f"T={cfg.num_simulations}, {ticks} ticks traced "
          f"in {wall!r} s ({int(alive.any(1).sum())} with a live tree; {int(res.ticks.max())} "
          f"ticks for the slowest tree); O conservation held on all {ticks} x {TRACE_B} "
          f"(tick, tree) pairs ({walked} busy slot-ticks walked, {time.perf_counter() - t1!r} "
          f"s on the host); O == 0 at the end; max busy slots {int(trace.busy_slots.max())}")

    lm = dataclasses.replace(get_reduced("llama3-8b", vocab_size=64, num_layers=2),
                             dtype=torch.float32)
    params = init_params(lm, torch.Generator(device=device).manual_seed(4))
    env = make_token_env(lm, params, prompt_tokens(torch, 64, 8, seed=6).to(device),
                         max_len=REDUCED_MAX_LEN, top_k=TOP_K, eos_token=EOS)
    spec = reduced_spec()
    cfg = spec.config
    ticks = cfg.num_simulations * (cfg.max_sim_steps + 2) + 2
    roots = env.init(rng.split(rng.PRNGKey(7, device=device), spec.batch))
    rngs = rng.split(rng.PRNGKey(8, device=device), spec.batch)
    blocks = spec.batch * spec.wave_size * -(-REDUCED_MAX_LEN // REDUCED_BLOCK)
    kw = dict(top_k=TOP_K, eos_token=EOS)
    for what, ev in (("cached", CachedModelEvaluator(lm, params, **kw)),
                     ("paged", PagedCachedModelEvaluator(lm, params, block_size=REDUCED_BLOCK,
                                                         num_blocks=blocks, **kw))):
        t0 = time.perf_counter()
        _, tr = run_async_search_batched(env, cfg, roots, rngs, trace_ticks=ticks, evaluator=ev)
        sync(device)
        wall = time.perf_counter() - t0
        alive = tr.alive.cpu().numpy()
        if not alive.any() or alive[-1].any():
            raise AssertionError(f"{what} trace: alive {alive.any()} at all, {alive[-1].any()} "
                                 "at the end")
        busy = (tr.kind.cpu().numpy() != 0) & alive[..., None]
        cache_len, state_len = tr.cache_len.cpu().numpy(), tr.state_len.cpu().numpy()
        if not busy.any() or not np.array_equal(cache_len[busy], state_len[busy]):
            raise AssertionError(f"{what} trace: cache_len differs from state_len on "
                                 f"{int((cache_len[busy] != state_len[busy]).sum())} busy "
                                 "slot-ticks")
        line = (f"trace: reduced llama3-8b (2 layers, float32) {what} async search B=8 W=4 "
                f"T=32, {ticks} ticks in {wall!r} s: cache_len == state_len on all "
                f"{int(busy.sum())} busy slot-ticks of live trees")
        if what == "paged":
            used = tr.blocks_in_use.cpu().numpy()
            if not 0 < used.max() <= blocks:
                raise AssertionError(f"paged trace: blocks in use up to {used.max()} of {blocks}")
            line += f"; blocks in use at most {int(used.max())} of {blocks}"
        print(line)
    del params


def dtype_name(cfg):
    return str(cfg.dtype).replace("torch.", "")


def serve_prompts(torch, vocab, n):
    """``n`` ragged prompts (64 to 128 tokens) from a seed."""
    lengths = np.random.default_rng(9).integers(64, PROMPT_LEN + 1, size=n)
    return [prompt_tokens(torch, vocab, int(m), seed=100 + i).tolist()
            for i, m in enumerate(lengths)]


def serve_stream(torch, device, svc, prompts, keys):
    """Submit ``prompts`` in bursts of ``SERVE_BURST`` (one poll round after
    each) and poll until every request has finished.  Returns (results,
    latencies in s, wall, launches, model calls, host syncs, stats delta)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import CALLS, reset_calls
    from repro_torch.sync import SYNCS, reset_syncs

    svc.poll()            # builds the engine (placeholder rows, evicted)
    before = dataclasses_dict(svc.stats)
    sync(device)
    reset_launches()
    reset_calls()
    reset_syncs()
    submitted, finished = {}, {}
    t0 = time.perf_counter()

    def stamp(fresh):
        now = time.perf_counter()
        for rid in fresh:
            finished[rid] = now

    for start in range(0, len(prompts), SERVE_BURST):
        for i in range(start, min(start + SERVE_BURST, len(prompts))):
            submitted[svc.submit(prompts[i], key=keys[i])] = time.perf_counter()
        stamp(svc.poll())
    while svc.stats.completed < svc.stats.submitted:
        stamp(svc.poll())
    sync(device)
    wall = time.perf_counter() - t0
    stats = {k: v - before[k] for k, v in dataclasses_dict(svc.stats).items()}
    stats["slot_idle_frac"] = 1.0 - stats["busy_tree_ticks"] / max(1, stats["ticks"] * svc.spec.batch)
    lat = np.asarray([finished[r] - submitted[r] for r in sorted(submitted)])
    return (svc.results, lat, wall, dict(LAUNCHES), dict(CALLS), SYNCS["host_any"], stats)


def dataclasses_dict(stats):
    import dataclasses

    return {k: v for k, v in dataclasses.asdict(stats).items() if k != "batch"}


def fresh_batch(torch, device, svc, prompts, keys):
    """The one-shot search of ``prompts`` (one per row) with ``keys``,
    through the service's own searcher: what a fresh batch gives them."""
    from repro_torch.envs import TokenEnvState

    tokens = torch.zeros((len(prompts), svc.max_len), dtype=torch.int32)
    for i, p in enumerate(prompts):
        tokens[i, : len(p)] = torch.tensor(p, dtype=torch.int32)
    roots = TokenEnvState(tokens.to(device), torch.tensor([len(p) for p in prompts],
                                                          dtype=torch.int32, device=device),
                          torch.zeros((len(prompts),), dtype=torch.bool, device=device))
    return svc._search(roots, keys)


def admission_parity(torch, device, svc, results, prompts, keys, lo):
    """How many of requests ``lo .. lo + B - 1`` (admitted mid-run into
    recycled rows) chose what a fresh one-shot batch of them chooses."""
    b = svc.spec.batch
    fresh = fresh_batch(torch, device, svc, prompts[lo:lo + b], keys[lo:lo + b])
    return sum(int(results[lo + i].action) == int(fresh.action[i]) for i in range(b))


def serving_path(torch, device, cfg, params, fused=False, host_paced=None):
    """Phase 17 (``fused=False``) and phase 18 (the fused request ring):
    SearchService over llama3-8b (phase 7's cell: B = 8 rows, W = 16,
    T = 64, top-8), dense and then paged (phase 10's pool); 16 ragged
    prompts in two bursts of 8.  Phase 18 also holds the ring empty after
    each drain and prints its actions' agreement with phase 17's
    (``host_paced``, what this returns for phase 17).  Returns (launches,
    actions by request per mode)."""
    from repro_torch import rng
    from repro_torch.serving import SearchService

    _, spec, _, _ = guided_cell(torch, device, cfg, params)
    prompts = serve_prompts(torch, cfg.vocab_size, SERVE_R)
    keys = rng.split(rng.PRNGKey(12, device=device), SERVE_R)
    launches, actions = {}, {}
    pacing = "fused ring" if fused else "host-paced"
    for paged in (False, True):
        what = "paged" if paged else "dense"
        svc = SearchService(cfg, params, spec, top_k=TOP_K, max_len=MAX_LEN, eos_token=EOS,
                            paged=paged, block_size=BLOCK,
                            num_blocks=POOL_BLOCKS if paged else None, fused=fused,
                            device=device)
        results, lat, wall, got, calls, syncs, stats = serve_stream(
            torch, device, svc, prompts, keys)
        if stats["completed"] != stats["submitted"] or len(results) != SERVE_R:
            raise AssertionError(f"serving {what}: {stats}")
        bad = [r for r, res in results.items() if not 0 <= int(res.action) < TOP_K]
        if bad:
            raise AssertionError(f"serving {what}: requests {bad} have no valid action")
        kernel = "paged_decode_attention" if paged else "decode_attention"
        launch_identity(got, calls, kernel, "paged_decode_step" if paged else "decode_step",
                        cfg.num_layers)
        launches[kernel] = got[kernel]
        actions[what] = {r: int(res.action) for r, res in results.items()}
        line = (f"serving {what}: llama3-8b {cfg.num_layers} layers {dtype_name(cfg)}, SearchService "
                f"({pacing}) B={spec.batch} W={spec.wave_size} T={spec.num_simulations} "
                f"top-{TOP_K}, {SERVE_R} ragged prompts ({min(map(len, prompts))}-"
                f"{max(map(len, prompts))} tokens) in bursts of {SERVE_BURST}: "
                f"{SERVE_R / wall!r} requests/s (wall {wall!r} s), latency p50 "
                f"{float(np.percentile(lat, 50))!r} s p90 {float(np.percentile(lat, 90))!r} s, "
                f"host rounds {stats['host_rounds']}, master ticks {stats['ticks']}, "
                f"slot_idle_frac {stats['slot_idle_frac']!r}, host syncs {syncs}, model calls "
                f"{ {k: v for k, v in calls.items() if v} }, {kernel} launches {got[kernel]}")
        if fused:
            ring = svc._ring
            line += (f", ring_occupancy {stats['ring_occupancy_sum'] / stats['host_rounds']!r}, "
                     f"ring capacity {svc.ring_capacity}, ticks per segment "
                     f"{svc.ticks_per_segment}")
            sentinel = (not paged or bool((ring.aux["table"] == svc.evaluator.num_blocks).all())
                        and bool((ring.aux["len"] == 0).all()))
            if int(ring.count) != 0 or not sentinel:
                raise AssertionError(f"serving {what} (fused ring): ring count "
                                     f"{int(ring.count)}, tables at the sentinel: {sentinel}")
        if paged:
            aux = svc._carry[7]
            held = int((aux["refcount"] != 0).sum())
            free = svc.evaluator.num_blocks - int((aux["refcount"] > 0).sum())
            if held or int(aux["oom"]) or free != svc.evaluator.num_blocks:
                raise AssertionError(f"serving paged: {held} pages still held, oom "
                                     f"{int(aux['oom'])}, {free} free of {POOL_BLOCKS}")
            line += f"; after the drain {free} of {POOL_BLOCKS} blocks free, 0 leaked"
        print(line)
        if fused:
            same = sum(actions[what][r] == host_paced[what][r] for r in host_paced[what])
            print(f"serving {what}, {dtype_name(cfg)} {cfg.num_layers} layers: the fused ring "
                  f"chooses phase 17's host-paced action on {same}/{SERVE_R} requests (printed, "
                  "not held: phase 18.2 holds them equal in float32)")
            del svc
            torch.cuda.empty_cache()
            continue
        same = admission_parity(torch, device, svc, results, prompts, keys, SERVE_BURST)
        if not paged:
            # One burst again, warm, under the profiler: the card's busy share.
            profile_call(torch, device, lambda: serve_stream(
                torch, device, svc, prompts[:SERVE_BURST], keys[:SERVE_BURST]),
                f"serving {what}, one burst of {SERVE_BURST} requests")
        print(f"serving {what}, {dtype_name(cfg)} {cfg.num_layers} layers: requests admitted "
              f"mid-run choose a fresh one-shot batch's action on {same}/8 (printed, not held: "
              "a bf16 prefill over R rows and one over B·W rows round differently, ROADMAP.md "
              "§3)")
        del svc
        torch.cuda.empty_cache()
    return launches, actions


def serving_parity_f32(torch, device):
    """Phases 17.2 and 18.2, at full width, 2 layers, float32 (no TF32),
    16 requests in two bursts, host-paced and then fused in each of the
    four evaluator modes.  17.2 (dense and paged host-paced): requests
    admitted mid-run into recycled rows choose a fresh one-shot batch's
    action on at least 7 of 8.  18.2: the fused ring serves every request
    as host-paced serving does: action, root visit counts and ticks equal,
    root values within 1e-6 (tests/test_serving_continuous.py's bar)."""
    from repro_torch import rng
    from repro_torch.core import FrontierModelEvaluator, PagedFrontierModelEvaluator
    from repro_torch.serving import SearchService

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cfg, params = lm_setup(torch, device, 2, torch.float32, seed=1)
    _, spec, _, _ = guided_cell(torch, device, cfg, params)
    prompts = serve_prompts(torch, cfg.vocab_size, PARITY_R)
    keys = rng.split(rng.PRNGKey(12, device=device), PARITY_R)
    evaluators = {
        "dense": lambda: None, "paged": lambda: None,
        "frontier": lambda: FrontierModelEvaluator(cfg, params, top_k=TOP_K, eos_token=EOS),
        "paged frontier": lambda: PagedFrontierModelEvaluator(
            cfg, params, top_k=TOP_K, eos_token=EOS, block_size=BLOCK,
            num_blocks=POOL_BLOCKS)}
    for mode, make in evaluators.items():
        rows = {}
        for fused in (False, True):
            svc = SearchService(cfg, params, spec, top_k=TOP_K, max_len=MAX_LEN,
                                eos_token=EOS, paged="paged" in mode, block_size=BLOCK,
                                num_blocks=POOL_BLOCKS if "paged" in mode else None,
                                evaluator=make(), fused=fused, device=device)
            results, _, wall, _, _, syncs, stats = serve_stream(torch, device, svc, prompts,
                                                                keys)
            rows[fused] = (results, wall, syncs, stats)
            if not fused and mode in ("dense", "paged"):
                same = admission_parity(torch, device, svc, results, prompts, keys,
                                        SERVE_BURST)
                if same < 7:
                    raise AssertionError(f"{mode}: mid-run admissions agree with a fresh "
                                         f"batch on {same} of 8")
                print(f"(17.2) full width, 2 layers, float32, serving {mode}: {PARITY_R} "
                      f"requests in {wall!r} s; requests admitted mid-run choose a fresh "
                      f"one-shot batch's action on {same}/8")
            del svc
        (host, h_wall, h_syncs, h_stats), (ring, f_wall, f_syncs, f_stats) = rows[False], rows[True]
        v_diff = 0.0
        for r in range(PARITY_R):
            a, b = ring[r], host[r]
            v_diff = max(v_diff, float((a.root_v - b.root_v).abs().max()))
            if (int(a.action) != int(b.action) or not torch.equal(a.root_n, b.root_n)
                    or int(a.ticks) != int(b.ticks)):
                raise AssertionError(f"{mode}: request {r} fused (action {int(a.action)}, "
                                     f"root_n {a.root_n.tolist()}, ticks {int(a.ticks)}) "
                                     f"differs from host-paced ({int(b.action)}, "
                                     f"{b.root_n.tolist()}, {int(b.ticks)})")
        if v_diff > 1e-6:
            raise AssertionError(f"{mode}: root values differ by up to {v_diff!r} (bar 1e-6)")
        print(f"(18.2) full width, 2 layers, float32, {mode}: the fused ring equals host-paced "
              f"serving on {PARITY_R}/{PARITY_R} requests (action, root_n, ticks; max "
              f"|root_v diff| {v_diff!r}); host-paced {h_wall!r} s, {h_stats['host_rounds']} "
              f"host rounds, {h_syncs} host syncs; fused {f_wall!r} s, {f_stats['host_rounds']} "
              f"host rounds, {f_syncs} host syncs")
    del params
    torch.cuda.empty_cache()


# Phases 19 and 20: ServingEngine's cells.
ENGINE_SLOTS, ENGINE_NEW = 8, 32     # phase 19: 8 slots, 32 new tokens at most
RECURRENT_R, RECURRENT_NEW = 8, 16   # phase 20: 8 prompts, 16 new tokens


def engine_run(torch, device, cfg, params, prompts, paged, new_tokens):
    """One ``ServingEngine.run`` (greedy, EOS 1, ``max_len`` 160) counted:
    (outputs, wall, launches, calls, syncs, peak GiB, engine)."""
    from repro_torch.serving import ServeConfig, ServingEngine

    engine = ServingEngine(cfg, params, ServeConfig(
        batch_slots=ENGINE_SLOTS, max_len=MAX_LEN, eos_token=EOS, paged=paged,
        block_size=BLOCK, max_new_tokens=new_tokens), device=device)
    out, wall, launches, calls, syncs, peak = counted_run(
        torch, device, lambda: engine.run(prompts, max_ticks=10 ** 6))
    if len(out) != len(prompts) or engine.active.any() or not all(
            0 < len(o) <= new_tokens for o in out):
        raise AssertionError(f"ServingEngine: {len(out)} outputs of lengths "
                             f"{[len(o) for o in out]} for {len(prompts)} requests")
    return out, wall, launches, calls, syncs, peak, engine


def lm_serving(torch, device, cfg, params):
    """Phase 19: ServingEngine over phase 7's llama3-8b, 8
    slots, 16 ragged prompts of 64-128 tokens, 32 new tokens at most,
    greedy: dense, then paged (16-token blocks, the dense equivalent)."""
    launches = {}
    for paged in (False, True):
        launches.update(family_engine(torch, device, cfg, params, paged, SERVE_R, ENGINE_NEW))
    return launches


def greedy_by_forward(torch, device, cfg, params, prompts, new_tokens):
    """What ServingEngine's greedy rules give each prompt, computed by the
    cache-free ``forward`` (``flash_attention``) over the whole sequence at
    every step; all prompts at once, right-padded."""
    from repro_torch.models import logits_at

    outs = [[] for _ in prompts]
    live = list(range(len(prompts)))
    while live:
        seqs = [prompts[i] + outs[i] for i in live]
        width = max(map(len, seqs))
        tokens = torch.zeros((len(live), width), dtype=torch.int32)
        for k, seq in enumerate(seqs):
            tokens[k, :len(seq)] = torch.tensor(seq, dtype=torch.int32)
        pos = torch.tensor([len(seq) - 1 for seq in seqs], device=device)
        nxt = torch.argmax(logits_at(params, cfg, tokens.to(device), pos), dim=-1).tolist()
        for i, t in zip(list(live), nxt):
            outs[i].append(int(t))
            if len(outs[i]) > 1 and (t == EOS or len(prompts[i]) + len(outs[i]) - 1
                                     >= MAX_LEN - 1 or len(outs[i]) >= new_tokens):
                live.remove(i)
    return outs


def lm_serving_parity_f32(torch, device):
    """Phase 19.2: at full width, 2 layers, float32 (no TF32), each
    request's tokens through ServingEngine equal greedy decoding through the
    cache-free forward on all requests but one, dense and paged."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cfg, params = lm_setup(torch, device, 2, torch.float32, seed=1)
    prompts = serve_prompts(torch, cfg.vocab_size, SERVE_R)
    want = greedy_by_forward(torch, device, cfg, params, prompts, ENGINE_NEW)
    for paged in (False, True):
        out, wall, *_ = engine_run(torch, device, cfg, params, prompts, paged, ENGINE_NEW)
        same = sum(a == b for a, b in zip(out, want))
        what = "paged" if paged else "dense"
        if same < SERVE_R - 1:
            raise AssertionError(f"ServingEngine {what}: {same} of {SERVE_R} requests equal "
                                 "greedy decoding through forward")
        print(f"full width, 2 layers, float32, ServingEngine {what}: {same}/{SERVE_R} "
              f"requests equal greedy decoding through the cache-free forward "
              f"({sum(map(len, out))} tokens, {wall!r} s)")
    del params
    torch.cuda.empty_cache()


def recurrent_serving(torch, device, cfg, params):
    """Phase 20: ServingEngine over mamba2-2.7b or zamba2-7b at full width
    and depth (bf16), 8 slots, 8 prompts of 64-128 tokens, 16 new tokens:
    each prompt prefilled once (one ssd_scan with its final state per
    layer), the decode steps on the recurrent cache (no ssd_scan; zamba2's
    shared block through decode_attention at its 14 sites)."""
    from repro_torch.models.lm import _num_attn_sites

    prompts = serve_prompts(torch, cfg.vocab_size, RECURRENT_R)
    out, wall, got, calls, syncs, peak, engine = engine_run(
        torch, device, cfg, params, prompts, False, RECURRENT_NEW)
    if calls["prefill"] != RECURRENT_R or got["ssd_scan"] != cfg.num_layers * RECURRENT_R:
        raise AssertionError(f"ssd_scan launched {got['ssd_scan']} times for "
                             f"{calls['prefill']} prefills of {cfg.num_layers} layers "
                             f"({RECURRENT_R} prompts)")
    sites = _num_attn_sites(cfg)
    if sites:
        launch_identity(got, calls, "decode_attention", "decode_step", sites)
    slot_bytes = sum(x.numel() * x.element_size() for part in ("ssm", "kv")
                     for x in engine.cache.get(part, {}).values()) / ENGINE_SLOTS
    tokens = sum(len(o) for o in out)
    print(f"ServingEngine {cfg.name}: {cfg.num_layers} layers {dtype_name(cfg)}, "
          f"{ENGINE_SLOTS} slots, {RECURRENT_R} prompts ({min(map(len, prompts))}-"
          f"{max(map(len, prompts))} tokens), {RECURRENT_NEW} new tokens: {tokens} tokens in "
          f"{wall!r} s = {tokens / wall!r} tokens/s; cache {slot_bytes / 2 ** 20!r} MiB per "
          f"slot (conv windows and states{' and the shared block KV' if sites else ''}), "
          f"peak memory {peak!r} GiB; model calls {({k: v for k, v in calls.items() if v})}, "
          f"launches {({k: v for k, v in got.items() if v})}, host syncs {syncs}")
    del engine
    torch.cuda.empty_cache()
    return got


def agreement_recurrent_cache(torch, device):
    """Phase 20.2: mamba2-2.7b and zamba2-7b at full width, 2 layers,
    float32 (no TF32): ``prefill`` (through ssd_scan with its final state)
    and 3 ``decode_step`` calls against the cache-free forward's logits,
    prompts of 128 tokens (one chunk) and 300 (padded to two chunks)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import decode_step, forward, init_cache, prefill

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    for name in ("mamba2-2.7b", "zamba2-7b"):
        cfg, params = lm_setup(torch, device, 2, torch.float32, seed=5, name=name)
        gen = torch.Generator(device=device).manual_seed(9)
        for s in (128, 300):
            toks = torch.randint(2, cfg.vocab_size, (2, s + 3), generator=gen, device=device,
                                 dtype=torch.int32)
            full, _ = forward(params, cfg, {"tokens": toks})
            reset_launches()
            logits, cache = prefill(params, cfg, {"tokens": toks[:, :s]},
                                    init_cache(cfg, 2, s + 8, device=device))
            if LAUNCHES["ssd_scan"] != cfg.num_layers:
                raise AssertionError(f"{name}: prefill launched ssd_scan "
                                     f"{LAUNCHES['ssd_scan']} times for {cfg.num_layers} layers")
            diffs = [float((logits - full[:, s - 1]).abs().max())]
            torch.testing.assert_close(logits, full[:, s - 1], **LOGIT_TOL)
            for t in range(s, s + 3):
                logits, cache = decode_step(params, cfg, toks[:, t], cache)
                torch.testing.assert_close(logits, full[:, t], **LOGIT_TOL)
                diffs.append(float((logits - full[:, t]).abs().max()))
            if LAUNCHES["ssd_scan"] != cfg.num_layers:
                raise AssertionError(f"{name}: a decode step launched ssd_scan")
            print(f"{name} full width, 2 layers, float32, 2 x {s} prompt tokens: max |prefill "
                  f"and decode step logits - forward's| = {diffs!r} (logits up to "
                  f"{float(full.abs().max())!r}; tolerance {LOGIT_TOL})")
        del params, full, cache
        torch.cuda.empty_cache()


# Phases 21-23: the other model families, one model on the card at a time.
# phi3-medium-14b and qwen2.5-32b at full depth; deepseek-67b at 40 of its
# 95 layers (58.7 of 134.8 GB in bf16); qwen3-moe-235b-a22b at 8 of 94
# layers (41.7 of 463.5 GB).  Cut deepseek first, then qwen3-moe, if the
# run runs long.
DENSE_FAMILY = (("phi3-medium-14b", 40), ("qwen2.5-32b", 64), ("deepseek-67b", 40))
MOE_SMALL, MOE_LARGE, MOE_LARGE_LAYERS = "qwen2-moe-a2.7b", "qwen3-moe-235b-a22b", 8
# (Hq, Hkv, D) of the new paths: phi3, qwen2.5-32b (G = 5), deepseek (G = 8),
# qwen2-moe (MHA), qwen3-moe (G = 16 at D = 64), whisper (MHA at D = 64).
NEW_LAYOUTS = [(40, 10, 128), (40, 8, 128), (64, 8, 128), (16, 16, 128), (64, 4, 64),
               (12, 12, 64)]
STUB_ROWS, STUB_PROMPT, STUB_STEPS = 8, 128, 16    # phase 23: llava's rows and prompt
WHISPER_PROMPT = 64
PARITY_PROMPT = 128           # phases 21.2-23.2: prompt tokens before 3 decode steps


def family_engine(torch, device, cfg, params, paged=False, n_prompts=RECURRENT_R,
                  new_tokens=RECURRENT_NEW):
    """Phases 19, 21 and 22(b): ServingEngine over ``cfg`` (bf16), 8 slots,
    ``n_prompts`` ragged prompts (phase 20's 8 by default), ``new_tokens``
    at most, greedy: every request finishes, the decode kernel launches
    once per layer and decode step, and a paged run leaves no block in
    use.  Returns the kernel's launches."""
    prompts = serve_prompts(torch, cfg.vocab_size, n_prompts)
    out, wall, got, calls, syncs, peak, engine = engine_run(
        torch, device, cfg, params, prompts, paged, new_tokens)
    kernel, call = (("paged_decode_attention", "paged_decode_step") if paged
                    else ("decode_attention", "decode_step"))
    launch_identity(got, calls, kernel, call, cfg.num_layers)
    tokens = sum(len(o) for o in out)
    line = (f"ServingEngine {'paged' if paged else 'dense'}: {cfg.name} {cfg.num_layers} "
            f"layers {dtype_name(cfg)}, {ENGINE_SLOTS} slots, {n_prompts} prompts "
            f"({min(map(len, prompts))}-{max(map(len, prompts))} tokens), up to "
            f"{new_tokens} new tokens: {tokens} tokens in {wall!r} s = {tokens / wall!r} "
            f"tokens/s, {n_prompts / wall!r} requests/s; model calls {({k: v for k, v in calls.items() if v})}, {kernel} "
            f"launches {got[kernel]} ({cfg.num_layers} x {calls[call]} steps), host syncs "
            f"{syncs}, peak memory {peak!r} GiB")
    if paged:
        used = engine.blocks_in_use()
        if used:
            raise AssertionError(f"ServingEngine paged {cfg.name}: {used} blocks in use")
        line += f"; 0 of {engine.num_blocks} blocks in use after the run"
    print(line)
    del engine
    torch.cuda.empty_cache()
    return {kernel: got[kernel]}


def dense_family(torch, device):
    """Phase 21: ServingEngine dense over phi3-medium-14b, qwen2.5-32b and
    deepseek-67b (reduced depth), each loaded after the last is freed."""
    launches = 0
    for name, layers in DENSE_FAMILY:
        cfg, params = lm_setup(torch, device, layers, torch.bfloat16, seed=1, name=name)
        launches += family_engine(torch, device, cfg, params)["decode_attention"]
        del params
        torch.cuda.empty_cache()
    return {"decode_attention": launches}


def moe_family(torch, device):
    """Phase 22: qwen2-moe-a2.7b at full width and depth (phase 7's cell,
    then ServingEngine dense and paged), then qwen3-moe at reduced depth
    (ServingEngine dense)."""
    cfg, params = lm_setup(torch, device, 24, torch.bfloat16, seed=1, name=MOE_SMALL)
    got = {"decode_attention": model_guided(torch, device, cfg, params,
                                            profile=False)[0]["decode_attention"]}
    got["decode_attention"] += family_engine(torch, device, cfg, params)["decode_attention"]
    got.update(family_engine(torch, device, cfg, params, paged=True))
    del params
    torch.cuda.empty_cache()
    cfg, params = lm_setup(torch, device, MOE_LARGE_LAYERS, torch.bfloat16, seed=1,
                           name=MOE_LARGE)
    got["decode_attention"] += family_engine(torch, device, cfg, params)["decode_attention"]
    del params
    torch.cuda.empty_cache()
    return got


def stub_batch(torch, device, cfg, tokens, seed):
    """The frontend stubs' inputs beside ``tokens``, as the reference's
    tests draw them: N(0, 1) patch embeddings (vlm) or frame embeddings
    (encdec) of the model's width, from a seed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    batch = {"tokens": tokens}
    b = tokens.shape[0]
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn((b, cfg.num_patches, cfg.d_model), generator=gen,
                                            device=device)
    if cfg.family == "encdec":
        batch["frame_embeds"] = torch.randn((b, cfg.encoder_seq, cfg.d_model), generator=gen,
                                            device=device)
    return batch


def stub_path(torch, device, cfg, params, prompt_len):
    """Phase 23 for one stub: ``prefill`` of 8 rows (the frontend's
    embeddings and ``prompt_len`` tokens), 16 greedy ``decode_step``\\ s,
    then one cache-free ``forward`` over the same positions.  Held: the
    decode kernel launches once per (self-attention) layer and step, the
    flash kernel once per layer of the forward, every logit finite."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import decode_step, forward, init_cache, prefill

    tokens = torch.stack([prompt_tokens(torch, cfg.vocab_size, prompt_len, seed=200 + i)
                          for i in range(STUB_ROWS)]).to(device)
    batch = stub_batch(torch, device, cfg, tokens, seed=33)
    extra = cfg.num_patches if cfg.family == "vlm" else 0
    cache_len = -(-(extra + prompt_len + STUB_STEPS) // BLOCK) * BLOCK
    sync(device)
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    t0 = time.perf_counter()
    logits, cache = prefill(params, cfg, batch, init_cache(cfg, STUB_ROWS, cache_len,
                                                           device=device))
    sync(device)
    t_prefill = time.perf_counter() - t0
    prefill_launches = dict(LAUNCHES)
    finite = bool(torch.isfinite(logits.float()).all())
    t0 = time.perf_counter()
    for _ in range(STUB_STEPS):
        tok = torch.argmax(logits, dim=-1)
        logits, cache = decode_step(params, cfg, tok, cache)
        finite &= bool(torch.isfinite(logits.float()).all())
    sync(device)
    t_decode = time.perf_counter() - t0
    decode_launches = LAUNCHES["decode_attention"] - prefill_launches["decode_attention"]
    reset_launches()
    t0 = time.perf_counter()
    full, _ = forward(params, cfg, batch)
    sync(device)
    t_forward = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    finite &= bool(torch.isfinite(full.float()).all())
    if decode_launches != cfg.num_layers * STUB_STEPS or LAUNCHES["flash_attention"] != \
            cfg.num_layers or not finite:
        raise AssertionError(f"{cfg.name}: decode_attention {decode_launches} launches for "
                             f"{STUB_STEPS} steps of {cfg.num_layers} layers, flash_attention "
                             f"{LAUNCHES['flash_attention']} for one forward; finite {finite}")
    encoder = (f" + {cfg.num_encoder_layers} encoder layers over {cfg.encoder_seq} frames"
               if cfg.family == "encdec" else "")
    prefill_kernels = {k: v for k, v in prefill_launches.items() if v}
    rows = (f"{extra + prompt_len} positions ({extra} patch embeddings and {prompt_len} "
            f"tokens)" if extra else f"{prompt_len} tokens")
    print(f"{cfg.name} stub: {cfg.num_layers} layers{encoder} {dtype_name(cfg)}, "
          f"{STUB_ROWS} rows of {rows}: prefill {t_prefill!r} s, {STUB_STEPS} decode steps "
          f"{t_decode!r} s = {STUB_ROWS * STUB_STEPS / t_decode!r} tokens/s, forward "
          f"{t_forward!r} s; launches: prefill {prefill_kernels}, decode_attention "
          f"{decode_launches} in the decode steps, flash_attention "
          f"{LAUNCHES['flash_attention']} in the forward; peak memory {peak!r} GiB")
    return {"decode_attention": decode_launches, "flash_attention": LAUNCHES["flash_attention"]}


def stub_family(torch, device):
    """Phase 23: llava-next-mistral-7b (576 patch embeddings and a 128-token
    prompt, 704 positions) and whisper-small (1500 frame embeddings and a
    64-token prompt), full depth, bf16."""
    from repro_torch.configs import get_config

    got = {"decode_attention": 0, "flash_attention": 0}
    for name, prompt_len in (("llava-next-mistral-7b", STUB_PROMPT),
                             ("whisper-small", WHISPER_PROMPT)):
        cfg, params = lm_setup(torch, device, get_config(name).num_layers, torch.bfloat16,
                               seed=1, name=name)
        for k, v in stub_path(torch, device, cfg, params, prompt_len).items():
            got[k] += v
        del params
        torch.cuda.empty_cache()
    return got


def roomy(cfg):
    """``cfg`` with an MoE capacity of every token of a call (``k / E``
    times the capacity factor is 1), so no token drops and an MoE model's
    cached steps equal its cache-free forward, as the reference's
    ``tests/test_arch_smoke.py`` arranges it."""
    import dataclasses

    if cfg.family != "moe":
        return cfg
    return dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.num_experts_per_tok)


def family_parity_f32(torch, device):
    """Phases 21.2, 22.2 and 23.2 at full width, 2 layers (whisper: 2 + 2),
    float32 (no TF32): ``prefill`` of 128 tokens (behind llava's patches,
    with whisper's frames) and 3 ``decode_step``\\ s against the cache-free
    ``forward``'s logits (LOGIT_TOL); then qwen2-moe's router top-k on the
    card against the CPU's on the same inputs, and the reduced qwen2-moe's
    cached, frontier and paged frontier searches on the card against the
    port on the CPU (phase 9's bar).  Returns the kernel launches."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import decode_step, forward, init_cache, prefill

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    total = {}
    for name in ("qwen2.5-32b", MOE_SMALL, MOE_LARGE, "llava-next-mistral-7b",
                 "whisper-small"):
        extra_cfg = {"num_encoder_layers": 2} if name == "whisper-small" else {}
        cfg, params = lm_setup(torch, device, 2, torch.float32, seed=5, name=name,
                               **extra_cfg)
        cfg = roomy(cfg)
        gen = torch.Generator(device=device).manual_seed(9)
        toks = torch.randint(2, cfg.vocab_size, (2, PARITY_PROMPT + 3), generator=gen,
                             device=device, dtype=torch.int32)
        batch = stub_batch(torch, device, cfg, toks, seed=34)
        extra = cfg.num_patches if cfg.family == "vlm" else 0
        reset_launches()
        full, _ = forward(params, cfg, batch)
        logits, cache = prefill(params, cfg, dict(batch, tokens=toks[:, :PARITY_PROMPT]),
                                init_cache(cfg, 2, extra + PARITY_PROMPT + 8, device=device))
        diffs = []
        for t in range(PARITY_PROMPT - 1, PARITY_PROMPT + 3):
            if t >= PARITY_PROMPT:
                logits, cache = decode_step(params, cfg, toks[:, t], cache)
            torch.testing.assert_close(logits, full[:, extra + t], **LOGIT_TOL)
            diffs.append(float((logits - full[:, extra + t]).abs().max()))
        if (LAUNCHES["flash_attention"], LAUNCHES["decode_attention"]) != (2, 6):
            raise AssertionError(f"{name}: forward, prefill and 3 decode steps launched "
                                 f"{LAUNCHES}; expected 2 flash and 6 decode kernels")
        for k, v in LAUNCHES.items():
            total[k] = total.get(k, 0) + v
        what = " (MoE capacity: every token)" if cfg.family == "moe" else ""
        behind = f" behind {extra} patch embeddings" if extra else ""
        print(f"{name} full width, 2 layers, float32{what}, 2 x {PARITY_PROMPT} prompt "
              f"tokens{behind}: max |prefill and decode step logits - forward's| = "
              f"{diffs!r} (logits up to {float(full.abs().max())!r}; tolerance {LOGIT_TOL})")
        if name == MOE_SMALL:
            router_topk_agree(torch, device, cfg, params)
        del params, full, cache
        torch.cuda.empty_cache()
    for k, v in agreement_moe_reduced(torch, device).items():
        total[k] = total.get(k, 0) + v
    return total


def router_topk_agree(torch, device, cfg, params):
    """qwen2-moe's router (float32, ``[2048, 60]``) over 1280 random token
    states: the top-4 experts on the card equal the CPU's, except where two
    experts' CPU probabilities are within 2e-7 of each other (a tie at
    float32 rounding; TF32 would flip ~1e-3 gaps)."""
    from repro_torch.models.layers import sorted_top_k

    router = params["blocks"]["moe"]["router"][0]
    gen = torch.Generator(device=device).manual_seed(35)
    x = torch.randn((ASYNC_B * MAX_LEN, cfg.d_model), generator=gen, device=device)
    (probs_card, idx_card), (probs_cpu, idx_cpu) = (
        (probs.cpu(), sorted_top_k(probs, cfg.num_experts_per_tok)[1].cpu())
        for probs in (torch.softmax(x.to(dev) @ router.to(dev), dim=-1)
                      for dev in (device, torch.device("cpu"))))
    diff = (idx_card != idx_cpu).any(1)
    gap = (probs_cpu.gather(1, idx_card) - probs_cpu.gather(1, idx_cpu)).abs().amax(1)
    if bool((diff & (gap > 2e-7)).any()):
        raise AssertionError(f"router top-k: {int(diff.sum())} of {x.shape[0]} tokens route "
                             f"differently on the card, CPU probability gaps up to "
                             f"{float(gap.max())!r}")
    print(f"{cfg.name} router (float32 {tuple(router.shape)}): top-{cfg.num_experts_per_tok} "
          f"experts on the card equal the CPU's on {x.shape[0] - int(diff.sum())} of "
          f"{x.shape[0]} tokens ({int(diff.sum())} float32 ties), max |probability "
          f"difference| {float((probs_card - probs_cpu).abs().max())!r}")


def agreement_moe_reduced(torch, device):
    """Phase 22.2's searches: the reduced qwen2-moe (vocab 64, 2 layers,
    float32) in phase 9.2's cell, cached, frontier and paged frontier, on
    the card and on the port's CPU path; returns the card's launches."""
    from repro_torch.configs import get_reduced
    from repro_torch.core import (
        CachedModelEvaluator,
        FrontierModelEvaluator,
        PagedFrontierModelEvaluator,
    )
    from repro_torch.models import init_params

    cfg = get_reduced(MOE_SMALL, vocab_size=64, num_layers=2)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(4))
    blocks = 8 * 4 * -(-REDUCED_MAX_LEN // REDUCED_BLOCK)
    evaluators = {
        "cached": lambda p: CachedModelEvaluator(cfg, p, top_k=TOP_K, eos_token=EOS),
        "frontier": lambda p: FrontierModelEvaluator(cfg, p, top_k=TOP_K, eos_token=EOS),
        "paged frontier": lambda p: PagedFrontierModelEvaluator(
            cfg, p, top_k=TOP_K, eos_token=EOS, block_size=REDUCED_BLOCK, num_blocks=blocks),
    }
    total = {}
    for what, make in evaluators.items():
        launches, _ = gpu_cpu_agree(torch, device, cfg, params, reduced_spec(), make,
                                    f"reduced {MOE_SMALL} (vocab 64, 2 layers) async {what} "
                                    "search")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    return total


# ---------------------------------------------------------------------------
# Training on the card (phase 24)
# ---------------------------------------------------------------------------

# llama3-8b at full width, cut to 8 of its 32 layers: with bf16 weights and
# gradients and AdamW's float32 m, v and master (16 bytes a parameter) the
# 8.03e9 parameters need ~128 GB; 8 layers (2.795e9) ~45 GB, ~55 GB at the
# optimizer's peak.  The learning rate reaches 3e-4 at the first step.
TRAIN_LAYERS = 8
TRAIN_STEPS = 7               # 1 warm-up step and 6 timed
TRAIN_OPT = dict(lr=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS)
# 24.2: 2 float32 layers of 2 x 64 tokens, the vocabulary cut to 4096.  At
# the first step AdamW moves a parameter by lr times the sign of its
# gradient whatever the gradient's size, so a gradient at float32 noise
# whose sign differs between card and CPU moves by 2 lr: lr = 1e-6 keeps
# that inside the parameters' bar (1e-6 + 1e-4 |p|), which therefore says
# little of the gradients: they are held directly, leaf by leaf, before the
# step, and through the new moments (m = 0.1 g, v = 0.05 g^2) after it.
PARITY_TRAIN = dict(b=2, s=64, vocab=4096, lr=1e-6)
PARITY_SSD_CHUNK = 16         # 24.3: four chunks of the 64 tokens, so the state pass runs
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
GRAD_SHARE = 1e-4             # max |g_gpu - g_cpu| <= this x max |g_cpu|, per leaf
MOMENT_SHARE = 1e-4           # max |m_gpu - m_cpu| <= this x max |m_cpu|, per leaf


class RepeatedBatch:
    """A data source that serves one batch at every step."""

    def __init__(self, batch):
        self.batch = batch

    def batch_at(self, step):
        return self.batch


# Phase 24(a)'s profiled step: device time by group, in this order (a
# kernel goes to the first group one of whose name pieces it holds; the
# optimizer's section is one group whatever its kernels).
STEP_GROUPS = (("flash_attention_bwd", ("bwd_delta_kernel", "bwd_dkdv", "bwd_dq", "bwd_wgmma")),
               ("flash_attention forward", ("flash_wgmma_kernel", "flash_mma_kernel",
                                            "flash_attention_kernel")),
               ("ssd_scan_bwd", ("ssd_bwd_",)),
               ("ssd_scan forward", ("ssd_wgmma_kernel", "ssd_mma_kernel",
                                     "ssd_fwd_state_mma_kernel", "ssd_scan_kernel")),
               ("GEMMs", ("gemm", "nvjet", "xmma", "cutlass")))


def profiled_step(torch, device, cfg, params, opt_state, batch, what="24(a)"):
    """One more step of phase 24(a) or (c) under torch.profiler, as the train step
    runs it (``grad_fn``, then AdamW in place), profiled in two sections so
    that AdamW's elementwise passes, whose kernels share their names with
    the model's, are told apart.  Prints and returns device ms by group."""
    from repro_torch.training import AdamWConfig
    from repro_torch.training.data import to_device
    from repro_torch.training.optimizer import adamw_update
    from repro_torch.training.train_step import grad_fn

    data = to_device(batch, device)
    held = {}

    def grads():
        held["grads"] = grad_fn(params, cfg, data)[1]

    sync(device)
    t0 = time.perf_counter()
    by_name = device_us_by_kernel(torch, device, grads)
    opt = device_us_by_kernel(torch, device, lambda: adamw_update(
        held.pop("grads"), opt_state, params, AdamWConfig(**TRAIN_OPT)))
    wall = time.perf_counter() - t0
    groups = {name: 0.0 for name, _ in STEP_GROUPS}
    groups["AdamW"] = sum(opt.values()) * 1e-3
    groups["the rest"] = 0.0
    for name, us in by_name.items():
        low = name.lower()
        group = next((g for g, pieces in STEP_GROUPS if any(p in low for p in pieces)),
                     "the rest")
        groups[group] += us * 1e-3
    busy = sum(groups.values())
    print(f"{what} one more step under torch.profiler: wall {wall!r} s (profiler included), "
          f"device {busy!r} ms: " + ", ".join(f"{g} {ms!r} ms ({ms / busy:.4f})"
                                             for g, ms in groups.items()))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print("  top kernels of the gradient section: "
          + "; ".join(f"{us * 1e-3!r} ms {name[:90]}" for name, us in top))
    return {"wall_s": wall, "device_ms": busy, "groups_ms": groups}


def train_llama(torch, device):
    """Phase 24(a): returns the kernels' launches and the profiled step's
    split."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.train import train
    from repro_torch.training import AdamWConfig, SyntheticStream, TrainConfig
    from repro_torch.training.optimizer import leaves

    cfg = dataclasses.replace(get_config("llama3-8b"), num_layers=TRAIN_LAYERS)
    if not (cfg.remat and cfg.loss_chunk == 0 and cfg.dtype == torch.bfloat16):
        raise AssertionError(f"phase 24 trains the reference's llama3-8b settings: {cfg}")
    source = RepeatedBatch(SyntheticStream(cfg.vocab_size, TRAIN_B, TRAIN_S, seed=3).batch_at(0))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    sync(device)
    reset_launches()
    t0 = time.perf_counter()
    params, opt_state, records = train(
        cfg, TrainConfig(optimizer=AdamWConfig(**TRAIN_OPT)), steps=TRAIN_STEPS,
        batch=TRAIN_B, seq=TRAIN_S, seed=1, device=device, source=source, log_every=1)
    sync(device)
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated(device)
    n_params = sum(x.numel() for x in leaves(params))
    split = profiled_step(torch, device, cfg, params, opt_state, source.batch)
    del params, opt_state
    torch.cuda.empty_cache()
    for r in records:
        if not (math.isfinite(r.loss) and math.isfinite(r.grad_norm)):
            raise AssertionError(f"phase 24: step {r.step} loss {r.loss}, grad norm "
                                 f"{r.grad_norm}")
    if not records[-1].loss < records[0].loss:
        raise AssertionError(f"phase 24: the loss did not fall on the repeated batch: "
                             f"{[r.loss for r in records]}")
    want = {"flash_attention": 2 * TRAIN_LAYERS * TRAIN_STEPS,
            "flash_attention_bwd": TRAIN_LAYERS * TRAIN_STEPS}
    others = {k: n for k, n in launches.items() if k not in want and n}
    if any(launches[k] != n for k, n in want.items()) or others:
        raise AssertionError(f"phase 24: launches {launches}, expected {want} and no other")
    timed = [r.seconds for r in records[1:]]
    step_s = sum(timed) / len(timed)
    name = torch.cuda.get_device_name(device)
    print(f"train llama3-8b full width, {TRAIN_LAYERS} of 32 layers, bf16, {n_params} "
          f"parameters, {TRAIN_B} x {TRAIN_S} tokens a step, remat, loss unchunked, on {name}: "
          f"losses {[r.loss for r in records]}, grad norms {[r.grad_norm for r in records]}, "
          f"lr {[r.lr for r in records]}; step times {[r.seconds for r in records]} s "
          f"(first: warm-up); mean of the {len(timed)} timed {step_s!r} s, "
          f"{TRAIN_B * TRAIN_S / step_s!r} tokens/s; peak memory {peak / 2**30!r} GiB; "
          f"wall {wall!r} s (parameters made, 7 steps); launches per step: flash_attention "
          f"{launches['flash_attention'] / TRAIN_STEPS!r}, flash_attention_bwd "
          f"{launches['flash_attention_bwd'] / TRAIN_STEPS!r}")
    return {k: launches[k] for k in want}, split


# Phase 24(c): the SSM and hybrid families at full width, 8 x 512 tokens a
# step (two chunks of 256), remat, unchunked loss, AdamW as 24(a).  mamba2
# at full depth (2.7e9 parameters, ~16 bytes each with AdamW's state);
# zamba2 at 24 of its 81 blocks (2.3e9; all 81 are 6.7e9, ~107 GB), its
# shared 32/32, D=112 block at 4 sites (blocks 0, 6, 12, 18).
SSM_TRAIN = (("mamba2-2.7b", 64, 5), ("zamba2-7b", 24, 3))   # name, blocks, steps


def train_ssm(torch, device):
    """Phase 24(c): each of :data:`SSM_TRAIN` through ``launch.train.train``
    on a repeated batch (1 warm-up step): finite losses and grad norms, the
    loss falling, and the launch identities of remat (non-reentrant
    checkpoint: each block's scan runs in the forward and in the backward's
    recompute, its backward once; likewise the shared attention block)
    held exactly, no other kernel launched.  mamba2's run is followed by
    one profiled step.  Returns ``(launches by arch, mamba2's step split)``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.train import train
    from repro_torch.training import AdamWConfig, SyntheticStream, TrainConfig
    from repro_torch.training.optimizer import leaves

    out, split = {}, None
    for name, layers, steps in SSM_TRAIN:
        cfg = dataclasses.replace(get_config(name), num_layers=layers)
        if not (cfg.remat and cfg.loss_chunk == 0 and cfg.dtype == torch.bfloat16):
            raise AssertionError(f"24(c) trains the reference's {name} settings: {cfg}")
        opt = AdamWConfig(lr=TRAIN_OPT["lr"], warmup_steps=1, total_steps=steps)
        source = RepeatedBatch(SyntheticStream(cfg.vocab_size, TRAIN_B, TRAIN_S,
                                               seed=3).batch_at(0))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        sync(device)
        reset_launches()
        t0 = time.perf_counter()
        params, opt_state, records = train(
            cfg, TrainConfig(optimizer=opt), steps=steps, batch=TRAIN_B, seq=TRAIN_S, seed=1,
            device=device, source=source, log_every=1)
        sync(device)
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated(device)
        n_params = sum(x.numel() for x in leaves(params))
        if cfg.family == "ssm":
            split = profiled_step(torch, device, cfg, params, opt_state, source.batch,
                                  what=f"24(c) {name}")
        del params, opt_state
        torch.cuda.empty_cache()
        for r in records:
            if not (math.isfinite(r.loss) and math.isfinite(r.grad_norm)):
                raise AssertionError(f"24(c) {name}: step {r.step} loss {r.loss}, grad norm "
                                     f"{r.grad_norm}")
        if not records[-1].loss < records[0].loss:
            raise AssertionError(f"24(c) {name}: the loss did not fall on the repeated batch: "
                                 f"{[r.loss for r in records]}")
        sites = -(-layers // cfg.attn_every) if cfg.family == "hybrid" else 0
        want = {"ssd_scan": 2 * layers * steps, "ssd_scan_bwd": layers * steps}
        if sites:
            want.update(flash_attention=2 * sites * steps, flash_attention_bwd=sites * steps)
        others = {k: n for k, n in launches.items() if k not in want and n}
        if any(launches[k] != n for k, n in want.items()) or others:
            raise AssertionError(f"24(c) {name}: launches {launches}, expected {want} and no "
                                 "other")
        timed = [r.seconds for r in records[1:]]
        step_s = sum(timed) / len(timed)
        print(f"24(c) train {name} full width, {layers} of {get_config(name).num_layers} "
              f"blocks ({sites} shared-block sites), bf16, {n_params} parameters, {TRAIN_B} x "
              f"{TRAIN_S} tokens a step, remat, loss unchunked, on "
              f"{torch.cuda.get_device_name(device)}: losses {[r.loss for r in records]}, grad "
              f"norms {[r.grad_norm for r in records]}; step times "
              f"{[r.seconds for r in records]} s (first: warm-up); mean of the {len(timed)} "
              f"timed {step_s!r} s, {TRAIN_B * TRAIN_S / step_s!r} tokens/s; peak memory "
              f"{peak / 2**30!r} GiB; wall {wall!r} s (parameters made, {steps} steps); "
              f"launches per step: " + ", ".join(f"{k} {launches[k] / steps!r}" for k in want))
        out[name] = {k: launches[k] for k in want}
    return out, split


def train_policy_example(torch, device):
    """Phase 24(b): the example at its default size on the card."""
    from repro_torch.examples import train_policy
    from repro_torch.kernels import LAUNCHES, reset_launches

    reset_launches()
    t0 = time.perf_counter()
    out = train_policy.main(["--device", str(device)])
    sync(device)
    wall = time.perf_counter() - t0
    if (out["restored_at"], out["last_step"]) != (20, 40):
        raise AssertionError(f"train_policy: restored at {out['restored_at']}, reached "
                             f"{out['last_step']} (expected 20, 40)")
    if not all(math.isfinite(x) for x in out["losses"]):
        raise AssertionError(f"train_policy: losses {out['losses']}")
    if not (LAUNCHES["flash_attention_bwd"] and LAUNCHES["flash_attention"]):
        raise AssertionError(f"train_policy did not run the attention kernels: {LAUNCHES}")
    print(f"train_policy on the card: restored at step {out['restored_at']}, reached step "
          f"{out['last_step']}, losses {out['losses'][0]!r} -> {out['losses'][-1]!r}, wall "
          f"{wall!r} s; flash_attention {LAUNCHES['flash_attention']}, flash_attention_bwd "
          f"{LAUNCHES['flash_attention_bwd']} launches")
    return {"flash_attention": LAUNCHES["flash_attention"],
            "flash_attention_bwd": LAUNCHES["flash_attention_bwd"]}


def grad_guard(torch, device):
    """A grad-requiring input to a kernel with no backward raises:
    ``ssd_scan(return_state=True)`` (the cache-producing prefill) and
    ``decode_attention``."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.ssd_scan import ssd_scan

    x = torch.randn((1, 16, 2, 16), device=device, requires_grad=True)
    da = -torch.rand((1, 16, 2), device=device)
    bc = torch.randn((1, 16, 16), device=device)
    q = torch.randn((2, 8, 64), device=device).to(torch.bfloat16).requires_grad_()
    cache = torch.randn((2, 32, 2, 64), device=device).to(torch.bfloat16)
    for what, call in (("ssd_scan(return_state=True)",
                        lambda: ssd_scan(x, da, bc, bc, chunk=16, return_state=True)),
                       ("decode_attention", lambda: decode_attention(q, cache, cache, 32))):
        try:
            call()
        except RuntimeError as err:
            if "no backward" not in str(err):
                raise
        else:
            raise AssertionError(f"{what} took a grad-requiring input without raising")
    print("ssd_scan(return_state=True) and decode_attention raise for a grad-requiring input "
          "on the card")


def train_parity_f32(torch, device, name="llama3-8b", with_step=True, label="24.2"):
    """24.2 (llama3-8b) and 24.3 (mamba2-2.7b, zamba2-7b): the gradients
    and, with ``with_step``, one train step at 2 full-width float32 layers (no
    TF32) on the card and on the CPU, from the same parameters and batch.
    For the recurrent families the scan runs in :data:`PARITY_SSD_CHUNK`-token
    chunks, and the card's gradients must have run the scan's backward
    kernel once per block (and the attention backward once per shared-block
    site)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import init_params
    from repro_torch.models.ssm import kernel_chunk
    from repro_torch.models.lm import tree_map
    from repro_torch.training import (AdamWConfig, SyntheticStream, TrainConfig, adamw_init,
                                      make_train_step)
    from repro_torch.training.data import to_device
    from repro_torch.training.optimizer import leaves
    from repro_torch.training.train_step import grad_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    pt = PARITY_TRAIN
    cfg = dataclasses.replace(get_config(name), num_layers=2, vocab_size=pt["vocab"],
                              dtype=torch.float32)
    if cfg.family in ("ssm", "hybrid"):
        # One chunk of 64 would skip the kernel's state pass and its
        # carried-state terms, which 24(c) trains through at 2 chunks.
        cfg = dataclasses.replace(cfg, ssd_chunk=PARITY_SSD_CHUNK)
    step = make_train_step(cfg, TrainConfig(optimizer=AdamWConfig(
        lr=pt["lr"], warmup_steps=1, total_steps=10)))
    batch = SyntheticStream(cfg.vocab_size, pt["b"], pt["s"], seed=4).batch_at(0)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(5))
    cpu_params = tree_map(lambda x: x.to("cpu", copy=True), params)   # the step writes in place
    reset_launches()
    _, g_grads = grad_fn(params, cfg, to_device(batch, device))
    sync(device)
    if cfg.family in ("ssm", "hybrid"):
        sites = -(-cfg.num_layers // cfg.attn_every) if cfg.family == "hybrid" else 0
        if (LAUNCHES["ssd_scan_bwd"], LAUNCHES["flash_attention_bwd"]) != (cfg.num_layers,
                                                                           sites):
            raise AssertionError(f"{label} {name}: the card's gradients launched {LAUNCHES}")
        chunks = pt["s"] // kernel_chunk(cfg, pt["s"])
        if chunks < 2:
            raise AssertionError(f"{label} {name}: the scan ran in {chunks} chunk")
        scan = f", the scan in {chunks} chunks"
    else:
        scan = ""
    t_cpu = time.perf_counter()
    _, c_grads = grad_fn(cpu_params, cfg, to_device(batch, "cpu"))
    t_cpu = time.perf_counter() - t_cpu
    worst_grad, grad_rel = 0.0, []
    for i, (g_leaf, c_leaf) in enumerate(zip(leaves(g_grads), leaves(c_grads))):
        bad = [int((~torch.isfinite(x)).sum()) for x in (g_leaf, c_leaf)]
        if any(bad):
            raise AssertionError(f"{label} {name}: gradient leaf {i} {tuple(c_leaf.shape)} has "
                                 f"{bad[0]} non-finite entries on the card, {bad[1]} on the CPU")
        diff = (g_leaf.cpu() - c_leaf).abs()
        share = float(diff.max()) / max(float(c_leaf.abs().max()), 1e-30)
        if share > GRAD_SHARE:
            raise AssertionError(f"{label} {name}: gradient leaf {i} {tuple(c_leaf.shape)} "
                                 f"differs by {share!r} of its largest value (bar "
                                 f"{GRAD_SHARE})")
        worst_grad = max(worst_grad, share)
        grad_rel.append(float(diff.norm()) / max(float(c_leaf.norm()), 1e-30))
    del g_grads, c_grads
    grads_line = (f"gradients within {worst_grad!r} of their largest value per leaf (bar "
                  f"{GRAD_SHARE}; largest relative norm of the difference {max(grad_rel)!r})")
    if not with_step:
        print(f"{label} the gradients, {name} full width, 2 layers, float32, vocabulary "
              f"{cfg.vocab_size}, {pt['b']} x {pt['s']} tokens{scan}, card against CPU: "
              f"{grads_line}; the CPU's took {t_cpu!r} s")
        return
    t0 = time.perf_counter()
    gp, gs, gm = step(params, adamw_init(params), to_device(batch, device))
    sync(device)
    t1 = time.perf_counter()
    cp, cs, cm = step(cpu_params, adamw_init(cpu_params), to_device(batch, "cpu"))
    t2 = time.perf_counter()
    loss_rel = abs(gm["loss"] - cm["loss"]) / abs(cm["loss"])
    if loss_rel > LOSS_RTOL:
        raise AssertionError(f"{label} {name}: loss {gm['loss']!r} on the card, {cm['loss']!r} "
                             f"on the CPU (relative {loss_rel!r})")
    worst_param, worst_moment = 0.0, 0.0
    for g_leaf, c_leaf in zip(leaves(gp), leaves(cp)):
        diff = (g_leaf.cpu() - c_leaf).abs()
        bound = PARAM_TOL["atol"] + PARAM_TOL["rtol"] * c_leaf.abs()
        if bool((diff > bound).any()):
            raise AssertionError(f"{label} {name}: updated parameters differ by up to "
                                 f"{float(diff.max())!r} ({int((diff > bound).sum())} elements "
                                 f"out of {PARAM_TOL})")
        worst_param = max(worst_param, float((diff / bound).max()))
    for g_leaf, c_leaf in zip(leaves(gs.m) + leaves(gs.v), leaves(cs.m) + leaves(cs.v)):
        share = float((g_leaf.cpu() - c_leaf).abs().max()) / max(float(c_leaf.abs().max()),
                                                                 1e-30)
        if share > MOMENT_SHARE:
            raise AssertionError(f"{label} {name}: a moment differs by {share!r} of its "
                                 "largest value")
        worst_moment = max(worst_moment, share)
    print(f"{label} one train step, {name} full width, 2 layers, float32, vocabulary "
          f"{cfg.vocab_size}, {pt['b']} x {pt['s']} tokens{scan}, lr {pt['lr']}: loss card "
          f"{gm['loss']!r} CPU {cm['loss']!r} (relative {loss_rel!r}), grad norm card "
          f"{gm['grad_norm']!r} CPU {cm['grad_norm']!r}; {grads_line}; parameters within the "
          f"bar (worst {worst_param!r} of it), moments within {worst_moment!r} of their largest value; "
          f"step {t1 - t0!r} s on the card, {t2 - t1!r} s on the CPU")


# ---------------------------------------------------------------------------
# The multi-device layer at world size 1 (phase 25)
# ---------------------------------------------------------------------------

SHARDED_SSM_BLOCKS = 4        # 25(d): mamba2-2.7b blocks (of 64)
CELL_SEED = 6


def process_group(torch, device):
    """A one-rank process group with an in-memory store (no sockets): NCCL
    on the card, gloo on the CPU (the rehearsal)."""
    import torch.distributed as dist

    if device.type == "cuda":
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                                device_id=device)
    else:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)


def one_step(torch, device, cfg, batch, seed, mesh=None, strategy="tp"):
    """One train step from the parameters of ``seed``: plain, or placed on
    ``mesh`` under ``strategy`` (``distribute_params``, AdamW's ZeRO
    state).  Returns the metrics, a copy of the updated parameters (this
    rank's blocks: at one rank, the whole), the kernels' launches, the
    step's wall and peak memory."""
    from repro_torch.distributed.sharding import (distribute_params, opt_state_shardings,
                                                  param_partition_specs)
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import init_params
    from repro_torch.training import AdamWConfig, TrainConfig, adamw_init, make_train_step
    from repro_torch.training.optimizer import leaves

    params = init_params(cfg, torch.Generator(device=device).manual_seed(seed))
    if mesh is None:
        opt_state = adamw_init(params)
    else:
        params = distribute_params(params, param_partition_specs(cfg, params, mesh, strategy),
                                   mesh)
        opt_state = adamw_init(params, opt_state_shardings(cfg, params, mesh, None, strategy).m)
    step = make_train_step(cfg, TrainConfig(optimizer=AdamWConfig(**TRAIN_OPT)), mesh=mesh,
                           strategy=strategy)
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    sync(device)
    t0 = time.perf_counter()
    params, opt_state, metrics = step(params, opt_state, batch)
    sync(device)
    wall = time.perf_counter() - t0
    launches = {k: n for k, n in LAUNCHES.items() if n}
    peak = torch.cuda.max_memory_allocated(device)
    out = [(x.to_local() if mesh is not None else x).detach().clone() for x in leaves(params)]
    del params, opt_state
    torch.cuda.empty_cache()
    return metrics, out, launches, wall, peak


def same_step(torch, label, plain, placed):
    """The placed step against the plain one: loss, grad norm and every
    updated parameter bit for bit, and the same kernel launches."""
    (m0, p0, l0, _, _), (m1, p1, l1, _, _) = plain, placed
    if l1 != l0:
        raise AssertionError(f"{label}: launches {l1}, the plain step's {l0}")
    unequal = [i for i, (a, b) in enumerate(zip(p0, p1)) if not torch.equal(a, b)]
    worst = max((float((a.float() - b.float()).abs().max()) for a, b in zip(p0, p1)),
                default=0.0)
    if m1["loss"] != m0["loss"] or m1["grad_norm"] != m0["grad_norm"] or unequal:
        raise AssertionError(f"{label}: loss {m1['loss']!r} / {m0['loss']!r}, grad norm "
                             f"{m1['grad_norm']!r} / {m0['grad_norm']!r}, {len(unequal)} of "
                             f"{len(p0)} parameters differ (largest {worst!r})")


def sharded_training(torch, device, mesh, name, layers, strategies, label):
    """25(a)/(d): a plain step of ``name`` cut to ``layers`` layers, then the
    same step from the same seed placed on the one-rank ``mesh`` under each
    of ``strategies``: bit-equal.  Returns the launches of the placed
    steps (summed) and the printed numbers."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.training import SyntheticStream
    from repro_torch.training.data import to_device

    cfg = dataclasses.replace(get_config(name), num_layers=layers)
    batch = to_device(SyntheticStream(cfg.vocab_size, TRAIN_B, TRAIN_S, seed=3).batch_at(0),
                      device)
    plain = one_step(torch, device, cfg, batch, seed=1)
    walls, peaks, launches = {"plain": plain[3]}, {"plain": plain[4]}, {}
    for strategy in strategies:
        placed = one_step(torch, device, cfg, batch, seed=1, mesh=mesh, strategy=strategy)
        same_step(torch, f"{label} {name} {strategy}", plain, placed)
        walls[strategy], peaks[strategy] = placed[3], placed[4]
        for k, n in placed[2].items():
            launches[k] = launches.get(k, 0) + n
        del placed
    print(f"{label} {name} full width, {layers} layers, bf16, {TRAIN_B} x {TRAIN_S} tokens: one "
          f"step plain and on the (1, 1) mesh under {', '.join(strategies)}, bit-equal (loss "
          f"{plain[0]['loss']!r}, grad norm {plain[0]['grad_norm']!r}, {len(plain[1])} "
          f"parameters); step walls {walls} s; peak memory "
          f"{ {k: v / 2**30 for k, v in peaks.items()} } GiB; launches a step "
          f"{plain[2]} (each placed step the same)")
    return launches


def sharded_moe(torch, device, mesh):
    """25(b): qwen2-moe-a2.7b's MoE block at full width, ``_moe_block_sharded``
    on the one-rank mesh (plus the shared experts) against
    ``_moe_block_local`` on 8 x 512 bf16 tokens: bit-equal."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import (_moe_block_local, _moe_block_sharded, init_moe,
                                           mlp_block)

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen2-moe-a2.7b")
    gen = torch.Generator(device=device).manual_seed(2)
    p = init_moe(gen, cfg, torch.bfloat16)
    x = torch.randn((TRAIN_B, TRAIN_S, cfg.d_model), generator=gen, device=device
                    ).to(torch.bfloat16)
    def sharded():
        out, aux = _moe_block_sharded(p, cfg, x, mesh)
        return out + mlp_block(p["shared"], x), aux

    with torch.no_grad():
        want, aux0 = _moe_block_local(p, cfg, x)
        got, aux1 = sharded()       # the first call also starts NCCL's communicator
        ms = {"local": time_ms(torch, lambda: _moe_block_local(p, cfg, x), 5),
              "sharded": time_ms(torch, sharded, 5)}
    if not (torch.equal(got, want) and torch.equal(aux1, aux0)):
        raise AssertionError(f"25(b): the sharded MoE block differs by "
                             f"{float((got.float() - want.float()).abs().max())!r}, aux "
                             f"{float(aux1)!r} / {float(aux0)!r}")
    print(f"25(b) qwen2-moe-a2.7b MoE block ({cfg.num_experts} experts, top "
          f"{cfg.num_experts_per_tok}, shared {cfg.shared_expert_d_ff}) on {TRAIN_B} x "
          f"{TRAIN_S} bf16 tokens: _moe_block_sharded on the (1, 1) mesh bit-equal to "
          f"_moe_block_local (aux {float(aux0)!r}); paced {ms['sharded']!r} ms sharded, "
          f"{ms['local']!r} ms local")


def sharded_search_cell(torch, device, mesh):
    """25(c): the search cell at its defaults (wave 256, T=1024, d_mlp=8192,
    bf16 MLP): one wave step on the one-rank mesh against the same step
    without a mesh, the tree bit-equal.  Returns the placed step's
    ``tree_descend`` launches."""
    from repro_torch import rng
    from repro_torch.core.batched_tree import init_batched_tree
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.search_cell import build_search_cell, place_params

    cell = build_search_cell(mesh)
    gen = torch.Generator(device=device).manual_seed(CELL_SEED)
    params = {k: (0.02 * torch.randn(v.shape, generator=gen, device=device)).to(v.dtype)
              for k, v in cell.arg_specs[0].items()}
    root = cell.env.init(rng.PRNGKey(0, device=device)[None])
    capacity = cell.cfg.num_simulations + cell.cfg.wave_size + 1
    key = rng.PRNGKey(1, device=device)
    trees, walls, launches = {}, {}, {}
    for label, p in (("plain", params), ("mesh", place_params(params, mesh))):
        tree = init_batched_tree(root, capacity, cell.env.num_actions)
        reset_launches()
        sync(device)
        t0 = time.perf_counter()
        trees[label] = cell.fn(p, tree, key)
        sync(device)
        walls[label] = 1e3 * (time.perf_counter() - t0)
        launches[label] = dict(LAUNCHES)
    a, b = trees["plain"], trees["mesh"]
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        pairs = zip(x, y) if f == "states" else [(x, y)]
        if not all(torch.equal(u, v) for u, v in pairs):
            raise AssertionError(f"25(c): the tree's {f} differs with the mesh")
    if launches["mesh"] != launches["plain"] or launches["mesh"]["tree_descend"] != \
            cell.cfg.wave_size:
        raise AssertionError(f"25(c): launches {launches}")
    print(f"25(c) search cell (wave {cell.cfg.wave_size}, T={cell.cfg.num_simulations}, "
          f"d_mlp {cell.arg_specs[0]['w1'].shape[1]}, bf16 MLP): one wave step on the (1, 1) "
          f"mesh bit-equal to the step without a mesh ({int(b.size[0])} nodes, root N "
          f"{float(b.N[0, 0])!r}); wave step {walls['mesh']!r} ms on the mesh, "
          f"{walls['plain']!r} ms without (first calls); tree_descend "
          f"{launches['mesh']['tree_descend']} launches a wave")
    return launches["mesh"]["tree_descend"]


# 25(e): one data rank's share of the reference's decode_32k cell on the
# production (16, 16) mesh, 128 rows over 16: 8 rows of a 32,768-deep bf16
# cache, full but for the last position (the reference's cell "pretends
# the cache is full"), llama3-8b at 25(a)'s setup.
DECODE_CELL_ROWS, DECODE_CELL_S = 8, 32768
SPLIT_PARTS = (2, 4)


def bf16_ulp(torch, x):
    """One bf16 unit in the last place at each |x| (float32)."""
    e = torch.floor(torch.log2(x.float().abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def split_merge_check(torch, q, k, v, lens):
    """Splits of S against the unsplit kernel (``parts = 1``): the kernel
    with ``return_lse`` on 2 and on 4 slices of S, merged by
    ``merge_by_lse``, and the wrapper, which splits S across blocks as its
    plan says (``decode_parts``): bf16 within one bf16 ulp of the row's
    largest |out| (both round the same float32 sums, taken in another
    order, once: near zero an element's own ulp is below that float32
    noise); float32 (the same cache upcast) within 2e-6 of the row's
    largest attention over |V| (``out`` of random V over 32,767 keys
    cancels to ~1/40 of the summands' scale, on which float32 rounding
    acts).  Returns the worst of each and the plan's parts."""
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_split
    from repro_torch.kernels.decode_attention.ops import decode_parts, query_groups
    from repro_torch.models.layers import merge_by_lse

    n, hq, _ = q.shape
    s, hkv = k.shape[1], k.shape[2]
    # (The plain version on the CPU does not split.)
    plan = 1 if q.device.type != "cuda" else decode_parts(
        n * hkv * query_groups(hq // hkv), s,
        torch.cuda.get_device_properties(q.device).multi_processor_count)
    worst = {"bfloat16_ulps": 0.0, "float32_share": 0.0, "plan_parts": plan}
    for dtype in (torch.bfloat16, torch.float32):
        qd, kd, vd = (x.to(dtype) for x in (q, k, v))
        whole = decode_attention_split(qd, kd, vd, lens, 1).float()
        if dtype == torch.float32:
            scale = decode_attention(qd, kd, vd.abs(), lens).amax(dim=(1, 2))
        splits = {}
        for parts in SPLIT_PARTS:
            step = s // parts
            outs, lses = zip(*(decode_attention(
                qd, kd[:, i * step:(i + 1) * step].contiguous(),
                vd[:, i * step:(i + 1) * step].contiguous(),
                torch.clamp(lens - i * step, 0, step), return_lse=True) for i in range(parts)))
            splits[f"{parts} slices merged"] = merge_by_lse(torch.stack(outs),
                                                           torch.stack(lses))[0].to(dtype)
        splits[f"the plan's {plan} parts"] = decode_attention(qd, kd, vd, lens)
        for what, merged in splits.items():
            if dtype == torch.bfloat16:
                ulps = float(((merged.float() - whole).abs().amax(dim=(1, 2))
                              / bf16_ulp(torch, whole.abs().amax(dim=(1, 2)))).max())
                worst["bfloat16_ulps"] = max(worst["bfloat16_ulps"], ulps)
                ok = ulps <= 1.0
            else:
                share = float(((merged - whole).abs().amax(dim=(1, 2)) / scale).max())
                worst["float32_share"] = max(worst["float32_share"], share)
                ok = share <= 2e-6
            if not ok:
                raise AssertionError(f"25(e): {what} differ from the unsplit kernel "
                                     f"({dtype}): {worst}")
        del qd, kd, vd
    return worst


def time_decode_cell(torch, device, q, k, v, lens):
    """decode_attention at 25(e)'s shape: the kernel as the plan splits it
    (paced and by graph replay) and unsplit (``parts = 1``, graph
    replay), plain version, SDPA (paced and by graph replay), and the
    bound: each valid K/V byte read once, q read and out written once, at
    3.35 TB/s."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (
        decode_attention,
        decode_attention_ref,
        decode_attention_split,
    )

    n, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    k_ms = time_ms(torch, lambda: decode_attention(q, k, v, lens), 50)
    k_dev = device_ms(lambda: decode_attention(q, k, v, lens), calls=20)
    one_dev = device_ms(lambda: decode_attention_split(q, k, v, lens, 1), calls=20)
    p_ms = time_ms(torch, lambda: decode_attention_ref(q, k, v, lens), 3)
    mask = (torch.arange(s, device=device)[None, :] < lens[:, None])[:, None, None, :]
    qs, ks, vs = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
    lib = lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, enable_gqa=True)
    lib_ms = time_ms(torch, lib, 10)
    lib_dev = device_ms(lib, calls=20)
    valid = int(lens.sum())
    nbytes = 2 * (2 * n * hq * d + 2 * valid * hkv * d) + 4 * n
    ops = 4 * d * hq * valid
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S) * 1e3
    print(f"25(e) decode_attention bf16 N={n} S={s} {hq}/{hkv} D={d} (kv_len {valid // n}): "
          f"kernel {k_ms * 1e3!r} us paced, {k_dev * 1e3!r} us device (unsplit, parts = 1: "
          f"{one_dev * 1e3!r} us device); plain {p_ms * 1e3!r} us, SDPA {lib_ms * 1e3!r} us "
          f"paced, {lib_dev * 1e3!r} us device; bound {bound_ms * 1e3!r} us ({nbytes} bytes "
          f"at 3.35 TB/s; {ops} flops); device share of the bound {bound_ms / k_dev!r}")
    return {"shape": [n, s, hq, hkv, d], "kv_len": valid // n, "ms": k_ms, "device_ms": k_dev,
            "unsplit_device_ms": one_dev, "plain_ms": p_ms, "library_ms": lib_ms,
            "library_device_ms": lib_dev, "bound_ms": bound_ms, "bound_by": "bytes",
            "device_bound_share": bound_ms / k_dev}


def sharded_decode(torch, device, mesh):
    """25(e): llama3-8b at 25(a)'s setup over one data rank's share of the
    decode_32k cell (``DECODE_CELL_ROWS`` rows of a ``DECODE_CELL_S``-deep
    bf16 cache at ``len`` S - 1): ``decode_step`` plain, then the cell's
    ``fn`` on the (1, 1) mesh with its arguments placed by ``place_args``
    in the ``batch`` and the split-KV ``batch+seq_model`` modes: logits and
    caches bit-equal, one ``decode_attention`` launch a layer, 0 wire bytes
    counted; the split merged on one card against the unsplit kernel; the
    kernel timed.  Returns (the launches of the placed steps, the timing
    fields for the kernels line)."""
    import contextlib
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.distributed.collectives import CollectiveCounter
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.cells import build_cell, place_args
    from repro_torch.models import decode_step, init_params
    from repro_torch.models.lm import tree_map

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("llama3-8b"), num_layers=TRAIN_LAYERS)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(1))
    b, s, hkv, d = DECODE_CELL_ROWS, DECODE_CELL_S, cfg.num_kv_heads, cfg.head_dim
    gen = torch.Generator(device=device).manual_seed(7)
    shape = (cfg.num_layers, b, s, hkv, d)
    cache = {"kv": {"k": torch.randn(shape, generator=gen, device=device, dtype=cfg.dtype),
                    "v": torch.randn(shape, generator=gen, device=device, dtype=cfg.dtype)},
             "len": torch.tensor(s - 1, dtype=torch.int32, device=device)}
    token = torch.randint(2, cfg.vocab_size, (b,), generator=gen, device=device)
    over = {"num_layers": cfg.num_layers}
    runs, launches, walls = {}, {}, {}
    with torch.no_grad():
        for mode in ("plain", "batch", "batch+seq_model"):
            fresh = tree_map(torch.clone, cache)
            if mode == "plain":
                fn, args = (lambda p, t, c: decode_step(p, cfg, t, c)), (params, token, fresh)
            else:
                cell = build_cell("llama3-8b", "decode_32k", mesh, cfg_overrides=over,
                                  kv_mode=mode)
                fn, args = cell.fn, place_args(cell, mesh, (params, token, fresh))
            reset_launches()
            sync(device)
            t1 = time.perf_counter()
            scope = contextlib.nullcontext() if mode == "plain" else use_mesh(mesh)
            with scope, CollectiveCounter() as counter:
                logits, out_cache = fn(*args)
            sync(device)
            walls[mode] = time.perf_counter() - t1
            launches[mode] = {k: n for k, n in LAUNCHES.items() if n}
            wire = counter.result()
            local = lambda x: x.to_local() if hasattr(x, "to_local") else x
            runs[mode] = (local(logits), {k: local(out_cache["kv"][k]) for k in ("k", "v")})
            if mode != "plain":
                want_logits, want_cache = runs["plain"]
                same = torch.equal(runs[mode][0], want_logits) and all(
                    torch.equal(runs[mode][1][k], want_cache[k]) for k in ("k", "v"))
                if not same:
                    raise AssertionError(f"25(e) {mode}: the placed decode step differs from "
                                         f"the plain one (logits by "
                                         f"{float((runs[mode][0].float() - want_logits.float()).abs().max())!r})")
                if wire["total"] != 0:
                    raise AssertionError(f"25(e) {mode}: {wire} wire bytes at world size 1")
                print(f"25(e) {mode}: collectives at world size 1 {wire}")
            if launches[mode] != {"decode_attention": cfg.num_layers}:
                raise AssertionError(f"25(e) {mode}: launches {launches[mode]}, want "
                                     f"{cfg.num_layers} decode_attention")
            del fresh, args
            if mode != "plain":
                del runs[mode]
    del runs
    torch.cuda.empty_cache()
    # The split over S on one card, and the kernel's time, on layer 0.
    q = torch.randn((b, cfg.num_heads, d), generator=gen, device=device).to(cfg.dtype)
    k, v = cache["kv"]["k"][0], cache["kv"]["v"][0]
    lens = torch.full((b,), s - 1, dtype=torch.int32, device=device)
    worst = split_merge_check(torch, q, k, v, lens)
    timing = time_decode_cell(torch, device, q, k, v, lens)
    print(f"25(e) llama3-8b full width, {cfg.num_layers} layers, bf16, {b} rows x {s} cache "
          f"at len {s - 1}: decode_step plain and the decode_32k cell on the (1, 1) mesh in "
          f"batch and batch+seq_model, logits and caches bit-equal; decode_attention "
          f"{cfg.num_layers} launches a step; walls {walls} s (first calls); the kernel with "
          f"return_lse on {SPLIT_PARTS} slices of S merged by merge_by_lse, and split across "
          f"blocks by its plan, against the unsplit kernel (parts = 1): worst {worst} (bf16: "
          f"in ulps of the row's largest |out|, bar 1; float32: share of the row's largest "
          f"attention over |V|, bar 2e-6); 25(e) took {time.perf_counter() - t0!r} s")
    del cache, params, q
    torch.cuda.empty_cache()
    placed = {k: launches["batch"].get(k, 0) + launches["batch+seq_model"].get(k, 0)
              for k in launches["batch"]}
    return placed, {**timing, "launches": launches["batch"]["decode_attention"],
                    "split_merge": worst}


# 25(f): phase 7's cell through the async engine's split slot aux on the
# (1, 1) mesh, llama3-8b at full width and 2 of its 32 layers and
# mamba2-2.7b at 2 of its 64 blocks, T=32.  Cut for time from 4 layers and
# 25(d)'s 4 blocks, then from T=64: its 18 calls are host-bound (3.5-5.3 s
# each at T=64 and 2 layers), and the collective counter's dispatch mode
# adds ~3 s to the call it wraps.
SPLIT_LAYERS = 2
SPLIT_SIMULATIONS = 32
SPLIT_MODES = ("uncached", "cached", "paged", "frontier", "paged frontier")


def split_evaluator(mode, cfg, params):
    """25(f)'s evaluator of ``mode`` (the paged ones over phase 10's pool)."""
    from repro_torch.core import (CachedModelEvaluator, FrontierModelEvaluator, ModelEvaluator,
                                  PagedCachedModelEvaluator, PagedFrontierModelEvaluator)

    kw = dict(top_k=TOP_K, eos_token=EOS)
    paged = dict(block_size=BLOCK, num_blocks=POOL_BLOCKS)
    return {"uncached": lambda: ModelEvaluator(cfg, params, **kw),
            "cached": lambda: CachedModelEvaluator(cfg, params, **kw),
            "paged": lambda: PagedCachedModelEvaluator(cfg, params, **kw, **paged),
            "frontier": lambda: FrontierModelEvaluator(cfg, params, **kw),
            "paged frontier": lambda: PagedFrontierModelEvaluator(cfg, params, **kw, **paged),
            }[mode]()


def split_mode(torch, device, mesh, cfg, params, mode):
    """25(f) in one mode: phase 7's searches placed (``constrain=
    constrain_search_batch`` on the mesh) inside ``CollectiveCounter``,
    plain, and placed again under ``retrace_guard`` alone (its wall is
    the placement's, without the counter's dispatch); the results
    bit-equal, the launches equal, 0 wire bytes.  Returns the first
    placed call's launches."""
    from repro_torch.analysis import host_syncs, library_loads, retrace_guard
    from repro_torch.core import build_searcher
    from repro_torch.distributed.collectives import CollectiveCounter
    from repro_torch.distributed.sharding import constrain_search_batch, use_mesh

    env, spec, roots, rngs = guided_cell(torch, device, cfg, params, SPLIT_SIMULATIONS)
    ev = split_evaluator(mode, cfg, params)
    plain = build_searcher(env, spec, evaluator=ev, device=device)
    placed = build_searcher(env, spec, evaluator=ev, device=device,
                            constrain=constrain_search_batch)

    def counted():
        with use_mesh(mesh), CollectiveCounter() as counter:
            res = placed(roots, rngs)
        return res, counter.result()

    def guarded(limit):
        with retrace_guard(loads=(library_loads, 0), syncs=(host_syncs, limit)) as guard, \
                use_mesh(mesh):
            res = placed(roots, rngs)
        return res, guard.counts()

    runs = {"placed": counted_run(torch, device, counted),
            "plain": counted_run(torch, device, lambda: plain(roots, rngs))}
    runs["guarded"] = counted_run(torch, device, lambda: guarded(runs["placed"][4]))
    res, wire = runs["placed"][0]
    base = runs["plain"][0]
    search_results_ok(torch, base, spec, f"25(f) {mode}")
    again, counts = runs["guarded"][0]
    for label, got in (("placed", res), ("guarded", again)):
        unequal = [f for f in base._fields if not torch.equal(getattr(got, f),
                                                              getattr(base, f))]
        if unequal:
            raise AssertionError(f"25(f) {mode}: the {label} search's {unequal} differ from "
                                 "the plain search's")
    launched = {label: {k: n for k, n in run[2].items() if n} for label, run in runs.items()}
    if not launched["placed"] or launched["placed"] != launched["plain"] or \
            launched["guarded"] != launched["plain"]:
        raise AssertionError(f"25(f) {mode}: launches {launched}")
    if wire["total"] != 0:
        raise AssertionError(f"25(f) {mode}: {wire['total']!r} wire bytes at world size 1")
    walls = {label: run[1] for label, run in runs.items()}
    syncs = {label: run[4] for label, run in runs.items()}
    print(f"25(f) {mode}: {cfg.name} {cfg.num_layers} layers bf16, phase 7's cell at "
          f"T={spec.num_simulations}, placed "
          f"(counted), plain and placed again (guarded), every SearchResult field bit-equal; "
          f"launches {launched['placed']} in each; walls {walls} s (first calls of the "
          f"mode); host syncs {syncs}; collectives {wire['counts']}, wire bytes "
          f"{wire['total']!r}; guarded call {counts}; master ticks {int(base.ticks.max())}, "
          f"actions {base.action.tolist()}")
    return launched["placed"]


def split_searches(torch, device, mesh):
    """25(f): :func:`split_mode` in llama3-8b's five modes and with
    mamba2-2.7b's ``ModelEvaluator``.  Returns the kernels' launches,
    summed over the modes' first placed calls."""
    t0 = time.perf_counter()
    launches = {}

    def add(got):
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n

    cfg, params = lm_setup(torch, device, SPLIT_LAYERS, torch.bfloat16, seed=1)
    for mode in SPLIT_MODES:
        add(split_mode(torch, device, mesh, cfg, params, mode))
    del params
    torch.cuda.empty_cache()
    cfg, params = lm_setup(torch, device, SPLIT_LAYERS, torch.bfloat16, seed=1,
                           name="mamba2-2.7b")
    add(split_mode(torch, device, mesh, cfg, params, "uncached"))
    del params
    torch.cuda.empty_cache()
    print(f"25(f) launches {launches}; 25(f) took {time.perf_counter() - t0!r} s")
    return launches


# 25(g): the request lifecycle in 25(f)'s llama3-8b cell (full width, 2 of
# 32 layers, bf16, B=8, W=16, T=32), cached and paged: twelve requests on
# prefixes of phase 7's prompt, 64-128 tokens long, drained through a ring
# of 4 and host-paced, both in segments of 4 ticks.
LIFECYCLE_R = 12
LIFECYCLE_RING = 4
LIFECYCLE_SEG = 4
LIFECYCLE_MODES = ("cached", "paged")


def lifecycle_requests(torch, device, cfg):
    """25(g)'s requests: root states and keys of ``LIFECYCLE_R`` prompts,
    prefixes of phase 7's prompt of lengths from a seed."""
    from repro_torch import rng
    from repro_torch.envs.token_env import TokenEnvState

    prompt = prompt_tokens(torch, cfg.vocab_size, PROMPT_LEN, seed=2)
    lengths = np.random.default_rng(7).integers(PROMPT_LEN // 2, PROMPT_LEN + 1,
                                                size=LIFECYCLE_R).astype(np.int32)
    tokens = torch.zeros((LIFECYCLE_R, MAX_LEN), dtype=torch.int32)
    for i, n in enumerate(lengths):
        tokens[i, :n] = prompt[:n]
    roots = TokenEnvState(tokens=tokens.to(device), length=torch.from_numpy(lengths).to(device),
                          done=torch.zeros((LIFECYCLE_R,), dtype=torch.bool, device=device))
    return roots, rng.split(rng.PRNGKey(3, device=device), LIFECYCLE_R)


def lifecycle_take(roots, ids):
    from repro_torch.envs.base import map_state

    return map_state(lambda x: x[list(ids)], roots)


def lifecycle_host_paced(torch, engine, roots, keys):
    """25(g)'s host-paced drain: the first ``B`` requests born in the rows,
    then segments of ``LIFECYCLE_SEG`` ticks, each followed by the settled
    rows' harvest, an ``evict`` and an ``admit`` a row.  Returns ``(carry,
    {request: its SearchResult row})``."""
    import collections

    from repro_torch.core import SearchResult
    from repro_torch.sync import host_read

    b = engine.B
    carry = engine.init_carry(lifecycle_take(roots, range(b)), keys[:b])
    row_req = list(range(b))
    queue = collections.deque(range(b, LIFECYCLE_R))
    results = {}
    while queue or any(r is not None for r in row_req):
        carry, _, _ = engine.run_segment(carry, LIFECYCLE_SEG)
        settled = host_read(engine.settled(carry))
        done = [r for r in range(b) if settled[r] and row_req[r] is not None]
        if done:
            res = engine.result(carry)
            for r in done:
                results[row_req[r]] = SearchResult(*(x[r].clone() for x in res))
                row_req[r] = None
                carry = engine.evict(carry, torch.tensor([r]))
        for r in range(b):
            if settled[r] and row_req[r] is None and queue:
                row_req[r] = queue.popleft()
                carry = engine.admit(carry, torch.tensor([r]),
                                     lifecycle_take(roots, [row_req[r]]),
                                     keys[row_req[r]:row_req[r] + 1])
    return carry, results


def lifecycle_fused(torch, engine, roots, keys):
    """25(g)'s fused drain: every row born idle (its placeholder pages
    evicted), a ring of ``LIFECYCLE_RING`` made for the carry, filled
    before each ``serve_segment`` of ``LIFECYCLE_SEG`` ticks.  Returns
    ``(carry, ring, {request: its SearchResult row})``."""
    import collections

    from repro_torch.core import SearchResult

    b = engine.B
    dev = keys.device
    carry = engine.init_carry(lifecycle_take(roots, range(b)), keys[:b],
                              active=torch.zeros((b,), dtype=torch.bool, device=dev))
    carry = engine.evict(carry, torch.arange(b))
    ring = engine.init_ring(carry, LIFECYCLE_RING)
    row_req = torch.full((b,), -1, dtype=torch.int64, device=dev)
    queue = collections.deque(range(LIFECYCLE_R))
    staged = in_rows = 0
    results = {}
    while queue or staged or in_rows:
        while queue and staged < LIFECYCLE_RING:
            q = queue.popleft()
            carry, ring = engine.stage(carry, ring, lifecycle_take(roots, [q]), keys[q:q + 1],
                                       [q])
            staged += 1
        carry, ring, row_req, comp, _, _ = engine.serve_segment(carry, ring, row_req,
                                                                LIFECYCLE_SEG)
        for i, q in enumerate(comp.req_id[:comp.count].tolist()):
            results[q] = SearchResult(
                action=comp.action[i], root_n=comp.root_n[i], root_v=comp.root_v[i],
                tree_size=comp.tree_size[i], dup_selections=torch.zeros((), device=dev),
                max_o=comp.max_o[i], overflowed=comp.overflowed[i], ticks=comp.ticks[i])
        left = int(ring.count.sum())
        in_rows += staged - left - comp.count
        staged = left
    return carry, ring, results


def lifecycle_drain(torch, device, mesh, mode, surface, engine, roots, keys, how):
    """One 25(g) drain under ``counted_run``, ``how``: ``"counted"`` on the
    mesh inside ``CollectiveCounter``, ``"placed"`` on the mesh,
    ``"guarded"`` on the mesh under ``retrace_guard`` (no library load), or
    ``"plain"``.  Returns ``(counted_run's tuple, {request: row}, the
    counter's or the guard's reading)``; raises if a pool block or a ring
    page is still in use after it."""
    from repro_torch.analysis import library_loads, retrace_guard
    from repro_torch.distributed.collectives import CollectiveCounter
    from repro_torch.distributed.sharding import use_mesh

    def drain():
        if surface == "fused":
            carry, ring, results = lifecycle_fused(torch, engine, roots, keys)
            tables = [ring.aux["table"]] if "table" in ring.aux else []
        else:
            carry, results = lifecycle_host_paced(torch, engine, roots, keys)
            tables = []
        aux = carry[7]
        if "refcount" in aux:
            p = aux["refcount"].shape[0]
            held = int((aux["refcount"] > 0).sum())
            if held or not all(bool((t == p).all()) for t in tables + [aux["table"]]):
                raise AssertionError(f"25(g) {mode} {surface} ({how}): {held} pool blocks in "
                                     "use, or a table off the sentinel, after the drain")
        return results

    def run():
        if how == "plain":
            return drain(), None
        if how == "guarded":
            with retrace_guard(loads=(library_loads, 0)) as g, use_mesh(mesh):
                got = drain()
            return got, g.counts()
        if how == "placed":
            with use_mesh(mesh):
                return drain(), None
        with use_mesh(mesh), CollectiveCounter() as counter:
            got = drain()
        return got, counter.result()

    run_ = counted_run(torch, device, run)
    results, reading = run_[0]
    return run_, results, reading


def split_lifecycle(torch, device, mesh):
    """25(g): 25(f)'s llama3-8b cell's request lifecycle, cached and paged,
    fused and host-paced, placed (``constrain=constrain_search_batch`` on
    the mesh) and plain: each request's results bit-equal, the same
    launches, no pool block in use after a paged drain; the paged fused
    drain placed inside ``CollectiveCounter`` (0 wire bytes), the paged
    host-paced one, the second placed paged drain, under ``retrace_guard``
    (no library load).  Returns the placed drains' launches."""
    from repro_torch.core import BatchedAsyncEngine, SearchResult
    from repro_torch.distributed.sharding import constrain_search_batch

    t0 = time.perf_counter()
    cfg, params = lm_setup(torch, device, SPLIT_LAYERS, torch.bfloat16, seed=1)
    env, spec, _, _ = guided_cell(torch, device, cfg, params, SPLIT_SIMULATIONS)
    roots, keys = lifecycle_requests(torch, device, cfg)
    launches = {}
    for mode in LIFECYCLE_MODES:
        ev = split_evaluator(mode, cfg, params)
        placed = BatchedAsyncEngine(env, spec.config, ASYNC_B, evaluator=ev,
                                    constrain=constrain_search_batch)
        plain = BatchedAsyncEngine(env, spec.config, ASYNC_B, evaluator=ev)
        for surface in ("fused", "host-paced"):
            what = f"25(g) {mode} {surface}"

            # The paged fused drain, whose ring holds pool pages, runs inside
            # the collective counter (its dispatch mode doubles a drain's
            # wall); the paged host-paced one, the second placed paged drain,
            # under the guard.
            how = {("paged", "fused"): "counted",
                   ("paged", "host-paced"): "guarded"}.get((mode, surface), "placed")
            runs = {label: lifecycle_drain(torch, device, mesh, mode, surface, engine, roots,
                                           keys, label if label == "plain" else how)
                    for label, engine in (("placed", placed), ("plain", plain))}
            base = runs["plain"][1]
            if sorted(base) != list(range(LIFECYCLE_R)):
                raise AssertionError(f"{what}: requests {sorted(base)} done")
            search_results_ok(torch, SearchResult(*(
                torch.stack([getattr(base[q], f) for q in range(LIFECYCLE_R)])
                for f in SearchResult._fields)), spec, what)
            for label, (_, got, _) in runs.items():
                unequal = sorted({f for q in range(LIFECYCLE_R) for f in SearchResult._fields
                                  if f != "dup_selections" and not torch.equal(
                                      getattr(got[q], f), getattr(base[q], f))})
                if sorted(got) != sorted(base) or unequal:
                    raise AssertionError(f"{what}: the {label} drain's {unequal} differ from "
                                         "the plain drain's")
            launched = {label: {k: n for k, n in run[0][2].items() if n}
                        for label, run in runs.items()}
            if not launched["placed"] or launched["placed"] != launched["plain"]:
                raise AssertionError(f"{what}: launches {launched}")
            reading = runs["placed"][2]
            if how == "counted" and reading["total"] != 0:
                raise AssertionError(f"{what}: {reading['total']!r} wire bytes at world size 1")
            for k, n in launched["placed"].items():
                launches[k] = launches.get(k, 0) + n
            walls = {label: run[0][1] for label, run in runs.items()}
            syncs = {label: run[0][4] for label, run in runs.items()}
            read = "placed drain uncounted"
            if how == "counted":
                read = f"collectives {reading['counts']}, wire bytes {reading['total']!r}"
            elif how == "guarded":
                read = f"placed drain guarded: {reading}"
            ring = f" through a ring of {LIFECYCLE_RING}" if surface == "fused" else ""
            print(f"{what}: {cfg.name} {cfg.num_layers} layers bf16, B={ASYNC_B} W={ASYNC_W} "
                  f"T={spec.num_simulations}, {LIFECYCLE_R} requests{ring}, segments of "
                  f"{LIFECYCLE_SEG} ticks, placed and plain: each request's SearchResult "
                  f"bit-equal; launches {launched['placed']} in each; walls {walls} s; host "
                  f"syncs {syncs}; {read}; ticks "
                  f"{[int(base[q].ticks) for q in range(LIFECYCLE_R)]}, actions "
                  f"{[int(base[q].action) for q in range(LIFECYCLE_R)]}")
    del params
    torch.cuda.empty_cache()
    print(f"25(g) launches {launches}; 25(g) took {time.perf_counter() - t0!r} s")
    return launches


def multi_device(torch, device):
    """Phase 25: the multi-device layer at world size 1, through the sharded
    code path on a ``(1, 1)`` ``('data', 'model')`` mesh.  Returns the
    kernels' launches."""
    import torch.distributed as dist

    from repro_torch.distributed.sharding import abstract_mesh
    from repro_torch.launch.mesh import device_mesh

    t0 = time.perf_counter()
    process_group(torch, device)
    try:
        mesh = device_mesh(abstract_mesh((1, 1), ("data", "model")),
                           None if device.type == "cuda" else "cpu")
        launches = sharded_training(torch, device, mesh, "llama3-8b", TRAIN_LAYERS,
                                    ("tp", "fsdp"), "25(a)")
        got, decode_cell = sharded_decode(torch, device, mesh)
        launches.update(got)
        launches.update(sharded_training(torch, device, mesh, "mamba2-2.7b",
                                         SHARDED_SSM_BLOCKS, ("tp",), "25(d)"))
        sharded_moe(torch, device, mesh)
        launches["tree_descend"] = sharded_search_cell(torch, device, mesh)
        for k, n in split_searches(torch, device, mesh).items():
            launches[k] = launches.get(k, 0) + n
        for k, n in split_lifecycle(torch, device, mesh).items():
            launches[k] = launches.get(k, 0) + n
    finally:
        dist.destroy_process_group()
    print(f"phase 25 took {time.perf_counter() - t0!r} s")
    return launches, decode_cell


def main():
    import torch

    phase("1. card")
    card_info(torch)
    device = torch.device("cuda", 0)

    phase("2. build")
    from repro_torch.kernels import _build
    libraries = sorted(set(SOURCES.values()))
    t0 = time.perf_counter()
    _build.build(libraries)
    print(f"built {', '.join(libraries)} in {time.perf_counter() - t0!r} s (in parallel)")
    for name, log in _build.BUILD_LOGS.items():
        print(f"nvcc {name}:\n{log.strip()}")
    for name in PTXAS_SUMMARY:
        print(f"ptxas {name} (registers, spills, static shared memory):")
        print("\n".join(ptxas_summary(_build.BUILD_LOGS.get(name, ""))))
    for name, (kernel, opcodes) in SASS_REQUIRED.items():
        counts = sass_opcodes(_build.library_path(name), kernel, opcodes)
        print(f"SASS of {kernel} ({name}): {counts}")
        if not all(counts.values()):
            raise AssertionError(f"{kernel} issues none of some of {opcodes}: {counts}")

    phase("3. kernels against their plain versions")
    fields = {"tree_select": check_tree_select(torch, device)}
    fields["tree_select"].update(check_tree_descend(torch, device))
    # Driven shapes beyond the grids: phase 9.1 (4 rows, 24 positions, full
    # width) and phase 9.2 (the reduced model's 8 x 4 slots, 4/2 heads, D=16).
    # Phases 21-23 drive 8 slots of 160 at each new layout, qwen2-moe's 128
    # slots (phase 22a), llava's 8 rows of 720; phases 21.2-23.2 2 rows of
    # 136 (llava 712).
    family_decode = [(n, s, *layout) for layout in NEW_LAYOUTS
                     for n, s in ((ENGINE_SLOTS, MAX_LEN), (2, PARITY_PROMPT + 8))]
    family_decode += [(ASYNC_B * ASYNC_W, MAX_LEN, 16, 16, 128), (STUB_ROWS, 720, 32, 8, 128),
                      (2, 576 + PARITY_PROMPT + 8, 32, 8, 128)]
    # 25(e)'s one data rank of the decode_32k cell, split across blocks.
    err = check_decode(torch, device, [(4, 24, 32, 8, 128),
                                       (8 * 4, REDUCED_MAX_LEN, 4, 2, 16)] + family_decode
                       + [(DECODE_CELL_ROWS, DECODE_CELL_S, 32, 8, 128)])
    fields["decode_attention"] = {"max_abs_err": err, **time_decode(torch, device),
                                  "options_max_err": check_decode_options(torch, device)}
    # qwen2.5-32b's and qwen3-moe's ServingEngine decode (phases 21, 22):
    # 8 slots of 160, lengths 65-160.
    fields["decode_attention"]["family_shapes"] = {
        name: {"shape": [ENGINE_SLOTS, MAX_LEN, hq, hkv, d],
               **time_decode(torch, device, ENGINE_SLOTS, MAX_LEN, hq, hkv, d, min_len=65)}
        for name, (hq, hkv, d) in (("qwen2.5-32b", (40, 8, 128)),
                                   (MOE_LARGE, (64, 4, 64)))}
    # Phase 14 drives zamba2's shared block (8 rows of 160, 32/32, D=112),
    # phase 9.4 the reduced zamba2 (32 rows of 20, 4/2 heads, D=16); the
    # new layouts at 2 x 160, llava's 8 x 704 and whisper's 8 x 64 (phase
    # 23), and phases 21.2-23.2's 2 x 131 (llava 707).
    family_flash = [(2, MAX_LEN, *layout) for layout in NEW_LAYOUTS]
    family_flash += [(STUB_ROWS, 576 + STUB_PROMPT, 32, 8, 128),
                     (STUB_ROWS, WHISPER_PROMPT, 12, 12, 64),
                     (2, 576 + PARITY_PROMPT + 3, 32, 8, 128)]
    family_flash += [(2, PARITY_PROMPT + 3, *layout) for layout in
                     ((40, 8, 128), (16, 16, 128), (64, 4, 64), (12, 12, 64))]
    err = check_flash(torch, device, [(4, 24, 32, 8, 128), (WAVE_B * WAVE_W, MAX_LEN, 32, 32, 112),
                                      (8 * 4, REDUCED_MAX_LEN, 4, 2, 16)] + family_flash)
    fields["flash_attention"] = {"max_abs_err": err, **time_flash(torch, device)}
    time_flash(torch, device, hq=32, hkv=32, d=112)
    bwd_errs = check_flash_bwd(torch, device)
    fields["flash_attention_bwd"] = {"max_abs_err": bwd_errs["float32"],
                                     "bf16_max_err_share": bwd_errs["bfloat16_share"],
                                     "lse_max_abs_err": bwd_errs["lse"],
                                     **time_flash_bwd(torch, device)}
    # zamba2's shared block in phase 24(c): 8 x 512 tokens, 32/32, D=112.
    t0 = time.perf_counter()
    fields["flash_attention_bwd"]["zamba2_d112"] = time_flash_bwd(torch, device, hq=32, hkv=32,
                                                                  d=112)
    print(f"flash_attention_bwd timed at D=112 in {time.perf_counter() - t0!r} s")
    # Phases 10-12 drive 128 slots over 10 blocks of 16 with A = 8 candidates
    # at full width; phase 9.2 32 slots over 5 blocks of 4, 4/2 heads, D=16.
    n_main, npg_main = ASYNC_B * ASYNC_W, -(-MAX_LEN // BLOCK)
    npg_reduced = -(-REDUCED_MAX_LEN // REDUCED_BLOCK)
    # The new layouts at 8 slots over 10 blocks of 16 (qwen2-moe's paged
    # ServingEngine and, with A = 8, its frontier).
    errs = check_tree(torch, device,
                      [(n_main, TOP_K, MAX_LEN, 32, 8, 128)]
                      + [(ENGINE_SLOTS, TOP_K, MAX_LEN, *layout) for layout in NEW_LAYOUTS],
                      [(n_main, TOP_K, BLOCK, npg_main, 32, 8, 128),
                       (32, TOP_K, REDUCED_BLOCK, npg_reduced, 4, 2, 16)]
                      + [(ENGINE_SLOTS, TOP_K, BLOCK, npg_main, *layout)
                         for layout in NEW_LAYOUTS])
    # Long pools (1 and 8 rows of 2048 blocks of 16, 25(e)'s keys), which
    # the paged kernel splits across blocks as the dense one.
    errs["paged_decode_attention"] = check_paged_decode(
        torch, device, [(n_main, BLOCK, npg_main, 32, 8, 128),
                        (32, REDUCED_BLOCK, npg_reduced, 4, 2, 16)]
        + [(ENGINE_SLOTS, BLOCK, npg_main, *layout) for layout in NEW_LAYOUTS]
        + [(rows, BLOCK, DECODE_CELL_S // BLOCK, 32, 8, 128) for rows in (1, 8)])
    for name, timed in time_paged_family(torch, device).items():
        fields[name] = {"max_abs_err": errs[name], **timed}
    # The scans phases 13, 14 and 9.4 drive: mamba2 (128 slots, H=80, P=64,
    # N=128) and zamba2 (8 rows, H=112, N=64) at 160 tokens, one chunk;
    # mamba2 at 2 layers over 4 x 160 and 4 x 384 (three chunks of 128);
    # the reduced models' 32 slots of 20 tokens (H=8, P=N=16, Q=4).
    mamba2_scan = (ASYNC_B * ASYNC_W, MAX_LEN, 80, 64, 128, MAX_LEN)
    zamba2_scan = (WAVE_B * WAVE_W, MAX_LEN, 112, 64, 64, MAX_LEN)
    # 24(c) trains through SSD_TRAIN_SHAPES (two chunks of 256).
    err = check_ssd(torch, device, [mamba2_scan, zamba2_scan,
                                    (4, MAX_LEN, 80, 64, 128, MAX_LEN), (4, 384, 80, 64, 128, 128),
                                    (8 * 4, REDUCED_MAX_LEN, 8, 16, 16, 4), *SSD_TRAIN_SHAPES])
    fields["ssd_scan"] = {"max_abs_err": err, **time_ssd(torch, device, mamba2_scan)}
    time_ssd(torch, device, zamba2_scan)
    fields["ssd_scan"]["train"] = [time_ssd(torch, device, shape) for shape in SSD_TRAIN_SHAPES]
    fields["ssd_scan"]["return_state_max_abs_err"] = check_ssd_state(torch, device,
                                                                     SSD_STATE_DRIVEN)
    fields["ssd_scan"]["return_state"] = [time_ssd_state(torch, device, shape)
                                          for shape in SSD_STATE_DRIVEN[:2]]
    t0 = time.perf_counter()
    bwd_errs = check_ssd_bwd(torch, device)
    fields["ssd_scan_bwd"] = {"max_abs_err": bwd_errs["float32_abs"],
                              "f32_max_err_share": bwd_errs["float32_share"],
                              "bf16_max_err_share": bwd_errs["bfloat16_share"],
                              **time_ssd_bwd(torch, device, SSD_TRAIN_SHAPES[0])}
    fields["ssd_scan_bwd"]["zamba2"] = time_ssd_bwd(torch, device, SSD_TRAIN_SHAPES[1])
    print(f"ssd_scan_bwd checked and timed in {time.perf_counter() - t0!r} s")

    phase("4. main path")
    got = main_path(torch, device)
    launches = {"tree_select": got["tree_descend"]}
    fields["tree_select"]["level_launches"] = got["tree_select"]

    phase("5. bandit tree")
    shares = bandit(torch, device)

    phase("6. single root")
    single_root(torch, device)

    phase("15. the paper's baselines (LeafP, RootP) and the random MDP")
    baselines(torch, device, shares)

    phase("16. trace mode (AsyncTickTrace) on the card")
    trace_phase(torch, device)

    phase("7. model-guided main path (KV-cached async search)")
    cfg, params = lm_setup(torch, device, LM_LAYERS, torch.bfloat16, seed=1)
    got, base = model_guided(torch, device, cfg, params)
    launches["decode_attention"] = got["decode_attention"]

    phase("8. uncached path (ModelEvaluator, wave engine)")
    launches["flash_attention"] = uncached(torch, device, cfg, params)["flash_attention"]

    phase("10. paged path (PagedCachedModelEvaluator, phase 7's cell)")
    got = paged_path(torch, device, cfg, params, base)
    launches["paged_decode_attention"] = got["paged_decode_attention"]

    phase("11. frontier path (FrontierModelEvaluator, phase 7's cell)")
    got, dense_frontier = frontier_path(torch, device, cfg, params, base)
    launches["tree_decode_attention"] = got["tree_decode_attention"]

    phase("12. paged frontier path (PagedFrontierModelEvaluator, phase 7's cell)")
    got = paged_frontier_path(torch, device, cfg, params, base, dense_frontier)
    launches["paged_tree_decode_attention"] = got["paged_tree_decode_attention"]

    cfg, params = serve_layers(torch, cfg, params)

    phase("17. host-paced serving (SearchService, phase 7's cell)")
    _, host_paced = serving_path(torch, device, cfg, params)

    phase("18. fused ring serving (SearchService, phase 7's cell)")
    serving_path(torch, device, cfg, params, fused=True, host_paced=host_paced)

    phase("19. LM serving (ServingEngine, llama3-8b)")
    lm_serving(torch, device, cfg, params)
    del params
    torch.cuda.empty_cache()

    phase("13. SSM main path (mamba2-2.7b, ModelEvaluator, phase 7's cell)")
    cfg, params = lm_setup(torch, device, SSM_LAYERS, torch.bfloat16, seed=1,
                           name="mamba2-2.7b")
    launches["ssd_scan"] = ssm_path(torch, device, cfg, params)["ssd_scan"]

    phase("20. recurrent serving (ServingEngine, mamba2-2.7b)")
    recurrent_serving(torch, device, cfg, params)
    del params
    torch.cuda.empty_cache()

    phase("14. hybrid path (zamba2-7b, ModelEvaluator, phase 8's cell)")
    cfg, params = lm_setup(torch, device, HYBRID_LAYERS, torch.bfloat16, seed=1,
                           name="zamba2-7b")
    hybrid_path(torch, device, cfg, params)

    phase("20. recurrent serving (ServingEngine, zamba2-7b)")
    recurrent_serving(torch, device, cfg, params)
    del params
    torch.cuda.empty_cache()

    phase("21. the dense configs (ServingEngine: phi3-medium-14b, qwen2.5-32b, deepseek-67b)")
    family = {"21": dense_family(torch, device)}

    phase("22. MoE (qwen2-moe-a2.7b: phase 7's cell and ServingEngine; qwen3-moe-235b-a22b)")
    family["22"] = moe_family(torch, device)

    phase("23. the stubs (llava-next-mistral-7b, whisper-small: prefill, decode, forward)")
    family["23"] = stub_family(torch, device)

    phase("24. training on the card (llama3-8b 8 of 32 layers; mamba2-2.7b, zamba2-7b 24 of 81 "
          "blocks; train_policy; the grad guard)")
    got, fields["flash_attention_bwd"]["train_step_profile"] = train_llama(torch, device)
    launches["flash_attention_bwd"] = got["flash_attention_bwd"]
    phase("24(c) mamba2-2.7b (64 blocks) and zamba2-7b (24 of 81 blocks) training")
    got, fields["ssd_scan_bwd"]["train_step_profile"] = train_ssm(torch, device)
    launches["ssd_scan_bwd"] = got["mamba2-2.7b"]["ssd_scan_bwd"]
    family["24(c) mamba2-2.7b"], family["24(c) zamba2-7b"] = got["mamba2-2.7b"], got["zamba2-7b"]
    phase("24(b) train_policy and the grad guard")
    family["24"] = train_policy_example(torch, device)
    grad_guard(torch, device)

    phase("9. agreement on the card")
    agreement_full_width(torch, device)
    agreement_reduced(torch, device)
    agreement_frontier(torch, device)
    agreement_ssm(torch, device)

    phase("17.2 and 18.2 mid-run admission against a fresh batch, the fused ring against "
          "host-paced serving (float32, 2 layers)")
    serving_parity_f32(torch, device)

    phase("19.2 ServingEngine against greedy forward decoding (float32, 2 layers)")
    lm_serving_parity_f32(torch, device)

    phase("20.2 recurrent prefill and decode against forward (float32, 2 layers)")
    agreement_recurrent_cache(torch, device)

    phase("21.2, 22.2 and 23.2 the new families against forward, qwen2-moe's router and "
          "searches against the CPU (float32, 2 layers)")
    family["21.2-23.2"] = family_parity_f32(torch, device)

    phase("24.2 one train step on the card against the CPU (float32, 2 layers)")
    train_parity_f32(torch, device)

    phase("24.3 mamba2-2.7b and zamba2-7b gradients (and a mamba2 train step) on the card "
          "against the CPU (float32, 2 layers)")
    train_parity_f32(torch, device, "mamba2-2.7b", label="24.3")
    train_parity_f32(torch, device, "zamba2-7b", with_step=False, label="24.3")

    phase("25. the multi-device layer at world size 1 (NCCL, a (1, 1) mesh): llama3-8b and "
          "mamba2-2.7b train steps placed under tp and fsdp, the expert-parallel MoE block, "
          "the search cell, the decode cell, the async engine's split slot aux")
    got, fields["decode_attention"]["decode_32k"] = multi_device(torch, device)
    family["25"] = {("tree_select" if k == "tree_descend" else k): n for k, n in got.items()}

    kernels = [{
        "name": name,
        "route": "cuda",
        "source": f"src/repro_torch/csrc/{SOURCES[name]}.cu",
        "replaces": REPLACES[name],
        "launches": launches[name],
        **fields[name],
        # Launches on the new families' paths, by phase (not the main path's).
        "family_launches": {ph: got[name] for ph, got in family.items() if got.get(name)},
        "bound_share": fields[name]["bound_ms"] / fields[name]["ms"],
        "device_bound_share": fields[name]["bound_ms"] / fields[name]["device_ms"],
    } for name in KERNELS]
    phase("done")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
