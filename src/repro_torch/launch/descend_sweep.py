"""Time the tree walk (``tree_descend``) and its variants on one GPU, and
count the host's aten ops of a search.

    PYTHONPATH=src python -m repro_torch.launch.descend_sweep
    PYTHONPATH=src python -m repro_torch.launch.descend_sweep --count-ops [--device cpu]

On the trees of a search in progress (the tap game 6x6 of
``chip_smoke.py`` phase 4, B=256, after two waves of W=16 and a third
selection whose expansions are pending; the bandit tree d=6, A=4,
B=1024, likewise), it prints the device time of one walk by CUDA-graph
replay for the shipped kernel and its variants: trees (warps) per block
1, 2, 8 (shipped: 4); the threefry draws made by every lane instead of by
lane 0; the argmax as a butterfly of shuffles instead of two warp
reductions; the scoring loop unrolled to two children per pass.  Each
variant is a copy of ``csrc/tree_select.cu`` with the shipped code text
replaced, built by ``nvcc`` with the kernel's own flags into
``build/repro_torch/sweep/``, and its stop nodes must equal the plain
version's.  The shipped walk is also cut to 1-3 levels (``max_depth``
0-2): the time a level adds.  Beside them: the levels walked, the bytes a
walk must read, and the latency floor, levels x dependent loads x the
latency of one load, which a pointer chase measures over 4 MB (in L2) and
1 GB (device memory) (:mod:`.walk_cost`).  The card's name and power
limit are printed first.

``--count-ops`` counts the aten ops that phase 4's search (tap 6x6,
B=256, W=16, T=128, the second call) dispatches from the host: all of
them, those inside the traversal (``tree_descend``; on the CPU its plain
version, the lockstep loop) and those inside threefry hashes
(``rng.threefry2x32``).  On the card each is at least one kernel launch.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import shutil
import subprocess
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .. import rng
from ..core import SearchSpec, build_searcher
from ..core.api import resolve_device
from ..core.batched_search import mid_search_trees, walk_inputs
from ..envs import make_bandit_tree, make_tap_game
from ..kernels import _build
from ..kernels.tree_select import ops as tree_ops
from ..kernels.tree_select.ref import KINDS, tree_descend_ref
from .attention_sweep import SWEEP_DIR, graph_ms
from .walk_cost import chase_ns, floor_loads, walk_work

# Phase 4's cell and phase 5's bandit tree.
TAP_SPEC = dict(batch=256, num_simulations=128, wave_size=16, max_depth=10, max_width=5,
                max_sim_steps=20)
BANDIT_SPEC = dict(batch=1024, num_simulations=128, wave_size=16, max_depth=6,
                   max_sim_steps=6, max_width=4, gamma=1.0)
# The shipped code each variant replaces, and what with.
_WARPS = "constexpr int kDescendWarps = 4;"
_DRAW_LANE0 = """    bool coin = false;
    if ((threadIdx.x & 31) == 0) {
      coin = coin_of(coin_key, expand_coin);
      coin_key = threefry2x32(next_key, 0u, 1u);
      next_key = threefry2x32(next_key, 0u, 0u);
    }
    return __shfl_sync(kFull, coin, 0);"""
_DRAW_EVERY_LANE = """    const bool coin = coin_of(coin_key, expand_coin);
    coin_key = threefry2x32(next_key, 0u, 1u);
    next_key = threefry2x32(next_key, 0u, 0u);
    return coin;"""
_REDUX = """  const uint32_t key = order_key(best);
  const uint32_t top = __reduce_max_sync(kFull, key);
  idx = static_cast<int>(__reduce_min_sync(
      kFull, key == top ? static_cast<uint32_t>(idx) : 0xffffffffu));
  best = __shfl_sync(kFull, best, idx & 31);"""
_BUTTERFLY = """#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(kFull, best, off);
    const int oi = __shfl_xor_sync(kFull, idx, off);
    if (ob > best || (ob == best && oi < idx)) {
      best = ob;
      idx = oi;
    }
  }"""
_SCORE_LOOP = """  for (int a = lane; a < A; a += 32) {
    const Child c = load(a);"""
VARIANTS = {
    **{f"{w} tree{'s' if w > 1 else ''} per block": [(_WARPS, _WARPS.replace("4", str(w)))]
       for w in (1, 2, 8)},
    "every lane draws": [(_DRAW_LANE0, _DRAW_EVERY_LANE)],
    "butterfly argmax": [(_REDUX, _BUTTERFLY)],
    "two children per pass": [(_SCORE_LOOP, "#pragma unroll 2\n" + _SCORE_LOOP)],
}


def _build_variants():
    jobs = {}
    for name, subs in VARIANTS.items():
        where = SWEEP_DIR / ("walk_" + name.replace(" ", "_"))
        shutil.rmtree(where, ignore_errors=True)
        shutil.copytree(_build.CSRC, where)
        text = (where / "tree_select.cu").read_text()
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        (where / "tree_select.cu").write_text(text)
        lib = where / "libtree_select.so"
        cmd = [_build._nvcc(), *_build.nvcc_flags("tree_select"), "-o", str(lib),
               str(where / "tree_select.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), lib)
    libs = {"shipped, 4 trees per block": _build.load("tree_select")}
    for name, (proc, lib) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def _walks(device):
    """(name, tree, tensors, keys, params) of the swept walks."""
    out = []
    for name, make_env, fields in (("tap 6x6 B=256", lambda: make_tap_game(6, 4, goal_count=10,
                                                                           step_budget=20),
                                    TAP_SPEC),
                                   ("bandit d=6 B=1024", lambda: make_bandit_tree(6, 4),
                                    BANDIT_SPEC)):
        env = make_env()
        b = fields["batch"]
        cfg = SearchSpec(**fields).config
        roots = env.init(rng.split(rng.PRNGKey(0, device=device), b))
        tree = mid_search_trees(env, cfg, roots, rng.split(rng.PRNGKey(1, device=device), b),
                                waves=2)[-1]
        tensors, params = walk_inputs(tree, cfg)
        keys = rng.split(rng.PRNGKey(2, device=device), b)
        out.append((name, tree, tensors, keys, params))
    return out


class OpCount(TorchDispatchMode):
    """Counts the aten ops dispatched under it by the regions the host is
    in: ``traversal`` under a call of ``tree_descend``, ``threefry`` under
    ``rng.threefry2x32``.  The regions are found on the Python stack by the
    functions' code, so a call counts whatever name its caller knows."""

    REGIONS = {tree_ops.tree_descend.__code__: "traversal",
               rng.threefry2x32.__code__: "threefry"}

    def __init__(self):
        super().__init__()
        self.counts: collections.Counter = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        regions, frame = set(), sys._getframe(1)
        while frame is not None:
            region = self.REGIONS.get(frame.f_code)
            if region:
                regions.add(region)
            frame = frame.f_back
        self.counts[frozenset(regions)] += 1
        return func(*args, **(kwargs or {}))


def count_ops(env, spec: SearchSpec, device) -> dict:
    """Aten ops of ``spec``'s batched search's second call on ``device``:
    ``total``, ``traversal``, ``threefry`` and ``threefry_outside`` (the
    threefry ops outside the traversal)."""
    roots = env.init(rng.split(rng.PRNGKey(0, device=device), spec.batch))
    rngs = rng.split(rng.PRNGKey(1, device=device), spec.batch)
    search = build_searcher(env, spec, device=device)
    search(roots, rngs)             # warm-up: builds the kernels
    with OpCount() as mode:
        search(roots, rngs)
    counts = mode.counts
    return {"total": sum(counts.values()),
            "traversal": sum(n for k, n in counts.items() if "traversal" in k),
            "threefry": sum(n for k, n in counts.items() if "threefry" in k),
            "threefry_outside": counts[frozenset({"threefry"})]}


def _print_op_counts(spec: SearchSpec, device) -> None:
    c = count_ops(make_tap_game(6, 4, goal_count=10, step_budget=20), spec, device)
    total = c["total"]
    print(f"aten ops of one tap 6x6 call (B={spec.batch}, W={spec.wave_size}, "
          f"T={spec.num_simulations}) on {device}: {total}; in the traversal "
          f"{c['traversal']} ({c['traversal'] / total!r}); in threefry hashes "
          f"{c['threefry']} ({c['threefry'] / total!r}), {c['threefry_outside']} of them "
          f"outside the traversal ({c['threefry_outside'] / total!r})")


def _sweep() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("descend_sweep needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"card: {card}")
    device = torch.device("cuda", 0)
    libs = _build_variants()
    l2_ns, dram_ns = chase_ns(4 << 20), chase_ns(1 << 30)
    print(f"dependent-load latency (pointer chase, ld.global.cg): 4 MB {l2_ns!r} ns, "
          f"1 GB {dram_ns!r} ns")
    for name, tree, tensors, keys, params in _walks(device):
        ref = tree_descend_ref(*tensors, keys, **params)
        work = walk_work(tree, ref, params["kind"])
        loads = floor_loads(work["max_levels"])
        print(f"-- walk {name} {params['kind']}: levels max {work['max_levels']} mean "
              f"{work['mean_levels']!r}; {work['bytes']} bytes "
              f"({work['bytes'] / 3.35e12 * 1e6!r} us at 3.35 TB/s), {work['ops']} operations; "
              f"latency floor {loads} loads x {l2_ns!r} ns = {loads * l2_ns * 1e-3!r} us")
        b, m, a = tensors[0].shape
        # The shipped walk cut to 1, 2, 3 levels: the time each level adds.
        for cut in (0, 1, 2):
            p = dict(params, max_depth=cut)
            call = lambda: tree_ops.tree_descend(*tensors, keys, **p)
            levels = walk_work(tree, tree_descend_ref(*tensors, keys, **p),
                               p["kind"])["max_levels"]
            print(f"shipped wrapper, max_depth {cut} (at most {levels} levels): "
                  f"{graph_ms(call) * 1e3!r} us")
        out = torch.empty_like(ref)
        for _ in range(2):          # two rounds: the spread between them is the noise
            for lib_name, lib in libs.items():
                fn = lib.tree_descend_launch
                fn.argtypes = tree_ops._descend_launcher().argtypes
                fn.restype = ctypes.c_int

                def call():
                    err = fn(*(t.data_ptr() for t in tensors), keys.data_ptr(),
                             out.data_ptr(), b, m, a, keys.stride(0), params["width"],
                             params["max_depth"], params["expand_coin"],
                             KINDS.index(params["kind"]), params["beta"], params["r_vl"],
                             params["n_vl"], device.index,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"tree_descend launch failed: cudaError {err}")
                ms = graph_ms(call)
                same = bool(torch.equal(out, ref))
                print(f"{lib_name}: {ms * 1e3!r} us "
                      f"(stop nodes equal the plain version's: {same})")
                if not same:
                    raise AssertionError(f"{lib_name} differs from the plain version")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--count-ops", action="store_true",
                    help="count the aten ops of phase 4's search instead of timing walks")
    ap.add_argument("--device", default="cuda", help="--count-ops: torch device")
    ap.add_argument("--batch", type=int, default=TAP_SPEC["batch"], help="--count-ops: B")
    args = ap.parse_args(argv)
    if args.count_ops:
        spec = SearchSpec(**dict(TAP_SPEC, batch=args.batch))
        _print_op_counts(spec, resolve_device(args.device))
    else:
        _sweep()


if __name__ == "__main__":
    main()
