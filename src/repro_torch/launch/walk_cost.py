"""What a tree walk (``tree_descend``) must do, for its bound and its
latency floor: the bytes and operations of the paths it took, the
dependent loads on the longest path, and the latency of one dependent load
on the card (a pointer chase).  Used by ``chip_smoke.py`` phase 3 and
``python -m repro_torch.launch.descend_sweep``.
"""

from __future__ import annotations

import ctypes
import subprocess

import numpy as np
import torch

from ..kernels import _build
from .attention_sweep import SWEEP_DIR

# Statistics of a child each kind reads (N, O, V, VL; float32), and of the parent.
CHILD_STATS = {"wu_uct": 3, "uct": 2, "treep": 3, "treep_vc": 3}
PARENT_STATS = {"wu_uct": 2, "uct": 1, "treep": 1, "treep_vc": 2}
# Integer operations of one level's three threefry hashes (20 rounds of
# add, rotate, xor; key injections) and float32 operations per scored
# child (as the per-level kernel's bound counts them).
THREEFRY_OPS = 3 * (20 * 3 + 5 * 3 + 3)
SCORE_OPS = 12

_CHASE_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void chase_kernel(const uint32_t* next, uint32_t start, int steps,
                             uint32_t* out) {
  uint32_t p = start;
  for (int i = 0; i < steps; ++i) p = __ldcg(next + p);
  *out = p;
}
extern "C" int chase_launch(const uint32_t* next, uint32_t start, int steps,
                            uint32_t* out, void* stream) {
  chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(next, start, steps, out);
  return static_cast<int>(cudaGetLastError());
}
"""


def walk_work(tree, stops, kind: str) -> dict:
    """What a walk to ``stops`` must do, counted from the paths it took.

    Per node on a path: its children row (8 bytes per action), depth and
    terminal flag; per node the walk left: the parent's statistics and,
    per tried child, its pending flag and the statistics ``kind`` reads;
    per row its key (16 bytes) and stop node (8).  A stop because no
    child is valid also reads the pending flags: not counted.  Operations:
    one level's threefry draws per node, a score per scored child.
    """
    parent = tree.parent.cpu().numpy()
    kids = tree.children.cpu().numpy()
    a = kids.shape[2]
    nbytes, ops, levels = 24 * len(stops), 0, []
    for b, node in enumerate(stops.cpu().tolist()):
        path = [node]
        while path[-1] != 0:
            path.append(int(parent[b, path[-1]]))
        levels.append(len(path))
        nbytes += len(path) * (8 * a + 8 + 1)
        ops += len(path) * THREEFRY_OPS
        for left in path[1:]:
            tried = int((kids[b, left] >= 0).sum())
            nbytes += 4 * PARENT_STATS[kind] + tried * (1 + 4 * CHILD_STATS[kind])
            ops += tried * SCORE_OPS
    return {"bytes": nbytes, "ops": ops, "max_levels": max(levels),
            "mean_levels": sum(levels) / len(levels)}


def floor_loads(max_levels: int) -> int:
    """Dependent loads on the longest path: per node its children row, and
    for every node but the last the children's statistics."""
    return 2 * max_levels - 1


_CHASE = None


def chase_ns(nbytes: int, steps: int = 20000, seed: int = 0) -> float:
    """Latency of one dependent load in ns: one thread follows a random
    cycle through ``nbytes`` of device memory, one 128-byte line per step."""
    global _CHASE
    if _CHASE is None:
        where = SWEEP_DIR / "chase"
        where.mkdir(parents=True, exist_ok=True)
        (where / "chase.cu").write_text(_CHASE_SRC)
        lib = where / "libchase.so"
        subprocess.run([_build._nvcc(), *_build.COMMON_FLAGS, "-o", str(lib),
                        str(where / "chase.cu")], check=True, capture_output=True, text=True)
        fn = ctypes.CDLL(str(lib)).chase_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _CHASE = fn
    lines = nbytes // 128
    order = np.random.default_rng(seed).permutation(lines).astype(np.int64) * 32
    nxt = np.zeros(lines * 32, dtype=np.uint32)
    nxt[order] = np.roll(order, -1)
    nxt = torch.from_numpy(nxt).cuda()
    out = torch.empty(1, dtype=torch.int32, device="cuda")

    def run(start, n):
        err = _CHASE(nxt.data_ptr(), int(order[start % lines]), n, out.data_ptr(),
                     torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"chase launch failed: cudaError {err}")

    # 4 MB: a whole lap first, so every line is in L2.  1 GB: the timed
    # steps go on from where a short warm-up stopped, to lines not yet read.
    warm = lines if nbytes <= (8 << 20) else 1000
    run(0, warm)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    run(warm, steps)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e6 / steps
