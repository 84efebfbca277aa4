"""Hold the SSD scan kernels against another build of their sources on one
GPU: what must not have changed bit for bit, what did change as a
difference, and both builds' device times side by side.

    git archive <commit> src/repro_torch/csrc | tar -x -C build/other
    PYTHONPATH=src python -m repro_torch.launch.ssd_parity build/other/src/repro_torch/csrc

The other ``csrc/`` directory (for example a parent commit's) is built by
``nvcc`` with the shipped libraries' own flags into
``build/repro_torch/parity/ssd/``; its C entry points are read with or
without the forward's ``states`` and the backward's ``hs_given`` argument,
as its source declares them.  On ``chip_smoke.py`` phase 3's scan grid and
driven shapes it requires, bit for bit: the forward's ``y`` with float32
B/C, and with bf16 B/C at one chunk (phases 13 and 14 run one chunk of
160; the Hopper chunk kernel sums its products in the mma.sync body's
order), also beside ``return_state``; with bf16 B/C the states entering
the chunks (``keep_states``) and the final state, in both types; the
backward's four gradients at the grid and phase 24(c)'s training shapes,
in both types, from a direct call (which recomputes the states).  With
bf16 B/C and more than one chunk, where the carried-state term now starts
the chunk kernel's accumulators instead of being added to y by the state
kernel, ``y`` may differ: it prints the largest difference and requires
it within ``chip_smoke.SSD_TOL`` of the other build's ``y``.  At phase 13's
and phase 14's scans (one chunk of 160), the training shapes (8 x 512
tokens, two chunks of 256: mamba2-2.7b and zamba2-7b) and phase 20's
prefills it times both builds' forward, and the backward at the training
shapes, by CUDA-graph replay in turns (other, shipped, shipped, other),
and the device µs of each kernel of both builds under torch.profiler; at
phase 13's shape also the paced eager call (CUDA events over back-to-back
calls).  The card's name and power limit are printed first.  Exits
non-zero when an output that must not change differs.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

from ..kernels import _build
from ..kernels.ssd_scan import ops as ssd_ops
from ..kernels.ssd_scan import ssd_scan_bwd
from .attention_sweep import _ok, graph_ms
from .ssd_bwd_sweep import _by_kernel

PARITY_DIR = _build.BUILD_DIR / "parity" / "ssd"
# chip_smoke.py phase 3: SSD_GRID, then the driven shapes (b, s, h, p, n, Q).
GRID = [(2, 128, 4, 32, 16, 32), (1, 256, 2, 64, 32, 64), (1, 64, 8, 16, 64, 64),
        (2, 96, 3, 16, 8, 32), (1, 512, 4, 64, 128, 256), (1, 81, 2, 16, 8, 81),
        (2, 20, 4, 16, 16, 4), (2, 8, 3, 16, 8, 1), (1, 45, 5, 64, 64, 15),
        (2, 32, 3, 128, 256, 16), (1, 34, 9, 16, 128, 17), (1, 126, 3, 64, 8, 63),
        (2, 128, 2, 128, 64, 64), (1, 130, 11, 64, 128, 65), (1, 320, 3, 16, 256, 160),
        (1, 256, 5, 128, 256, 256), (128, 160, 13, 64, 128, 160), (96, 256, 7, 16, 64, 128),
        (2, 33, 3, 18, 12, 11), (16, 160, 20, 64, 128, 160)]
TRAIN = [(8, 512, 80, 64, 128, 256), (8, 512, 112, 64, 64, 256)]
DRIVEN = [(128, 160, 80, 64, 128, 160), (8, 160, 112, 64, 64, 160), (4, 160, 80, 64, 128, 160),
          (4, 384, 80, 64, 128, 128), (32, 20, 8, 16, 16, 4)] + TRAIN
PREFILLS = [(1, 128, 80, 64, 128, 128), (1, 128, 112, 64, 64, 128)]
PHASES = [(128, 160, 80, 64, 128, 160), (8, 160, 112, 64, 64, 160)]
# chip_smoke.SSD_TOL: how far bf16 y may move from the other build's.
SSD_TOL = dict(atol=1e-4, rtol=1e-4)


def _build_other(csrc: Path) -> dict:
    """The other ``ssd_scan`` and ``ssd_scan_bwd`` libraries' entry points,
    each with whether it takes the newer argument (``states``,
    ``hs_given``)."""
    PARITY_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("ssd_scan", "ssd_scan_bwd"):
        lib = PARITY_DIR / f"lib{name}.so"
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.nvcc_flags(name), "-o", str(lib), str(csrc / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    entries = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the other {name}:\n{log}")
        text = (csrc / f"{name}.cu").read_text()
        fn = getattr(ctypes.CDLL(str(lib)), f"{name}_launch")
        if name == "ssd_scan":
            newer = "float* hout, float* states" in text
            fn.argtypes = [ctypes.c_void_p] * (7 if newer else 6) + [ctypes.c_int] * 8 + [
                ctypes.c_void_p]
        else:
            newer = "int hs_given" in text
            fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * (9 if newer else 8) + [
                ctypes.c_void_p]
            scratch = ctypes.CDLL(str(lib)).ssd_scan_bwd_scratch_floats
            scratch.argtypes = [ctypes.c_int] * 8
            scratch.restype = ctypes.c_longlong
            entries["bwd_scratch"] = scratch
        fn.restype = ctypes.c_int
        entries[name] = (fn, newer)
    return entries


def _inputs(gen, shape, dtype, device):
    b, s, h, p, n, _ = shape
    xdt = torch.randn((b, s, h, p), generator=gen, device=device) * 0.3
    dA = -F.softplus(torch.randn((b, s, h), generator=gen, device=device))
    bm, cm = ((torch.randn((b, s, n), generator=gen, device=device) * 0.3).to(dtype)
              for _ in range(2))
    return xdt, dA, bm, cm


def _other_forward(entry, shape, args, return_state):
    """A call of the other forward: ``(launch, y, h_final, states)``
    (``states`` None where the other source takes none)."""
    fn, newer = entry
    b, s, h, p, n, q = shape
    xdt, dA, bm, cm = args
    y = torch.empty_like(xdt)
    f32 = dict(dtype=torch.float32, device=xdt.device)
    hout = torch.empty((b, h, p, n), **f32) if return_state else None
    states = [torch.empty((b, s // q, h, p, n), **f32)] if newer else []
    launch = lambda: _ok(fn(xdt.data_ptr(), dA.data_ptr(), bm.data_ptr(), cm.data_ptr(),
                            y.data_ptr(), hout.data_ptr() if return_state else None,
                            *(x.data_ptr() for x in states), b, s, h, p, n, q,
                            ssd_ops._DTYPES[bm.dtype], xdt.device.index,
                            torch.cuda.current_stream().cuda_stream))
    return launch, y, hout, (states[0] if states else None)


def _other_backward(entries, shape, args, dy):
    """A call of the other backward (the states recomputed): ``(launch,
    grads)``."""
    fn, newer = entries["ssd_scan_bwd"]
    b, s, h, p, n, q = shape
    xdt, dA, bm, cm = args
    dtype = ssd_ops._DTYPES[bm.dtype]
    f32 = dict(dtype=torch.float32, device=xdt.device)
    grads = [torch.empty_like(x) for x in args]
    states = [torch.empty((b, s // q, h, p, n), **f32) for _ in range(2)]
    scratch = torch.empty(entries["bwd_scratch"](b, s, h, p, n, q, dtype, xdt.device.index),
                          **f32)
    launch = lambda: _ok(fn(*(x.data_ptr() for x in (*args, dy, *grads, *states, scratch)),
                            b, s, h, p, n, q, *([0] if newer else []), dtype,
                            xdt.device.index, torch.cuda.current_stream().cuda_stream))
    return launch, grads


def parity(entries, device) -> list:
    """Raises where an output that must not change differs, or where bf16
    ``y`` moved beyond SSD_TOL; returns the printed differences of the
    outputs that may move."""
    gen = torch.Generator(device=device).manual_seed(48)
    notes = []
    for dtype in (torch.float32, torch.bfloat16):
        for shape in GRID + DRIVEN:
            b, s, h, p, n, q = shape
            args = _inputs(gen, shape, dtype, device)
            for return_state in (False, True):
                launch, y, hout, states = _other_forward(entries["ssd_scan"], shape, args,
                                                         return_state)
                launch()
                got = ssd_ops._forward(*args, chunk=q, return_state=return_state,
                                       keep_states=True)
                got_y, got_h, got_states = got if return_state else (got[0], None, got[1])
                what = f"forward {dtype} {shape} return_state={return_state}"
                if dtype == torch.float32 or s == q:
                    if not torch.equal(got_y, y):
                        raise AssertionError(f"{what}: y differs from the other build")
                else:
                    diff = (got_y - y).abs()
                    if bool((diff > SSD_TOL["atol"] + SSD_TOL["rtol"] * y.abs()).any()):
                        raise AssertionError(f"{what}: y moved by up to {float(diff.max())!r} "
                                             f"from the other build's, beyond {SSD_TOL}")
                    notes.append((what, "y", float(diff.max())))
                if return_state and not torch.equal(got_h, hout):
                    raise AssertionError(f"{what}: the final state differs")
                if got_states is not None and states is not None and \
                        not torch.equal(got_states[:, 1:], states[:, 1:]):
                    raise AssertionError(f"{what}: the states entering the chunks differ")
            if shape in GRID + TRAIN:
                dy = torch.randn((b, s, h, p), generator=gen, device=device)
                launch, grads = _other_backward(entries, shape, args, dy)
                launch()
                got = ssd_scan_bwd(*args, dy, chunk=q)
                if not all(torch.equal(a, c) for a, c in zip(got, grads)):
                    raise AssertionError(f"backward {dtype} {shape}: the gradients differ")
    return notes


def _paced_us(fn, calls=20):
    """Host-paced µs of one eager ``fn()``: CUDA events over back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / calls


def times(entries, device) -> list:
    """Device µs of the other and the shipped build in turns (bf16 B/C),
    and each build's device µs by kernel."""
    gen = torch.Generator(device=device).manual_seed(49)
    rows = []
    for shape, return_state in ([(s, False) for s in PHASES + TRAIN]
                                + [(s, True) for s in PREFILLS]):
        b, s, h, p, n, q = shape
        args = _inputs(gen, shape, torch.bfloat16, device)
        other, _, _, _ = _other_forward(entries["ssd_scan"], shape, args, return_state)
        shipped = lambda: ssd_ops.ssd_scan(*args, chunk=q, return_state=return_state)
        rows.append((f"forward {shape} return_state={return_state}",
                     [(name, graph_ms(fn, calls=10) * 1e3) for name, fn in
                      (("other", other), ("shipped", shipped), ("shipped", shipped),
                       ("other", other))]))
        rows.append((f"forward {shape} return_state={return_state}, profiled by kernel",
                     [("other", _by_kernel(other)), ("shipped", _by_kernel(shipped))]))
        if shape == PHASES[0]:
            rows.append((f"forward {shape}, paced eager call",
                         [(name, _paced_us(fn)) for name, fn in
                          (("other", other), ("shipped", shipped), ("shipped", shipped),
                           ("other", other))]))
        if not return_state:
            dy = torch.randn((b, s, h, p), generator=gen, device=device)
            other_bwd, _ = _other_backward(entries, shape, args, dy)
            shipped_bwd = lambda: ssd_scan_bwd(*args, dy, chunk=q)
            rows.append((f"backward {shape}",
                         [(name, graph_ms(fn, calls=5) * 1e3) for name, fn in
                          (("other", other_bwd), ("shipped", shipped_bwd),
                           ("shipped", shipped_bwd), ("other", other_bwd))]))
    return rows


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("csrc", type=Path, help="the other build's csrc/ directory")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ssd_parity needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"card: {card}")
    device = torch.device("cuda", 0)
    entries = _build_other(args.csrc)
    notes = parity(entries, device)
    print(f"bit-equal to the other build: the forward's y with float32 B/C and with bf16 B/C "
          f"at one chunk (with and without return_state), the final state and the states "
          f"entering the chunks, the backward's gradients in both types; {len(GRID)} grid "
          f"shapes, {len(DRIVEN)} driven")
    worst = 0.0
    for what, _, diff in notes:
        print(f"{what}: bf16 y max |shipped - other| {diff!r}")
        worst = max(worst, diff)
    print(f"bf16 y with more than one chunk: max |shipped - other| {worst!r} over "
          f"{len(notes)} calls, each within {SSD_TOL}")
    for what, row in times(entries, device):
        print(f"{what}: " + ", ".join(f"{name} {us!r}" for name, us in row))


if __name__ == "__main__":
    main()
