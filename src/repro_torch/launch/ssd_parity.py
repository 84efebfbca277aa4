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
160), also beside ``return_state``; the backward's four gradients at the
grid and phase 24(c)'s training shapes, in both types, from a direct call
(which recomputes the states).  For bf16 B/C with more than one chunk,
and for the final state, it prints the largest difference.  At the
training shapes (8 x 512 tokens, two chunks of 256: mamba2-2.7b and
zamba2-7b) and phase 20's prefills it times both builds' forward, and the
backward at the training shapes, by CUDA-graph replay in turns (other,
shipped, shipped, other).  The card's name and power limit are printed
first.  Exits non-zero when an output that must not change differs.
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

PARITY_DIR = _build.BUILD_DIR / "parity" / "ssd"
# chip_smoke.py phase 3: SSD_GRID, then the driven shapes (b, s, h, p, n, Q).
GRID = [(2, 128, 4, 32, 16, 32), (1, 256, 2, 64, 32, 64), (1, 64, 8, 16, 64, 64),
        (2, 96, 3, 16, 8, 32), (1, 512, 4, 64, 128, 256), (1, 81, 2, 16, 8, 81),
        (2, 20, 4, 16, 16, 4), (2, 8, 3, 16, 8, 1), (1, 45, 5, 64, 64, 15),
        (2, 32, 3, 128, 256, 16), (1, 34, 9, 16, 128, 17), (1, 126, 3, 64, 8, 63),
        (2, 128, 2, 128, 64, 64), (1, 130, 11, 64, 128, 65), (1, 320, 3, 16, 256, 160),
        (1, 256, 5, 128, 256, 256), (128, 160, 13, 64, 128, 160), (96, 256, 7, 16, 64, 128),
        (2, 33, 3, 18, 12, 11)]
TRAIN = [(8, 512, 80, 64, 128, 256), (8, 512, 112, 64, 64, 256)]
DRIVEN = [(128, 160, 80, 64, 128, 160), (8, 160, 112, 64, 64, 160), (4, 160, 80, 64, 128, 160),
          (4, 384, 80, 64, 128, 128), (32, 20, 8, 16, 16, 4)] + TRAIN
PREFILLS = [(1, 128, 80, 64, 128, 128), (1, 128, 112, 64, 64, 128)]


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
    """A call of the other forward: ``(launch, y, h_final)``."""
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
    return launch, y, hout


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
    """Raises where an output that must not change differs; returns the
    printed differences of those that may."""
    gen = torch.Generator(device=device).manual_seed(48)
    notes = []
    for dtype in (torch.float32, torch.bfloat16):
        for shape in GRID + DRIVEN:
            b, s, h, p, n, q = shape
            args = _inputs(gen, shape, dtype, device)
            for return_state in (False, True):
                launch, y, hout = _other_forward(entries["ssd_scan"], shape, args, return_state)
                launch()
                got = ssd_ops.ssd_scan(*args, chunk=q, return_state=return_state)
                got_y, got_h = got if return_state else (got, None)
                what = f"forward {dtype} {shape} return_state={return_state}"
                if dtype == torch.float32 or s == q:
                    if not torch.equal(got_y, y):
                        raise AssertionError(f"{what}: y differs from the other build")
                else:
                    notes.append((what, "y", float((got_y - y).abs().max())))
                if return_state and dtype == torch.float32 and not torch.equal(got_h, hout):
                    raise AssertionError(f"{what}: the final state differs")
                if return_state and dtype == torch.bfloat16:
                    notes.append((what, "final state", float((got_h - hout).abs().max())))
            if shape in GRID + TRAIN:
                dy = torch.randn((b, s, h, p), generator=gen, device=device)
                launch, grads = _other_backward(entries, shape, args, dy)
                launch()
                got = ssd_scan_bwd(*args, dy, chunk=q)
                if not all(torch.equal(a, c) for a, c in zip(got, grads)):
                    raise AssertionError(f"backward {dtype} {shape}: the gradients differ")
    return notes


def times(entries, device) -> list:
    """Device µs of the other and the shipped build in turns (bf16 B/C)."""
    gen = torch.Generator(device=device).manual_seed(49)
    rows = []
    for shape, return_state in [(s, False) for s in TRAIN] + [(s, True) for s in PREFILLS]:
        b, s, h, p, n, q = shape
        args = _inputs(gen, shape, torch.bfloat16, device)
        other, _, _ = _other_forward(entries["ssd_scan"], shape, args, return_state)
        shipped = lambda: ssd_ops.ssd_scan(*args, chunk=q, return_state=return_state)
        rows.append((f"forward {shape} return_state={return_state}",
                     [(name, graph_ms(fn, calls=10) * 1e3) for name, fn in
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
          f"at one chunk (with and without return_state), the float32 final state, the "
          f"backward's gradients in both types; {len(GRID)} grid shapes, {len(DRIVEN)} driven")
    worst = {}
    for _, out, diff in notes:
        worst[out] = max(worst.get(out, 0.0), diff)
    print(f"bf16 B/C with more than one chunk, and the final state, max |shipped - other|: "
          f"{worst}")
    for what, row in times(entries, device):
        print(f"{what}, device us by graph replay: "
              + ", ".join(f"{name} {us!r}" for name, us in row))


if __name__ == "__main__":
    main()
