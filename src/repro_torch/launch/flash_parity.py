"""Hold the flash-attention kernels against another build of their sources
on one GPU, and time both beside SDPA.

    git archive <commit> src/repro_torch/csrc | tar -x -C build/other
    PYTHONPATH=src python -m repro_torch.launch.flash_parity build/other/src/repro_torch/csrc

The other ``csrc/`` directory (for example a parent commit's) is built by
``nvcc`` with the shipped libraries' own flags into
``build/repro_torch/parity/``.  The card's name and power limit are printed
first, then the registers and spills of the shipped bf16 kernels (ptxas).

* Forward, on the shapes ``chip_smoke.py`` phase 3 runs it at (its grid of
  ``check_flash`` and the shapes of ``check_flash_bwd``), with and without
  ``lse``: in float32 the shipped ``out`` and ``lse`` must equal the other
  build's bit for bit; in bf16 both builds' ``out`` must lie within
  ``chip_smoke.ATTN_TOL["bfloat16"]`` of the plain version (the bodies may
  group their sums differently), and the largest difference between the
  builds is printed in bf16 ulps, with the shapes that differ.  The
  shipped ``lse`` must stay within the float32 bar of the plain version.
* Times, device µs by CUDA-graph replay in turns (other, shipped, shipped,
  other): the bf16 forward at phase 8's shape (8 × 160 tokens, 32/8
  heads, D=128), phase 14's (32/32, D=112) and 24(a)'s (8 × 512, 32/8,
  D=128), with SDPA's graph-replayed time; the bf16 backward at 24(a)'s
  shape and at 32/32, D=112, with SDPA's backward as the summed device
  time of its profiled kernels.  Each row gives the bound (bytes at 3.35
  TB/s or flops at 989 TFLOP/s, the larger) and whether the shipped build
  reached SDPA.
* Host cost at phase 8's forward and 24(a)'s backward: µs of host time a
  call (enqueuing 200 back-to-back calls, fewer than the launch queue
  holds, so none waits on the device) of the other build's C entry, the
  shipped one (which encodes its TMA tensor maps) and the shipped wrapper,
  in turns; then the wrapper's and SDPA's host-paced µs (200 eager calls
  over their wall time to the last one's end).

Exits non-zero when an output breaks its bar or a float32 output differs.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import re
import subprocess
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from ..kernels import _build
from ..kernels.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_lse_ref,
    flash_attention_ref,
)
from ..kernels.flash_attention import ops as flash_ops
from .attention_sweep import _ok, graph_ms

PARITY_DIR = _build.BUILD_DIR / "parity"
# chip_smoke.py phase 3: check_flash's grid, then check_flash_bwd's shapes
# (B, S, Hq, Hkv, D, causal), then check_flash's G = 71 shapes.
FORWARD_SHAPES = (
    [(b, s, hq, hkv, d, True) for b in (1, 8) for s in (1, 7, 160, 1024)
     for hq, hkv in ((32, 8), (8, 8), (4, 1)) for d in (64, 128)]
    + [(b, s, 32, 32, 112, True) for b in (1, 8) for s in (1, 7, 160, 1024)]
    + [(8, 512, 32, 8, 128, True), (2, 160, 8, 2, 64, True), (2, 160, 32, 32, 112, True),
       (1, 33, 4, 1, 16, True), (2, 7, 8, 8, 64, True), (2, 100, 8, 2, 128, False),
       (2, 96, 16, 2, 32, True), (2, 100, 40, 8, 128, True), (2, 96, 16, 1, 64, True),
       (1, 60, 71, 1, 64, True)]
    + [(1, s, 71, 1, 64, True) for s in (7, 160)])
# chip_smoke.ATTN_TOL: (atol, rtol) of |out - plain| <= atol + rtol |plain|.
BF16_TOL = (1e-5, 2.0 ** -7)
F32_LSE_TOL = (5e-5, 5e-5)
# (B, S, Hq, Hkv, D): phase 8, phase 14, 24(a); the backward at 24(a)'s
# shape and at zamba2's shared block (24(c)).
TIMED_FORWARD = ((8, 160, 32, 8, 128), (8, 160, 32, 32, 112), (8, 512, 32, 8, 128))
TIMED_BACKWARD = ((8, 512, 32, 8, 128), (8, 512, 32, 32, 112))
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12


def _entry(lib, name):
    fn = getattr(lib, f"{name}_launch")
    n_ptrs = 5 if name == "flash_attention" else 10
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _build_other(csrc: Path) -> dict:
    """The other ``flash_attention`` and ``flash_attention_bwd`` libraries'
    C entry points."""
    PARITY_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("flash_attention", "flash_attention_bwd"):
        lib = PARITY_DIR / f"lib{name}.so"
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.nvcc_flags(name), "-o", str(lib), str(csrc / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    entries = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the other {name}:\n{log}")
        entries[name] = _entry(ctypes.CDLL(str(lib)), name)
    return entries


def _ptxas(names=("flash_attention", "flash_attention_bwd"), keep=("wgmma",)):
    """Registers and spills of the shipped kernels whose names hold one of
    ``keep``, from a fresh build's ``-Xptxas=-v`` log."""
    lines = []
    for name in names:
        path = _build.library_path(name)
        if path.exists() and name not in _build.BUILD_LOGS:
            path.unlink()                     # rebuilt for its log
        _build.build([name])
        kernel = spill = None
        for line in _build.BUILD_LOGS[name].splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1]
            elif "spill stores" in line:
                spill = line.strip()
            elif "Used" in line and "registers" in line and kernel:
                if any(k in kernel for k in keep):
                    regs = re.search(r"Used (\d+) registers", line).group(1)
                    lines.append(f"{name} {kernel}: {regs} registers; {spill}")
                kernel = spill = None
    return lines


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance between two bf16 tensors in units in the last place."""
    def ordered(x):
        bits = x.contiguous().view(torch.int16).int()
        mag = bits & 0x7FFF
        return torch.where(bits < 0, -mag, mag)
    return int((ordered(a) - ordered(b)).abs().max())


def _outside(out, ref, tol):
    diff = (out.float() - ref.float()).abs()
    return int((diff > tol[0] + tol[1] * ref.float().abs()).sum())


def forward_parity(fwd, device) -> tuple[int, int, list]:
    """Calls of the shipped forward held against the other build: float32
    bit for bit, bf16 both within the bar of the plain version.  Returns
    the calls, the largest bf16 distance between the builds in ulps and the
    bf16 shapes where they differ; raises at the first break."""
    gen = torch.Generator(device=device).manual_seed(12)
    stream = torch.cuda.current_stream().cuda_stream
    calls, worst, differ = 0, 0, []
    for dtype in (torch.float32, torch.bfloat16):
        for b, s, hq, hkv, d, causal in FORWARD_SHAPES:
            q, k, v = (torch.randn(shape, generator=gen, device=device).to(dtype)
                       for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
            ref = flash_attention_ref(q, k, v, causal=causal) if dtype == torch.bfloat16 else None
            for with_lse in (False, True):
                out, lse = flash_ops._forward(q, k, v, causal, with_lse)
                other = torch.empty_like(out)
                other_lse = torch.empty_like(lse) if with_lse else None
                _ok(fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), other.data_ptr(),
                        other_lse.data_ptr() if with_lse else None, b, s, s, hq, hkv, d,
                        int(causal), 1.0 / math.sqrt(d), flash_ops._DTYPES[dtype],
                        device.index, stream))
                what = f"forward {dtype} {(b, s, hq, hkv, d, causal)} with_lse={with_lse}"
                if dtype == torch.float32:
                    if not torch.equal(out, other) or (with_lse and not torch.equal(lse, other_lse)):
                        raise AssertionError(f"{what}: differs from the other build")
                else:
                    for name, x in (("shipped", out), ("other", other)):
                        bad = _outside(x, ref, BF16_TOL)
                        if bad:
                            raise AssertionError(f"{what}: {bad} of the {name} build's outputs "
                                                 f"outside the bf16 bar")
                    if with_lse:
                        lse_ref = flash_attention_lse_ref(q, k, causal=causal)
                        if _outside(lse, lse_ref, F32_LSE_TOL):
                            raise AssertionError(f"{what}: lse outside the float32 bar")
                    ulps = _ulps(out, other)
                    if ulps and not with_lse:
                        differ.append(((b, s, hq, hkv, d, causal), ulps))
                    worst = max(worst, ulps)
                calls += 1
    return calls, worst, differ


def _bound_us(nbytes, ops):
    times = {"bytes": nbytes / HBM_BYTES_PER_S, "operations": ops / BF16_OPS_PER_S}
    by = max(times, key=times.get)
    return times[by] * 1e6, by


def _profiled_us(fn, calls=10):
    """Device µs of one ``fn()``: its kernels' profiled device time summed
    (for work a CUDA graph cannot capture, as autograd's backward)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = sum(evt.duration_ns() for evt in prof.profiler.kineto_results.events()
                if evt.device_type() == torch.autograd.DeviceType.CUDA)
    return total * 1e-3 / calls


def _turns(other, shipped, calls):
    return [(name, graph_ms(fn, calls=calls) * 1e3)
            for name, fn in (("other", other), ("shipped", shipped),
                             ("shipped", shipped), ("other", other))]


def _row(what, times, sdpa_us, bound):
    shipped = [us for name, us in times if name == "shipped"]
    others = [us for name, us in times if name == "other"]
    spread = max(max(shipped) - min(shipped), max(others) - min(others))
    print(f"{what}: " + ", ".join(f"{name} {us!r}" for name, us in times)
          + f"; SDPA {sdpa_us!r}; bound {bound[0]!r} us by {bound[1]}; shipped "
          + ("reached" if min(shipped) <= sdpa_us else "did not reach")
          + f" SDPA; shipped - other {min(shipped) - min(others)!r} us (spread {spread!r})")


def forward_times(fwd, device, b, s, hq, hkv, d) -> None:
    """The bf16 forward of both builds in turns and SDPA, device µs."""
    gen = torch.Generator(device=device).manual_seed(14)
    q, k, v = (torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
               for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    out = torch.empty_like(q)
    other = lambda: _ok(fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None,
                            b, s, s, hq, hkv, d, 1, 1.0 / math.sqrt(d), 1, device.index,
                            torch.cuda.current_stream().cuda_stream))
    times = _turns(other, lambda: flash_attention(q, k, v), 50)
    qs, ks, vs = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    sdpa = graph_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                                           enable_gqa=True)) * 1e3
    nbytes = 2 * (2 * b * s * hq * d + 2 * b * s * hkv * d)
    ops = 4 * d * (s * (s + 1) // 2) * b * hq
    _row(f"forward bf16 B={b} S={s} {hq}/{hkv} D={d} causal, device us", times, sdpa,
         _bound_us(nbytes, ops))


def backward_times(bwd, device, b, s, hq, hkv, d) -> None:
    """The bf16 backward of both builds in turns and SDPA's, device µs."""
    gen = torch.Generator(device=device).manual_seed(16)
    q, k, v, dout = (torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
                     for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, hq, d)))
    out, lse = flash_ops._forward(q, k, v, True, with_lse=True)
    grads = [torch.empty_like(x) for x in (q, k, v)]
    delta = torch.empty((b, hq, s), dtype=torch.float32, device=device)
    other = lambda: _ok(bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                            *(x.data_ptr() for x in grads), b, s, s, hq, hkv, d, 1,
                            1.0 / math.sqrt(d), 1, device.index,
                            torch.cuda.current_stream().cuda_stream))

    times = _turns(other, lambda: flash_attention_bwd(q, k, v, out, dout, lse), 10)
    qs, ks, vs = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)
    dout_t = dout.transpose(1, 2)
    sdpa = _profiled_us(lambda: torch.autograd.grad(lib_out, (qs, ks, vs), dout_t,
                                                    retain_graph=True))
    elems_q, elems_kv = b * s * hq * d, b * s * hkv * d
    nbytes = 2 * (4 * elems_q + 4 * elems_kv) + 4 * b * hq * s
    ops = 10 * d * (s * (s + 1) // 2) * b * hq
    _row(f"backward bf16 B={b} S={s} {hq}/{hkv} D={d} causal, device us", times, sdpa,
         _bound_us(nbytes, ops))


def host_us(fn, calls=200) -> float:
    """Host µs of one ``fn()``: ``calls`` back-to-back calls enqueued (the
    device still busy with them) over ``calls``."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    took = time.perf_counter() - start
    torch.cuda.synchronize()
    return took / calls * 1e6


def paced_us(fn, calls=200) -> float:
    """Host-paced µs of one ``fn()``: ``calls`` eager calls over the wall
    time to the last one's end."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - start) / calls * 1e6


def host_costs(builds, device) -> None:
    """Host µs a call of each build's C entry and of the shipped wrapper,
    in turns, and the wrapper's and SDPA's paced µs: the forward at phase
    8's shape, the backward at 24(a)'s."""
    gen = torch.Generator(device=device).manual_seed(18)
    stream = torch.cuda.current_stream().cuda_stream
    for name, (b, s, hq, hkv, d) in (("flash_attention", TIMED_FORWARD[0]),
                                     ("flash_attention_bwd", TIMED_BACKWARD[0])):
        q, k, v, dout = (torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
                         for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d),
                                       (b, s, hq, d)))
        out, lse = flash_ops._forward(q, k, v, True, with_lse=True)
        scale = 1.0 / math.sqrt(d)
        if name == "flash_attention":
            res = torch.empty_like(q)
            args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), res.data_ptr(), None)
            wrapper = lambda: flash_attention(q, k, v)
            qs, ks, vs = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            sdpa = lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                                          enable_gqa=True)
        else:
            delta = torch.empty((b, hq, s), dtype=torch.float32, device=device)
            grads = [torch.empty_like(x) for x in (q, k, v)]
            args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), *(x.data_ptr() for x in grads))
            wrapper = lambda: flash_attention_bwd(q, k, v, out, dout, lse)
            qs, ks, vs = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
            lib_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                                     enable_gqa=True)
            dout_t = dout.transpose(1, 2)
            sdpa = lambda: torch.autograd.grad(lib_out, (qs, ks, vs), dout_t,
                                               retain_graph=True)
        calls = {build: (lambda fn=fns[name]: _ok(fn(*args, b, s, s, hq, hkv, d, 1, scale, 1,
                                                     device.index, stream)))
                 for build, fns in builds.items()}
        calls["shipped wrapper"] = wrapper
        order = list(calls) + list(calls)[::-1]
        times = [(build, host_us(calls[build])) for build in order]
        print(f"host cost, {name} bf16 B={b} S={s} {hq}/{hkv} D={d}, host us a call in turns: "
              + ", ".join(f"{build} {us!r}" for build, us in times)
              + f"; paced us: shipped wrapper {paced_us(wrapper)!r}, SDPA {paced_us(sdpa)!r}")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("csrc", type=Path, help="the other build's csrc/ directory")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_parity needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"card: {card}")
    for line in _ptxas():
        print(f"ptxas: {line}")
    device = torch.device("cuda", 0)
    other = _build_other(args.csrc)
    calls, worst, differ = forward_parity(other["flash_attention"], device)
    print(f"forward: {calls} calls ({len(FORWARD_SHAPES)} shapes x (float32, bfloat16) x with "
          f"and without lse); float32 out and lse bit-equal to the other build; bf16 out of "
          f"both builds within the bf16 bar (atol {BF16_TOL[0]}, rtol {BF16_TOL[1]}) of the "
          f"plain version, bf16 builds at most {worst} ulp apart; bf16 shapes that differ: "
          f"{len(differ)} of {len(FORWARD_SHAPES)} {differ}")
    shipped = {name: _entry(_build.load(name), name)
               for name in ("flash_attention", "flash_attention_bwd")}
    host_costs({"other": other, "shipped": shipped}, device)
    for _ in range(2):          # two rounds: the spread between them is the noise
        for shape in TIMED_FORWARD:
            forward_times(other["flash_attention"], device, *shape)
        for shape in TIMED_BACKWARD:
            backward_times(other["flash_attention_bwd"], device, *shape)


if __name__ == "__main__":
    main()
