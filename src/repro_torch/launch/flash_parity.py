"""Hold the flash-attention kernels against another build of their sources
on one GPU: the forward's output and log-sum-exp bit for bit, and the
backward's device time side by side.

    git archive <commit> src/repro_torch/csrc | tar -x -C build/other
    PYTHONPATH=src python -m repro_torch.launch.flash_parity build/other/src/repro_torch/csrc

The other ``csrc/`` directory (for example a parent commit's) is built by
``nvcc`` with the shipped libraries' own flags into
``build/repro_torch/parity/``.  Then, on the shapes ``chip_smoke.py``
phase 3 runs the forward at (its grid of ``check_flash`` and the shapes of
``check_flash_bwd``), in float32 and bf16, with and without ``lse``, the
shipped forward's ``out`` and ``lse`` must equal the other build's bit for
bit; and at phase 24's backward shape (8 x 512 tokens, 32/8 heads,
D=128, bf16, causal) both backward builds are timed by CUDA-graph replay
in turns (other, shipped, shipped, other).  The card's name and power
limit are printed first.  Exits non-zero when an output differs.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import subprocess
from pathlib import Path

import torch

from ..kernels import _build
from ..kernels.flash_attention import flash_attention_bwd
from ..kernels.flash_attention import ops as flash_ops
from .attention_sweep import _ok, graph_ms

PARITY_DIR = _build.BUILD_DIR / "parity"
# chip_smoke.py phase 3: check_flash's grid, then check_flash_bwd's shapes
# (B, S, Hq, Hkv, D, causal).
FORWARD_SHAPES = (
    [(b, s, hq, hkv, d, True) for b in (1, 8) for s in (1, 7, 160, 1024)
     for hq, hkv in ((32, 8), (8, 8), (4, 1)) for d in (64, 128)]
    + [(b, s, 32, 32, 112, True) for b in (1, 8) for s in (1, 7, 160, 1024)]
    + [(8, 512, 32, 8, 128, True), (2, 160, 8, 2, 64, True), (2, 160, 32, 32, 112, True),
       (1, 33, 4, 1, 16, True), (2, 7, 8, 8, 64, True), (2, 100, 8, 2, 128, False),
       (2, 96, 16, 2, 32, True)])


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
        fn = getattr(ctypes.CDLL(str(lib)), f"{name}_launch")
        n_ptrs = 5 if name == "flash_attention" else 10
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def forward_parity(fwd, device) -> int:
    """Calls of the shipped forward that equal the other build's bit for
    bit; raises at the first that does not."""
    gen = torch.Generator(device=device).manual_seed(12)
    stream = torch.cuda.current_stream().cuda_stream
    calls = 0
    for dtype in (torch.float32, torch.bfloat16):
        for b, s, hq, hkv, d, causal in FORWARD_SHAPES:
            q, k, v = (torch.randn(shape, generator=gen, device=device).to(dtype)
                       for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
            for with_lse in (False, True):
                out, lse = flash_ops._forward(q, k, v, causal, with_lse)
                other = torch.empty_like(out)
                other_lse = torch.empty_like(lse) if with_lse else None
                _ok(fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), other.data_ptr(),
                        other_lse.data_ptr() if with_lse else None, b, s, s, hq, hkv, d,
                        int(causal), 1.0 / math.sqrt(d), flash_ops._DTYPES[dtype],
                        device.index, stream))
                if not torch.equal(out, other) or (with_lse and not torch.equal(lse, other_lse)):
                    raise AssertionError(f"forward {dtype} {(b, s, hq, hkv, d, causal)} "
                                         f"with_lse={with_lse}: differs from the other build")
                calls += 1
    return calls


def backward_times(bwd, device, b=8, s=512, hq=32, hkv=8, d=128) -> list:
    """Device µs of the other and the shipped backward in turns."""
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
    shipped = lambda: flash_attention_bwd(q, k, v, out, dout, lse)
    return [(name, graph_ms(fn, calls=10) * 1e3)
            for name, fn in (("other", other), ("shipped", shipped),
                             ("shipped", shipped), ("other", other))]


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
    device = torch.device("cuda", 0)
    other = _build_other(args.csrc)
    calls = forward_parity(other["flash_attention"], device)
    print(f"forward out and lse bit-equal to the other build: {calls} calls "
          f"({len(FORWARD_SHAPES)} shapes x (float32, bfloat16) x with and without lse)")
    times = backward_times(other["flash_attention_bwd"], device)
    print("backward bf16 B=8 S=512 32/8 D=128 causal, device us by graph replay: "
          + ", ".join(f"{name} {us!r}" for name, us in times))


if __name__ == "__main__":
    main()
