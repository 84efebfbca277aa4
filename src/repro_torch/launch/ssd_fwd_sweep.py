"""Time variants of the SSD scan's forward (bf16 B/C) on one GPU.

    PYTHONPATH=src python -m repro_torch.launch.ssd_fwd_sweep [--only NAME,NAME]

Each variant is the shipped ``csrc/ssd_scan.cu`` (or the state body it
includes, ``csrc/ssd_state.cuh``) with text substitutions, built by
``nvcc`` with the kernel's flags into ``build/repro_torch/sweep/``
(``attention_sweep._build_variants``) and called through its C entry point: the
inter-chunk term exp(cum_i) C_i·hᵀ added by the state kernel after the
chunk kernel from the state it holds (shipped), or by the chunk kernel
after the state kernel, reading the state from global memory; as
ablations, no inter term (the state kernel still runs), the chunk kernel
alone, the state rounded once in the term, the term without its MMAs or
without its loads of C, and a 2-stage state ring.  At phase 24(c)'s training shapes (8 rows of 512 tokens, two
chunks of 256: mamba2-2.7b H=80, P=64, N=128 and zamba2-7b H=112, N=64)
and phase 20's prefills with the final state (1 x 128 tokens, one chunk),
it prints per variant the device time of one call from CUDA-graph replay,
the device µs of each of its kernels under torch.profiler, and the largest
|y - y of the shipped wrapper| (an ablation is not meant to be right).
Two rounds: the spread between them is the noise.  The card's name and
power limit are printed first.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import torch
import torch.nn.functional as F

from ..kernels.ssd_scan import ssd_scan
from .attention_sweep import _build_variants, _ok, graph_ms
from .ssd_bwd_sweep import _by_kernel

_SRC = "ssd_scan.cu"
_STATE = "ssd_state.cuh"
_NO_TERM = ("  return inter ? launch_state<true>", "  return false ? launch_state<true>")

# name -> (library, edited file, [(old text, new text), ...])
VARIANTS = {
    "ssd_fwd shipped": ("ssd_scan", _SRC, []),
    "ssd_fwd inter term in the chunk kernel": (
        "ssd_scan", _SRC, [("constexpr bool kInterInChunk = false;",
                            "constexpr bool kInterInChunk = true;")]),
    "ssd_fwd without the inter term": ("ssd_scan", _SRC, [_NO_TERM]),
    "ssd_fwd chunk kernel alone": (
        "ssd_scan", _SRC, [("const bool state_pass = inter || hout != nullptr;",
                            "const bool state_pass = false;")]),
    "ssd_fwd state rounded once in the term": (
        "ssd_scan", _STATE, [("constexpr bool kSplitH = true;", "constexpr bool kSplitH = false;")]),
    "ssd_fwd state kernel 2-stage ring": (
        "ssd_scan", _STATE, [("constexpr int kStStages = 3;", "constexpr int kStStages = 2;")]),
    "ssd_fwd inter term without its MMAs": (
        "ssd_scan", _STATE,
        [("            tc::mma_bf16(acc[2 * j], a, bh[0], bh[1]);\n"
          "            tc::mma_bf16(acc[2 * j + 1], a, bh[2], bh[3]);\n", ""),
         ("              tc::mma_bf16(acc[2 * j], a, bl[0], bl[1]);\n"
          "              tc::mma_bf16(acc[2 * j + 1], a, bl[2], bl[3]);\n", "")]),
    "ssd_fwd inter term without its C loads": (
        "ssd_scan", _STATE, [("          const uint32_t a[4] = {\n",
                              "          const uint32_t a[4] = {0x3f803f80u + k0, 7u * ia, 3u * ib, "
                              "5u + k0}; const uint32_t a_[4] = {\n")]),
}

# (b, s, h, p, n, Q, return_state)
SHAPES = {"mamba2-2.7b train": (8, 512, 80, 64, 128, 256, False),
          "zamba2-7b train": (8, 512, 112, 64, 64, 256, False),
          "mamba2-2.7b prefill": (1, 128, 80, 64, 128, 128, True),
          "zamba2-7b prefill": (1, 128, 112, 64, 64, 128, True)}


def _shape(libs, device, name, shape):
    b, s, h, p, n, q, with_state = shape
    gen = torch.Generator(device=device).manual_seed(47)
    xdt = torch.randn((b, s, h, p), generator=gen, device=device) * 0.3
    dA = -F.softplus(torch.randn((b, s, h), generator=gen, device=device))
    bm, cm = ((torch.randn((b, s, n), generator=gen, device=device) * 0.3).to(torch.bfloat16)
              for _ in range(2))
    wrapper = lambda: ssd_scan(xdt, dA, bm, cm, chunk=q, return_state=with_state)
    ref = wrapper()
    ref = ref[0] if with_state else ref
    print(f"-- ssd_scan bf16 B/C {name} (b, s, h, p, n, Q) = {shape[:6]}, final state "
          f"{with_state}")
    print(f"wrapper: {graph_ms(wrapper, calls=10, replays=3) * 1e3!r} us")
    y = torch.empty_like(xdt)
    hout = torch.empty((b, h, p, n), dtype=torch.float32, device=device) if with_state else None
    states = torch.empty((b, s // q, h, p, n), dtype=torch.float32, device=device)
    for vname, lib in libs.items():
        fn = lib.ssd_scan_launch
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        call = lambda: _ok(fn(xdt.data_ptr(), dA.data_ptr(), bm.data_ptr(), cm.data_ptr(),
                              y.data_ptr(), hout.data_ptr() if with_state else None,
                              states.data_ptr(), b, s, h, p, n, q, 1, device.index,
                              torch.cuda.current_stream().cuda_stream))
        ms = graph_ms(call, calls=10, replays=3)
        call()
        print(f"{vname}: {ms * 1e3!r} us; by kernel {_by_kernel(call)}; max |y - shipped| "
              f"{float((y - ref).abs().max())!r}")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", default="",
                        help="comma-separated substrings: sweep only the variants naming one")
    only = [x for x in parser.parse_args(argv).only.split(",") if x]
    if not torch.cuda.is_available():
        raise SystemExit("ssd_fwd_sweep needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"card: {card}")
    device = torch.device("cuda", 0)
    variants = {k: v for k, v in VARIANTS.items()
                if k == "ssd_fwd shipped" or not only or any(x in k for x in only)}
    libs = _build_variants({"ssd_fwd"}, variants)
    for _ in range(2):
        for name, shape in SHAPES.items():
            _shape(libs, device, name, shape)


if __name__ == "__main__":
    main()
