"""Time variants of the SSD scan's forward (bf16 B/C) on one GPU.

    PYTHONPATH=src python -m repro_torch.launch.ssd_fwd_sweep [--only NAME,NAME]

Each variant is the shipped ``csrc/ssd_scan.cu`` (or the state body it
includes, ``csrc/ssd_state.cuh``) with text substitutions, built by
``nvcc`` with the kernel's flags into ``build/repro_torch/sweep/``
(``attention_sweep._build_variants``) and called through its C entry
point.  Three groups:

* the Hopper chunk kernel (``ssd_wgmma_kernel``) that the main path runs,
  with a part of its work dropped (an ablation is not meant to be right):
  no ``expf`` in the scores, hi.hi alone, no y products, no C·Bᵀ products,
  no xdt split, no xdt or B loads past the first stages, no y stores, no
  carried-state term; and as design variants the state rounded once in
  that term, a 2-stage split ring, one head a block;
* the ``mma.sync`` chunk kernel (``ssd_mma_kernel``, the body that shapes
  outside the Hopper body's keep), forced at every shape, whole and with
  parts dropped, so that the older design's breakdown stays measurable;
* the state kernel: its 2-stage ring.

At phase 13's and phase 14's scans (128 and 8 rows of one chunk of 160
tokens, mamba2-2.7b H=80, N=128 and zamba2-7b H=112, N=64), phase 24(c)'s
training shapes (8 rows of 512 tokens, two chunks of 256) and phase 20's
prefills with the final state (1 x 128 tokens, one chunk) it prints per
variant the device time of one call from CUDA-graph replay, the device µs
of each of its kernels under torch.profiler, and the largest |y - y of the
shipped wrapper|.  Two rounds: the spread between them is the noise.  The
card's name and power limit are printed first.
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

# The mma.sync body at every shape (it runs where the wgmma body does not fit).
_MMA = ("constexpr bool kWgmmaBody = true;", "constexpr bool kWgmmaBody = false;")
# Parts of the Hopper body.
_WG_CB = """      wgmma_ss<kWgSlab, 0>(d, desc_sw128(ct + (kd >> 2) * kRegion + o),
                           desc_sw128(bt + (kd >> 2) * kSlabRegion + o), kd > 0);
"""
_WG_Y = """        wgmma_rs<kWgP, 1>(acc, fh[kk], dh, 1);
        wgmma_rs<kWgP, 1>(acc, fh[kk], dl, 1);
        wgmma_rs<kWgP, 1>(acc, fl[kk], dh, 1);
"""
_WG_HI = "        wgmma_rs<kWgP, 1>(acc, fh[kk], dh, 1);\n"
# The scores stay live, else the compiler drops them with the products.
_WG_KEEP = "        acc[kk] += __uint_as_float(fh[kk][0] ^ fh[kk][3] ^ fl[kk][1] ^ fl[kk][2]);\n"
# The scores' exponentials taken only where the mask keeps them.
_WG_EXP = """          const float e0 = expf(ci - cj.x);
          const float e1 = expf(ci - cj.y);
          const bool live = row < Q;
          const float s0 = (live && j <= row) ? sc[f][8 * kk + 2 * q] * e0 : 0.0f;
          const float s1 = (live && j + 1 <= row) ? sc[f][8 * kk + 2 * q + 1] * e1 : 0.0f;
"""
_WG_EXP_MASKED = """          const bool live = row < Q;
          const float s0 = (live && j <= row) ? sc[f][8 * kk + 2 * q] * expf(ci - cj.x) : 0.0f;
          const float s1 =
              (live && j + 1 <= row) ? sc[f][8 * kk + 2 * q + 1] * expf(ci - cj.y) : 0.0f;
"""
# Where the next slab's C.B^T runs: over the scores (two score sets) or after them.
_OVERLAP = "constexpr bool kOverlap = kTiles < 4;"
_WG_SPLIT = ("        split_store(dst, dst + kSlabRegion, v[k], kRowsPw * pw + (e >> 4), "
             "4 * (e & 15));\n")
_WG_STORE = """      if (ra < Q)
        *reinterpret_cast<float2*>(yh + ra * y_tok + col) = make_float2(acc[4 * j], acc[4 * j + 1]);
      if (rb < Q)
        *reinterpret_cast<float2*>(yh + rb * y_tok + col) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
"""
# The outputs stay live (else the compiler drops the products).
_WG_NO_STORE = "      if (acc[4 * j] == 1234.5f) yh[col] = acc[4 * j + 1] + acc[4 * j + 2];\n"
# Every stage after the first ones: its barrier completes with no copy.
_WG_LOADS = [("      mbar_expect_tx(bar, kRawX);\n      tma_load_3d(",
              "      mbar_expect_tx(bar, i < kRawStages ? kRawX : 0);\n"
              "      if (i < kRawStages) tma_load_3d("),
             ("        mbar_expect_tx(&b_full[st], NR * kSlabRegion);\n"
              "        for (int r = 0; r < NR; ++r)",
              "        mbar_expect_tx(&b_full[st], i < kCvStages ? NR * kSlabRegion : 0);\n"
              "        for (int r = 0; r < NR && i < kCvStages; ++r)")]
# Parts of the mma.sync body.
_MMA_EXP = [("expf(ci[q] - cumj[q].x)", "1.0f"), ("expf(ci[q] - cumj[q].y)", "1.0f")]
_MMA_LO = """          mma_bf16(acc[2 * dp], sh_[kk], bl[0], bl[1]);
          mma_bf16(acc[2 * dp + 1], sh_[kk], bl[2], bl[3]);
          mma_bf16(acc[2 * dp], sl_[kk], bh[0], bh[1]);
          mma_bf16(acc[2 * dp + 1], sl_[kk], bh[2], bh[3]);
"""
_MMA_HI = """          mma_bf16(acc[2 * dp], sh_[kk], bh[0], bh[1]);
          mma_bf16(acc[2 * dp + 1], sh_[kk], bh[2], bh[3]);
"""
# The products' inputs stay live, else the compiler drops the scores too.
_MMA_KEEP = ("          acc[2 * dp][0] += __uint_as_float(sh_[kk][0] ^ sl_[kk][3] ^ bh[0] ^ "
             "bl[1] ^ bh[2] ^ bl[3]);\n")
_MMA_CB = """        mma_bf16(acc0, a, bk[0], bk[1]);
        mma_bf16(acc1, a, bk[2], bk[3]);
"""
_MMA_SPLIT = """        *reinterpret_cast<uint2*>(xh + r * kXb + p) = make_uint2(h01, h23);
        *reinterpret_cast<uint2*>(xl + r * kXb + p) = make_uint2(l01, l23);
"""
_MMA_REFILL = "    if (it + 1 < items) issue_x(it + 1, (it + 1) & 1);\n"
_MMA_STORE = """        if (ia < Q) store2(yh + ia * x_tok + p, acc[nt][0], acc[nt][1], p, P, vec_y);
        if (ib < Q) store2(yh + ib * x_tok + p, acc[nt][2], acc[nt][3], p, P, vec_y);
"""
# The outputs stay live (else the compiler drops the products).
_MMA_NO_STORE = ("        if (acc[nt][0] == 1234.5f) yh[p] = acc[nt][1] + acc[nt][2] + "
                 "acc[nt][3];\n")
_MMA_TILE = ("const int tile = n_tiles - 1 - idx % n_tiles;", "const int tile = 0;")

# name -> (library, edited file, [(old text, new text), ...])
VARIANTS = {
    "ssd_fwd shipped": ("ssd_scan", _SRC, []),
    "ssd_fwd without expf": ("ssd_scan", _SRC, [("expf(ci - cj.x)", "1.0f"),
                                                ("expf(ci - cj.y)", "1.0f")]),
    "ssd_fwd hi.hi only (no lo products)": ("ssd_scan", _SRC, [(_WG_Y, _WG_HI)]),
    "ssd_fwd without the y products": ("ssd_scan", _SRC, [(_WG_Y, _WG_KEEP)]),
    "ssd_fwd without C.B^T products": ("ssd_scan", _SRC, [(_WG_CB, "")]),
    "ssd_fwd without the xdt split": ("ssd_scan", _SRC, [(_WG_SPLIT, "")]),
    "ssd_fwd without xdt and B loads past the first stages": ("ssd_scan", _SRC, _WG_LOADS),
    "ssd_fwd without y stores": ("ssd_scan", _SRC, [(_WG_STORE, _WG_NO_STORE)]),
    "ssd_fwd without the carried-state term": (
        "ssd_scan", _SRC, [("const bool term = kTerm && chunk > 0;", "const bool term = false;")]),
    "ssd_fwd state rounded once in the term": (
        "ssd_scan", _SRC, [("constexpr bool kSplitH = true;", "constexpr bool kSplitH = false;")]),
    "ssd_fwd 2-stage split ring": (
        "ssd_scan", _SRC, [("constexpr int kCvStages = 3;", "constexpr int kCvStages = 2;")]),
    "ssd_fwd 4-stage split ring": (
        "ssd_scan", _SRC, [("constexpr int kCvStages = 3;", "constexpr int kCvStages = 4;")]),
    "ssd_fwd 2-stage raw ring": (
        "ssd_scan", _SRC, [("constexpr int kRawStages = 4;", "constexpr int kRawStages = 2;")]),
    "ssd_fwd exponentials only where unmasked": ("ssd_scan", _SRC, [(_WG_EXP, _WG_EXP_MASKED)]),
    "ssd_fwd the next slab's C.B^T after the scores at every block size": (
        "ssd_scan", _SRC, [(_OVERLAP, _OVERLAP.replace("kTiles < 4", "false"))]),
    "ssd_fwd the next slab's C.B^T over the scores at every block size": (
        "ssd_scan", _SRC, [(_OVERLAP, _OVERLAP.replace("kTiles < 4", "true"))]),
    "ssd_fwd 2 producer warps": (
        "ssd_scan", _SRC, [("constexpr int kProducerWarps = 4;", "constexpr int kProducerWarps = 2;")]),
    "ssd_fwd one head a block": ("ssd_scan", _SRC, [("for (int g = 1; g <= H; ++g) {",
                                                     "for (int g = 1; g <= 1; ++g) {")]),
    "ssd_fwd mma.sync body": ("ssd_scan", _SRC, [_MMA]),
    "ssd_fwd mma.sync without expf": ("ssd_scan", _SRC, [_MMA, *_MMA_EXP]),
    "ssd_fwd mma.sync hi.hi only (no lo products)": ("ssd_scan", _SRC, [_MMA, (_MMA_LO, "")]),
    "ssd_fwd mma.sync without the y products": (
        "ssd_scan", _SRC, [_MMA, (_MMA_HI + _MMA_LO, _MMA_KEEP)]),
    "ssd_fwd mma.sync without C.B^T products": ("ssd_scan", _SRC, [_MMA, (_MMA_CB, "")]),
    "ssd_fwd mma.sync without xdt split": ("ssd_scan", _SRC, [_MMA, (_MMA_SPLIT, "")]),
    "ssd_fwd mma.sync without xdt loads": ("ssd_scan", _SRC, [_MMA, (_MMA_REFILL, "")]),
    "ssd_fwd mma.sync without y stores": ("ssd_scan", _SRC, [_MMA, (_MMA_STORE, _MMA_NO_STORE)]),
    "ssd_fwd mma.sync one row tile (the first) a block": ("ssd_scan", _SRC, [_MMA, _MMA_TILE]),
    "ssd_fwd state kernel 2-stage ring": (
        "ssd_scan", _STATE, [("constexpr int kStStages = 3;", "constexpr int kStStages = 2;")]),
}

# (b, s, h, p, n, Q, return_state)
SHAPES = {"mamba2-2.7b phase 13": (128, 160, 80, 64, 128, 160, False),
          "zamba2-7b phase 14": (8, 160, 112, 64, 64, 160, False),
          "mamba2-2.7b train": (8, 512, 80, 64, 128, 256, False),
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
        try:
            call()   # a variant whose shared memory does not fit refuses the launch
        except RuntimeError as err:
            print(f"{vname}: {err}")
            continue
        ms = graph_ms(call, calls=10, replays=3)
        call()
        print(f"{vname}: {ms * 1e3!r} us; by kernel {_by_kernel(call)}; max |y - shipped| "
              f"{float((y - ref).abs().max())!r}")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", default="",
                        help="comma-separated substrings: sweep only the variants naming one")
    parser.add_argument("--shapes", default="",
                        help="comma-separated substrings: time only the shapes naming one")
    args = parser.parse_args(argv)
    only = [x for x in args.only.split(",") if x]
    wanted = [x for x in args.shapes.split(",") if x]
    if not torch.cuda.is_available():
        raise SystemExit("ssd_fwd_sweep needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"card: {card}")
    device = torch.device("cuda", 0)
    variants = {k: v for k, v in VARIANTS.items()
                if k == "ssd_fwd shipped" or not only or any(x in k for x in only)}
    shapes = {k: v for k, v in SHAPES.items() if not wanted or any(x in k for x in wanted)}
    libs = _build_variants({"ssd_fwd"}, variants)
    for _ in range(2):
        for name, shape in shapes.items():
            _shape(libs, device, name, shape)


if __name__ == "__main__":
    main()
