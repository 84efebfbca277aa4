"""Time variants of the SSD scan's backward (bf16 B/C) on one GPU.

    PYTHONPATH=src python -m repro_torch.launch.ssd_bwd_sweep [--only NAME,NAME]

Each variant is the shipped ``csrc/ssd_scan_bwd.cu`` (or the state body it
includes, ``csrc/ssd_state.cuh``) with text substitutions (an ablation
that drops a part of the work, or another head group), built by ``nvcc``
with the kernel's flags into
``build/repro_torch/sweep/`` (``attention_sweep``'s builder) and called
through its C entry point.  At phase 24(c)'s training shapes (8 rows of 512
tokens, two chunks of 256: mamba2-2.7b H=80, P=64, N=128 and zamba2-7b
H=112, N=64), bf16 B/C, it prints per variant the device time of one call
from CUDA-graph replay, the device µs of each of its kernels under
torch.profiler, and the largest difference from the shipped wrapper's
gradients as a share of each gradient's largest value (an ablation is not
meant to be right).  Two rounds: the spread between them is the noise.
The card's name and power limit are printed first.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import torch
import torch.nn.functional as F

from ..kernels.ssd_scan import ssd_scan_bwd
from .attention_sweep import _build_variants, _ok, graph_ms

_SRC = "ssd_scan_bwd.cu"
_STATE = "ssd_state.cuh"
_G_FORM = "      for (int it = jt; it < nT; ++it) {\n        const int ia = 16 * it + g;"
_DM_MMA = ("          mma3<kSplitDm>(dm0, xa_h[kk], xa_l[kk], bh[0], bh[1], bl[0], bl[1]);\n"
           "          mma3<kSplitDm>(dm1, xa_h[kk], xa_l[kk], bh[2], bh[3], bl[2], bl[3]);\n")
_DX_MMA = ("          mma3<kSplitM>(acc[2 * dp], mh, ml, bh[0], bh[1], bl[0], bl[1]);\n"
           "          mma3<kSplitM>(acc[2 * dp + 1], mh, ml, bh[2], bh[3], bl[2], bl[3]);\n")
_FIN_MMA = ("            mma3<true>(acc[i][0], xh, xl, sh[0], sh[1], sl[0], sl[1]);\n"
            "            mma3<true>(acc[i][1], xh, xl, sh[2], sh[3], sl[2], sl[3]);\n")
_ST_MMA = ("            mma2(acc[i][0], ah, al, bk[0], bk[1]);\n"
           "            mma2(acc[i][1], ah, al, bk[2], bk[3]);\n")
_GROUPS = "long long groups = sm_count(device) / rows;"
_FIN_REFILL = "      if (s + kFinStages - 1 < n_slabs) fetch(s + kFinStages - 1);\n"
_SPLIT = "plan.split = 2 * plan.fin_blocks < sm_count(device) && H > 1 ? 2 : 1;"
_G_NEXT = "if (it + 1 < nT) load_frag(g_tiles + tri_index(it + 1, jt) * 256, lane, g_next);"

# name -> (library, edited file, [(old text, new text), ...])
VARIANTS = {
    "ssd_bwd shipped": ("ssd_scan_bwd", _SRC, []),
    "ssd_bwd chunk without G formation": (
        "ssd_scan_bwd", _SRC, [(_G_FORM, _G_FORM.replace("it = jt;", "it = nT;"))]),
    "ssd_bwd chunk without state terms": (
        "ssd_scan_bwd", _SRC, [("    if (has_g) {\n      float sb",
                                "    if (false) {\n      float sb"),
                               ("    if (has_h) {\n      float sc",
                                "    if (false) {\n      float sc")]),
    "ssd_bwd chunk without dy loads": (
        "ssd_scan_bwd", _SRC, [("const float4 v = ld_f4(dyg + r * x_tok, p, P, r < Q);",
                                "const float4 v = make_float4(0.25f * r, 0.5f * p, 1.0f, 2.0f);")]),
    "ssd_bwd chunk without the ddA scan": (
        "ssd_scan_bwd", _SRC, [("    if (warp == 0) {\n      float wsum = 0.0f;\n",
                                "    if (false) {\n      float wsum = 0.0f;\n")]),
    "ssd_bwd chunk without tile mma": (
        "ssd_scan_bwd", _SRC, [(_DM_MMA, ""), (_DX_MMA, "")]),
    "ssd_bwd chunk without tile expf": (
        "ssd_scan_bwd", _SRC, [("expf(cum[i] - ((q & 2) ? cum_b : cum_a))",
                                "(cum[i] - ((q & 2) ? cum_b : cum_a))")]),
    "ssd_bwd chunk without G tile loads": (
        "ssd_scan_bwd", _SRC, [(_G_NEXT,
                                "for (int q = 0; q < 8; ++q) g_next[q] = 0.5f * q + it;")]),
    "ssd_bwd chunk without D updates": (
        "ssd_scan_bwd", _SRC, [("        store_frag(dt, lane, dg);\n", "")]),
    "ssd_bwd twice the head groups": (
        "ssd_scan_bwd", _SRC, [(_GROUPS, _GROUPS.replace("= sm_count", "= 2 * sm_count"))]),
    "ssd_bwd finish without state mma": ("ssd_scan_bwd", _SRC, [(_FIN_MMA, "")]),
    "ssd_bwd finish without state loads": (
        "ssd_scan_bwd", _SRC, [(_FIN_REFILL, "")]),
    "ssd_bwd finish 2-stage ring": (
        "ssd_scan_bwd", _SRC, [("constexpr int kFinStages = 3;", "constexpr int kFinStages = 2;")]),
    "ssd_bwd finish without the head split": (
        "ssd_scan_bwd", _SRC, [(_SPLIT, "plan.split = 1;")]),
    "ssd_bwd finish without D part": (
        "ssd_scan_bwd", _SRC, [("for (int kt0 = kt_begin; kt0 < kt_end;",
                                "for (int kt0 = kt_end; kt0 < kt_end;")]),
    "ssd_bwd state pass without mma": ("ssd_scan_bwd", _STATE, [(_ST_MMA, "")]),
    "ssd_bwd state pass 2-stage ring": (
        "ssd_scan_bwd", _STATE,
        [("constexpr int kStStages = 3;", "constexpr int kStStages = 2;")]),
}

SHAPES = {"mamba2-2.7b": (8, 512, 80, 64, 128, 256), "zamba2-7b": (8, 512, 112, 64, 64, 256)}


def _by_kernel(fn, calls=3):
    """Device µs of one ``fn()`` by kernel name (torch.profiler's device events)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    totals: dict[str, float] = {}
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() == torch.autograd.DeviceType.CUDA:
            name = evt.name().replace("(anonymous namespace)::", "").removeprefix("void ")
            name = name.split("(")[0]
            totals[name] = totals.get(name, 0.0) + evt.duration_ns() * 1e-3 / calls
    return {k: round(v, 2) for k, v in totals.items()}


def _shape(libs, device, name, shape):
    b, s, h, p, n, q = shape
    gen = torch.Generator(device=device).manual_seed(46)
    xdt = torch.randn((b, s, h, p), generator=gen, device=device) * 0.3
    dA = -F.softplus(torch.randn((b, s, h), generator=gen, device=device))
    bm, cm = ((torch.randn((b, s, n), generator=gen, device=device) * 0.3).to(torch.bfloat16)
              for _ in range(2))
    dy = torch.randn((b, s, h, p), generator=gen, device=device)
    ref = ssd_scan_bwd(xdt, dA, bm, cm, dy, chunk=q)
    print(f"-- ssd_scan_bwd bf16 B/C {name} (b, s, h, p, n, Q) = {shape}")
    ms = graph_ms(lambda: ssd_scan_bwd(xdt, dA, bm, cm, dy, chunk=q), calls=5, replays=3)
    print(f"wrapper: {ms * 1e3!r} us")
    outs = [torch.empty_like(x) for x in (xdt, dA, bm, cm)]
    states = [torch.empty((b, s // q, h, p, n), dtype=torch.float32, device=device)
              for _ in range(2)]
    for vname, lib in libs.items():
        scratch_floats = lib.ssd_scan_bwd_scratch_floats
        scratch_floats.argtypes = [ctypes.c_int] * 8
        scratch_floats.restype = ctypes.c_longlong
        scratch = torch.empty(scratch_floats(b, s, h, p, n, q, 1, device.index),
                              dtype=torch.float32, device=device)
        fn = lib.ssd_scan_bwd_launch
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        call = lambda: _ok(fn(xdt.data_ptr(), dA.data_ptr(), bm.data_ptr(), cm.data_ptr(),
                              dy.data_ptr(), *(x.data_ptr() for x in outs),
                              *(x.data_ptr() for x in states), scratch.data_ptr(),
                              b, s, h, p, n, q, 0, 1, device.index,
                              torch.cuda.current_stream().cuda_stream))
        ms = graph_ms(call, calls=5, replays=3)
        shares = [float((o.float() - r.float()).abs().max()) / float(r.float().abs().max())
                  for o, r in zip(outs, ref)]
        print(f"{vname}: {ms * 1e3!r} us; by kernel {_by_kernel(call)}; max |d - shipped| / "
              f"max (dxdt, ddA, dB, dC) {shares}")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", default="",
                        help="comma-separated substrings: sweep only the variants naming one")
    only = [x for x in parser.parse_args(argv).only.split(",") if x]
    if not torch.cuda.is_available():
        raise SystemExit("ssd_bwd_sweep needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"card: {card}")
    device = torch.device("cuda", 0)
    variants = {k: v for k, v in VARIANTS.items()
                if k == "ssd_bwd shipped" or not only or any(x in k for x in only)}
    libs = _build_variants({"ssd_bwd"}, variants)
    for _ in range(2):
        for name, shape in SHAPES.items():
            _shape(libs, device, name, shape)


if __name__ == "__main__":
    main()
