"""Time variants of the flash-, decode- and tree-decode-attention kernels
and of the flash-attention backward on one GPU (the SSD scan's are in
``ssd_fwd_sweep.py`` and ``ssd_bwd_sweep.py``).

    PYTHONPATH=src python -m repro_torch.launch.attention_sweep [--only flash,flash_bwd,decode,tree]

Each variant is the shipped source of ``csrc/flash_attention.cu``,
``csrc/flash_attention_bwd.cu``, ``csrc/decode_split.cuh`` or
``csrc/tree_decode_attention.cu`` with one text
substitution (an ablation that drops a part of the work, or another block
shape or rounding), built by ``nvcc`` with the kernel's own flags into
``build/repro_torch/sweep/`` and called through its C entry point.  At the
main paths' shapes (phase 8's, phase 14's and 24(a)'s flash forwards,
24(a)'s backward and zamba2's at D=112, phase 7's decode step, phase 11's
and 12's frontier forwards through both tree entry points; bf16) it
prints, per variant, the device time of one call, from CUDA-graph replay
of 50 back-to-back calls (10 for the backward), and the
largest difference from the plain version (for the backward, the largest
over dq, dk and dv as a share of that gradient's largest value; an
ablation is not meant to be right).  The shipped wrappers and SDPA (for the tree kernels: a
concatenation of prefix and tail, a gather of the pages first when paged,
and masked SDPA) are timed the same way beside them.  For the decode and
tree kinds it also prints, from ``cuobjdump -sass`` of the shipped
library, the instructions of the bf16 G=4 kernel's hottest loop (the one
with the most FFMA) by opcode.  The card's name and power limit are
printed first.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import math
import re
import shutil
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

from ..kernels import _build
from ..kernels.decode_attention import (
    decode_attention,
    decode_attention_ref,
    paged_tree_decode_attention,
    paged_tree_decode_attention_ref,
    tree_decode_attention,
    tree_decode_attention_ref,
)
from ..kernels.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_ref,
    flash_attention_ref,
)
from ..kernels.flash_attention import ops as flash_ops

SWEEP_DIR = _build.BUILD_DIR / "sweep"

# The flash forward's wgmma body (D >= 64).
_QK = """      wgmma_ss<BK, 0>(s, desc_sw128(qs + h * kQHalf + off),
                      desc_sw128(ks + (st * kH + h) * kKVHalf + off), kk > 0);
"""
_LO = """      wgmma_rs<D, 1>(acc, pl[kk], dv, 1);
"""
_STORE = """    for (int h = 0; h < kH; ++h) tma_store_5d(&to, qs + h * kQHalf, 64 * h, 0, hk, t0, b);
"""
_P_EXP = "      const float p = exp2f(s[i] - m[(i >> 1) & 1]);"
_KEY_TILE = "constexpr int kKeyTile = 32;"
_FWD_STAGES = "constexpr int kFwdStages = 2;"
_FWD_ORDER = "constexpr bool kFwdTilesInner = false;"
# The flash backward's wgmma body (D >= 64).
_BWD_STAGES = "constexpr int kBwdStages = 2;"
_DQ_KEYS = "constexpr int kDqKeys = 32;"
_DQ_STAGES = "constexpr int kDqStages = 2;"
_LONG_BLOCK = "constexpr float kLongBlock = 0.5f;"
_DQ_ORDER = "constexpr bool kDqTilesInner = true;"
_DKDV = """      wgmma_rs<D, 1>(dv_acc, pa[kk], d_o, 1);
      wgmma_rs<D, 1>(dk_acc, sa[kk], d_q, 1);
"""
_DQ_MMA = """      wgmma_rs<D, 1>(acc, da[kk], desc_sw128(kt + kk * 2048, kKVHalf), 1);
"""
_SHUFFLE = """      s[u][j] = dot;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    if (o < lp) {
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < GT; ++j)
          s[u][j] += __shfl_xor_sync(0xffffffffu, s[u][j], o);
    }
  }
"""
_SHUFFLE_PER_SUM = """      for (int o = lp >> 1; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      s[u][j] = dot;
    }
  }
"""
# The warp vote that lets p = 2^x run as MUFU.EX2 alone (exact).
_VOTE = "  if (__all_sync(0xffffffffu, quick)) {"
# The decode body's 16-byte loads, and with a hint that L2 fetch 256 bytes.
_LOAD16 = "  return __ldg(static_cast<const uint4*>(p));\n"
_LOAD16_L2_256 = """  uint4 x;
  asm("ld.global.nc.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];\\n"
      : "=r"(x.x), "=r"(x.y), "=r"(x.z), "=r"(x.w)
      : "l"(p));
  return x;
"""
# The decode kernels' cp.async ring, in key-loop iterations.
_RING = "constexpr int kRing = 2;"
# The decode kernels' blocks an SM up to 4 queries a block.
_MIN_BLOCKS = "__launch_bounds__(kWarps * 32, GT <= 4 ? 4 : 1)"
_GROUPS = "constexpr int kGroups = 2;"
_CANDIDATES = "constexpr int kCandidates = 32;"
_OVERLAP = "constexpr bool kOverlap = true;"

# The backward's block shapes.
_KV_KEYS = "constexpr int kKvKeys = 64;"
_Q_ROWS = "constexpr int kQRows = 32;"
_DQ_WARPS = "      : launch_dq_mma<D, 4>("

# name -> (library, edited file, [(old, new), ...])
VARIANTS = {
    "flash shipped": ("flash_attention", "flash_attention.cu", []),
    "flash 64-key tiles": ("flash_attention", "flash_attention.cu",
                           [(_KEY_TILE, _KEY_TILE.replace("32", "64"))]),
    "flash 3-stage rings": ("flash_attention", "flash_attention.cu",
                            [(_FWD_STAGES, _FWD_STAGES.replace("2", "3"))]),
    "flash 4-stage rings": ("flash_attention", "flash_attention.cu",
                            [(_FWD_STAGES, _FWD_STAGES.replace("2", "4"))]),
    "flash row tiles inner": ("flash_attention", "flash_attention.cu",
                              [(_FWD_ORDER, _FWD_ORDER.replace("false", "true"))]),
    "flash p by ex2.approx, not exp2f": ("flash_attention", "flash_attention.cu",
                                         [(_P_EXP, _P_EXP.replace("exp2f(", "ex2("))]),
    "flash single bf16 p (no lo wgmma)": ("flash_attention", "flash_attention.cu", [(_LO, "")]),
    "flash without Q.K^T wgmma": ("flash_attention", "flash_attention.cu", [(_QK, "")]),
    "flash without output stores": ("flash_attention", "flash_attention.cu", [(_STORE, "")]),
    "flash_bwd shipped": ("flash_attention_bwd", "flash_attention_bwd.cu", []),
    "flash_bwd 3-stage Q/dO ring": ("flash_attention_bwd", "flash_attention_bwd.cu",
                                    [(_BWD_STAGES, _BWD_STAGES.replace("2", "3"))]),
    "flash_bwd dK/dV key tiles inner at every shape": (
        "flash_attention_bwd", "flash_attention_bwd.cu",
        [(_LONG_BLOCK, _LONG_BLOCK.replace("0.5f", "1e30f"))]),
    "flash_bwd dK/dV heaviest key tiles first at every shape": (
        "flash_attention_bwd", "flash_attention_bwd.cu",
        [(_LONG_BLOCK, _LONG_BLOCK.replace("0.5f", "0.0f"))]),
    "flash_bwd dQ kernel's heaviest row tiles first across heads": (
        "flash_attention_bwd", "flash_attention_bwd.cu",
        [(_DQ_ORDER, _DQ_ORDER.replace("true", "false"))]),
    "flash_bwd dQ kernel 64-key tiles": ("flash_attention_bwd", "flash_attention_bwd.cu",
                                         [(_DQ_KEYS, _DQ_KEYS.replace("32", "64"))]),
    "flash_bwd dQ kernel 3-stage K/V ring": ("flash_attention_bwd", "flash_attention_bwd.cu",
                                             [(_DQ_STAGES, _DQ_STAGES.replace("2", "3"))]),
    "flash_bwd p by exp2f, not ex2.approx": (
        "flash_attention_bwd", "flash_attention_bwd.cu",
        [("ex2(fmaf(st_acc", "exp2f(fmaf(st_acc"), ("ex2(fmaf(s[i]", "exp2f(fmaf(s[i]")]),
    "flash_bwd p and ds split hi + lo": (
        "flash_attention_bwd", "flash_attention_bwd.cu",
        [("constexpr bool kSplitP = false;", "constexpr bool kSplitP = true;"),
         ("constexpr bool kSplitDs = false;", "constexpr bool kSplitDs = true;")]),
    "flash_bwd without the dK/dV products": ("flash_attention_bwd", "flash_attention_bwd.cu",
                                             [(_DKDV, "")]),
    "flash_bwd without the dQ product": ("flash_attention_bwd", "flash_attention_bwd.cu",
                                         [(_DQ_MMA, "")]),
    "decode shipped": ("decode_attention", "decode_split.cuh", []),
    "decode 2 warps": ("decode_attention", "decode_split.cuh",
                       [("constexpr int kWarps = 4;", "constexpr int kWarps = 2;")]),
    "decode 8 warps": ("decode_attention", "decode_split.cuh",
                       [("constexpr int kWarps = 4;", "constexpr int kWarps = 8;")]),
    "decode unroll 2": ("decode_attention", "decode_split.cuh",
                        [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 2;")]),
    "decode unroll 8": ("decode_attention", "decode_split.cuh",
                        [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 8;")]),
    "decode shuffle loop per sum": ("decode_attention", "decode_split.cuh",
                                    [(_SHUFFLE, _SHUFFLE_PER_SUM)]),
    "decode exp2f without the vote": ("decode_attention", "decode_split.cuh",
                                      [(_VOTE, "  if (false) {")]),
    "decode L2 256-byte fetch hint": ("decode_attention", "decode_split.cuh",
                                      [(_LOAD16, _LOAD16_L2_256)]),
    "decode 5 blocks an SM": ("decode_attention", "decode_split.cuh",
                              [(_MIN_BLOCKS, _MIN_BLOCKS.replace("? 4 :", "? 5 :"))]),
    "decode 3 blocks an SM": ("decode_attention", "decode_split.cuh",
                              [(_MIN_BLOCKS, _MIN_BLOCKS.replace("? 4 :", "? 3 :"))]),
    "decode ring of 3 iterations": ("decode_attention", "decode_split.cuh",
                                    [(_RING, _RING.replace("2;", "3;"))]),

    "tree shipped": ("tree_decode_attention", "tree_decode_attention.cu", []),
    "tree 1 candidate group per block": ("tree_decode_attention", "tree_decode_attention.cu",
                                         [(_GROUPS, _GROUPS.replace("2", "1"))]),
    "tree 4 candidate groups per block": ("tree_decode_attention", "tree_decode_attention.cu",
                                          [(_GROUPS, _GROUPS.replace("2", "4"))]),
    "tree 4 candidates per block": ("tree_decode_attention", "tree_decode_attention.cu",
                                    [(_CANDIDATES, _CANDIDATES.replace("32", "4"))]),
    "tree staging without overlap": ("tree_decode_attention", "tree_decode_attention.cu",
                                     [(_OVERLAP, _OVERLAP.replace("true", "false"))]),
    "tree exp2f without the vote": ("tree_decode_attention", "decode_split.cuh",
                                    [(_VOTE, "  if (false) {")]),
}


def _build_variants(kinds, variants=None):
    # Every substitution is checked before any nvcc starts.
    jobs = {}
    for name, (library, edited, subs) in (VARIANTS if variants is None else variants).items():
        if name.split()[0] not in kinds:
            continue
        where = SWEEP_DIR / name.replace(" ", "_").replace("/", "").replace(".", "")
        shutil.rmtree(where, ignore_errors=True)
        shutil.copytree(_build.CSRC, where)
        text = (where / edited).read_text()
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        (where / edited).write_text(text)
        jobs[name] = (library, where)
    procs = {}
    for name, (library, where) in jobs.items():
        lib = where / f"lib{library}.so"
        cmd = [_build._nvcc(), *_build.nvcc_flags(library), "-o", str(lib),
               str(where / f"{library}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), lib)
    libs, failed = {}, []
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"nvcc failed for {name}:\n{log}")
        else:
            libs[name] = ctypes.CDLL(str(lib))
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def graph_ms(fn, calls=50, replays=5):
    """Device time of one ``fn()``: CUDA-graph replay of back-to-back calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def _entry(lib, name, n_ints):
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = ([ctypes.c_void_p] * 5
                   + [ctypes.c_int] * n_ints
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _ok(err):
    if err != 0:
        raise RuntimeError(f"kernel launch failed: cudaError {err}")


def _report(name, ms, out, ref):
    err = float((out.float() - ref.float()).abs().max())
    print(f"{name}: {ms * 1e3!r} us (max |out - plain| {err!r})")


def _flash(libs, device, hq, hkv, d, b=8, s=160):
    gen = torch.Generator(device=device).manual_seed(14)
    q, k, v = (torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
               for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    ref = flash_attention_ref(q, k, v)
    print(f"-- flash_attention bf16 B={b} S={s} {hq}/{hkv} D={d}")
    _report("wrapper", graph_ms(lambda: flash_attention(q, k, v)), flash_attention(q, k, v), ref)
    qs, ks, vs = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    sdpa = lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)
    _report("SDPA", graph_ms(sdpa), sdpa().transpose(1, 2), ref)
    out = torch.empty_like(q)
    for name, lib in libs.items():
        if name.split()[0] != "flash":
            continue
        fn = _entry(lib, "flash_attention", 7)
        call = lambda: _ok(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None,
                              b, s, s, hq, hkv, d, 1, 1.0 / math.sqrt(d), 1, device.index,
                              torch.cuda.current_stream().cuda_stream))
        _report(name, graph_ms(call), out, ref)


def _grad_share(grads, ref):
    return max(float((x.float() - r).abs().max()) / float(r.abs().max())
               for x, r in zip(grads, ref))


def _flash_bwd(libs, device, b=8, s=512, hq=32, hkv=8, d=128):
    """Phase 24's backward: 8 x 512 tokens, 32/8 heads, D=128, bf16, causal."""
    gen = torch.Generator(device=device).manual_seed(16)
    q, k, v, dout = (torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
                     for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, hq, d)))
    out, lse = flash_ops._forward(q, k, v, True, with_lse=True)
    ref = flash_attention_bwd_ref(q.float(), k.float(), v.float(), out.float(), dout.float(), lse)
    print(f"-- flash_attention_bwd bf16 B={b} S={s} {hq}/{hkv} D={d} causal")
    run = lambda: flash_attention_bwd(q, k, v, out, dout, lse)
    ms = graph_ms(run, calls=10)
    print(f"wrapper: {ms * 1e3!r} us (max share |d - plain| / max |plain| "
          f"{_grad_share(run(), ref)!r})")
    grads = [torch.empty_like(x) for x in (q, k, v)]
    delta = torch.empty((b, hq, s), dtype=torch.float32, device=device)
    for name, lib in libs.items():
        if name.split()[0] != "flash_bwd":
            continue
        fn = lib.flash_attention_bwd_launch
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        call = lambda: _ok(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                              dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                              *(x.data_ptr() for x in grads), b, s, s, hq, hkv, d, 1,
                              1.0 / math.sqrt(d), 1, device.index,
                              torch.cuda.current_stream().cuda_stream))
        ms = graph_ms(call, calls=10)
        print(f"{name}: {ms * 1e3!r} us (max share |d - plain| / max |plain| "
              f"{_grad_share(grads, ref)!r})")


def _decode(libs, device, n=128, s=160, hq=32, hkv=8, d=128):
    gen = torch.Generator(device=device).manual_seed(13)
    q = torch.randn((n, hq, d), generator=gen, device=device).to(torch.bfloat16)
    k, v = (torch.randn((n, s, hkv, d), generator=gen, device=device).to(torch.bfloat16)
            for _ in range(2))
    lens = torch.randint(129, s + 1, (n,), generator=gen, device=device, dtype=torch.int32)
    ref = decode_attention_ref(q, k, v, lens)
    print(f"-- decode_attention bf16 N={n} S={s} {hq}/{hkv} D={d}, kv_len 129..{s}")
    _report("wrapper", graph_ms(lambda: decode_attention(q, k, v, lens)),
            decode_attention(q, k, v, lens), ref)
    mask = (torch.arange(s, device=device)[None, :] < lens[:, None])[:, None, None, :]
    qs, ks, vs = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
    sdpa = lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, enable_gqa=True)
    _report("SDPA", graph_ms(sdpa), sdpa()[:, :, 0], ref)
    out = torch.empty_like(q)
    for name, lib in libs.items():
        if not name.startswith("decode"):
            continue
        fn = _tree_entry(lib, "decode_attention", 7, 8)
        call = lambda: _ok(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
                              out.data_ptr(), None, None, n, s, hkv, hq // hkv, d, hq, 0, 1,
                              1.0 / math.sqrt(d), 1, device.index,
                              torch.cuda.current_stream().cuda_stream))
        _report(name, graph_ms(call), out, ref)


def _tree_entry(lib, name, n_ptrs, n_ints):
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _tree(libs, device, n=128, a=8, s=160, bs=16, hq=32, hkv=8, d=128):
    """Phase 11's and 12's frontier forward: 128 rows x 8 candidates, the
    identity mask, a 160-key prefix (lengths 129-160), dense and as 10
    pages of 16 from a shuffled 1280-block pool."""
    gen = torch.Generator(device=device).manual_seed(15)
    npg = s // bs

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)

    q, ks, vs = rand(n, a, hq, d), rand(n, a, hkv, d), rand(n, a, hkv, d)
    pk, pv = rand(n * npg, bs, hkv, d), rand(n * npg, bs, hkv, d)
    table = torch.randperm(n * npg, generator=gen, device=device).reshape(n, npg)
    table = table.to(torch.int32)
    kc, vc = (x[table.long()].reshape(n, s, hkv, d) for x in (pk, pv))
    lens = torch.randint(129, s + 1, (n,), generator=gen, device=device, dtype=torch.int32)
    mask = torch.eye(a, dtype=torch.int32, device=device)
    pos = torch.arange(s, device=device)
    sdpa_mask = torch.cat([(pos[None, :] < lens[:, None])[:, None, :].expand(n, a, s),
                           mask.bool()[None].expand(n, a, a)], dim=-1)[:, None]

    def sdpa(k_, v_):
        kf = torch.cat([k_, ks], dim=1).transpose(1, 2)
        vf = torch.cat([v_, vs], dim=1).transpose(1, 2)
        return F.scaled_dot_product_attention(q.transpose(1, 2), kf, vf, attn_mask=sdpa_mask,
                                              enable_gqa=True).transpose(1, 2)

    ref = tree_decode_attention_ref(q, kc, vc, ks, vs, lens)
    paged_ref = paged_tree_decode_attention_ref(q, pk, pv, table, ks, vs, lens)
    print(f"-- tree_decode_attention bf16 N={n} A={a} S={s} {hq}/{hkv} D={d}, kv_len "
          f"129..{s}, identity mask; paged: {npg} pages of {bs}")
    _report("dense wrapper", graph_ms(lambda: tree_decode_attention(q, kc, vc, ks, vs, lens)),
            tree_decode_attention(q, kc, vc, ks, vs, lens), ref)
    _report("paged wrapper",
            graph_ms(lambda: paged_tree_decode_attention(q, pk, pv, table, ks, vs, lens)),
            paged_tree_decode_attention(q, pk, pv, table, ks, vs, lens), paged_ref)
    _report("concat + masked SDPA", graph_ms(lambda: sdpa(kc, vc)), sdpa(kc, vc), ref)
    gathered = lambda: sdpa(pk[table.long()].reshape(n, s, hkv, d),
                            pv[table.long()].reshape(n, s, hkv, d))
    _report("gather + concat + masked SDPA", graph_ms(gathered), gathered(), paged_ref)
    out = torch.empty_like(q)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    for name, lib in libs.items():
        if not name.startswith("tree"):
            continue
        dense = _tree_entry(lib, "tree_decode_attention", 8, 6)
        paged = _tree_entry(lib, "paged_tree_decode_attention", 9, 8)
        call = lambda: _ok(dense(q.data_ptr(), kc.data_ptr(), vc.data_ptr(), ks.data_ptr(),
                                 vs.data_ptr(), lens.data_ptr(), mask.data_ptr(), out.data_ptr(),
                                 n, a, s, hkv, hq // hkv, d, 1.0 / math.sqrt(d), 1,
                                 device.index, stream()))
        _report(f"{name}, dense", graph_ms(call), out, ref)
        call = lambda: _ok(paged(q.data_ptr(), pk.data_ptr(), pv.data_ptr(), table.data_ptr(),
                                 ks.data_ptr(), vs.data_ptr(), lens.data_ptr(), mask.data_ptr(),
                                 out.data_ptr(), n, a, n * npg, bs, npg, hkv, hq // hkv, d,
                                 1.0 / math.sqrt(d), 1, device.index, stream()))
        _report(f"{name}, paged", graph_ms(call), out, paged_ref)


# Mangled-name pieces of the bf16, GT=4, dense instance of each kernel
# (the driven shape's).
_HOT_KERNELS = {
    "decode_attention": "split_kernelI13__nv_bfloat16S1_Li4ELi1EN12decode_tiles9DenseRows",
    "tree_decode_attention": "tree_kernelI13__nv_bfloat16Li4ELi1EN12decode_tiles9DenseRows",
}
_SASS_LINE = re.compile(r"\s+/\*([0-9a-f]+)\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)[^;]*;")


def _sass_mix(library):
    """The key loop of the bf16 G=4 kernel of ``library`` (the shortest
    loop with the 256 FFMA of a step's scores and p.V, 8 keys x 4 queries
    a warp): its instruction count and the counts by opcode, from
    ``cuobjdump -sass``."""
    cuobjdump = str(Path(_build._nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([cuobjdump, "-sass", str(_build.library_path(library))],
                          capture_output=True, text=True, check=True).stdout
    body = next(f for f in re.split(r"\n\s+Function : ", sass)
                if _HOT_KERNELS[library] in f.split("\n", 1)[0])
    ins = [(int(m.group(1), 16), m.group(2)) for m in _SASS_LINE.finditer(body)]
    loops = []
    for addr, op in ins:
        if op == "BRA":
            line = body[body.index(f"/*{addr:04x}*/"):].split(";", 1)[0]
            target = re.search(r"BRA\s+(?:`\(\.L_x_\d+\)|0x([0-9a-f]+))", line)
            if target and target.group(1) and int(target.group(1), 16) < addr:
                seg = [o for a, o in ins if int(target.group(1), 16) <= a <= addr]
                if collections.Counter(seg)["FFMA"] >= 256:
                    loops.append(seg)
    seg = min(loops, key=len)
    mix = collections.Counter(seg).most_common()
    print(f"{library} bf16 G=4: key loop {len(seg)} instructions per pass: "
          + ", ".join(f"{op} {n}" for op, n in mix))


def _resource_usage(library):
    """Registers, stack, spills and shared memory of every kernel of the
    shipped ``library``, from ``cuobjdump --dump-resource-usage``."""
    cuobjdump = str(Path(_build._nvcc()).with_name("cuobjdump"))
    dump = subprocess.run([cuobjdump, "--dump-resource-usage",
                           str(_build.build([library])[library])],
                          capture_output=True, text=True, check=True).stdout
    demangle = shutil.which("c++filt")
    name = None
    for line in dump.splitlines():
        if "Function" in line:
            name = line.split("Function", 1)[1].split(":")[0].strip()
            if demangle:
                name = subprocess.run([demangle, name], capture_output=True, text=True,
                                      check=True).stdout.strip() or name
                name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
                name = name.split("(")[0]
        if "REG:" in line:
            print(f"{library} {name}: {line[line.index('REG:'):].strip()}")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", default="flash,flash_bwd,decode,tree",
                        help="comma-separated kernels to sweep: flash, flash_bwd, decode, "
                             "tree")
    kinds = set(parser.parse_args(argv).only.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("attention_sweep needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"card: {card}")
    device = torch.device("cuda", 0)
    libs = _build_variants(kinds)
    if "flash_bwd" in kinds:
        _resource_usage("flash_attention_bwd")
    for library in ("decode_attention", "tree_decode_attention"):
        if library.split("_")[0] in kinds:
            _build.build([library])
            _sass_mix(library)
    for _ in range(2):          # two rounds: the spread between them is the noise
        if "flash" in kinds:
            _flash(libs, device, 32, 8, 128)
            _flash(libs, device, 32, 32, 112)
            _flash(libs, device, 32, 8, 128, s=512)
        if "flash_bwd" in kinds:
            _flash_bwd(libs, device)
            _flash_bwd(libs, device, hkv=32, d=112)
        if "decode" in kinds:
            _decode(libs, device)
        if "tree" in kinds:
            _tree(libs, device)


if __name__ == "__main__":
    main()
