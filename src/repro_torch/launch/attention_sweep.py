"""Time variants of the flash- and decode-attention kernels on one GPU.

    PYTHONPATH=src python -m repro_torch.launch.attention_sweep

Each variant is the shipped source of ``csrc/flash_attention.cu`` or
``csrc/decode_split.cuh`` with one text substitution (an ablation that
drops a part of the work, or another block shape), built by ``nvcc`` with
the kernel's own flags into ``build/repro_torch/sweep/`` and called
through its C entry point.  At the main paths' shapes (phase 8's and
phase 14's flash forwards, phase 7's decode step; bf16) it prints, per
variant, the device time of one call, from CUDA-graph replay of 50
back-to-back calls, and the largest difference from the plain version
(an ablation is not meant to be right).  The shipped wrappers and SDPA
are timed the same way beside them.  The card's name and power limit are
printed first.
"""

from __future__ import annotations

import ctypes
import math
import shutil
import subprocess

import torch
import torch.nn.functional as F

from ..kernels import _build
from ..kernels.decode_attention import decode_attention, decode_attention_ref
from ..kernels.flash_attention import flash_attention, flash_attention_ref

SWEEP_DIR = _build.BUILD_DIR / "sweep"

_QK = """            mma_bf16(s[2 * np], qf[kd], bk[0], bk[1]);
            mma_bf16(s[2 * np + 1], qf[kd], bk[2], bk[3]);
"""
_LO = """          mma_bf16(acc[2 * dp], pl, bv[0], bv[1]);
"""
_LO2 = """          mma_bf16(acc[2 * dp + 1], pl, bv[2], bv[3]);
"""
_REFILL = """    if (it + kStages - 1 < n_tiles)
      load_kv(it + kStages - 1, (it + kStages - 1) % kStages);
"""
_STORE = """      *reinterpret_cast<uint4*>(ob + row_offset(wf0 + r) + ch * 8) =
          *reinterpret_cast<const uint4*>(stage + r * kStride + ch * 8);
"""
_WARPS = """      return Hq == Hkv
          ? launch_bf16<D, 2>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, scale, s)
          : launch_bf16<D, 4>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, scale, s);"""
_WARPS_SWAPPED = _WARPS.replace("Hq == Hkv", "Hq != Hkv")
_SHUFFLE = """        s[u][j] = dot;
      }
    }
    for (int o = lp >> 1; o > 0; o >>= 1) {
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < GT; ++j)
          s[u][j] += __shfl_xor_sync(0xffffffffu, s[u][j], o);
    }
"""
_SHUFFLE_PER_SUM = """        for (int o = lp >> 1; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        s[u][j] = dot;
      }
    }
"""

# name -> (library, edited file, [(old, new), ...])
VARIANTS = {
    "flash shipped": ("flash_attention", "flash_attention.cu", []),
    "flash without Q.K^T mma": ("flash_attention", "flash_attention.cu", [(_QK, "")]),
    "flash single bf16 p (no lo mma)": ("flash_attention", "flash_attention.cu",
                                        [(_LO, ""), (_LO2, "")]),
    "flash without K/V refills": ("flash_attention", "flash_attention.cu", [(_REFILL, "")]),
    "flash without output stores": ("flash_attention", "flash_attention.cu",
                                    [(_STORE, "      ;\n")]),
    "flash 4 warps at G=1, 2 at G>1": ("flash_attention", "flash_attention.cu",
                                       [(_WARPS, _WARPS_SWAPPED)]),
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
}


def _build_variants():
    procs = {}
    for name, (library, edited, subs) in VARIANTS.items():
        where = SWEEP_DIR / name.replace(" ", "_").replace("/", "").replace(".", "")
        shutil.rmtree(where, ignore_errors=True)
        shutil.copytree(_build.CSRC, where)
        text = (where / edited).read_text()
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        (where / edited).write_text(text)
        lib = where / f"lib{library}.so"
        cmd = [_build._nvcc(), *_build.nvcc_flags(library), "-o", str(lib),
               str(where / f"{library}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
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
    fn.argtypes = ([ctypes.c_void_p] * (5 if name == "decode_attention" else 4)
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
        if not name.startswith("flash"):
            continue
        fn = _entry(lib, "flash_attention", 7)
        call = lambda: _ok(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
                              s, hq, hkv, d, 1, 1.0 / math.sqrt(d), 1, device.index,
                              torch.cuda.current_stream().cuda_stream))
        _report(name, graph_ms(call), out, ref)


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
        fn = _entry(lib, "decode_attention", 5)
        call = lambda: _ok(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
                              out.data_ptr(), n, s, hkv, hq // hkv, d, 1.0 / math.sqrt(d), 1,
                              device.index, torch.cuda.current_stream().cuda_stream))
        _report(name, graph_ms(call), out, ref)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("attention_sweep needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"card: {card}")
    device = torch.device("cuda", 0)
    libs = _build_variants()
    for _ in range(2):          # two rounds: the spread between them is the noise
        _flash(libs, device, 32, 8, 128)
        _flash(libs, device, 32, 32, 112)
        _decode(libs, device)


if __name__ == "__main__":
    main()
