"""Hold the four decode-attention kernels against another build of their
sources on one GPU, bit for bit, and time the dense one beside it.

    git archive <commit> src/repro_torch/csrc | tar -x -C build/other
    PYTHONPATH=src python -m repro_torch.launch.decode_parity build/other/src/repro_torch/csrc

The other ``csrc/`` directory (for example a parent commit's) is built by
``nvcc`` with the shipped libraries' own flags into
``build/repro_torch/parity/`` (``decode_attention``,
``paged_decode_attention`` and ``tree_decode_attention``, each over its
own copy of the shared body ``decode_split.cuh``).  On the grids
``chip_smoke.py`` phase 3 runs them at, float32 and bf16, each shipped
kernel's output must equal the other build's bit for bit: the dense
decode kernel (without its log-sum-exp output: a build before it has
none), the paged one, and both tree kernels with the identity and a
lower-triangular mask.  The other ``decode_attention`` entry point's C
interface is read from its source (with or without the head window and
the log-sum-exp).  Then both dense builds are timed by CUDA-graph replay
in turns (other, shipped, shipped, other) at phase 7's decode shape (128
slots of 160, 32/8 heads, D=128) and at phase 25(e)'s (8 rows of a
32,768-deep cache).  The card's name and power limit are printed first.
Exits non-zero when an output differs.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import subprocess
from pathlib import Path

import torch

from ..kernels import _build
from ..kernels.decode_attention import (
    decode_attention,
    paged_decode_attention,
    paged_tree_decode_attention,
    tree_decode_attention,
)
from ..kernels.decode_attention import ops as decode_ops
from .attention_sweep import _ok, graph_ms

PARITY_DIR = _build.BUILD_DIR / "parity"
LIBRARIES = ("decode_attention", "paged_decode_attention", "tree_decode_attention")
# chip_smoke.py phase 3's grids: check_decode (N, S, Hq, Hkv, D),
# check_paged_decode (N, bs, pages, Hq, Hkv, D), check_tree (N, A, bs,
# pages, Hq, Hkv, D; the dense tree kernel at S = bs * pages).
DECODE_GRID = [(n, s, hq, hkv, d) for n in (1, 128, 1000) for s in (1, 160, 4096)
               for hq, hkv in ((32, 8), (8, 8), (4, 1)) for d in (64, 128)]
PAGED_GRID = [(n, bs, npg, hq, hkv, d) for n in (1, 128) for bs, npg in
              ((1, 37), (3, 11), (4, 40), (16, 10)) for hq, hkv in ((32, 8), (4, 1))
              for d in (64, 128)]
TREE_GRID = [(n, a, bs, npg, hq, hkv, d) for n in (1, 128) for a in (1, 4, 8)
             for bs, npg in ((1, 37), (3, 11), (16, 10)) for hq, hkv in ((32, 8), (4, 1))
             for d in (64, 128)] + [(7, 16, 4, 9, 8, 2, 64), (5, 32, 4, 6, 8, 2, 64)]


def _entry(lib, name, n_ptrs, n_ints):
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _build_other(csrc: Path) -> tuple[dict, bool]:
    """The other build's C entry points, and whether its dense entry point
    takes the head window and the log-sum-exp."""
    PARITY_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in LIBRARIES:
        lib = PARITY_DIR / f"lib{name}.so"
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.nvcc_flags(name), "-o", str(lib), str(csrc / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the other {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    windowed = "q_head0" in (csrc / "decode_attention.cu").read_text()
    entries = {
        "decode_attention": _entry(libs["decode_attention"], "decode_attention",
                                   *((6, 7) if windowed else (5, 5))),
        "paged_decode_attention": _entry(libs["paged_decode_attention"],
                                         "paged_decode_attention", 6, 7),
        "tree_decode_attention": _entry(libs["tree_decode_attention"],
                                        "tree_decode_attention", 8, 6),
        "paged_tree_decode_attention": _entry(libs["tree_decode_attention"],
                                              "paged_tree_decode_attention", 9, 8),
    }
    return entries, windowed


def _lens(gen, n, full, device):
    lens = torch.randint(0, full + 1, (n,), generator=gen, device=device, dtype=torch.int32)
    for i, x in enumerate((0, 1, full, min(full, 33))[:n]):
        lens[i] = x
    return lens


def _pools(gen, n, bs, npg, hkv, d, dtype, device):
    p = n * npg
    pk, pv = (torch.randn((p, bs, hkv, d), generator=gen, device=device).to(dtype)
              for _ in range(2))
    table = torch.randperm(p, generator=gen, device=device).reshape(n, npg).to(torch.int32)
    return pk, pv, table


def _same(what, shipped, other):
    if not torch.equal(shipped, other):
        raise AssertionError(f"{what}: differs from the other build by up to "
                             f"{float((shipped.float() - other.float()).abs().max())!r}")


def parity(other, windowed, device) -> dict:
    """Calls of each shipped kernel that equal the other build's bit for
    bit; raises at the first that does not."""
    gen = torch.Generator(device=device).manual_seed(11)
    stream = torch.cuda.current_stream().cuda_stream
    calls = dict.fromkeys(other, 0)
    for dtype in (torch.float32, torch.bfloat16):
        code, name = decode_ops._DTYPES[dtype], str(dtype).split(".")[-1]
        for n, s, hq, hkv, d in DECODE_GRID:
            q = torch.randn((n, hq, d), generator=gen, device=device).to(dtype)
            k, v = (torch.randn((n, s, hkv, d), generator=gen, device=device).to(dtype)
                    for _ in range(2))
            lens = _lens(gen, n, s, device)
            got, out = decode_attention(q, k, v, lens), torch.empty_like(q)
            head = [q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), out.data_ptr()]
            ints = [n, s, hkv, hq // hkv, d]
            if windowed:
                head, ints = head + [None], ints + [hq, 0]
            _ok(other["decode_attention"](*head, *ints, 1.0 / math.sqrt(d), code, device.index,
                                          stream))
            _same(f"decode_attention {name} {(n, s, hq, hkv, d)}", got, out)
            calls["decode_attention"] += 1
        for n, bs, npg, hq, hkv, d in PAGED_GRID:
            q = torch.randn((n, hq, d), generator=gen, device=device).to(dtype)
            pk, pv, table = _pools(gen, n, bs, npg, hkv, d, dtype, device)
            lens = _lens(gen, n, bs * npg, device)
            got, out = paged_decode_attention(q, pk, pv, table, lens), torch.empty_like(q)
            _ok(other["paged_decode_attention"](
                q.data_ptr(), pk.data_ptr(), pv.data_ptr(), table.data_ptr(), lens.data_ptr(),
                out.data_ptr(), n, n * npg, bs, npg, hkv, hq // hkv, d, 1.0 / math.sqrt(d),
                code, device.index, stream))
            _same(f"paged_decode_attention {name} {(n, bs, npg, hq, hkv, d)}", got, out)
            calls["paged_decode_attention"] += 1
        for n, a, bs, npg, hq, hkv, d in TREE_GRID:
            q = torch.randn((n, a, hq, d), generator=gen, device=device).to(dtype)
            pk, pv, table = _pools(gen, n, bs, npg, hkv, d, dtype, device)
            ks, vs = (torch.randn((n, a, hkv, d), generator=gen, device=device).to(dtype)
                      for _ in range(2))
            lens = _lens(gen, n, bs * npg, device)
            kc, vc = (x.reshape(n, npg * bs, hkv, d) for x in (pk, pv))
            for mask in (None, torch.tril(torch.ones((a, a), device=device)).to(torch.int32)):
                mptr = None if mask is None else mask.data_ptr()
                tail = (ks.data_ptr(), vs.data_ptr(), lens.data_ptr(), mptr)
                got = paged_tree_decode_attention(q, pk, pv, table, ks, vs, lens, mask)
                out = torch.empty_like(q)
                _ok(other["paged_tree_decode_attention"](
                    q.data_ptr(), pk.data_ptr(), pv.data_ptr(), table.data_ptr(), *tail,
                    out.data_ptr(), n, a, n * npg, bs, npg, hkv, hq // hkv, d,
                    1.0 / math.sqrt(d), code, device.index, stream))
                _same(f"paged_tree_decode_attention {name} {(n, a, bs, npg, hq, hkv, d)}",
                      got, out)
                got = tree_decode_attention(q, kc, vc, ks, vs, lens, mask)
                _ok(other["tree_decode_attention"](
                    q.data_ptr(), kc.data_ptr(), vc.data_ptr(), *tail, out.data_ptr(), n, a,
                    npg * bs, hkv, hq // hkv, d, 1.0 / math.sqrt(d), code, device.index, stream))
                _same(f"tree_decode_attention {name} {(n, a, npg * bs, hq, hkv, d)}", got, out)
                calls["paged_tree_decode_attention"] += 1
                calls["tree_decode_attention"] += 1
    return calls


def decode_times(fn, windowed, device, n, s, hq=32, hkv=8, d=128, min_len=None) -> list:
    """Device µs of the other and the shipped dense kernel in turns."""
    gen = torch.Generator(device=device).manual_seed(13)
    q = torch.randn((n, hq, d), generator=gen, device=device).to(torch.bfloat16)
    k, v = (torch.randn((n, s, hkv, d), generator=gen, device=device).to(torch.bfloat16)
            for _ in range(2))
    lo = s - 1 if min_len is None else min_len
    lens = torch.randint(lo, s, (n,), generator=gen, device=device, dtype=torch.int32)
    out = torch.empty_like(q)
    head = [q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), out.data_ptr()]
    ints = [n, s, hkv, hq // hkv, d]
    if windowed:
        head, ints = head + [None], ints + [hq, 0]
    other = lambda: _ok(fn(*head, *ints, 1.0 / math.sqrt(d), 1, device.index,
                           torch.cuda.current_stream().cuda_stream))
    shipped = lambda: decode_attention(q, k, v, lens)
    return [(name, graph_ms(call, calls=20) * 1e3)
            for name, call in (("other", other), ("shipped", shipped),
                               ("shipped", shipped), ("other", other))]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("csrc", type=Path, help="the other build's csrc/ directory")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("decode_parity needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"card: {card}")
    device = torch.device("cuda", 0)
    other, windowed = _build_other(args.csrc)
    print(f"the other decode_attention entry point takes the head window and lse: {windowed}")
    calls = parity(other, windowed, device)
    print(f"bit-equal to the other build (float32 and bf16, phase 3's grids; the tree kernels "
          f"with the identity and a lower-triangular mask): {calls}")
    for label, n, s, min_len in (("phase 7's shape, 128 x 160, lengths 129-160", 128, 160, 129),
                                 ("phase 25(e)'s shape, 8 x 32768, length 32767", 8, 32768,
                                  None)):
        times = decode_times(other["decode_attention"], windowed, device, n, s,
                             min_len=min_len)
        print(f"decode_attention bf16 32/8 D=128 at {label}, device us by graph replay: "
              + ", ".join(f"{name} {us!r}" for name, us in times))


if __name__ == "__main__":
    main()
