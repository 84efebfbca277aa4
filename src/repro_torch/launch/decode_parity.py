"""Hold the four decode-attention kernels against another build of their
sources on one GPU, bit for bit, and time the dense and paged ones beside
other builds and SDPA.

    git archive <commit> src/repro_torch/csrc | tar -x -C build/other
    PYTHONPATH=src python -m repro_torch.launch.decode_parity build/other/src/repro_torch/csrc \
        [more csrc directories, timed only]

Each other ``csrc/`` directory (for example a parent commit's) is built by
``nvcc`` with the shipped libraries' own flags into
``build/repro_torch/parity/<n>/`` (``decode_attention``,
``paged_decode_attention`` and ``tree_decode_attention``, each over its
own copy of the shared body ``decode_split.cuh``).  Every build's C entry
points are called by their parameters' names, read from its source, so
builds before the head window, the log-sum-exp or the split of S
(``parts``) take the same calls.

Against the first directory, on the grids ``chip_smoke.py`` phase 3 runs
them at, float32 and bf16, each shipped kernel's output must equal the
other build's bit for bit: the dense decode kernel (without its
log-sum-exp) through its C entry point at ``parts = 1`` on every shape,
and through the wrapper wherever the wrapper's plan
(``ops.decode_parts``) gives one part; the paged one likewise; both tree
kernels with the identity and a lower-triangular mask.

``--variants`` adds builds of the shipped sources with
``attention_sweep``'s decode variants substituted (timed, not held).

Then, by CUDA-graph replay, every build's dense kernel at phase 7's decode
shape (128 slots of 160, 32/8 heads, D=128, bf16, lengths 129-160) and at
phase 25(e)'s (8 rows of a 32,768-deep cache at length 32,767), and every
build's paged kernel at phase 10's shape (128 slots, 10 blocks of 16 from
a 1280-block pool, lengths 129-160) and over 25(e)'s cache paged in
blocks of 16, in turns (the others, a build that splits S at the plan's
parts, the shipped wrapper, the shipped entry at ``parts = 1``, SDPA,
and back, twice), beside each shape's bound (its
bytes at 3.35 TB/s); at 25(e)'s shape also the shipped entry at several
part counts, with its difference from ``parts = 1``, and both wrappers'
device time by kernel (torch.profiler); at phase 10's shape the paged
kernel over one pool through a shuffled table and with its pages in
order (the dense cache's layout) beside the dense kernel on that cache.
The registers ptxas
gave each build's bf16 G=4 decode kernels are printed.  The card's name
and power limit are printed first.  Exits non-zero when an output
differs.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import re
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

from ..kernels import _build
from ..kernels.decode_attention import (
    decode_attention,
    paged_decode_attention,
    paged_tree_decode_attention,
    tree_decode_attention,
)
from ..kernels.decode_attention import ops as decode_ops
from .attention_sweep import VARIANTS, _ok, graph_ms

PARITY_DIR = _build.BUILD_DIR / "parity"
LIBRARIES = ("decode_attention", "paged_decode_attention", "tree_decode_attention")
ENTRIES = {"decode_attention": "decode_attention",
           "paged_decode_attention": "paged_decode_attention",
           "tree_decode_attention": "tree_decode_attention",
           "paged_tree_decode_attention": "tree_decode_attention"}
HBM_BYTES_PER_S = 3.35e12
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
# Part counts timed at 25(e)'s shape through the shipped entry point.
PARTS_SWEEP = (2, 3, 4, 5, 6, 8)

_SIGNATURE = r'extern "C" int {}_launch\s*\(([^)]*)\)'


class Entry:
    """A C entry point called by its parameters' names."""

    def __init__(self, lib, name: str, source: str):
        found = re.search(_SIGNATURE.format(name), source)
        if found is None:
            raise RuntimeError(f"no {name}_launch in the source")
        kinds = {"ptr": ctypes.c_void_p, "float": ctypes.c_float, "int": ctypes.c_int}
        self.params = []
        for param in found.group(1).split(","):
            words = param.replace("*", " * ").split()
            kind = "ptr" if "*" in words else "float" if words[0] == "float" else "int"
            self.params.append((words[-1], kind))
        self.fn = getattr(lib, f"{name}_launch")
        self.fn.argtypes = [kinds[k] for _, k in self.params]
        self.fn.restype = ctypes.c_int
        self.names = {p for p, _ in self.params}

    def __call__(self, **values) -> None:
        # The stream current at the call (a graph captures on its own).
        values["stream"] = torch.cuda.current_stream().cuda_stream
        _ok(self.fn(*(values[p] for p, _ in self.params)))


def _entries(libs: dict, csrc: Path) -> dict:
    return {name: Entry(libs[lib], name, (csrc / f"{lib}.cu").read_text())
            for name, lib in ENTRIES.items()}


def _build_other(csrc: Path, tag: str) -> tuple[dict, dict]:
    """The other build's entry points and its nvcc logs."""
    where = PARITY_DIR / tag
    where.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in LIBRARIES:
        lib = where / f"lib{name}.so"
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.nvcc_flags(name), "-o", str(lib), str(csrc / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs, logs = {}, {}
    for name, (proc, lib) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {csrc / name}.cu:\n{logs[name]}")
        libs[name] = ctypes.CDLL(str(lib))
    return _entries(libs, csrc), logs


def _variant_csrc(name: str) -> Path:
    """A copy of the shipped ``csrc/`` with ``attention_sweep``'s variant
    ``name`` substituted into its decode body."""
    import shutil

    _, edited, subs = VARIANTS[name]
    where = PARITY_DIR / ("variant_" + re.sub(r"\W+", "_", name))
    shutil.rmtree(where, ignore_errors=True)
    shutil.copytree(_build.CSRC, where)
    text = (where / edited).read_text()
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f"{name}: the source no longer holds {old!r}")
        text = text.replace(old, new)
    (where / edited).write_text(text)
    return where


def _shipped() -> dict:
    libs = {name: _build.load(name) for name in LIBRARIES}
    return _entries(libs, _build.CSRC)


def registers(logs: dict) -> list[str]:
    """ptxas's registers, spills and shared memory of a build's bf16, G=4
    decode kernels (the driven shapes' instances) and of any decode kernel
    that spills."""
    lines = []
    for lib in ("decode_attention", "paged_decode_attention"):
        name = spill = None
        for line in logs.get(lib, "").splitlines():
            if "Compiling entry function" in line:
                name = line.split("'")[1]
            elif "spill stores" in line:
                spill = line.strip()
            elif "Used" in line and "registers" in line and name:
                spills = spill is not None and not spill.startswith("0 bytes stack frame, 0 bytes")
                if ("nv_bfloat16" in name and "Li4E" in name) or spills:
                    lines.append(f"  {lib} {name}: {line.split('Used', 1)[1].strip()}; {spill}")
                name = spill = None
    return lines


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


def _common(device, dtype_code, d):
    return dict(scale=1.0 / math.sqrt(d), dtype=dtype_code, device=device.index, lse=None,
                ws=None, parts=1, q_head0=0)


def _dense_args(q, k, v, lens, out, **extra):
    n, hq, d = q.shape
    return dict(q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), kv_len=lens.data_ptr(),
                out=out.data_ptr(), B=n, S=k.shape[1], Hkv=k.shape[2], G=hq // k.shape[2],
                D=d, Hq=hq, **extra)


def _paged_args(q, pk, pv, table, lens, out, **extra):
    n, hq, d = q.shape
    return dict(q=q.data_ptr(), pool_k=pk.data_ptr(), pool_v=pv.data_ptr(),
                table=table.data_ptr(), kv_len=lens.data_ptr(), out=out.data_ptr(), B=n,
                P=pk.shape[0], bs=pk.shape[1], n_pages=table.shape[1], Hkv=pk.shape[2],
                G=hq // pk.shape[2], D=d, **extra)


def _plan(n, hq, hkv, limit, device) -> int:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return decode_ops.decode_parts(n * hkv * decode_ops.query_groups(hq // hkv), limit, sms)


def parity(other, shipped, device) -> dict:
    """Calls of each shipped kernel that equal the other build's bit for
    bit; raises at the first that does not."""
    gen = torch.Generator(device=device).manual_seed(11)
    calls = {"decode_attention (plan, one part)": 0, "decode_attention (parts = 1)": 0,
             "paged_decode_attention (plan, one part)": 0,
             "paged_decode_attention (parts = 1)": 0, "tree_decode_attention": 0,
             "paged_tree_decode_attention": 0}
    for dtype in (torch.float32, torch.bfloat16):
        code, name = decode_ops._DTYPES[dtype], str(dtype).split(".")[-1]
        common = lambda d: _common(device, code, d)
        for n, s, hq, hkv, d in DECODE_GRID:
            q = torch.randn((n, hq, d), generator=gen, device=device).to(dtype)
            k, v = (torch.randn((n, s, hkv, d), generator=gen, device=device).to(dtype)
                    for _ in range(2))
            lens = _lens(gen, n, s, device)
            out, one = torch.empty_like(q), torch.empty_like(q)
            other["decode_attention"](**_dense_args(q, k, v, lens, out, **common(d)))
            what = f"decode_attention {name} {(n, s, hq, hkv, d)}"
            if "parts" in shipped["decode_attention"].names:
                shipped["decode_attention"](**_dense_args(q, k, v, lens, one, **common(d)))
                _same(what + " parts = 1", one, out)
                calls["decode_attention (parts = 1)"] += 1
            if _plan(n, hq, hkv, s, device) == 1:
                _same(what, decode_attention(q, k, v, lens), out)
                calls["decode_attention (plan, one part)"] += 1
        for n, bs, npg, hq, hkv, d in PAGED_GRID:
            q = torch.randn((n, hq, d), generator=gen, device=device).to(dtype)
            pk, pv, table = _pools(gen, n, bs, npg, hkv, d, dtype, device)
            lens = _lens(gen, n, bs * npg, device)
            out, one = torch.empty_like(q), torch.empty_like(q)
            other["paged_decode_attention"](**_paged_args(q, pk, pv, table, lens, out,
                                                          **common(d)))
            what = f"paged_decode_attention {name} {(n, bs, npg, hq, hkv, d)}"
            if "parts" in shipped["paged_decode_attention"].names:
                shipped["paged_decode_attention"](**_paged_args(q, pk, pv, table, lens, one,
                                                                **common(d)))
                _same(what + " parts = 1", one, out)
                calls["paged_decode_attention (parts = 1)"] += 1
            if _plan(n, hq, hkv, bs * npg, device) == 1:
                _same(what, paged_decode_attention(q, pk, pv, table, lens), out)
                calls["paged_decode_attention (plan, one part)"] += 1
        for n, a, bs, npg, hq, hkv, d in TREE_GRID:
            q = torch.randn((n, a, hq, d), generator=gen, device=device).to(dtype)
            pk, pv, table = _pools(gen, n, bs, npg, hkv, d, dtype, device)
            ks, vs = (torch.randn((n, a, hkv, d), generator=gen, device=device).to(dtype)
                      for _ in range(2))
            lens = _lens(gen, n, bs * npg, device)
            kc, vc = (x.reshape(n, npg * bs, hkv, d) for x in (pk, pv))
            for mask in (None, torch.tril(torch.ones((a, a), device=device)).to(torch.int32)):
                out = torch.empty_like(q)
                tail = dict(k_spec=ks.data_ptr(), v_spec=vs.data_ptr(), kv_len=lens.data_ptr(),
                            mask=None if mask is None else mask.data_ptr(), out=out.data_ptr(),
                            B=n, A=a, Hkv=hkv, G=hq // hkv, D=d, **common(d))
                other["paged_tree_decode_attention"](
                    q=q.data_ptr(), pool_k=pk.data_ptr(), pool_v=pv.data_ptr(),
                    table=table.data_ptr(), P=n * npg, bs=bs, n_pages=npg, **tail)
                got = paged_tree_decode_attention(q, pk, pv, table, ks, vs, lens, mask)
                _same(f"paged_tree_decode_attention {name} {(n, a, bs, npg, hq, hkv, d)}",
                      got, out)
                other["tree_decode_attention"](q=q.data_ptr(), k_cache=kc.data_ptr(),
                                               v_cache=vc.data_ptr(), S=npg * bs, **tail)
                got = tree_decode_attention(q, kc, vc, ks, vs, lens, mask)
                _same(f"tree_decode_attention {name} {(n, a, npg * bs, hq, hkv, d)}", got, out)
                calls["paged_tree_decode_attention"] += 1
                calls["tree_decode_attention"] += 1
    return calls


def _in_turns(calls: dict) -> dict:
    """Device µs of each call, timed in turns: forwards, backwards, twice."""
    order = 2 * (list(calls) + list(reversed(calls)))
    times = {name: [] for name in calls}
    for name in order:
        times[name].append(graph_ms(calls[name], calls=20) * 1e3)
    return times


def decode_times(builds: dict, shipped: dict, device, n, s, min_len, paged_bs=None,
                 hq=32, hkv=8, d=128) -> tuple[dict, float]:
    """Device µs of each build's dense kernel (``paged_bs`` None) or paged
    kernel (the same cache in blocks of ``paged_bs``), the shipped wrapper,
    the shipped entry at ``parts = 1`` and SDPA, in turns; and the bound in
    µs (each valid K/V byte, q, out, kv_len and the live page ids once)."""
    gen = torch.Generator(device=device).manual_seed(13)
    q = torch.randn((n, hq, d), generator=gen, device=device).to(torch.bfloat16)
    lens = torch.randint(min_len, s, (n,), generator=gen, device=device, dtype=torch.int32)
    lens[0] = s if min_len < s - 1 else s - 1
    if paged_bs is None:
        k, v = (torch.randn((n, s, hkv, d), generator=gen, device=device).to(torch.bfloat16)
                for _ in range(2))
        kernel = lambda: decode_attention(q, k, v, lens)
        args = lambda out, **extra: _dense_args(q, k, v, lens, out, **extra)
        name, ids = "decode_attention", 0
    else:
        pk, pv, table = _pools(gen, n, paged_bs, s // paged_bs, hkv, d, torch.bfloat16, device)
        kernel = lambda: paged_decode_attention(q, pk, pv, table, lens)
        args = lambda out, **extra: _paged_args(q, pk, pv, table, lens, out, **extra)
        name = "paged_decode_attention"
        ids = 4 * int(((lens + paged_bs - 1) // paged_bs).sum())
    common = _common(device, 1, d)
    # Builds that split S run at the plan's parts.
    plan = _plan(n, hq, hkv, s, device)
    ws = torch.empty(plan * n * hq * (d + 1), dtype=torch.float32, device=device)
    split = {**common, "parts": plan, "ws": ws.data_ptr()}
    calls = {}
    for label, entries in builds.items():
        out, entry = torch.empty_like(q), entries[name]
        extra = split if "parts" in entry.names else common
        calls[label] = (lambda e=entry, o=out, x=extra: e(**args(o, **x)))
    calls["shipped"] = kernel
    if "parts" in shipped[name].names:
        one = torch.empty_like(q)
        calls["shipped, parts = 1"] = lambda: shipped[name](**args(one, **common))
    mask = (torch.arange(s, device=device)[None, :] < lens[:, None])[:, None, None, :]
    if paged_bs is None:
        calls["SDPA"] = lambda: F.scaled_dot_product_attention(
            q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
            enable_gqa=True)
    else:
        def gather_sdpa():
            k_, v_ = (pool[table.long()].reshape(n, s, hkv, d) for pool in (pk, pv))
            return F.scaled_dot_product_attention(q[:, :, None, :], k_.transpose(1, 2),
                                                  v_.transpose(1, 2), attn_mask=mask,
                                                  enable_gqa=True)
        calls["gather + SDPA"] = gather_sdpa
    times = _in_turns(calls)
    nbytes = 2 * (2 * n * hq * d + 2 * int(lens.sum()) * hkv * d) + 4 * n + ids
    return times, nbytes / HBM_BYTES_PER_S * 1e6


def in_order_pages(device, n=128, bs=16, npg=10, hq=32, hkv=8, d=128) -> dict:
    """The shipped paged kernel at phase 10's shape over one pool, its
    pages once in a shuffled table and once in order (page i of row b is
    block b * npg + i: the dense cache's layout), and the dense kernel
    over that cache, in turns."""
    gen = torch.Generator(device=device).manual_seed(23)
    q = torch.randn((n, hq, d), generator=gen, device=device).to(torch.bfloat16)
    pk, pv, shuffled = _pools(gen, n, bs, npg, hkv, d, torch.bfloat16, device)
    in_order = torch.arange(n * npg, device=device, dtype=torch.int32).reshape(n, npg)
    lens = torch.randint(129, bs * npg + 1, (n,), generator=gen, device=device,
                         dtype=torch.int32)
    kc, vc = (x.reshape(n, npg * bs, hkv, d) for x in (pk, pv))
    return _in_turns({
        "paged, shuffled table": lambda: paged_decode_attention(q, pk, pv, shuffled, lens),
        "paged, pages in order": lambda: paged_decode_attention(q, pk, pv, in_order, lens),
        "dense": lambda: decode_attention(q, kc, vc, lens)})


def parts_sweep(shipped: dict, device, n=8, s=32768, hq=32, hkv=8, d=128) -> list:
    """At 25(e)'s shape: the shipped dense entry at each of PARTS_SWEEP,
    device µs and max |out - out at parts = 1| (float32 out, in units of
    the row's largest |out|)."""
    gen = torch.Generator(device=device).manual_seed(17)
    q = torch.randn((n, hq, d), generator=gen, device=device).to(torch.bfloat16)
    k, v = (torch.randn((n, s, hkv, d), generator=gen, device=device).to(torch.bfloat16)
            for _ in range(2))
    lens = torch.full((n,), s - 1, dtype=torch.int32, device=device)
    entry, common = shipped["decode_attention"], _common(device, 1, d)
    lse = torch.empty((n, hq), dtype=torch.float32, device=device)
    whole = torch.empty((n, hq, d), dtype=torch.float32, device=device)
    entry(**_dense_args(q, k, v, lens, whole, **{**common, "lse": lse.data_ptr()}))
    rows = []
    for parts in PARTS_SWEEP:
        out = torch.empty_like(whole)
        ws = torch.empty(parts * n * hq * (d + 1), dtype=torch.float32, device=device)
        extra = {**common, "lse": lse.data_ptr(), "ws": ws.data_ptr(), "parts": parts}
        call = lambda: entry(**_dense_args(q, k, v, lens, out, **extra))
        call()
        torch.cuda.synchronize()
        share = float(((out - whole).abs().amax(dim=(1, 2))
                       / whole.abs().amax(dim=(1, 2))).max())
        rows.append((parts, graph_ms(call, calls=20) * 1e3, share))
    return rows


def by_kernel(fn, calls=10) -> dict:
    """Device µs of one ``fn()`` by kernel (torch.profiler's device events of
    ``calls`` calls, summed per kernel name without its arguments)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    totals: dict[str, float] = {}
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() == torch.autograd.DeviceType.CUDA:
            name = evt.name().removeprefix("void ").split("<")[0].split("(")[0]
            totals[name] = totals.get(name, 0.0) + evt.duration_ns() * 1e-3 / calls
    return totals


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("csrc", type=Path, nargs="+",
                        help="other builds' csrc/ directories; the first is held bit for bit")
    parser.add_argument("--variants", default="",
                        help="comma-separated attention_sweep decode variants, built from the "
                             "shipped sources and timed beside the others")
    args = parser.parse_args(argv)
    variants = [v.strip() for v in args.variants.split(",") if v.strip()]
    for name in variants:
        if name not in VARIANTS or VARIANTS[name][1] not in ("decode_split.cuh",
                                                             "decode_tiles.cuh"):
            raise SystemExit(f"{name!r} is not a decode variant of attention_sweep")
    if not torch.cuda.is_available():
        raise SystemExit("decode_parity needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"card: {card}")
    device = torch.device("cuda", 0)
    shipped = _shipped()
    # The shipped sources built once more for ptxas's log.
    build_logs = {"shipped": _build_other(_build.CSRC, "shipped")[1]}
    builds = {}
    others = [(f"other {i} ({csrc})", csrc) for i, csrc in enumerate(args.csrc)]
    others += [(f"variant {name!r}", _variant_csrc(name)) for name in variants]
    for i, (label, csrc) in enumerate(others):
        builds[label], build_logs[label] = _build_other(csrc, str(i))
        print(f"{label}: C parameters of decode_attention_launch "
              f"{[p for p, _ in builds[label]['decode_attention'].params]}")
    for label, blogs in build_logs.items():
        print(f"ptxas, {label}:")
        print("\n".join(registers(blogs)) or "  (no log: the library was built before)")
    first = next(iter(builds))
    calls = parity(builds[first], shipped, device)
    print(f"bit-equal to {first} (float32 and bf16, phase 3's grids; the tree kernels with "
          f"the identity and a lower-triangular mask): {calls}")
    for label, n, s, min_len, bs in (
            ("dense, phase 7's shape, 128 x 160, lengths 129-160", 128, 160, 129, None),
            ("dense, phase 25(e)'s shape, 8 x 32768, length 32767", 8, 32768, 32767, None),
            ("paged, phase 10's shape, 128 x 10 blocks of 16, lengths 129-160", 128, 160,
             129, 16),
            ("paged, 25(e)'s cache in 8 x 2048 blocks of 16, length 32767", 8, 32768, 32767,
             16)):
        times, bound = decode_times(builds, shipped, device, n, s, min_len, paged_bs=bs)
        print(f"bf16 32/8 D=128 {label}: bound {bound!r} us; device us by graph replay, "
              f"in turns: " + "; ".join(f"{name} {us!r}" for name, us in times.items()))
        torch.cuda.empty_cache()
    times = in_order_pages(device)
    print("paged, phase 10's shape, pages in a shuffled table and in order (the dense "
          "cache's layout), beside the dense kernel, device us by graph replay, in turns: "
          + "; ".join(f"{name} {us!r}" for name, us in times.items()))
    if "parts" in shipped["decode_attention"].names:
        for parts, us, share in parts_sweep(shipped, device):
            print(f"dense at 25(e)'s shape, shipped entry, parts = {parts}: {us!r} us device; "
                  f"max |out - out at parts = 1| / row max |out| = {share!r}")
        gen = torch.Generator(device=device).manual_seed(19)
        for label, paged_bs in (("dense", None), ("paged", 16)):
            q = torch.randn((8, 32, 128), generator=gen, device=device).to(torch.bfloat16)
            lens = torch.full((8,), 32767, dtype=torch.int32, device=device)
            if paged_bs is None:
                k, v = (torch.randn((8, 32768, 8, 128), generator=gen, device=device)
                        .to(torch.bfloat16) for _ in range(2))
                fn = lambda: decode_attention(q, k, v, lens)
            else:
                pk, pv, table = _pools(gen, 8, 16, 2048, 8, 128, torch.bfloat16, device)
                fn = lambda: paged_decode_attention(q, pk, pv, table, lens)
            print(f"{label} at 25(e)'s shape, the shipped wrapper (plan: "
                  f"{_plan(8, 32, 8, 32768, device)} parts), device us by kernel "
                  f"(torch.profiler): {by_kernel(fn)}")
            del fn
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
