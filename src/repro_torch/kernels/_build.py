"""Build the port's CUDA sources into shared libraries and load them.

Each ``src/repro_torch/csrc/<name>.cu`` exposes a plain C interface and is
compiled by ``nvcc`` for Hopper (``sm_90a``) into its own shared library,
which :func:`load` opens with ``ctypes``.  Every kernel has its own flags
(:func:`nvcc_flags`: the common ones plus :data:`KERNEL_FLAGS`).
A source may include headers of ``csrc/`` (``#include "x.cuh"``).
Libraries go into ``build/repro_torch/`` at the root of the checkout
(git-ignored), named by a hash of the source, the headers it includes and
that kernel's flags, so a rebuild happens when any of them changes.  :func:`build` starts one
``nvcc`` per missing library, all together, and waits for all of them.

Nothing here runs at import: ``nvcc`` and a CUDA device are needed only
when a kernel is first launched.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
COMMON_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "-Xptxas=-v",
    "-shared", "-Xcompiler", "-fPIC",
)
# Keyed by library (``csrc/<name>.cu``).  ``tree_decode_attention`` holds
# both tree kernels, the dense and the paged entry point.
KERNEL_FLAGS: dict[str, tuple[str, ...]] = {
    # Exact rounding: no contraction of products and sums into FMAs.
    "tree_select": ("--fmad=false",),
    # Held to their plain versions within a tolerance: FMAs are welcome.
    "decode_attention": (),
    "flash_attention": (),
    "flash_attention_bwd": (),
    "paged_decode_attention": (),
    "tree_decode_attention": (),
    # Accurate expf (no --use_fast_math); held to their plain versions
    # within a float32 tolerance.
    "ssd_scan": (),
    "ssd_scan_bwd": (),
}


def nvcc_flags(name: str) -> tuple[str, ...]:
    """The flags kernel ``name`` is compiled with."""
    return COMMON_FLAGS + KERNEL_FLAGS[name]

_LOADED: dict[str, ctypes.CDLL] = {}
BUILD_LOGS: dict[str, str] = {}
# Libraries opened with ctypes so far (what a warm process should not repeat;
# ``repro_torch.analysis.retrace_guard`` reads it).
LOADS: dict[str, int] = {"cdll": 0}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the port's "
        "CUDA kernels are built from source at first use"
    )


_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _sources(path: Path, seen: dict[Path, bytes]) -> dict[Path, bytes]:
    """``path`` and every header it includes from ``csrc/``, transitively."""
    if path in seen or not path.exists():
        return seen
    text = path.read_bytes()
    seen[path] = text
    for header in _INCLUDE.findall(text.decode()):
        _sources(CSRC / header, seen)
    return seen


def library_path(name: str) -> Path:
    """Where library ``name`` is built: named by a hash of its source, the
    ``csrc/`` headers it includes and its flags."""
    files = _sources(CSRC / f"{name}.cu", {})
    digest = hashlib.sha256()
    for path in sorted(files):
        digest.update(path.name.encode() + b"\0" + files[path])
    digest.update(" ".join(nvcc_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Sequence[str]) -> dict[str, Path]:
    """Compile every missing library of ``names``; nvcc runs in parallel.

    Raises ``RuntimeError`` with the compiler's output if a build fails.
    The compiler's output of each build (``-Xptxas=-v`` reports registers
    and spills) is kept in :data:`BUILD_LOGS`.
    """
    paths = {name: library_path(name) for name in names}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *nvcc_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of library ``name``, built first if needed.  Each
    real open (not a cached handle) counts in :data:`LOADS`."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _LOADED[name] = lib
        LOADS["cdll"] += 1
    return lib
