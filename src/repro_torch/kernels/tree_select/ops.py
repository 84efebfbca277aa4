"""Wrapper of the batched tree-selection kernel (``csrc/tree_select.cu``).

CPU tensors go to the plain version (:mod:`.ref`).  CUDA tensors go to the
hand-written kernel, or the call raises: there is no fallback.  The kernel
launches on PyTorch's current stream, and each launch adds one to
``repro_torch.kernels.LAUNCHES["tree_select"]``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import LAUNCHES
from .. import _build
from .ref import KINDS, tree_select_ref

_C_FUNCTION = None


def _launcher():
    global _C_FUNCTION
    if _C_FUNCTION is None:
        fn = _build.load("tree_select").tree_select_launch
        fn.argtypes = [ctypes.c_void_p] * 9 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _C_FUNCTION = fn
    return _C_FUNCTION


def _check(name, x, shape, dtype, device):
    if x.device != device:
        raise ValueError(f"tree_select: {name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"tree_select: {name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"tree_select: {name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"tree_select: {name} must be contiguous")


def tree_select(n_c, o_c, v_c, n_p, o_p, valid, vl_c=None, *,
                kind: str = "wu_uct", beta: float = 1.0, r_vl: float = 1.0,
                n_vl: float = 1.0):
    """Best child of each of ``B`` rows: ``(act i32[B], best f32[B])``.

    ``n_c, o_c, v_c, vl_c`` are child statistics ``f32[B, A]`` (``vl_c``
    may be None: zeros), ``n_p, o_p`` parent statistics ``f32[B]`` and
    ``valid`` a ``bool[B, A]`` mask.  All contiguous, on one device.
    """
    if kind not in KINDS:
        raise ValueError(f"unknown policy kind: {kind!r}; expected one of {KINDS}")
    device = n_c.device
    if device.type == "cpu":
        return tree_select_ref(n_c, o_c, v_c, n_p, o_p, valid, vl_c,
                               kind=kind, beta=beta, r_vl=r_vl, n_vl=n_vl)
    if device.type != "cuda":
        raise ValueError(f"tree_select runs on CPU or CUDA tensors, got {device}")
    if n_c.dim() != 2:
        raise ValueError(f"tree_select: n_c must be [B, A], got {tuple(n_c.shape)}")
    b, a = n_c.shape
    for name, x in (("n_c", n_c), ("o_c", o_c), ("v_c", v_c)):
        _check(name, x, (b, a), torch.float32, device)
    if vl_c is not None:
        _check("vl_c", vl_c, (b, a), torch.float32, device)
    _check("n_p", n_p, (b,), torch.float32, device)
    _check("o_p", o_p, (b,), torch.float32, device)
    _check("valid", valid, (b, a), torch.bool, device)

    act = torch.empty((b,), dtype=torch.int32, device=device)
    best = torch.empty((b,), dtype=torch.float32, device=device)
    if b == 0:
        return act, best
    if a == 0:
        raise ValueError("tree_select: rows need at least one child (A > 0)")
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _launcher()(
        n_c.data_ptr(), o_c.data_ptr(), v_c.data_ptr(),
        vl_c.data_ptr() if vl_c is not None else None,
        n_p.data_ptr(), o_p.data_ptr(), valid.data_ptr(),
        act.data_ptr(), best.data_ptr(),
        b, a, KINDS.index(kind), beta, r_vl, n_vl,
        device.index if device.index is not None else torch.cuda.current_device(),
        stream,
    )
    if err != 0:
        raise RuntimeError(f"tree_select kernel launch failed: cudaError {err}")
    LAUNCHES["tree_select"] += 1
    return act, best
