"""Wrappers of the tree-selection kernels (``csrc/tree_select.cu``).

:func:`tree_select` scores one level of ``B`` rows; :func:`tree_descend`
walks ``B`` trees from the root to their stop nodes in one launch.  CPU
tensors go to the plain versions (:mod:`.ref`).  CUDA tensors go to the
hand-written kernels, or the call raises: there is no fallback.  The
kernels launch on PyTorch's current stream, and each launch adds one to
``repro_torch.kernels.LAUNCHES["tree_select"]`` or ``["tree_descend"]``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import LAUNCHES, refuse_grad
from .. import _build
from .ref import KINDS, tree_descend_ref, tree_select_ref

_C_FUNCTION = None
_C_DESCEND = None


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


def _descend_launcher():
    global _C_DESCEND
    if _C_DESCEND is None:
        fn = _build.load("tree_select").tree_descend_launch
        fn.argtypes = [ctypes.c_void_p] * 10 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int64, ctypes.c_float, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _C_DESCEND = fn
    return _C_DESCEND


def _check(name, x, shape, dtype, device, fn="tree_select"):
    if x.device != device:
        raise ValueError(f"{fn}: {name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{fn}: {name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{fn}: {name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


def _device_index(device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


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
    refuse_grad("tree_select", n_c, o_c, v_c, n_p, o_p, vl_c)
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
        b, a, KINDS.index(kind), beta, r_vl, n_vl, _device_index(device), stream,
    )
    if err != 0:
        raise RuntimeError(f"tree_select kernel launch failed: cudaError {err}")
    LAUNCHES["tree_select"] += 1
    return act, best


def tree_descend(children, N, O, V, VL, pending, terminal, depth, rngs, *,
                 width: int, max_depth: int, expand_coin: float = 0.5,
                 kind: str = "wu_uct", beta: float = 1.0, r_vl: float = 1.0,
                 n_vl: float = 1.0) -> torch.Tensor:
    """Stop node ``i64[B]`` of each of ``B`` trees, walked from the root.

    ``children i64[B, M, A]``; ``N, O, V, VL f32[B, M]``; ``pending,
    terminal bool[B, M]``; ``depth i64[B, M]``; ``rngs`` the rows' keys
    ``i64[B, 2]`` (rows may be strided, words contiguous).  ``width`` is
    ``min(max_width, A)``.  On a GPU one launch walks every tree to its
    end; its stop nodes equal :func:`.ref.tree_descend_ref`'s bit for bit.
    """
    if kind not in KINDS:
        raise ValueError(f"unknown policy kind: {kind!r}; expected one of {KINDS}")
    params = dict(width=width, max_depth=max_depth, expand_coin=expand_coin,
                  kind=kind, beta=beta, r_vl=r_vl, n_vl=n_vl)
    device = children.device
    if device.type == "cpu":
        return tree_descend_ref(children, N, O, V, VL, pending, terminal, depth, rngs,
                                **params)
    if device.type != "cuda":
        raise ValueError(f"tree_descend runs on CPU or CUDA tensors, got {device}")
    refuse_grad("tree_descend", N, O, V, VL)
    if children.dim() != 3:
        raise ValueError(f"tree_descend: children must be [B, M, A], got "
                         f"{tuple(children.shape)}")
    b, m, a = children.shape
    _check("children", children, (b, m, a), torch.int64, device, "tree_descend")
    for name, x in (("N", N), ("O", O), ("V", V), ("VL", VL)):
        _check(name, x, (b, m), torch.float32, device, "tree_descend")
    for name, x in (("pending", pending), ("terminal", terminal)):
        _check(name, x, (b, m), torch.bool, device, "tree_descend")
    _check("depth", depth, (b, m), torch.int64, device, "tree_descend")
    if rngs.device != device or rngs.dtype != torch.int64 or tuple(rngs.shape) != (b, 2):
        raise ValueError(f"tree_descend: rngs must be int64 [{b}, 2] on {device}, got "
                         f"{rngs.dtype} {tuple(rngs.shape)} on {rngs.device}")
    if rngs.stride(1) != 1:
        raise ValueError("tree_descend: the two words of a key must be adjacent")

    out = torch.empty((b,), dtype=torch.int64, device=device)
    if b == 0:
        return out
    if m == 0 or a == 0:
        raise ValueError("tree_descend: trees need a root and at least one action")
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _descend_launcher()(
        children.data_ptr(), N.data_ptr(), O.data_ptr(), V.data_ptr(), VL.data_ptr(),
        pending.data_ptr(), terminal.data_ptr(), depth.data_ptr(), rngs.data_ptr(),
        out.data_ptr(), b, m, a, rngs.stride(0), width, max_depth, expand_coin,
        KINDS.index(kind), beta, r_vl, n_vl, _device_index(device), stream,
    )
    if err != 0:
        raise RuntimeError(f"tree_descend kernel launch failed: cudaError {err}")
    LAUNCHES["tree_descend"] += 1
    return out
