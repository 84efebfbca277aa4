"""Wrapper of the causal flash-attention kernel (``csrc/flash_attention.cu``).

CPU tensors go to the plain version (:mod:`.ref`).  CUDA tensors go to the
hand-written kernel, or the call raises: there is no fallback.  The kernel
launches on PyTorch's current stream, and each launch adds one to
``repro_torch.kernels.LAUNCHES["flash_attention"]``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import LAUNCHES
from .. import _build
from .ref import flash_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 112, 128)
_C_FUNCTION = None


def _launcher():
    global _C_FUNCTION
    if _C_FUNCTION is None:
        fn = _build.load("flash_attention").flash_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _C_FUNCTION = fn
    return _C_FUNCTION


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """GQA attention ``q [B, Sq, Hq, D]`` over ``k``/``v [B, Sk, Hkv, D]``
    (positions from 0; causal by default) -> ``[B, Sq, Hq, D]`` in ``q``'s
    dtype (float32 or bfloat16, float32 accumulation).  Any sequence
    length; on the card ``D`` is one of :data:`HEAD_DIMS` and q, k, v are
    16-byte aligned.  bf16 runs on the tensor cores, float32 on the CUDA
    cores (see ``csrc/flash_attention.cu``)."""
    device = q.device
    if device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    if device.type != "cuda":
        raise ValueError(f"flash_attention runs on CPU or CUDA tensors, got {device}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention: q must be [B, Sq, Hq, D] and k/v "
                         f"[B, Sk, Hkv, D], got {tuple(q.shape)}, {tuple(k.shape)}")
    b, sq, hq, d = q.shape
    _, sk, hkv, dk = k.shape
    if k.shape[0] != b or dk != d or hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not fit q {tuple(q.shape)}")
    if tuple(v.shape) != tuple(k.shape):
        raise ValueError("flash_attention: k and v differ in shape")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} is not one of {HEAD_DIMS}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got {q.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != device or x.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {x.dtype} on {x.device}, "
                             f"expected {q.dtype} on {device}")
        if not x.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be 16-byte aligned "
                             f"(the kernel loads 16 bytes at a time)")
    out = torch.empty_like(q)
    if b == 0 or sq == 0:
        return out
    if sk == 0:
        raise ValueError("flash_attention: no keys (Sk = 0)")
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, sq, sk, hq, hkv, d, int(causal), 1.0 / math.sqrt(d), _DTYPES[q.dtype],
        device.index if device.index is not None else torch.cuda.current_device(),
        stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    LAUNCHES["flash_attention"] += 1
    return out
