"""Wrapper of the dense decode-attention kernel (``csrc/decode_attention.cu``).

CPU tensors go to the plain version (:mod:`.ref`).  CUDA tensors go to the
hand-written kernel, or the call raises: there is no fallback.  The kernel
launches on PyTorch's current stream, and each launch adds one to
``repro_torch.kernels.LAUNCHES["decode_attention"]``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import LAUNCHES
from .. import _build
from .ref import decode_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_C_FUNCTION = None


def _launcher():
    global _C_FUNCTION
    if _C_FUNCTION is None:
        fn = _build.load("decode_attention").decode_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _C_FUNCTION = fn
    return _C_FUNCTION


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_len) -> torch.Tensor:
    """One-token GQA attention: ``q [B, Hq, D]`` over the first ``kv_len``
    entries of ``k_cache``/``v_cache [B, S, Hkv, D]``; ``kv_len`` is an int
    or an integer tensor ``[]``/``[B]``.  Returns ``[B, Hq, D]`` in
    ``q``'s dtype (float32 or bfloat16, float32 accumulation)."""
    device = q.device
    if device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, kv_len)
    if device.type != "cuda":
        raise ValueError(f"decode_attention runs on CPU or CUDA tensors, got {device}")
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(f"decode_attention: q must be [B, Hq, D] and the caches "
                         f"[B, S, Hkv, D], got {tuple(q.shape)}, {tuple(k_cache.shape)}")
    b, hq, d = q.shape
    _, s, hkv, dk = k_cache.shape
    if k_cache.shape[0] != b or dk != d or hkv == 0 or hq % hkv:
        raise ValueError(f"decode_attention: caches {tuple(k_cache.shape)} do not fit "
                         f"q {tuple(q.shape)}")
    if tuple(v_cache.shape) != tuple(k_cache.shape):
        raise ValueError("decode_attention: k_cache and v_cache differ in shape")
    if q.dtype not in _DTYPES:
        raise TypeError(f"decode_attention takes float32 or bfloat16, got {q.dtype}")
    for name, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if x.device != device or x.dtype != q.dtype:
            raise ValueError(f"decode_attention: {name} is {x.dtype} on {x.device}, "
                             f"expected {q.dtype} on {device}")
        if not x.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be contiguous")
    lens = torch.as_tensor(kv_len, device=device)
    if lens.dtype.is_floating_point or lens.dim() > 1 or lens.numel() not in (1, b):
        raise ValueError(f"decode_attention: kv_len must be an integer [] or [{b}]")
    lens = lens.to(torch.int32).reshape(-1).expand(b).contiguous()
    out = torch.empty_like(q)
    if b == 0:
        return out
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _launcher()(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lens.data_ptr(),
        out.data_ptr(), b, s, hkv, hq // hkv, d, 1.0 / math.sqrt(d),
        _DTYPES[q.dtype],
        device.index if device.index is not None else torch.cuda.current_device(),
        stream,
    )
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: cudaError {err}")
    LAUNCHES["decode_attention"] += 1
    return out
