"""Wrapper of the causal flash-attention kernel (``csrc/flash_attention.cu``)
and of its backward (``csrc/flash_attention_bwd.cu``).

CPU tensors go to the plain version (:mod:`.ref`), which autograd
differentiates.  CUDA tensors go to the hand-written kernels, or the call
raises: there is no fallback.  When grad mode is on and an input requires
grad, the CUDA call runs through :class:`FlashAttention`, whose forward
also writes each row's log-sum-exp and whose backward launches the
backward kernel.  The kernels launch on PyTorch's current stream; each
forward launch adds one to ``repro_torch.kernels.LAUNCHES["flash_attention"]``,
each backward launch one to ``LAUNCHES["flash_attention_bwd"]``.
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
_C_FUNCTIONS: dict = {}


def _launcher(name: str):
    fn = _C_FUNCTIONS.get(name)
    if fn is None:
        if name == "flash_attention":
            fn = _build.load(name).flash_attention_launch
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
                ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ]
        else:
            fn = _build.load(name).flash_attention_bwd_launch
            fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [
                ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ]
        fn.restype = ctypes.c_int
        _C_FUNCTIONS[name] = fn
    return fn


def _device_index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, **more) -> tuple:
    """Shapes ``(b, sq, sk, hq, hkv, d)`` of a CUDA call, after checking
    what the kernels take."""
    device = q.device
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
    for name, x in (("q", q), ("k", k), ("v", v), *more.items()):
        if x.device != device or x.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {x.dtype} on {x.device}, "
                             f"expected {q.dtype} on {device}")
        if not x.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be 16-byte aligned "
                             f"(the kernel loads 16 bytes at a time)")
    return b, sq, sk, hq, hkv, d


def _forward(q, k, v, causal: bool, with_lse: bool):
    """The forward kernel: ``out``, and with ``with_lse`` also ``lse [B, Hq,
    Sq]`` in float32."""
    b, sq, sk, hq, hkv, d = _check(q, k, v)
    out = torch.empty_like(q)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if b == 0 or sq == 0:
        return out, lse
    if sk == 0:
        raise ValueError("flash_attention: no keys (Sk = 0)")
    err = _launcher("flash_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if with_lse else None,
        b, sq, sk, hq, hkv, d, int(causal), 1.0 / math.sqrt(d), _DTYPES[q.dtype],
        _device_index(q.device), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    LAUNCHES["flash_attention"] += 1
    return out, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor, *,
                        causal: bool = True) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of :func:`flash_attention` on the card: the forward's
    inputs, its output ``out``, the output gradient ``dout`` (both ``[B,
    Sq, Hq, D]`` in q's dtype) and its ``lse [B, Hq, Sq]`` (float32).  The
    gradients come in the inputs' dtype, accumulated in float32 (bf16 on
    the tensor cores, float32 on the CUDA cores; no atomics, so a repeated
    call gives the same bits)."""
    b, sq, sk, hq, hkv, d = _check(q, k, v, out=out, dout=dout)
    if tuple(out.shape) != tuple(q.shape) or tuple(dout.shape) != tuple(q.shape):
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)} and dout "
                         f"{tuple(dout.shape)} must be shaped as q {tuple(q.shape)}")
    if (lse.dtype != torch.float32 or lse.device != q.device
            or tuple(lse.shape) != (b, hq, sq) or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd: lse must be contiguous float32 "
                         f"{(b, hq, sq)} on {q.device}, got {lse.dtype} "
                         f"{tuple(lse.shape)} on {lse.device}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if b == 0 or sq == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)  # scratch
    err = _launcher("flash_attention_bwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, sq, sk, hq, hkv, d, int(causal), 1.0 / math.sqrt(d), _DTYPES[q.dtype],
        _device_index(q.device), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: cudaError {err}")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """The forward kernel with its log-sum-exp saved; the backward kernel
    for its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = _forward(q, k, v, causal, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(), lse,
                                         causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """GQA attention ``q [B, Sq, Hq, D]`` over ``k``/``v [B, Sk, Hkv, D]``
    (positions from 0; causal by default) -> ``[B, Sq, Hq, D]`` in ``q``'s
    dtype (float32 or bfloat16, float32 accumulation).  Any sequence
    length; on the card ``D`` is one of :data:`HEAD_DIMS` and q, k, v are
    16-byte aligned.  bf16 runs on the tensor cores, float32 on the CUDA
    cores (see ``csrc/flash_attention.cu``).  Differentiable: on the card
    through :class:`FlashAttention` and the backward kernel."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal)
    return _forward(q, k, v, causal, with_lse=False)[0]

