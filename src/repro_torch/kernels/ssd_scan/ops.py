"""Wrapper of the SSD scan kernel (``csrc/ssd_scan.cu``).

CPU tensors go to the plain version (:mod:`.ref`).  CUDA tensors go to the
hand-written kernel, or the call raises: there is no fallback.  The type of
B and C picks the body: bfloat16 the tensor-core body (followed, with more
than one chunk or with ``return_state``, by its state pass), float32 the
CUDA-core body.  With ``return_state`` the kernel also writes the state
after the last chunk, which a cache-producing prefill needs.  The kernel
launches on PyTorch's current stream, and each call that launches it adds
one to ``repro_torch.kernels.LAUNCHES["ssd_scan"]``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import LAUNCHES, refuse_grad
from .. import _build
from .ref import check_chunk, ssd_scan_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# What the kernel's shared memory and register tiles hold (csrc/ssd_scan.cu).
MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 256, 128, 256
_C_FUNCTION = None
_C_GROUP = None


def _launcher():
    global _C_FUNCTION
    if _C_FUNCTION is None:
        fn = _build.load("ssd_scan").ssd_scan_launch
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _C_FUNCTION = fn
    return _C_FUNCTION


def heads_per_block(b: int, s: int, h: int, p: int, n: int, chunk: int,
                    device: torch.device) -> int:
    """Heads that one block of the tensor-core body (bfloat16 B/C) takes at
    this shape on the CUDA ``device``: the kernel sizes the group from the
    shape and the card's SM count."""
    global _C_GROUP
    if _C_GROUP is None:
        fn = _build.load("ssd_scan").ssd_scan_heads_per_block
        fn.argtypes = [ctypes.c_int] * 7
        fn.restype = ctypes.c_int
        _C_GROUP = fn
    index = device.index if device.index is not None else torch.cuda.current_device()
    group = _C_GROUP(b, s, h, p, n, check_chunk(s, chunk), index)
    if group < 1:
        raise ValueError(f"ssd_scan: the kernel refuses (b, s, h, p, n, chunk) = "
                         f"{(b, s, h, p, n, chunk)}")
    return group


def ssd_scan(xdt: torch.Tensor, dA: torch.Tensor, Bmat: torch.Tensor, Cmat: torch.Tensor,
             *, chunk: int = 256, return_state: bool = False):
    """The chunked SSD scan: ``xdt [B, S, H, P]`` and ``dA [B, S, H]`` in
    float32, ``Bmat``/``Cmat [B, S, N]`` (one type, float32 or bfloat16,
    shared by all heads) -> ``y [B, S, H, P]`` in float32, or with
    ``return_state`` ``(y, h_final [B, H, P, N])`` in float32, the state
    after the last chunk from a zero initial state.  The chunk is
    ``min(chunk, S)`` and must divide ``S``; on the card it is at most
    :data:`MAX_CHUNK`, ``P`` at most :data:`MAX_HEAD_DIM` and ``N`` at most
    :data:`MAX_STATE`."""
    device = xdt.device
    if device.type == "cpu":
        return ssd_scan_ref(xdt, dA, Bmat, Cmat, chunk=chunk, return_state=return_state)
    if device.type != "cuda":
        raise ValueError(f"ssd_scan runs on CPU or CUDA tensors, got {device}")
    refuse_grad("ssd_scan", xdt, dA, Bmat, Cmat)
    if xdt.dim() != 4 or dA.dim() != 3 or Bmat.dim() != 3:
        raise ValueError(f"ssd_scan: xdt must be [B, S, H, P], dA [B, S, H] and B/C "
                         f"[B, S, N], got {tuple(xdt.shape)}, {tuple(dA.shape)}, "
                         f"{tuple(Bmat.shape)}")
    b, s, h, p = xdt.shape
    n = Bmat.shape[-1]
    if tuple(dA.shape) != (b, s, h) or tuple(Bmat.shape) != (b, s, n) \
            or tuple(Cmat.shape) != (b, s, n):
        raise ValueError(f"ssd_scan: dA {tuple(dA.shape)}, B {tuple(Bmat.shape)} and C "
                         f"{tuple(Cmat.shape)} do not fit xdt {tuple(xdt.shape)}")
    q = check_chunk(s, chunk)
    if q > MAX_CHUNK or not 0 < p <= MAX_HEAD_DIM or not 0 < n <= MAX_STATE:
        raise ValueError(f"ssd_scan: chunk {q}, head dim {p} and state {n} must be in "
                         f"[1, {MAX_CHUNK}], [1, {MAX_HEAD_DIM}] and [1, {MAX_STATE}]")
    if xdt.dtype != torch.float32 or dA.dtype != torch.float32:
        raise TypeError(f"ssd_scan: xdt and dA must be float32, got {xdt.dtype}, {dA.dtype}")
    if Bmat.dtype not in _DTYPES or Cmat.dtype != Bmat.dtype:
        raise TypeError(f"ssd_scan: B and C must share one type, float32 or bfloat16, got "
                        f"{Bmat.dtype}, {Cmat.dtype}")
    for name, x in (("xdt", xdt), ("dA", dA), ("B", Bmat), ("C", Cmat)):
        if x.device != device:
            raise ValueError(f"ssd_scan: {name} is on {x.device}, expected {device}")
        if not x.is_contiguous():
            raise ValueError(f"ssd_scan: {name} must be contiguous")
    y = torch.empty_like(xdt)
    h_final = (torch.empty((b, h, p, n), dtype=torch.float32, device=device)
               if return_state else None)
    if b * h == 0:
        return (y, h_final) if return_state else y
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _launcher()(
        xdt.data_ptr(), dA.data_ptr(), Bmat.data_ptr(), Cmat.data_ptr(), y.data_ptr(),
        h_final.data_ptr() if return_state else None,
        b, s, h, p, n, q, _DTYPES[Bmat.dtype],
        device.index if device.index is not None else torch.cuda.current_device(),
        stream,
    )
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: cudaError {err}")
    LAUNCHES["ssd_scan"] += 1
    return (y, h_final) if return_state else y
