"""Wrapper of the SSD scan kernel (``csrc/ssd_scan.cu``) and of its
backward (``csrc/ssd_scan_bwd.cu``).

CPU tensors go to the plain versions (:mod:`.ref`), which autograd
differentiates.  CUDA tensors go to the hand-written kernels, or the call
raises: there is no fallback.  The type of B and C picks the body of the
forward and of the backward: bfloat16 the tensor-core body (with more than
one chunk or with ``return_state`` the forward's state kernel, then its
chunk kernel, which reads the states back; the chunk kernel's Hopper body
at P = 64, N = 64 or 128, chunk >= 64, its mma.sync body at other shapes,
:func:`chunk_kernel`), float32 the CUDA-core body.
With ``return_state`` the kernel also writes the state after the last
chunk, which a cache-producing prefill needs; that call has no backward.
When grad mode is on and an input requires grad, a CUDA call without
``return_state`` runs through :class:`SsdScan`, whose backward launches the
backward kernel on the states the forward kernel kept (bfloat16 B/C, more
than one chunk).  The kernels launch on PyTorch's current stream; each
forward call that launches adds one to
``repro_torch.kernels.LAUNCHES["ssd_scan"]``, each backward call one to
``LAUNCHES["ssd_scan_bwd"]`` (however many launches it makes).
"""

from __future__ import annotations

import ctypes
import types

import torch

from .. import LAUNCHES, refuse_grad
from .. import _build
from .ref import check_chunk, ssd_scan_bwd_ref, ssd_scan_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# What the kernels' shared memory and register tiles hold (csrc/ssd_scan.cu,
# csrc/ssd_scan_bwd.cu).
MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 256, 128, 256
_C_FUNCTIONS: dict = {}


def _launcher(name: str):
    fn = _C_FUNCTIONS.get(name)
    if fn is None:
        if name == "ssd_scan":
            fn = _build.load(name).ssd_scan_launch
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        elif name == "ssd_scan_bwd":
            fn = _build.load(name).ssd_scan_bwd_launch
            fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        elif name == "bwd_scratch":
            fn = _build.load("ssd_scan_bwd").ssd_scan_bwd_scratch_floats
            fn.argtypes = [ctypes.c_int] * 8
        elif name == "wgmma":
            fn = _build.load("ssd_scan").ssd_scan_wgmma
            fn.argtypes = [ctypes.c_int] * 3
        elif name == "bwd_heads_per_block":
            fn = _build.load("ssd_scan_bwd").ssd_scan_bwd_heads_per_block
            fn.argtypes = [ctypes.c_int] * 7
        else:
            fn = _build.load("ssd_scan").ssd_scan_heads_per_block
            fn.argtypes = [ctypes.c_int] * 7
        fn.restype = ctypes.c_longlong if name == "bwd_scratch" else ctypes.c_int
        _C_FUNCTIONS[name] = fn
    return fn


def _device_index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def heads_per_block(b: int, s: int, h: int, p: int, n: int, chunk: int,
                    device: torch.device) -> int:
    """Heads that one block of the tensor-core body (bfloat16 B/C) takes at
    this shape on the CUDA ``device``: the kernel sizes the group from the
    shape and the card's SM count."""
    group = _launcher("heads_per_block")(b, s, h, p, n, check_chunk(s, chunk),
                                          _device_index(device))
    if group < 1:
        raise ValueError(f"ssd_scan: the kernel refuses (b, s, h, p, n, chunk) = "
                         f"{(b, s, h, p, n, chunk)}")
    return group


def chunk_kernel(p: int, n: int, chunk: int) -> str:
    """The name of the forward's chunk kernel that a bfloat16 call with
    head dim ``p``, state ``n`` and ``chunk`` launches on the card (16-byte
    aligned tensors): ``ssd_wgmma_kernel`` (the Hopper body) or
    ``ssd_mma_kernel``."""
    return "ssd_wgmma_kernel" if _launcher("wgmma")(p, n, chunk) else "ssd_mma_kernel"


def bwd_heads_per_block(b: int, s: int, h: int, p: int, n: int, chunk: int,
                        device: torch.device) -> int:
    """Heads that one chunk-kernel block of the backward's tensor-core body
    (bfloat16 B/C) takes at this shape on the CUDA ``device``."""
    group = _launcher("bwd_heads_per_block")(b, s, h, p, n, check_chunk(s, chunk),
                                              _device_index(device))
    if group < 1:
        raise ValueError(f"ssd_scan_bwd: the kernel refuses (b, s, h, p, n, chunk) = "
                         f"{(b, s, h, p, n, chunk)}")
    return group


def _check(xdt, dA, Bmat, Cmat, chunk: int, **more) -> tuple:
    """Shapes ``(b, s, h, p, n, q)`` of a CUDA call, after checking what the
    kernels take; ``more`` are further float32 tensors shaped as ``xdt``."""
    device = xdt.device
    if device.type != "cuda":
        raise ValueError(f"ssd_scan runs on CPU or CUDA tensors, got {device}")
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
    for name, x in (("xdt", xdt), ("dA", dA), ("B", Bmat), ("C", Cmat), *more.items()):
        if x.device != device:
            raise ValueError(f"ssd_scan: {name} is on {x.device}, expected {device}")
        if not x.is_contiguous():
            raise ValueError(f"ssd_scan: {name} must be contiguous")
    for name, x in more.items():
        if tuple(x.shape) != (b, s, h, p) or x.dtype != torch.float32:
            raise ValueError(f"ssd_scan: {name} must be float32 {(b, s, h, p)}, got "
                             f"{x.dtype} {tuple(x.shape)}")
    return b, s, h, p, n, q


def _forward(xdt, dA, Bmat, Cmat, *, chunk: int, return_state: bool = False,
             keep_states: bool = False):
    """The forward kernel: ``y``, with ``return_state`` also ``h_final``,
    with ``keep_states`` also the states entering each chunk ``[B, nc, H,
    P, N]`` (entry 0 unwritten), which the backward kernel takes, or None
    where the kernel forms none (float32 B/C, one chunk)."""
    b, s, h, p, n, q = _check(xdt, dA, Bmat, Cmat, chunk)
    device = xdt.device
    f32 = dict(dtype=torch.float32, device=device)
    y = torch.empty_like(xdt)
    h_final = torch.empty((b, h, p, n), **f32) if return_state else None
    # The state kernel's output (bf16 B/C): scratch, or kept for the backward.
    states = (torch.empty((b, s // q, h, p, n), **f32)
              if Bmat.dtype == torch.bfloat16 and s > q else None)
    if b * h:
        err = _launcher("ssd_scan")(
            xdt.data_ptr(), dA.data_ptr(), Bmat.data_ptr(), Cmat.data_ptr(), y.data_ptr(),
            h_final.data_ptr() if return_state else None,
            states.data_ptr() if states is not None else None,
            b, s, h, p, n, q, _DTYPES[Bmat.dtype], _device_index(device),
            torch.cuda.current_stream(device).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"ssd_scan kernel launch failed: cudaError {err}")
        LAUNCHES["ssd_scan"] += 1
    out = (y, *((h_final,) if return_state else ()), *((states,) if keep_states else ()))
    return out if len(out) > 1 else y


def ssd_scan_bwd(xdt: torch.Tensor, dA: torch.Tensor, Bmat: torch.Tensor, Cmat: torch.Tensor,
                 dy: torch.Tensor, *, chunk: int = 256, states: torch.Tensor | None = None):
    """The gradient of :func:`ssd_scan`'s ``y`` (without ``return_state``)
    for the output gradient ``dy [B, S, H, P]`` (float32): ``(dxdt, ddA,
    dB, dC)``, ``dxdt`` and ``ddA`` in float32, ``dB``/``dC`` in B's and C's
    type (summed in float32 over the heads and rounded once).  On the card
    no atomics, so a repeated call gives the same bits: bfloat16 B/C the
    tensor-core body (bf16 products, float32 operands split hi + lo, the
    products the heads share once per row and chunk), float32 B/C the
    CUDA-core float32 body; CPU tensors take :func:`.ref.ssd_scan_bwd_ref`.
    ``states`` (``[B, nc, H, P, N]`` float32, the states entering the
    chunks as the forward kernel keeps them, bfloat16 B/C only) spare the
    kernel their recomputation, with the same bits."""
    if xdt.device.type == "cpu":
        return ssd_scan_bwd_ref(xdt, dA, Bmat, Cmat, dy, chunk=chunk, states=states)
    b, s, h, p, n, q = _check(xdt, dA, Bmat, Cmat, chunk, dy=dy)
    device = xdt.device
    dxdt, ddA = torch.empty_like(xdt), torch.empty_like(dA)
    dB, dC = torch.empty_like(Bmat), torch.empty_like(Cmat)
    if b * h == 0:
        return dxdt, ddA, dB.zero_(), dC.zero_()
    nc = s // q
    dtype, index = _DTYPES[Bmat.dtype], _device_index(device)
    f32 = dict(dtype=torch.float32, device=device)
    if states is not None and (Bmat.dtype != torch.bfloat16 or nc == 1
                               or tuple(states.shape) != (b, nc, h, p, n)
                               or states.dtype != torch.float32 or states.device != device
                               or not states.is_contiguous()):
        raise ValueError(f"ssd_scan_bwd: states must be contiguous float32 {(b, nc, h, p, n)} "
                         f"on {device}, with bfloat16 B/C and more than one chunk; got "
                         f"{states.dtype} {tuple(states.shape)} on {states.device}, B/C "
                         f"{Bmat.dtype}")
    # Scratch: the states entering (unless given) and the state gradients
    # leaving each chunk, and what the body passes between its launches
    # (float32: each head's part of dB and dC; bfloat16: G^T and each head
    # group's D, exp(cum) and w, the parts of dB and dC), sized by the
    # library.
    hs, gs = (None, None) if nc == 1 else (
        states if states is not None else torch.empty((b, nc, h, p, n), **f32),
        torch.empty((b, nc, h, p, n), **f32))
    scratch = torch.empty(_launcher("bwd_scratch")(b, s, h, p, n, q, dtype, index), **f32)
    err = _launcher("ssd_scan_bwd")(
        xdt.data_ptr(), dA.data_ptr(), Bmat.data_ptr(), Cmat.data_ptr(), dy.data_ptr(),
        dxdt.data_ptr(), ddA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
        *(x.data_ptr() if x is not None else None for x in (hs, gs)), scratch.data_ptr(),
        b, s, h, p, n, q, int(states is not None), dtype, index,
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"ssd_scan_bwd kernel launch failed: cudaError {err}")
    LAUNCHES["ssd_scan_bwd"] += 1
    return dxdt, ddA, dB, dC


# The two launches of :class:`SsdScan`, looked up at each call: the CPU
# tests point them at the plain versions to run the Function's wiring.
KERNEL = types.SimpleNamespace(forward=_forward, backward=ssd_scan_bwd)


class SsdScan(torch.autograd.Function):
    """The forward kernel, its inputs and the states it formed saved; the
    backward kernel for their gradients (``None`` for ``chunk``)."""

    @staticmethod
    def forward(ctx, xdt, dA, Bmat, Cmat, chunk):
        y, states = KERNEL.forward(xdt, dA, Bmat, Cmat, chunk=chunk, keep_states=True)
        ctx.save_for_backward(xdt, dA, Bmat, Cmat, states)
        ctx.chunk = chunk
        return y

    @staticmethod
    def backward(ctx, dy):
        xdt, dA, Bmat, Cmat, states = ctx.saved_tensors
        grads = KERNEL.backward(xdt, dA, Bmat, Cmat, dy.contiguous(), chunk=ctx.chunk,
                                states=states)
        return (*grads, None)


def ssd_scan(xdt: torch.Tensor, dA: torch.Tensor, Bmat: torch.Tensor, Cmat: torch.Tensor,
             *, chunk: int = 256, return_state: bool = False):
    """The chunked SSD scan: ``xdt [B, S, H, P]`` and ``dA [B, S, H]`` in
    float32, ``Bmat``/``Cmat [B, S, N]`` (one type, float32 or bfloat16,
    shared by all heads) -> ``y [B, S, H, P]`` in float32, or with
    ``return_state`` ``(y, h_final [B, H, P, N])`` in float32, the state
    after the last chunk from a zero initial state.  The chunk is
    ``min(chunk, S)`` and must divide ``S``; on the card it is at most
    :data:`MAX_CHUNK`, ``P`` at most :data:`MAX_HEAD_DIM` and ``N`` at most
    :data:`MAX_STATE`.  Differentiable without ``return_state``: on the card
    through :class:`SsdScan` and the backward kernel; with it, a
    grad-requiring input raises on the card."""
    device = xdt.device
    if device.type == "cpu":
        return ssd_scan_ref(xdt, dA, Bmat, Cmat, chunk=chunk, return_state=return_state)
    if return_state:
        refuse_grad("ssd_scan(return_state=True)", xdt, dA, Bmat, Cmat)
    elif torch.is_grad_enabled() and any(x.requires_grad for x in (xdt, dA, Bmat, Cmat)):
        return SsdScan.apply(xdt, dA, Bmat, Cmat, chunk)
    return _forward(xdt, dA, Bmat, Cmat, chunk=chunk, return_state=return_state)
