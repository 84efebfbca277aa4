"""Counter-based random numbers that reproduce ``jax.random`` bit for bit.

Every search decision of the reference package draws from threefry2x32
keys: the traversal coin, the Gumbel expansion draw, the rollout policy,
the tap game's refill and the bandit tree's edge rewards.  A
``torch.Generator`` cannot give those bits, so the port carries its own
generator with explicit keys, following JAX's partitionable threefry
layout (``jax_threefry_partitionable=True``, the default since JAX 0.5):

* a key is its raw data, an ``int64`` tensor ``[..., 2]`` holding the two
  unsigned 32-bit words;
* ``split(key, n)`` hashes the counters ``(0, i)``; ``fold_in(key, d)``
  hashes ``(0, d)``; 32-bit random bits are ``x0 ^ x1`` of the hash of the
  flat element index;
* unsigned 32-bit arithmetic runs in ``int64`` with masking, which gives
  the same words on the CPU and on CUDA.

Leading axes of a key act as a batch axis (the port's form of ``vmap``):
``uniform(keys[B, 2], (A,))`` draws ``[B, A]``, row ``b`` equal to
``jax.random.uniform(keys[b], (A,))``.  Each sampler runs a few hundred
small tensor ops, so on a GPU every draw costs that many launches.

``normal``, ``gamma``/``loggamma`` and ``dirichlet`` follow JAX's float32
algorithms step for step (XLA's ``erf_inv`` polynomial, Marsaglia–Tsang
rejection with one key split per element); they differ from JAX only
where PyTorch's ``log``/``log1p``/``exp`` round an ulp away from XLA's
(measured in ``tests/test_torch_random_mdp.py``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k1, k2, x1, x2) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of counter words ``(x1, x2)``
    under key words ``(k1, k2)``; all broadcastable ``int64`` tensors
    holding values in ``[0, 2**32)``."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x1 + ks[0]) & MASK32
    y = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + y) & MASK32
            y = _rotl(y, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        y = (y + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, y


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """Key data of ``jax.random.PRNGKey(seed)`` for a 32-bit seed."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64,
                        device=device)


def _words(key: torch.Tensor, extra_dims: int):
    """Key words shaped to broadcast against ``extra_dims`` trailing axes."""
    if key.shape[-1:] != (2,):
        raise ValueError(f"key data must end in an axis of 2, got {tuple(key.shape)}")
    view = key.shape[:-1] + (1,) * extra_dims
    return key[..., 0].reshape(view), key[..., 1].reshape(view)


def _counters(shape: Sequence[int], device) -> torch.Tensor:
    n = math.prod(shape)
    if n >= 2 ** 32:
        raise ValueError("more than 2**32 draws from one key")
    return torch.arange(n, dtype=torch.int64, device=device).reshape(tuple(shape))


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``[..., 2] -> [..., num, 2]``."""
    k1, k2 = _words(key, 1)
    lo = _counters((num,), key.device)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: mixes the 32-bit pattern of ``data`` into
    ``key``.  ``data`` (an int or integer tensor) broadcasts against the
    key's batch axes."""
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & MASK32
    k1, k2 = key[..., 0], key[..., 1]
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(data), data)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """32-bit ``jax.random.bits`` as ``int64`` values in ``[0, 2**32)``,
    shaped ``key.shape[:-1] + shape``."""
    shape = tuple(shape)
    k1, k2 = _words(key, len(shape))
    lo = _counters(shape, key.device)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: Sequence[int] = (),
            minval: float = 0.0, maxval: float = 1.0,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.uniform`` over ``[minval, maxval)`` in float32 or
    bfloat16.

    float32: XLA fuses the scale-and-shift ``u * (maxval - minval) +
    minval`` into one fused multiply-add.  The port forms it in float64,
    which holds the product exactly, then rounds once to float32: the
    fused result, as long as ``|minval|`` is below about 32 times the span
    (beyond that the float64 sum itself may round).

    bfloat16: JAX draws 8 random bits per value (the low byte of the
    32-bit bits), since bfloat16 has fewer than 8 mantissa bits; ``(b >> 1)
    | 0x3F80`` viewed as bfloat16 lies in ``[1, 2)``.  Every later step is
    a bfloat16 operation, each rounded, as XLA computes it.
    """
    bits = random_bits(key, shape)
    if dtype == torch.bfloat16:
        one = torch.tensor(1.0, dtype=dtype, device=key.device)
        lo = torch.tensor(minval, dtype=dtype, device=key.device)
        hi = torch.tensor(maxval, dtype=dtype, device=key.device)
        floats = (((bits & 0xFF) >> 1) | 0x3F80).to(torch.int16).view(dtype) - one
        return torch.maximum(lo, floats * (hi - lo) + lo)
    if dtype != torch.float32:
        raise TypeError(f"uniform draws float32 or bfloat16, not {dtype}")
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = np.float32(minval)
    scale = np.float32(maxval) - lo      # float32 arithmetic, as in JAX
    value = (floats.to(torch.float64) * float(scale) + float(lo)).to(torch.float32)
    return torch.clamp_min(value, float(lo))


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """``(a * b) mod 2**32`` for words ``a`` and a host word ``b`` without
    leaving int64."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


_INT_INFO = {
    torch.int8: (-(2 ** 7), 2 ** 7 - 1),
    torch.int16: (-(2 ** 15), 2 ** 15 - 1),
    torch.int32: (-(2 ** 31), 2 ** 31 - 1),
}


def randint(key: torch.Tensor, shape: Sequence[int], minval: int, maxval: int,
            dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """``jax.random.randint`` for int8/int16/int32 and host bounds.

    JAX draws two 32-bit words per value and folds them modulo the span;
    types narrower than 32 bits are sampled as int32 with the bounds
    clipped to the narrow range, then cast.
    """
    if dtype not in _INT_INFO:
        raise TypeError(f"randint supports int8/int16/int32, got {dtype}")
    lo_t, hi_t = _INT_INFO[dtype]
    minval, maxval = int(minval), int(maxval)
    if dtype != torch.int32:
        minval = min(max(minval, lo_t), hi_t)
        maxval = min(max(maxval, lo_t), hi_t + 1)
    if not (-(2 ** 31) <= minval < 2 ** 31 and -(2 ** 31) <= maxval < 2 ** 31):
        raise ValueError("randint bounds must fit in int32")
    keys = split(key)
    higher = random_bits(keys[..., 0, :], shape)
    lower = random_bits(keys[..., 1, :], shape)
    span = 1 if maxval <= minval else (maxval - minval) & MASK32
    multiplier = (2 ** 16) % span
    multiplier = ((multiplier * multiplier) & MASK32) % span
    offset = (_mul32(higher % span, multiplier) + lower % span) & MASK32
    offset = offset % span
    value = ((minval + offset + 2 ** 31) & MASK32) - 2 ** 31   # int32 wrap
    return value.to(dtype)


def gumbel(key: torch.Tensor, shape: Sequence[int] = (),
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.gumbel`` (the default ``mode='low'``) in float32 or
    bfloat16: ``-log(-log(u))`` of a uniform over ``[tiny, 1)``, each step
    in ``dtype``."""
    u = uniform(key, shape, minval=float(torch.finfo(dtype).tiny), maxval=1.0, dtype=dtype)
    return -torch.log(-torch.log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis of ``logits``.

    The Gumbel noise is drawn in the logits' dtype (float32 or bfloat16),
    as JAX draws it, and added in that dtype.  A single key ``[2]`` draws
    the noise for the whole ``logits`` array, as JAX does; batched keys
    ``[..., 2]`` draw one row each (``vmap`` of the single-key call), so
    their batch shape must be ``logits.shape[:-1]``.  Returns ``int64``
    indices.
    """
    if key.dim() == 1:
        g = gumbel(key, tuple(logits.shape), dtype=logits.dtype)
    else:
        if key.shape[:-1] != logits.shape[:-1]:
            raise ValueError(
                f"batched keys {tuple(key.shape)} do not match logits "
                f"{tuple(logits.shape)}"
            )
        g = gumbel(key, (logits.shape[-1],), dtype=logits.dtype)
    return torch.argmax(g + logits, dim=-1)


# ---------------------------------------------------------------------------
# Normal, gamma and Dirichlet draws (``jax.random.normal`` / ``gamma`` /
# ``loggamma`` / ``dirichlet`` in float32).
# ---------------------------------------------------------------------------

# XLA's float32 erf_inv: Giles' polynomials in w = -log1p(-x^2), one for
# w < 5 (evaluated at w - 2.5) and one beyond (at sqrt(w) - 3).
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
                 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
_SQRT2_F32 = float(np.float32(np.sqrt(2.0)))
_THIRD_F32 = float(np.float32(1.0 / 3.0))


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as XLA's fused multiply-add:
    the float64 product of two float32 values is exact."""
    b = b.double() if isinstance(b, torch.Tensor) else float(b)
    c = c.double() if isinstance(c, torch.Tensor) else float(c)
    return (a.double() * b + c).float()


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (XLA's and CUDA's ``sqrtf``)."""
    return torch.sqrt(x.double()).float()


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv``: the same polynomial, evaluated in the same
    order with fused multiply-adds (not ``torch.erfinv``)."""
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, _sqrt(w) - 3.0)
    p = torch.where(small, float(np.float32(_ERFINV_SMALL[0])),
                    float(np.float32(_ERFINV_LARGE[0])))
    for lo, hi in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        coef = torch.where(small, float(np.float32(lo)), float(np.float32(hi)))
        p = _fma(p, w, coef)
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(key: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """``jax.random.normal`` (float32): ``sqrt(2) * erf_inv(u)`` with ``u``
    uniform over ``[nextafter(-1, 0), 1)``."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    return _SQRT2_F32 * erf_inv(uniform(key, shape, minval=lo, maxval=1.0))


def _gamma_flat(keys: torch.Tensor, alpha: torch.Tensor, log_space: bool) -> torch.Tensor:
    """Marsaglia–Tsang for ``N`` elements, element ``i`` drawing from
    ``keys[i]`` as JAX's ``_gamma_one`` does.

    JAX runs one rejection loop per element; here all elements loop
    together, and an element that has accepted stops drawing (its key,
    ``X``, ``V`` and ``U`` are frozen).  Every loop trip costs one host
    sync.
    """
    from .sync import host_any

    boost = alpha >= 1.0
    a = torch.where(boost, alpha, alpha + 1.0)
    d = a - _THIRD_F32
    c = _THIRD_F32 / _sqrt(d)
    ks = split(keys)
    key, subkey = ks[:, 0], ks[:, 1]

    def rejected(X, V, U):
        squeeze = U >= _fma(-0.0331 * torch.ones_like(X), X * X, 1.0)
        rhs = _fma(d, (1.0 - V) + torch.log(V), X * 0.5)
        return squeeze & (torch.log(U) >= rhs)

    X = torch.zeros_like(alpha)
    V = torch.ones_like(alpha)
    U = torch.full_like(alpha, 2.0)
    active = rejected(X, V, U)
    while host_any(active):
        k3 = split(key, 3)
        # Inner loop: redraw x until v = 1 + x c is positive.
        k, x = k3[:, 1], torch.zeros_like(alpha)
        v = torch.full_like(alpha, -1.0)
        inner = active.clone()
        while host_any(inner):
            k2 = split(k)
            xn = normal(k2[:, 1])
            vn = _fma(xn, c, 1.0)
            x, v = torch.where(inner, xn, x), torch.where(inner, vn, v)
            k = torch.where(inner[:, None], k2[:, 0], k)
            inner = inner & (v <= 0.0)
        un = uniform(k3[:, 2])
        key = torch.where(active[:, None], k3[:, 0], key)
        X = torch.where(active, x * x, X)
        V = torch.where(active, (v * v) * v, V)
        U = torch.where(active, un, U)
        active = active & rejected(X, V, U)
    if log_space:
        log_samples = torch.log1p(-uniform(subkey))      # -exponential(subkey)
        log_boost = torch.where(boost | (log_samples == 0.0), 0.0,
                                log_samples * (1.0 / alpha))
        return (torch.log(d) + torch.log(V)) + log_boost
    samples = 1.0 - uniform(subkey)
    pw = torch.where(boost, 1.0, torch.pow(samples, 1.0 / alpha))
    return (d * V) * pw


def _gamma(key: torch.Tensor, alpha, shape, log_space: bool) -> torch.Tensor:
    if key.shape != (2,):
        raise ValueError(f"gamma draws from one key [2], got {tuple(key.shape)}")
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=key.device)
    shape = tuple(alpha.shape) if shape is None else tuple(shape)
    alpha = torch.broadcast_to(alpha, shape).reshape(-1)
    keys = split(key, alpha.numel())       # one key per element, as _gamma_impl
    return _gamma_flat(keys, alpha, log_space).reshape(shape)


def gamma(key: torch.Tensor, a, shape: Optional[Sequence[int]] = None) -> torch.Tensor:
    """``jax.random.gamma`` (float32) for shape parameters ``a``."""
    return _gamma(key, a, shape, log_space=False)


def loggamma(key: torch.Tensor, a, shape: Optional[Sequence[int]] = None) -> torch.Tensor:
    """``jax.random.loggamma`` (float32): the log of a gamma draw, formed in
    log space."""
    return _gamma(key, a, shape, log_space=True)


def dirichlet(key: torch.Tensor, alpha, shape: Sequence[int] = ()) -> torch.Tensor:
    """``jax.random.dirichlet`` (float32): the softmax of ``loggamma`` draws
    of shape ``shape + alpha.shape[-1:]``."""
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=key.device)
    logs = loggamma(key, alpha, tuple(shape) + tuple(alpha.shape[-1:]))
    e = torch.exp(logs - logs.max(dim=-1, keepdim=True).values)
    return e / e.sum(dim=-1, keepdim=True)
