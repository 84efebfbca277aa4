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
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY_F32 = float(np.finfo(np.float32).tiny)


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
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32 over ``[minval, maxval)``.

    XLA fuses the scale-and-shift ``u * (maxval - minval) + minval`` into
    one fused multiply-add.  The port forms it in float64, which holds the
    product exactly, then rounds once to float32: the fused result, as
    long as ``|minval|`` is below about 32 times the span (beyond that the
    float64 sum itself may round).
    """
    bits = random_bits(key, shape)
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


def gumbel(key: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """``jax.random.gumbel`` (float32, the default ``mode='low'``)."""
    u = uniform(key, shape, minval=_TINY_F32, maxval=1.0)
    return -torch.log(-torch.log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis of ``logits``.

    A single key ``[2]`` draws the noise for the whole ``logits`` array,
    as JAX does; batched keys ``[..., 2]`` draw one row each (``vmap`` of
    the single-key call), so their batch shape must be
    ``logits.shape[:-1]``.  Returns ``int64`` indices.
    """
    if key.dim() == 1:
        g = gumbel(key, tuple(logits.shape))
    else:
        if key.shape[:-1] != logits.shape[:-1]:
            raise ValueError(
                f"batched keys {tuple(key.shape)} do not match logits "
                f"{tuple(logits.shape)}"
            )
        g = gumbel(key, (logits.shape[-1],))
    return torch.argmax(g + logits, dim=-1)
