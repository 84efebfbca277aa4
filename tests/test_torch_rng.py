"""The port's counter-based generator against ``jax.random``.

Keys are raw uint32 key data drawn with numpy and handed to both sides.
``split``, ``fold_in``, the 32-bit bits, ``uniform``, ``randint`` and
``categorical`` must be bit-exact; in bfloat16 (8 random bits per value,
every step a bfloat16 operation) so must ``uniform``, ``gumbel`` and
``categorical``.  ``gumbel`` takes two float32 logs,
and PyTorch's ``log`` differs from XLA's in the last bit on about a
seventh of inputs; near ``-log(u) = 1`` the outer log is close to zero,
where one ulp of input is many ulps of output, so it is held to
``atol = rtol = 1e-6`` (measured maximum difference over 4M draws:
9.5e-7).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import convert, rng

torch.set_num_threads(2)

NUM_KEYS = 32
SHAPES = [(), (5,), (3, 4), (7, 36)]


def _key_data(seed=0, n=NUM_KEYS):
    return np.random.default_rng(seed).integers(0, 2 ** 32, size=(n, 2), dtype=np.uint32)


def _both(seed=0):
    kd = _key_data(seed)
    return kd, convert.keys_from_numpy(kd, device="cpu")


def _jax_per_key(fn, kd, *args):
    return np.asarray(jax.jit(jax.vmap(fn))(jnp.asarray(kd), *args))


# Compiled once per shape and dtype; bounds are traced, so cases share them.
@functools.partial(jax.jit, static_argnames=("shape",))
def _jax_uniform(kd, lo, hi, shape):
    return jax.vmap(lambda k: jax.random.uniform(k, shape, jnp.float32, lo, hi))(kd)


@functools.partial(jax.jit, static_argnames=("shape", "dtype"))
def _jax_randint(kd, lo, hi, shape, dtype):
    return jax.vmap(lambda k: jax.random.randint(k, shape, lo, hi, dtype))(kd)


@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 - 1])
def test_prng_key(seed):
    ref = np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))
    np.testing.assert_array_equal(rng.PRNGKey(seed).numpy(), ref.astype(np.int64))


@pytest.mark.parametrize("num", [2, 3, 16])
def test_split(num):
    kd, kt = _both(1)
    ref = _jax_per_key(lambda k: jax.random.split(k, num), kd)
    np.testing.assert_array_equal(rng.split(kt, num).numpy(), ref.astype(np.int64))
    # The unbatched form is the same function of one key.
    np.testing.assert_array_equal(rng.split(kt[3], num).numpy(), ref[3].astype(np.int64))


def test_fold_in():
    kd, kt = _both(2)
    data = np.random.default_rng(3).integers(-2 ** 31, 2 ** 31, size=NUM_KEYS,
                                             dtype=np.int64).astype(np.int32)
    ref = _jax_per_key(jax.random.fold_in, kd, jnp.asarray(data))
    out = rng.fold_in(kt, torch.from_numpy(data))
    np.testing.assert_array_equal(out.numpy(), ref.astype(np.int64))


@pytest.mark.parametrize("shape", SHAPES)
def test_random_bits(shape):
    kd, kt = _both(4)
    ref = _jax_per_key(lambda k: jax.random.bits(k, shape, jnp.uint32), kd)
    np.testing.assert_array_equal(rng.random_bits(kt, shape).numpy(), ref.astype(np.int64))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bounds", [(0.0, 1.0), (-2.5, 3.0),
                                    (float(np.finfo(np.float32).tiny), 1.0)])
def test_uniform(shape, bounds):
    kd, kt = _both(5)
    lo, hi = bounds
    ref = np.asarray(_jax_uniform(jnp.asarray(kd), np.float32(lo), np.float32(hi), shape))
    out = rng.uniform(kt, shape, lo, hi).numpy()
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bounds", [(0, 4), (0, 36), (-5, 4), (0, 81), (7, 7),
                                    (10, 2), (0, 2 ** 31 - 1),
                                    (-2 ** 31, 2 ** 31 - 1), (-3, 65539)])
def test_randint_int32(shape, bounds):
    kd, kt = _both(6)
    lo, hi = bounds
    ref = np.asarray(_jax_randint(jnp.asarray(kd), np.int32(lo), np.int32(hi), shape, jnp.int32))
    out = rng.randint(kt, shape, lo, hi, torch.int32)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("shape", [(), (6, 6), (7, 7)])
@pytest.mark.parametrize("bounds", [(0, 4), (0, 5), (-128, 128), (-100, 100), (0, 300)])
def test_randint_int8(shape, bounds):
    kd, kt = _both(7)
    lo, hi = bounds
    ref = np.asarray(_jax_randint(jnp.asarray(kd), np.int32(lo), np.int32(hi), shape, jnp.int8))
    out = rng.randint(kt, shape, lo, hi, torch.int8)
    assert out.dtype == torch.int8
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("shape", SHAPES)
def test_gumbel(shape):
    kd, kt = _both(8)
    ref = _jax_per_key(lambda k: jax.random.gumbel(k, shape, jnp.float32), kd)
    np.testing.assert_allclose(rng.gumbel(kt, shape).numpy(), ref, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("width", [4, 36, 49])
def test_categorical(width):
    kd, kt = _both(9)
    logits = np.random.default_rng(10).normal(size=(NUM_KEYS, width)).astype(np.float32)
    logits[:, ::3] = -1e9                     # the tap policy's masked cells
    ref = _jax_per_key(jax.random.categorical, kd, jnp.asarray(logits))
    out = rng.categorical(kt, torch.from_numpy(logits))
    np.testing.assert_array_equal(out.numpy(), ref)
    # One key over a whole [rows, width] table draws like JAX too.
    one = np.asarray(jax.random.categorical(jnp.asarray(kd[0]), jnp.asarray(logits)))
    np.testing.assert_array_equal(rng.categorical(kt[0], torch.from_numpy(logits)).numpy(), one)


def _bf16(x):
    """float32 copy of a bfloat16 array (JAX) or tensor (port), exact."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("shape", [(), (7, 36), (1024,)])
@pytest.mark.parametrize("bounds", [(0.0, 1.0), (0.3, 2.7), (-1.5, 0.7)])
def test_uniform_bfloat16(shape, bounds):
    kd, kt = _both(11)
    lo, hi = bounds
    ref = _jax_per_key(lambda k: jax.random.uniform(k, shape, jnp.bfloat16, lo, hi), kd)
    out = rng.uniform(kt, shape, lo, hi, dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bf16(out), _bf16(ref))


@pytest.mark.parametrize("shape", [(5,), (1024,)])
def test_gumbel_bfloat16(shape):
    """Bit-equal; 1024 draws per key reach every one of the 128 values
    ``u`` can take."""
    kd, kt = _both(12)
    ref = _jax_per_key(lambda k: jax.random.gumbel(k, shape, jnp.bfloat16), kd)
    out = rng.gumbel(kt, shape, dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bf16(out), _bf16(ref))


@pytest.mark.parametrize("width", [4, 8, 1000])
def test_categorical_bfloat16(width):
    """bfloat16 logits draw bfloat16 noise, with batched keys (``vmap``)
    and with one key over the whole table, as ``jax.random.categorical``."""
    kd, kt = _both(13)
    logits = np.random.default_rng(14).normal(size=(NUM_KEYS, width)).astype(np.float32)
    jl = jnp.asarray(logits).astype(jnp.bfloat16)
    tl = torch.from_numpy(logits).to(torch.bfloat16)
    ref = _jax_per_key(jax.random.categorical, kd, jl)
    np.testing.assert_array_equal(rng.categorical(kt, tl).numpy(), ref)
    one = np.asarray(jax.random.categorical(jnp.asarray(kd[0]), jl))
    np.testing.assert_array_equal(rng.categorical(kt[0], tl).numpy(), one)
    # The float32 draw of the same logits is another draw.
    f32 = _jax_per_key(jax.random.categorical, kd, jl.astype(jnp.float32))
    if width > 8:
        assert (f32 != ref).any()
